"""Experiment configuration: dataclass recipes + factories.

Parity: reference ``utils_config.py`` + ``experiments/journal_experiment_configs``
(SURVEY.md §2.8/§5.6): a config object carries the WHOLE constructor recipe for
environment, SSM and solver. Here configs are plain dataclasses (JSON-able,
hashable enough for jit closures) registered by name, replacing the reference's
import-a-python-class-file machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from safe_exploration_tpu.envs import (
    Env,
    linearize_discretize,
    make_cartpole,
    make_pendulum,
    make_quadrotor,
)
from safe_exploration_tpu.ops.linalg import dlqr
from safe_exploration_tpu.solvers.cem import CemConfig, cem_plan, cem_warm_len
from safe_exploration_tpu.solvers.costs import (
    exploration_cost,
    risk_tracking_cost,
    tracking_cost,
)
from safe_exploration_tpu.solvers.safempc import SafeMPCConfig, make_safempc

__all__ = ["ExperimentConfig", "CONFIGS", "build_experiment", "register_config"]

ENV_FACTORIES: dict[str, Callable[..., Env]] = {
    "pendulum": make_pendulum,
    "cartpole": make_cartpole,
    "quadrotor": make_quadrotor,
}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment = env + SSM + solver + runtime schedule (SURVEY.md §2.8)."""

    name: str = "pendulum_episode"
    # task: "episodic" | "exploration" | "uncertainty" (reference main.py
    # scenarios) | "batch" (mesh-sharded parallel episodes, BASELINE cfg 3)
    task: str = "episodic"
    batch_lanes: int = 256           # parallel episode lanes for task="batch"
    # ONLINE-learning episode runner for task="batch": "auto" (= "vmapped")
    # | "vmapped" | "lanes" (the lane-major per-lane-buffer runner — the only
    # path for pre-stacked LaneGPSSM models). The batched SOLVE inside both
    # runners rides the lane SQP backend where supported. Which runner is
    # faster on the GPU is not measured yet.
    batch_backend: str = "auto"
    env: str = "pendulum"
    solver: str = "cem"              # "cem" | "sqp"
    # "tracking" | "exploration" | "risk_tracking" (variance-priced tracking —
    # consumes the propagated performance covariance; solvers/costs.py)
    objective: str = "tracking"
    w_sigma: float = 1.0             # risk weight for objective="risk_tracking"

    # SSM (family selected by config — reference's CemSSM backends, §2.6)
    # "gp" | "sparse_gp" | "mc_dropout" | "mc_dropout_concrete" (learned
    # per-layer keep probability — the reference's concrete-dropout ssm_cem)
    ssm: str = "gp"
    kern_types: tuple = ("rbf", "rbf")
    n_max: int = 512                 # padded GP capacity
    m_subset: int = 0                # subset-of-data m for the dense GP (0=all)
    n_inducing: int = 64             # sparse-GP inducing points
    mc_hidden: tuple = (64, 64)      # MC-dropout MLP widths
    mc_samples: int = 16             # MC passes
    l_mu: float = 0.5                # Lipschitz const of GP mean gradient (per dim)
    l_sigma: float = 0.25            # Lipschitz const of predictive std (per dim)
    log_noise: float = -3.0
    # train the GP on normalized inputs z / [norm_x, norm_u] (reference
    # behavior — environments.py::normalize, SURVEY.md §2.7): lengthscales
    # come out O(1) regardless of per-dimension state scales
    normalize_inputs: bool = True
    # GP refit arithmetic: "f32" | "ff" (double-word float-float factors —
    # fp64-equivalent refits in f32 arithmetic; ops/ff.py)
    precision: str = "f32"

    # safe-MPC
    n_safe: int = 5                  # safety horizon
    n_perf: int = 0                  # performance horizon (0 = none)
    r_shared: int = 1                # controls shared by safety & perf trajs
    perf_trajectory: str = "taylor"  # "taylor" | "mean_equivalent"
    c_safety: float = 2.0            # beta confidence scaling
    # ONE feasibility tolerance for every planner (IPOPT constr_viol_tol
    # semantics — the reference has a single solver stack, so a single
    # standard); wired into both CemConfig and SqpConfig
    feas_tol: float = 1e-4
    lqr_w_x: float = 1.0
    lqr_w_u: float = 1.0

    # CEM knobs
    cem_samples: int = 128
    cem_elites: int = 16
    cem_iterations: int = 6
    # single-instance CEM planner backend: "portable" (vmap over samples) |
    # "lanes" (solvers/cem_lanes with B=1 — the M samples form the lane
    # axis; same algorithm, different noise stream). The BATCHED
    # entries always auto-dispatch to the lane backend where supported.
    cem_backend: str = "portable"

    # SQP knobs
    sqp_outer: int = 12
    sqp_inner: int = 6
    # restoration budget: Gauss-Newton feasibility-polish steps after the AL
    # loop, and rescue-burst AL outers (restore-then-reoptimize) after the
    # polish — the knobs behind the robust cold-start budget (see bench.py)
    sqp_polish: int = 3
    sqp_rescue: int = 0
    # violation-gated extra polish steps (free when the budget converged —
    # SqpConfig.n_polish_extra; the fast-budget feasibility knob)
    sqp_polish_extra: int = 0

    # runtime schedule
    n_ep: int = 6
    n_steps: int = 50
    n_init_samples: int = 40
    hyp_iters: int = 120
    seed: int = 0

    def __post_init__(self):
        # validate the backend selectors at CONSTRUCTION (ADVICE r4: the
        # batch_backend check only ran inside task="batch" dispatch, so a
        # typo'd value in any other task rode along silently)
        if self.batch_backend not in ("auto", "lanes", "vmapped"):
            raise ValueError(
                f"config '{self.name}': unknown batch_backend "
                f"{self.batch_backend!r} (auto|lanes|vmapped)"
            )
        if self.cem_backend not in ("portable", "lanes"):
            raise ValueError(
                f"config '{self.name}': unknown cem_backend "
                f"{self.cem_backend!r} (portable|lanes)"
            )
        if self.perf_trajectory not in ("taylor", "mean_equivalent"):
            raise ValueError(
                f"config '{self.name}': unknown perf_trajectory "
                f"{self.perf_trajectory!r} (taylor|mean_equivalent)"
            )


def _warn_ignored_knobs(cfg: ExperimentConfig, ignored: tuple) -> None:
    """Warn when a config overrides knobs the selected solver never reads
    (VERDICT r2 missing #3: cfg 5 silently dropped its advertised long horizon
    because the CEM path ignored n_perf) — a non-default value of an ignored
    field is almost certainly a config bug."""
    import warnings

    defaults = ExperimentConfig()
    for name in ignored:
        if getattr(cfg, name) != getattr(defaults, name):
            warnings.warn(
                f"config '{cfg.name}': field '{name}'={getattr(cfg, name)!r} is "
                f"ignored by solver='{cfg.solver}'",
                stacklevel=3,
            )


def _kern_tuple(cfg: ExperimentConfig, n_s: int) -> tuple:
    kt = tuple(cfg.kern_types)
    if len(kt) == 1:
        kt = kt * n_s
    if len(kt) != n_s:
        raise ValueError(f"kern_types has {len(kt)} entries for n_s={n_s}")
    return kt


def build_experiment(cfg: ExperimentConfig, dtype=jnp.float32) -> dict:
    """Wire the full experiment from a config (the reference's config-factory
    pattern): returns env, prior (a, b), k_fb, planner, safempc functions, cost
    and SSM hyper-bundles, ready for the runners."""
    env = ENV_FACTORIES[cfg.env](dtype=dtype)
    spec = env.spec
    mpc_cfg = SafeMPCConfig(
        n_safe=cfg.n_safe, c_safety=cfg.c_safety,
        lqr_w_x=cfg.lqr_w_x, lqr_w_u=cfg.lqr_w_u,
    )
    a, b = linearize_discretize(env)
    k_lqr, _ = dlqr(
        a, b,
        cfg.lqr_w_x * jnp.eye(spec.n_s, dtype=dtype),
        cfg.lqr_w_u * jnp.eye(spec.n_u, dtype=dtype),
    )
    k_fb = -k_lqr

    if cfg.objective == "tracking":
        cost_fn = tracking_cost(spec.target)
    elif cfg.objective == "exploration":
        cost_fn = exploration_cost()
    elif cfg.objective == "risk_tracking":
        # variance-priced tracking — the objective that consumes the
        # propagated performance covariance, making perf_trajectory="taylor"
        # vs "mean_equivalent" observable (VERDICT r4 missing #3). The lane
        # backends carry it natively (sqp_lanes._rollout_perf_lanes
        # want_sigma=True runs the lane Σ recursion; parity pinned in
        # tests/test_perf_trajectory_sqp.py).
        cost_fn = risk_tracking_cost(spec.target, w_sigma=cfg.w_sigma)
    else:
        raise ValueError(f"unknown objective {cfg.objective}")
    if cfg.objective != "risk_tracking":
        _warn_ignored_knobs(cfg, ignored=("w_sigma",))

    warm_len = cfg.n_safe
    if cfg.solver == "cem":
        _warn_ignored_knobs(
            cfg, ignored=("sqp_outer", "sqp_inner", "sqp_polish", "sqp_rescue",
                          "sqp_polish_extra")
        )
        cem_cfg = CemConfig(
            n_safe=cfg.n_safe,
            n_samples=cfg.cem_samples,
            n_elites=cfg.cem_elites,
            n_iterations=cfg.cem_iterations,
            feas_tol=cfg.feas_tol,
            n_perf=cfg.n_perf,
            r_shared=cfg.r_shared,
            perf_method=cfg.perf_trajectory,
        )
        warm_len = cem_warm_len(cem_cfg)

        def _planner_portable(key, ssm, x0, warm_mean):
            return cem_plan(
                key, ssm, x0, k_fb, a, b, spec.u_min, spec.u_max,
                spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
                cfg.c_safety, cost_fn, cem_cfg, warm_mean,
            )

        if cfg.cem_backend not in ("portable", "lanes"):
            raise ValueError(f"unknown cem_backend {cfg.cem_backend!r}")

        if cfg.cem_backend == "lanes":
            # single-instance planner through the lane backend: B=1, the M
            # samples fill the vector lanes (falls back per-model at call
            # time outside the supported envelope)
            from safe_exploration_tpu.solvers.cem_lanes import (
                cem_lanes_supported as _cls,
            )

            def planner(key, ssm, x0, warm_mean):
                if not _cls(ssm, cfg.objective):
                    return _planner_portable(key, ssm, x0, warm_mean)
                k_ff, feas, viol, info = cem_lane_solver(
                    ssm, x0[None], warm_mean[None], key=key
                )
                info1 = {k: v[0] for k, v in info.items()}
                return k_ff[0], feas[0], viol[0], info1
        else:
            planner = _planner_portable

        # Batched entry: the lane-major CEM (solvers/cem_lanes — samples x
        # instances as ONE lane axis) when the model/objective allow it,
        # falling back to vmapping the portable planner. Same results
        # contract as the SQP batch_planner; the two backends draw different
        # noise streams, so per-instance solutions are equally-good, not
        # identical (tests/test_cem_lanes.py).
        from safe_exploration_tpu.solvers.cem_lanes import (
            cem_lanes_supported,
            make_cem_lane_solver,
        )

        cem_cost_args = (
            {"target": spec.target} if cfg.objective == "tracking"
            else {"target": spec.target, "w_sigma": cfg.w_sigma}
            if cfg.objective == "risk_tracking" else {}
        )
        cem_lane_solver = make_cem_lane_solver(
            env, k_fb, a, b, cfg.c_safety, cfg.objective, cem_cost_args,
            cem_cfg,
        )

        def cem_batch_planner(ssm, x0s, warm, lam=None, *, key=None):
            if cem_lanes_supported(ssm, cfg.objective):
                return cem_lane_solver(ssm, x0s, warm, key=key)
            k = jax.random.PRNGKey(0) if key is None else key
            return jax.vmap(
                lambda x, w: planner(k, ssm, x, w)
            )(x0s, warm)

        batch_planner_cem = cem_batch_planner

    n_duals = 0
    dual_shift = None
    batch_planner = None
    lane_batch_supported = None
    if cfg.solver == "cem":
        batch_planner = batch_planner_cem
    if cfg.solver == "sqp":
        _warn_ignored_knobs(
            cfg, ignored=("cem_samples", "cem_elites", "cem_iterations",
                          "cem_backend")
        )
        from functools import partial

        from safe_exploration_tpu.solvers.sqp import (
            SqpConfig,
            make_sqp_planner,
            shift_duals,
            sqp_n_duals,
            sqp_warm_len,
        )

        sqp_cfg = SqpConfig(
            n_safe=cfg.n_safe, c_safety=cfg.c_safety,
            n_outer=cfg.sqp_outer, n_inner=cfg.sqp_inner,
            n_polish=cfg.sqp_polish, n_rescue_outer=cfg.sqp_rescue,
            n_polish_extra=cfg.sqp_polish_extra,
            n_perf=cfg.n_perf, r_shared=cfg.r_shared,
            perf_method=cfg.perf_trajectory, feas_tol=cfg.feas_tol,
        )
        planner = make_sqp_planner(env, k_fb, a, b, cost_fn, sqp_cfg)
        warm_len = sqp_warm_len(sqp_cfg)
        n_duals = sqp_n_duals(env, sqp_cfg)
        dual_shift = partial(
            shift_duals, n_safe=cfg.n_safe, n_obs=spec.h_obs.shape[0]
        )

        # Batched entry: the lane-major backend (solvers/sqp_lanes — the
        # batch-last solve) when the configuration supports it, transparently
        # falling back to vmapping the portable planner otherwise. Same
        # per-lane results contract.
        from safe_exploration_tpu.solvers.sqp_lanes import (
            lanes_supported,
            make_sqp_lane_solver,
        )

        cost_args = (
            {"target": spec.target} if cfg.objective == "tracking"
            else {"target": spec.target, "w_sigma": cfg.w_sigma}
            if cfg.objective == "risk_tracking" else {}
        )
        lane_solver = make_sqp_lane_solver(
            env, k_fb, a, b, cfg.objective, cost_args, sqp_cfg
        )

        def batch_planner(ssm, x0s, warm, lam=None):
            if lanes_supported(ssm, sqp_cfg, cfg.objective):
                return lane_solver(ssm, x0s, warm, lam)
            from safe_exploration_tpu.models.gp_lanes import LaneGPSSM

            if isinstance(ssm, LaneGPSSM):
                raise TypeError(
                    "per-lane (LaneGPSSM) models require the lane backend; "
                    "this solver configuration is unsupported there "
                    "(opt_k_fb/non-GN/ff-precision) — use the "
                    "stacked runtime/batch.run_batched_episodes path"
                )
            key = jax.random.PRNGKey(0)
            if lam is None:
                return jax.vmap(
                    lambda x, w: planner(key, ssm, x, w)
                )(x0s, warm)
            return jax.vmap(
                lambda x, w, la: planner(key, ssm, x, w, la)
            )(x0s, warm, lam)

        def lane_batch_supported(ssm):
            """Whether the batched EPISODE RUNNER rides the lane-major
            backend for this model — runtime/main's batch task uses it to
            pick run_batched_episodes_lanes over the vmapped runner. The
            lane episode runner needs per-lane exact-GP buffers — a shared
            GPSSM (stacked via models/gp_lanes.lane_stack_ssm at dispatch)
            or an already-stacked LaneGPSSM. Sparse models still ride the
            lane batch PLANNER (the solve), just not the per-lane
            online-append episode loop."""
            from safe_exploration_tpu.models.gp_lanes import LaneGPSSM
            from safe_exploration_tpu.models.ssm import GPSSM

            return isinstance(ssm, (GPSSM, LaneGPSSM)) and lanes_supported(
                ssm, sqp_cfg, cfg.objective
            )
    elif cfg.solver != "cem":
        raise ValueError(f"unknown solver {cfg.solver}")

    init_state, get_action, _, _ = make_safempc(
        env, mpc_cfg, planner, warm_len=warm_len, n_duals=n_duals,
        dual_shift=dual_shift,
    )
    init_state_batch = get_action_batch = None
    if batch_planner is not None:
        from safe_exploration_tpu.solvers.safempc import make_safempc_batch

        init_state_batch, get_action_batch = make_safempc_batch(
            env, mpc_cfg, batch_planner, warm_len=warm_len,
            n_duals=n_duals, dual_shift=dual_shift,
        )
    kern_types = _kern_tuple(cfg, spec.n_s)
    dtype_ = dtype

    def make_ssm(key, xs, us, resid):
        """SSM factory (family per cfg.ssm) — the runners' model constructor."""
        l_mu = jnp.full((spec.n_s,), cfg.l_mu, dtype_)
        l_sigma = jnp.full((spec.n_s,), cfg.l_sigma, dtype_)
        z_scale = (
            jnp.concatenate([spec.norm_x, spec.norm_u])
            if cfg.normalize_inputs else None
        )
        if cfg.ssm == "gp":
            from safe_exploration_tpu.models import make_gp_ssm

            return make_gp_ssm(
                kern_types, xs, us, resid, n_max=cfg.n_max,
                l_mu=l_mu, l_sigma=l_sigma, log_noise=cfg.log_noise,
                z_scale=z_scale, precision=cfg.precision,
                m_subset=cfg.m_subset or None,
            )
        if cfg.ssm == "sparse_gp":
            from safe_exploration_tpu.models.sparse_gp import make_sparse_gp_ssm

            return make_sparse_gp_ssm(
                kern_types, xs, us, resid, n_max=cfg.n_max,
                n_inducing=cfg.n_inducing, l_mu=l_mu, l_sigma=l_sigma,
                log_noise=cfg.log_noise, z_scale=z_scale,
            )
        if cfg.ssm in ("mc_dropout", "mc_dropout_concrete"):
            from safe_exploration_tpu.models.nn_ssm import make_mc_dropout_ssm

            return make_mc_dropout_ssm(
                key, xs, us, resid, n_max=cfg.n_max,
                l_mu=l_mu, l_sigma=l_sigma,
                hidden=tuple(int(h) for h in cfg.mc_hidden),
                n_samples=cfg.mc_samples, log_noise=cfg.log_noise,
                concrete=(cfg.ssm == "mc_dropout_concrete"),
            )
        raise ValueError(f"unknown ssm family: {cfg.ssm}")
    return {
        "env": env,
        "a": a,
        "b": b,
        "k_fb": k_fb,
        "planner": planner,
        "init_state": init_state,
        "get_action": get_action,
        "cost_fn": cost_fn,
        "batch_planner": batch_planner,
        "init_state_batch": init_state_batch,
        "get_action_batch": get_action_batch,
        "lane_batch_supported": lane_batch_supported,
        "kern_types": kern_types,
        "make_ssm": make_ssm,
        "l_mu": jnp.full((spec.n_s,), cfg.l_mu, dtype),
        "l_sigma": jnp.full((spec.n_s,), cfg.l_sigma, dtype),
        "cfg": cfg,
    }


# --- named config registry (parity: journal_experiment_configs) ---------------

CONFIGS: dict[str, ExperimentConfig] = {}


def register_config(cfg: ExperimentConfig) -> ExperimentConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# BASELINE.json config 1: pendulum, RBF GP, H=5, terminal-set constraint
register_config(ExperimentConfig(name="pendulum_episode"))
# BASELINE.json config 1 solved by the SQP instead of CEM
register_config(ExperimentConfig(name="pendulum_episode_sqp", solver="sqp"))
# alternative SSM families (reference ssm_cem backends, SURVEY.md §2.6)
register_config(
    ExperimentConfig(name="pendulum_episode_mcdropout", ssm="mc_dropout")
)
register_config(
    ExperimentConfig(
        name="pendulum_episode_concrete", ssm="mc_dropout_concrete"
    )
)
register_config(
    ExperimentConfig(name="pendulum_episode_sparse", ssm="sparse_gp",
                     n_inducing=32)
)
# BASELINE.json config 4 AT SCALE: "large GP inside the MPC loop" — an
# N=10,240-capacity sparse VFE model with m=256 trained inducing inputs,
# driven END-TO-END by the episodic runner on the SQP path (the bench's
# sparse_solves_per_sec rows build this same construction; reference: GPy
# ``SparseGPRegression`` inside ``safempc_simple``, SURVEY.md §2.3/§2.5).
# c_safety=1.8: the VFE variance floor is x0-independent, so the headline's
# 2.0 makes EVERY tube infeasible on this distribution (measured cliff pinned
# in tests/test_sqp_lanes_sparse.py).
register_config(
    ExperimentConfig(
        name="pendulum_large_sparse", solver="sqp", ssm="sparse_gp",
        n_max=10240, n_inducing=256, c_safety=1.8,
        n_ep=6, n_steps=50, n_init_samples=1024, hyp_iters=60,
    )
)
# production serving surface: the AOT-compiled ServeController driven against
# the simulated plant with online observe() learning (runtime/serve.py;
# task="serve" in runtime/main.py)
register_config(
    ExperimentConfig(
        name="pendulum_serve", task="serve", solver="sqp",
        sqp_outer=4, sqp_inner=3, n_steps=40, n_max=256,
    )
)
# exploration task (SURVEY.md §3.2) — greedy variant: information-seeking
# trajectory planned from the current state
register_config(
    ExperimentConfig(
        name="pendulum_exploration", task="exploration", objective="exploration",
        n_safe=3, n_steps=1,
    )
)
# STATIC safe active learning (the reference's exploration_runner semantics):
# the probe input z = (x, u) is itself the decision variable, constrained to
# be n_safe-step returnable (solvers/static_exploration.py)
register_config(
    ExperimentConfig(
        name="pendulum_exploration_static", task="exploration_static",
        solver="sqp", n_safe=3, n_steps=1, sqp_outer=8, sqp_inner=4,
    )
)
# BASELINE.json config 3: mesh-sharded batch of parallel pendulum episodes
register_config(
    ExperimentConfig(
        name="pendulum_batch", task="batch", batch_lanes=256, n_safe=3,
        n_max=128, n_steps=20, n_init_samples=24, n_ep=1,
        cem_samples=64, cem_elites=12, cem_iterations=4,
    )
)
# config 3 on the NLP path: the lane-major production pipeline — per-lane
# LaneGPSSM buffers, the batched SafeMPC state machine and the lane-major
# SQP in ONE program per step (runtime/batch.run_batched_episodes_lanes;
# runtime/main routes here via lane_batch_supported)
register_config(
    ExperimentConfig(
        name="pendulum_batch_sqp", task="batch", batch_backend="lanes", solver="sqp",
        batch_lanes=256, n_safe=3, n_max=128, n_steps=20, n_init_samples=24,
        n_ep=4,  # 4 episodes/lane: 24 + 4*20 = 104 <= n_max=128
        sqp_outer=4, sqp_inner=3,
    )
)
# BASELINE.json config 2: cart-pole, H=10, performance trajectory
register_config(
    ExperimentConfig(
        name="cartpole_episode", env="cartpole", kern_types=("rbf",),
        n_safe=10, n_perf=10, c_safety=2.0, cem_samples=192,
    )
)
# config 2 on the NLP path: joint safety+performance trajectories in the SQP
register_config(
    ExperimentConfig(
        name="cartpole_episode_sqp", env="cartpole", kern_types=("rbf",),
        solver="sqp", n_safe=10, n_perf=10, r_shared=2, c_safety=2.0,
    )
)
# config 2 with the RISK-SENSITIVE objective: the performance trajectory's
# Taylor covariance recursion priced into the plan (solvers/costs.
# risk_tracking_cost — "taylor" vs "mean_equivalent" genuinely differ here;
# batched solves ride the lane backend's Σ recursion, see _LANE_COSTS)
register_config(
    ExperimentConfig(
        name="cartpole_risk_sqp", env="cartpole", kern_types=("rbf",),
        solver="sqp", objective="risk_tracking", w_sigma=5.0,
        n_safe=10, n_perf=10, r_shared=2, c_safety=2.0,
        perf_trajectory="taylor",
    )
)
# config 2 at fleet scale: cartpole joint safety+perf learning runs on the
# lane-major pipeline (n_s=4 rides the array-form lane rollout)
register_config(
    ExperimentConfig(
        name="cartpole_batch_sqp", task="batch", batch_backend="lanes", env="cartpole",
        solver="sqp", kern_types=("rbf",), batch_lanes=128,
        n_safe=6, n_perf=10, r_shared=2, c_safety=2.0, n_max=128,
        n_steps=16, n_init_samples=40, n_ep=4,
        sqp_outer=4, sqp_inner=3,
    )
)
# BASELINE.json config 5: 6D quadrotor, joint safety+performance, long horizon.
# Long-horizon lookahead rides the 12-step performance trajectory; the safety
# tube is kept short (recursive ellipsoid sums compound the closed loop's
# non-normal transient growth — an 8-step 6D tube is infeasible outright with
# honestly-calibrated Lipschitz constants, same math as cartpole H=10).
register_config(
    ExperimentConfig(
        name="quadrotor_episode", env="quadrotor", kern_types=("rbf",),
        n_safe=5, n_perf=12, c_safety=1.5, cem_samples=256,
    )
)
# BASELINE cfg 5's plant on the lane-major NLP pipeline: 6D quadrotor batch
# learning runs (3-step tube + 5-step joint perf trajectory) — the lane
# algebra at n_s=6 (6x6 lane ellipsoid blocks, 6-var Newton systems)
register_config(
    ExperimentConfig(
        name="quadrotor_batch_sqp", task="batch", batch_backend="lanes", env="quadrotor",
        solver="sqp", kern_types=("rbf",), batch_lanes=64,
        n_safe=3, n_perf=5, r_shared=1, n_max=96, c_safety=1.5,
        n_steps=8, n_init_samples=40, n_ep=2, log_noise=-4.5,
        sqp_outer=4, sqp_inner=3,
    )
)
# uncertainty-estimation scenario (SURVEY.md §2.8)
register_config(
    ExperimentConfig(name="pendulum_uncertainty", task="uncertainty", n_steps=20)
)
