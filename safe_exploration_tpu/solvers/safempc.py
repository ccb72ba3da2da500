"""SafeMPC orchestration: planner + feasibility fallback chain as a jit state machine.

Parity: reference ``safempc_simple.py::SimpleSafeMPC`` control logic (SURVEY.md
§2.5) and its "fault tolerance" (§5.3): on solver infeasibility the controller
re-uses the PREVIOUS still-valid safe trajectory shifted by one (applying
``k_ff_{t+1} + k_fb (x - p_{t+1})``), and once that is exhausted falls back to the
terminal safe LQR policy; a consecutive-failure counter is tracked. The papers'
safety theorem rests on this chain, so here it is a first-class ``lax.cond`` state
machine — not Python exception handling — and therefore works inside jit/vmap/scan
(the reference cannot batch this at all).

The planner is PLUGGABLE (the reference's CasADi-NLP vs torch-CEM seam, SURVEY.md
§2.6): anything with signature
``planner(key, ssm, x0, warm_mean) -> (k_ff_all, feasible, violation, info)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from safe_exploration_tpu.envs.base import Env, linearize_discretize
from safe_exploration_tpu.models.ssm import GPSSM
from safe_exploration_tpu.ops.linalg import dlqr
from safe_exploration_tpu.reachability.onestep import multistep_reachability
from safe_exploration_tpu.utils import struct

__all__ = ["SafeMPCState", "SafeMPCConfig", "make_safempc"]

PlannerFn = Callable[..., tuple]


class SafeMPCConfig(NamedTuple):
    """Static SafeMPC knobs (mirrors reference config fields, SURVEY.md §2.5/§2.8)."""

    n_safe: int = 5                 # safety horizon
    c_safety: float = 2.5           # beta_safety confidence scaling
    lqr_w_x: float = 1.0            # LQR state weight (prior-model feedback)
    lqr_w_u: float = 1.0            # LQR control weight


@struct.dataclass
class SafeMPCState:
    """Carried controller state (a pytree): the stored safe plan + failure book-keeping."""

    k_ff_plan: jax.Array   # (T, n_u) last feasible feed-forward plan
    p_plan: jax.Array      # (T, n_s) centers at which each stored control applies
    plan_idx: jax.Array    # () int32: next stored stage to execute on failure (T = exhausted)
    n_fail: jax.Array      # () int32: consecutive infeasible solves
    warm_mean: jax.Array   # (n_warm, n_u) planner warm start (shifted previous solution)
    lam: jax.Array         # (n_duals,) dual warm start (zeros when unused)


def make_safempc(
    env: Env,
    cfg: SafeMPCConfig,
    planner: PlannerFn,
    warm_len: int | None = None,
    n_duals: int = 0,
    dual_shift: Callable | None = None,
):
    """Build the SafeMPC pure functions for one environment.

    ``warm_len`` is the row count of the planner's warm-start matrix — equal to
    n_safe for safety-only planners, and n_safe + (n_perf - r_shared) when the
    planner carries a joint performance trajectory (solvers/sqp.sqp_warm_len);
    planners return the matching full decision matrix as ``info['warm_next']``.

    ``n_duals`` > 0 enables dual warm-starting: the planner is called as
    ``planner(key, ssm, x0, warm, lam)`` and must return ``info['lam']``; the
    carried multipliers keep constraints active across receding-horizon
    re-solves (measured: short-budget warm solves are infeasible without it).

    Returns (init_state, get_action, k_fb, (a, b)):
      * ``init_state() -> SafeMPCState``
      * ``get_action(key, state, ssm, x) -> (u, new_state, info)`` — fully
        jit/vmap-compatible; ``info`` carries feasibility/fallback telemetry.

    The per-stage feedback ``k_fb`` is fixed from discrete LQR on the prior
    linearization (reference: ``utils.dlqr`` on ``env.linearize_discretize``,
    SURVEY.md §2.5), negated so u = k_ff + k_fb (x - p).
    """
    spec = env.spec
    a, b = linearize_discretize(env)
    dtype = a.dtype
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    n_warm = t_len if warm_len is None else warm_len

    k_lqr, _ = dlqr(
        a, b,
        cfg.lqr_w_x * jnp.eye(n_s, dtype=dtype),
        cfg.lqr_w_u * jnp.eye(n_u, dtype=dtype),
    )
    k_fb = -k_lqr  # (n_u, n_s)

    def init_state() -> SafeMPCState:
        return SafeMPCState(
            k_ff_plan=jnp.zeros((t_len, n_u), dtype),
            p_plan=jnp.zeros((t_len, n_s), dtype),
            plan_idx=jnp.asarray(t_len, jnp.int32),  # nothing stored yet
            n_fail=jnp.asarray(0, jnp.int32),
            warm_mean=jnp.zeros((n_warm, n_u), dtype),
            lam=jnp.zeros((n_duals,), dtype),
        )

    def _shift_warm(warm: jax.Array) -> jax.Array:
        """Receding-horizon shift of the stacked decision matrix.

        The warm matrix is [k_ff (n_safe) | u_perf_free (n_warm - n_safe)];
        the two blocks are shifted INDEPENDENTLY (each duplicates its last
        row), mirroring shift_duals. A uniform shift would leak the first
        free performance control into the last safety stage — a control for
        time r_shared, not n_safe (cross-block contamination that degrades
        short-budget warm-start convergence).
        """
        k_ff = warm[:t_len]
        k_ff = jnp.concatenate([k_ff[1:], k_ff[-1:]], axis=0)
        if n_warm > t_len:
            perf = warm[t_len:]
            perf = jnp.concatenate([perf[1:], perf[-1:]], axis=0)
            return jnp.concatenate([k_ff, perf], axis=0)
        return k_ff

    def get_action(key, state: SafeMPCState, ssm: GPSSM, x: jax.Array):
        if n_duals > 0:
            k_ff_new, feasible, violation, pinfo = planner(
                key, ssm, x, state.warm_mean, state.lam
            )
            lam_next = pinfo["lam"]
        else:
            k_ff_new, feasible, violation, pinfo = planner(
                key, ssm, x, state.warm_mean
            )
            lam_next = state.lam
        warm_next = pinfo.get("warm_next", k_ff_new)

        def on_success(_):
            # predicted centers: control t applies at center p_{t} (p_0 = x)
            k_fb_all = jnp.tile(k_fb[None], (t_len, 1, 1))
            p_traj, _, _ = multistep_reachability(
                ssm, x, k_ff_new, k_fb_all, a, b, cfg.c_safety
            )
            p_refs = jnp.concatenate([x[None], p_traj[:-1]], axis=0)
            u = k_ff_new[0]
            new_state = SafeMPCState(
                k_ff_plan=k_ff_new,
                p_plan=p_refs,
                plan_idx=jnp.asarray(1, jnp.int32),
                n_fail=jnp.asarray(0, jnp.int32),
                warm_mean=_shift_warm(warm_next),
                lam=dual_shift(lam_next) if dual_shift is not None else lam_next,
            )
            return u, new_state

        def on_failure(_):
            idx = jnp.minimum(state.plan_idx, t_len - 1)
            have_stored = state.plan_idx < t_len
            # stored-plan control with feedback around its reference center
            u_stored = state.k_ff_plan[idx] + k_fb @ (x - state.p_plan[idx])
            # terminal safe controller: LQR toward the target equilibrium
            u_lqr = k_fb @ (x - spec.target)
            u = jnp.where(have_stored, u_stored, u_lqr)
            u = jnp.clip(u, spec.u_min, spec.u_max)
            new_state = SafeMPCState(
                k_ff_plan=state.k_ff_plan,
                p_plan=state.p_plan,
                plan_idx=jnp.minimum(state.plan_idx + 1, t_len),
                n_fail=state.n_fail + 1,
                warm_mean=_shift_warm(state.warm_mean),
                # decay rather than keep: a failed solve's duals are stale
                lam=0.5 * state.lam,
            )
            return u, new_state

        u, new_state = jax.lax.cond(feasible, on_success, on_failure, operand=None)
        info = {
            "feasible": feasible,
            "violation": violation,
            "n_fail": new_state.n_fail,
            "used_fallback": jnp.logical_not(feasible),
            **pinfo,
        }
        return u, new_state, info

    return init_state, get_action, k_fb, (a, b)


def make_safempc_batch(
    env: Env,
    cfg: SafeMPCConfig,
    batch_planner: Callable,
    warm_len: int | None = None,
    n_duals: int = 0,
    dual_shift: Callable | None = None,
):
    """Batched SafeMPC: the same state machine over B lanes in ONE program.

    ``batch_planner`` is build_experiment's batched entry
    (``batch_planner(ssm, x0s, warm, lam) -> (k_ff, feasible, violation,
    info)`` with leading batch dims) — the lane-major SQP backend where
    supported. The per-lane ``lax.cond`` of :func:`make_safempc` becomes a
    lane-wise ``where`` (both branches are data, not control); everything
    else is the portable state machine with a leading batch axis, so the
    fallback-chain semantics (stored-plan shift -> terminal LQR, n_fail,
    warm/dual shifts, dual decay on failure) are identical — pinned against
    the vmapped portable path in tests/test_sqp_lanes.py.

    Returns (init_state_batch, get_action_batch):
      * ``init_state_batch(batch) -> SafeMPCState`` (leading batch dims)
      * ``get_action_batch(state, ssm, xs (B, n_s)) -> (u (B, n_u),
        new_state, info)``
    """
    spec = env.spec
    a, b = linearize_discretize(env)
    dtype = a.dtype
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    n_warm = t_len if warm_len is None else warm_len

    k_lqr, _ = dlqr(
        a, b,
        cfg.lqr_w_x * jnp.eye(n_s, dtype=dtype),
        cfg.lqr_w_u * jnp.eye(n_u, dtype=dtype),
    )
    k_fb = -k_lqr

    def init_state_batch(batch: int) -> SafeMPCState:
        return SafeMPCState(
            k_ff_plan=jnp.zeros((batch, t_len, n_u), dtype),
            p_plan=jnp.zeros((batch, t_len, n_s), dtype),
            plan_idx=jnp.full((batch,), t_len, jnp.int32),
            n_fail=jnp.zeros((batch,), jnp.int32),
            warm_mean=jnp.zeros((batch, n_warm, n_u), dtype),
            lam=jnp.zeros((batch, n_duals), dtype),
        )

    def _shift_warm(warm: jax.Array) -> jax.Array:
        k_ff = warm[:, :t_len]
        k_ff = jnp.concatenate([k_ff[:, 1:], k_ff[:, -1:]], axis=1)
        if n_warm > t_len:
            perf = warm[:, t_len:]
            perf = jnp.concatenate([perf[:, 1:], perf[:, -1:]], axis=1)
            return jnp.concatenate([k_ff, perf], axis=1)
        return k_ff

    def get_action_batch(state: SafeMPCState, ssm, xs: jax.Array):
        if n_duals > 0:
            k_ff_new, feasible, violation, pinfo = batch_planner(
                ssm, xs, state.warm_mean, state.lam
            )
            lam_next = pinfo["lam"]
        else:
            k_ff_new, feasible, violation, pinfo = batch_planner(
                ssm, xs, state.warm_mean
            )
            lam_next = state.lam
        warm_next = pinfo.get("warm_next", k_ff_new)

        if "p_traj" in pinfo:
            p_traj = pinfo["p_traj"]                        # (B, T, n_s)
        else:
            k_fb_all = jnp.tile(k_fb[None], (t_len, 1, 1))
            p_traj, _, _ = jax.vmap(
                lambda x, kff: multistep_reachability(
                    ssm, x, kff, k_fb_all, a, b, cfg.c_safety
                )
            )(xs, k_ff_new)
        p_refs = jnp.concatenate([xs[:, None], p_traj[:, :-1]], axis=1)

        feas = feasible[:, None]                            # (B, 1)
        feas_t = feasible[:, None, None]

        # success branch values
        u_ok = k_ff_new[:, 0]
        # failure branch values (stored-plan shift -> terminal LQR)
        idx = jnp.minimum(state.plan_idx, t_len - 1)
        have_stored = (state.plan_idx < t_len)[:, None]
        onehot = (
            jnp.arange(t_len)[None, :] == idx[:, None]
        ).astype(dtype)                                     # (B, T)
        kff_st = jnp.einsum("bt,btu->bu", onehot, state.k_ff_plan)
        p_st = jnp.einsum("bt,bts->bs", onehot, state.p_plan)
        u_stored = kff_st + (xs - p_st) @ k_fb.T
        u_lqr = (xs - spec.target[None]) @ k_fb.T
        u_fail = jnp.clip(
            jnp.where(have_stored, u_stored, u_lqr), spec.u_min, spec.u_max
        )

        u = jnp.where(feas, u_ok, u_fail)
        shifted_lam = (
            jax.vmap(dual_shift)(lam_next)
            if dual_shift is not None else lam_next
        )
        new_state = SafeMPCState(
            k_ff_plan=jnp.where(feas_t, k_ff_new, state.k_ff_plan),
            p_plan=jnp.where(feas_t, p_refs, state.p_plan),
            plan_idx=jnp.where(
                feasible, jnp.asarray(1, jnp.int32),
                jnp.minimum(state.plan_idx + 1, t_len),
            ),
            n_fail=jnp.where(feasible, 0, state.n_fail + 1),
            warm_mean=jnp.where(
                feas_t, _shift_warm(warm_next), _shift_warm(state.warm_mean)
            ),
            lam=jnp.where(feas, shifted_lam, 0.5 * state.lam),
        )
        info = {
            "feasible": feasible,
            "violation": violation,
            "n_fail": new_state.n_fail,
            "used_fallback": jnp.logical_not(feasible),
            **pinfo,
        }
        return u, new_state, info

    return init_state_batch, get_action_batch
