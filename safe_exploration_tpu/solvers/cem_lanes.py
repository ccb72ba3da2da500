"""Lane-major constrained CEM planner — the sampling-based solver on the
batch-last backend.

WHY. The portable CEM (solvers/cem.py) scores its M control-sequence samples
with ``vmap(score_one)``: every tube intermediate carries a leading samples
dim in front of tiny trailing dims (2x2 ellipsoid blocks, n_u-wide controls)
— the layout the lane-major SQP avoids (solvers/sqp_lanes.py module
docstring). Here the SAMPLE x INSTANCE product IS the lane axis: scoring M
sequences for B problem instances runs ONE lane-major tube rollout of width
L = M*B, so the GP contractions are (n, L) matmuls and all ellipsoid algebra
runs elementwise over the wide lane axis.
The iteration machinery (per-lane elites via ``take_along_axis`` over the
sample axis, smoothed refits, best-ever archive) stays (n_var, B).

Covers the same configuration envelope as the lane SQP's model side: GP-SSM
over the full kernel menu, f32 factors, the stock cost menu (tracking /
exploration / Σ-consuming risk_tracking via the lane covariance recursion),
optional joint performance trajectory. Falls back to vmapping the portable
``cem_plan`` otherwise (runtime/config.build_experiment owns the dispatch).

Parity: reference ``safempc_cem.py::CemSafeMPC`` (SURVEY.md §2.6) — same
constrained-CEM algorithm as solvers/cem.py (sample -> roll tubes -> penalized
score -> elites -> refit; best-ever archive; mean-elite retention), re-laid
out. The two backends draw DIFFERENT random streams (the noise tensor shapes
differ), so parity with the portable planner is pinned at (a) exact f64
scoring parity on fixed sequences and (b) decision/quality level on full
solves (tests/test_cem_lanes.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_exploration_tpu.models.gp_lanes import _KERNEL_PARTS
from safe_exploration_tpu.models.sparse_gp import SparseGPSSM
from safe_exploration_tpu.models.ssm import GPSSM
from safe_exploration_tpu.solvers.cem import CemConfig, cem_warm_len
from safe_exploration_tpu.solvers.sqp_lanes import (
    _LANE_COSTS,
    _cost_lanes,
    _dist_lanes,
    _gp_of,
    _rollout_y_lanes,
    _wants_sigma,
)

__all__ = ["cem_lanes_supported", "cem_plan_lanes", "make_cem_lane_solver"]


class _TubeCfg(NamedTuple):
    """The subset of rollout knobs _rollout_lanes/_rollout_perf_lanes read."""

    n_safe: int
    c_safety: float
    n_perf: int
    perf_method: str = "taylor"


def cem_lanes_supported(ssm, cost_kind: str) -> bool:
    """Whether the lane CEM covers this model/objective — the model envelope
    of the lane SQP: shared exact GP-SSM or inducing-point SparseGPSSM
    (per-lane LaneGPSSM models would need the buffers tiled across the M
    sample lanes and stay on the vmapped path)."""
    if not isinstance(ssm, (GPSSM, SparseGPSSM)):
        return False
    gp = _gp_of(ssm)
    return (
        all(kt in _KERNEL_PARTS for kt in gp.kern_types)
        and getattr(gp, "precision", "f32") == "f32"
        # the _LANE_COSTS whitelist (sqp_lanes): tracking/exploration are
        # Σ-free; risk_tracking runs the lane Σ recursion on the perf
        # rollout (want_sigma) — all three are covered here
        and cost_kind in _LANE_COSTS
    )


def cem_plan_lanes(
    key: jax.Array,
    ssm: GPSSM,
    x0s: jax.Array,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    u_min: jax.Array,
    u_max: jax.Array,
    h_mat_obs: jax.Array,
    h_obs: jax.Array,
    h_mat_safe: jax.Array,
    h_safe: jax.Array,
    c_safety: float,
    cost_kind: str,
    cost_args: dict,
    cfg: CemConfig,
    warm: jax.Array | None = None,
):
    """Constrained-CEM solve for B instances at once, lane-major.

    Args mirror solvers/cem.cem_plan batched: x0s (B, n_s), warm
    (B, cem_warm_len(cfg), n_u) or None; ONE PRNG key drives the whole
    batch (per-lane noise comes from the lane axis of each draw).

    Returns (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info)
    with info = {cost (B,), warm_next (B, t_total, n_u), p_traj
    (B, n_safe, n_s)} — the batched-planner contract of build_experiment
    (same as the lane SQP), so make_safempc_batch and the runners can use
    either solver family.
    """
    t_len, n_u = cfg.n_safe, u_min.shape[0]
    t_total = cem_warm_len(cfg)
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    n_s = x0s.shape[1]
    bsz = x0s.shape[0]
    m = cfg.n_samples
    dtype = x0s.dtype
    n_var = t_total * n_u

    lo = jnp.tile(u_min, t_total)[:, None]                  # (n_var, 1)
    hi = jnp.tile(u_max, t_total)[:, None]
    u_range = jnp.tile((u_max - u_min) * 0.5, t_total)[:, None]

    s_lift = jnp.concatenate([jnp.eye(n_s, dtype=dtype), k_fb], axis=0)
    bmat = s_lift.T @ s_lift
    tube_cfg = _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=cfg.n_perf,
                        perf_method=cfg.perf_method)
    want_sigma = _wants_sigma(cost_kind, cfg.n_perf)
    def make_score(x0_cols):
        """Penalized scorer over lanes of width x0_cols[0].size."""
        x0_rows = [x0_cols[i] for i in range(n_s)]

        def score(u_flat):
            y = _rollout_y_lanes(ssm, u_flat, x0_rows, k_fb, a, b,
                                 tube_cfg, bmat, r, n_u,
                                 want_sigma=want_sigma)
            g = _dist_lanes(y, t_len, n_s, h_mat_obs, h_obs,
                            h_mat_safe, h_safe)
            viol = jnp.sum(jnp.maximum(g, 0.0), axis=0)
            cost = _cost_lanes(cost_kind, cost_args, y, u_flat, t_len,
                               n_s, n_u, n_perf=cfg.n_perf, r=r)
            return cost + cfg.penalty * viol, viol, cost, y

        return score

    # sampling lanes: L = M*B, column index = sample*B + instance
    x0_wide = jnp.broadcast_to(
        x0s.T[:, None, :], (n_s, m, bsz)
    ).reshape(n_s, m * bsz)
    score_wide = make_score(x0_wide)
    score_b = make_score(x0s.T)

    mean0 = (
        jnp.zeros((n_var, bsz), dtype) if warm is None
        else jnp.moveaxis(warm.reshape(bsz, n_var), 0, -1)
    )
    std0 = jnp.broadcast_to(
        cfg.init_std * u_range.astype(dtype), (n_var, bsz)
    )

    def iteration(carry, it_key):
        mean, std, best_k, best_score = carry
        eps = jax.random.normal(it_key, (m, n_var, bsz), dtype)
        samples = jnp.clip(mean[None] + std[None] * eps, lo[None], hi[None])
        # always include the distribution mean itself (elite retention)
        samples = samples.at[0].set(jnp.clip(mean, lo, hi))
        scores = score_wide(
            jnp.moveaxis(samples, 0, 1).reshape(n_var, m * bsz)
        )[0].reshape(m, bsz)
        # per-lane elites over the sample axis (M is small: one argsort)
        elite_idx = jnp.argsort(scores, axis=0)[: cfg.n_elites]  # (k, B)
        elites = jnp.take_along_axis(
            samples, elite_idx[:, None, :], axis=0
        )                                                   # (k, n_var, B)
        new_mean = jnp.mean(elites, axis=0)
        new_std = jnp.std(elites, axis=0) + cfg.min_std
        mean = cfg.smoothing * mean + (1.0 - cfg.smoothing) * new_mean
        std = cfg.smoothing * std + (1.0 - cfg.smoothing) * new_std
        # best-ever archive per lane
        it_best = jnp.argmin(scores, axis=0)                # (B,)
        cand = jnp.take_along_axis(
            samples,
            jnp.broadcast_to(it_best[None, None, :], (1, n_var, bsz)),
            axis=0,
        )[0]                                                # (n_var, B)
        it_score = jnp.min(scores, axis=0)
        better = it_score < best_score
        best_k = jnp.where(better[None, :], cand, best_k)
        best_score = jnp.where(better, it_score, best_score)
        return (mean, std, best_k, best_score), None

    keys = jax.random.split(key, cfg.n_iterations)
    big = jnp.full((bsz,), jnp.inf, dtype)
    (mean, _, best_k, best_score), _ = jax.lax.scan(
        iteration, (mean0, std0, mean0, big), keys
    )

    # return the better of (refined mean, best-ever sample) per lane
    mean_k = jnp.clip(mean, lo, hi)
    mean_score, _, _, _ = score_b(mean_k)
    use_mean = mean_score <= best_score
    seq_best = jnp.where(use_mean[None, :], mean_k, best_k)
    _, viol, cost, y_fin = score_b(seq_best)
    feasible = viol <= cfg.feas_tol
    p_traj = jnp.moveaxis(y_fin[: t_len * n_s], -1, 0).reshape(
        bsz, t_len, n_s
    )
    u_mat = jnp.moveaxis(seq_best, -1, 0).reshape(bsz, t_total, n_u)
    info = {"cost": cost, "warm_next": u_mat, "p_traj": p_traj}
    return u_mat[:, :t_len], feasible, viol, info


def make_cem_lane_solver(env, k_fb, a, b, c_safety, cost_kind, cost_args,
                         cfg: CemConfig):
    """Batched-planner factory mirroring sqp_lanes.make_sqp_lane_solver:

        batch_planner(ssm, x0s (B, n_s), warm, key=...) ->
            (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info)
    """
    spec = env.spec

    def batch_planner(ssm, x0s, warm, key=None):
        k = jax.random.PRNGKey(0) if key is None else key
        return cem_plan_lanes(
            k, ssm, x0s, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            c_safety, cost_kind, cost_args, cfg, warm=warm,
        )

    return batch_planner
