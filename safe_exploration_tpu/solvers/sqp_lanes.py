"""Lane-major batched SafeMPC solver — the batch-last SQP backend.

WHY THIS FILE EXISTS. The portable solver (solvers/sqp.py) is batched with
``jax.vmap``, which places the batch dimension FIRST in every intermediate,
in front of tiny trailing dims (shapes like f32[512,3,2,2]): the batched
solve becomes tens of thousands of small ops whose layout, not their FLOPs,
sets the cost on a vector machine. ``vmap(in_axes=-1)`` does not help:
batching rules normalize the batch dim per primitive. The design was made
for the accelerator the solver was first tuned on; whether it still beats
the vmapped form on the H100 is not measured yet (bench.py keeps both).

This backend instead writes the whole solve BATCH-LAST by construction:

  * every per-lane scalar is a ``(B,)`` array;
  * tiny-matrix algebra (ellipsoids, closed-loop maps, Newton systems) is
    unrolled over indices, exactly like sqp.py's ``_solve_spd_unrolled``;
  * GP contractions run as ``(n, B)`` matmuls;
  * the Gauss-Newton machinery comes from ``jax.linearize`` + basis-tangent
    jvps, so AD never reintroduces a leading batch dim (tangent/cotangent
    shapes mirror the primal ``(..., B)`` shapes).

The backend covers the production cold/warm solve configuration (GP-SSM over
the full kernel menu, GN Hessian, exact line search, fixed feedback gains;
with or without a joint performance trajectory) and falls back to the
portable path otherwise (opt_k_fb, exact Hessian, non-GP models); parity
with ``solve_safempc_nlp`` is pinned in tests/test_sqp_lanes.py.

Parity: reference ``safempc_simple.py::SimpleSafeMPC`` solve path +
IPOPT/MUMPS (SURVEY.md §2.5, §3.3) — same NLP, same augmented-Lagrangian /
polish / rescue schedule as solvers/sqp.py.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from safe_exploration_tpu.models.gp_lanes import (
    _KERNEL_PARTS,
    LaneGPSSM,
    lane_predict,
)
from safe_exploration_tpu.models.sparse_gp import SparseGPSSM
from safe_exploration_tpu.models.ssm import GPSSM
from safe_exploration_tpu.solvers.sqp import SqpConfig, _solve_spd_unrolled

__all__ = ["lanes_supported", "solve_safempc_lanes", "make_sqp_lane_solver"]


# ---------------------------------------------------------------- lane algebra
# A lane matrix is a nested Python list m[i][j] of (B,) arrays; a lane vector
# is a list v[i] of (B,) arrays. Unrolled index loops keep every op on fully
# lane-tiled (B,) shapes.


def _mat_mul(a, b):
    n, m, k = len(a), len(b[0]), len(b)
    return [[sum(a[i][l] * b[l][j] for l in range(k)) for j in range(m)]
            for i in range(n)]


def _mat_vec(a, v):
    return [sum(a[i][j] * v[j] for j in range(len(v))) for i in range(len(a))]


def _trace(a):
    return sum(a[i][i] for i in range(len(a)))


def _const_rows(mat: jax.Array):
    """A constant (k, m) jax array as a list-of-lists of scalars (broadcast
    against (B,) lanes)."""
    k, m = mat.shape
    return [[mat[i, j] for j in range(m)] for i in range(k)]


# ----------------------------------------------------------------- GP (lanes)


def _gp_of(ssm):
    """The underlying GP state of any lane-capable SSM family: exact
    (GPSSM.gp), per-lane exact (LaneGPSSM.gp) or inducing-point
    (SparseGPSSM.sgp). All three expose kern_types/params/log_noise/n_out."""
    return ssm.sgp if isinstance(ssm, SparseGPSSM) else ssm.gp


def _gp_predict_lanes(ssm, z: jax.Array, *, want_jac: bool):
    """Posterior mean/var (+ closed-form mean Jacobian) at B query lanes.

    ``z``: (d_in, B) RAW state-action inputs (lane-last). Mirrors
    models/gp._predict_dim + gp_predict_mean_jac (incl. the conditioning-
    aware variance floor) and models/ssm.ssm_predict_jac's z_scale chain
    rule, with every contraction shaped (n, B) — plain matmuls.

    Returns (mu (e, B), var (e, B)[, jac (e, d_in, B)]).

    For a :class:`LaneGPSSM` (per-lane evolving models, runtime/batch lane
    episodes) each lane queries ITS OWN posterior — dispatched to
    models/gp_lanes.lane_predict, same contract.

    For a :class:`SparseGPSSM` (inducing-point tier, BASELINE cfg 4 —
    reference ``SimpleGPModel`` with a ``Z`` set, SURVEY.md §2.3) the same
    body runs over the m inducing rows: mean weights are ``alpha``
    (= sparse_gp_predict), the variance quadratic form contracts against the
    precomputed ``vmat`` and no mask is needed (inducing rows are all
    active) — parity with sparse_gp_predict_mean_jac pinned in
    tests/test_sqp_lanes_sparse.py.
    """
    if isinstance(ssm, LaneGPSSM):
        return lane_predict(ssm, z, want_jac=want_jac)
    sparse = isinstance(ssm, SparseGPSSM)
    gp = _gp_of(ssm)
    xr = gp.z if sparse else gp.x          # support rows: inducing | data
    w_mean = gp.alpha if sparse else gp.beta
    w_var = gp.vmat if sparse else gp.kinv
    mask = None if sparse else gp.mask
    zz = z if ssm.z_scale is None else z / ssm.z_scale[:, None]
    eps = jnp.finfo(zz.dtype).eps
    mus, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        kv = sum(_kv_part_shared(p, params, xr, zz) for p in parts)  # (n, B)
        if mask is not None:
            kv = kv * mask[:, None]
        mus.append(w_mean[d] @ kv)                         # (B,)
        kzz = sum(_kzz_part_shared(p, params, zz) for p in parts)
        floor = jnp.maximum(8.0 * eps * kzz, 1e-12)
        vars_.append(
            jnp.maximum(kzz - jnp.sum(kv * (w_var[d] @ kv), axis=0), floor)
        )
        if want_jac:
            # closed form (kernels.weighted_mean_jac, matmul lane form);
            # the weights carry the mask, so per-part kv rows need none
            c = w_mean[d] if mask is None else mask * w_mean[d]
            jac = sum(
                _jac_part_shared(p, params, xr, zz, c) for p in parts
            )                                              # (d_in, B)
            if ssm.z_scale is not None:
                jac = jac / ssm.z_scale[:, None]
            jacs.append(jac)
    mu = jnp.stack(mus)
    var = jnp.stack(vars_)
    if want_jac:
        return mu, var, jnp.stack(jacs)                    # (e, d_in, B)
    return mu, var


def _d2_shared(params, x, zz):
    """ARD squared distances (n, B) in the matmul form."""
    ls = jnp.exp(params["log_lengthscales"])
    xs = x / ls[None, :]                                   # (n, d_in)
    zs = zz / ls[:, None]                                  # (d_in, B)
    return jnp.maximum(
        jnp.sum(xs * xs, axis=-1)[:, None]
        + jnp.sum(zs * zs, axis=0)[None, :]
        - 2.0 * (xs @ zs),
        0.0,
    )


def _kv_part_shared(part, params, x, zz):
    """One kernel part's cross-covariance k(z_b, X), (n, B) — the shared-
    model matmul counterpart of models/gp_lanes._lane_kv_part."""
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return (x * v[None, :]) @ zz
    sf2 = jnp.exp(2.0 * params["log_sf"])
    if part == "rbf":
        return sf2 * jnp.exp(-0.5 * _d2_shared(params, x, zz))
    d = jnp.sqrt(_d2_shared(params, x, zz) + 1e-30)
    s5 = jnp.sqrt(5.0).astype(d.dtype)
    return sf2 * (1.0 + s5 * d + (5.0 / 3.0) * d * d) * jnp.exp(-s5 * d)


def _kzz_part_shared(part, params, zz):
    """One kernel part's prior variance at the queries, (B,)."""
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return v @ (zz * zz)
    return jnp.exp(2.0 * params["log_sf"]) * jnp.ones_like(zz[0])


def _jac_part_shared(part, params, x, zz, c):
    """One kernel part's weighted-mean input gradient, (d_in, B) —
    models/kernels.weighted_mean_jac in the shared-model matmul form."""
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return (v * (c @ x))[:, None] * jnp.ones_like(zz[:1])
    ls = jnp.exp(params["log_lengthscales"])
    if part == "rbf":
        w = _kv_part_shared("rbf", params, x, zz) * c[:, None]
    else:  # mat52
        sf2 = jnp.exp(2.0 * params["log_sf"])
        r = jnp.sqrt(_d2_shared(params, x, zz) + 1e-30)
        s5 = jnp.sqrt(5.0).astype(r.dtype)
        w = c[:, None] * (5.0 / 3.0) * sf2 * (1.0 + s5 * r) * jnp.exp(-s5 * r)
    return (x.T @ w - zz * jnp.sum(w, axis=0)[None, :]) / (ls * ls)[:, None]


# ------------------------------------------------------------- tube (lanes)


def _max_eig_lanes(m, iters: int = 30):
    """Dominant eigenvalue of lane matrices M = Q B (PSD product) — mirrors
    ops/lipschitz.max_eig_psd_product (closed form at n=2, trace-normalized
    repeated squaring + Rayleigh refinement at n>=3), unrolled over lanes."""
    n = len(m)
    if n == 1:
        return jnp.maximum(m[0][0], 0.0)
    if n == 2:
        tr = m[0][0] + m[1][1]
        det = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
        return jnp.maximum(0.5 * (tr + disc), 0.0)
    scale = _trace(m) / n + 1e-30
    mn = [[m[i][j] / scale for j in range(n)] for i in range(n)]
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):
        mn = _mat_mul(mn, mn)
        s = _trace(mn) / n + 1e-30
        mn = [[mn[i][j] / s for j in range(n)] for i in range(n)]
    v = [1.0 + 1e-3 * i for i in range(n)]
    nrm = sum(float(x) ** 2 for x in v) ** 0.5
    v = [jnp.asarray(x / nrm, m[0][0].dtype) * jnp.ones_like(m[0][0])
         for x in v]
    for _ in range(n_refine):
        w = _mat_vec(mn, v)
        nw = jnp.sqrt(sum(x * x for x in w)) + 1e-30
        v = [x / nw for x in w]
    mv = _mat_vec(m, v)
    num = sum(a * b for a, b in zip(v, mv))
    den = sum(a * a for a in v) + 1e-30
    return jnp.maximum(num / den, 0.0)


def _sum_two_ellipsoids_q(q1, q2):
    """Shape part of ops/ellipsoid.sum_two_ellipsoids on lane matrices."""
    n = len(q1)
    eps = 1e-30
    t1 = _trace(q1) + eps
    t2 = _trace(q2) + eps
    c = jnp.sqrt(t1 / t2)
    return [[(1.0 + 1.0 / c) * q1[i][j] + (1.0 + c) * q2[i][j]
             for j in range(n)] for i in range(n)]


def _rollout_lanes(ssm, u_flat, x0, k_fb, a, b, cfg, bmat):
    """Lane tube rollout: u_flat (n_var, B), x0 (n_s, B) ->
    (p_traj, q_traj, var_traj) as lists over stages of lane structures.

    Mirrors reachability/onestep.multistep_reachability from a POINT state
    (the SafeMPC case): stage 0 is the point step, stages 1..T-1 the
    closed-loop ellipsoid steps. ``bmat`` is the constant S^T S of the
    Lipschitz lift (k_fb fixed per stage — cfg.opt_k_fb unsupported here).
    """
    t_len = cfg.n_safe
    n_s = len(x0)
    n_u = k_fb.shape[0]
    noise = jnp.exp(2.0 * _gp_of(ssm).log_noise)           # (e,)
    a_rows = _const_rows(a)
    b_rows = _const_rows(b)
    kfb_rows = _const_rows(k_fb)
    c_safety = cfg.c_safety

    def kff_at(t):
        return [u_flat[t * n_u + i] for i in range(n_u)]

    # stage 0: point step (onestep_reachability_point)
    kff = kff_at(0)
    z = jnp.stack(list(x0) + kff)                          # (d_in, B)
    mu, var = _gp_predict_lanes(ssm, z, want_jac=False)
    p = [
        sum(a_rows[i][j] * x0[j] for j in range(n_s))
        + sum(b_rows[i][k] * kff[k] for k in range(n_u))
        + mu[i]
        for i in range(n_s)
    ]
    zero = jnp.zeros_like(p[0])
    hw0 = [c_safety * jnp.sqrt(var[i] + noise[i]) for i in range(n_s)]
    q = [[n_s * hw0[i] * hw0[i] if i == j else zero for j in range(n_s)]
         for i in range(n_s)]
    p_traj, q_traj, var_traj = [p], [q], [[var[i] for i in range(n_s)]]

    l_mu, l_sigma = ssm.l_mu, ssm.l_sigma
    for t in range(1, t_len):
        kff = kff_at(t)
        z = jnp.stack(list(p) + kff)
        mu, var, jac = _gp_predict_lanes(ssm, z, want_jac=True)
        p_next = [
            sum(a_rows[i][j] * p[j] for j in range(n_s))
            + sum(b_rows[i][k] * kff[k] for k in range(n_u))
            + mu[i]
            for i in range(n_s)
        ]
        # H = a + J_x + (b + J_u) k_fb  (onestep_reachability step 3)
        h = [[
            a_rows[i][j] + jac[i, j]
            + sum((b_rows[i][k] + jac[i, n_s + k]) * kfb_rows[k][j]
                  for k in range(n_u))
            for j in range(n_s)] for i in range(n_s)]
        q_lin = _mat_mul(_mat_mul(h, q), [[h[j][i] for j in range(n_s)]
                                          for i in range(n_s)])
        # Lipschitz remainder: r^2 = lambda_max(Q @ S^T S)
        qb = _mat_mul(q, _const_rows(bmat))
        r_sqr = _max_eig_lanes(qb)
        r = jnp.sqrt(jnp.maximum(r_sqr, 0.0))
        u_mu = [0.5 * l_mu[i] * r_sqr for i in range(n_s)]
        u_sig = [l_sigma[i] * r for i in range(n_s)]
        hw_t = [u_mu[i] for i in range(n_s)]
        q_taylor = [[n_s * hw_t[i] * hw_t[i] if i == j else zero
                     for j in range(n_s)] for i in range(n_s)]
        hw_c = [c_safety * (jnp.sqrt(var[i] + noise[i]) + u_sig[i])
                for i in range(n_s)]
        q_conf = [[n_s * hw_c[i] * hw_c[i] if i == j else zero
                   for j in range(n_s)] for i in range(n_s)]
        q_sum = _sum_two_ellipsoids_q(q_lin, q_conf)
        q = _sum_two_ellipsoids_q(q_sum, q_taylor)
        p = p_next
        p_traj.append(p)
        q_traj.append(q)
        var_traj.append([var[i] for i in range(n_s)])
    return p_traj, q_traj, var_traj


def _max_eig_lanes_array(m, iters: int = 30):
    """Array-form dominant eigenvalue of lane matrices m (n, n, B) — the
    same trace-normalized squaring + Rayleigh refinement as
    :func:`_max_eig_lanes`, with closed forms at n<=2."""
    n = m.shape[0]
    if n == 1:
        return jnp.maximum(m[0, 0], 0.0)
    if n == 2:
        tr = m[0, 0] + m[1, 1]
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
        return jnp.maximum(0.5 * (tr + disc), 0.0)
    trace = jnp.einsum("iib->b", m)
    scale = trace / n + 1e-30
    mn = m / scale[None, None, :]
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):
        mn = jnp.einsum("ikb,kjb->ijb", mn, mn)
        s = jnp.einsum("iib->b", mn) / n + 1e-30
        mn = mn / s[None, None, :]
    v0 = 1.0 + 1e-3 * jnp.arange(n, dtype=m.dtype)
    v0 = v0 / jnp.linalg.norm(v0)
    v = jnp.broadcast_to(v0[:, None], (n, m.shape[-1])).astype(m.dtype)
    for _ in range(n_refine):
        w = jnp.einsum("ijb,jb->ib", mn, v)
        v = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + 1e-30)
    mv = jnp.einsum("ijb,jb->ib", m, v)
    num = jnp.sum(v * mv, axis=0)
    den = jnp.sum(v * v, axis=0) + 1e-30
    return jnp.maximum(num / den, 0.0)


def _sum_two_ellipsoids_q_array(q1, q2):
    """Array form of :func:`_sum_two_ellipsoids_q` on (n, n, B) lanes."""
    eps = 1e-30
    t1 = jnp.einsum("iib->b", q1) + eps
    t2 = jnp.einsum("iib->b", q2) + eps
    c = jnp.sqrt(t1 / t2)[None, None, :]
    return (1.0 + 1.0 / c) * q1 + (1.0 + c) * q2


def _rollout_lanes_array(ssm, u_flat, x0, k_fb, a, b, cfg, bmat):
    """ARRAY-form lane tube rollout — identical math to
    :func:`_rollout_lanes`, with the tiny-matrix algebra as batch-LAST
    (n_s, n_s, B) einsums instead of Python-scalar unrolls.

    WHY TWO FORMS. The scalar-unrolled form emits O(n_s^2) HLO instructions
    per matrix op; the whole GN solve traces ~10 rollouts per Newton step,
    and at n_s >= 4 the graph grows past what XLA compiles in reasonable
    time (measured: n_s=2 seconds, n_s=4 ~13 min, n_s=6 does not finish on
    XLA:CPU). This form keeps every array batch-last at a constant trace
    size, so 4D/6D envs (cartpole, quadrotor) get the lane backend too.
    n_s <= 2 keeps the scalar form; f64 equivalence of the two forms is
    pinned in tests/test_sqp_lanes.py.

    Returns the PACKED y directly ((ny, B), the _pack_y layout).
    """
    t_len = cfg.n_safe
    n_s = a.shape[0]
    n_u = k_fb.shape[0]
    noise = jnp.exp(2.0 * _gp_of(ssm).log_noise)
    noise = noise if noise.ndim == 2 else noise[:, None]    # (e, 1|B)
    c_safety = cfg.c_safety
    eye = jnp.eye(n_s, dtype=a.dtype)

    def diag_q(hw):                                         # (n_s, B) -> q
        return eye[:, :, None] * (n_s * hw * hw)[:, None, :]

    kff = u_flat[:n_u]
    z = jnp.concatenate([x0, kff], axis=0)                  # (d_in, B)
    mu, var = _gp_predict_lanes(ssm, z, want_jac=False)
    p = a @ x0 + b @ kff + mu
    hw0 = c_safety * jnp.sqrt(var + noise)
    q = diag_q(hw0)
    p_traj, q_traj, var_traj = [p], [q], [var]

    l_mu = ssm.l_mu if ssm.l_mu.ndim == 2 else ssm.l_mu[:, None]
    l_sigma = (
        ssm.l_sigma if ssm.l_sigma.ndim == 2 else ssm.l_sigma[:, None]
    )
    for t in range(1, t_len):
        kff = u_flat[t * n_u:(t + 1) * n_u]
        z = jnp.concatenate([p, kff], axis=0)
        mu, var, jac = _gp_predict_lanes(ssm, z, want_jac=True)
        p = a @ p + b @ kff + mu
        # H = a + J_x + (b + J_u) k_fb  (onestep_reachability step 3)
        h = (
            a[:, :, None] + jac[:, :n_s, :]
            + jnp.einsum("ikb,kj->ijb", b[:, :, None] + jac[:, n_s:, :],
                         k_fb)
        )
        q_lin = jnp.einsum("ikb,klb,jlb->ijb", h, q, h)
        qb = jnp.einsum("ikb,kj->ijb", q, bmat)
        r_sqr = _max_eig_lanes_array(qb)
        r = jnp.sqrt(jnp.maximum(r_sqr, 0.0))
        q_taylor = diag_q(0.5 * l_mu * r_sqr[None, :])
        hw_c = c_safety * (jnp.sqrt(var + noise) + l_sigma * r[None, :])
        q_conf = diag_q(hw_c)
        q = _sum_two_ellipsoids_q_array(
            _sum_two_ellipsoids_q_array(q_lin, q_conf), q_taylor
        )
        p_traj.append(p)
        q_traj.append(q)
        var_traj.append(var)
    return jnp.concatenate(
        [jnp.concatenate(p_traj, axis=0)]
        + [qq.reshape(n_s * n_s, -1) for qq in q_traj]
        + [jnp.concatenate(var_traj, axis=0)]
    )


def _rollout_y_lanes(ssm, u_flat, x0_rows, k_fb, a, b, cfg, bmat, r, n_u,
                     want_sigma=False):
    """Packed tube(+perf) rollout, choosing the rollout form by state
    dimension (see _rollout_lanes_array docstring for the trace-size
    rationale)."""
    t_len = cfg.n_safe
    n_s = a.shape[0]
    perf = (
        _rollout_perf_lanes(ssm, u_flat, x0_rows, a, b, cfg, r, n_u, t_len,
                            want_sigma=want_sigma)
        if cfg.n_perf > 0 else None
    )
    if n_s <= 2:
        return _pack_y(
            *_rollout_lanes(ssm, u_flat, x0_rows, k_fb, a, b, cfg, bmat),
            perf=perf,
        )
    y = _rollout_lanes_array(
        ssm, u_flat, jnp.stack(x0_rows), k_fb, a, b, cfg, bmat
    )
    if perf is None:
        return y
    return jnp.concatenate([y, _pack_y([], [], [], perf=perf)])


def _rollout_perf_lanes(ssm, u_flat, x0, a, b, cfg, r, n_u, t_len,
                        want_sigma=False):
    """Performance-trajectory stages, lane-major.

    Mirrors reachability/propagation.multi_step_propagation (reference
    ``uncertainty_propagation_casadi.py``, SURVEY.md §2.4). The Σ-free stock
    objectives (tracking/exploration, _cost_lanes) read only the stage means
    and GP variances — for them the input-covariance recursion is skipped
    (``want_sigma=False``): ``taylor`` and ``mean_equivalent`` are provably
    identical there, and that identity is what the parity test pins. A
    Σ-consuming cost (risk_tracking) sets ``want_sigma=True``, which runs the
    lane form of the portable recursion exactly:

      * ``taylor``:          Σ⁺ = H Σ Hᵀ + diag(var + noise), H = a + J_mu,x
      * ``mean_equivalent``: Σ⁺ = Σ + diag(var + noise)

    (the portable perf path propagates open loop — no k_fb term in H,
    solvers/sqp.py objective / multi_step_propagation call).

    Stage controls: the first ``r`` are SHARED with the safety tube
    (k_ff[:r]); the rest come from the free perf block at the tail of
    ``u_flat`` — the reference's joint safety+performance NLP layout
    (``safempc_simple.py``, SURVEY.md §2.5).
    """
    n_s = len(x0)
    a_rows = _const_rows(a)
    b_rows = _const_rows(b)
    method = getattr(cfg, "perf_method", "taylor")
    taylor = method == "taylor"
    noise = jnp.exp(2.0 * _gp_of(ssm).log_noise)            # (e,)

    def u_at(t):
        base = t * n_u if t < r else t_len * n_u + (t - r) * n_u
        return [u_flat[base + i] for i in range(n_u)]

    p = list(x0)
    zero = jnp.zeros_like(x0[0])
    sig = [[zero for _ in range(n_s)] for _ in range(n_s)]
    p_perf, var_perf, sig_perf = [], [], []
    for t in range(cfg.n_perf):
        ut = u_at(t)
        z = jnp.stack(p + ut)
        if want_sigma and taylor:
            mu, var, jac = _gp_predict_lanes(ssm, z, want_jac=True)
        else:
            mu, var = _gp_predict_lanes(ssm, z, want_jac=False)
        p = [
            sum(a_rows[i][j] * p[j] for j in range(n_s))
            + sum(b_rows[i][k] * ut[k] for k in range(n_u))
            + mu[i]
            for i in range(n_s)
        ]
        p_perf.append(p)
        var_perf.append([var[i] for i in range(n_s)])
        if want_sigma:
            if taylor:
                h = [[a_rows[i][j] + jac[i, j] for j in range(n_s)]
                     for i in range(n_s)]
                sig = _mat_mul(_mat_mul(h, sig),
                               [[h[j][i] for j in range(n_s)]
                                for i in range(n_s)])
            else:
                sig = [[sig[i][j] for j in range(n_s)] for i in range(n_s)]
            for i in range(n_s):
                sig[i][i] = sig[i][i] + var[i] + noise[i]
            sig_perf.append(sig)
    if want_sigma:
        return p_perf, var_perf, sig_perf
    return p_perf, var_perf


def _pack_y(p_traj, q_traj, var_traj, perf=None):
    parts = []
    for p in p_traj:
        parts += p
    for q in q_traj:
        for row in q:
            parts += row
    for v in var_traj:
        parts += v
    if perf is not None:
        p_perf, var_perf, *sig = perf
        for p in p_perf:
            parts += p
        for v in var_perf:
            parts += v
        if sig:
            for s in sig[0]:
                for row in s:
                    parts += row
    return jnp.stack(parts)                                # (ny, B)


def _unpack_y(y, t_len, n_s, n_perf=0, with_sigma=False):
    idx = 0
    p_traj, q_traj, var_traj = [], [], []
    for _ in range(t_len):
        p_traj.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    for _ in range(t_len):
        q_traj.append([[y[idx + i * n_s + j] for j in range(n_s)]
                       for i in range(n_s)])
        idx += n_s * n_s
    for _ in range(t_len):
        var_traj.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    if n_perf == 0:
        return p_traj, q_traj, var_traj
    p_perf, var_perf = [], []
    for _ in range(n_perf):
        p_perf.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    for _ in range(n_perf):
        var_perf.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    if not with_sigma:
        return p_traj, q_traj, var_traj, (p_perf, var_perf)
    sig_perf = []
    for _ in range(n_perf):
        sig_perf.append([[y[idx + i * n_s + j] for j in range(n_s)]
                         for i in range(n_s)])
        idx += n_s * n_s
    return p_traj, q_traj, var_traj, (p_perf, var_perf, sig_perf)


def _dist_lanes(y, t_len, n_s, h_mat_obs, h_obs, h_mat_safe, h_safe):
    """Safety margins (reachability/safety.lin_ellipsoid_safety_distance) for
    every stage + terminal, stacked (n_con, B). Array form at n_s > 2 (same
    trace-size rationale as _rollout_lanes_array)."""
    if n_s > 2:
        p = y[: t_len * n_s].reshape(t_len, n_s, -1)
        q = y[t_len * n_s: t_len * n_s * (1 + n_s)].reshape(
            t_len, n_s, n_s, -1
        )

        def margins(p_t, q_t, h, hv):
            sup = jnp.sqrt(jnp.maximum(
                jnp.einsum("ij,tjkb,ik->tib", h, q_t, h), 0.0
            ))
            lin = jnp.einsum("ij,tjb->tib", h, p_t)
            return (lin + sup - hv[None, :, None]).reshape(
                -1, p_t.shape[-1]
            )

        return jnp.concatenate([
            margins(p, q, h_mat_obs, h_obs),
            margins(p[-1:], q[-1:], h_mat_safe, h_safe),
        ])
    p_traj, q_traj, _ = _unpack_y(y, t_len, n_s)

    def margins(p, q, h_mat, h_vec):
        out = []
        for i in range(h_mat.shape[0]):
            sup = sum(
                h_mat[i, j] * q[j][k] * h_mat[i, k]
                for j in range(n_s) for k in range(n_s)
            )
            sup = jnp.sqrt(jnp.maximum(sup, 0.0))
            out.append(
                sum(h_mat[i, j] * p[j] for j in range(n_s)) + sup - h_vec[i]
            )
        return out

    rows = []
    for t in range(t_len):
        rows += margins(p_traj[t], q_traj[t], h_mat_obs, h_obs)
    rows += margins(p_traj[-1], q_traj[-1], h_mat_safe, h_safe)
    return jnp.stack(rows)                                 # (n_con, B)


# The lane backends' objective whitelist. tracking/exploration are Σ-FREE
# (they read only stage means and GP variances, so the perf rollout skips
# the input-covariance recursion and ``taylor`` ≡ ``mean_equivalent`` —
# pinned by the parity tests). risk_tracking is Σ-CONSUMING: for it the lane
# perf rollout runs the full covariance recursion (_rollout_perf_lanes
# want_sigma=True — the lane form of reachability/propagation) and the two
# methods genuinely differ, matching the portable path. A new Σ-consuming
# cost must be added to _wants_sigma as well — lanes_supported/
# cem_lanes_supported key off this tuple, so an unlisted cost falls back to
# the vmapped portable path honestly.
_LANE_COSTS = ("tracking", "exploration", "risk_tracking")


def _wants_sigma(cost_kind: str, n_perf: int) -> bool:
    """Whether the lane rollout must carry the perf-trajectory covariance
    recursion for this objective (with n_perf == 0 the risk cost reads the
    safety tube's q_traj, which the tube rollout always carries)."""
    return cost_kind == "risk_tracking" and n_perf > 0


def _cost_lanes(cost_kind: str, cost_args: dict, y, u_flat, t_len, n_s, n_u,
                n_perf=0, r=0):
    """Lane forms of the stock objectives (solvers/costs.py) -> (B,).

    With ``n_perf > 0`` the objective rides the performance trajectory
    (stage means/variances from the perf blocks of ``y``; the control
    penalty over u_perf_all = shared k_ff[:r] + free perf controls) — the
    portable cost_small contract (solvers/sqp._build_constraint_fn)."""
    sig_cost = None
    if n_perf > 0:
        if _wants_sigma(cost_kind, n_perf):
            *_, (p_cost, var_cost, sig_cost) = _unpack_y(
                y, t_len, n_s, n_perf, with_sigma=True
            )
        else:
            *_, (p_cost, var_cost) = _unpack_y(y, t_len, n_s, n_perf)
        ctrl_idx = [t * n_u + k for t in range(r) for k in range(n_u)] + [
            t_len * n_u + m for m in range((n_perf - r) * n_u)
        ]
        t_cost = n_perf
    else:
        p_cost, q_traj, var_cost = _unpack_y(y, t_len, n_s)
        sig_cost = q_traj          # the portable n_perf==0 contract: the
        ctrl_idx = [t * n_u + k for t in range(t_len) for k in range(n_u)]
        t_cost = t_len             # risk cost prices the safety tube shapes
    if cost_kind in ("tracking", "risk_tracking"):
        target = cost_args["target"]
        w_x = cost_args.get("w_x", 1.0)
        w_u = cost_args.get("w_u", 0.1)
        w_t = cost_args.get("w_terminal", 5.0)
        stage = sum(
            (p_cost[t][i] - target[i]) ** 2
            for t in range(t_cost - 1) for i in range(n_s)
        )
        ctrl = sum(u_flat[m] ** 2 for m in ctrl_idx)
        term = sum((p_cost[-1][i] - target[i]) ** 2 for i in range(n_s))
        cost = w_x * stage + w_u * ctrl + w_t * term
        if cost_kind == "risk_tracking":
            w_s = cost_args.get("w_sigma", 1.0)
            cost = cost + w_s * sum(
                sig_cost[t][i][i] for t in range(t_cost) for i in range(n_s)
            )
        return cost
    if cost_kind == "exploration":
        scale = cost_args.get("scale", 1.0)
        return -scale * sum(
            jnp.sqrt(var_cost[t][i]) for t in range(t_cost)
            for i in range(n_s)
        )
    raise ValueError(f"lane backend has no cost '{cost_kind}'")


# ------------------------------------------------------------------- GN-AL


def _basis_tangents(n_var: int, b: int, dtype):
    return jnp.eye(n_var, dtype=dtype)[:, :, None] * jnp.ones(
        (1, 1, b), dtype
    )                                                       # (n_var, n_var, B)


def _select_candidates(vals, cands, f0, u):
    """Per-lane argmin over the candidate axis, accept only improvements.

    vals (n_c, B), cands (n_c, n_var, B) -> (n_var, B). One-hot contraction
    instead of gather keeps everything lane-tiled."""
    best = jnp.argmin(vals, axis=0)                         # (B,)
    onehot = (
        jnp.arange(vals.shape[0])[:, None] == best[None, :]
    ).astype(u.dtype)                                       # (n_c, B)
    u_best = jnp.sum(onehot[:, None, :] * cands, axis=0)    # (n_var, B)
    v_best = jnp.sum(onehot * vals, axis=0)                 # (B,)
    return jnp.where(v_best < f0, u_best, u)


def solve_safempc_lanes(
    ssm: GPSSM,
    x0s: jax.Array,
    u_init: jax.Array,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    u_min: jax.Array,
    u_max: jax.Array,
    h_mat_obs: jax.Array,
    h_obs: jax.Array,
    h_mat_safe: jax.Array,
    h_safe: jax.Array,
    cost_kind: str,
    cost_args: dict,
    cfg: SqpConfig,
    lam_init: jax.Array | None = None,
):
    """Batched safety-NLP solve, lane-major.

    Args mirror solvers/sqp.solve_safempc_nlp but batched: x0s (B, n_s),
    u_init (B, n_safe, n_u), lam_init (B, n_con) optional.

    Returns (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info) with
    info = {cost (B,), max_constraint (B,), warm_next (B, n_safe, n_u),
    lam (B, n_con)} — same contract as the portable solver, so runners and
    bench can swap backends. Parity pinned in tests/test_sqp_lanes.py.
    """
    if cfg.opt_k_fb or cfg.hessian != "gn":
        raise NotImplementedError(
            "lane backend covers the production fixed-k_fb / GN "
            "configuration; use solvers/sqp.py otherwise"
        )
    t_len = cfg.n_safe
    n_u = k_fb.shape[0]
    n_s = x0s.shape[1]
    bsz = x0s.shape[0]
    dtype = x0s.dtype
    # joint safety+performance decision vector, portable layout
    # (solvers/sqp._build_constraint_fn): [k_ff (t_len) | u_perf_free]
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    t_total = t_len + (cfg.n_perf - r if cfg.n_perf > 0 else 0)
    n_var = t_total * n_u
    n_con = t_len * h_obs.shape[0] + h_safe.shape[0]

    x0 = x0s.T                                              # (n_s, B)
    u0 = jnp.moveaxis(u_init.reshape(bsz, n_var), 0, -1)    # (n_var, B)
    lo = jnp.tile(u_min, t_total)[:, None]
    hi = jnp.tile(u_max, t_total)[:, None]
    lam0 = (
        jnp.zeros((n_con, bsz), dtype) if lam_init is None else lam_init.T
    )
    s_lift = jnp.concatenate([jnp.eye(n_s, dtype=dtype), k_fb], axis=0)
    bmat = s_lift.T @ s_lift

    x0_rows = [x0[i] for i in range(n_s)]
    want_sigma = _wants_sigma(cost_kind, cfg.n_perf)

    def rollout_y(u_flat):
        return _rollout_y_lanes(ssm, u_flat, x0_rows, k_fb, a, b, cfg,
                                bmat, r, n_u, want_sigma=want_sigma)

    def dist(y):
        return _dist_lanes(y, t_len, n_s, h_mat_obs, h_obs,
                           h_mat_safe, h_safe)

    def cost(y, u_flat):
        return _cost_lanes(cost_kind, cost_args, y, u_flat, t_len, n_s, n_u,
                           n_perf=cfg.n_perf, r=r)

    def al_of(y, u, lam, mu):
        g = dist(y)
        s = jnp.maximum(lam + mu * g, 0.0)
        return cost(y, u) + jnp.sum(s * s - lam * lam, axis=0) / (2.0 * mu)

    tangents = _basis_tangents(n_var, bsz, dtype)
    alphas = 0.5 ** jnp.arange(cfg.n_linesearch, dtype=dtype)
    polish_alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125], dtype)

    # Line-search/polish FOLDING: the n_c trial step-sizes are evaluated in
    # ONE rollout over n_c*B lanes instead of n_c sequential B-lane rollouts
    # — the candidate axis is just more lanes (per-lane math is identical;
    # lane index c*B + b sees x0[b]). Sequential trials leave the device
    # underfed at small B and serialize n_c dispatch chains; folding is the
    # same layout argument as the backend itself. Per-lane LaneGPSSM
    # models are excluded: their support buffers are per-lane, so widening
    # the lane axis would require tiling every GP buffer n_c-fold per step.
    fold_cands = not isinstance(ssm, LaneGPSSM)

    def fold_eval(cands, eval_wide):
        """cands (n_c, n_var, B) -> per-candidate values (n_c, B) via one
        wide evaluation; eval_wide maps (u_wide, y_wide, n_c) -> (n_c*B,)."""
        n_c = cands.shape[0]
        u_wide = jnp.moveaxis(cands, 0, 1).reshape(n_var, n_c * bsz)
        x0w = [jnp.tile(xr, n_c) for xr in x0_rows]
        y_wide = _rollout_y_lanes(ssm, u_wide, x0w, k_fb, a, b, cfg,
                                  bmat, r, n_u, want_sigma=want_sigma)
        return eval_wide(u_wide, y_wide, n_c).reshape(n_c, bsz)

    def gn_step(u, lam, mu):
        # ONE primal rollout + n_var jvps of its linearization (jy), then all
        # further derivatives through the TINY y-space maps on y + Jy (v - u):
        # grad at v=u equals the exact AL gradient; the Hessian is exactly the
        # classical GN curvature (d2y/du2 dropped) — same math as
        # solvers/sqp.solve_al_nlp_gn, laid out lane-last.
        y, f_jvp = jax.linearize(rollout_y, u)
        jy = jax.vmap(f_jvp)(tangents)                      # (n_var, ny, B)

        def al_lin(v):
            y_lin = y + jnp.einsum("ib,iyb->yb", v - u, jy)
            return al_of(y_lin, v, lam, mu)

        f0 = al_lin(u)                                      # true AL at u
        grad_fn = jax.grad(lambda v: jnp.sum(al_lin(v)))
        grad, g_jvp = jax.linearize(grad_fn, u)             # (n_var, B)
        h = jax.vmap(g_jvp)(tangents)                       # (n_var, n_var, B)

        diag = jnp.stack([jnp.abs(h[i, i]) for i in range(n_var)])
        diag_scale = jnp.maximum(jnp.max(diag, axis=0), 1.0)
        hs = 0.5 * (h + jnp.swapaxes(h, 0, 1))
        eye = jnp.eye(n_var, dtype=dtype)[:, :, None]
        d0 = _solve_spd_unrolled(hs + cfg.newton_damping * diag_scale * eye,
                                 -grad)
        d1 = _solve_spd_unrolled(hs + diag_scale * eye, -grad)
        ok = jnp.all(jnp.isfinite(d0), axis=0)
        d = jnp.where(ok[None, :], d0, d1)

        cands = jnp.stack(
            [jnp.clip(u + al_ * d, lo, hi) for al_ in alphas]
        )                                                   # (n_c, n_var, B)
        if fold_cands:
            vals = fold_eval(
                cands,
                lambda uw, yw, n_c: al_of(yw, uw, jnp.tile(lam, (1, n_c)),
                                          mu),
            )
        else:
            vals = jnp.stack(
                [al_of(rollout_y(c), c, lam, mu) for c in cands]
            )
        vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
        return _select_candidates(vals, cands, f0, u)

    def outer_step(carry, _):
        u, lam, mu = carry

        def inner(u_, _):
            return gn_step(u_, lam, mu), None

        u, _ = jax.lax.scan(inner, u, None, length=cfg.n_inner)
        g = dist(rollout_y(u))
        lam = jnp.maximum(lam + mu * g, 0.0)
        mu = mu * cfg.mu_growth
        return (u, lam, mu), None

    u_cur = jnp.clip(u0, lo, hi)
    (u_fin, lam_fin, _), _ = jax.lax.scan(
        outer_step, (u_cur, lam0, jnp.asarray(cfg.mu0, dtype)), None,
        length=cfg.n_outer,
    )

    def do_polish(u_in, n_steps=0):
        def polish_step(u, _):
            y, f_jvp = jax.linearize(rollout_y, u)
            jy = jax.vmap(f_jvp)(tangents)
            g = dist(y)
            v = jnp.maximum(g, 0.0)

            def g_lin(vv):
                return dist(y + jnp.einsum("ib,iyb->yb", vv - u, jy))

            viol_fn = jax.grad(
                lambda vv: jnp.sum(jnp.maximum(g_lin(vv), 0.0) * v)
            )
            # J^T v with the active mask folded in: grad of sum(max(g,0)*v)
            # at vv=u gives jac^T (act * v) = jtv of the portable path
            jtv = viol_fn(u)
            gj_fn = jax.linearize(
                lambda vv: jnp.maximum(g_lin(vv), 0.0) * (g > 0.0), u
            )[1]
            gj = jax.vmap(gj_fn)(tangents)                  # (n_var,n_con,B)
            jtj = jnp.einsum("icb,jcb->ijb", gj, gj)
            eye = jnp.eye(n_var, dtype=dtype)[:, :, None]
            d = _solve_spd_unrolled(jtj + 1e-6 * eye, -jtv)
            cands = jnp.stack(
                [jnp.clip(u + al_ * d, lo, hi) for al_ in polish_alphas]
            )
            if fold_cands:
                viols = fold_eval(
                    cands,
                    lambda uw, yw, n_c: jnp.sum(
                        jnp.maximum(dist(yw), 0.0), axis=0
                    ),
                )
            else:
                viols = jnp.stack([
                    jnp.sum(jnp.maximum(dist(rollout_y(c)), 0.0), axis=0)
                    for c in cands
                ])
            return _select_candidates(viols, cands,
                                      jnp.sum(v, axis=0), u), None

        u_out, _ = jax.lax.scan(polish_step, u_in, None,
                                length=n_steps or cfg.n_polish)
        return u_out

    if cfg.n_polish > 0:
        u_fin = do_polish(u_fin)

    if cfg.n_rescue_outer > 0:
        mu_r = jnp.asarray(cfg.mu0 * cfg.mu_growth ** cfg.n_outer, dtype)
        (u_fin, _, _), _ = jax.lax.scan(
            outer_step, (u_fin, jnp.zeros_like(lam0), mu_r), None,
            length=cfg.n_rescue_outer,
        )
        if cfg.n_polish > 0:
            u_fin = do_polish(u_fin)

    if cfg.n_polish_extra > 0:
        # violation-gated extra restoration (SqpConfig.n_polish_extra): the
        # gate is batch-GLOBAL (any lane still infeasible) — lax.cond skips
        # the whole block at runtime when every lane converged; polish steps
        # only improve per-lane violation (candidate acceptance is
        # monotone), so converged lanes are inert passengers when the block
        # does run. The gate's rollout doubles as the final y on the
        # converged path, so the gate costs no extra tube evaluation there.
        y_gate = rollout_y(u_fin)
        still_bad = jnp.any(
            jnp.sum(jnp.maximum(dist(y_gate), 0.0), axis=0) > cfg.feas_tol
        )

        def _restore(u, y):
            u2 = do_polish(u, cfg.n_polish_extra)
            return u2, rollout_y(u2)

        u_fin, y_fin = jax.lax.cond(
            still_bad, _restore, lambda u, y: (u, y), u_fin, y_gate
        )
    else:
        y_fin = rollout_y(u_fin)
    g_fin = dist(y_fin)
    violation = jnp.sum(jnp.maximum(g_fin, 0.0), axis=0)    # (B,)
    feasible = violation <= cfg.feas_tol
    # predicted tube centers come free with the final rollout — the SafeMPC
    # state machine stores them as fallback reference centers (solvers/
    # safempc.py on_success) without re-rolling the tube
    p_traj = jnp.moveaxis(y_fin[: t_len * n_s], -1, 0).reshape(
        bsz, t_len, n_s
    )
    u_mat = jnp.moveaxis(u_fin, -1, 0).reshape(bsz, t_total, n_u)
    info = {
        "cost": cost(y_fin, u_fin),
        "max_constraint": jnp.max(g_fin, axis=0),
        "warm_next": u_mat,
        "lam": lam_fin.T,
        "p_traj": p_traj,
    }
    # safety block only — the full decision matrix rides warm_next (the
    # portable solve_safempc_nlp return contract)
    return u_mat[:, :t_len], feasible, violation, info


def lanes_supported(ssm, cfg: SqpConfig, cost_kind: str) -> bool:
    """Whether the lane backend covers this configuration. ``ssm`` may be a
    shared GPSSM (one model, B initial states), a LaneGPSSM (B per-lane
    models — the batched online-learning episodes of runtime/batch) or a
    SparseGPSSM (inducing-point tier — its solve-free alpha/vmat posterior
    is natively f32 and rides the same lane contractions)."""
    if not isinstance(ssm, (GPSSM, LaneGPSSM, SparseGPSSM)):
        return False
    gp = _gp_of(ssm)
    return (
        all(kt in _KERNEL_PARTS for kt in gp.kern_types)
        and getattr(gp, "precision", "f32") == "f32"
        and not cfg.opt_k_fb
        and cfg.hessian == "gn"
        and cfg.linesearch == "exact"
        # both perf methods are fully implemented on lanes: Σ-free costs
        # skip the covariance recursion (the methods are provably identical
        # there — pinned); risk_tracking runs the lane Σ recursion
        # (_rollout_perf_lanes want_sigma=True), where the methods genuinely
        # differ, matching the portable path
        and cfg.perf_method in ("taylor", "mean_equivalent")
        and cost_kind in _LANE_COSTS
    )


def make_sqp_lane_solver(
    env,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    cost_kind: str,
    cost_args: dict,
    cfg: SqpConfig,
) -> Callable:
    """Batched-planner factory mirroring solvers/sqp.make_sqp_planner, but
    solving ALL lanes in one lane-major program:

        batch_planner(ssm, x0s (B, n_s), warm (B, n_safe, n_u)[, lam])
            -> (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info)
    """
    spec = env.spec

    def batch_planner(ssm, x0s, warm, lam=None):
        return solve_safempc_lanes(
            ssm, x0s, warm, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            cost_kind, cost_args, cfg, lam_init=lam,
        )

    return batch_planner
