"""Multi-output Gaussian-process regression — the dynamics-residual model.

Replaces BOTH of the reference's GP stacks with one JAX implementation
(SURVEY.md §2.3):
  * ``ssm_gpy/gaussian_process.py::SimpleGPModel`` — GPy regression, one
    independent scalar GP per output dimension, hyperopt, update_model;
  * ``gp_models_utils_casadi.py::gp_pred*`` — the symbolic posterior that the
    reference bakes into its IPOPT NLP. Here the SAME function is traced into the
    SQP graph (jit), differentiated (jacfwd) and batched (vmap).

Design decisions (SURVEY.md §7):
  * **Static shapes**: the training set lives in a fixed (n_max, d) buffer with a
    validity mask. The reference reallocates numpy arrays every episode; here the
    dataset "grows" by writing into the padded buffer — no retrace, no recompile.
  * **Masked-identity Gram trick**: K_ij = m_i m_j k(x_i,x_j) + delta_ij * (m_i
    (sigma_n^2 + jitter) + (1 - m_i)). Masked rows/cols reduce to the identity, so
    chol(K) is well-defined for ANY mask, beta = K^{-1}(m*y) is exactly zero on
    padding, and posterior mean/var are bit-identical to the unpadded computation.
  * The Gram build and the (E-batched) Cholesky are plain jax.numpy, left to
    XLA's lowerings (cuBLAS/cuSOLVER and its own fusions on the GPU); the
    large-N tier is the sharded inducing-point path (models/sparse_gp.py,
    parallel/).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import optax

from safe_exploration_tpu.models.kernels import (
    gram,
    init_kernel_params,
    kernel_diag,
)
from safe_exploration_tpu.utils import struct

__all__ = ["GP", "gp_init", "gp_refit", "gp_update_data", "gp_append_point",
           "gp_nll", "gp_fit", "gp_predict", "gp_predict_batch",
           "gp_predict_full_cov", "gp_predict_jac"]

_JITTER = 1e-6


@struct.dataclass
class GP:
    """Padded multi-output GP state (a pytree — vmap/shard/checkpoint friendly).

    One independent scalar GP per output dimension (parity with the reference's
    per-dim GPy models), each with its own kernel type and hyperparameters.
    """

    kern_types: tuple = struct.field(pytree_node=False)  # (E,) strings, static
    x: jax.Array        # (n_max, d_in) padded training inputs
    y: jax.Array        # (n_max, e) padded training targets
    mask: jax.Array     # (n_max,) 1.0 where valid
    params: tuple       # per-dim kernel param dicts, length e
    log_noise: jax.Array  # (e,) log observation-noise std
    chol: jax.Array     # (e, n_max, n_max) lower Cholesky of masked K per dim
    beta: jax.Array     # (e, n_max) K^{-1} (mask * y_d) per dim
    kinv: jax.Array     # (e, n_max, n_max) K^{-1} per dim (see _kinv_from_chol)
    head: jax.Array     # () int32 ring-buffer write pointer
    # "f32" (default) or "ff": refits compute the posterior factors in
    # double-word float-float arithmetic (ops/ff.py) — fp64-equivalent
    # factorization in f32 arithmetic, rounded to f32 only at storage. The
    # correctness-critical mode of the BASELINE north star.
    precision: str = struct.field(pytree_node=False, default="f32")

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    @property
    def n_points(self) -> jax.Array:
        return jnp.sum(self.mask).astype(jnp.int32)


def _masked_gram(
    kern_type: str, params: dict, x: jax.Array, mask: jax.Array, noise_var: jax.Array
) -> jax.Array:
    """Gram matrix with identity padding on masked entries (see module docstring)."""
    k = gram(kern_type, params, x, x)
    k = k * (mask[:, None] * mask[None, :])
    diag = mask * (noise_var + _JITTER) + (1.0 - mask)
    return k + jnp.diag(diag)


def _refit_gram(gp: GP, d: int, noise_var: jax.Array) -> jax.Array:
    """Masked Gram for the (non-differentiated) refit path."""
    return _masked_gram(gp.kern_types[d], gp.params[d], gp.x, gp.mask, noise_var)


def _kinv_from_chol(l: jax.Array) -> jax.Array:
    """Explicit K^{-1} from the lower Cholesky factor (refit-time, O(n^3)).

    Predict-time variance then becomes the quadratic form
    ``kzz - kv @ (kinv @ kv)`` — two matvecs — instead of a SEQUENTIAL
    triangular solve per posterior evaluation. The SQP evaluates the posterior
    (and its jacfwd/Hessian transforms) hundreds of times per solve, so the
    solve-free predict collapses the dispatch-bound kernel chain that capped
    round 1's batched-solver throughput (~1000x under roofline). Identity
    padding is preserved: chol is identity on masked slots, hence so is kinv.

    The inversion uses XLA's triangular solve. Replaces LAPACK ``trsm``
    under GPy (SURVEY.md §2.10).
    """
    n = l.shape[-1]
    eye = jnp.eye(n, dtype=l.dtype)
    linv = jax.scipy.linalg.solve_triangular(l, eye, lower=True)
    return linv.T @ linv


def _uniform_kern(gp: GP) -> str | None:
    """The single kernel type if all output dims share one, else None.

    All-same is the common case (configs default to per-dim RBF); it unlocks
    the vmapped-over-dims fast paths below, which emit ONE batched Gram /
    Cholesky / solve instead of e copies — smaller solver graphs and XLA's
    batched kernels (the analog of the reference's ssm_pytorch BATCHED
    multi-output GP, SURVEY.md §2.3).
    """
    return gp.kern_types[0] if len(set(gp.kern_types)) == 1 else None


def _stack_params(params: tuple) -> dict:
    """Stack the per-dim param dicts into one dict of (e, ...) arrays."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params)


def gp_refit(gp: GP) -> GP:
    """Recompute posterior factors (chol, beta) for the current data + params.

    Parity: the Cholesky the reference does in GPy/LAPACK on every
    ``update_model`` (SURVEY.md §3.1 hot loop 'GP refit'). Gram build and
    factorization are left to XLA's lowerings; this path is never
    differentiated (hyperopt's gp_nll keeps its own cholesky).
    """
    if gp.precision == "ff":
        from safe_exploration_tpu.ops.ff import gp_factors_ff

        chols, betas, kinvs = [], [], []
        for d in range(gp.n_out):
            noise_var = jnp.exp(2.0 * gp.log_noise[d])
            k = _masked_gram(
                gp.kern_types[d], gp.params[d], gp.x, gp.mask, noise_var
            )
            l, b, ki = gp_factors_ff(
                k.astype(jnp.float32), (gp.mask * gp.y[:, d]).astype(jnp.float32)
            )
            chols.append(l.astype(gp.x.dtype))
            betas.append(b.astype(gp.x.dtype))
            kinvs.append(ki.astype(gp.x.dtype))
        return gp.replace(
            chol=jnp.stack(chols), beta=jnp.stack(betas), kinv=jnp.stack(kinvs)
        )

    kt = _uniform_kern(gp)
    if kt is not None:
        def per_dim(p, log_noise_d, yd):
            noise_var = jnp.exp(2.0 * log_noise_d)
            k = _masked_gram(kt, p, gp.x, gp.mask, noise_var)
            l = jnp.linalg.cholesky(k)
            ym = gp.mask * yd
            z = jax.scipy.linalg.solve_triangular(l, ym, lower=True)
            b = jax.scipy.linalg.solve_triangular(l.T, z, lower=False)
            return l, b, _kinv_from_chol(l)

        chol, beta, kinv = jax.vmap(per_dim)(
            _stack_params(gp.params), gp.log_noise, gp.y.T
        )
        return gp.replace(chol=chol, beta=beta, kinv=kinv)

    chols = []
    betas = []
    kinvs = []
    for d in range(gp.n_out):
        noise_var = jnp.exp(2.0 * gp.log_noise[d])
        k = _refit_gram(gp, d, noise_var)
        l = jnp.linalg.cholesky(k)
        yd = gp.mask * gp.y[:, d]
        z = jax.scipy.linalg.solve_triangular(l, yd, lower=True)
        b = jax.scipy.linalg.solve_triangular(l.T, z, lower=False)
        chols.append(l)
        betas.append(b)
        kinvs.append(_kinv_from_chol(l))
    return gp.replace(
        chol=jnp.stack(chols), beta=jnp.stack(betas), kinv=jnp.stack(kinvs)
    )


def gp_init(
    kern_types: tuple,
    x: jax.Array,
    y: jax.Array,
    *,
    n_max: int,
    log_noise: float | jax.Array = -2.3,
    params: tuple | None = None,
    precision: str = "f32",
) -> GP:
    """Build a GP from (possibly empty) initial data, padded to ``n_max`` rows.

    Parity: reference ``SimpleGPModel.__init__`` / ``train`` (SURVEY.md §2.3).
    ``precision="ff"`` selects double-word float-float refits (see GP field).
    """
    n, d_in = x.shape
    e = y.shape[1]
    if len(kern_types) != e:
        raise ValueError("need one kernel type per output dim")
    if n > n_max:
        raise ValueError(f"initial data ({n}) exceeds n_max ({n_max})")
    dtype = x.dtype
    xp = jnp.zeros((n_max, d_in), dtype).at[:n].set(x)
    yp = jnp.zeros((n_max, e), dtype).at[:n].set(y)
    mask = jnp.zeros((n_max,), dtype).at[:n].set(1.0)
    if params is None:
        params = tuple(init_kernel_params(kt, d_in, dtype) for kt in kern_types)
    ln = jnp.broadcast_to(jnp.asarray(log_noise, dtype), (e,))
    gp = GP(
        kern_types=tuple(kern_types),
        x=xp,
        y=yp,
        mask=mask,
        params=params,
        log_noise=ln,
        chol=jnp.zeros((e, n_max, n_max), dtype),
        beta=jnp.zeros((e, n_max), dtype),
        kinv=jnp.zeros((e, n_max, n_max), dtype),
        head=jnp.asarray(n, jnp.int32),
        precision=precision,
    )
    return gp_refit(gp)


def gp_update_data(
    gp: GP, x_new: jax.Array, y_new: jax.Array, *, replace_old: bool = True
) -> GP:
    """Append a batch of transitions; ring-buffer overwrite when full.

    Parity: reference ``SimpleGPModel.update_model(x_new, y_new, replace_old)``
    (SURVEY.md §2.3). jit-able: positions are computed with modular arithmetic on
    the current count, so shapes stay static. When the buffer is full and
    ``replace_old`` is False the new points are dropped (reference raises; inside
    jit we saturate instead — size the buffer for the experiment).
    """
    k = x_new.shape[0]
    idx = gp.head + jnp.arange(k, dtype=jnp.int32)
    if replace_old:
        idx = idx % gp.n_max
        keep = jnp.ones((k,), bool)
        head = (gp.head + k) % gp.n_max
    else:
        keep = idx < gp.n_max
        idx = jnp.minimum(idx, gp.n_max - 1)
        head = jnp.minimum(gp.head + k, gp.n_max)
    x = gp.x.at[idx].set(jnp.where(keep[:, None], x_new, gp.x[idx]))
    y = gp.y.at[idx].set(jnp.where(keep[:, None], y_new, gp.y[idx]))
    mask = gp.mask.at[idx].set(jnp.where(keep, 1.0, gp.mask[idx]))
    return gp_refit(gp.replace(x=x, y=y, mask=mask, head=head))


def gp_append_point(gp: GP, x_new: jax.Array, y_new: jax.Array) -> GP:
    """O(n^2) incremental append of ONE point via bordered Cholesky extension.

    With identity padding, K is block-diagonal across the masked boundary, so
    activating slot ``n`` only adds one row to each factor:
        l_row = L^{-1} k(x_new, X_act)   (triangular solve, O(n^2))
        l_nn  = sqrt(k(x_new,x_new) + sigma_n^2 + jitter - ||l_row||^2)
    beta is then refreshed with two triangular solves. This is the incremental
    refit used by the 256-episode batched-exploration config (BASELINE config 3)
    instead of the reference's full O(n^3) GPy re-factorization.

    FULL-BUFFER BEHAVIOR (VERDICT r2 weak #3): the bordered-extension update is
    only valid when the activated slot was an inactive identity row. When the
    buffer is already full (``head == n_max``) the append is a gated NO-OP —
    the point is dropped and every factor stays exactly as it was, instead of
    silently overwriting an ACTIVE row with math that assumes it was identity
    (which produced a wrong Cholesky/K^-1 with no error). The batch runner
    (runtime/batch.py) additionally rejects overflowing schedules host-side
    before tracing — parity with ``SimpleGPModel.update_model``'s explicit
    error (SURVEY.md §2.3). Saturation (not ``lax.cond`` into a full refit)
    keeps the function cheap under vmap, where both cond branches execute.
    """
    # Slot to activate; has_room gates every write below so a full buffer is a
    # no-op rather than a corrupting overwrite.
    has_room = gp.head < gp.n_max
    slot = jnp.minimum(gp.head, gp.n_max - 1)
    x = gp.x.at[slot].set(jnp.where(has_room, x_new, gp.x[slot]))
    y = gp.y.at[slot].set(jnp.where(has_room, y_new, gp.y[slot]))
    mask = gp.mask.at[slot].set(jnp.where(has_room, 1.0, gp.mask[slot]))

    row_sel = jnp.arange(gp.n_max) == slot

    chols = []
    betas = []
    kinvs = []
    for d in range(gp.n_out):
        noise_var = jnp.exp(2.0 * gp.log_noise[d])
        # masked cross-covariances of the new point vs existing actives
        kv = gram(gp.kern_types[d], gp.params[d], x_new[None, :], x)[0] * gp.mask
        l_row = jax.scipy.linalg.solve_triangular(gp.chol[d], kv, lower=True)
        # old identity rows have L^{-1} = I on padding, kv is 0 there -> 0 contribution
        knn = kernel_diag(gp.kern_types[d], gp.params[d], x_new[None, :])[0]
        schur = jnp.maximum(
            knn + noise_var + _JITTER - jnp.dot(l_row, l_row), _JITTER
        )
        l_nn = jnp.sqrt(schur)
        # write the new row (old row was e_slot from identity padding)
        new_l = gp.chol[d]
        new_l = new_l.at[slot, :].set(jnp.where(row_sel, l_nn, l_row))
        # K^{-1} refresh in O(n^2): block inverse of the bordered matrix.
        # With w = K_old^{-1} kv and S the Schur complement (== l_nn^2, since
        # kv^T K^{-1} kv = ||L^{-1} kv||^2), the new inverse is
        #   [[Kinv + w w^T / S, -w / S], [-w^T / S, 1 / S]].
        # kv is masked by the OLD mask (kv[slot] = 0) and Kinv is identity on
        # padding, so w vanishes on every inactive slot — the rank-1 term
        # leaves padding rows untouched and the slot row/col overwrite below
        # replaces the old identity row exactly.
        w = gp.kinv[d] @ kv
        new_kinv = gp.kinv[d] + jnp.outer(w, w) / schur
        slot_vec = jnp.where(row_sel, 1.0 / schur, -w / schur)
        new_kinv = new_kinv.at[slot, :].set(slot_vec)
        new_kinv = new_kinv.at[:, slot].set(slot_vec)
        # beta refresh from the MAINTAINED CHOLESKY FACTOR (two O(n^2)
        # triangular solves), not from the repeatedly-Schur-updated kinv: the
        # bordered factor extension is exact given the previous factor, so
        # beta stays backed by a stabilizing factorization over long append
        # sequences while kinv (variance only) accumulates bounded rank-1
        # rounding drift (pinned by tests/test_gp.py append-drift test).
        yd = mask * y[:, d]
        z_half = jax.scipy.linalg.solve_triangular(new_l, yd, lower=True)
        b = jax.scipy.linalg.solve_triangular(new_l.T, z_half, lower=False)
        chols.append(jnp.where(has_room, new_l, gp.chol[d]))
        betas.append(jnp.where(has_room, b, gp.beta[d]))
        kinvs.append(jnp.where(has_room, new_kinv, gp.kinv[d]))

    return gp.replace(
        x=x, y=y, mask=mask, chol=jnp.stack(chols), beta=jnp.stack(betas),
        kinv=jnp.stack(kinvs), head=jnp.minimum(gp.head + 1, gp.n_max),
    )


def gp_shrink_to_bucket(gp: GP, *, min_bucket: int = 32) -> GP:
    """Slice the padded buffer down to the smallest power-of-2 bucket holding
    the active points (host-side, between jit regions).

    The solver's per-predict cost is O(n_max) for the mean and O(n_max^2) for
    the variance quadratic form REGARDLESS of how many points are real — the
    padding is identity rows, so a buffer sized 128 with 64 active points
    pays 2-4x the contraction work on every posterior evaluation inside the
    solve. Shape bucketing (the standard trick for dynamic sizes under
    static-shape compilation) recovers it:
    runners hand the PLANNER a bucketed view and keep appending into the
    full buffer. Factors are sliced, not recomputed — with identity padding
    every factor is block-diagonal across the active/padding boundary, so the
    sliced factors ARE the factors of the sliced problem (pinned by test).

    Requires append-only layout (no ring wrap): active rows are a prefix.
    """
    n_pts = int(jax.device_get(gp.n_points))
    n_bucket = min_bucket
    while n_bucket < n_pts:
        n_bucket *= 2
    n_bucket = min(n_bucket, gp.n_max)
    if n_bucket >= gp.n_max:
        return gp
    # verify prefix layout host-side (ring wrap would scatter active rows)
    mask_prefix = jax.device_get(gp.mask[:n_pts])
    if float(mask_prefix.min(initial=1.0)) < 1.0:
        return gp  # non-prefix layout: bucketing unavailable, keep full
    return gp.replace(
        x=gp.x[:n_bucket],
        y=gp.y[:n_bucket],
        mask=gp.mask[:n_bucket],
        chol=gp.chol[:, :n_bucket, :n_bucket],
        beta=gp.beta[:, :n_bucket],
        kinv=gp.kinv[:, :n_bucket, :n_bucket],
        head=jnp.minimum(gp.head, n_bucket),
    )


def gp_nll(params: tuple, log_noise: jax.Array, gp: GP) -> jax.Array:
    """Negative log marginal likelihood, summed over output dims.

    Identity padding contributes 0 to both the quadratic form and the log-det, so
    the value equals the unpadded NLL up to the constant 0.5*N*log(2*pi) term
    (which uses the true count). Parity: GPy's objective in
    ``SimpleGPModel.train`` (SURVEY.md §2.3).
    """
    n_eff = jnp.sum(gp.mask)
    kt = _uniform_kern(gp)
    if kt is not None:
        def per_dim(p, log_noise_d, yd):
            noise_var = jnp.exp(2.0 * log_noise_d)
            k = _masked_gram(kt, p, gp.x, gp.mask, noise_var)
            l = jnp.linalg.cholesky(k)
            z = jax.scipy.linalg.solve_triangular(l, gp.mask * yd, lower=True)
            return 0.5 * jnp.dot(z, z) + jnp.sum(jnp.log(jnp.diagonal(l)))

        per = jax.vmap(per_dim)(_stack_params(params), log_noise, gp.y.T)
        return jnp.sum(per) + gp.n_out * 0.5 * n_eff * jnp.log(2.0 * jnp.pi)

    total = jnp.asarray(0.0, gp.x.dtype)
    for d in range(gp.n_out):
        noise_var = jnp.exp(2.0 * log_noise[d])
        k = _masked_gram(gp.kern_types[d], params[d], gp.x, gp.mask, noise_var)
        l = jnp.linalg.cholesky(k)
        yd = gp.mask * gp.y[:, d]
        z = jax.scipy.linalg.solve_triangular(l, yd, lower=True)
        quad = 0.5 * jnp.dot(z, z)
        logdet = jnp.sum(jnp.log(jnp.diagonal(l)))
        total = total + quad + logdet + 0.5 * n_eff * jnp.log(2.0 * jnp.pi)
    return total


def gp_fit(gp: GP, *, iters: int = 200, lr: float = 5e-2,
           prior_strength: float = 0.5) -> GP:
    """Hyperparameter optimization: Adam on the log-space NLL, fixed iterations.

    Replaces GPy's L-BFGS ``optimize_restarts`` (SURVEY.md §2.3) with a jit-able
    fixed-budget optimizer so hyperopt can run INSIDE the episodic scan and be
    vmapped across episodes — the reference must drop to Python/LAPACK here.

    ``prior_strength`` is a weak Gaussian prior (in log space) centered at the
    CURRENT hyperparameters — the jit-able analog of GPy's bounded/priored
    optimization. It prevents small-data refits from collapsing lengthscales,
    which would blow up the Lipschitz remainder bounds (observed: an episodic
    cartpole refit on ~37 points drove one lengthscale to 0.2, l_mu to 9.5 and
    every subsequent solve infeasible). Set 0.0 for a pure ML-II fit.
    """
    opt = optax.adam(lr)
    theta_ref = (gp.params, gp.log_noise)

    def loss(theta):
        nll = gp_nll(theta[0], theta[1], gp)
        if prior_strength > 0.0:
            sq = jax.tree.map(lambda t, t0: jnp.sum((t - t0) ** 2),
                              theta, theta_ref)
            nll = nll + prior_strength * jax.tree.reduce(
                lambda a, b: a + b, sq
            )
        return nll

    theta0 = (gp.params, gp.log_noise)
    state0 = opt.init(theta0)

    def step(carry, _):
        theta, opt_state = carry
        g = jax.grad(loss)(theta)
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
        return (theta, opt_state), None

    (theta, _), _ = jax.lax.scan(step, (theta0, state0), None, length=iters)
    return gp_refit(gp.replace(params=theta[0], log_noise=theta[1]))


def _predict_dim(gp: GP, d: int, z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Latent posterior mean/variance of output dim d at a single input z (d_in,).

    Solve-free: var = kzz - kv^T K^{-1} kv via the precomputed inverse — two
    matvecs, no sequential triangular solve. This is the SQP's innermost op
    (traced, jacfwd'd and Hessian'd hundreds of times per solve); keeping it
    pure matmul work is what the kinv field exists for (see _kinv_from_chol).
    """
    kv = gram(gp.kern_types[d], gp.params[d], z[None, :], gp.x)[0] * gp.mask  # (n_max,)
    mean = jnp.dot(kv, gp.beta[d])
    kzz = kernel_diag(gp.kern_types[d], gp.params[d], z[None, :])[0]
    # Conditioning-aware variance floor: the quadratic form kzz - kv' Kinv kv
    # cancels to O(eps * kzz * cond) on ill-conditioned Grams; clamping the
    # rare negative result to an absolute 1e-12 UNDERESTIMATES posterior
    # uncertainty (a smaller safety tube — the unsafe direction). Floor at a
    # machine-epsilon multiple of the prior variance instead: ~1e-6*kzz in f32
    # (the cancellation scale), degrading to the old 1e-12 absolute floor in
    # f64 where the f64 oracle-parity tests live.
    floor = jnp.maximum(8.0 * jnp.finfo(kv.dtype).eps * kzz, 1e-12)
    var = jnp.maximum(kzz - jnp.dot(kv, gp.kinv[d] @ kv), floor)
    return mean, var


def gp_predict(gp: GP, z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Posterior mean and LATENT variance at one input.

    Args:   z: (d_in,) state-action input.
    Returns: (mean (e,), var (e,)).

    Parity: reference ``SimpleGPModel.predict`` / casadi ``gp_pred``
    (SURVEY.md §2.3) — mean is k(z,X) beta (O(n)), variance is
    k(z,z) - ||L^{-1} k(z,X)||^2 (O(n^2)).
    """
    # NOTE: deliberately a per-dim Python loop, NOT vmap-over-dims. This
    # function sits inside the SQP's nested jacfwd/hessian, where vmap over
    # e ~ 2-6 dims produced worse XLA than straight-line unrolled code on the
    # accelerator the solver was first tuned on (not measured on the GPU).
    # The vmapped fast paths live only in the non-differentiated refit and
    # the flat-gradient NLL.
    means, vars_ = zip(*(_predict_dim(gp, d, z) for d in range(gp.n_out)))
    return jnp.stack(means), jnp.stack(vars_)


def gp_predict_batch(gp: GP, z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched prediction: z (m, d_in) -> (mean (m, e), var (m, e))."""
    return jax.vmap(lambda zz: gp_predict(gp, zz))(z)


def gp_predict_full_cov(gp: GP, z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Joint posterior over a batch of query points with the FULL cross-point
    covariance: z (m, d_in) -> (mean (m, e), cov (e, m, m)).

    Parity: the ``full_cov=True`` branch of ``StateSpaceModel.predict`` /
    GPy ``predict(..., full_cov=True)`` (SURVEY.md §2.3; VERDICT r2 missing
    #5) — cov_d = K(Z,Z) - K(Z,X) K^{-1} K(X,Z), whose diagonal equals the
    per-point latent variance of :func:`gp_predict_batch`.
    """
    means, covs = [], []
    eps = jnp.finfo(z.dtype).eps
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        kv = gram(kt, params, z, gp.x) * gp.mask[None, :]     # (m, n_max)
        means.append(kv @ gp.beta[d])
        kzz = gram(kt, params, z, z)                          # (m, m)
        cov = kzz - kv @ (gp.kinv[d] @ kv.T)
        cov = 0.5 * (cov + cov.T)
        # conditioning-aware diagonal floor (same rationale as _predict_dim)
        diag = jnp.diagonal(cov)
        floor = jnp.maximum(8.0 * eps * jnp.diagonal(kzz), 1e-12)
        cov = cov + jnp.diag(jnp.maximum(diag, floor) - diag)
        covs.append(cov)
    return jnp.stack(means, axis=-1), jnp.stack(covs)


def gp_predict_mean_jac(
    gp: GP, z: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Posterior mean, latent variance and CLOSED-FORM mean Jacobian at one
    input: returns (mean (e,), var (e,), jac_mean (e, d_in)).

    The reachability linearization consumes exactly this triple per stage per
    Newton iteration (SURVEY.md §2.4); computing the Jacobian analytically
    (kernels.weighted_mean_jac — one extra matvec per dim) instead of by a
    nested ``jacfwd`` collapses the hot-loop graph the SQP then forward-mode
    differentiates (VERDICT r2 #2). Equivalence with the jacfwd path is pinned
    in tests/test_gp.py.
    """
    from safe_exploration_tpu.models.kernels import weighted_mean_jac

    means, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        kv = gram(kt, params, z[None, :], gp.x)[0] * gp.mask
        c = gp.mask * gp.beta[d]
        means.append(jnp.dot(kv, gp.beta[d]))
        kzz = kernel_diag(kt, params, z[None, :])[0]
        floor = jnp.maximum(8.0 * jnp.finfo(kv.dtype).eps * kzz, 1e-12)
        vars_.append(jnp.maximum(kzz - jnp.dot(kv, gp.kinv[d] @ kv), floor))
        jacs.append(weighted_mean_jac(kt, params, z, gp.x, kv, c))
    return jnp.stack(means), jnp.stack(vars_), jnp.stack(jacs)


def gp_predict_jac(
    gp: GP, z: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Prediction + input-Jacobians of mean and std at one input.

    Returns (mean (e,), var (e,), jac_mean (e, d_in), jac_std (e, d_in)).

    Parity: reference ``SimpleGPModel.predictive_gradients`` / ``linearize_predict``
    (SURVEY.md §2.3, §3.4) — implemented as ONE ``jacfwd`` over the predict
    function instead of GPy's handwritten gradient formulas. Value and both
    Jacobians come out of a single fused forward pass: jacfwd's primal
    computation is tangent-independent, so XLA sees one posterior evaluation,
    not three (round 1 evaluated mean/std/value separately).
    """
    e = gp.n_out

    def both(zz):
        m, v = gp_predict(gp, zz)
        return jnp.concatenate([m, jnp.sqrt(v)]), (m, v)

    jac, (mean, var) = jax.jacfwd(both, has_aux=True)(z)
    return mean, var, jac[:e], jac[e:]


def gp_export_params(gp: GP) -> dict[str, Any]:
    """Flat dict view of hyperparameters (checkpointing / logging)."""
    return {
        "params": gp.params,
        "log_noise": gp.log_noise,
        "n_points": gp.n_points,
    }
