"""Sparse (inducing-point) GP regression — the large-N tier (BASELINE config 4).

Parity: the reference's sparse option in ``ssm_gpy/gaussian_process.py``
(GPy ``SparseGPRegression`` via ``Z`` inducing inputs — SURVEY.md §2.3). This is
the Titsias/VFE (SGPR) formulation:

    Sigma   = Kuu + sigma_n^-2 Kuf Kuf^T              (m x m)
    alpha   = sigma_n^-2 Sigma^-1 Kuf y               (m,)
    mean(z) = Kzu alpha
    var(z)  = Kzz - Kzu Kuu^-1 Kuz + Kzu Sigma^-1 Kuz

Cost: O(N m^2) to build factors, O(m^2) per predict — N = 10k training points
with m = 128-512 inducing points stays real-time inside the MPC loop.

Accelerator-first: the only O(N) contractions are ``Kuf Kuf^T`` and ``Kuf y``
— pure matmuls, and exactly the terms that shard over a
device mesh with a single psum each (see parallel/sharded_gp.py). Masked padding
works as in the dense GP: masked columns of Kuf are zeroed, so they contribute
nothing to either contraction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_exploration_tpu.models.kernels import gram, init_kernel_params, kernel_diag
from safe_exploration_tpu.utils import struct

__all__ = [
    "SparseGP",
    "SparseGPSSM",
    "make_sparse_gp_ssm",
    "sparse_gp_init",
    "sparse_gp_refit",
    "sparse_gp_update_data",
    "sparse_gp_predict",
    "sparse_gp_predict_full_cov",
    "sparse_gp_elbo",
    "sparse_gp_fit",
]

_JITTER = 1e-6


@struct.dataclass
class SparseGP:
    """Inducing-point multi-output GP state (pytree)."""

    kern_types: tuple = struct.field(pytree_node=False)
    z: jax.Array          # (m, d_in) inducing inputs (shared across output dims)
    x: jax.Array          # (n_max, d_in) padded training inputs
    y: jax.Array          # (n_max, e)
    mask: jax.Array       # (n_max,)
    params: tuple         # per-dim kernel params
    log_noise: jax.Array  # (e,)
    luu: jax.Array        # (e, m, m) chol(Kuu + jitter)
    lsig: jax.Array       # (e, m, m) chol(Sigma)
    alpha: jax.Array      # (e, m) predictive-mean weights
    vmat: jax.Array       # (e, m, m) Kuu^{-1} - Sigma^{-1} (solve-free variance)
    head: jax.Array       # () int32 ring-buffer pointer

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_inducing(self) -> int:
        return self.z.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    @property
    def n_points(self) -> jax.Array:
        return jnp.sum(self.mask).astype(jnp.int32)


def _factors_from_whitened(
    luu: jax.Array, aat: jax.Array, ayw: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(lsig, alpha, vmat) from the WHITENED data contractions.

    Inputs: ``luu`` = chol(Kuu + jitter); ``aat`` = A A^T and ``ayw`` = A y /
    sigma_n, where A = Luu^{-1} Kuf / sigma_n is the whitened cross-factor
    (the same A as :func:`sparse_gp_elbo`). With B = I + A A^T:

        Sigma          = Luu B Luu^T        -> lsig = Luu chol(B)
        alpha          = Luu^{-T} B^{-1} (A y / sigma_n)
        Kuu^{-1}-Sig^{-1} = Li^T (I - B^{-1}) Li,  Li = Luu^{-1}
                       = Li^T Li - C^T C,   C = chol(B)^{-1} Li

    Numerics (the reason this exists): forming Sigma = Kuu + Kuf Kuf^T /
    sigma_n^2 and factoring it DIRECTLY breaks down in f32 at BASELINE-cfg-4
    scale — cond(Sigma) ~ (N sf^2/sigma_n^2) / jitter blows past 1e8 for
    N=10k low-noise data, the Cholesky pivot goes negative and every factor
    NaNs (observed in CPU f32). B's eigenvalues are >= 1, so
    chol(B) never sees a negative pivot and its relative error stays bounded
    regardless of N — the standard GPy/GPflow-stable SGPR formulation.

    Predict-time variance stays solve-free: kzz - kzu @ vmat @ kzu — ONE
    matvec per posterior evaluation (same rationale as the dense GP's kinv,
    models/gp.py::_kinv_from_chol): this path sits inside the SQP's
    traced/differentiated hot loop.
    """
    m = luu.shape[-1]
    eye = jnp.eye(m, dtype=luu.dtype)
    bmat = eye + 0.5 * (aat + aat.T)
    lb = jnp.linalg.cholesky(bmat)
    lsig = luu @ lb
    w = jax.scipy.linalg.solve_triangular(lb, ayw, lower=True)
    v = jax.scipy.linalg.solve_triangular(lb.T, w, lower=False)
    alpha = jax.scipy.linalg.solve_triangular(luu.T, v, lower=False)
    li = jax.scipy.linalg.solve_triangular(luu, eye, lower=True)
    c = jax.scipy.linalg.solve_triangular(lb, li, lower=True)
    vmat = li.T @ li - c.T @ c
    return lsig, alpha, vmat


def _kuu_jitter(kuu: jax.Array) -> jax.Array:
    """Cholesky jitter for Kuu, scaled to the dtype's ACTUAL rounding floor.

    A fixed 1e-6 is fine in f64 but below f32's noise: the gram's rounding
    error perturbs eigenvalues by ~eps * lambda_max ~ eps * tr(Kuu), which at
    m=256/sf=1 is ~2.5e-5 — numerically-negative eigenvalues swamp a 1e-6
    shift and chol NaNs (observed: 256 inducing points padded from 64 data
    points, f32). 12*eps*tr covers that bound with margin; the 1e-6 floor
    keeps f64 behavior (and the frozen f64 goldens) bit-identical.
    """
    eps = jnp.finfo(kuu.dtype).eps
    return jnp.maximum(jnp.asarray(_JITTER, kuu.dtype),
                       12.0 * eps * jnp.trace(kuu))


def _factors_dim(kt, params, z, x, mask, y_d, noise_var):
    """(luu, lsig, alpha, vmat) for one output dim (whitened-stable form)."""
    m = z.shape[0]
    kuu0 = gram(kt, params, z, z)
    kuu = kuu0 + _kuu_jitter(kuu0) * jnp.eye(m, dtype=z.dtype)
    kuf = gram(kt, params, z, x) * mask[None, :]  # (m, n)
    luu = jnp.linalg.cholesky(kuu)
    sn = jnp.sqrt(noise_var)
    a = jax.scipy.linalg.solve_triangular(luu, kuf, lower=True) / sn
    lsig, alpha, vmat = _factors_from_whitened(
        luu, a @ a.T, a @ (mask * y_d) / sn
    )
    return luu, lsig, alpha, vmat


def sparse_gp_refit(sgp: SparseGP) -> SparseGP:
    """Rebuild (luu, lsig, alpha, vmat) for the current data + hyperparameters."""
    luus, lsigs, alphas, vmats = [], [], [], []
    for d in range(sgp.n_out):
        noise_var = jnp.exp(2.0 * sgp.log_noise[d]) + _JITTER
        luu, lsig, alpha, vmat = _factors_dim(
            sgp.kern_types[d], sgp.params[d], sgp.z, sgp.x, sgp.mask,
            sgp.y[:, d], noise_var,
        )
        luus.append(luu)
        lsigs.append(lsig)
        alphas.append(alpha)
        vmats.append(vmat)
    return sgp.replace(
        luu=jnp.stack(luus), lsig=jnp.stack(lsigs), alpha=jnp.stack(alphas),
        vmat=jnp.stack(vmats),
    )


def sparse_gp_init(
    kern_types: tuple,
    x: jax.Array,
    y: jax.Array,
    *,
    n_max: int,
    n_inducing: int,
    log_noise: float | jax.Array = -2.3,
    z: jax.Array | None = None,
    params: tuple | None = None,
) -> SparseGP:
    """Build a sparse GP; inducing inputs default to an even subsample of the
    initial data (padded with small jittered copies if data < m)."""
    n, d_in = x.shape
    e = y.shape[1]
    dtype = x.dtype
    if z is None:
        idx = jnp.linspace(0, max(n - 1, 0), n_inducing).astype(jnp.int32)
        # jitter scale matters when n < m: the even subsample then REPEATS
        # data points, and near-duplicate inducing inputs make Kuu
        # numerically singular (observed: NaN whitened factors in f32 at
        # 1e-4 spacing with O(1) lengthscales — 64 points padded to m=256).
        # Inducing inputs are free variational parameters, so a 1e-2 spread
        # is equally valid and keeps chol(Kuu) well-conditioned; with n >= m
        # the subsample has no duplicates and the jitter is cosmetic.
        z = x[idx] + 1e-2 * jnp.sin(
            jnp.arange(n_inducing, dtype=dtype)[:, None]
            * jnp.arange(1, d_in + 1, dtype=dtype)[None, :]
        )
    xp = jnp.zeros((n_max, d_in), dtype).at[:n].set(x)
    yp = jnp.zeros((n_max, e), dtype).at[:n].set(y)
    mask = jnp.zeros((n_max,), dtype).at[:n].set(1.0)
    if params is None:
        params = tuple(init_kernel_params(kt, d_in, dtype) for kt in kern_types)
    m = z.shape[0]
    sgp = SparseGP(
        kern_types=tuple(kern_types),
        z=z, x=xp, y=yp, mask=mask, params=params,
        log_noise=jnp.broadcast_to(jnp.asarray(log_noise, dtype), (e,)),
        luu=jnp.zeros((e, m, m), dtype),
        lsig=jnp.zeros((e, m, m), dtype),
        alpha=jnp.zeros((e, m), dtype),
        vmat=jnp.zeros((e, m, m), dtype),
        head=jnp.asarray(n, jnp.int32),
    )
    return sparse_gp_refit(sgp)


def sparse_gp_update_data(
    sgp: SparseGP, x_new: jax.Array, y_new: jax.Array, *, replace_old: bool = True
) -> SparseGP:
    """Append a transition batch (ring buffer) and refit factors — O(N m^2)."""
    k = x_new.shape[0]
    idx = (sgp.head + jnp.arange(k, dtype=jnp.int32)) % sgp.n_max
    if not replace_old:
        keep = (sgp.head + jnp.arange(k, dtype=jnp.int32)) < sgp.n_max
        idx = jnp.minimum(sgp.head + jnp.arange(k, dtype=jnp.int32), sgp.n_max - 1)
    else:
        keep = jnp.ones((k,), bool)
    x = sgp.x.at[idx].set(jnp.where(keep[:, None], x_new, sgp.x[idx]))
    y = sgp.y.at[idx].set(jnp.where(keep[:, None], y_new, sgp.y[idx]))
    mask = sgp.mask.at[idx].set(jnp.where(keep, 1.0, sgp.mask[idx]))
    head = (sgp.head + k) % sgp.n_max if replace_old else jnp.minimum(
        sgp.head + k, sgp.n_max
    )
    return sparse_gp_refit(sgp.replace(x=x, y=y, mask=mask, head=head))


def sparse_gp_predict(sgp: SparseGP, zq: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Posterior mean and latent variance at one input zq (d_in,) -> ((e,), (e,)).

    Solve-free (mean: one matvec vs alpha; variance: one matvec vs the
    precomputed vmat) — see _factors_from_whitened.
    """
    means, vars_ = [], []
    for d in range(sgp.n_out):
        kt, params = sgp.kern_types[d], sgp.params[d]
        kzu = gram(kt, params, zq[None, :], sgp.z)[0]  # (m,)
        mean = jnp.dot(kzu, sgp.alpha[d])
        kzz = kernel_diag(kt, params, zq[None, :])[0]
        var = kzz - jnp.dot(kzu, sgp.vmat[d] @ kzu)
        means.append(mean)
        # conditioning-aware floor (see models/gp.py::_predict_dim): clamping
        # f32 cancellation to an absolute 1e-12 underestimates uncertainty
        floor = jnp.maximum(8.0 * jnp.finfo(kzu.dtype).eps * kzz, 1e-12)
        vars_.append(jnp.maximum(var, floor))
    return jnp.stack(means), jnp.stack(vars_)


def sparse_gp_predict_mean_jac(
    sgp: SparseGP, zq: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Mean, latent variance and CLOSED-FORM mean Jacobian (e, d_in) at one
    input — the sparse-family analog of ``gp.gp_predict_mean_jac`` (same
    hot-loop rationale; the weighted sum runs over the inducing set)."""
    from safe_exploration_tpu.models.kernels import weighted_mean_jac

    means, vars_, jacs = [], [], []
    for d in range(sgp.n_out):
        kt, params = sgp.kern_types[d], sgp.params[d]
        kzu = gram(kt, params, zq[None, :], sgp.z)[0]
        means.append(jnp.dot(kzu, sgp.alpha[d]))
        kzz = kernel_diag(kt, params, zq[None, :])[0]
        floor = jnp.maximum(8.0 * jnp.finfo(kzu.dtype).eps * kzz, 1e-12)
        vars_.append(
            jnp.maximum(kzz - jnp.dot(kzu, sgp.vmat[d] @ kzu), floor)
        )
        jacs.append(weighted_mean_jac(kt, params, zq, sgp.z, kzu, sgp.alpha[d]))
    return jnp.stack(means), jnp.stack(vars_), jnp.stack(jacs)


def sparse_gp_predict_full_cov(
    sgp: SparseGP, zq: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Joint posterior over a query batch with full cross-point covariance:
    zq (k, d_in) -> (mean (k, e), cov (e, k, k)).

    Parity: ``full_cov=True`` branch of ``StateSpaceModel.predict`` for the
    sparse family (SURVEY.md §2.3) — cov = Kzz - Kzu (Kuu^{-1} - Sigma^{-1})
    Kuz, whose diagonal equals :func:`sparse_gp_predict`'s variance.
    """
    means, covs = [], []
    eps = jnp.finfo(zq.dtype).eps
    for d in range(sgp.n_out):
        kt, params = sgp.kern_types[d], sgp.params[d]
        kzu = gram(kt, params, zq, sgp.z)                     # (k, m)
        means.append(kzu @ sgp.alpha[d])
        kzz = gram(kt, params, zq, zq)
        cov = kzz - kzu @ (sgp.vmat[d] @ kzu.T)
        cov = 0.5 * (cov + cov.T)
        diag = jnp.diagonal(cov)
        floor = jnp.maximum(8.0 * eps * jnp.diagonal(kzz), 1e-12)
        cov = cov + jnp.diag(jnp.maximum(diag, floor) - diag)
        covs.append(cov)
    return jnp.stack(means, axis=-1), jnp.stack(covs)


def sparse_gp_elbo(
    params: tuple, log_noise: jax.Array, sgp: SparseGP,
    z: jax.Array | None = None,
) -> jax.Array:
    """Negative Titsias VFE bound (to MINIMIZE), summed over output dims.

    -ELBO = 0.5 [ N log(2 pi sigma^2) + 2 sum log diag(LB) + sigma^-2 y^T y
                  - c^T c + sigma^-2 (tr(Kff) - tr(Qff)) ]
    with A = Luu^-1 Kuf / sigma, B = I + A A^T, c = LB^-1 A y / sigma.

    ``z`` overrides the stored inducing inputs — differentiable, so the fit can
    optimize Z as a variational parameter (GPy ``SparseGPRegression.optimize``
    trains Z too, SURVEY.md §2.3; VERDICT r2 missing #5).
    """
    zi = sgp.z if z is None else z
    total = jnp.asarray(0.0, sgp.x.dtype)
    n_eff = jnp.sum(sgp.mask)
    m = sgp.n_inducing
    eye = jnp.eye(m, dtype=sgp.x.dtype)
    for d in range(sgp.n_out):
        kt = sgp.kern_types[d]
        noise_var = jnp.exp(2.0 * log_noise[d]) + _JITTER
        kuu0 = gram(kt, params[d], zi, zi)
        kuu = kuu0 + _kuu_jitter(kuu0) * eye
        kuf = gram(kt, params[d], zi, sgp.x) * sgp.mask[None, :]
        luu = jnp.linalg.cholesky(kuu)
        a = jax.scipy.linalg.solve_triangular(luu, kuf, lower=True) / jnp.sqrt(noise_var)
        bmat = eye + a @ a.T
        lb = jnp.linalg.cholesky(bmat)
        yd = sgp.mask * sgp.y[:, d]
        c = jax.scipy.linalg.solve_triangular(
            lb, a @ yd, lower=True
        ) / jnp.sqrt(noise_var)
        tr_kff = jnp.sum(kernel_diag(kt, params[d], sgp.x) * sgp.mask)
        tr_qff = jnp.sum(a * a) * noise_var
        total = total + 0.5 * (
            n_eff * jnp.log(2.0 * jnp.pi * noise_var)
            + 2.0 * jnp.sum(jnp.log(jnp.diagonal(lb)))
            + jnp.dot(yd, yd) / noise_var
            - jnp.dot(c, c)
            + (tr_kff - tr_qff) / noise_var
        )
    return total


def sparse_gp_fit(sgp: SparseGP, *, iters: int = 200, lr: float = 5e-2,
                  prior_strength: float = 0.5, opt_z: bool = True) -> SparseGP:
    """Hyperparameter + inducing-input fit by Adam on the negative VFE bound
    (fixed budget, jit-able — replaces GPy's L-BFGS on the sparse marginal
    likelihood, which optimizes kernel hypers, noise AND Z jointly).

    ``prior_strength`` anchors the log-hypers as in ``gp.gp_fit`` (prevents
    lengthscale collapse that inflates the Lipschitz remainder bounds). The
    inducing inputs are a VARIATIONAL parameter — more of them only tightens
    the bound — so they are deliberately NOT anchored: the ELBO itself is
    their regularizer (Titsias 2009), and pinning them to the initial data
    subsample would defeat the point of optimizing them (VERDICT r2 #8).
    """
    import optax

    opt = optax.adam(lr)
    theta_ref = (sgp.params, sgp.log_noise)

    def loss(theta):
        (params, log_noise), z = theta
        obj = sparse_gp_elbo(params, log_noise, sgp, z=z)
        if prior_strength > 0.0:
            sq = jax.tree.map(lambda t, t0: jnp.sum((t - t0) ** 2),
                              (params, log_noise), theta_ref)
            obj = obj + prior_strength * jax.tree.reduce(lambda a, b: a + b, sq)
        return obj

    theta0 = ((sgp.params, sgp.log_noise), sgp.z if opt_z else None)
    state0 = opt.init(theta0)

    def step(carry, _):
        theta, opt_state = carry
        g = jax.grad(loss)(theta)
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
        return (theta, opt_state), None

    (theta, _), _ = jax.lax.scan(step, (theta0, state0), None, length=iters)
    (params, log_noise), z = theta
    new = sgp.replace(params=params, log_noise=log_noise)
    if opt_z:
        new = new.replace(z=z)
    return sparse_gp_refit(new)


@struct.dataclass
class SparseGPSSM:
    """Sparse-GP-backed state-space model (the BASELINE config-4 tier).

    Satisfies the SSM protocol (``predict_latent`` / ``noise_var`` + Lipschitz
    constants), so the SAME reachability engine and planners consume it — this
    is how the N=10k inducing-point GP sits inside the MPC loop. Parity:
    reference ``SimpleGPModel`` with a ``Z`` inducing set (SURVEY.md §2.3).
    """

    sgp: SparseGP
    l_mu: jax.Array     # (n_s,)
    l_sigma: jax.Array  # (n_s,)
    # optional input-normalization scales — see models/ssm.py::GPSSM.z_scale
    z_scale: jax.Array | None = None

    def predict_latent(self, zq: jax.Array):
        if self.z_scale is not None:
            zq = zq / self.z_scale
        return sparse_gp_predict(self.sgp, zq)

    def noise_var(self) -> jax.Array:
        return jnp.exp(2.0 * self.sgp.log_noise)


def make_sparse_gp_ssm(
    kern_types: tuple,
    x: jax.Array,
    u: jax.Array,
    y: jax.Array,
    *,
    n_max: int,
    n_inducing: int,
    l_mu: jax.Array,
    l_sigma: jax.Array,
    log_noise: float = -2.3,
    z_scale: jax.Array | None = None,
) -> SparseGPSSM:
    """Build a sparse-GP SSM from transition data (x, u) -> residual y."""
    z = jnp.concatenate([x, u], axis=-1)
    params = None
    if z_scale is not None:
        z = z / z_scale
        from safe_exploration_tpu.models.ssm import _scale_consistent_params

        params = _scale_consistent_params(kern_types, z_scale)
    sgp = sparse_gp_init(
        kern_types, z, y, n_max=n_max, n_inducing=n_inducing,
        log_noise=log_noise, params=params,
    )
    return SparseGPSSM(sgp=sgp, l_mu=l_mu, l_sigma=l_sigma, z_scale=z_scale)
