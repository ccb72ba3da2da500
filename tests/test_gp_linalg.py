"""Oracle tests of the GP refit's linear algebra: the masked Gram, the
refit Cholesky, the two triangular solves for beta, the explicit inverse and
``solve_psd_chol``, against numpy/scipy (SURVEY.md §4.1 cross-implementation
parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from safe_exploration_tpu.models.gp import _kinv_from_chol, _masked_gram, gp_init
from safe_exploration_tpu.models.kernels import init_kernel_params
from safe_exploration_tpu.ops.linalg import solve_psd_chol


def _spd(rng, n, dtype=jnp.float64):
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    return jnp.asarray(a, dtype)


def _np_rbf(x, params):
    ls = np.exp(np.asarray(params["log_lengthscales"], np.float64))
    sf2 = np.exp(2.0 * float(params["log_sf"]))
    xs = np.asarray(x) / ls
    d2 = np.sum((xs[:, None, :] - xs[None, :, :]) ** 2, axis=-1)
    return sf2 * np.exp(-0.5 * d2)


# ---------------------------------------------------------------- cholesky ---


def _refit_chol_vs_scipy(rng, n, e, dtype):
    """gp_refit's factor (Gram + Cholesky) and scipy's of the numpy Gram."""
    x = rng.standard_normal((n, 3))
    y = rng.standard_normal((n, e))
    gp = gp_init(("rbf",) * e, jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                 n_max=n)
    noise = float(np.exp(2.0 * np.asarray(gp.log_noise[0], np.float64)))
    k = _np_rbf(x, gp.params[0]) + (noise + 1e-6) * np.eye(n)
    return gp.chol, scipy.linalg.cholesky(k, lower=True)


@pytest.mark.parametrize("n", [64, 128, 200, 384])
def test_refit_cholesky_matches_scipy(rng, n):
    chol, ref = _refit_chol_vs_scipy(rng, n, 1, jnp.float64)
    np.testing.assert_allclose(chol[0], ref, rtol=1e-9, atol=1e-9)


def test_refit_cholesky_batched(rng):
    """Three output dims with one kernel type take the vmapped refit."""
    chol, ref = _refit_chol_vs_scipy(rng, 128, 3, jnp.float64)
    assert chol.shape == (3, 128, 128)
    for i in range(3):
        np.testing.assert_allclose(chol[i], ref, rtol=1e-9, atol=1e-9)


def test_refit_cholesky_f32_accuracy(rng):
    """f32 factor stays within the f32 conditioning-driven error of f64."""
    chol, ref = _refit_chol_vs_scipy(rng, 256, 1, jnp.float32)
    np.testing.assert_allclose(np.asarray(chol[0], np.float64), ref,
                               rtol=2e-4, atol=2e-4)


# ------------------------------------------------------- triangular solves ---


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(128, 1), (128, 64), (300, 140)])
def test_refit_triangular_solve_matches_scipy(rng, shape, transpose):
    """The two solves gp_refit uses for beta: L z = y and L^T b = z."""
    n, m = shape
    l = jnp.linalg.cholesky(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal((n, m)))
    lhs = l.T if transpose else l
    x = jax.scipy.linalg.solve_triangular(lhs, b, lower=not transpose)
    x_ref = scipy.linalg.solve_triangular(np.asarray(lhs), np.asarray(b),
                                          lower=not transpose)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-8)


def test_solve_psd_chol_vector_rhs(rng):
    a = _spd(rng, 200)
    l = jnp.linalg.cholesky(a)
    b = jnp.asarray(rng.standard_normal(200))
    x = solve_psd_chol(l, b)
    assert x.shape == (200,)
    ref = scipy.linalg.cho_solve((np.asarray(l), True), np.asarray(b))
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-8)


def test_solve_psd_chol_roundtrip(rng):
    a = _spd(rng, 256)
    l = jnp.linalg.cholesky(a)
    b = jnp.asarray(rng.standard_normal((256, 32)))
    x = solve_psd_chol(l, b)
    np.testing.assert_allclose(a @ x, b, rtol=1e-7, atol=1e-7)


# ---------------------------------------------------------- explicit inverse ---


@pytest.mark.parametrize("n,dtype,tol", [
    (256, jnp.float32, 2e-4),
    (640, jnp.float32, 2e-4),
    (384, jnp.float64, 1e-9),
])
def test_kinv_from_chol_matches_scipy(rng, n, dtype, tol):
    """K^{-1} from the factor, scaled by ||K^{-1}||: f32 at the sizes the
    refit sees, f64 against scipy's inverse to roundoff."""
    a = _spd(rng, n)
    ref = scipy.linalg.inv(np.asarray(a))
    kinv = _kinv_from_chol(jnp.linalg.cholesky(a.astype(dtype)))
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(np.asarray(kinv, np.float64) / scale,
                               ref / scale, rtol=0, atol=tol)


# -------------------------------------------------------------------- gram ---


@pytest.mark.parametrize("n,n_active", [(64, 64), (300, 220), (512, 40)])
def test_masked_gram_matches_numpy(rng, n, n_active):
    d = 3
    x = jnp.asarray(rng.standard_normal((n, d)))
    mask = jnp.zeros((n,), x.dtype).at[:n_active].set(1.0)
    params = init_kernel_params("rbf", d, x.dtype)
    params = {
        "log_lengthscales": params["log_lengthscales"] + 0.3,
        "log_sf": params["log_sf"] - 0.2,
    }
    noise_var = 1e-3
    k = _masked_gram("rbf", params, x, mask, jnp.asarray(noise_var, x.dtype))
    m = np.asarray(mask)
    ref = _np_rbf(x, params) * np.outer(m, m)
    ref += np.diag(m * (noise_var + 1e-6) + (1.0 - m))
    np.testing.assert_allclose(k, ref, rtol=1e-9, atol=1e-9)


def test_masked_gram_padding_is_identity(rng):
    """Masked rows/cols reduce to identity so chol works for any mask."""
    x = jnp.asarray(rng.standard_normal((130, 4)))
    mask = jnp.zeros((130,), x.dtype).at[:7].set(1.0)
    params = init_kernel_params("rbf", 4, x.dtype)
    k = _masked_gram("rbf", params, x, mask, jnp.asarray(1e-2, x.dtype))
    l = jnp.linalg.cholesky(k)
    assert bool(jnp.all(jnp.isfinite(l)))
    np.testing.assert_allclose(k[7:, 7:], jnp.eye(123, dtype=x.dtype),
                               atol=1e-12)
    np.testing.assert_allclose(k[:7, 7:], 0.0, atol=0)
