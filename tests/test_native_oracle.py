"""Cross-LANGUAGE oracle tests: JAX implementations vs the native C++ oracle.

The reference pins numpy-vs-CasADi-vs-torch equivalence (SURVEY.md §4.1);
here the second implementation is first-party C++ (native/oracle.cpp), so the
same random-input-allclose strategy validates the JAX math against a compiler,
runtime and algorithm stack that shares nothing with XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.utils.native_oracle import load_oracle

oracle = load_oracle()
pytestmark = pytest.mark.skipif(oracle is None, reason="no C++ toolchain")


def test_ellipsoid_sum_matches(rng):
    from safe_exploration_tpu.ops.ellipsoid import sum_two_ellipsoids

    for _ in range(5):
        n = int(rng.integers(2, 7))
        m1 = rng.standard_normal((n, n))
        m2 = rng.standard_normal((n, n))
        q1, q2 = m1 @ m1.T, m2 @ m2.T
        p1, p2 = rng.standard_normal(n), rng.standard_normal(n)
        pj, qj = sum_two_ellipsoids(*map(jnp.asarray, (p1, q1, p2, q2)))
        pc, qc = oracle.ellipsoid_sum(p1, q1, p2, q2)
        np.testing.assert_allclose(pj, pc, rtol=1e-12)
        np.testing.assert_allclose(qj, qc, rtol=1e-12)


def test_ellipsoid_from_rect_matches(rng):
    from safe_exploration_tpu.ops.ellipsoid import ellipsoid_from_rectangle

    ub = np.abs(rng.standard_normal(5))
    np.testing.assert_allclose(
        ellipsoid_from_rectangle(jnp.asarray(ub)),
        oracle.ellipsoid_from_rect(ub),
        rtol=1e-14,
    )


def test_remainder_overapprox_matches(rng):
    from safe_exploration_tpu.ops.lipschitz import (
        compute_remainder_overapproximations,
    )

    m = rng.standard_normal((3, 3))
    q = m @ m.T
    k_fb = rng.standard_normal((2, 3))
    l_mu = np.abs(rng.standard_normal(3))
    l_sigma = np.abs(rng.standard_normal(3))
    u_mu_j, u_sig_j = compute_remainder_overapproximations(
        *map(jnp.asarray, (q, k_fb, l_mu, l_sigma))
    )
    u_mu_c, u_sig_c = oracle.remainder_overapprox(q, k_fb, l_mu, l_sigma)
    np.testing.assert_allclose(u_mu_j, u_mu_c, rtol=1e-9)
    np.testing.assert_allclose(u_sig_j, u_sig_c, rtol=1e-9)


def test_cholesky_and_trsm_match(rng):
    n = 96
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    l_c = oracle.cholesky(a)
    np.testing.assert_allclose(l_c, np.linalg.cholesky(a), rtol=1e-10, atol=1e-10)
    l_j = jnp.linalg.cholesky(jnp.asarray(a))
    np.testing.assert_allclose(l_j, l_c, rtol=1e-9, atol=1e-9)

    b = rng.standard_normal((n, 7))
    x_c = oracle.trsm_lower(l_c, b)
    x_j = jax.scipy.linalg.solve_triangular(jnp.asarray(l_c), jnp.asarray(b),
                                            lower=True)
    np.testing.assert_allclose(x_c, x_j, rtol=1e-9, atol=1e-11)
    xt_c = oracle.trsm_lower(l_c, b, transpose=True)
    xt_j = jax.scipy.linalg.solve_triangular(jnp.asarray(l_c).T, jnp.asarray(b),
                                             lower=False)
    np.testing.assert_allclose(xt_c, xt_j, rtol=1e-9, atol=1e-11)


def test_dare_matches(rng):
    from safe_exploration_tpu.ops.linalg import dare_sda

    a = np.asarray([[1.0, 0.05], [0.49, 1.0]])
    b = np.asarray([[0.0], [0.1]])
    q = np.eye(2)
    r = np.eye(1)
    x_j = dare_sda(*map(jnp.asarray, (a, b, q, r)))
    x_c = oracle.dare_sda(a, b, q, r)
    np.testing.assert_allclose(x_j, x_c, rtol=1e-10)


def test_rbf_posterior_matches(rng):
    from safe_exploration_tpu.models.gp import gp_init, gp_predict

    n, d = 40, 3
    x = rng.standard_normal((n, d))
    y = np.sin(x[:, :1]) + 0.01 * rng.standard_normal((n, 1))
    gp = gp_init(("rbf",), jnp.asarray(x), jnp.asarray(y), n_max=64)
    z = rng.standard_normal(d)
    mu_j, var_j = gp_predict(gp, jnp.asarray(z))
    params = gp.params[0]
    mu_c, var_c = oracle.rbf_posterior(
        np.asarray(gp.x), np.asarray(gp.mask), np.asarray(gp.beta[0]),
        np.asarray(gp.chol[0]), z,
        np.exp(np.asarray(params["log_lengthscales"])),
        float(np.exp(2.0 * params["log_sf"])),
    )
    np.testing.assert_allclose(float(mu_j[0]), mu_c, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(var_j[0]), var_c, rtol=1e-8, atol=1e-12)


def test_onestep_reachability_end_to_end_matches(rng):
    """Composed end-to-end gate: the full one-step reachability (GP posterior
    + ANALYTIC mean Jacobian + remainders + Minkowski sums) re-derived in C++
    must match the JAX engine (which uses jacfwd) to f64 precision."""
    from safe_exploration_tpu.models import make_gp_ssm
    from safe_exploration_tpu.models.gp import gp_refit
    from safe_exploration_tpu.reachability.onestep import onestep_reachability

    n, n_s, n_u = 30, 2, 1
    xs = rng.uniform(-0.4, 0.4, (n, n_s))
    us = rng.uniform(-1, 1, (n, n_u))
    ys = 0.01 * rng.standard_normal((n, n_s))
    ssm = make_gp_ssm(
        ("rbf", "rbf"), *map(jnp.asarray, (xs, us, ys)), n_max=n,
        l_mu=jnp.asarray([0.3, 0.2]), l_sigma=jnp.asarray([0.1, 0.15]),
        log_noise=-3.5,
    )
    # perturb hypers so nothing is at init defaults
    params = tuple(
        {"log_lengthscales": p["log_lengthscales"] + 0.2 * d,
         "log_sf": p["log_sf"] - 1.0 - 0.1 * d}
        for d, p in enumerate(ssm.gp.params)
    )
    ssm = ssm.replace(gp=gp_refit(ssm.gp.replace(params=params)))

    p = jnp.asarray([0.05, -0.1])
    mq = rng.standard_normal((n_s, n_s)) * 0.05
    q = jnp.asarray(mq @ mq.T + 0.001 * np.eye(n_s))
    k_ff = jnp.asarray([0.3])
    k_fb = jnp.asarray([[-0.8, -0.5]])
    a = jnp.asarray([[1.0, 0.05], [0.49, 1.0]])
    b = jnp.asarray([[0.0], [0.2]])
    c_safety = 2.0

    p_jax, q_jax, _ = onestep_reachability(ssm, p, q, k_ff, k_fb, a, b, c_safety)

    gp = ssm.gp
    ls = np.stack([np.exp(np.asarray(pr["log_lengthscales"])) for pr in gp.params])
    sf2 = np.asarray([float(np.exp(2 * pr["log_sf"])) for pr in gp.params])
    noise = np.exp(2.0 * np.asarray(gp.log_noise))
    p_c, q_c = oracle.onestep_reachability(
        np.asarray(gp.x), np.asarray(gp.mask), np.asarray(gp.beta),
        np.asarray(gp.chol), ls, sf2, noise,
        np.asarray(ssm.l_mu), np.asarray(ssm.l_sigma),
        np.asarray(p), np.asarray(q), np.asarray(k_ff), np.asarray(k_fb),
        np.asarray(a), np.asarray(b), c_safety,
    )
    np.testing.assert_allclose(np.asarray(p_jax), p_c, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(q_jax), q_c, rtol=1e-8, atol=1e-12)
