"""Sparse (inducing-point) GP tests: exactness when Z = X, VFE bound dominance,
data-update consistency, hyperopt progress (BASELINE config 4 groundwork)."""

import jax
import jax.numpy as jnp
import numpy as np

from safe_exploration_tpu.models import gp_init, gp_nll, gp_predict
from safe_exploration_tpu.models.sparse_gp import (
    sparse_gp_elbo,
    sparse_gp_fit,
    sparse_gp_init,
    sparse_gp_predict,
    sparse_gp_update_data,
)


def make_data(rng, n=40, d=3, e=2):
    x = rng.standard_normal((n, d))
    y = np.stack([np.sin(x @ rng.standard_normal(d)) for _ in range(e)], -1)
    y += 0.01 * rng.standard_normal((n, e))
    return jnp.asarray(x), jnp.asarray(y)


def test_collapses_to_exact_gp_when_z_is_x(rng):
    x, y = make_data(rng)
    dense = gp_init(("rbf", "rbf"), x, y, n_max=40, log_noise=-2.0)
    sparse = sparse_gp_init(
        ("rbf", "rbf"), x, y, n_max=40, n_inducing=40, log_noise=-2.0, z=x
    )
    for _ in range(5):
        zq = jnp.asarray(rng.standard_normal(3))
        md, vd = gp_predict(dense, zq)
        ms, vs = sparse_gp_predict(sparse, zq)
        # tolerance reflects the differing jitter placement (dense: on the noise
        # diagonal; sparse: on Kuu) — not a formulation error
        np.testing.assert_allclose(np.asarray(ms), np.asarray(md), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(vs), np.asarray(vd), rtol=1e-3, atol=1e-6)


def test_vfe_bound_dominated_by_exact_nll(rng):
    """-ELBO >= exact NLL (Titsias bound), approaching equality as m -> n."""
    x, y = make_data(rng, n=30)
    dense = gp_init(("rbf", "rbf"), x, y, n_max=30, log_noise=-2.0)
    exact = float(gp_nll(dense.params, dense.log_noise, dense))
    prev_gap = None
    for m in (5, 15, 30):
        sparse = sparse_gp_init(
            ("rbf", "rbf"), x, y, n_max=30, n_inducing=m, log_noise=-2.0,
            z=x[:m],
        )
        bound = float(sparse_gp_elbo(sparse.params, sparse.log_noise, sparse))
        assert bound >= exact - 1e-6, (m, bound, exact)
        gap = bound - exact
        if prev_gap is not None:
            assert gap <= prev_gap + 1e-6  # monotone improvement with more inducing
        prev_gap = gap
    assert abs(prev_gap) < 5e-3  # m = n: tight up to Kuu jitter


def test_update_data_matches_from_scratch(rng):
    x, y = make_data(rng, n=20)
    x2, y2 = make_data(rng, n=8)
    z = x[:10]
    s1 = sparse_gp_init(("rbf", "rbf"), x, y, n_max=40, n_inducing=10, z=z)
    s1 = sparse_gp_update_data(s1, x2, y2)
    s2 = sparse_gp_init(
        ("rbf", "rbf"), jnp.concatenate([x, x2]), jnp.concatenate([y, y2]),
        n_max=40, n_inducing=10, z=z,
    )
    zq = jnp.asarray(rng.standard_normal(3))
    m1, v1 = sparse_gp_predict(s1, zq)
    m2, v2 = sparse_gp_predict(s2, zq)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-7)


def test_fit_decreases_negative_elbo(rng):
    x, y = make_data(rng, n=50)
    sgp = sparse_gp_init(("rbf", "rbf"), x, y, n_max=64, n_inducing=16, log_noise=-1.0)
    before = float(sparse_gp_elbo(sgp.params, sgp.log_noise, sgp))
    sgp2 = jax.jit(lambda s: sparse_gp_fit(s, iters=100))(sgp)
    after = float(sparse_gp_elbo(sgp2.params, sgp2.log_noise, sgp2))
    assert after < before - 1.0


def test_predict_jacobian_through_sparse(rng):
    """jacfwd must flow through the sparse posterior (reachability needs it)."""
    x, y = make_data(rng, n=25)
    sgp = sparse_gp_init(("rbf", "rbf"), x, y, n_max=32, n_inducing=12)
    zq = jnp.asarray(rng.standard_normal(3) * 0.3)
    jac = jax.jacfwd(lambda z: sparse_gp_predict(sgp, z)[0])(zq)
    eps = 1e-6
    for i in range(3):
        dz = jnp.zeros(3).at[i].set(eps)
        fd = (sparse_gp_predict(sgp, zq + dz)[0] - sparse_gp_predict(sgp, zq - dz)[0]) / (2 * eps)
        np.testing.assert_allclose(np.asarray(jac[:, i]), np.asarray(fd), rtol=1e-4, atol=1e-8)


def test_sparse_ssm_plugs_into_reachability_and_cem(rng):
    """BASELINE config 4: the inducing-point GP sits inside the MPC loop via
    the SSM protocol — same reachability engine and planner as the exact GP."""
    import jax

    from safe_exploration_tpu.envs import linearize_discretize, make_pendulum
    from safe_exploration_tpu.models.sparse_gp import make_sparse_gp_ssm
    from safe_exploration_tpu.ops.linalg import dlqr
    from safe_exploration_tpu.reachability.onestep import multistep_reachability
    from safe_exploration_tpu.solvers.cem import CemConfig, cem_plan
    from safe_exploration_tpu.solvers.costs import tracking_cost

    n = 200
    x = jnp.asarray(rng.uniform(-0.3, 0.3, (n, 2)))
    u = jnp.asarray(rng.uniform(-1, 1, (n, 1)))
    y = 1e-3 * jnp.asarray(rng.standard_normal((n, 2)))
    ssm = make_sparse_gp_ssm(
        ("rbf", "rbf"), x, u, y, n_max=256, n_inducing=32,
        l_mu=jnp.full((2,), 0.05), l_sigma=jnp.full((2,), 0.02),
        log_noise=-4.0,
    )
    env = make_pendulum(dtype=jnp.float64)
    spec = env.spec
    a, b = linearize_discretize(env)
    k, _ = dlqr(a, b, jnp.eye(2, dtype=jnp.float64), jnp.eye(1, dtype=jnp.float64))
    k_fb = -k
    k_fb_all = jnp.tile(k_fb[None], (3, 1, 1))
    p_traj, q_traj, _ = multistep_reachability(
        ssm, jnp.asarray([0.05, 0.0], jnp.float64),
        jnp.zeros((3, 1), jnp.float64), k_fb_all, a, b, 2.0,
    )
    assert bool(jnp.all(jnp.isfinite(p_traj)))
    assert bool(jnp.all(jnp.linalg.eigvalsh(q_traj[-1]) >= 0))

    cfg = CemConfig(n_safe=3, n_samples=32, n_elites=8, n_iterations=3)
    k_ff, feasible, viol, _ = jax.jit(
        lambda key, x0: cem_plan(
            key, ssm, x0, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            2.0, tracking_cost(spec.target), cfg,
        )
    )(jax.random.PRNGKey(0), jnp.asarray([0.02, 0.0], jnp.float64))
    assert bool(feasible), float(viol)


def test_optimized_inducing_inputs_tighten_elbo(rng):
    """VERDICT r2 #8: Z must be a trained variational parameter (GPy
    ``SparseGPRegression.optimize`` trains Z). On clustered data whose initial
    even-subsample Z misses a cluster, optimizing Z must strictly tighten the
    bound vs. optimizing hypers alone."""
    # two tight clusters far apart: an even data subsample puts most inducing
    # points in cluster A; moving them is worth real ELBO
    xa = 0.3 * rng.standard_normal((30, 3)) + np.array([3.0, 0.0, 0.0])
    xb = 0.3 * rng.standard_normal((10, 3)) - np.array([3.0, 0.0, 0.0])
    x = jnp.asarray(np.concatenate([xa, xb]))
    y = jnp.asarray(
        np.sin(np.asarray(x) @ rng.standard_normal(3))[:, None]
        + 0.01 * rng.standard_normal((40, 1))
    )
    sgp = sparse_gp_init(("rbf",), x, y, n_max=40, n_inducing=6, log_noise=-2.0)
    fixed = jax.jit(
        lambda s: sparse_gp_fit(s, iters=150, lr=3e-2, opt_z=False)
    )(sgp)
    opt = jax.jit(
        lambda s: sparse_gp_fit(s, iters=150, lr=3e-2, opt_z=True)
    )(sgp)
    elbo_fixed = float(sparse_gp_elbo(fixed.params, fixed.log_noise, fixed))
    elbo_opt = float(sparse_gp_elbo(opt.params, opt.log_noise, opt))
    assert elbo_opt < elbo_fixed - 0.5  # strictly better bound
    # Z actually moved
    assert float(jnp.max(jnp.abs(opt.z - sgp.z))) > 1e-2


def test_sparse_full_cov_diag_matches_predict(rng):
    from safe_exploration_tpu.models.sparse_gp import (
        sparse_gp_predict_full_cov,
    )

    x, y = make_data(rng)
    sgp = sparse_gp_init(("rbf", "rbf"), x, y, n_max=40, n_inducing=12)
    zq = jnp.asarray(rng.standard_normal((6, 3)))
    mean_f, cov_f = sparse_gp_predict_full_cov(sgp, zq)
    for i in range(6):
        m, v = sparse_gp_predict(sgp, zq[i])
        np.testing.assert_allclose(np.asarray(mean_f[i]), np.asarray(m), rtol=1e-9)
        for d in range(2):
            np.testing.assert_allclose(
                float(cov_f[d, i, i]), float(v[d]), rtol=1e-7, atol=1e-12
            )
    for d in range(2):
        assert np.linalg.eigvalsh(np.asarray(cov_f[d]))[0] > -1e-9


def test_f32_refit_stable_at_low_noise_scale():
    """REGRESSION (round 3): the whitened-form refit must survive f32 at
    BASELINE-cfg-4-like conditioning. Forming Sigma = Kuu + Kuf Kuf^T /
    sigma_n^2 directly and factoring it NaN'd every factor for low-noise
    N>=2k pendulum-residual data (cond(Sigma) ~ 1e8+; observed in CPU f32)
    — the first half of this test pins that the scenario really is past
    the naive form's cliff, the second that _factors_from_whitened survives
    it with a usable posterior."""
    import jax.scipy.linalg  # noqa: F401  (solve_triangular used below)

    from safe_exploration_tpu.envs import (
        env_step,
        linearize_discretize,
        make_pendulum,
    )
    from safe_exploration_tpu.models.kernels import gram
    from safe_exploration_tpu.models.sparse_gp import (
        _JITTER,
        make_sparse_gp_ssm,
        sparse_gp_predict,
        sparse_gp_refit,
    )

    def build(dtype, n_data=2048, m=64):
        env = make_pendulum(dtype=dtype)
        a, b = linearize_discretize(env)
        key = jax.random.PRNGKey(0)
        xs = (jax.random.uniform(key, (n_data, 2), dtype, -1.0, 1.0)
              * jnp.asarray([0.3, 1.0], dtype))
        us = jax.random.uniform(jax.random.fold_in(key, 1), (n_data, 1),
                                dtype, -1.0, 1.0)
        _, x_next = jax.vmap(lambda x, u: env_step(env, key, x, u))(xs, us)
        resid = x_next - (xs @ a.T + us @ b.T)
        ssm = make_sparse_gp_ssm(
            ("rbf", "rbf"), xs, us, resid, n_max=n_data, n_inducing=m,
            l_mu=jnp.full((2,), 0.05, dtype),
            l_sigma=jnp.full((2,), 0.02, dtype), log_noise=-4.0,
        )
        params = tuple(
            {**p, "log_sf": jnp.asarray(-3.0, dtype)} for p in ssm.sgp.params
        )
        return sparse_gp_refit(ssm.sgp.replace(params=params))

    sgp32 = build(jnp.float32)

    # (a) the scenario sits past the naive form's breakdown cliff
    m = sgp32.n_inducing
    dtype = jnp.float32
    noise_var = jnp.exp(2.0 * sgp32.log_noise[0])
    kuu = (gram("rbf", sgp32.params[0], sgp32.z, sgp32.z)
           + _JITTER * jnp.eye(m, dtype=dtype))
    kuf = gram("rbf", sgp32.params[0], sgp32.z, sgp32.x) * sgp32.mask[None, :]
    sigma = kuu + (kuf @ kuf.T) / noise_var
    naive = jnp.linalg.cholesky(sigma + _JITTER * jnp.eye(m, dtype=dtype))
    # "breaks" is backend-dependent near the conditioning cliff: most BLAS
    # lowerings return NaN factors, but some return finite garbage instead
    # (tiny/negative trailing pivots, huge reconstruction error). Accept
    # either failure mode so the canary pins the cliff without being flaky
    # across platforms (ADVICE r3).
    naive_nan = bool(jnp.isnan(naive).any())
    naive_bad_pivot = bool(
        (jnp.diagonal(naive) <= jnp.sqrt(_JITTER) * 1e-2).any()
    )
    recon_rel = float(
        jnp.max(jnp.abs(jnp.nan_to_num(naive @ naive.T) - sigma))
        / jnp.max(jnp.abs(sigma))
    )
    naive_bad_recon = recon_rel > 1e-3
    assert naive_nan or naive_bad_pivot or naive_bad_recon, (
        "naive Sigma chol no longer breaks at this size — grow the scenario "
        "so this test keeps pinning the whitened form's reason to exist"
    )

    # (b) every whitened-form factor is finite
    for name in ("luu", "lsig", "alpha", "vmat"):
        assert bool(jnp.isfinite(getattr(sgp32, name)).all()), name

    # (c) usable posterior: positive variance everywhere, bounded by the
    # prior, and mean at data scale. NOTE the loose mean tolerance: at this
    # conditioning (information matrix cond ~1e4-1e5) f32 cannot resolve the
    # ~1e-3-scale posterior mean below ~2e-3 absolute — the whitened form's
    # deliverable is FINITE, conservative factors where the naive form NaN'd,
    # not f64 accuracy. Tighter accuracy at this scale is what the
    # precision="ff" mode / f64-on-CPU path is for (numerics policy,
    # SURVEY.md §7).
    sgp64 = build(jnp.float64)
    key = jax.random.PRNGKey(9)
    zq = jax.random.uniform(key, (16, 3), jnp.float64, -0.5, 0.5)
    for i in range(16):
        mu32, var32 = sparse_gp_predict(sgp32, zq[i].astype(jnp.float32))
        mu64, var64 = sparse_gp_predict(sgp64, zq[i])
        assert bool((var32 > 0).all())
        kzz = float(jnp.exp(2.0 * sgp32.params[0]["log_sf"]))
        assert bool((np.asarray(var32) <= kzz * (1.0 + 1e-3)).all())
        np.testing.assert_allclose(
            np.asarray(mu32, np.float64), np.asarray(mu64), atol=5e-3
        )
