"""The lane-form GP posterior (sqp_lanes._gp_predict_lanes) against the
per-query portable posterior (models/ssm.ssm_predict_jac, vmapped over
queries): mean, variance (incl. the conditioning floor) and mean Jacobian
(incl. the z_scale chain rule), for the exact masked-buffer GP, the
inducing-point sparse GP and the per-lane LaneGPSSM."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.envs import env_step, linearize_discretize, make_pendulum
from safe_exploration_tpu.models import make_gp_ssm
from safe_exploration_tpu.models.gp import gp_refit
from safe_exploration_tpu.models.gp_lanes import lane_stack_ssm
from safe_exploration_tpu.models.sparse_gp import (
    make_sparse_gp_ssm,
    sparse_gp_refit,
)
from safe_exploration_tpu.models.ssm import ssm_predict_jac
from safe_exploration_tpu.solvers.sqp_lanes import _gp_predict_lanes

_Z_SCALE = (0.5, 2.0, 1.0)


def _data(dtype, n_data, seed):
    env = make_pendulum(dtype=dtype)
    a, b = linearize_discretize(env)
    key = jax.random.PRNGKey(seed)
    xs = (jax.random.uniform(key, (n_data, 2), dtype, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0], dtype))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (n_data, 1), dtype,
                            -1.0, 1.0)
    _, x_next = jax.vmap(lambda x, u: env_step(env, key, x, u))(xs, us)
    return xs, us, x_next - (xs @ a.T + us @ b.T)


def _exact_ssm(dtype, n_data=24, n_max=32, z_scale=None):
    xs, us, resid = _data(dtype, n_data, 3)
    ssm = make_gp_ssm(
        ("rbf", "rbf"), xs, us, resid, n_max=n_max,
        l_mu=jnp.full((2,), 0.05, dtype),
        l_sigma=jnp.full((2,), 0.02, dtype), log_noise=-4.0,
        z_scale=None if z_scale is None else jnp.asarray(z_scale, dtype),
    )
    params = tuple(
        {**p, "log_sf": jnp.asarray(-3.0, dtype)} for p in ssm.gp.params
    )
    return ssm.replace(gp=gp_refit(ssm.gp.replace(params=params)))


def _sparse_ssm(dtype):
    xs, us, resid = _data(dtype, 32, 0)
    ssm = make_sparse_gp_ssm(
        ("rbf", "rbf"), xs, us, resid, n_max=48, n_inducing=16,
        l_mu=jnp.full((2,), 0.05, dtype),
        l_sigma=jnp.full((2,), 0.02, dtype), log_noise=-4.0,
        z_scale=jnp.asarray(_Z_SCALE, dtype),
    )
    params = tuple(
        {**p, "log_sf": jnp.asarray(-3.0, dtype)} for p in ssm.sgp.params
    )
    return ssm.replace(sgp=sparse_gp_refit(ssm.sgp.replace(params=params)))


def _queries(dtype, n_lanes):
    return jax.random.uniform(jax.random.PRNGKey(7), (3, n_lanes), dtype,
                              -1.0, 1.0)


def _check(ssm, z, want_jac, rtol=3e-5, atol=3e-6):
    """Lane output vs the vmapped portable posterior at the same queries."""
    out = _gp_predict_lanes(ssm, z, want_jac=want_jac)
    mu, var, jx, ju = jax.vmap(
        lambda q: ssm_predict_jac(ssm, q[:2], q[2:])
    )(z.T)
    ref = [mu.T, var.T]
    if want_jac:
        ref.append(jnp.moveaxis(jnp.concatenate([jx, ju], axis=-1), 0, -1))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(np.asarray(o), np.asarray(r),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("want_jac", [False, True])
@pytest.mark.parametrize("n_lanes", [64, 513])
def test_lane_predict_matches_portable_exact_gp(want_jac, n_lanes):
    dtype = jnp.float32
    _check(_exact_ssm(dtype), _queries(dtype, n_lanes), want_jac)


def test_lane_predict_respects_mask():
    """Inactive padded-buffer rows contribute exactly nothing."""
    dtype = jnp.float32
    ssm = _exact_ssm(dtype, n_data=24, n_max=48)
    gp = gp_refit(ssm.gp.replace(mask=ssm.gp.mask.at[16:].set(0.0)))
    _check(ssm.replace(gp=gp), _queries(dtype, 128), want_jac=True)


@pytest.mark.parametrize("want_jac", [False, True])
def test_lane_predict_matches_portable_sparse_gp(want_jac):
    """Inducing-point tier: Z rows as support, alpha/vmat as weights, z_scale
    chain rule on the Jacobian."""
    dtype = jnp.float32
    _check(_sparse_ssm(dtype), _queries(dtype, 200), want_jac)


def test_lane_predict_z_scale_chain_rule_f64():
    """Normalized-input exact GP in f64: the lane form matches to roundoff."""
    dtype = jnp.float64
    _check(_exact_ssm(dtype, z_scale=_Z_SCALE), _queries(dtype, 96),
           want_jac=True, rtol=1e-10, atol=1e-12)


def test_lane_predict_per_lane_models_match_shared():
    """LaneGPSSM (one posterior per lane, batch-last buffers) stacked from
    one shared model predicts what the shared model predicts."""
    dtype = jnp.float32
    ssm = _exact_ssm(dtype)
    z = _queries(dtype, 16)
    shared = _gp_predict_lanes(ssm, z, want_jac=True)
    per_lane = _gp_predict_lanes(lane_stack_ssm(ssm, 16), z, want_jac=True)
    for s, p in zip(shared, per_lane):
        np.testing.assert_allclose(np.asarray(p), np.asarray(s),
                                   rtol=3e-5, atol=3e-6)
