"""The lane CEM scorer chain (sqp_lanes._rollout_y_lanes + _dist_lanes +
_cost_lanes, as solvers/cem_lanes composes it) against the portable per-sample
scorer (reachability.multistep_reachability + cem.tube_violation + the cost
function), sample by sample at an odd lane width."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.envs import env_step, linearize_discretize, make_pendulum
from safe_exploration_tpu.models import make_gp_ssm
from safe_exploration_tpu.models.gp import gp_refit
from safe_exploration_tpu.ops.linalg import dlqr
from safe_exploration_tpu.reachability.onestep import multistep_reachability
from safe_exploration_tpu.solvers.cem import tube_violation
from safe_exploration_tpu.solvers.cem_lanes import _TubeCfg
from safe_exploration_tpu.solvers.costs import (
    exploration_cost,
    risk_tracking_cost,
    tracking_cost,
)
from safe_exploration_tpu.solvers.sqp_lanes import (
    _cost_lanes,
    _dist_lanes,
    _rollout_y_lanes,
    _wants_sigma,
)


def _setup(dtype, z_scale):
    env = make_pendulum(dtype=dtype)
    a, b = linearize_discretize(env)
    k_lqr, _ = dlqr(a, b, jnp.eye(2, dtype=dtype), jnp.eye(1, dtype=dtype))
    key = jax.random.PRNGKey(0)
    xs = (jax.random.uniform(key, (24, 2), dtype, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0], dtype))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (24, 1), dtype,
                            -1.0, 1.0)
    _, x_next = jax.vmap(lambda x, u: env_step(env, key, x, u))(xs, us)
    resid = x_next - (xs @ a.T + us @ b.T)
    ssm = make_gp_ssm(
        ("rbf", "rbf"), xs, us, resid, n_max=32,
        l_mu=jnp.full((2,), 0.05, dtype), l_sigma=jnp.full((2,), 0.02, dtype),
        log_noise=-4.0,
        z_scale=jnp.asarray([0.5, 2.0, 1.0], dtype) if z_scale else None,
    )
    params = tuple(
        {**p, "log_sf": jnp.asarray(-3.0, dtype)} for p in ssm.gp.params
    )
    ssm = ssm.replace(gp=gp_refit(ssm.gp.replace(params=params)))
    return env, ssm, -k_lqr, a, b


def _costs(target):
    return {
        "tracking": (tracking_cost(target), {"target": target}),
        "exploration": (exploration_cost(), {}),
        "risk_tracking": (risk_tracking_cost(target, w_sigma=3.0),
                          {"target": target, "w_sigma": 3.0}),
    }


@pytest.mark.parametrize("cost_kind,z_scale,dtype", [
    ("tracking", True, jnp.float32),
    ("tracking", False, jnp.float32),
    ("exploration", True, jnp.float32),
    ("exploration", False, jnp.float32),
    ("risk_tracking", True, jnp.float64),
])
def test_lane_score_matches_portable_scorer(cost_kind, z_scale, dtype):
    env, ssm, k_fb, a, b = _setup(dtype, z_scale)
    spec = env.spec
    t_len, n_u, n_s, c_safety = 4, 1, 2, 2.0
    width = 37
    key = jax.random.PRNGKey(5)
    u_flat = 0.4 * jax.random.normal(key, (t_len * n_u, width), dtype)
    x0_cols = (jax.random.uniform(jax.random.fold_in(key, 1), (n_s, width),
                                  dtype, -1.0, 1.0)
               * jnp.asarray([0.15, 0.4], dtype)[:, None])
    cost_fn, cost_args = _costs(spec.target)[cost_kind]

    s_lift = jnp.concatenate([jnp.eye(n_s, dtype=dtype), k_fb], axis=0)
    y = _rollout_y_lanes(
        ssm, u_flat, [x0_cols[i] for i in range(n_s)], k_fb, a, b,
        _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=0),
        s_lift.T @ s_lift, 0, n_u, want_sigma=_wants_sigma(cost_kind, 0),
    )
    g = _dist_lanes(y, t_len, n_s, spec.h_mat_obs, spec.h_obs,
                    spec.h_mat_safe, spec.h_safe)
    viol = jnp.sum(jnp.maximum(g, 0.0), axis=0)
    cost = _cost_lanes(cost_kind, cost_args, y, u_flat, t_len, n_s, n_u)

    k_fb_all = jnp.tile(k_fb[None], (t_len, 1, 1))

    def score_one(x0, k_ff):
        p, q, var = multistep_reachability(ssm, x0, k_ff, k_fb_all, a, b,
                                           c_safety)
        v = tube_violation(p, q, spec.h_mat_obs, spec.h_obs,
                           spec.h_mat_safe, spec.h_safe)
        return cost_fn(p, q, var, k_ff), v

    cost_ref, viol_ref = jax.vmap(score_one)(
        x0_cols.T, u_flat.T.reshape(width, t_len, n_u)
    )
    assert cost.shape == (width,) and viol.shape == (width,)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == jnp.float32 else dict(
        rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(cost), np.asarray(cost_ref), **tol)
    np.testing.assert_allclose(np.asarray(viol), np.asarray(viol_ref), **tol)
