"""Host-clock times of the GP linear algebra as XLA compiles it, on one GPU.

    python tools/xla_op_times.py

Times the plain JAX versions of the Gram build, Cholesky, triangular solve,
lane-form GP posterior and lane CEM scoring pass at the shapes the removed
hand-written kernels were benchmarked at. A future GPU kernel for one of
these ops has to beat the number printed here on the same card.

Each op is jitted, warmed up, then called ``reps`` times back to back with one
``block_until_ready`` at the end; that is repeated ``rounds`` times and the
median and minimum per-call times are reported in microseconds. Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from safe_exploration_tpu.utils.device import (  # noqa: E402
    gpu_name_and_power_limit,
    require_gpu,
)


def time_us(fn, *args, reps: int = 50, rounds: int = 7) -> dict:
    """Median and minimum per-call microseconds of ``fn(*args)``."""
    jax.block_until_ready(fn(*args))
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    return {"median_us": round(statistics.median(per_call), 2),
            "min_us": round(min(per_call), 2)}


def _spd(n: int) -> jax.Array:
    m = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    return m @ m.T + n * jnp.eye(n, dtype=jnp.float32)


def gram_rows(sizes=(512, 2048), d: int = 3) -> dict:
    from safe_exploration_tpu.models.gp import _masked_gram

    params = {"log_lengthscales": jnp.zeros((d,), jnp.float32),
              "log_sf": jnp.zeros((), jnp.float32)}
    noise = jnp.asarray(0.01, jnp.float32)
    f = jax.jit(lambda x, mask: _masked_gram("rbf", params, x, mask, noise))
    out = {}
    for n in sizes:
        x = jax.random.normal(jax.random.PRNGKey(1), (n, d), jnp.float32)
        out[f"gram_n{n}"] = time_us(f, x, jnp.ones((n,), jnp.float32))
    return out


def cholesky_rows(sizes=(512, 2048, 4096)) -> dict:
    f = jax.jit(jnp.linalg.cholesky)
    return {f"cholesky_n{n}": time_us(f, _spd(n), reps=10 if n > 2048 else 50)
            for n in sizes}


def trsm_rows(sizes=(512, 2048)) -> dict:
    f = jax.jit(lambda l, b: jax.scipy.linalg.solve_triangular(l, b, lower=True))
    out = {}
    for n in sizes:
        l = jnp.linalg.cholesky(_spd(n))
        out[f"trsm_n{n}_rhs{n}"] = time_us(f, l, jnp.eye(n, dtype=jnp.float32))
    return out


def _lane_model(n_data: int, n_max: int = 128):
    """The headline GP (pendulum residuals, calibrated signal std), bucketed."""
    from safe_exploration_tpu.envs import env_step, linearize_discretize, make_pendulum
    from safe_exploration_tpu.models import make_gp_ssm
    from safe_exploration_tpu.models.gp import gp_refit
    from safe_exploration_tpu.models.ssm import ssm_bucketed

    dtype = jnp.float32
    env = make_pendulum(dtype=dtype)
    a, b = linearize_discretize(env)
    key = jax.random.PRNGKey(0)
    xs = (jax.random.uniform(key, (n_data, 2), dtype, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0], dtype))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (n_data, 1), dtype,
                            -1.0, 1.0)
    _, x_next = jax.vmap(lambda x, u: env_step(env, key, x, u))(xs, us)
    resid = x_next - (xs @ a.T + us @ b.T)
    ssm = make_gp_ssm(("rbf", "rbf"), xs, us, resid, n_max=n_max,
                      l_mu=jnp.full((2,), 0.05, dtype),
                      l_sigma=jnp.full((2,), 0.02, dtype), log_noise=-4.0)
    params = tuple({**p, "log_sf": jnp.asarray(-3.0, dtype)}
                   for p in ssm.gp.params)
    ssm = ssm.replace(gp=gp_refit(ssm.gp.replace(params=params)))
    return ssm_bucketed(ssm), env, a, b


def lane_gp_predict_row(n_data: int = 64, n_lanes: int = 16384) -> dict:
    from safe_exploration_tpu.solvers.sqp_lanes import _gp_predict_lanes

    ssm, *_ = _lane_model(n_data)
    z = jax.random.uniform(jax.random.PRNGKey(5), (3, n_lanes), jnp.float32,
                           -1.0, 1.0)
    f = jax.jit(lambda s, q: _gp_predict_lanes(s, q, want_jac=True))
    return {f"lane_gp_predict_n{n_data}_l{n_lanes}": time_us(f, ssm, z)}


def lane_cem_score_row(n_data: int = 48, m_samples: int = 64,
                       batch: int = 256, t_len: int = 5) -> dict:
    """One scoring pass of the lane CEM over M*B lanes: tube rollout,
    constraint margins and tracking cost."""
    from safe_exploration_tpu.ops.linalg import dlqr
    from safe_exploration_tpu.solvers.cem_lanes import _TubeCfg
    from safe_exploration_tpu.solvers.sqp_lanes import (
        _cost_lanes,
        _dist_lanes,
        _rollout_y_lanes,
    )

    dtype = jnp.float32
    ssm, env, a, b = _lane_model(n_data)
    spec = env.spec
    k_lqr, _ = dlqr(a, b, jnp.eye(2, dtype=dtype), jnp.eye(1, dtype=dtype))
    k_fb = -k_lqr
    s_lift = jnp.concatenate([jnp.eye(2, dtype=dtype), k_fb], axis=0)
    bmat = s_lift.T @ s_lift
    lanes = m_samples * batch
    key = jax.random.PRNGKey(9)
    x0 = (jax.random.uniform(key, (2, lanes), dtype, -1.0, 1.0)
          * jnp.asarray([0.15, 0.4], dtype)[:, None])
    u = 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (t_len, lanes), dtype)
    cfg = _TubeCfg(n_safe=t_len, c_safety=2.0, n_perf=0)
    cost_args = {"target": spec.target}

    def score(s, u_flat, x0_cols):
        y = _rollout_y_lanes(s, u_flat, [x0_cols[0], x0_cols[1]], k_fb, a, b,
                             cfg, bmat, 0, 1)
        g = _dist_lanes(y, t_len, 2, spec.h_mat_obs, spec.h_obs,
                        spec.h_mat_safe, spec.h_safe)
        viol = jnp.sum(jnp.maximum(g, 0.0), axis=0)
        return _cost_lanes("tracking", cost_args, y, u_flat, t_len, 2, 1) \
            + 1e3 * viol

    return {f"lane_cem_score_l{lanes}": time_us(jax.jit(score), ssm, u, x0)}


def main() -> int:
    device = require_gpu()
    device["nvidia_smi"] = gpu_name_and_power_limit()
    print(f"nvidia-smi: {device['nvidia_smi']}", flush=True)
    rows = {}
    for fn in (gram_rows, cholesky_rows, trsm_rows, lane_gp_predict_row,
               lane_cem_score_row):
        rows.update(fn())
        print(f"{fn.__name__}: done", file=sys.stderr, flush=True)
    print(json.dumps({"device": device, "jax": jax.__version__,
                      "matmul_precision":
                      str(jax.config.jax_default_matmul_precision),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
