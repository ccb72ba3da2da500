"""Smoke run of the safe-MPC main path on an NVIDIA GPU.

    python chip_smoke.py                # one GPU: phases (a)-(e)
    python chip_smoke.py --four-cards   # four GPUs: the two multi-device paths

Each phase drives a user entry point at the registered widths and compares
what comes out with a plain reference, printing every comparison beside its
tolerance and the reason for it:

  (a) headline cold solve: pendulum H=5, n_max=128 with 64 points, batch 512,
      the 14x3+6+4 GN-AL budget, through ``build_experiment(...)
      ["batch_planner"]``; reference: the portable planner in f64 on the CPU;
  (b) episodic learning loop: ``run_experiment`` on ``pendulum_episode_sqp``;
  (c) fleet batch runner: ``pendulum_batch_sqp`` (256 lanes) through the
      ``batch`` task;
  (d) serving: ``pendulum_serve`` through the ``serve`` task (the AOT
      ``ServeController`` with its donated state);
  (e) numerics: exact-GP refit and predict-with-Jacobian against numpy f64,
      the N=10,240 / m=256 sparse refit and the float-float refit against f64.

``--four-cards`` runs only the mesh-sharded fleet against the same lanes on
one card, and the one-psum sharded sparse refit against the local refit.

The script refuses to run without a GPU. Its last line is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from safe_exploration_tpu.envs import env_step, linearize_discretize, make_pendulum
from safe_exploration_tpu.models import make_gp_ssm
from safe_exploration_tpu.models.gp import (
    _masked_gram,
    gp_init,
    gp_predict_jac,
    gp_refit,
)
from safe_exploration_tpu.models.kernels import init_kernel_params
from safe_exploration_tpu.models.sparse_gp import sparse_gp_predict, sparse_gp_refit
from safe_exploration_tpu.models.ssm import ssm_bucketed
from safe_exploration_tpu.ops.ff import cholesky_ff, gp_factors_ff
from safe_exploration_tpu.runtime.config import (
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu.runtime.main import run_experiment
from safe_exploration_tpu.utils.compile_cache import enable_compile_cache
from safe_exploration_tpu.utils.device import (
    gpu_name_and_power_limit,
    require_gpu,
)


class CheckFailed(AssertionError):
    """A comparison fell outside its tolerance."""


def check(name: str, value: float, tol: float, reason: str) -> None:
    """Print one comparison; raise when ``value`` is not finite or above
    ``tol``."""
    ok = bool(np.isfinite(value)) and value <= tol
    print(f"  check {name}: {value:.3e} <= {tol:.1e} "
          f"[{'ok' if ok else 'FAIL'}] ({reason})", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value!r} > {tol!r}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300))


@contextlib.contextmanager
def cpu_f64():
    """Trace, compile and run on the host CPU in float64 (the references)."""
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        yield


def pendulum_transitions(n: int, seed: int):
    """``n`` pendulum transitions (x, u, residual) in f64, drawn on the host:
    the same inputs feed the device run and its f64 reference."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1.0, 1.0, (n, 2)) * np.array([0.3, 1.0])
    us = rng.uniform(-1.0, 1.0, (n, 1))
    with cpu_f64():
        env = make_pendulum(dtype=jnp.float64)
        a, b = linearize_discretize(env)
        key = jax.random.PRNGKey(seed)
        _, x_next = jax.vmap(lambda x, u: env_step(env, key, x, u))(
            jnp.asarray(xs), jnp.asarray(us)
        )
        resid = np.asarray(x_next) - (xs @ np.asarray(a).T + us @ np.asarray(b).T)
    return xs, us, resid


# ---------------------------------------------------------------- (a) headline


def _headline_ssm(exp, xs, us, resid, n_max, dtype):
    """The bench's headline model: RBF GP on the transitions with the signal
    std calibrated to the ~1e-3-scale residuals, bucketed as the episodic
    runner hands it to the planner."""
    ssm = make_gp_ssm(
        exp["kern_types"], jnp.asarray(xs, dtype), jnp.asarray(us, dtype),
        jnp.asarray(resid, dtype), n_max=n_max,
        l_mu=jnp.full((2,), 0.05, dtype), l_sigma=jnp.full((2,), 0.02, dtype),
        log_noise=-4.0,
    )
    params = tuple(
        {**p, "log_sf": jnp.asarray(-3.0, dtype)} for p in ssm.gp.params
    )
    return ssm_bucketed(ssm.replace(gp=gp_refit(ssm.gp.replace(params=params))))


def phase_headline(batch=512, n_max=128, n_data=64, n_safe=5, n_ref=32,
                   budget=(14, 3, 6, 4)):
    outer, inner, polish, rescue = budget
    cfg = ExperimentConfig(
        name="smoke_headline", solver="sqp", n_safe=n_safe, n_max=n_max,
        sqp_outer=outer, sqp_inner=inner, sqp_polish=polish,
        sqp_rescue=rescue,
    )
    xs, us, resid = pendulum_transitions(n_data, seed=0)
    x0s = (np.random.default_rng(1).uniform(-1.0, 1.0, (batch, 2))
           * np.array([0.15, 0.4]))

    dtype = jnp.float32
    exp = build_experiment(cfg, dtype=dtype)
    ssm = _headline_ssm(exp, xs, us, resid, n_max, dtype)
    solve = jax.jit(lambda s, x, w: exp["batch_planner"](s, x, w)[:3])
    k_ff, feas, viol = jax.block_until_ready(solve(
        ssm, jnp.asarray(x0s, dtype), jnp.zeros((batch, n_safe, 1), dtype)
    ))
    k_ff, feas, viol = (np.asarray(v) for v in (k_ff, feas, viol))
    assert k_ff.shape == (batch, n_safe, 1), k_ff.shape
    check("headline/nonfinite_controls", float(np.sum(~np.isfinite(k_ff))),
          0, "every lane returns a finite plan, feasible or not")
    print(f"  headline feasible fraction {feas.mean():.4f} over {batch} lanes")

    with cpu_f64():
        exp64 = build_experiment(cfg, dtype=jnp.float64)
        ssm64 = _headline_ssm(exp64, xs, us, resid, n_max, jnp.float64)
        ref = jax.jit(jax.vmap(
            lambda s, x, w: exp64["planner"](jax.random.PRNGKey(0), s, x, w)[:3],
            in_axes=(None, 0, 0),
        ))
        k_ref, feas_ref, viol_ref = (np.asarray(v) for v in ref(
            ssm64, jnp.asarray(x0s[:n_ref]), jnp.zeros((n_ref, n_safe, 1))
        ))
    flips = int(np.sum(feas[:n_ref] != feas_ref))
    print(f"  reference feasible {int(feas_ref.sum())}/{n_ref}, "
          f"device feasible {int(feas[:n_ref].sum())}/{n_ref}")
    check("headline/feasibility_flips_vs_f64", flips, 2,
          "f32 lane solve vs f64 portable solve: a tube whose violation sits "
          "at the 1e-4 feasibility tolerance may land on either side")
    both = feas[:n_ref] & feas_ref
    u_range = float(np.max(np.asarray(exp["env"].spec.u_max)
                           - np.asarray(exp["env"].spec.u_min)))
    check("headline/control_drift_vs_f64",
          float(np.max(np.abs(k_ff[:n_ref][both] - k_ref[both]), initial=0.0))
          / u_range, 0.1,
          "fraction of the control range: the fixed-budget solve stops "
          "before convergence, and f32 vs f64 iterates part by a few "
          "percent (up to 5.5e-2 seen on an H100 80GB HBM3 at 400 W); a "
          "wrong solve parts by O(1)")


# ------------------------------------------------------ (b)-(d) user entries


def _run_config(name: str, **overrides) -> dict:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return run_experiment(cfg)


def phase_episodic(n_ep=2, **overrides):
    series = _run_config("pendulum_episode_sqp", n_ep=n_ep, **overrides)["series"]
    print(f"  episodic feasibility per episode {series['feasibility_rate']}")
    check("episodic/violations", float(sum(series["violations"])), 0,
          "the safety guarantee: no state-constraint violation")


def phase_fleet(**overrides):
    series = _run_config("pendulum_batch_sqp", n_ep=1, **overrides)["series"]
    print(f"  fleet lanes {series['lanes'][0]}, feasibility "
          f"{series['feasibility_rate'][0]:.4f}, lane runner "
          f"{bool(series['lane_backend'][0])}")
    check("fleet/lane_runner_off", float(1 - series["lane_backend"][0]), 0,
          "pendulum_batch_sqp pins the lane-major episode runner")
    check("fleet/violations", float(series["violations"][0]), 0,
          "the safety guarantee over every lane and step")


def phase_serve(n_steps=6, **overrides):
    series = _run_config("pendulum_serve", n_steps=n_steps,
                         **overrides)["series"]
    print(f"  serve feasibility {series['feasibility_rate'][0]:.3f}, "
          f"recompiles {series['recompiles'][0]}, host-clock step latency "
          f"p50 {series['latency_p50_ms'][0]} ms")
    check("serve/violations", float(series["violations"][0]), 0,
          "the safety guarantee over every served step")


# -------------------------------------------------------------- (e) numerics


def _np_rbf(a, b, ls, sf2):
    d2 = np.sum(((a[:, None, :] - b[None, :, :]) / ls) ** 2, axis=-1)
    return sf2 * np.exp(-0.5 * d2)


def numerics_exact_gp(n=256, n_query=16):
    """f32 refit + gp_predict_jac on the device against a numpy f64 GP."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 3))
    y = rng.standard_normal((n, 2))
    zq = 0.5 * rng.standard_normal((n_query, 3))
    dtype = jnp.float32
    gp = jax.jit(lambda xx, yy: gp_init(("rbf", "rbf"), xx, yy, n_max=n))(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    )
    mu, var, jac, _ = (np.asarray(v) for v in jax.jit(jax.vmap(
        lambda z: gp_predict_jac(gp, z), in_axes=0))(jnp.asarray(zq, dtype)))

    p = init_kernel_params("rbf", 3, dtype)
    ls = np.exp(np.asarray(p["log_lengthscales"], np.float64))
    sf2 = float(np.exp(2.0 * np.asarray(p["log_sf"], np.float64)))
    noise = float(np.exp(2.0 * np.asarray(gp.log_noise[0], np.float64)))
    kxx = _np_rbf(x, x, ls, sf2) + (noise + 1e-6) * np.eye(n)
    kqx = _np_rbf(zq, x, ls, sf2)
    beta = np.linalg.solve(kxx, y)                       # (n, e)
    mu_ref = kqx @ beta                                  # (q, e)
    var_ref = sf2 - np.sum(kqx * np.linalg.solve(kxx, kqx.T).T, axis=1)
    # d/dz k(z, x_i) = -k(z, x_i) (z - x_i) / ls^2
    diff = (zq[:, None, :] - x[None, :, :]) / ls**2       # (q, n, d)
    jac_ref = -np.einsum("qn,qnd,ne->qed", kqx, diff, beta)
    cond = float(np.linalg.cond(kxx))
    tol = 5.0 * np.finfo(np.float32).eps * cond
    reason = (f"f32 refit of a Gram with condition {cond:.1e}: 5 eps_f32 x "
              "cond; TF32 products round 8192x coarser and would exceed it")
    check("numerics/exact_gp_mean_vs_f64", rel_err(mu, mu_ref), tol, reason)
    check("numerics/exact_gp_var_vs_f64",
          float(np.max(np.abs(var - var_ref[:, None]))) / sf2, tol, reason)
    check("numerics/exact_gp_jac_vs_f64", rel_err(jac, jac_ref), tol, reason)


def numerics_sparse_refit(n=10240, m=256, n_query=64):
    """pendulum_large_sparse's model at N=n, m=m with the signal std
    calibrated to the residuals (as the headline model is): f32 device refit
    against the same construction in f64. Errors are measured against the
    predictive std / variance (latent + noise), which set the tube widths."""
    cfg = dataclasses.replace(CONFIGS["pendulum_large_sparse"], n_max=n,
                              n_inducing=m)
    xs, us, resid = pendulum_transitions(n, seed=3)
    zq = (np.random.default_rng(4).uniform(-1.0, 1.0, (n_query, 3))
          * np.array([0.3, 1.0, 1.0]))

    def predict(dtype):
        exp = build_experiment(cfg, dtype=dtype)
        ssm = exp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(xs, dtype),
                              jnp.asarray(us, dtype), jnp.asarray(resid, dtype))
        params = tuple({**p, "log_sf": jnp.asarray(-3.0, dtype)}
                       for p in ssm.sgp.params)
        sgp = jax.jit(sparse_gp_refit)(ssm.sgp.replace(params=params))
        z = jnp.asarray(zq, dtype) / ssm.z_scale
        mu, var = jax.jit(jax.vmap(lambda q: sparse_gp_predict(sgp, q)))(z)
        noise = jnp.exp(2.0 * sgp.log_noise)
        return (np.asarray(v, np.float64) for v in (mu, var, noise))

    mu, var, _ = predict(jnp.float32)
    with cpu_f64():
        mu_ref, var_ref, noise = predict(jnp.float64)
    pred_var = var_ref + noise
    check("numerics/sparse_mean_vs_f64_in_std",
          float(np.max(np.abs(mu - mu_ref) / np.sqrt(pred_var))), 1e-3,
          "f32 whitened VFE factors over 10,240 rows; 1e-3 of the "
          "predictive std")
    check("numerics/sparse_var_vs_f64_in_pred_var",
          float(np.max(np.abs(var - var_ref) / pred_var)), 5e-2,
          "the latent variance kzz - qzz cancels two terms near sf^2 in "
          "f32; 5e-2 of the predictive variance moves a tube width <= 2.5%")


def numerics_ff(n_chol=256, n_refit=128):
    """Float-float Cholesky and refit: the error-free transformations must
    survive the device compiler (no FMA contraction, no reassociation)."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((n_chol, n_chol))
    a32 = (m @ m.T + n_chol * np.eye(n_chol)).astype(np.float32)
    l64 = np.linalg.cholesky(a32.astype(np.float64))
    lff = jax.jit(cholesky_ff)(jnp.asarray(a32))
    l_ff = np.asarray(lff.hi, np.float64) + np.asarray(lff.lo, np.float64)
    l_32 = np.asarray(jax.jit(jnp.linalg.cholesky)(jnp.asarray(a32)))
    print(f"  plain f32 Cholesky error {rel_err(l_32, l64):.3e} (for contrast)")
    check("numerics/ff_cholesky_vs_f64", rel_err(l_ff, l64), 1e-11,
          "double-word factor carries ~2^-45 relative; a contracted or "
          "reassociated two_prod/two_sum falls back to ~1e-7")

    x = rng.standard_normal((n_refit, 3)).astype(np.float32)
    y = rng.standard_normal((n_refit, 2)).astype(np.float32)

    def refit(precision):
        return jax.jit(lambda xx, yy: gp_init(
            ("rbf", "rbf"), xx, yy, n_max=n_refit, precision=precision))(x, y)

    gp_ff, gp_32 = refit("ff"), refit("f32")
    # float-float makes the factorization exact for the f32 Gram it is
    # given, and another program may round the Gram differently: so factor
    # one device Gram with the ff refit's own routine and solve the same
    # matrix in f64
    noise_var = jnp.exp(2.0 * gp_ff.log_noise[0])
    k32 = jax.jit(_masked_gram, static_argnums=0)(
        "rbf", gp_ff.params[0], gp_ff.x, gp_ff.mask, noise_var)
    _, beta_ff, _ = jax.jit(gp_factors_ff)(k32, jnp.asarray(y[:, 0]))
    beta_ref = np.linalg.solve(np.asarray(k32, np.float64),
                               y[:, 0].astype(np.float64))
    print(f"  plain f32 refit beta error {rel_err(gp_32.beta[0], beta_ref):.3e}"
          f", precision='ff' refit {rel_err(gp_ff.beta[0], beta_ref):.3e} "
          "(for contrast; both include the Gram's own rounding)")
    check("numerics/ff_factors_beta_vs_f64", rel_err(beta_ff, beta_ref),
          1e-5, "ff factors are f64-class and rounded to f32 once at "
          "storage: a few eps_f32, where a plain f32 solve pays eps_f32 x "
          "cond")


def phase_numerics(n_exact=256, n_sparse=10240, m_sparse=256, n_ff=256,
                   n_ff_refit=128):
    numerics_exact_gp(n_exact)
    numerics_sparse_refit(n_sparse, m_sparse)
    numerics_ff(n_ff, n_ff_refit)


# ----------------------------------------------------------- four cards


def phase_sharded_fleet(n_dev=4, **overrides):
    """pendulum_batch_sqp's lanes sharded over ``n_dev`` cards against the
    same lanes on one card (runtime/batch.run_batched_episodes_lanes, the
    runner the batch task uses)."""
    from safe_exploration_tpu.models.gp_lanes import (
        lane_shrink_to_bucket,
        lane_stack_ssm,
    )
    from safe_exploration_tpu.models.ssm import calibrate_lipschitz, ssm_fit
    from safe_exploration_tpu.parallel import make_mesh
    from safe_exploration_tpu.runtime.batch import run_batched_episodes_lanes
    from safe_exploration_tpu.runtime.episode import collect_initial_data

    cfg = dataclasses.replace(CONFIGS["pendulum_batch_sqp"], n_ep=1,
                              **overrides)
    dtype = jnp.float32
    exp = build_experiment(cfg, dtype=dtype)
    env, spec = exp["env"], exp["env"].spec
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    xs, us, resid = collect_initial_data(env, k1, cfg.n_init_samples,
                                         exp["a"], exp["b"], exp["k_fb"])
    ssm = jax.jit(lambda s: calibrate_lipschitz(
        ssm_fit(s, iters=cfg.hyp_iters), spec))(exp["make_ssm"](k2, xs, us, resid))
    lanes = cfg.batch_lanes
    lssm = lane_shrink_to_bucket(lane_stack_ssm(ssm, lanes), n_free=cfg.n_steps)
    x0s = spec.init_m + spec.init_std * jax.random.normal(
        k3, (lanes, spec.n_s), dtype)
    keys = jax.random.split(k4, lanes)

    def run(mesh):
        traj, _ = run_batched_episodes_lanes(
            env, exp["get_action_batch"], exp["init_state_batch"], lssm, x0s,
            keys, cfg.n_steps, exp["a"], exp["b"], mesh=mesh)
        return jax.block_until_ready(traj)

    mesh = make_mesh(n_dev)
    sharded = run(mesh)
    local = run(None)
    x_sh = sharded["x"]
    devices = {s.device for s in x_sh.addressable_shards}
    rows = sorted({s.data.shape[0] for s in x_sh.addressable_shards})
    print(f"  fleet trajectory on {len(devices)} devices, rows per shard {rows}")
    check("four/fleet_devices_unused", float(n_dev - len(devices)), 0,
          "make_mesh must spread the lanes over every card")
    check("four/fleet_uneven_shards", float(rows != [lanes // n_dev]), 0,
          "each card holds lanes / n_dev episode lanes")
    for name, traj in (("sharded", sharded), ("one_card", local)):
        check(f"four/fleet_violations_{name}",
              float(np.sum(~np.asarray(traj["constraint_ok"]))), 0,
              "the safety guarantee over every lane and step")
    # The lanes are independent and the sharded program does the same math
    # (bit-identical on a virtual CPU mesh), but on the GPU the per-card lane
    # width changes which kernels XLA picks, so results differ in the last
    # bits. A lane whose plan then lands on the other side of the
    # feasibility tolerance takes the fallback chain and follows another,
    # equally valid trajectory. Step 0 has identical inputs on both sides;
    # over the episode only fleet-level rates can be compared.
    feas_sh, feas_lo = (np.asarray(t["feasible"]) for t in (sharded, local))
    u_sh, u_lo = (np.asarray(t["u"]) for t in (sharded, local))
    parted = np.any(feas_sh != feas_lo, axis=1)
    print(f"  lanes whose decisions part at some step: {parted.mean():.4f}; "
          f"fleet feasibility sharded {feas_sh.mean():.4f}, one card "
          f"{feas_lo.mean():.4f}")
    check("four/fleet_step0_flips", float(np.mean(feas_sh[:, 0] != feas_lo[:, 0])),
          0.02, "step 0 has the same state and model on both sides: only a "
          "plan sitting at the feasibility tolerance may flip")
    both = feas_sh[:, 0] & feas_lo[:, 0]
    u_range = float(np.max(np.asarray(spec.u_max) - np.asarray(spec.u_min)))
    check("four/fleet_step0_control_drift",
          float(np.max(np.abs(u_sh[both, 0] - u_lo[both, 0]), initial=0.0))
          / u_range, 0.1,
          "fraction of the control range, as in phase (a): a wrong solve "
          "parts by O(1)")
    check("four/fleet_feasibility_rate_gap",
          float(abs(feas_sh.mean() - feas_lo.mean())), 0.03,
          "parted lanes follow other valid trajectories; the fleet's rate "
          "must agree (~5 standard errors of the gap over 5,120 decisions)")


def phase_sharded_sparse_refit(n_dev=4, n=10240, m=256):
    """The one-psum data-sharded sparse refit against the local refit, at
    pendulum_large_sparse's N and m."""
    from safe_exploration_tpu.models.sparse_gp import sparse_gp_init
    from safe_exploration_tpu.parallel import (
        make_mesh,
        shard_sparse_gp,
        sparse_gp_refit_sharded,
    )

    xs, us, resid = pendulum_transitions(n, seed=6)
    z = np.concatenate([xs, us], axis=1).astype(np.float32)
    sgp = sparse_gp_init(("rbf", "rbf"), jnp.asarray(z),
                         jnp.asarray(resid, jnp.float32), n_max=n,
                         n_inducing=m,
                         log_noise=CONFIGS["pendulum_large_sparse"].log_noise)
    # signal std calibrated to the ~1e-3-scale residuals, as in phase (e)
    sgp = sgp.replace(params=tuple(
        {**p, "log_sf": jnp.asarray(-3.0, jnp.float32)} for p in sgp.params))
    mesh = make_mesh(n_dev, axis="data")
    placed = shard_sparse_gp(sgp, mesh)
    devices = {s.device for s in placed.x.addressable_shards}
    print(f"  training rows on {len(devices)} devices")
    check("four/sparse_devices_unused", float(n_dev - len(devices)), 0,
          "make_mesh must spread the data rows over every card")
    sharded = jax.block_until_ready(sparse_gp_refit_sharded(placed, mesh))
    local = jax.jit(sparse_gp_refit)(sgp)
    check("four/sparse_alpha_vs_local", rel_err(sharded.alpha, local.alpha),
          5e-3, "f32 with another reduction order (per-card partials + one "
          "psum against one contraction)")
    zq = jnp.asarray(z[:: max(1, n // 64)][:64])
    predict = jax.jit(jax.vmap(sparse_gp_predict, in_axes=(None, 0)))
    mu_sh, var_sh = (np.asarray(v, np.float64) for v in predict(sharded, zq))
    mu_lo, var_lo = (np.asarray(v, np.float64) for v in predict(local, zq))
    pred_var = var_lo + np.exp(2.0 * np.asarray(local.log_noise, np.float64))
    check("four/sparse_mean_vs_local_in_std",
          float(np.max(np.abs(mu_sh - mu_lo) / np.sqrt(pred_var))), 1e-3,
          "reduction order only; 1e-3 of the predictive std")
    check("four/sparse_var_vs_local_in_pred_var",
          float(np.max(np.abs(var_sh - var_lo) / pred_var)), 5e-2,
          "the f32 latent variance cancels two terms near sf^2 (see the "
          "single-card numerics phase); 5e-2 of the predictive variance")


# -------------------------------------------------------------------- main


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0

    def __call__(self, event: str, duration: float, **kwargs) -> None:
        if event in self.EVENTS:
            self.total += duration


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their references")
    args = ap.parse_args(argv)

    device = require_gpu()
    n_cards = 4 if args.four_cards else 1
    if device["count"] < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {device['count']}")
    print(gpu_name_and_power_limit(), flush=True)  # name, power limit
    print(f"device_kind: {device['kind']} x {device['count']}")
    print(f"jax {jax.__version__}, compile cache {enable_compile_cache()}")

    if args.four_cards:
        phases = [("four-card fleet", phase_sharded_fleet),
                  ("four-card sparse refit", phase_sharded_sparse_refit)]
    else:
        phases = [("a headline", phase_headline),
                  ("b episodic", phase_episodic),
                  ("c fleet", phase_fleet),
                  ("d serve", phase_serve),
                  ("e numerics", phase_numerics)]

    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    failed = []
    for name, phase in phases:
        print(f"== phase {name}", flush=True)
        c0, t0 = clock.total, time.perf_counter()
        try:
            phase()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"  phase {name}: set-up (trace + compile) "
              f"{clock.total - c0:.1f} s of {time.perf_counter() - t0:.1f} s "
              f"wall [{'FAIL' if name in failed else 'ok'}]", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
