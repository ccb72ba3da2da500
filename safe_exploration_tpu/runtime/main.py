"""Experiment CLI — entry point of the framework.

Parity: reference ``main.py`` (SURVEY.md §2.8): a CLI that selects a named
scenario config + task type and dispatches to the matching runner, recording
config/metrics/artifacts to an output directory. The reference uses sacred
(``python -m safe_exploration.main with <config>``); here it is a plain argparse
CLI with the dataclass config registry:

    python -m safe_exploration_tpu.runtime.main --config pendulum_episode \
        [--platform cpu] [--out results/] [--set n_ep=3 n_steps=20]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

__all__ = ["main", "run_experiment"]


def _apply_overrides(cfg, overrides: list[str]):
    """`--set key=value ...` overrides on the frozen dataclass config."""
    if not overrides:
        return cfg
    updates = {}
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    for item in overrides:
        k, _, v = item.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown config field: {k}")
        ftype = type(getattr(cfg, k))
        if ftype is bool:
            updates[k] = v.lower() in ("1", "true", "yes")
        elif ftype is tuple:
            updates[k] = tuple(v.split(","))
        else:
            updates[k] = ftype(v)
    return dataclasses.replace(cfg, **updates)


def run_experiment(cfg, *, out_dir: str | None = None, dtype=None,
                   resume: bool = False) -> dict:
    """Build and run one experiment (importable API; the CLI wraps this)."""
    import jax
    import jax.numpy as jnp

    from safe_exploration_tpu.runtime.config import build_experiment
    from safe_exploration_tpu.runtime.episode import run_episodic
    from safe_exploration_tpu.runtime.exploration import run_exploration
    from safe_exploration_tpu.runtime.metrics import AggregatedMetrics

    dtype = dtype or jnp.float32
    metrics = AggregatedMetrics(out_dir, run_name=cfg.name)
    exp = build_experiment(cfg, dtype=dtype)
    key = jax.random.PRNGKey(cfg.seed)

    common = dict(
        key=key, kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], hyp_iters=cfg.hyp_iters,
        metrics=metrics, make_ssm=exp["make_ssm"],
    )
    t0 = time.perf_counter()
    if cfg.task == "episodic":
        ckpt_dir = os.path.join(out_dir, f"{cfg.name}.ckpt") if out_dir else None
        out = run_episodic(
            exp["env"], exp["init_state"], exp["get_action"],
            exp["a"], exp["b"], exp["k_fb"],
            n_ep=cfg.n_ep, n_steps=cfg.n_steps,
            n_init_samples=cfg.n_init_samples,
            ckpt_dir=ckpt_dir, resume=resume, **common,
        )
    elif cfg.task == "exploration":
        out = run_exploration(
            exp["env"], exp["init_state"], exp["get_action"],
            exp["a"], exp["b"], exp["k_fb"],
            n_iterations=cfg.n_ep * cfg.n_steps,
            n_init_samples=cfg.n_init_samples, **common,
        )
    elif cfg.task == "exploration_static":
        from safe_exploration_tpu.runtime.exploration import (
            run_exploration_static,
        )

        out = run_exploration_static(
            exp["env"], exp["a"], exp["b"], exp["k_fb"],
            n_iterations=cfg.n_ep * cfg.n_steps,
            n_init_samples=cfg.n_init_samples,
            n_safe=cfg.n_safe, c_safety=cfg.c_safety,
            sqp_outer=cfg.sqp_outer, sqp_inner=cfg.sqp_inner,
            log_noise=cfg.log_noise, **common,
        )
    elif cfg.task == "batch":
        import jax.numpy as jnp

        from safe_exploration_tpu.models.ssm import (
            calibrate_lipschitz,
            ssm_fit,
            ssm_probe_points,
        )
        from safe_exploration_tpu.parallel import make_mesh
        from safe_exploration_tpu.runtime.batch import (
            run_batched_episodes,
            run_batched_episodes_lanes,
            stack_ssm,
        )
        from safe_exploration_tpu.runtime.episode import collect_initial_data

        k1, k2, k3, k4 = jax.random.split(key, 4)
        xs, us, resid = collect_initial_data(
            exp["env"], k1, cfg.n_init_samples, exp["a"], exp["b"], exp["k_fb"]
        )
        ssm = exp["make_ssm"](k2, xs, us, resid)

        def _fit_cal(s):
            s = ssm_fit(s, iters=cfg.hyp_iters)
            return calibrate_lipschitz(s, exp["env"].spec)

        ssm = jax.jit(_fit_cal)(ssm)
        # mesh over at most `lanes` devices; lanes rounded up to a multiple of
        # the mesh size so the episode axis shards evenly
        n_dev = max(1, min(len(jax.devices()), cfg.batch_lanes))
        lanes = ((cfg.batch_lanes + n_dev - 1) // n_dev) * n_dev
        mesh = make_mesh(n_dev)
        spec = exp["env"].spec
        x0s = spec.init_m + spec.init_std * jax.random.normal(
            k3, (lanes, spec.n_s), dtype
        )
        # ONLINE-episode runner selection (cfg.batch_backend): "auto" routes
        # to the vmapped runner, while "lanes" forces the lane-major
        # per-lane-buffer runner when the configuration supports it. The
        # batched SOLVE inside either runner still rides the lane-major SQP
        # where supported.
        lanes_ok = (
            exp["get_action_batch"] is not None
            and exp["lane_batch_supported"] is not None
            and exp["lane_batch_supported"](ssm)
        )
        if cfg.batch_backend not in ("auto", "lanes", "vmapped"):
            raise SystemExit(f"unknown batch_backend {cfg.batch_backend!r}")
        if cfg.batch_backend == "lanes" and not lanes_ok:
            # a config that PINS the lane pipeline (the *_batch_sqp entries
            # do, specifically to keep it exercised) must not silently run
            # the vmapped runner instead (ADVICE r4)
            import warnings

            warnings.warn(
                f"config '{cfg.name}' pins batch_backend='lanes' but the "
                "lane episode runner does not support this model/solver "
                "configuration — falling back to the vmapped runner",
                stacklevel=2,
            )
        use_lanes = lanes_ok and cfg.batch_backend == "lanes"
        if cfg.n_ep > 1:
            # N independent FULL learning runs: per-episode rollouts +
            # between-episode per-lane hyperopt (the reference's episodic
            # loop, every lane at once)
            from safe_exploration_tpu.runtime.batch import (
                run_batched_learning,
            )

            import os as _os

            ckpt_dir = (
                _os.path.join(out_dir, f"{cfg.name}.ckpt") if out_dir
                else None
            )
            res = run_batched_learning(
                exp["env"], exp, ssm, lanes, k4, cfg.n_ep, cfg.n_steps,
                hyp_iters=cfg.hyp_iters, mesh=mesh,
                backend="lanes" if use_lanes else "stacked",
                ckpt_dir=ckpt_dir, resume=resume,
            )
            series = dict(res["series"])
            roll_s = sum(series["episode_time_s"])
            total_steps = lanes * cfg.n_steps * cfg.n_ep
            series["lane_backend"] = [int(use_lanes)] * cfg.n_ep
            series["lanes"] = [lanes] * cfg.n_ep
            series["steps_per_sec"] = [total_steps / roll_s] * cfg.n_ep
            out = {"series": series}
            for name, vals in series.items():
                for step, v in enumerate(vals):
                    metrics.log_scalar(name, v, step=step)
            metrics.flush()
        else:
            t_roll = time.perf_counter()
            if use_lanes:
                from safe_exploration_tpu.models.gp_lanes import (
                    lane_shrink_to_bucket,
                    lane_stack_ssm,
                )

                traj, _ = run_batched_episodes_lanes(
                    exp["env"], exp["get_action_batch"],
                    exp["init_state_batch"],
                    lane_shrink_to_bucket(
                        lane_stack_ssm(ssm, lanes), n_free=cfg.n_steps
                    ),
                    x0s, jax.random.split(k4, lanes),
                    cfg.n_steps, exp["a"], exp["b"], mesh=mesh,
                )
            else:
                traj, _ = run_batched_episodes(
                    exp["env"], exp["get_action"], exp["init_state"],
                    stack_ssm(ssm, lanes), x0s, jax.random.split(k4, lanes),
                    cfg.n_steps, exp["a"], exp["b"], mesh=mesh,
                )
            roll_s = time.perf_counter() - t_roll
            total_steps = lanes * cfg.n_steps
            out = {"series": {
                "lane_backend": [int(use_lanes)],
                "violations": [int((~traj["constraint_ok"]).sum())],
                "feasibility_rate": [float(traj["feasible"].mean())],
                "model_error": [float(jnp.mean(traj["model_err"]))],
                "lanes": [lanes],
                "steps_per_sec": [total_steps / roll_s],
            }}
            for name, vals in out["series"].items():
                metrics.log_scalar(name, vals[0], step=0)
            metrics.flush()
    elif cfg.task == "serve":
        # production deployment surface: drive the AOT-compiled
        # ServeController against the simulated plant (the reference's
        # get_action+update_model loop, SURVEY.md §3.3, behind fixed-shape
        # pre-compiled executables — runtime/serve.py)
        import jax.numpy as jnp
        import numpy as np

        from safe_exploration_tpu.models.ssm import (
            calibrate_lipschitz,
            ssm_fit,
        )
        from safe_exploration_tpu.runtime.episode import collect_initial_data
        from safe_exploration_tpu.runtime.serve import ServeController

        k1, k2, k3 = jax.random.split(key, 3)
        xs, us, resid = collect_initial_data(
            exp["env"], k1, cfg.n_init_samples, exp["a"], exp["b"], exp["k_fb"]
        )
        ssm = exp["make_ssm"](k2, xs, us, resid)
        ssm = jax.jit(lambda s: calibrate_lipschitz(
            ssm_fit(s, iters=cfg.hyp_iters), exp["env"].spec
        ))(ssm)
        from safe_exploration_tpu.envs import env_step

        ctrl = ServeController(exp, ssm, key=k3, on_full="drop")
        spec = exp["env"].spec
        x = np.asarray(jax.device_get(
            spec.init_m + spec.init_std * jax.random.normal(
                jax.random.fold_in(k3, 1), (spec.n_s,), dtype
            )
        ))
        feas, viol = [], 0
        for i in range(cfg.n_steps):
            u = ctrl.step(x)
            _, x_next = env_step(
                exp["env"], jax.random.fold_in(k3, 2 + i),
                jnp.asarray(x, dtype), jnp.asarray(u, dtype),
            )
            x_next = np.asarray(jax.device_get(x_next))
            ctrl.observe(x, u, x_next)
            feas.append(bool(ctrl.last_feasible))
            if np.any(spec.h_mat_obs @ x_next - spec.h_obs > 0.0):
                viol += 1
            x = x_next
        stats = ctrl.latency_stats()
        out = {"series": {
            "feasibility_rate": [float(np.mean(feas))],
            "violations": [viol],
            "recompiles": [ctrl.recompiles],
            "dropped_points": [ctrl.dropped_points],
            "latency_p50_ms": [stats["p50_ms"]],
            "latency_p99_ms": [stats["p99_ms"]],
        }}
        for name, vals in out["series"].items():
            # latency percentiles are None (JSON null) when every recorded
            # step was a post-compile first step (short runs) — skip the
            # scalar log rather than coercing to NaN
            if vals[0] is not None:
                metrics.log_scalar(name, vals[0], step=0)
        metrics.flush()
    elif cfg.task == "uncertainty":
        import jax.numpy as jnp

        from safe_exploration_tpu.runtime.episode import collect_initial_data
        from safe_exploration_tpu.models import make_gp_ssm, ssm_fit
        from safe_exploration_tpu.models.ssm import calibrate_lipschitz
        from safe_exploration_tpu.runtime.uncertainty import run_uncertainty_estimation

        k1, k2 = jax.random.split(key)
        xs, us, resid = collect_initial_data(
            exp["env"], k1, cfg.n_init_samples, exp["a"], exp["b"], exp["k_fb"]
        )
        ssm = make_gp_ssm(
            exp["kern_types"], xs, us, resid, n_max=cfg.n_max,
            l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], log_noise=cfg.log_noise,
        )
        ssm = ssm_fit(ssm, iters=cfg.hyp_iters)
        ssm = calibrate_lipschitz(ssm, exp["env"].spec)
        out = run_uncertainty_estimation(
            exp["env"], ssm, exp["a"], exp["b"], exp["k_fb"],
            key=k2,
            x0=jnp.zeros((exp["env"].spec.n_s,), dtype),
            k_ff_all=jnp.zeros((cfg.n_safe, exp["env"].spec.n_u), dtype),
            c_safety=cfg.c_safety, metrics=metrics,
        )
    else:
        raise SystemExit(f"unknown task: {cfg.task}")
    wall = time.perf_counter() - t0

    summary = {
        "config": dataclasses.asdict(cfg),
        "wall_time_s": wall,
        "metrics": metrics.summary(),
    }
    if "series" in out:
        summary["series"] = out["series"]
    elif "per_stage_containment" in out:
        summary["per_stage_containment"] = out["per_stage_containment"]
        summary["overall_containment"] = out["overall_containment"]
        summary["violation_rate"] = out["violation_rate"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{cfg.name}.summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="pendulum_episode",
                        help="named config (see runtime/config.py registry)")
    parser.add_argument("--list", action="store_true", help="list configs")
    parser.add_argument("--platform", default=None,
                        help="force jax platform (cpu/gpu)")
    parser.add_argument("--x64", action="store_true", help="enable float64")
    parser.add_argument("--out", default=None, help="output directory")
    parser.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                        help="config field overrides")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a jax.profiler trace of the run to DIR "
                             "(view with TensorBoard / xprof; SURVEY.md §5.1)")
    parser.add_argument("--resume", action="store_true",
                        help="resume the episodic/batch task from the latest "
                             "checkpoint under --out (bit-exact RNG stream)")
    parser.add_argument("--debug-nans", action="store_true",
                        help="enable jax_debug_nans (SURVEY.md §5.2 analog)")
    args = parser.parse_args(argv)

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    import jax.numpy as jnp

    from safe_exploration_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from safe_exploration_tpu.runtime.config import CONFIGS

    if args.list:
        for name, c in CONFIGS.items():
            print(f"{name:28s} task={c.task:12s} env={c.env:10s} solver={c.solver}")
        return 0

    if args.config not in CONFIGS:
        raise SystemExit(
            f"unknown config '{args.config}'; available: {sorted(CONFIGS)}"
        )
    cfg = _apply_overrides(CONFIGS[args.config], args.set)
    dtype = jnp.float64 if args.x64 else jnp.float32
    if args.profile:
        with jax.profiler.trace(args.profile):
            summary = run_experiment(cfg, out_dir=args.out, dtype=dtype,
                                     resume=args.resume)
    else:
        summary = run_experiment(cfg, out_dir=args.out, dtype=dtype,
                                 resume=args.resume)
    print(json.dumps(
        {k: v for k, v in summary.items() if k != "config"}, indent=2, default=str
    ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
