"""Batched parallel episodes — BASELINE config 3 (256 vmapped episodes).

The reference runs ONE episode at a time on one CPU (SURVEY.md §2.9). Here a
whole fleet of independent safe-learning episodes runs as a single XLA
program: each lane owns its environment state, SafeMPC controller state and
its own GP (a stacked pytree), the per-step model update is the O(n^2)
incremental bordered-Cholesky append (models/gp.gp_append_point) instead of
the reference's O(n^3) GPy re-factorization, and the lane axis shards over the
device mesh (parallel/mesh.py) — embarrassingly parallel, zero collectives.

This is the scale-out path behind the >=1000 parallel solves/sec north star;
it is also exactly what ``__graft_entry__.dryrun_multichip`` compiles over the
virtual mesh.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

import numpy as np

from safe_exploration_tpu.envs.base import Env, env_step
from safe_exploration_tpu.models.ssm import GPSSM, ssm_append_point, ssm_predict
from safe_exploration_tpu.parallel.mesh import EPISODE_AXIS

__all__ = [
    "stack_ssm",
    "run_batched_episodes",
    "run_batched_episodes_lanes",
    "run_batched_learning",
]


def stack_ssm(ssm: GPSSM, batch: int) -> GPSSM:
    """Replicate one SSM into a per-lane stacked pytree (each episode then
    updates its own copy independently)."""
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), ssm)


def run_batched_episodes(
    env: Env,
    get_action: Callable,
    init_state: Callable,
    ssm_batch: GPSSM,
    x0s: jax.Array,
    keys: jax.Array,
    n_steps: int,
    a: jax.Array,
    b: jax.Array,
    *,
    mesh=None,
):
    """Run ``batch`` independent episodes of ``n_steps`` as one device program.

    Args:
      ssm_batch: lane-stacked GPSSM (see :func:`stack_ssm`); each lane's GP
        buffer must have >= n_steps free slots (incremental appends).
      x0s: (batch, n_s) initial states.  keys: (batch,) PRNG keys.
      mesh: optional Mesh — lane axis is sharded over it (SPMD).

    Returns (traj, ssm_batch_final) where traj is a dict of (batch, n_steps, ...)
    series: x, u, resid, model_err, feasible, violation, constraint_ok.

    Raises ValueError host-side if any lane's GP buffer could overflow during
    the run: gp_append_point saturates (drops points) on a full buffer rather
    than corrupting factors, and a schedule that would hit that silently stops
    learning — parity with ``SimpleGPModel.update_model``'s explicit error
    (SURVEY.md §2.3; VERDICT r2 weak #3).
    """
    spec = env.spec
    # host-side overflow guard: mask/n_max are concrete here (pre-jit)
    n_max = ssm_batch.gp.x.shape[-2]
    n_used = int(np.max(jax.device_get(jnp.sum(ssm_batch.gp.mask, axis=-1))))
    if n_used + n_steps > n_max:
        raise ValueError(
            f"batched episode would overflow the GP buffer: {n_used} points + "
            f"{n_steps} appends > n_max={n_max}; raise the config's n_max or "
            "shorten the episode"
        )

    def one_lane(key, ssm: GPSSM, x0: jax.Array):
        mstate = init_state()
        step_keys = jax.random.split(key, n_steps)

        def body(carry, k):
            x, ms, s = carry
            k_plan, k_step = jax.random.split(k)
            u, ms, info = get_action(k_plan, ms, s, x)
            u_app, x_next = env_step(env, k_step, x, u)
            resid = x_next - (a @ x + b @ u_app)
            # model error = |residual - predicted residual| with the model
            # that planned this step (prediction BEFORE the append below)
            mu_pred, _ = ssm_predict(s, x, u_app)
            # O(n^2) bordered-Cholesky append: the lane's model learns online
            # (ssm_append_point owns the z_scale normalization)
            s = ssm_append_point(s, x, u_app, resid)
            ok = jnp.all(spec.h_mat_obs @ x_next - spec.h_obs <= 0.0)
            out = {
                "x": x, "u": u_app, "resid": resid,
                "model_err": jnp.linalg.norm(resid - mu_pred),
                "feasible": info["feasible"], "violation": info["violation"],
                "constraint_ok": ok,
            }
            return (x_next, ms, s), out

        (x_fin, _, s_fin), traj = jax.lax.scan(
            body, (x0, mstate, ssm), step_keys
        )
        return traj, s_fin, x_fin

    fn = jax.vmap(one_lane)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(EPISODE_AXIS))
        args = jax.device_put((keys, ssm_batch, x0s), shard)
        fn = jax.jit(fn, in_shardings=shard, out_shardings=shard)
        traj, ssm_fin, _ = fn(*args)
    else:
        traj, ssm_fin, _ = jax.jit(fn)(keys, ssm_batch, x0s)
    return traj, ssm_fin


def run_batched_episodes_lanes(
    env: Env,
    get_action_batch: Callable,
    init_state_batch: Callable,
    lane_ssm,
    x0s: jax.Array,
    keys: jax.Array,
    n_steps: int,
    a: jax.Array,
    b: jax.Array,
    *,
    mesh=None,
):
    """Lane-major batched online-learning episodes — the same semantics as
    :func:`run_batched_episodes` through the lane-major (batch-last) backend.

    The vmapped runner above puts the batch dim in front of the tiny
    trailing dims of every solver intermediate (solvers/sqp_lanes.py module
    docstring). This runner instead threads the whole per-step pipeline
    batch-LAST:

      * planning: ``get_action_batch`` (the batched SafeMPC state machine
        over the lane-major SQP, solvers/safempc.make_safempc_batch);
      * model: a :class:`~safe_exploration_tpu.models.gp_lanes.LaneGPSSM` —
        per-lane GP buffers/factors stored (..., B), with the O(n^2)
        incremental append as lane-tiled block-inverse updates
        (models/gp_lanes.lane_append_point);
      * plant steps/metrics: vmapped (tiny, not on the critical path).

    Args mirror :func:`run_batched_episodes` with ``lane_ssm`` from
    :func:`~safe_exploration_tpu.models.gp_lanes.lane_stack_ssm` and the
    batched controller entries from ``build_experiment``. PRNG streams match
    the vmapped runner exactly (same per-lane key splits), so plant noise is
    identical — parity is pinned in tests/test_batch_lanes.py.

    Returns (traj, lane_ssm_final) with the same (batch, n_steps, ...) traj
    contract; convert the final model back with ``lane_unstack_ssm`` at the
    episode boundary if stacked-path consumers (per-lane hyperopt,
    checkpointing) need it.
    """
    from safe_exploration_tpu.models.gp_lanes import (
        lane_append_point,
        lane_predict,
        lane_sharding_tree,
    )

    spec = env.spec
    n_max = lane_ssm.gp.x.shape[0]
    n_used = int(np.sum(jax.device_get(lane_ssm.gp.mask)))
    if n_used + n_steps > n_max:
        raise ValueError(
            f"batched episode would overflow the GP buffer: {n_used} points "
            f"+ {n_steps} appends > n_max={n_max}; raise the config's n_max "
            "or shorten the episode"
        )
    bsz = x0s.shape[0]

    # identical PRNG streams to the vmapped runner's one_lane: per lane,
    # split(key, n_steps) then (k_plan, k_step) per step
    step_keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(keys)
    step_keys = jnp.moveaxis(step_keys, 0, 1)               # (n_steps, B, ...)

    def run(ls, x0s_, skeys):
        ms = init_state_batch(bsz)

        def body(carry, ks):
            xs, ms, s = carry
            pair = jax.vmap(jax.random.split)(ks)           # (B, 2, key)
            k_step = pair[:, 1]
            u, ms, info = get_action_batch(ms, s, xs)
            u_app, x_next = jax.vmap(
                lambda k, x, uu: env_step(env, k, x, uu)
            )(k_step, xs, u)
            resid = x_next - (xs @ a.T + u_app @ b.T)
            mu_pred, _ = lane_predict(
                s, jnp.concatenate([xs, u_app], axis=-1).T
            )                                               # (e, B)
            s = lane_append_point(s, xs, u_app, resid)
            ok = jnp.all(
                x_next @ spec.h_mat_obs.T - spec.h_obs[None, :] <= 0.0,
                axis=-1,
            )
            out = {
                "x": xs, "u": u_app, "resid": resid,
                "model_err": jnp.linalg.norm(resid - mu_pred.T, axis=-1),
                "feasible": info["feasible"],
                "violation": info["violation"],
                "constraint_ok": ok,
            }
            return (x_next, ms, s), out

        (x_fin, _, s_fin), traj = jax.lax.scan(body, (x0s_, ms, ls), skeys)
        # (n_steps, B, ...) -> (B, n_steps, ...): the vmapped runner's contract
        traj = jax.tree.map(lambda t: jnp.moveaxis(t, 0, 1), traj)
        return traj, s_fin

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lane_shard = NamedSharding(mesh, P(EPISODE_AXIS))
        key_shard = NamedSharding(mesh, P(None, EPISODE_AXIS))
        ls = jax.device_put(lane_ssm, lane_sharding_tree(
            mesh, lane_ssm, EPISODE_AXIS
        ))
        x0s_ = jax.device_put(x0s, lane_shard)
        skeys = jax.device_put(step_keys, key_shard)
        traj, ssm_fin = jax.jit(run)(ls, x0s_, skeys)
    else:
        traj, ssm_fin = jax.jit(run)(lane_ssm, x0s, step_keys)
    return traj, ssm_fin


def run_batched_learning(
    env: Env,
    exp: dict,
    ssm: GPSSM,
    batch: int,
    key: jax.Array,
    n_ep: int,
    n_steps: int,
    *,
    hyp_iters: int = 80,
    opt_hyp_every: int = 1,
    calibrate: bool = True,
    mesh=None,
    backend: str | None = None,
    ckpt_dir: str | None = None,
    resume: bool = False,
):
    """``batch`` independent FULL safe-learning runs: the reference's episodic
    loop (``episode_runner.py::run_episodic``, SURVEY.md §2.8) for every lane
    at once — per-episode rollouts through the batched episode runners above,
    then a BETWEEN-EPISODE per-lane hyperparameter re-fit (+ Lipschitz
    re-calibration) exactly like the single-run ``runtime/episode.py`` loop,
    vmapped across lanes.

    ``backend`` "lanes" | "stacked" | None (auto: lanes when the experiment's
    ``lane_batch_supported`` covers the model). On the lane backend the
    between-episode fit round-trips through the stacked view
    (``lane_unstack_ssm`` -> vmapped fit -> ``lane_restack_ssm``), after which
    every lane carries its OWN hyperparameters/Lipschitz constants as
    batch-last hyper leaves (models/gp_lanes ``per_lane_hypers``).

    Returns {"series": per-episode lists (lane-mean metrics, same names as
    run_episodic), "model": final per-lane model (LaneGPSSM or stacked
    GPSSM)}.

    ``ckpt_dir`` enables per-episode checkpointing of the FULL fleet state
    (per-lane model incl. evolved buffers/factors/hypers, RNG key, episode
    index, metric series); ``resume=True`` restarts from the latest
    checkpoint bit-exactly — the same §5.4 guarantee as the single-run
    ``run_episodic``, at fleet scale.
    """
    import time

    from safe_exploration_tpu.envs.base import env_reset
    from safe_exploration_tpu.models.ssm import (
        calibrate_lipschitz as _calibrate,
        ssm_fit,
    )

    spec = env.spec
    a, b = exp["a"], exp["b"]
    if backend is None:
        lbs = exp.get("lane_batch_supported")
        backend = (
            "lanes"
            if exp.get("get_action_batch") is not None
            and lbs is not None and lbs(ssm)
            else "stacked"
        )
    if backend == "lanes":
        from safe_exploration_tpu.models.gp_lanes import (
            lane_restack_ssm,
            lane_stack_ssm,
            lane_unstack_ssm,
        )

        model = lane_stack_ssm(ssm, batch)
    else:
        model = stack_ssm(ssm, batch)

    def fit_one(s):
        s = ssm_fit(s, iters=hyp_iters)
        if calibrate:
            s = _calibrate(s, spec)
        return s

    fit_batch = jax.jit(jax.vmap(fit_one))

    series: dict[str, list] = {
        "violations": [], "feasibility_rate": [], "model_error": [],
        "mean_cost": [], "episode_time_s": [], "n_data": [],
    }
    start_ep = 0
    if resume and ckpt_dir is not None:
        from safe_exploration_tpu.runtime.checkpoint import (
            latest_checkpoint,
            load_checkpoint,
        )

        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            restored = load_checkpoint(path)
            model = restored["model"]
            key = restored["key"]
            start_ep = int(restored["episode"]) + 1
            # scalar series entries come back as 0-d arrays — keep the
            # series JSON-able plain numbers
            series = {
                k: [v.item() if hasattr(v, "item") else v for v in vals]
                for k, vals in restored["series"].items()
            }

    for ep in range(start_ep, n_ep):
        key, k_reset, k_roll = jax.random.split(key, 3)
        x0s = jax.vmap(lambda k: env_reset(env, k))(
            jax.random.split(k_reset, batch)
        )
        ep_keys = jax.random.split(k_roll, batch)
        t0 = time.perf_counter()
        if backend == "lanes":
            from safe_exploration_tpu.models.gp_lanes import (
                lane_expand_to,
                lane_shrink_to_bucket,
            )

            # episode runs on a BUCKETED view (contractions sized to the
            # active points + this episode's appends, not the padded
            # capacity — the lane form of the stacked path's ssm_bucketed);
            # expanded back to capacity afterwards
            cap = model.gp.n_max
            view = lane_shrink_to_bucket(model, n_free=n_steps)
            traj, view = run_batched_episodes_lanes(
                env, exp["get_action_batch"], exp["init_state_batch"],
                view, x0s, ep_keys, n_steps, a, b, mesh=mesh,
            )
            model = lane_expand_to(view, cap)
            n_data = int(model.gp.n_points)
        else:
            traj, model = run_batched_episodes(
                env, exp["get_action"], exp["init_state"],
                model, x0s, ep_keys, n_steps, a, b, mesh=mesh,
            )
            n_data = int(np.max(
                jax.device_get(jnp.sum(model.gp.mask, axis=-1))
            ))
        jax.block_until_ready(traj["x"])
        dt_ep = time.perf_counter() - t0

        series["violations"].append(int((~traj["constraint_ok"]).sum()))
        series["feasibility_rate"].append(float(traj["feasible"].mean()))
        series["model_error"].append(float(jnp.mean(traj["model_err"])))
        series["mean_cost"].append(
            float(jnp.mean(jnp.sum(traj["x"] ** 2, axis=-1)))
        )
        series["episode_time_s"].append(dt_ep)
        series["n_data"].append(n_data)

        # per-lane hyperopt after EVERY episode (run_episodic semantics —
        # also what makes resume-from-checkpoint bit-exact: an interrupted
        # run's post-episode state must not depend on how many episodes
        # remain)
        if opt_hyp_every and (ep + 1) % opt_hyp_every == 0:
            if backend == "lanes":
                model = lane_restack_ssm(fit_batch(lane_unstack_ssm(model)))
            else:
                model = fit_batch(model)

        if ckpt_dir is not None:
            from safe_exploration_tpu.runtime.checkpoint import (
                save_checkpoint,
            )

            # post-fit state: a resume re-enters the next episode with
            # exactly the model/key this run would use (bit-exact, §5.4)
            save_checkpoint(
                f"{ckpt_dir}/ckpt_{ep}.pkl",
                {"model": model, "key": key, "episode": ep,
                 "series": series},
            )

    return {"series": series, "model": model}
