"""Production serving: an AOT-compiled SafeMPC controller.

The research runners (runtime/episode.py etc.) trace + jit lazily — fine for
experiments, wrong for deployment: the first control step of a freshly started
process would eat a multi-second XLA compile, and a shape drift (GP bucket
growth) would silently retrace mid-mission. This module packages the planner +
fallback state machine behind a FIXED-SHAPE, ahead-of-time-compiled step
executable:

  * ``ServeController.step(x)`` runs one control step — plan, fallback chain,
    state carry — as ONE pre-compiled XLA program (``jax.jit(...).lower(...)
    .compile()`` at construction, never at call time);
  * the controller state is DONATED to the executable, so the steady-state
    loop allocates nothing on the host side of the step;
  * ``observe(x, u, x_next)`` feeds transitions back through the O(n^2)
    incremental GP append (a second pre-compiled executable); crossing a GP
    bucket boundary re-AOT-compiles explicitly (logged via the ``recompiles``
    counter) instead of silently retracing — O(log n_max) times total;
  * step wall-clock latencies are recorded so deployments can read p50/p99
    from the controller itself.

Parity: the reference's production surface is ``SimpleSafeMPC.get_action`` +
``update_model`` called from a Python loop around CasADi/IPOPT
(``safempc_simple.py``, SURVEY.md §2.5/§3.3) — per-step solver latency there
is whatever IPOPT takes that step. This is the compiled counterpart: fixed
shapes, fixed budgets, one executable per bucket, microsecond-stable dispatch.
"""

from __future__ import annotations

import collections
import time

import jax
import jax.numpy as jnp
import numpy as np

from safe_exploration_tpu.models.ssm import ssm_append_point, ssm_bucketed

__all__ = ["ServeController"]


class ServeController:
    """AOT-compiled single-plant SafeMPC control loop.

    Args:
      exp: ``build_experiment(cfg)`` dict (env, get_action, init_state, ...).
      ssm: the trained SSM (exact-GP family required for ``observe``; any
        SSM family works for pure ``step`` serving).
      key: PRNG key for sampling-based planners (split per step on device).
      on_full: what ``observe`` does once the GP buffer saturates
        (``head == n_max``): ``"raise"`` (default — a silent learning stop is
        the one production failure mode that must be loud; parity with
        ``SimpleGPModel.update_model``'s explicit error, SURVEY.md §2.3 and
        the batch runner's host-side guard, runtime/batch.py) or ``"drop"``
        (count the dropped transition in ``dropped_points`` and keep serving
        on the frozen model — for deployments that prefer degraded learning
        over an exception in the control loop).
      latency_window: ring-buffer size for step-latency samples (a long-lived
        controller must not grow host memory without bound).

    The planner, horizon, budgets and model bucket are all frozen into the
    compiled executable; ``step`` accepts exactly one state vector of the
    environment's shape/dtype.
    """

    def __init__(self, exp: dict, ssm, key: jax.Array | None = None, *,
                 on_full: str = "raise", latency_window: int = 4096):
        if on_full not in ("raise", "drop"):
            raise ValueError(f"on_full must be 'raise' or 'drop', got {on_full!r}")
        self._exp = exp
        self._ssm_full = ssm
        self._spec = exp["env"].spec
        self._dtype = exp["a"].dtype
        self._state = exp["init_state"]()
        self._key = jax.random.PRNGKey(0) if key is None else key
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=latency_window
        )
        self._last_flags: tuple = (False, 0, 0.0)
        self._on_full = on_full
        self.dropped_points = 0
        self.recompiles = 0
        self._step_exec = None
        self._append_exec = None
        self._bucket_n = -1
        # buffer occupancy, tracked host-side (capacity is static; the count
        # starts at the model's current head and bumps per accepted append) —
        # the saturation guard must not cost a device sync per observe()
        gp = getattr(ssm, "gp", None)
        self._capacity = int(gp.x.shape[0]) if gp is not None else 0
        self._n_pts = (
            int(jax.device_get(gp.head)) if gp is not None else 0
        )
        self._compile_step()

    # ------------------------------------------------------------------ build

    def _compile_step(self) -> None:
        """(Re-)AOT-compile the step executable for the CURRENT GP bucket."""
        get_action = self._exp["get_action"]
        ssm_plan = ssm_bucketed(self._ssm_full)
        self._ssm_plan = ssm_plan
        self._bucket_n = int(self._bucket_size(ssm_plan))

        def _step(state, ssm, x, key):
            k_step, k_next = jax.random.split(key)
            u, state2, info = get_action(k_step, state, ssm, x)
            flags = (info["feasible"], info["n_fail"], info["violation"])
            return u, state2, k_next, flags

        x_proto = jnp.zeros((self._spec.n_s,), self._dtype)
        self._step_exec = (
            jax.jit(_step, donate_argnums=(0,))
            .lower(self._state, ssm_plan, x_proto, self._key)
            .compile()
        )
        self.recompiles += 1
        # the next step() pays this executable's one-time host linking — its
        # latency sample is excluded from latency_stats (per-executable, not
        # just the global first step; ADVICE r4)
        self._skip_next_latency = True

    def _compile_append(self) -> None:
        def _append(ssm, x, u, y):
            return ssm_append_point(ssm, x, u, y)

        x_proto = jnp.zeros((self._spec.n_s,), self._dtype)
        u_proto = jnp.zeros((self._spec.n_u,), self._dtype)
        self._append_exec = (
            jax.jit(_append)
            .lower(self._ssm_full, x_proto, u_proto, x_proto)
            .compile()
        )

    def _bucket_size(self, ssm_plan) -> int:
        gp = getattr(ssm_plan, "gp", None)
        if gp is not None and hasattr(gp, "x"):
            return gp.x.shape[0]
        sgp = getattr(ssm_plan, "sgp", None)
        if sgp is not None:
            return sgp.z.shape[0]
        return 0

    # ------------------------------------------------------------------ serve

    def step(self, x) -> np.ndarray:
        """One control step: plan (or fall back) at state ``x``, return u.

        Runs the pre-compiled executable — no tracing, no compilation, fixed
        shapes. Latency is recorded (seconds, wall clock including dispatch).
        """
        x = jnp.asarray(x, self._dtype)
        t0 = time.perf_counter()
        u, self._state, self._key, flags = self._step_exec(
            self._state, self._ssm_plan, x, self._key
        )
        u = np.asarray(jax.block_until_ready(u))
        if self._skip_next_latency:
            self._skip_next_latency = False  # first call of this executable
        else:
            self._latencies.append(time.perf_counter() - t0)
        self._last_flags = tuple(np.asarray(f) for f in flags)
        return u

    @property
    def last_feasible(self) -> bool:
        return bool(self._last_flags[0])

    @property
    def last_n_fail(self) -> int:
        return int(self._last_flags[1])

    def observe(self, x, u, x_next) -> None:
        """Feed one observed transition back into the model (online learning).

        Appends the residual ``x_next - (a x + b u)`` through the O(n^2)
        incremental GP update. If the append crosses a power-of-2 bucket
        boundary, the step executable is re-AOT-compiled for the new bucket
        (counted in ``recompiles`` — O(log n_max) over a deployment).

        Once the buffer saturates (``head == n_max``) the device-side append
        is a gated no-op (models/gp.gp_append_point) — learning would stop
        SILENTLY. This guard makes it loud: raises RuntimeError by default,
        or counts into ``dropped_points`` under ``on_full="drop"``.
        """
        if self._capacity and self._n_pts >= self._capacity:
            if self._on_full == "raise":
                raise RuntimeError(
                    f"ServeController GP buffer is full ({self._n_pts}/"
                    f"{self._capacity} points): observe() would silently stop "
                    "learning. Build the controller with a larger n_max, or "
                    "pass on_full='drop' to keep serving on the frozen model "
                    "(dropped transitions counted in .dropped_points)."
                )
            self.dropped_points += 1
            return
        if self._append_exec is None:
            self._compile_append()
        x = jnp.asarray(x, self._dtype)
        u = jnp.asarray(u, self._dtype)
        y = jnp.asarray(x_next, self._dtype) - (
            self._exp["a"] @ x + self._exp["b"] @ u
        )
        self._ssm_full = self._append_exec(self._ssm_full, x, u, y)
        self._n_pts += 1
        new_plan = ssm_bucketed(self._ssm_full)
        if int(self._bucket_size(new_plan)) != self._bucket_n:
            self._compile_step()
        else:
            self._ssm_plan = new_plan

    def latency_stats(self) -> dict:
        """p50/p99/mean step latency in milliseconds over the (bounded) sample
        window. The first step after EACH (re)compile is excluded at record
        time — it pays one-time host linking, not serving (ADVICE r4: the old
        code dropped only the global first sample, so post-recompile p99
        measured linking)."""
        lat = np.asarray(self._latencies, dtype=np.float64) * 1e3
        if lat.size == 0:
            # None (JSON null), NOT NaN: a short run whose every step was a
            # post-compile first step would otherwise write bare NaN tokens
            # into the summary JSON, which strict parsers reject
            return {"n": 0, "p50_ms": None, "p99_ms": None, "mean_ms": None}
        return {
            "n": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(lat.mean()),
        }
