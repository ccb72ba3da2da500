"""Static safe active learning: optimize the PROBE INPUT itself.

Parity: reference ``exploration_runner.py::run_exploration`` (SURVEY.md §3.2)
— the static safe-learning NLP of the journal paper:

    max_{z=(x,u), k_ff}  sigma^2(z)
    s.t.   x inside the state polytope,
           the n_safe-step ellipsoid tube started at x under
           [u, k_ff_1..k_ff_{n-1}] stays inside the state polytope and its
           terminal ellipsoid lands in the safe (returnable) set.

This differs from the greedy exploration runner (runtime/exploration.py),
which plans an information-seeking trajectory FROM THE CURRENT STATE: here
the probe state x is a decision variable, so the learner can query any safe,
returnable input — the reference's active-learning semantics (it assumes a
resettable/quasi-static plant that can be steered to the chosen x between
queries).

Compiled: the same fixed-budget augmented-Lagrangian core as the SafeMPC
NLP (solvers/sqp.py::solve_al_nlp) — jit-able, vmappable across restarts.
The reference solves this with a fresh CasADi/IPOPT program per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from safe_exploration_tpu.envs.base import Env
from safe_exploration_tpu.reachability.onestep import multistep_reachability
from safe_exploration_tpu.reachability.safety import lin_ellipsoid_safety_distance
from safe_exploration_tpu.solvers.sqp import SqpConfig, solve_al_nlp

__all__ = ["StaticExplorationResult", "make_static_exploration_planner",
           "polytope_box_bounds", "static_warm_len"]


def polytope_box_bounds(h_mat, h_vec, fallback: float = 10.0):
    """Per-dimension box bounds implied by the axis-aligned rows of the
    polytope {x : H x <= h} (build-time numpy; envs use box polytopes).
    Non-axis-aligned dims fall back to +-``fallback``."""
    h_mat = np.asarray(h_mat)
    h_vec = np.asarray(h_vec)
    n = h_mat.shape[1]
    lo = np.full((n,), -fallback)
    hi = np.full((n,), fallback)
    for r in range(h_mat.shape[0]):
        nz = np.nonzero(np.abs(h_mat[r]) > 1e-12)[0]
        if len(nz) != 1:
            continue
        i, c = int(nz[0]), h_mat[r, nz[0]]
        bound = h_vec[r] / c
        if c > 0:
            hi[i] = min(hi[i], bound)
        else:
            lo[i] = max(lo[i], bound)
    return lo, hi


class StaticExplorationResult(NamedTuple):
    x_probe: jax.Array      # (n_s,) chosen probe state
    u_probe: jax.Array      # (n_u,) chosen probe control
    k_ff_return: jax.Array  # (n_safe, n_u) full tube controls (stage 0 = u_probe)
    feasible: jax.Array     # () bool — probe is safely returnable
    violation: jax.Array    # () summed constraint violation
    sigma2: jax.Array       # (n_s,) predictive variance at the probe
    warm_next: jax.Array    # flat decision vector (warm start for next solve)


def static_warm_len(env: Env, cfg: SqpConfig) -> int:
    """Flat decision-vector length: [x_probe | u_probe | k_ff_return]."""
    spec = env.spec
    return spec.n_s + cfg.n_safe * spec.n_u


def make_static_exploration_planner(
    env: Env,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    cfg: SqpConfig,
):
    """Build ``planner(ssm, warm_flat) -> StaticExplorationResult``.

    ``warm_flat`` (static_warm_len,) warm-starts the decision vector; pass
    zeros (or the previous solve's ``warm_next``) — the runner perturbs it
    across iterations to escape the previous optimum's vanished-variance
    basin (sampling the probe collapses sigma^2 there).
    """
    spec = env.spec
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    dtype = a.dtype

    x_lo, x_hi = polytope_box_bounds(spec.h_mat_obs, spec.h_obs)
    lo = jnp.concatenate([
        jnp.asarray(x_lo, dtype), jnp.tile(spec.u_min, t_len)
    ])
    hi = jnp.concatenate([
        jnp.asarray(x_hi, dtype), jnp.tile(spec.u_max, t_len)
    ])
    k_fb_all = jnp.tile(k_fb[None], (t_len, 1, 1))

    def split(v):
        x_probe = v[:n_s]
        k_ff_all = v[n_s:].reshape(t_len, n_u)
        return x_probe, k_ff_all

    def planner(ssm, warm_flat: jax.Array) -> StaticExplorationResult:
        noise_var = ssm.noise_var()

        def objective(v):
            x_probe, k_ff_all = split(v)
            z = jnp.concatenate([x_probe, k_ff_all[0]])
            _, var = ssm.predict_latent(z)
            # negative exact information gain (better conditioned than raw
            # sigma^2; same argmax direction)
            return -0.5 * jnp.sum(jnp.log1p(var / noise_var))

        def constraints(v):
            x_probe, k_ff_all = split(v)
            # probe state itself must be safe
            d_probe = spec.h_mat_obs @ x_probe - spec.h_obs
            # and the tube from it must stay safe and RETURN to the safe set
            p_traj, q_traj, _ = multistep_reachability(
                ssm, x_probe, k_ff_all, k_fb_all, a, b, cfg.c_safety
            )
            d_stage = jax.vmap(
                lambda p, q: lin_ellipsoid_safety_distance(
                    p, q, spec.h_mat_obs, spec.h_obs
                )
            )(p_traj, q_traj)
            d_term = lin_ellipsoid_safety_distance(
                p_traj[-1], q_traj[-1], spec.h_mat_safe, spec.h_safe
            )
            return jnp.concatenate([d_probe, d_stage.reshape(-1), d_term])

        v_fin, _, g_fin = solve_al_nlp(
            objective, constraints, warm_flat, lo, hi, cfg
        )
        violation = jnp.sum(jnp.maximum(g_fin, 0.0))
        feasible = violation <= cfg.feas_tol
        x_probe, k_ff_all = split(v_fin)
        z = jnp.concatenate([x_probe, k_ff_all[0]])
        _, sigma2 = ssm.predict_latent(z)
        return StaticExplorationResult(
            x_probe=x_probe,
            u_probe=k_ff_all[0],
            k_ff_return=k_ff_all,
            feasible=feasible,
            violation=violation,
            sigma2=sigma2,
            warm_next=v_fin,
        )

    return planner
