"""Ellipsoidal reachability of GP dynamics — the safety engine.

Parity: the reference keeps THREE behaviorally-identical implementations of this
file (``gp_reachability.py`` numpy, ``gp_reachability_casadi.py`` symbolic inside
IPOPT, ``gp_reachability_pytorch.py`` batched for CEM — SURVEY.md §2.4). This one
JAX implementation is all three at once: call it eagerly, trace it into the SQP,
``jacfwd`` it for exact derivatives, ``vmap`` it across CEM samples / episodes.

Algorithm (Koller et al. CDC'18; SURVEY.md §2.4, [H]): one step of the closed-loop
system x+ = a x + b u + GP(x, u), u = k_ff + k_fb (x - p), from the ellipsoid
E(p, Q):

  1. GP predict (+ mean Jacobians) at the center z = (p, k_ff);
  2. next center  p+ = a p + b k_ff + mu(z);
  3. affine part  H = a + J_mu,x + (b + J_mu,u) k_fb,  Q_lin = H Q H^T;
  4. Lipschitz remainder boxes (ops/lipschitz) -> Taylor-error ellipsoid;
  5. confidence box  c_safety * (sqrt(var) + u_sigma) -> uncertainty ellipsoid;
  6. Minkowski-sum the three ellipsoids (trace-minimal over-approximation).

``c_safety`` (a.k.a. beta_safety, ~2-3 in the papers) scales the GP confidence
intervals to the desired probability level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_exploration_tpu.models.ssm import (
    GPSSM,
    ssm_noise_var,
    ssm_predict,
    ssm_predict_jac,
)
from safe_exploration_tpu.ops.ellipsoid import (
    ellipsoid_from_rectangle,
    sum_two_ellipsoids,
)
from safe_exploration_tpu.ops.lipschitz import compute_remainder_overapproximations

__all__ = [
    "onestep_reachability_point",
    "onestep_reachability",
    "multistep_reachability",
]


def onestep_reachability_point(
    ssm: GPSSM,
    p: jax.Array,
    k_ff: jax.Array,
    a: jax.Array,
    b: jax.Array,
    c_safety: float | jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reachable ellipsoid after one step from a POINT state (q = None case).

    Parity: reference ``gp_reachability.py::onestep_reachability`` with
    ``q is None`` (SURVEY.md §2.4 item 3).

    Returns (p_next (n_s,), q_next (n_s, n_s), var (n_s,)).
    """
    mu, var = ssm_predict(ssm, p, k_ff)
    p_next = a @ p + b @ k_ff + mu
    # predictive (latent + observation-noise) std: the tube must cover process
    # noise, which the fitted GP noise subsumes (see ssm_noise_var docstring)
    q_next = ellipsoid_from_rectangle(c_safety * jnp.sqrt(var + ssm_noise_var(ssm)))
    return p_next, q_next, var


def onestep_reachability(
    ssm: GPSSM,
    p: jax.Array,
    q: jax.Array,
    k_ff: jax.Array,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    c_safety: float | jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reachable ellipsoid after one closed-loop step from E(p, Q).

    Args:
      ssm: GP state-space model (carries l_mu / l_sigma).
      p: (n_s,) center.  q: (n_s, n_s) PSD shape.
      k_ff: (n_u,) feed-forward control at the center.
      k_fb: (n_u, n_s) feedback gain, u = k_ff + k_fb (x - p).
      a, b: discrete-time prior model.
      c_safety: confidence scaling (beta).

    Returns (p_next, q_next, var) — parity: reference
    ``gp_reachability.py::onestep_reachability`` (SURVEY.md §2.4 item 4).
    """
    mu, var, j_x, j_u = ssm_predict_jac(ssm, p, k_ff)
    p_next = a @ p + b @ k_ff + mu

    h = a + j_x + (b + j_u) @ k_fb
    q_lin = h @ q @ h.T

    u_mu, u_sigma = compute_remainder_overapproximations(q, k_fb, ssm.l_mu, ssm.l_sigma)
    q_taylor = ellipsoid_from_rectangle(u_mu)
    q_conf = ellipsoid_from_rectangle(
        c_safety * (jnp.sqrt(var + ssm_noise_var(ssm)) + u_sigma)
    )

    zero = jnp.zeros_like(p)
    p_sum, q_sum = sum_two_ellipsoids(p_next, q_lin, zero, q_conf)
    p_out, q_out = sum_two_ellipsoids(p_sum, q_sum, zero, q_taylor)
    return p_out, q_out, var


def multistep_reachability(
    ssm: GPSSM,
    p0: jax.Array,
    k_ff_all: jax.Array,
    k_fb_all: jax.Array,
    a: jax.Array,
    b: jax.Array,
    c_safety: float | jax.Array,
    q0: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fold the one-step map over a horizon with per-stage controls.

    The horizon is a ``lax.scan`` — the compiled replacement for the
    reference's symbolically-unrolled CasADi loop (SURVEY.md §3.1) and its
    Python loop in numpy/torch.

    Args:
      p0: (n_s,) initial state (point, unless q0 given).
      k_ff_all: (T, n_u) per-stage feed-forward.
      k_fb_all: (T, n_u, n_s) per-stage feedback (stage 0's is unused when
        starting from a point).
      q0: optional initial ellipsoid shape.

    Returns:
      (p_traj (T, n_s), q_traj (T, n_s, n_s), var_traj (T, n_s)) — the predicted
      tube, stage t index = state after t+1 steps.
    """
    if q0 is None:
        p1, q1, var1 = onestep_reachability_point(
            ssm, p0, k_ff_all[0], a, b, c_safety
        )
        k_rest, kfb_rest = k_ff_all[1:], k_fb_all[1:]
    else:
        p1, q1, var1 = onestep_reachability(
            ssm, p0, q0, k_ff_all[0], k_fb_all[0], a, b, c_safety
        )
        k_rest, kfb_rest = k_ff_all[1:], k_fb_all[1:]

    def body(carry, inp):
        p, q = carry
        k_ff, k_fb = inp
        p_n, q_n, var = onestep_reachability(ssm, p, q, k_ff, k_fb, a, b, c_safety)
        return (p_n, q_n), (p_n, q_n, var)

    # unroll: the horizon is short (T <= ~10) and the body is many small ops;
    # unrolling lets XLA fuse across stages instead of executing the rolled
    # body's thunks T times (the batched SQP is a chain of many small ops,
    # bound by their count rather than by FLOPs)
    (_, _), (ps, qs, vars_) = jax.lax.scan(
        body, (p1, q1), (k_rest, kfb_rest), unroll=True
    )
    p_traj = jnp.concatenate([p1[None], ps], axis=0)
    q_traj = jnp.concatenate([q1[None], qs], axis=0)
    var_traj = jnp.concatenate([var1[None], vars_], axis=0)
    return p_traj, q_traj, var_traj
