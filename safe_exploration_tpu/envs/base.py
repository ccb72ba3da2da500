"""Environment substrate: continuous-control plants as pure JAX functions.

Parity target: reference ``environments.py::Environment`` ABC (SURVEY.md §2.7) —
``reset``, ``step`` (ODE integration + additive process noise),
``linearize_discretize`` (discrete-time prior (a, b)), polytopic safe/state
constraint sets, normalization fields.

Functional re-design: an environment is a STATIC dynamics function plus a pytree
``EnvSpec`` of physical/safety parameters. Everything is pure: ``env_step`` takes
an explicit PRNG key, integrates one control interval with fixed-step RK4 (inside
``lax.scan``-able callers) and adds process noise — replacing the reference's
scipy/Fortran integrator (SURVEY.md §2.10) with compiler-friendly straight-line
arithmetic that vmaps across 256 episodes (BASELINE config 3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from safe_exploration_tpu.ops.linalg import expm_discretize
from safe_exploration_tpu.utils import struct

__all__ = ["EnvSpec", "Env", "env_reset", "env_step", "linearize_discretize",
           "rk4_step", "normalize_state", "unnormalize_state",
           "normalize_control", "unnormalize_control"]

DynamicsFn = Callable[[jax.Array, jax.Array], jax.Array]  # (x, u) -> xdot


@struct.dataclass
class EnvSpec:
    """Physical + safety parameters of a plant (a pytree; dynamics fn is static).

    Fields mirror the reference Environment attributes (SURVEY.md §2.7):
    ``h_mat_safe x <= h_safe`` is the terminal/safe polytope, ``h_mat_obs x <=
    h_obs`` the per-stage state constraints.
    """

    dt: jax.Array              # control interval
    init_m: jax.Array          # (n_s,) mean initial state
    init_std: jax.Array        # (n_s,) std of initial state
    u_min: jax.Array           # (n_u,)
    u_max: jax.Array           # (n_u,)
    plant_noise: jax.Array     # (n_s,) std of additive process noise per step
    target: jax.Array          # (n_s,) task target state
    h_mat_safe: jax.Array      # (m_safe, n_s)
    h_safe: jax.Array          # (m_safe,)
    h_mat_obs: jax.Array       # (m_obs, n_s)
    h_obs: jax.Array           # (m_obs,)
    norm_x: jax.Array          # (n_s,) state normalization scales
    norm_u: jax.Array          # (n_u,) control normalization scales

    @property
    def n_s(self) -> int:
        return self.init_m.shape[0]

    @property
    def n_u(self) -> int:
        return self.u_min.shape[0]


class Env(NamedTuple):
    """An environment = static dynamics + parameter pytree.

    NamedTuple (not a pytree dataclass) on purpose: ``dynamics`` is a function
    and must stay static under jit; pass ``env.spec`` through traced code.
    """

    dynamics: DynamicsFn
    spec: EnvSpec
    name: str
    n_substeps: int = 8  # RK4 substeps per control interval


def rk4_step(dynamics: DynamicsFn, x: jax.Array, u: jax.Array, h: jax.Array) -> jax.Array:
    """One classical Runge-Kutta 4 step of size h (zero-order-hold control)."""
    k1 = dynamics(x, u)
    k2 = dynamics(x + 0.5 * h * k1, u)
    k3 = dynamics(x + 0.5 * h * k2, u)
    k4 = dynamics(x + h * k3, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _integrate(env: Env, x: jax.Array, u: jax.Array) -> jax.Array:
    h = env.spec.dt / env.n_substeps

    def body(_, xc):
        return rk4_step(env.dynamics, xc, u, h)

    return jax.lax.fori_loop(0, env.n_substeps, body, x)


def env_reset(env: Env, key: jax.Array) -> jax.Array:
    """Sample an initial state. Parity: ``Environment.reset`` (SURVEY.md §2.7)."""
    s = env.spec
    return s.init_m + s.init_std * jax.random.normal(key, s.init_m.shape, s.init_m.dtype)


def env_step(
    env: Env, key: jax.Array, x: jax.Array, u: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Apply clipped control for one interval; return (u_applied, x_next).

    RK4 sub-stepped integration + additive Gaussian process noise
    (``plant_noise`` std). Parity: ``Environment.step`` (SURVEY.md §2.7).
    """
    s = env.spec
    u_app = jnp.clip(u, s.u_min, s.u_max)
    x_next = _integrate(env, x, u_app)
    noise = s.plant_noise * jax.random.normal(key, x.shape, x.dtype)
    return u_app, x_next + noise


def linearize_discretize(
    env: Env, x_eq: jax.Array | None = None, u_eq: jax.Array | None = None
) -> tuple[jax.Array, jax.Array]:
    """Discrete-time prior (a, b): exact ZOH discretization of the Jacobian
    linearization at (x_eq, u_eq) (defaults: target state, zero control).

    Parity: ``Environment.linearize_discretize`` (SURVEY.md §2.7); Jacobians via
    ``jax.jacfwd`` replace the reference's handwritten ``_jac_dynamics``.
    """
    s = env.spec
    if x_eq is None:
        x_eq = s.target
    if u_eq is None:
        u_eq = jnp.zeros((s.n_u,), x_eq.dtype)
    a_c = jax.jacfwd(lambda xx: env.dynamics(xx, u_eq))(x_eq)
    b_c = jax.jacfwd(lambda uu: env.dynamics(x_eq, uu))(u_eq)
    return expm_discretize(a_c, b_c, s.dt)


def normalize_state(spec: EnvSpec, x: jax.Array) -> jax.Array:
    """States scaled to ~[-1, 1] by the spec's ``norm_x``.

    Parity: reference ``Environment.normalize`` (SURVEY.md §2.7) — the
    reference trains its GP on normalized inputs; here normalization is an
    explicit pure op callers apply when conditioning is an issue.
    """
    return x / spec.norm_x


def unnormalize_state(spec: EnvSpec, x: jax.Array) -> jax.Array:
    return x * spec.norm_x


def normalize_control(spec: EnvSpec, u: jax.Array) -> jax.Array:
    return u / spec.norm_u


def unnormalize_control(spec: EnvSpec, u: jax.Array) -> jax.Array:
    return u * spec.norm_u


def box_polytope(lo: jax.Array, hi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """H-representation of an axis-aligned box {lo <= x <= hi}: (H, h) with Hx<=h."""
    n = lo.shape[0]
    eye = jnp.eye(n, dtype=lo.dtype)
    h_mat = jnp.concatenate([eye, -eye], axis=0)
    h_vec = jnp.concatenate([hi, -lo], axis=0)
    return h_mat, h_vec
