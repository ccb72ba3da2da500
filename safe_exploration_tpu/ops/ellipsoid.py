"""Ellipsoid calculus — the geometric substrate of the safety engine.

An ellipsoid is represented by a center ``p`` in R^n and a PSD shape matrix ``Q``:

    E(p, Q) = { x : (x - p)^T Q^{-1} (x - p) <= 1 }.

Capability parity with the reference's ``safe_exploration/utils_ellipsoid.py`` and
its CasADi mirror ``utils_ellipsoid_casadi.py`` (SURVEY.md §2.1) — here a single
pure-JAX implementation serves the eager, jitted, differentiated and vmapped paths.

All functions are shape-polymorphic in the state dimension n and contain no Python
control flow on traced values, so they compile to straight-line XLA (fused
elementwise ops — these matrices are tiny, n <= ~12; the matmul work lives in the
GP kernels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "sum_two_ellipsoids",
    "ellipsoid_from_rectangle",
    "sample_inside_ellipsoid",
    "distance_to_center",
    "is_psd_trace_bounded",
]


def sum_two_ellipsoids(
    p1: jax.Array, q1: jax.Array, p2: jax.Array, q2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Trace-minimal outer ellipsoidal approximation of the Minkowski sum
    ``E(p1, Q1) ⊕ E(p2, Q2)``.

    For any c > 0, ``E(p1+p2, (1 + 1/c) Q1 + (1 + c) Q2)`` contains the Minkowski
    sum (Kurzhanski/Valyi). The trace of the shape matrix is minimized by
    ``c = sqrt(tr(Q1) / tr(Q2))``, giving the minimal trace
    ``(sqrt(tr Q1) + sqrt(tr Q2))^2``.

    Parity: reference ``utils_ellipsoid.py::sum_two_ellipsoids`` (SURVEY.md §2.1).

    Args:
      p1, p2: centers, shape (n,).
      q1, q2: PSD shape matrices, shape (n, n).

    Returns:
      (p, Q): center and shape of the over-approximating ellipsoid.
    """
    eps = jnp.asarray(1e-30, q1.dtype)
    t1 = jnp.trace(q1) + eps
    t2 = jnp.trace(q2) + eps
    c = jnp.sqrt(t1 / t2)
    p = p1 + p2
    q = (1.0 + 1.0 / c) * q1 + (1.0 + c) * q2
    return p, q


def ellipsoid_from_rectangle(ub: jax.Array) -> jax.Array:
    """Tight axis-aligned ellipsoid covering the box ``[-ub, ub]^n``.

    ``Q = diag(n * ub_i^2)``: the box corners x with |x_i| = ub_i satisfy
    sum_i x_i^2 / (n ub_i^2) = 1, i.e. corners lie ON the ellipsoid, so this is the
    minimal axis-aligned dilation covering the box.

    Parity: reference ``utils_ellipsoid.py::ellipsoid_from_rectangle``.

    Args:
      ub: box half-widths, shape (n,), must be >= 0.

    Returns:
      Q: (n, n) diagonal PSD shape matrix.
    """
    n = ub.shape[-1]
    return jnp.diag(jnp.asarray(n, ub.dtype) * ub * ub)


def sample_inside_ellipsoid(
    key: jax.Array, num: int, p: jax.Array, q: jax.Array
) -> jax.Array:
    """Sample ``num`` points uniformly inside E(p, Q).

    Uniform-in-ball (Gaussian direction x radius^(1/n)) pushed through the
    Cholesky factor of Q.

    Parity: reference ``utils_ellipsoid.py::sample_inside_ellipsoid`` (used by the
    containment tests and the MC uncertainty-validation runner, SURVEY.md §2.8).
    """
    n = p.shape[-1]
    k_dir, k_rad = jax.random.split(key)
    g = jax.random.normal(k_dir, (num, n), dtype=p.dtype)
    direction = g / jnp.linalg.norm(g, axis=-1, keepdims=True)
    radius = jax.random.uniform(k_rad, (num, 1), dtype=p.dtype) ** (1.0 / n)
    ball = direction * radius
    chol = jnp.linalg.cholesky(q + 1e-12 * jnp.eye(n, dtype=q.dtype))
    return ball @ chol.T + p


def distance_to_center(samples: jax.Array, p: jax.Array, q: jax.Array) -> jax.Array:
    """Squared Mahalanobis distance ``(x - p)^T Q^{-1} (x - p)`` per sample.

    A point is inside E(p, Q) iff the returned value is <= 1.

    Parity: reference ``utils_ellipsoid.py::distance_to_center``.

    Args:
      samples: (m, n) points.
      p: (n,) center.   q: (n, n) PSD shape.

    Returns:
      (m,) distances.
    """
    d = samples - p
    sol = jnp.linalg.solve(q, d.T)  # (n, m)
    return jnp.sum(d.T * sol, axis=0)


def is_psd_trace_bounded(q: jax.Array, bound: float) -> jax.Array:
    """Cheap sanity predicate used in debug assertions: symmetric + trace bound."""
    sym = jnp.max(jnp.abs(q - q.T)) < 1e-6 * (1.0 + jnp.max(jnp.abs(q)))
    return jnp.logical_and(sym, jnp.trace(q) <= bound)
