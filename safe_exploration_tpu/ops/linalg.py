"""Numerical linear algebra for the control and GP stacks — jit-first.

Replaces the reference's LAPACK/scipy call sites (SURVEY.md §2.10):
  * ``scipy.linalg.solve_discrete_are`` (used by ``utils.py::dlqr``) -> a
    structure-preserving doubling algorithm (SDA) with a fixed iteration count,
    which is jit-able, vmap-able and accelerator-friendly (pure matmuls).
  * exact discretization of the Jacobian linearization (``environments.py::
    linearize_discretize``) -> augmented matrix exponential.
  * Cholesky-based PSD solves. (Incremental GP factor updates — bordered
    Cholesky extension + Schur block-inverse — live in models/gp.py::
    gp_append_point, the BASELINE-config-3 refit primitive.)

Everything here is static-shaped straight-line XLA; no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "dare_sda",
    "dlqr",
    "expm_discretize",
    "solve_psd_chol",
]


def dare_sda(
    a: jax.Array, b: jax.Array, q: jax.Array, r: jax.Array, *, iters: int = 25
) -> jax.Array:
    """Stabilizing solution X of the discrete algebraic Riccati equation

        X = A^T X A - A^T X B (R + B^T X B)^{-1} B^T X A + Q

    via the structure-preserving doubling algorithm (quadratically convergent):

        A_{k+1} = A_k (I + G_k H_k)^{-1} A_k
        G_{k+1} = G_k + A_k (I + G_k H_k)^{-1} G_k A_k^T
        H_{k+1} = H_k + A_k^T H_k (I + G_k H_k)^{-1} A_k,     H_k -> X

    with A_0 = A, G_0 = B R^{-1} B^T, H_0 = Q. 25 doublings ≈ 2^25 implicit QZ
    steps — far past f64 convergence for the small (n <= ~12) control matrices of
    this domain. This is the jit-compiled replacement for scipy's
    ``solve_discrete_are`` (Fortran), per SURVEY.md §7.

    Oracle test: tests/test_linalg.py checks the DARE residual and agreement with
    ``scipy.linalg.solve_discrete_are`` in f64.
    """
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    g0 = b @ jnp.linalg.solve(r, b.T)

    def body(_, carry):
        ak, gk, hk = carry
        w = jnp.linalg.solve(eye + gk @ hk, ak)  # (I + G H)^{-1} A
        wg = jnp.linalg.solve(eye + gk @ hk, gk)  # (I + G H)^{-1} G
        a_next = ak @ w
        g_next = gk + ak @ wg @ ak.T
        h_next = hk + ak.T @ hk @ w
        # Symmetrize to kill accumulated drift.
        g_next = 0.5 * (g_next + g_next.T)
        h_next = 0.5 * (h_next + h_next.T)
        return a_next, g_next, h_next

    _, _, h = jax.lax.fori_loop(0, iters, body, (a, g0, q))
    return h


def dlqr(
    a: jax.Array, b: jax.Array, q: jax.Array, r: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Discrete-time LQR gain.

    Returns (K, P) with ``u = -K x`` optimal for cost sum x'Qx + u'Ru, i.e.
    ``K = (R + B^T P B)^{-1} B^T P A`` where P solves the DARE.

    Parity: reference ``utils.py::dlqr`` (SURVEY.md §2.2) — the safe-MPC uses the
    NEGATED gain as its per-stage feedback, ``k_fb = -K`` (SURVEY.md §2.5).
    """
    p = dare_sda(a, b, q, r)
    k = jnp.linalg.solve(r + b.T @ p @ b, b.T @ p @ a)
    return k, p


def expm_discretize(
    a_cont: jax.Array, b_cont: jax.Array, dt: float
) -> tuple[jax.Array, jax.Array]:
    """Exact zero-order-hold discretization of ``xdot = A x + B u``.

    Uses the standard augmented-matrix exponential
    ``expm(dt * [[A, B], [0, 0]]) = [[Ad, Bd], [0, I]]``.

    Parity: reference ``environments.py::linearize_discretize`` (SURVEY.md §2.7).
    """
    n_s = a_cont.shape[-1]
    n_u = b_cont.shape[-1]
    m = jnp.zeros((n_s + n_u, n_s + n_u), dtype=a_cont.dtype)
    m = m.at[:n_s, :n_s].set(a_cont)
    m = m.at[:n_s, n_s:].set(b_cont)
    em = jax.scipy.linalg.expm(m * dt)
    return em[:n_s, :n_s], em[:n_s, n_s:]


def solve_psd_chol(chol_l: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve ``(L L^T) x = rhs`` given the lower Cholesky factor L."""
    y = jax.scipy.linalg.solve_triangular(chol_l, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(chol_l.T, y, lower=False)


