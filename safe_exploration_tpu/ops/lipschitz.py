"""Lipschitz-based over-approximation of GP linearization remainders.

This is the analytic heart of the safety argument (Koller et al., CDC'18, Lemma 2 /
arXiv:1906.12189): the error of the first-order Taylor expansion of the GP mean and
the growth of the predictive standard deviation over a state-action ellipsoid are
bounded using Lipschitz constants of the mean's gradient (``l_mu``) and of the
std (``l_sigma``).

Given a state ellipsoid E(0, Q) under linear feedback ``u = k_fb x``, the
state-action lift is ``S = [I; k_fb]`` and the lifted set is ``S E(0, Q)``. Its
squared max radius is

    r^2 = max_{x in E} ||S x||^2 = lambda_max(S Q S^T) = lambda_max(Q S^T S).

Per output dimension i the remainder boxes have half-widths

    u_mu_i    = 0.5 * l_mu_i    * r^2          (quadratic Taylor remainder)
    u_sigma_i = l_sigma_i * r                  (std growth)

Parity: reference ``utils.py::compute_remainder_overapproximations`` (numpy) and
``utils_casadi.py::compute_remainder_overapproximations`` + ``matrix_norm_2``
(power iteration) — SURVEY.md §2.2. Here ONE implementation serves both the eager
and in-solver (jit/grad) paths; the dominant eigenvalue is computed by a
fixed-iteration power method, which is jit-able, vmap-able and differentiable —
exactly the role the reference's CasADi power iteration plays inside IPOPT.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["max_eig_psd_product", "compute_remainder_overapproximations"]


def max_eig_psd_product(m: jax.Array, iters: int = 30) -> jax.Array:
    """Dominant eigenvalue of ``M = Q B`` where Q, B are PSD.

    M is similar to the symmetric PSD matrix ``Q^{1/2} B Q^{1/2}``, so its
    spectrum is real and nonnegative. This sits on the reachability hot path:
    the SQP forward-differentiates it per stage per Newton iteration, and a
    plain 30-step power iteration (the reference's ``matrix_norm_2``
    approach, SURVEY.md §2.2) is 30 SEQUENTIAL tiny matvecs, each dragging a
    tangent batch along under jvp — a large share of solve time in the
    profile of the accelerator the solver was first tuned on. Two
    replacements, both static-shaped and differentiable:

      * n == 2: the characteristic-polynomial CLOSED FORM
        lambda_max = (tr + sqrt(tr^2 - 4 det)) / 2 (real spectrum) — a
        handful of fused scalar ops, exact.
      * n >= 3: REPEATED-SQUARING power iteration. M is normalized by
        tr(M)/n (for a nonnegative spectrum, tr/n <= lambda_max <= tr, so
        the normalized dominant eigenvalue lies in [1, n] — no under/overflow
        under squaring), squared ``k`` times (each squaring doubles the
        spectral-gap exponent), then refined with a few matvecs of M^(2^k);
        3 squarings + 4 matvecs converge like ~32 plain iterations at ~1/7th
        the sequential depth. The final Rayleigh quotient is taken on the
        ORIGINAL M, so the value is exact at convergence and its derivative
        is the standard eigenvalue derivative.

    ``iters`` keeps its meaning as the effective plain-iteration budget.
    """
    n = m.shape[-1]
    dtype = m.dtype
    if n == 1:
        return jnp.maximum(m[0, 0], 0.0)
    if n == 2:
        tr = m[0, 0] + m[1, 1]
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
        return jnp.maximum(0.5 * (tr + disc), 0.0)

    # Deterministic non-degenerate start vector (no RNG inside the solver graph).
    v0 = jnp.ones((n,), dtype) + 1e-3 * jnp.arange(n, dtype=dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    scale = jnp.trace(m) / n + 1e-30
    mn = m / scale
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):  # static unroll: M^2, M^4, M^8
        mn = mn @ mn
        # keep entries bounded across squarings (eigs of mn are in [1, n]
        # after trace normalization, but renormalize defensively anyway)
        mn = mn / (jnp.trace(mn) / n + 1e-30)

    def body(_, v):
        w = mn @ v
        return w / (jnp.linalg.norm(w) + 1e-30)

    v = jax.lax.fori_loop(0, n_refine, body, v0)
    mv = m @ v
    return jnp.maximum(jnp.dot(v, mv) / (jnp.dot(v, v) + 1e-30), 0.0)


def compute_remainder_overapproximations(
    q: jax.Array,
    k_fb: jax.Array,
    l_mu: jax.Array,
    l_sigma: jax.Array,
    *,
    iters: int = 30,
) -> tuple[jax.Array, jax.Array]:
    """Box half-widths bounding the GP linearization remainders over an ellipsoid.

    Args:
      q: (n_s, n_s) PSD shape matrix of the state ellipsoid.
      k_fb: (n_u, n_s) feedback gain (u = k_ff + k_fb (x - p)).
      l_mu: (n_out,) Lipschitz constants of the GP mean gradient per output dim.
      l_sigma: (n_out,) Lipschitz constants of the predictive std per output dim.
      iters: power-iteration count for the dominant eigenvalue.

    Returns:
      (u_mu, u_sigma): (n_out,) box half-widths.

    Parity: reference ``utils.py::compute_remainder_overapproximations``
    (SURVEY.md §2.2); constants 0.5*l_mu*r^2 and l_sigma*r follow the papers.
    """
    n_s = q.shape[-1]
    s = jnp.concatenate([jnp.eye(n_s, dtype=q.dtype), k_fb], axis=0)  # (n_s+n_u, n_s)
    b = s.T @ s  # (n_s, n_s) = S^T S
    r_sqr = max_eig_psd_product(q @ b, iters=iters)
    u_mu = 0.5 * l_mu * r_sqr
    u_sigma = l_sigma * jnp.sqrt(r_sqr)
    return u_mu, u_sigma
