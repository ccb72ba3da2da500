"""Float-float (double-word f32) arithmetic — fp64-equivalent accumulation
from f32 operations only.

The mode was built for hardware without an f64 unit (SURVEY.md §7 "numerics
policy" / BASELINE north star "bitwise-stable Cholesky at fp64-equivalent
tolerance"); ROADMAP C2 replaces it with native f64. A float-float number
represents a value as an unevaluated sum ``hi + lo`` with |lo| <= ulp(hi)/2,
giving ~49 mantissa bits — f64-class precision — out of pairs of f32s, using
only error-free transformations (EFTs):

  * two_sum   (Knuth):   a + b        = s + err   exactly
  * split     (Dekker):  x            = x_hi + x_lo, 12-bit halves
  * two_prod  (Dekker):  a * b        = p + err   exactly (via split products)

All ops are branch-free elementwise arithmetic — they jit, vmap, and work
inside lax loops. XLA must not re-associate these sums: the module relies on
jax's default strict float semantics (no fast-math). chip_smoke.py checks the
Cholesky against f64 on the GPU.

Used by :func:`safe_exploration_tpu.ops.ff.cholesky_ff` — the high-precision
factorization mode validated against the f64 oracle in tests/test_ff.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["FF", "ff", "two_sum", "two_prod", "ff_add", "ff_sub", "ff_mul",
           "ff_div", "ff_sqrt", "ff_neg", "ff_to_f32", "cholesky_ff",
           "trsm_ff", "gp_factors_ff"]

# Dekker split constant for f32: 2^12 + 1 (splits 24-bit mantissa into 12+12)
_SPLIT = jnp.float32(4097.0)


class FF(NamedTuple):
    """A float-float value/array: value = hi + lo (unevaluated)."""

    hi: jax.Array
    lo: jax.Array


def ff(x) -> FF:
    """Lift an f32 array to float-float (exact)."""
    x = jnp.asarray(x, jnp.float32)
    return FF(x, jnp.zeros_like(x))


def two_sum(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Knuth two-sum: s + err == a + b exactly (no branch on magnitudes)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dekker split: x == x_hi + x_lo, each with <= 12 mantissa bits."""
    c = _SPLIT * x
    x_hi = c - (c - x)
    return x_hi, x - x_hi


def two_prod(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dekker product: p + err == a * b exactly (split partial products)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def ff_add(x: FF, y: FF) -> FF:
    """Double-word addition (sloppy variant — sufficient for same-sign
    accumulation; ~2 ulp of the 49-bit format)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = two_sum(s, e)
    return FF(hi, lo)


def ff_neg(x: FF) -> FF:
    return FF(-x.hi, -x.lo)


def ff_sub(x: FF, y: FF) -> FF:
    return ff_add(x, ff_neg(y))


def ff_mul(x: FF, y: FF) -> FF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = two_sum(p, e)
    return FF(hi, lo)


def ff_div(x: FF, y: FF) -> FF:
    """Newton-corrected double-word division."""
    q1 = x.hi / y.hi
    # r = x - q1 * y  (computed in ff)
    r = ff_sub(x, ff_mul(FF(q1, jnp.zeros_like(q1)), y))
    q2 = (r.hi + r.lo) / y.hi
    hi, lo = two_sum(q1, q2)
    return FF(hi, lo)


def ff_sqrt(x: FF) -> FF:
    """Double-word square root via one Newton/Heron correction."""
    s1 = jnp.sqrt(jnp.maximum(x.hi, 0.0))
    safe = jnp.where(s1 > 0, s1, 1.0)
    # r = x - s1^2 (ff); correction = r / (2 s1)
    r = ff_sub(x, ff_mul(FF(s1, jnp.zeros_like(s1)), FF(s1, jnp.zeros_like(s1))))
    c = (r.hi + r.lo) / (2.0 * safe)
    c = jnp.where(s1 > 0, c, 0.0)
    hi, lo = two_sum(s1, c)
    return FF(hi, lo)


def ff_to_f32(x: FF) -> jax.Array:
    return x.hi + x.lo


def cholesky_ff(a: jax.Array) -> FF:
    """Right-looking Cholesky of an f32 SPD matrix with float-float arithmetic.

    Every intermediate (Schur-complement entries, divisions, square roots) is
    carried as a double-word pair, so the factor is accurate to ~2^-45 relative
    — fp64-equivalent for the condition numbers of jittered Gram matrices —
    while touching only f32 hardware ops. O(n^2) elementwise rank-1 updates
    per step (no matmul units: EFT products need every rounding explicit).

    Returns the factor as an :class:`FF` pair; ``ff_to_f32`` rounds to f32.
    It is the BASELINE north star's "fp64-equivalent tolerance" mode; use it
    for the correctness-critical refits, not the vmapped solver hot loop.
    """
    n = a.shape[-1]
    rows = jnp.arange(n)

    def body(j, carry):
        s_hi, s_lo, l_hi, l_lo = carry
        s = FF(s_hi, s_lo)
        d = ff_sqrt(FF(s_hi[j, j], s_lo[j, j]))
        col = ff_div(FF(s_hi[:, j], s_lo[:, j]), d)
        below = rows > j
        col = FF(jnp.where(below, col.hi, 0.0), jnp.where(below, col.lo, 0.0))
        col = FF(col.hi.at[j].set(d.hi), col.lo.at[j].set(d.lo))
        l_hi = l_hi.at[:, j].set(col.hi)
        l_lo = l_lo.at[:, j].set(col.lo)
        # rank-1 downdate S -= col col^T in ff
        outer = ff_mul(FF(col.hi[:, None], col.lo[:, None]),
                       FF(col.hi[None, :], col.lo[None, :]))
        s = ff_sub(s, outer)
        return s.hi, s.lo, l_hi, l_lo

    z = jnp.zeros_like(a)
    _, _, l_hi, l_lo = jax.lax.fori_loop(
        0, n, body, (jnp.asarray(a, jnp.float32), z, z, z)
    )
    return FF(l_hi, l_lo)


def trsm_ff(l: FF, b, *, transpose: bool = False) -> FF:
    """Double-word triangular solve ``L x = b`` (or ``L^T x = b``).

    Forward/back substitution with every intermediate carried as an FF pair
    — O(n^2) elementwise work, used by the ``precision="ff"`` GP refit mode
    (fp64-equivalent posterior factors from f32 operations).
    """
    n = l.hi.shape[0]
    bf = b if isinstance(b, FF) else ff(jnp.asarray(b, jnp.float32))

    def row(i):
        return (l.hi[i, :], l.lo[i, :]) if not transpose else (
            l.hi[:, i], l.lo[:, i]
        )

    def body(k, x):
        i = k if not transpose else n - 1 - k
        r_hi, r_lo = row(i)
        # s = b_i - sum_j!=i L_ij x_j  (x is zero where not yet computed)
        prod = ff_mul(FF(r_hi, r_lo), x)
        mask = jnp.arange(n) != i
        prod = FF(jnp.where(mask, prod.hi, 0.0), jnp.where(mask, prod.lo, 0.0))

        def acc_body(j, acc):
            return ff_add(acc, FF(prod.hi[j], prod.lo[j]))

        zero = FF(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
        s = jax.lax.fori_loop(0, n, acc_body, zero)
        rhs = ff_sub(FF(bf.hi[i], bf.lo[i]), s)
        d = FF(l.hi[i, i], l.lo[i, i])
        xi = ff_div(rhs, d)
        return FF(x.hi.at[i].set(xi.hi), x.lo.at[i].set(xi.lo))

    x0 = FF(jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
    return jax.lax.fori_loop(0, n, body, x0)


def gp_factors_ff(k: jax.Array, y: jax.Array):
    """fp64-equivalent GP posterior factors from an f32 Gram matrix.

    Returns (chol_f32, beta_f32, kinv_f32): the double-word Cholesky, the
    two ff triangular solves for beta = K^{-1} y, and K^{-1} built column-by-
    column from ff solves against the identity — all rounded to f32 at the
    END, so the only f32 error left is the final storage rounding (~1e-7
    relative) instead of the factorization's eps*k(K) accumulation. This is
    the ``precision="ff"`` refit mode (BASELINE north star: bitwise-stable
    Cholesky at fp64-equivalent tolerance).
    """
    lff = cholesky_ff(k)
    z = trsm_ff(lff, y)
    beta = trsm_ff(lff, z, transpose=True)

    n = k.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float32)

    def col(e):
        w = trsm_ff(lff, e)
        v = trsm_ff(lff, w, transpose=True)
        return ff_to_f32(v)

    kinv = jax.vmap(col, in_axes=1, out_axes=1)(eye)
    # symmetrize the storage rounding
    kinv = 0.5 * (kinv + kinv.T)
    return ff_to_f32(lff), ff_to_f32(beta), kinv
