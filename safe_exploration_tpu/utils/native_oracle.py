"""ctypes loader for the native f64 verification oracle (native/oracle.cpp).

The oracle is an independent C++ implementation of the framework's core
numerics; the test suite uses it as a cross-language gold standard
(tests/test_native_oracle.py) — this framework's analog of the reference's
numpy-vs-CasADi-vs-torch equivalence testing (SURVEY.md §4.1), with the
reference's external native layer (LAPACK, CasADi C++ — SURVEY.md §2.10)
replaced by first-party code.

The shared library is built on demand with ``make`` (g++ is part of the
toolchain); callers that cannot build (no compiler) get ``None`` from
:func:`load_oracle` and should skip.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

__all__ = ["load_oracle", "NativeOracle"]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB = _NATIVE_DIR / "liboracle.so"

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _stale() -> bool:
    src = _NATIVE_DIR / "oracle.cpp"
    return (
        not _LIB.exists()
        or (src.exists() and src.stat().st_mtime > _LIB.stat().st_mtime)
    )


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "-B", "liboracle.so"], cwd=_NATIVE_DIR, check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


class NativeOracle:
    """Thin typed wrapper over the C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.ellipsoid_sum.argtypes = [_D, _D, _D, _D, ctypes.c_int, _D, _D]
        lib.ellipsoid_from_rect.argtypes = [_D, ctypes.c_int, _D]
        lib.remainder_overapprox.argtypes = [
            _D, _D, _D, _D, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _D, _D,
        ]
        lib.cholesky.argtypes = [_D, ctypes.c_int, _D]
        lib.cholesky.restype = ctypes.c_int
        lib.trsm_lower.argtypes = [_D, _D, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _D]
        lib.dare_sda.argtypes = [_D, _D, _D, _D, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _D]
        lib.dare_sda.restype = ctypes.c_int
        lib.rbf_posterior.argtypes = [
            _D, _D, _D, _D, _D, _D, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, _D, _D,
        ]
        lib.onestep_reachability.argtypes = [
            _D, _D, _D, _D, _D, _D, _D, _D, _D,            # GP: x..l_sigma
            _D, _D, _D, _D, _D, _D, ctypes.c_double,       # p q k_ff k_fb a b c
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _D, _D,
        ]

    @staticmethod
    def _c(x) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(x, dtype=np.float64))

    def ellipsoid_sum(self, p1, q1, p2, q2):
        p1, q1, p2, q2 = map(self._c, (p1, q1, p2, q2))
        n = p1.shape[0]
        p_out = np.empty(n)
        q_out = np.empty((n, n))
        self._lib.ellipsoid_sum(p1, q1, p2, q2, n, p_out, q_out)
        return p_out, q_out

    def ellipsoid_from_rect(self, ub):
        ub = self._c(ub)
        n = ub.shape[0]
        q = np.empty((n, n))
        self._lib.ellipsoid_from_rect(ub, n, q)
        return q

    def remainder_overapprox(self, q, k_fb, l_mu, l_sigma, iters=30):
        q, k_fb, l_mu, l_sigma = map(self._c, (q, k_fb, l_mu, l_sigma))
        n_s, n_u, n_out = q.shape[0], k_fb.shape[0], l_mu.shape[0]
        u_mu = np.empty(n_out)
        u_sigma = np.empty(n_out)
        self._lib.remainder_overapprox(
            q, k_fb, l_mu, l_sigma, n_s, n_u, n_out, iters, u_mu, u_sigma
        )
        return u_mu, u_sigma

    def cholesky(self, a):
        a = self._c(a)
        n = a.shape[0]
        l_out = np.empty((n, n))
        rc = self._lib.cholesky(a, n, l_out)
        if rc != 0:
            raise np.linalg.LinAlgError("matrix not positive definite")
        return l_out

    def trsm_lower(self, l, b, transpose=False):
        l = self._c(l)
        b = self._c(b)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        n, m = b2.shape
        x = np.empty((n, m))
        self._lib.trsm_lower(l, self._c(b2), n, m, int(transpose), x)
        return x[:, 0] if squeeze else x

    def dare_sda(self, a, b, q, r, iters=25):
        a, b, q, r = map(self._c, (a, b, q, r))
        n, m = b.shape
        x = np.empty((n, n))
        rc = self._lib.dare_sda(a, b, q, r, n, m, iters, x)
        if rc != 0:
            raise np.linalg.LinAlgError("DARE doubling iteration failed")
        return x

    def rbf_posterior(self, x, mask, beta, chol_l, z, lengthscales, sf2):
        x, mask, beta, chol_l, z, ls = map(
            self._c, (x, mask, beta, chol_l, z, lengthscales)
        )
        n, d = x.shape
        mean = np.empty(1)
        var = np.empty(1)
        self._lib.rbf_posterior(
            x, mask, beta, chol_l, z, ls, float(sf2), n, d, mean, var
        )
        return float(mean[0]), float(var[0])

    def onestep_reachability(self, x, mask, beta, chol, ls, sf2, noise,
                             l_mu, l_sigma, p, q, k_ff, k_fb, a, b, c_safety):
        """Full one-step ellipsoid reachability on an RBF multi-output GP —
        the composed end-to-end oracle (see oracle.cpp). Shapes: x (n, n_s+n_u),
        beta (n_s, n), chol (n_s, n, n), ls (n_s, n_s+n_u)."""
        args = list(map(
            self._c, (x, mask, beta, chol, ls, sf2, noise, l_mu, l_sigma,
                      p, q, k_ff, k_fb, a, b)
        ))
        n = args[0].shape[0]
        n_s = args[9].shape[0]
        n_u = args[11].shape[0]
        p_out = np.empty(n_s)
        q_out = np.empty((n_s, n_s))
        self._lib.onestep_reachability(
            *args, float(c_safety), n, n_s, n_u, p_out, q_out
        )
        return p_out, q_out


_cached: NativeOracle | None = None
_tried = False


def load_oracle() -> NativeOracle | None:
    """Build (if needed) and load the oracle; None if no toolchain."""
    global _cached, _tried
    if _cached is not None or _tried:
        return _cached
    _tried = True
    if _stale() and not _build():
        return None
    try:
        _cached = NativeOracle(ctypes.CDLL(str(_LIB)))
    except OSError:
        _cached = None
    return _cached
