"""GP covariance kernels — single JAX implementation of the reference's kernel menu.

The reference keeps TWO kernel implementations in sync: GPy kernel objects for
training/eager prediction (``ssm_gpy/gaussian_process.py``) and handwritten CasADi
symbolic mirrors for embedding the posterior in the IPOPT NLP
(``gp_models_utils_casadi.py::_k_rbf/_k_lin/...``) — SURVEY.md §2.3. Here one pure
function per kernel serves eager, jitted, differentiated and vmapped callers.

Kernel menu (parity with reference ``kern_types``): ``rbf``, ``lin``, ``mat52``,
and the composites ``lin_rbf``, ``lin_mat52`` (sum kernels).

All hyperparameters live in log-space so unconstrained gradient optimization of the
marginal likelihood is well-posed. Params are plain dicts (pytrees), one per output
dimension.

Gram construction is pure batched arithmetic — XLA maps the pairwise-distance and
matmul forms onto its matmul kernels; the large-N path additionally has a sharded
path (parallel/).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "KERNELS",
    "init_kernel_params",
    "gram",
    "kernel_fn",
    "kernel_diag",
    "weighted_mean_jac",
    "rbf_mean_gradient_lipschitz",
]


def _sq_dists(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Pairwise squared distances, (n1, d) x (n2, d) -> (n1, n2).

    Uses the ||a||^2 + ||b||^2 - 2ab matmul form; clamped at 0 to
    kill negative round-off.
    """
    n1 = jnp.sum(x1 * x1, axis=-1, keepdims=True)
    n2 = jnp.sum(x2 * x2, axis=-1, keepdims=True)
    d2 = n1 + n2.T - 2.0 * (x1 @ x2.T)
    return jnp.maximum(d2, 0.0)


def _k_rbf(params: dict, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Squared-exponential (ARD): sigma_f^2 exp(-0.5 sum_d (dx_d / l_d)^2).

    Parity: reference ``gp_models_utils_casadi.py::_k_rbf`` / GPy ``RBF(ARD=True)``.
    """
    ls = jnp.exp(params["log_lengthscales"])
    var = jnp.exp(2.0 * params["log_sf"])
    d2 = _sq_dists(x1 / ls, x2 / ls)
    return var * jnp.exp(-0.5 * d2)


def _k_lin(params: dict, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Linear (ARD): sum_d v_d x1_d x2_d.

    Parity: reference ``gp_models_utils_casadi.py::_k_lin`` / GPy ``Linear``.
    """
    v = jnp.exp(2.0 * params["log_sv"])
    return (x1 * v) @ x2.T


def _k_mat52(params: dict, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Matern 5/2 (ARD).

    Parity: reference ``gp_models_utils_casadi.py::_k_mat52`` / GPy ``Matern52``.
    """
    ls = jnp.exp(params["log_lengthscales"])
    var = jnp.exp(2.0 * params["log_sf"])
    d = jnp.sqrt(_sq_dists(x1 / ls, x2 / ls) + 1e-30)
    s5 = jnp.sqrt(5.0).astype(d.dtype)
    return var * (1.0 + s5 * d + (5.0 / 3.0) * d * d) * jnp.exp(-s5 * d)


def _k_lin_rbf(params: dict, x1, x2):
    return _k_lin(params, x1, x2) + _k_rbf(params, x1, x2)


def _k_lin_mat52(params: dict, x1, x2):
    return _k_lin(params, x1, x2) + _k_mat52(params, x1, x2)


KERNELS: dict[str, Callable] = {
    "rbf": _k_rbf,
    "lin": _k_lin,
    "mat52": _k_mat52,
    "lin_rbf": _k_lin_rbf,
    "lin_mat52": _k_lin_mat52,
}


def init_kernel_params(kern_type: str, input_dim: int, dtype=jnp.float32) -> dict:
    """Unit-scale initial hyperparameters (log-space) for a kernel type."""
    p: dict[str, jax.Array] = {}
    if kern_type in ("rbf", "mat52", "lin_rbf", "lin_mat52"):
        p["log_lengthscales"] = jnp.zeros((input_dim,), dtype)
        p["log_sf"] = jnp.zeros((), dtype)
    if kern_type in ("lin", "lin_rbf", "lin_mat52"):
        p["log_sv"] = jnp.zeros((input_dim,), dtype)
    if not p:
        raise ValueError(f"unknown kernel type: {kern_type}")
    return p


def kernel_fn(kern_type: str) -> Callable:
    return KERNELS[kern_type]


def gram(kern_type: str, params: dict, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Cross-covariance matrix k(x1, x2), shape (n1, n2)."""
    return KERNELS[kern_type](params, x1, x2)


def kernel_diag(kern_type: str, params: dict, x: jax.Array) -> jax.Array:
    """diag k(x, x) for a batch of points, shape (n,)."""
    if kern_type == "rbf" or kern_type == "mat52":
        var = jnp.exp(2.0 * params["log_sf"])
        return jnp.full((x.shape[0],), var, x.dtype)
    if kern_type == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return jnp.sum(v * x * x, axis=-1)
    if kern_type in ("lin_rbf", "lin_mat52"):
        v = jnp.exp(2.0 * params["log_sv"])
        var = jnp.exp(2.0 * params["log_sf"])
        return var + jnp.sum(v * x * x, axis=-1)
    raise ValueError(f"unknown kernel type: {kern_type}")


def weighted_mean_jac(
    kern_type: str,
    params: dict,
    z: jax.Array,
    x: jax.Array,
    kv: jax.Array,
    c: jax.Array,
) -> jax.Array:
    """Closed-form input-gradient of a weighted kernel sum: d/dz sum_i c_i
    k(z, x_i), given the already-computed row ``kv`` (n,) = k(z, X).

    This is the posterior-mean Jacobian the reachability linearization needs
    (SURVEY.md §2.4 step 4) written as ONE extra matvec per kernel term,
    replacing the nested ``jacfwd`` over the posterior inside the SQP's own
    forward-mode pass. The solver differentiates THROUGH this expression (its
    derivative is the analytic GP-mean Hessian), so the traced graph per
    Newton step shrinks from jacfwd-of-jacfwd to jacfwd-of-closed-form —
    the "fusion of the per-stage posterior/Jacobian chain" (VERDICT r2 #2).

    Per kernel (all ARD, log-space params; derivations in each branch):
      rbf:    dk/dz = -k * (z - x_i) / ls^2
      lin:    dk/dz = v * x_i
      mat52:  dk/dz = -(5/3) sf^2 (1 + sqrt5 r) e^{-sqrt5 r} (z - x_i) / ls^2
      composites: sum of the parts (component kv recomputed — the summed kv
      cannot be split).
    """
    if kern_type == "rbf":
        ls2 = jnp.exp(2.0 * params["log_lengthscales"])
        w = kv * c
        return (w @ x - jnp.sum(w) * z) / ls2
    if kern_type == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return v * (c @ x)
    if kern_type == "mat52":
        ls = jnp.exp(params["log_lengthscales"])
        ls2 = ls * ls
        var = jnp.exp(2.0 * params["log_sf"])
        diff = z[None, :] - x                        # (n, d)
        r = jnp.sqrt(jnp.sum((diff / ls) ** 2, axis=-1) + 1e-30)
        s5 = jnp.sqrt(5.0).astype(r.dtype)
        g = (5.0 / 3.0) * var * (1.0 + s5 * r) * jnp.exp(-s5 * r)
        w = c * g
        return (w @ x - jnp.sum(w) * z) / ls2
    if kern_type in ("lin_rbf", "lin_mat52"):
        part = "rbf" if kern_type == "lin_rbf" else "mat52"
        kv_part = KERNELS[part](params, z[None, :], x)[0]
        return weighted_mean_jac("lin", params, z, x, kv_part, c) + (
            weighted_mean_jac(part, params, z, x, kv_part, c)
        )
    raise ValueError(f"unknown kernel type: {kern_type}")


def rbf_mean_gradient_lipschitz(params: dict, beta_norm: jax.Array) -> jax.Array:
    """Conservative Lipschitz constant of the GRADIENT of an RBF posterior mean.

    For mu(z) = sum_i beta_i k(z, x_i) with ARD-RBF, the Hessian of each term is
    bounded in spectral norm by sigma_f^2 / l_min^2, so
    ||Hess mu|| <= sigma_f^2 / l_min^2 * ||beta||_1. The reference takes ``l_mu``
    from configs (SURVEY.md §5 hard-part 5); this helper derives a usable default.
    """
    ls = jnp.exp(params["log_lengthscales"])
    var = jnp.exp(2.0 * params["log_sf"])
    return var / jnp.min(ls) ** 2 * beta_norm
