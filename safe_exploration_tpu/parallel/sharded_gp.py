"""Data-sharded large-N sparse GP: the framework's tensor-parallel analog.

BASELINE config 4 is an N=10k-point GP inside the MPC loop. In the SGPR
formulation (models/sparse_gp.py) every O(N) contraction is one of

    Sigma_data = Kuf Kuf^T      (m, m)   and    r = Kuf y / sigma^2   (m,)

— plain matmuls over the data axis. Sharding the TRAINING DATA over the device
mesh makes each device compute its local (m, m) / (m,) partial product and a
single ``psum`` over the interconnect reduces them; the m x m Cholesky and the
O(m^2) predictions stay replicated (m <= 512 — trivially small next to the
N-axis work). Communication volume per refit: n_out * (m^2 + m) floats — independent
of N, so scaling efficiency approaches 1 as N grows.

The reference has no distributed anything (SURVEY.md §2.9); its GPy sparse GP
(``SimpleGPModel`` with inducing inputs, SURVEY.md §2.3) is the single-CPU
counterpart of this module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from safe_exploration_tpu.models.kernels import gram
from safe_exploration_tpu.models.sparse_gp import (
    SparseGP,
    _JITTER,
    _factors_from_whitened,
)

__all__ = ["DATA_AXIS", "shard_sparse_gp", "sparse_gp_refit_sharded"]

DATA_AXIS = "data"


def shard_sparse_gp(sgp: SparseGP, mesh: Mesh, axis: str = DATA_AXIS) -> SparseGP:
    """Place the data-axis leaves (x, y, mask) sharded over the mesh and
    everything else replicated. n_max must divide by the mesh size."""
    row_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return sgp.replace(
        x=jax.device_put(sgp.x, row_sharding),
        y=jax.device_put(sgp.y, row_sharding),
        mask=jax.device_put(sgp.mask, row_sharding),
        z=jax.device_put(sgp.z, rep),
        luu=jax.device_put(sgp.luu, rep),
        lsig=jax.device_put(sgp.lsig, rep),
        alpha=jax.device_put(sgp.alpha, rep),
        vmat=jax.device_put(sgp.vmat, rep),
    )


def sparse_gp_refit_sharded(
    sgp: SparseGP, mesh: Mesh, axis: str = DATA_AXIS
) -> SparseGP:
    """Rebuild (luu, lsig, alpha) with the N-axis contractions sharded.

    Numerically identical to ``sparse_gp_refit`` (pinned in
    tests/test_sharded_gp.py on the 8-device CPU mesh); the only collective is
    one ``psum`` of the stacked (m, m+1) partials per refit.
    """
    kern_types = sgp.kern_types
    n_out = sgp.n_out
    m = sgp.n_inducing
    eye = jnp.eye(m, dtype=sgp.x.dtype)

    def factors(z, x, y, mask, params, log_noise):
        # x, y, mask are LOCAL shards of the data axis
        luus, lsigs, alphas, vmats = [], [], [], []
        for d in range(n_out):
            noise_var = jnp.exp(2.0 * log_noise[d]) + _JITTER
            kuf = gram(kern_types[d], params[d], z, x) * mask[None, :]  # (m, nl)
            yd = mask * y[:, d]
            # WHITENED local partials (sparse_gp._factors_from_whitened): Kuu
            # and its Cholesky are replicated (inputs z/params identical on
            # every chip), so each shard whitens its own Kuf slice locally —
            # A_s = Luu^{-1} Kuf_s / sigma_n — and the psummed [A A^T | A y /
            # sigma_n] feeds the f32-stable B = I + A A^T factorization.
            # Forming Sigma from a psummed Kuf Kuf^T NaN'd at cfg-4 scale
            # (see _factors_from_whitened's docstring); comm volume is
            # unchanged: one (m, m+1) psum per dim, independent of N.
            kuu = gram(kern_types[d], params[d], z, z) + _JITTER * eye
            luu = jnp.linalg.cholesky(kuu)
            sn = jnp.sqrt(noise_var)
            a_loc = jax.scipy.linalg.solve_triangular(luu, kuf, lower=True) / sn
            partial = jnp.concatenate(
                [a_loc @ a_loc.T, (a_loc @ yd)[:, None] / sn], axis=1
            )
            total = jax.lax.psum(partial, axis)
            lsig, alpha, vmat = _factors_from_whitened(
                luu, total[:, :m], total[:, m]
            )
            luus.append(luu)
            lsigs.append(lsig)
            alphas.append(alpha)
            # replicated O(m^3) post-processing, no communication
            vmats.append(vmat)
        return (
            jnp.stack(luus), jnp.stack(lsigs), jnp.stack(alphas),
            jnp.stack(vmats),
        )

    rep = P()
    sharded = shard_map(
        factors,
        mesh=mesh,
        in_specs=(rep, P(axis), P(axis), P(axis), rep, rep),
        out_specs=(rep, rep, rep, rep),
        check_vma=False,
    )
    luu, lsig, alpha, vmat = jax.jit(sharded)(
        sgp.z, sgp.x, sgp.y, sgp.mask, sgp.params, sgp.log_noise
    )
    return sgp.replace(luu=luu, lsig=lsig, alpha=alpha, vmat=vmat)
