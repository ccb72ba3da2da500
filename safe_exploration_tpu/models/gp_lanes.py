"""Per-lane GP state in LANE-MAJOR (batch-last) layout — the model side of the
lane-major solver backend (solvers/sqp_lanes.py).

WHY. ``runtime/batch.py`` runs B independent online-learning episodes where
every lane owns an EVOLVING GP. Its storage is the vmap-style stacked pytree
(leading batch dim), which forces the whole per-step pipeline — SafeMPC solve,
posterior predicts, incremental appends — through the vmapped portable path
whose tiny trailing dims make every op small (see solvers/sqp_lanes.py
module docstring).
This module stores the per-lane model BATCH-LAST instead:

  * buffers   x (n_max, d_in, B), y (n_max, e, B) — per-lane contents;
  * factors   beta (e, n_max, B), kinv (e, n_max, n_max, B);
  * mask / head are SHARED scalars: lanes are created by broadcasting ONE
    fitted model (:func:`lane_stack_ssm`) and append in LOCKSTEP (one point
    per env step in every lane), so the active-slot bookkeeping never
    diverges — per-lane masks would re-introduce (n, B) bookkeeping with no
    information in it;
  * hyperparameters are SHARED: episodes append data but never re-fit hypers
    mid-episode (re-fits happen between episodes through the stacked view,
    :func:`lane_unstack_ssm`).

Every per-lane quantity is a ``(..., B)`` array, so posterior predicts,
Jacobians and the O(n^2) incremental append are fully lane-tiled elementwise
work plus (n, B)/(n, n, B) contractions — the same layout discipline as the
lane solver, which consumes this state directly (``_gp_predict_lanes``
dispatches here for :class:`LaneGPSSM`).

The incremental append maintains beta/kinv by the EXACT block-inverse algebra
of the bordered Gram extension (same update as models/gp.gp_append_point's
kinv path; beta comes from the same closed form instead of the two
triangular solves — identical in exact arithmetic, and the f32 drift over an
episode-length append sequence is pinned against the portable path in
tests/test_batch_lanes.py). The per-lane Cholesky factor is NOT maintained —
converting back to the stacked representation re-factorizes (exact, once per
episode boundary).

Parity: reference ``ssm_gpy/gaussian_process.py::SimpleGPModel`` buffers +
``update_model`` (SURVEY.md §2.3) — per-episode-lane instead of global, over
the full reference kernel menu (rbf/lin/mat52 + lin_rbf/lin_mat52 composites,
per output dim — the journal configs' ``kern_types``), in lane-major
arithmetic (_lane_kv_part/_lane_kzz_part/_lane_jac_part).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_exploration_tpu.models import gp as gp_mod
from safe_exploration_tpu.models.ssm import GPSSM
from safe_exploration_tpu.utils import struct

__all__ = [
    "LaneGP",
    "LaneGPSSM",
    "lane_stack_ssm",
    "lane_unstack_ssm",
    "lane_restack_ssm",
    "lane_predict",
    "lane_append_point",
    "lane_shrink_to_bucket",
    "lane_expand_to",
    "lane_sharding_tree",
]

_JITTER = gp_mod._JITTER


@struct.dataclass
class LaneGP:
    """B independent per-lane GPs, batch-LAST (see module docstring).

    Hyperparameters come in two regimes, selected by ``per_lane_hypers``:
    SHARED (one fitted model broadcast by :func:`lane_stack_ssm` — params
    leaves/log_noise keep their unbatched shapes) or PER-LANE (between-
    episode per-lane hyperopt re-imported by :func:`lane_restack_ssm` —
    every hyper leaf gains a TRAILING (B,) lane axis). All lane arithmetic
    below is written so either shape broadcasts against the (n, B) lane
    tiles unchanged."""

    kern_types: tuple = struct.field(pytree_node=False)  # (e,) kernel menu
    x: jax.Array        # (n_max, d_in, B) padded per-lane training inputs
    y: jax.Array        # (n_max, e, B) padded per-lane targets
    mask: jax.Array     # (n_max,) SHARED validity mask (lockstep appends)
    params: tuple       # per-dim kernel param dicts (shared or batch-last)
    log_noise: jax.Array  # (e,) or (e, B) log observation-noise std
    beta: jax.Array     # (e, n_max, B) K^{-1}(m*y) per lane
    kinv: jax.Array     # (e, n_max, n_max, B) K^{-1} per lane
    head: jax.Array     # () int32 SHARED write pointer
    precision: str = struct.field(pytree_node=False, default="f32")
    per_lane_hypers: bool = struct.field(pytree_node=False, default=False)

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    @property
    def n_lanes(self) -> int:
        return self.x.shape[-1]

    @property
    def n_points(self) -> jax.Array:
        return jnp.sum(self.mask).astype(jnp.int32)


@struct.dataclass
class LaneGPSSM:
    """Per-lane GP-SSM: the lane-major counterpart of models/ssm.GPSSM.

    Satisfies the subset of the SSM seam the lane solver consumes. Lipschitz
    constants follow the hyper regime of ``gp.per_lane_hypers``: (n_s,)
    shared, or (n_s, B) after per-lane calibration — both broadcast through
    the lane tube rollout unchanged.
    """

    gp: LaneGP
    l_mu: jax.Array     # (n_s,) or (n_s, B)
    l_sigma: jax.Array  # (n_s,) or (n_s, B)
    z_scale: jax.Array | None = None  # (d_in,) or None — static per env


#: kernel menu in lane-major form: composites are sums of these parts
#: (models/kernels.KERNELS — same menu, batch-last arithmetic)
_KERNEL_PARTS = {
    "rbf": ("rbf",),
    "lin": ("lin",),
    "mat52": ("mat52",),
    "lin_rbf": ("lin", "rbf"),
    "lin_mat52": ("lin", "mat52"),
}


def _lane_d2(params, x, zz, d_in):
    """ARD squared distance of lane queries to per-lane buffers, unrolled
    over the tiny d_in so everything stays (n, B) lane-tiled."""
    ls = jnp.exp(params["log_lengthscales"])
    return jnp.maximum(
        sum(((x[:, j, :] - zz[j][None, :]) / ls[j]) ** 2 for j in range(d_in)),
        0.0,
    )


def _lane_kv_part(part, params, x, zz, d_in):
    """One kernel part's cross-covariance k(z_b, X_b), (n, B) — the lane
    form of models/kernels.KERNELS[part]."""
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return sum(v[j] * x[:, j, :] * zz[j][None, :] for j in range(d_in))
    sf2 = jnp.exp(2.0 * params["log_sf"])
    d2 = _lane_d2(params, x, zz, d_in)
    if part == "rbf":
        return sf2 * jnp.exp(-0.5 * d2)
    d = jnp.sqrt(d2 + 1e-30)
    s5 = jnp.sqrt(5.0).astype(d.dtype)
    return sf2 * (1.0 + s5 * d + (5.0 / 3.0) * d * d) * jnp.exp(-s5 * d)


def _lane_kzz_part(part, params, zz, d_in):
    """One kernel part's prior variance at the lane queries, (B,) —
    models/kernels.kernel_diag, lane form."""
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return sum(v[j] * zz[j] * zz[j] for j in range(d_in))
    return jnp.exp(2.0 * params["log_sf"]) * jnp.ones_like(zz[0])


def _lane_jac_part(part, params, x, zz, c, d_in):
    """One kernel part's weighted-mean input gradient d/dz sum_n c_n k(z, x_n)
    as a (d_in, B) stack — models/kernels.weighted_mean_jac, lane form
    (``c`` carries the mask, so unmasked part-kv rows are harmless)."""
    ls = jnp.exp(params.get("log_lengthscales", jnp.zeros(())))
    if part == "lin":
        v = jnp.exp(2.0 * params["log_sv"])
        return jnp.stack([
            v[j] * jnp.sum(x[:, j, :] * c, axis=0) for j in range(d_in)
        ])
    if part == "rbf":
        w = _lane_kv_part("rbf", params, x, zz, d_in) * c
    else:  # mat52: w_n = c_n * (5/3) sf^2 (1 + sqrt5 r) e^{-sqrt5 r}
        sf2 = jnp.exp(2.0 * params["log_sf"])
        r = jnp.sqrt(_lane_d2(params, x, zz, d_in) + 1e-30)
        s5 = jnp.sqrt(5.0).astype(r.dtype)
        w = c * (5.0 / 3.0) * sf2 * (1.0 + s5 * r) * jnp.exp(-s5 * r)
    sum_w = jnp.sum(w, axis=0)
    return jnp.stack([
        (jnp.sum(x[:, j, :] * w, axis=0) - zz[j] * sum_w) / (ls[j] * ls[j])
        for j in range(d_in)
    ])


def lane_stack_ssm(ssm: GPSSM, batch: int) -> LaneGPSSM:
    """Broadcast ONE fitted GP-SSM into B lane-major per-lane copies.

    The lane-major counterpart of runtime/batch.stack_ssm: each lane then
    evolves its own buffers/factors via :func:`lane_append_point`.
    """
    gp = ssm.gp
    if any(kt not in _KERNEL_PARTS for kt in gp.kern_types):
        raise NotImplementedError(
            f"unknown kernel in kern_types={gp.kern_types} — use "
            "runtime/batch.stack_ssm"
        )

    def lanes(arr):
        return jnp.broadcast_to(arr[..., None], arr.shape + (batch,))

    lane_gp = LaneGP(
        kern_types=gp.kern_types,
        x=lanes(gp.x),
        y=lanes(gp.y),
        mask=gp.mask,
        params=gp.params,
        log_noise=gp.log_noise,
        beta=lanes(gp.beta),
        kinv=lanes(gp.kinv),
        head=gp.head,
        precision=gp.precision,
    )
    return LaneGPSSM(
        gp=lane_gp, l_mu=ssm.l_mu, l_sigma=ssm.l_sigma, z_scale=ssm.z_scale
    )


def lane_unstack_ssm(lssm: LaneGPSSM) -> GPSSM:
    """Lane-major per-lane state -> the vmap-style STACKED GPSSM pytree
    (leading batch dim on every leaf, as runtime/batch.stack_ssm produces).

    Used at episode boundaries (per-lane hyperopt, checkpointing, handing
    lanes to stacked-path consumers). The per-lane Cholesky factor is not
    maintained lane-major, so this re-factorizes each lane via a vmapped
    ``gp_refit`` — exact, O(n^3) once per episode, outside the hot loop.
    """
    gp = lssm.gp
    b = gp.n_lanes

    def stack_shared(arr):
        return jnp.broadcast_to(arr[None], (b,) + arr.shape)

    # hyper leaves: broadcast if shared, rotate the trailing lane axis to
    # the front if already per-lane
    hyp = (lambda a_: jnp.moveaxis(a_, -1, 0)) if gp.per_lane_hypers \
        else stack_shared

    base = gp_mod.GP(
        kern_types=gp.kern_types,
        x=jnp.moveaxis(gp.x, -1, 0),
        y=jnp.moveaxis(gp.y, -1, 0),
        mask=stack_shared(gp.mask),
        params=jax.tree.map(hyp, gp.params),
        log_noise=hyp(gp.log_noise),
        # placeholder factors — gp_refit rebuilds chol/beta/kinv from data
        chol=jnp.moveaxis(gp.kinv, -1, 0),
        beta=jnp.moveaxis(gp.beta, -1, 0),
        kinv=jnp.moveaxis(gp.kinv, -1, 0),
        head=stack_shared(gp.head),
        precision=gp.precision,
    )
    stacked_gp = jax.vmap(gp_mod.gp_refit)(base)
    return GPSSM(
        gp=stacked_gp,
        l_mu=hyp(lssm.l_mu),
        l_sigma=hyp(lssm.l_sigma),
        z_scale=(
            None if lssm.z_scale is None else stack_shared(lssm.z_scale)
        ),
    )


def lane_restack_ssm(stacked: GPSSM) -> LaneGPSSM:
    """STACKED per-lane GPSSM (leading batch on every leaf, e.g. after a
    vmapped between-episode ``ssm_fit``/``calibrate_lipschitz``) -> the
    lane-major representation, keeping each lane's OWN hyperparameters and
    Lipschitz constants as batch-last hyper leaves (``per_lane_hypers``).

    Inverse of :func:`lane_unstack_ssm` up to the maintained factors
    (beta/kinv are taken from the stacked refit — exact). mask/head must be
    in lockstep across lanes (they are, by construction of the lane episode
    runner); lane 0's copy is taken.
    """
    gp = stacked.gp

    def to_lanes(arr):
        return jnp.moveaxis(arr, 0, -1)

    lane_gp = LaneGP(
        kern_types=gp.kern_types,
        x=to_lanes(gp.x),
        y=to_lanes(gp.y),
        mask=gp.mask[0],
        params=jax.tree.map(to_lanes, gp.params),
        log_noise=to_lanes(gp.log_noise),
        beta=to_lanes(gp.beta),
        kinv=to_lanes(gp.kinv),
        head=gp.head[0],
        precision=gp.precision,
        per_lane_hypers=True,
    )
    return LaneGPSSM(
        gp=lane_gp,
        l_mu=to_lanes(stacked.l_mu),
        l_sigma=to_lanes(stacked.l_sigma),
        z_scale=None if stacked.z_scale is None else stacked.z_scale[0],
    )


def lane_predict(lssm: LaneGPSSM, z: jax.Array, *, want_jac: bool = False):
    """Posterior mean/var (+ closed-form mean Jacobian) of B per-lane GPs at
    B query lanes — every lane queries ITS OWN model.

    ``z``: (d_in, B) RAW inputs, lane-last. Mirrors models/gp._predict_dim +
    gp_predict_mean_jac (incl. the conditioning-aware variance floor) and the
    z_scale chain rule, with per-lane buffers: the cross-covariance and its
    derivative are unrolled over the tiny d_in so everything stays (n, B)
    lane-tiled; the variance quadratic form is one (n, n, B) x (n, B)
    batched contraction per output dim.

    Returns (mu (e, B), var (e, B)[, jac (e, d_in, B)]).
    """
    gp = lssm.gp
    zz = z if lssm.z_scale is None else z / lssm.z_scale[:, None]
    eps = jnp.finfo(zz.dtype).eps
    d_in = zz.shape[0]
    mus, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        kv = sum(
            _lane_kv_part(p, params, gp.x, zz, d_in) for p in parts
        ) * gp.mask[:, None]                                # (n, B)
        mus.append(jnp.sum(gp.beta[d] * kv, axis=0))        # (B,)
        kzz = sum(_lane_kzz_part(p, params, zz, d_in) for p in parts)
        floor = jnp.maximum(8.0 * eps * kzz, 1e-12)
        kiv = jnp.einsum("ijb,jb->ib", gp.kinv[d], kv)      # (n, B)
        vars_.append(jnp.maximum(kzz - jnp.sum(kv * kiv, axis=0), floor))
        if want_jac:
            # closed form (kernels.weighted_mean_jac, lane form), weights
            # carry the mask so per-part kv rows need none
            c = gp.beta[d] * gp.mask[:, None]               # (n, B)
            jac = sum(
                _lane_jac_part(p, params, gp.x, zz, c, d_in) for p in parts
            )                                               # (d_in, B)
            if lssm.z_scale is not None:
                jac = jac / lssm.z_scale[:, None]
            jacs.append(jac)
    mu = jnp.stack(mus)
    var = jnp.stack(vars_)
    if want_jac:
        return mu, var, jnp.stack(jacs)
    return mu, var


def lane_append_point(
    lssm: LaneGPSSM, x: jax.Array, u: jax.Array, y: jax.Array
) -> LaneGPSSM:
    """O(n^2)-per-lane incremental append of ONE transition to EVERY lane's
    own GP — the lane-major counterpart of models/ssm.ssm_append_point ->
    gp_append_point.

    Args (runner layout, leading batch): x (B, n_s), u (B, n_u), y (B, e).
    Owns the z_scale normalization (ADVICE r2 high). Lanes append in
    lockstep into the SHARED slot; on a full buffer the append is a gated
    no-op for every lane (same saturation contract as gp_append_point —
    runtime/batch rejects overflowing schedules host-side).

    The update is the exact block-inverse of the bordered Gram extension:
    with w = K^{-1} kv and Schur complement S = k_nn + sigma_n^2 + jitter -
    kv^T w, the new inverse is [[K^{-1} + w w^T / S, -w / S], [-w^T/S, 1/S]]
    and the new beta follows in O(n) as beta + w c / -c with
    c = (kv^T beta - y_n) / S. kv is masked by the OLD mask and K^{-1} is
    identity on padding, so w vanishes on every inactive slot — padding rows
    stay untouched, exactly as in gp_append_point.
    """
    gp = lssm.gp
    n_lanes = gp.x.shape[-1]
    if x.ndim != 2 or x.shape[0] != n_lanes:
        # LOCKSTEP CONTRACT (VERDICT r4 next #9): every lane shares ONE
        # mask/head, so an append must carry exactly one transition for
        # EVERY lane. A runner that appends for a subset (early-terminating
        # or variable-length episodes) would silently desynchronize the
        # shared-slot buffers — reject it loudly at trace time instead.
        raise ValueError(
            "lane_append_point requires one transition per lane in lockstep "
            f"(shared mask/head): got x shape {tuple(x.shape)} for "
            f"{n_lanes} lanes; per-lane variable-length schedules must use "
            "the stacked (vmapped) runner, whose per-lane GPSSM pytrees "
            "carry independent masks"
        )
    z = jnp.concatenate([x, u], axis=-1).T                  # (d_in, B)
    if lssm.z_scale is not None:
        z = z / lssm.z_scale[:, None]
    y_t = y.T                                               # (e, B)
    d_in = z.shape[0]

    has_room = gp.head < gp.n_max
    slot = jnp.minimum(gp.head, gp.n_max - 1)
    row_sel = jnp.arange(gp.n_max) == slot                  # (n,)

    def gated(new, old):
        return jnp.where(has_room, new, old)

    x_buf = gp.x.at[slot].set(gated(z, gp.x[slot]))
    y_buf = gp.y.at[slot].set(gated(y_t, gp.y[slot]))
    mask = gp.mask.at[slot].set(gated(1.0, gp.mask[slot]))

    betas, kinvs = [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        noise_var = jnp.exp(2.0 * gp.log_noise[d])
        # cross-covariance of the new point vs existing actives (OLD mask
        # zeroes the slot row, so writing x first is safe — as in
        # gp_append_point)
        kv = sum(
            _lane_kv_part(p, params, x_buf, z, d_in) for p in parts
        ) * gp.mask[:, None]
        w = jnp.einsum("ijb,jb->ib", gp.kinv[d], kv)        # (n, B)
        knn = sum(_lane_kzz_part(p, params, z, d_in) for p in parts)  # (B,)
        schur = jnp.maximum(
            knn + noise_var + _JITTER - jnp.sum(kv * w, axis=0), _JITTER
        )                                                   # (B,)
        c = (jnp.sum(kv * gp.beta[d], axis=0) - y_t[d]) / schur
        new_beta = gp.beta[d] + w * c[None, :]
        new_beta = new_beta.at[slot].set(-c)
        new_kinv = gp.kinv[d] + (
            w[:, None, :] * w[None, :, :] / schur[None, None, :]
        )
        slot_vec = jnp.where(
            row_sel[:, None], 1.0 / schur[None, :], -w / schur[None, :]
        )                                                   # (n, B)
        new_kinv = new_kinv.at[slot, :, :].set(slot_vec)
        new_kinv = new_kinv.at[:, slot, :].set(slot_vec)
        betas.append(gated(new_beta, gp.beta[d]))
        kinvs.append(gated(new_kinv, gp.kinv[d]))

    new_gp = gp.replace(
        x=x_buf, y=y_buf, mask=mask,
        beta=jnp.stack(betas), kinv=jnp.stack(kinvs),
        head=jnp.minimum(gp.head + 1, gp.n_max),
    )
    return lssm.replace(gp=new_gp)


def lane_shrink_to_bucket(
    lssm: LaneGPSSM, n_free: int = 0, *, min_bucket: int = 32
) -> LaneGPSSM:
    """Slice the per-lane padded buffers down to the smallest power-of-2
    bucket holding the active points PLUS ``n_free`` upcoming appends
    (host-side, between jit regions) — models/gp.gp_shrink_to_bucket for the
    lane layout.

    Per-predict cost inside the lane solve is O(n_max) mean / O(n_max^2)
    variance REGARDLESS of how many rows are real, so an episode early in a
    learning run pays the full capacity on every posterior evaluation;
    bucketing recovers it at the cost of one recompile per bucket boundary
    (O(log n_max) compiles over a whole run). ``n_free`` reserves room for
    the episode's in-program appends. Requires the lockstep prefix layout
    (always true for lane models — appends are gated writes at the shared
    head); factors are sliced, not recomputed: identity padding makes every
    factor block-diagonal across the mask boundary.
    """
    gp = lssm.gp
    n_need = int(jax.device_get(gp.n_points)) + n_free
    bucket = min_bucket
    while bucket < n_need:
        bucket *= 2
    bucket = min(bucket, gp.n_max)
    if bucket >= gp.n_max:
        return lssm
    return lssm.replace(gp=gp.replace(
        x=gp.x[:bucket],
        y=gp.y[:bucket],
        mask=gp.mask[:bucket],
        beta=gp.beta[:, :bucket],
        kinv=gp.kinv[:, :bucket, :bucket],
    ))


def lane_expand_to(lssm: LaneGPSSM, n_max: int) -> LaneGPSSM:
    """Pad per-lane buffers back out to capacity ``n_max`` with inactive
    identity rows — the exact inverse of :func:`lane_shrink_to_bucket`
    (masked-identity convention: mask 0, beta 0, K^{-1} identity on padding),
    so an expanded model keeps appending/predicting exactly as before."""
    gp = lssm.gp
    nb = gp.n_max
    if nb >= n_max:
        return lssm
    pad = n_max - nb
    kinv = jnp.pad(gp.kinv, ((0, 0), (0, pad), (0, pad), (0, 0)))
    idx = jnp.arange(nb, n_max)
    kinv = kinv.at[:, idx, idx, :].set(1.0)
    return lssm.replace(gp=gp.replace(
        x=jnp.pad(gp.x, ((0, pad), (0, 0), (0, 0))),
        y=jnp.pad(gp.y, ((0, pad), (0, 0), (0, 0))),
        mask=jnp.pad(gp.mask, (0, pad)),
        beta=jnp.pad(gp.beta, ((0, 0), (0, pad), (0, 0))),
        kinv=kinv,
    ))


def lane_sharding_tree(mesh, lssm: LaneGPSSM, axis_name: str):
    """A LaneGPSSM-shaped pytree of NamedShardings: per-lane leaves (x, y,
    beta, kinv — batch-LAST) shard their last axis over ``axis_name``;
    shared leaves (mask, hypers, Lipschitz constants, head) replicate.

    The lane axis is embarrassingly parallel (zero collectives), so this is
    pure data parallelism over episodes — SURVEY.md §2.9.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    lane_fields = {"x", "y", "beta", "kinv"}
    if lssm.gp.per_lane_hypers:
        # per-lane hyper leaves also carry a trailing lane axis
        lane_fields |= {"params", "log_noise", "l_mu", "l_sigma"}

    def per_leaf(path, leaf):
        names = {
            p.name for p in path if isinstance(p, jax.tree_util.GetAttrKey)
        }
        if names & lane_fields:
            return NamedSharding(
                mesh, P(*([None] * (leaf.ndim - 1) + [axis_name]))
            )
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(per_leaf, lssm)
