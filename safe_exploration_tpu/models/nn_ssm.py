"""MC-dropout neural-network SSM — the second uncertainty-model family.

Parity: reference ``ssm_cem/ssm_cem.py::McDropoutSSM`` (+ concrete-dropout
variant) — a dropout MLP whose predictive distribution comes from S stochastic
forward passes (Gal & Ghahramani's dropout-as-Bayes view), used as a drop-in
``CemSSM`` backend for the CEM planner (SURVEY.md §2.3, §2.6).

Design:
  * The S dropout masks are DERIVED from a stored PRNG key (refreshable via
    ``mc_resample``), so prediction is a pure deterministic function of the
    model state — it jits, vmaps (CEM samples / episode batches) and
    differentiates (``jacfwd`` state-Jacobians for reachability) exactly like
    the GP. The reference draws fresh torch masks per call and cannot be
    batched deterministically.
  * All S stochastic passes run as ONE vmapped MLP — a batched matmul stack,
    not S sequential evaluations.
  * Training is fixed-budget Adam on MSE + L2 (the dropout-Bayes regularizer),
    jit-able inside episodic loops (same contract as models/gp.gp_fit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from safe_exploration_tpu.utils import struct

__all__ = [
    "McDropoutSSM",
    "make_mc_dropout_ssm",
    "mc_fit",
    "mc_update_data",
    "mc_resample",
]


@struct.dataclass
class McDropoutSSM:
    """Dropout-MLP residual-dynamics model (pytree; satisfies the SSM protocol
    consumed by reachability: ``predict_latent``, ``noise_var``, l_mu/l_sigma).
    """

    n_s: int = struct.field(pytree_node=False)
    n_samples: int = struct.field(pytree_node=False)   # S MC passes
    keep_prob: float = struct.field(pytree_node=False)
    weights: tuple    # ((w, b), ...) MLP layers
    mask_key: jax.Array   # PRNG key the S dropout masks derive from
    log_noise: jax.Array  # (e,) aleatoric noise std (log)
    l_mu: jax.Array       # (e,) Lipschitz const of mean gradient
    l_sigma: jax.Array    # (e,) Lipschitz const of predictive std
    # padded replay buffer for update_model parity
    x: jax.Array          # (n_max, d_in)
    y: jax.Array          # (n_max, e)
    mask: jax.Array       # (n_max,)
    head: jax.Array       # () int32
    # CONCRETE-DROPOUT variant (reference ssm_cem's concrete-dropout module,
    # SURVEY.md §2.3 [M]): per-hidden-layer LEARNABLE keep probability,
    # parameterized as a logit so it is an unconstrained pytree leaf trained
    # jointly with the weights by mc_fit (via the concrete/Gumbel relaxation).
    # None selects the fixed-keep_prob variant.
    keep_logit: jax.Array | None = None  # (n_hidden_layers,)

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    # --- SSM protocol -----------------------------------------------------

    def predict_latent(self, z: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Predictive mean and (epistemic) variance at one input z (d_in,)."""
        outs = _mc_forward(self, z)                     # (S, e)
        mean = jnp.mean(outs, axis=0)
        var = jnp.var(outs, axis=0) + 1e-12
        return mean, var

    def noise_var(self) -> jax.Array:
        return jnp.exp(2.0 * self.log_noise)


def _layer_keep_probs(ssm: McDropoutSSM):
    """Per-hidden-layer keep probabilities: learned (sigmoid of keep_logit,
    clipped away from 0/1) for the concrete variant, else the fixed scalar."""
    n_hidden = len(ssm.weights) - 1
    if ssm.keep_logit is None:
        return [jnp.asarray(ssm.keep_prob) for _ in range(n_hidden)]
    p = jnp.clip(jax.nn.sigmoid(ssm.keep_logit), 0.05, 0.99)
    return [p[i] for i in range(n_hidden)]


def _dropout_masks(ssm: McDropoutSSM, s: jax.Array) -> list:
    """Hidden-layer keep masks for MC pass ``s`` (inverted-dropout scaling)."""
    masks = []
    key = jax.random.fold_in(ssm.mask_key, s)
    probs = _layer_keep_probs(ssm)
    for i, (w, _) in enumerate(ssm.weights[:-1]):
        k = jax.random.fold_in(key, i)
        keep = jax.random.bernoulli(k, probs[i], (w.shape[1],))
        masks.append(keep.astype(w.dtype) / probs[i])
    return masks


def _concrete_masks(ssm: McDropoutSSM, key: jax.Array, temp: float = 0.1) -> list:
    """Differentiable relaxed keep masks (Gal/Hron/Kendall concrete dropout):
    z = sigmoid((logit(p) + logit(u)) / t), mask = z / p — gradients flow to
    the keep_logit parameters through the mask."""
    masks = []
    probs = _layer_keep_probs(ssm)
    for i, (w, _) in enumerate(ssm.weights[:-1]):
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(
            k, (w.shape[1],), w.dtype, 1e-6, 1.0 - 1e-6
        )
        p = probs[i]
        z = jax.nn.sigmoid(
            (jnp.log(p) - jnp.log1p(-p) + jnp.log(u) - jnp.log1p(-u)) / temp
        )
        masks.append(z / p)
    return masks


def _forward_once(ssm: McDropoutSSM, z: jax.Array, s: jax.Array) -> jax.Array:
    h = z
    masks = _dropout_masks(ssm, s)
    for i, (w, b) in enumerate(ssm.weights[:-1]):
        h = jnp.tanh(h @ w + b) * masks[i]
    w, b = ssm.weights[-1]
    return h @ w + b


def _mc_forward(ssm: McDropoutSSM, z: jax.Array) -> jax.Array:
    return jax.vmap(lambda s: _forward_once(ssm, z, s))(
        jnp.arange(ssm.n_samples)
    )


def make_mc_dropout_ssm(
    key: jax.Array,
    x: jax.Array,
    u: jax.Array,
    y: jax.Array,
    *,
    n_max: int,
    l_mu: jax.Array,
    l_sigma: jax.Array,
    hidden: tuple = (64, 64),
    n_samples: int = 16,
    keep_prob: float = 0.9,
    log_noise: float = -3.0,
    concrete: bool = False,
) -> McDropoutSSM:
    """Build (untrained) MC-dropout SSM from initial transitions; see mc_fit.

    ``concrete=True`` makes the per-layer keep probability a LEARNED parameter
    (initialized at ``keep_prob``), trained jointly with the weights through
    the concrete relaxation — the reference's concrete-dropout ssm_cem module.
    """
    z = jnp.concatenate([x, u], axis=-1)
    d_in, e = z.shape[1], y.shape[1]
    dtype = x.dtype
    dims = (d_in,) + tuple(hidden) + (e,)
    k_init, k_mask = jax.random.split(key)
    weights = []
    for i in range(len(dims) - 1):
        k_init, kw = jax.random.split(k_init)
        scale = jnp.sqrt(2.0 / dims[i]).astype(dtype)
        weights.append(
            (
                scale * jax.random.normal(kw, (dims[i], dims[i + 1]), dtype),
                jnp.zeros((dims[i + 1],), dtype),
            )
        )
    n = z.shape[0]
    xp = jnp.zeros((n_max, d_in), dtype).at[:n].set(z)
    yp = jnp.zeros((n_max, e), dtype).at[:n].set(y)
    mask = jnp.zeros((n_max,), dtype).at[:n].set(1.0)
    keep_logit = None
    if concrete:
        p0 = jnp.clip(jnp.asarray(keep_prob, dtype), 0.05, 0.99)
        keep_logit = jnp.full(
            (len(dims) - 2,), jnp.log(p0) - jnp.log1p(-p0), dtype
        )
    return McDropoutSSM(
        n_s=x.shape[1], n_samples=n_samples, keep_prob=keep_prob,
        weights=tuple(weights), mask_key=k_mask,
        log_noise=jnp.full((e,), log_noise, dtype),
        l_mu=l_mu, l_sigma=l_sigma,
        x=xp, y=yp, mask=mask, head=jnp.asarray(n, jnp.int32),
        keep_logit=keep_logit,
    )


def mc_update_data(ssm: McDropoutSSM, x: jax.Array, u: jax.Array, y: jax.Array
                   ) -> McDropoutSSM:
    """Append transitions to the replay buffer (ring overwrite when full).

    Parity: ``CemSSM.update_model`` (SURVEY.md §2.3); call mc_fit afterwards.
    """
    z = jnp.concatenate([x, u], axis=-1)
    k = z.shape[0]
    n_max = ssm.x.shape[0]
    if k > n_max:
        # duplicate ring indices in one .at[idx].set leave which row survives
        # unspecified — only the newest n_max transitions can be stored anyway
        z, y = z[-n_max:], y[-n_max:]
        k = n_max
    idx = (ssm.head + jnp.arange(k, dtype=jnp.int32)) % n_max
    return ssm.replace(
        x=ssm.x.at[idx].set(z),
        y=ssm.y.at[idx].set(y),
        mask=ssm.mask.at[idx].set(1.0),
        # store head modulo n_max: an unbounded int32 head would eventually
        # overflow on very long runs
        head=(ssm.head + k) % n_max,
    )


def mc_resample(ssm: McDropoutSSM, key: jax.Array) -> McDropoutSSM:
    """Redraw the S dropout masks (fresh epistemic sample set)."""
    return ssm.replace(mask_key=key)


def mc_fit(
    ssm: McDropoutSSM,
    key: jax.Array,
    *,
    iters: int = 500,
    lr: float = 3e-3,
    weight_decay: float = 1e-5,
) -> McDropoutSSM:
    """Fixed-budget Adam on masked MSE with per-step stochastic dropout.

    The L2 term is the KL regularizer of the dropout-as-Bayes objective.
    Concrete variant (``keep_logit`` set): the per-layer keep probabilities
    are trained jointly through differentiable concrete masks, with the
    concrete-dropout regularizer (weight term scaled by 1/p, plus the
    negative Bernoulli entropy that pulls p away from certainty).
    """
    n_max = ssm.x.shape[0]
    concrete = ssm.keep_logit is not None
    # Concrete variant: plain Adam — the explicit concrete-dropout regularizer
    # already carries the ||W||^2/p weight penalty, and adamw's decoupled decay
    # would (a) L2-regularize the weights a second time and (b) pull keep_logit
    # toward 0 (p toward 0.5) independently of the entropy term (ADVICE r2 #5).
    # Plain variant: adamw's decay IS the dropout-as-Bayes KL weight term
    # (keep_logit is None there, so no spurious decay target exists).
    opt = optax.adam(lr) if concrete else optax.adamw(
        lr, weight_decay=weight_decay
    )
    n_eff = jnp.maximum(jnp.sum(ssm.mask), 1.0)

    def loss(theta, step_key):
        weights, keep_logit = theta
        model = ssm.replace(weights=weights, keep_logit=keep_logit)

        if concrete:
            def per_point(i, z, y, m):
                masks = _concrete_masks(
                    model, jax.random.fold_in(step_key, i)
                )
                h = z
                for li, (w, b) in enumerate(weights[:-1]):
                    h = jnp.tanh(h @ w + b) * masks[li]
                w, b = weights[-1]
                return m * jnp.sum((h @ w + b - y) ** 2)

            total = jax.vmap(per_point)(
                jnp.arange(n_max), ssm.x, ssm.y, ssm.mask
            )
            mse = jnp.sum(total) / n_eff
            # concrete-dropout regularizer (Gal/Hron/Kendall eq. 3-5):
            # per layer: ||W||^2 / p  +  dropout-entropy term
            reg = jnp.asarray(0.0, mse.dtype)
            probs = _layer_keep_probs(model)
            for li, (w, _) in enumerate(weights[:-1]):
                p = probs[li]
                q = 1.0 - p
                ent = p * jnp.log(p) + q * jnp.log(q)
                reg = reg + weight_decay * jnp.sum(w * w) / p
                reg = reg + (1e-3 * w.shape[1] / n_eff) * ent
            return mse + reg

        def per_point(z, y, m):
            # one stochastic pass per point (mask index = 0 of a fresh key)
            model_k = model.replace(mask_key=step_key)
            pred = _forward_once(model_k, z, jnp.asarray(0))
            return m * jnp.sum((pred - y) ** 2)

        total = jax.vmap(per_point)(ssm.x, ssm.y, ssm.mask)
        return jnp.sum(total) / n_eff

    theta0 = (ssm.weights, ssm.keep_logit)
    state0 = opt.init(theta0)

    def step(carry, k):
        theta, opt_state = carry
        g = jax.grad(loss)(theta, k)
        updates, opt_state = opt.update(g, opt_state, theta)
        theta = optax.apply_updates(theta, updates)
        return (theta, opt_state), None

    keys = jax.random.split(key, iters)
    ((weights, keep_logit), _), _ = jax.lax.scan(step, (theta0, state0), keys)
    return ssm.replace(weights=weights, keep_logit=keep_logit)
