"""Derivative-based safe-MPC NLP solver — the jit-compiled IPOPT replacement.

Parity: reference ``safempc_simple.py::SimpleSafeMPC`` solve path (SURVEY.md
§2.5): the safety NLP

    min_{k_ff}  cost(tube(k_ff))
    s.t.        per-stage ellipsoid in state polytope,
                terminal ellipsoid in safe polytope,
                u_min <= k_ff <= u_max

where ``tube`` is the full multistep ellipsoid reachability (GP posterior + mean
Jacobians + Lipschitz remainders) — the reference builds this graph symbolically
in CasADi once and hands it to IPOPT/MUMPS per control step (SURVEY.md §3.3).

Compiled design (SURVEY.md §7 hard-part #1): an augmented-Lagrangian method
(Rockafellar inequality form) with damped projected-Newton inner iterations and a
FIXED iteration budget:

  * every derivative (gradient + dense Hessian of the AL through the entire
    reachability rollout, including second derivatives of the GP posterior) comes
    from jax.grad / jax.hessian — no hand-built KKT graph;
  * the decision vector is tiny (T * n_u <= ~20), so the Newton solve is a dense
    Cholesky — trivial work — and thousands of problem instances vmap side by
    side
    (the 1000+ solves/sec north star; IPOPT can only solve one at a time);
  * control bounds are handled by projection inside the Newton line search;
  * NO data-dependent control flow: multiplier updates, penalty growth and line
    search are all fixed-shape ``lax`` ops, so the solver nests inside scan/vmap.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from safe_exploration_tpu.envs.base import Env
from safe_exploration_tpu.models.ssm import GPSSM
from safe_exploration_tpu.reachability.onestep import multistep_reachability
from safe_exploration_tpu.reachability.safety import lin_ellipsoid_safety_distance

__all__ = ["SqpConfig", "solve_al_nlp", "solve_safempc_nlp", "make_sqp_planner",
           "sqp_warm_len", "sqp_n_duals", "shift_duals"]


class SqpConfig(NamedTuple):
    """Static solver knobs (fixed budgets keep everything jit/vmap-able)."""

    n_safe: int = 5
    c_safety: float = 2.5
    n_outer: int = 12          # augmented-Lagrangian (multiplier) updates
    n_inner: int = 6           # damped Newton steps per outer iteration
    # penalty schedule: mu0=50/growth=2.5 converges ~20x more of the
    # cold-start pendulum H=5 problems than the textbook mu0=10/1.6 at
    # identical cost per solve
    mu0: float = 50.0          # initial penalty
    mu_growth: float = 2.5     # geometric penalty growth per outer iteration
    newton_damping: float = 1e-6
    # feasibility gate on the SUMMED violation. 1e-4 is IPOPT's default
    # constr_viol_tol (the reference's solver) — margins are in state units
    # (~0.1-1), so 1e-4 slack is noise next to the c_safety tube conservatism;
    # the previous 1e-5 gate misclassified ~15% of converged f32 solves.
    feas_tol: float = 1e-4
    n_linesearch: int = 3      # backtracking candidates (1, 1/2, 1/4, ...)
    # joint safety+performance trajectory (reference safempc_simple.py,
    # SURVEY.md §2.5): the objective rides a length-n_perf cheap Gaussian
    # propagation sharing the first r_shared controls with the safety tube;
    # n_perf = 0 puts the objective on the safety tube itself.
    n_perf: int = 0
    r_shared: int = 1
    perf_method: str = "taylor"  # "taylor" | "mean_equivalent"
    # jointly optimize per-stage feedback gains (reference safempc_simple.py's
    # optional k_fb decision variables, SURVEY.md §2.5 [M]): decision vars gain
    # a per-stage delta dK_t on the LQR base gain, box-bounded by k_fb_bound.
    # dK always cold-starts at 0 (the warm-start protocol covers controls only).
    opt_k_fb: bool = False
    k_fb_bound: float = 2.0
    # feasibility polish: Gauss-Newton steps on 0.5*||max(g,0)||^2 after the
    # AL loop — cheap (no objective Hessian) and recovers lanes the fixed AL
    # budget left marginally infeasible (IPOPT's restoration-phase analog).
    # Each step backtracks over {1, 1/2, 1/4} of the GN direction (same
    # Jacobian) and keeps the best violation — the single full-step
    # accept/reject got stuck on curved constraint boundaries (measured:
    # backtracking closes ~half of the gap between the 10x3 budget and the
    # 25x8 oracle ceiling on cold-start feasibility).
    n_polish: int = 3
    # VIOLATION-GATED extra polish (VERDICT r4 next #8): after the whole
    # schedule, if the solve is still infeasible, run up to this many more
    # polish steps under a lax.cond — free when the budget already converged
    # (warm re-solves), and recovers marginal lanes on short cold budgets
    # (the fast 10x3+3 row) without paying for them on the happy path.
    n_polish_extra: int = 0
    # rescue burst: extra AL outer iterations AFTER the polish, warm-started
    # from the polished primal with fresh multipliers at a boosted penalty —
    # IPOPT's "restore then re-optimize" move for lanes the first AL pass
    # stalled on. 0 disables.
    n_rescue_outer: int = 0
    # Newton curvature model: "gn" computes the AL Hessian by Gauss-Newton
    # through the rollout outputs y — ONE jacfwd of the rollout per step plus
    # exact small-space curvature of cost/constraints in y (only the rollout
    # map's own second derivative is dropped) — cheaper than "exact"
    # (jax.hessian of the AL) at equal convergence; the ratio on the GPU is
    # not measured yet.
    hessian: str = "gn"
    # Line-search model (GN path only): "linearized" scores the backtracking
    # candidates on the LINEARIZED rollout y + Jy (u' - u) — the Jacobian the
    # step just computed — instead of re-rolling the tube per candidate
    # (3 full rollouts per Newton step under "exact"). At batch 512 and a
    # 10x3 budget it costs cold-start feasibility (0.875 -> 0.836): the
    # linearized acceptance misjudges steps near active-set switches. Default
    # stays "exact"; the knob exists for throughput-over-convergence
    # deployments.
    linesearch: str = "exact"  # "exact" | "linearized"


def _solve_spd_unrolled(h: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve the tiny SPD Newton system h d = rhs by a fully UNROLLED
    Cholesky + two substitutions (n_var <= ~20 scalars).

    `jnp.linalg.cholesky` + triangular solves lower to library custom-calls
    (two per Newton step, x30 per solve) whose cost at n_var = 5 is the
    kernel-launch floor, not FLOPs. Unrolling emits pure vectorized scalar
    arithmetic that XLA fuses into the surrounding step; each "scalar" is a
    (batch,)-vector under vmap. Breakdown (h not SPD) surfaces as NaN in d,
    exactly like the custom-call path, and is handled by the caller's
    fallback.

    Shape-polymorphic over trailing lane dims: ``h`` may be (n, n) of scalars
    or (n, n, B) of lane vectors (the lane-major backend, solvers/sqp_lanes) —
    every "scalar" below broadcasts over whatever trails the first two axes.
    """
    n = h.shape[0]
    # Cholesky: column-by-column, fully unrolled (static n)
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = jnp.sqrt(s)
        inv_d = 1.0 / l[j][j]
        for i in range(j + 1, n):
            s = h[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    # forward substitution L y = rhs
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    # back substitution L^T d = y
    d = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * d[k]
        d[i] = s / l[i][i]
    return jnp.stack(d)


# above this size the O(n^3) unrolled-graph size outweighs the custom-call
# launch overhead it avoids; the crossover lies well past any SafeMPC
# decision vector (n_var = warm_len * n_u + optional dK block)
_UNROLL_SOLVE_MAX_N = 24


def _newton_solve(h: jax.Array, rhs: jax.Array) -> jax.Array:
    if h.shape[-1] <= _UNROLL_SOLVE_MAX_N:
        return _solve_spd_unrolled(h, rhs)
    l = jnp.linalg.cholesky(h)
    y = jax.scipy.linalg.solve_triangular(l, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(l.T, y, lower=False)


def _build_constraint_fn(
    ssm: GPSSM,
    x0: jax.Array,
    k_fb_all: jax.Array,
    a: jax.Array,
    b: jax.Array,
    cfg: "SqpConfig",
    h_mat_obs: jax.Array,
    h_obs: jax.Array,
    h_mat_safe: jax.Array,
    h_safe: jax.Array,
    cost_fn: Callable,
):
    """Return (objective(u_flat), constraints(u_flat)) closures.

    Decision vector layout: ``u_flat = [k_ff (n_safe * n_u) | u_perf_free
    ((n_perf - r_shared) * n_u)]``. Safety constraints see only the k_ff block;
    the objective rides the performance trajectory (first r_shared controls
    shared with the safety tube) when ``cfg.n_perf > 0`` — the reference's
    joint safety+performance NLP structure (SURVEY.md §2.5).
    """
    t_len, n_u = k_fb_all.shape[0], k_fb_all.shape[1]
    n_s = k_fb_all.shape[2]
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    n_safe_flat = t_len * n_u
    n_ctrl_flat = sqp_warm_len(cfg) * n_u   # k_ff + free perf controls

    def split(u_flat):
        k_ff_all = u_flat[:n_safe_flat].reshape(t_len, n_u)
        u_perf_free = u_flat[n_safe_flat:n_ctrl_flat].reshape(-1, n_u)
        return k_ff_all, u_perf_free

    def stage_gains(u_flat):
        if not cfg.opt_k_fb:
            return k_fb_all
        dk = u_flat[n_ctrl_flat:].reshape(t_len, n_u, n_s)
        return k_fb_all + dk

    def rollout(u_flat):
        k_ff_all, _ = split(u_flat)
        return multistep_reachability(ssm, x0, k_ff_all, stage_gains(u_flat),
                                      a, b, cfg.c_safety)

    if cfg.n_perf > 0:
        from safe_exploration_tpu.reachability.propagation import (
            multi_step_propagation,
        )

        def objective(u_flat):
            k_ff_all, u_perf_free = split(u_flat)
            u_perf_all = jnp.concatenate([k_ff_all[:r], u_perf_free], axis=0)
            p_traj, sigma_traj, var_traj = multi_step_propagation(
                ssm, x0, u_perf_all, a, b, method=cfg.perf_method
            )
            return cost_fn(p_traj, sigma_traj, var_traj, u_perf_all)
    else:

        def objective(u_flat):
            p_traj, q_traj, var_traj = rollout(u_flat)
            return cost_fn(p_traj, q_traj, var_traj, split(u_flat)[0])

    def constraints(u_flat):
        p_traj, q_traj, _ = rollout(u_flat)
        d_stage = jax.vmap(
            lambda p, q: lin_ellipsoid_safety_distance(p, q, h_mat_obs, h_obs)
        )(p_traj, q_traj)
        d_term = lin_ellipsoid_safety_distance(
            p_traj[-1], q_traj[-1], h_mat_safe, h_safe
        )
        return jnp.concatenate([d_stage.reshape(-1), d_term])

    # --- Gauss-Newton decomposition: u --(rollout, expensive)--> y --(tiny)-->
    # (cost, distances). The GN path differentiates the rollout ONCE per
    # Newton step (jacfwd of outputs) and takes exact derivatives of the tiny
    # y-space maps, recovering all curvature except the rollout map's own
    # second derivative (the classical GN drop).
    n_perf_blk = cfg.n_perf if cfg.n_perf > 0 else 0
    sizes = [t_len * n_s, t_len * n_s * n_s, t_len * n_s]
    if n_perf_blk:
        sizes += [n_perf_blk * n_s, n_perf_blk * n_s * n_s, n_perf_blk * n_s]
    offs = [0]
    for s_ in sizes:
        offs.append(offs[-1] + s_)

    def _unpack(y):
        parts = [y[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        p_traj = parts[0].reshape(t_len, n_s)
        q_traj = parts[1].reshape(t_len, n_s, n_s)
        var_traj = parts[2].reshape(t_len, n_s)
        if n_perf_blk:
            pp = parts[3].reshape(n_perf_blk, n_s)
            sp = parts[4].reshape(n_perf_blk, n_s, n_s)
            vp = parts[5].reshape(n_perf_blk, n_s)
            return p_traj, q_traj, var_traj, (pp, sp, vp)
        return p_traj, q_traj, var_traj, None

    def outputs(u_flat):
        p_traj, q_traj, var_traj = rollout(u_flat)
        blocks = [p_traj.reshape(-1), q_traj.reshape(-1), var_traj.reshape(-1)]
        if n_perf_blk:
            from safe_exploration_tpu.reachability.propagation import (
                multi_step_propagation,
            )

            k_ff_all, u_perf_free = split(u_flat)
            u_perf_all = jnp.concatenate([k_ff_all[:r], u_perf_free], axis=0)
            pp, sp, vp = multi_step_propagation(
                ssm, x0, u_perf_all, a, b, method=cfg.perf_method
            )
            blocks += [pp.reshape(-1), sp.reshape(-1), vp.reshape(-1)]
        return jnp.concatenate(blocks)

    def cost_small(y, u_flat):
        p_traj, q_traj, var_traj, perf = _unpack(y)
        k_ff_all, u_perf_free = split(u_flat)
        if n_perf_blk:
            pp, sp, vp = perf
            u_perf_all = jnp.concatenate([k_ff_all[:r], u_perf_free], axis=0)
            return cost_fn(pp, sp, vp, u_perf_all)
        return cost_fn(p_traj, q_traj, var_traj, k_ff_all)

    def dist_small(y):
        p_traj, q_traj, _, _ = _unpack(y)
        d_stage = jax.vmap(
            lambda p, q: lin_ellipsoid_safety_distance(p, q, h_mat_obs, h_obs)
        )(p_traj, q_traj)
        d_term = lin_ellipsoid_safety_distance(
            p_traj[-1], q_traj[-1], h_mat_safe, h_safe
        )
        return jnp.concatenate([d_stage.reshape(-1), d_term])

    return objective, constraints, outputs, cost_small, dist_small


def sqp_warm_len(cfg: SqpConfig) -> int:
    """Rows of the planner's warm-start matrix: safety controls + free
    performance controls (those not shared with the safety trajectory)."""
    if cfg.n_perf <= 0:
        return cfg.n_safe
    r = min(cfg.r_shared, cfg.n_safe, cfg.n_perf)
    return cfg.n_safe + (cfg.n_perf - r)


def solve_al_nlp(
    objective: Callable,
    constraints: Callable,
    u0: jax.Array,
    lo: jax.Array,
    hi: jax.Array,
    cfg: SqpConfig,
    lam_init: jax.Array | None = None,
):
    """Generic fixed-budget augmented-Lagrangian NLP core.

        min_u objective(u)  s.t.  constraints(u) <= 0,  lo <= u <= hi

    Rockafellar AL outer loop + damped projected-Newton inner iterations +
    optional Gauss-Newton feasibility polish — everything fixed-shape ``lax``
    ops, so the solve nests inside jit/vmap/scan. This is the engine under
    BOTH the SafeMPC NLP (solve_safempc_nlp — the reference's IPOPT call,
    SURVEY.md §2.5) and the static safe-active-learning probe NLP
    (solvers/static_exploration.py — the reference's exploration_runner NLP,
    SURVEY.md §3.2).

    Returns (u_fin, lam_fin, g_fin): final primal, multipliers, constraints.
    """
    dtype = u0.dtype
    n_var = u0.shape[0]
    n_con = None  # resolved lazily from lam_init or a constraint eval

    def al_value(u, lam, mu):
        """Rockafellar augmented Lagrangian for inequalities g(u) <= 0."""
        g = constraints(u)
        shifted = jnp.maximum(lam + mu * g, 0.0)
        return objective(u) + (1.0 / (2.0 * mu)) * jnp.sum(
            shifted * shifted - lam * lam
        )

    al_value_grad = jax.value_and_grad(al_value)
    al_hess = jax.hessian(al_value)

    def inner_newton(u, lam, mu):
        def newton_step(u, _):
            f0, g = al_value_grad(u, lam, mu)
            h = al_hess(u, lam, mu)
            # Levenberg damping keeps the step well-defined when H is indefinite
            # (AL Hessians of active-set switches are only PSD near the solution).
            diag_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(h))), 1.0)
            damp = cfg.newton_damping * diag_scale
            eye = jnp.eye(n_var, dtype=dtype)

            # unrolled tiny-SPD solves (see _solve_spd_unrolled): fused
            # vector arithmetic instead of two LAPACK-style custom-calls
            hs = 0.5 * (h + h.T)
            d0 = _newton_solve(hs + damp * eye, -g)
            # fall back to a strongly-damped (gradient-like) step if Cholesky failed
            d1 = _newton_solve(hs + diag_scale * eye, -g)
            d = jnp.where(jnp.all(jnp.isfinite(d0)), d0, d1)

            # fixed backtracking line search with projection onto the box
            alphas = 0.5 ** jnp.arange(cfg.n_linesearch, dtype=dtype)
            cands = jax.vmap(lambda al_: jnp.clip(u + al_ * d, lo, hi))(alphas)
            vals = jax.vmap(lambda uu: al_value(uu, lam, mu))(cands)
            vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
            best = jnp.argmin(vals)
            u_new = jnp.where(vals[best] < f0, cands[best], u)
            return u_new, None

        u_out, _ = jax.lax.scan(newton_step, u, None, length=cfg.n_inner)
        return u_out

    def outer_step(carry, _):
        u, lam, mu = carry
        u = inner_newton(u, lam, mu)
        g = constraints(u)
        lam = jnp.maximum(lam + mu * g, 0.0)
        mu = mu * cfg.mu_growth
        return (u, lam, mu), None

    u0 = jnp.clip(u0, lo, hi)
    if lam_init is None:
        n_con = jax.eval_shape(constraints, u0).shape[0]
        lam0 = jnp.zeros((n_con,), dtype)
    else:
        lam0 = lam_init
    (u_fin, lam_fin, _), _ = jax.lax.scan(
        outer_step, (u0, lam0, jnp.asarray(cfg.mu0, dtype)), None,
        length=cfg.n_outer,
    )

    def do_polish(u_in, n_steps=0):
        # feasibility restoration: damped Gauss-Newton on the violation only,
        # backtracking over step fractions; never increases the violation
        # (all candidates rejected otherwise), so feasible lanes are untouched.
        def polish_step(u, _):
            g = constraints(u)
            v = jnp.maximum(g, 0.0)
            jac = jax.jacfwd(constraints)(u)           # (n_con, n_var)
            jtv = jac.T @ v
            jtj = jac.T @ (jac * (g > 0.0)[:, None])
            d = _newton_solve(jtj + 1e-6 * jnp.eye(n_var, dtype=dtype), -jtv)
            alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125], dtype)
            cands = jax.vmap(lambda al_: jnp.clip(u + al_ * d, lo, hi))(alphas)
            viols = jax.vmap(
                lambda uu: jnp.sum(jnp.maximum(constraints(uu), 0.0))
            )(cands)
            best = jnp.argmin(viols)
            take = viols[best] < jnp.sum(v)
            return jnp.where(take, cands[best], u), None

        u_out, _ = jax.lax.scan(polish_step, u_in, None,
                                length=n_steps or cfg.n_polish)
        return u_out

    if cfg.n_polish > 0:
        u_fin = do_polish(u_fin)

    if cfg.n_rescue_outer > 0:
        # rescue burst: continue the AL schedule from the polished primal with
        # fresh multipliers — re-optimizes lanes the first pass stalled on
        mu_r = jnp.asarray(cfg.mu0 * cfg.mu_growth ** cfg.n_outer, dtype)
        (u_fin, _, _), _ = jax.lax.scan(
            outer_step, (u_fin, jnp.zeros_like(lam_fin), mu_r), None,
            length=cfg.n_rescue_outer,
        )
        if cfg.n_polish > 0:
            u_fin = do_polish(u_fin)

    if cfg.n_polish_extra > 0:
        # violation-gated: only pay for the extra restoration when the
        # budget left this instance infeasible (lax.cond skips it at
        # runtime). The gate's constraint evaluation doubles as the return
        # value on the converged path — no extra rollout there.
        g_gate = constraints(u_fin)
        still_bad = jnp.sum(jnp.maximum(g_gate, 0.0)) > cfg.feas_tol

        def _restore(u, g):
            u2 = do_polish(u, cfg.n_polish_extra)
            return u2, constraints(u2)

        u_fin, g_fin = jax.lax.cond(
            still_bad, _restore, lambda u, g: (u, g), u_fin, g_gate
        )
        return u_fin, lam_fin, g_fin

    return u_fin, lam_fin, constraints(u_fin)


def solve_al_nlp_gn(
    outputs: Callable,
    cost_small: Callable,
    dist_small: Callable,
    u0: jax.Array,
    lo: jax.Array,
    hi: jax.Array,
    cfg: SqpConfig,
    lam_init: jax.Array,
):
    """Gauss-Newton augmented-Lagrangian core (cfg.hessian == "gn").

    Same outer/inner/polish schedule as :func:`solve_al_nlp`, but each Newton
    step derives the AL gradient AND curvature from ONE jacfwd of the
    expensive rollout map y(u):

        grad = Jy^T (dF/dy + Gy^T s) + dF/du
        H   ~= [Jy;I]^T d2F [Jy;I]  +  mu (Gy Jy)^T diag(active) (Gy Jy)

    with F = cost_small(y, u), G = dist_small(y), s = max(lam + mu g, 0).
    d2F/Gy are derivatives of TINY y-space functions (y ~ 40-90 numbers) —
    negligible next to the rollout. Only d2y/du2 contracted with the
    multipliers is dropped (classical GN); Levenberg damping covers it.
    Cheaper per step than the exact-Hessian path at equal feasibility on the
    pendulum H=5 batch (the GPU ratio is not measured yet).
    """
    dtype = u0.dtype
    n_var = u0.shape[0]

    def al_from(y, u, lam, mu):
        g = dist_small(y)
        s = jnp.maximum(lam + mu * g, 0.0)
        return cost_small(y, u) + jnp.sum(s * s - lam * lam) / (2.0 * mu)

    def al_value(u, lam, mu):
        return al_from(outputs(u), u, lam, mu)

    def gn_step(u, lam, mu):
        def out_aux(uu):
            yy = outputs(uu)
            return yy, yy

        jy, y = jax.jacfwd(out_aux, has_aux=True)(u)       # (ny, n_var), (ny,)
        g = dist_small(y)
        s = jnp.maximum(lam + mu * g, 0.0)
        act = (s > 0.0).astype(dtype)

        gy = jax.jacfwd(dist_small)(y)                     # (n_con, ny) tiny
        fy = jax.grad(cost_small, argnums=0)(y, u)         # (ny,)
        fu = jax.grad(cost_small, argnums=1)(y, u)         # (n_var,)
        hyy = jax.hessian(cost_small, argnums=0)(y, u)     # (ny, ny) tiny
        huu = jax.hessian(cost_small, argnums=1)(y, u)     # (n_var, n_var)
        hyu = jax.jacfwd(jax.grad(cost_small, argnums=0), argnums=1)(y, u)

        f0 = al_from(y, u, lam, mu)
        grad = jy.T @ (fy + gy.T @ s) + fu
        gj = gy @ jy                                       # (n_con, n_var)
        h = (
            jy.T @ (hyy @ jy + hyu)
            + hyu.T @ jy
            + huu
            + mu * gj.T @ (gj * act[:, None])
        )

        diag_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(h))), 1.0)
        damp = cfg.newton_damping * diag_scale
        eye = jnp.eye(n_var, dtype=dtype)

        # unrolled tiny-SPD solves (see _solve_spd_unrolled): fused vector
        # arithmetic instead of two library custom-calls
        hs = 0.5 * (h + h.T)
        d0 = _newton_solve(hs + damp * eye, -grad)
        d1 = _newton_solve(hs + diag_scale * eye, -grad)
        d = jnp.where(jnp.all(jnp.isfinite(d0)), d0, d1)

        alphas = 0.5 ** jnp.arange(cfg.n_linesearch, dtype=dtype)
        cands = jax.vmap(lambda al_: jnp.clip(u + al_ * d, lo, hi))(alphas)
        if cfg.linesearch == "linearized":
            # score candidates on the linearized rollout (reuses jy — no
            # extra tube evaluations); exact tiny y-space maps on top
            vals = jax.vmap(
                lambda uu: al_from(y + jy @ (uu - u), uu, lam, mu)
            )(cands)
        else:
            vals = jax.vmap(lambda uu: al_value(uu, lam, mu))(cands)
        vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
        best = jnp.argmin(vals)
        return jnp.where(vals[best] < f0, cands[best], u)

    def outer_step(carry, _):
        u, lam, mu = carry

        def inner(u_, _):
            return gn_step(u_, lam, mu), None

        u, _ = jax.lax.scan(inner, u, None, length=cfg.n_inner)
        g = dist_small(outputs(u))
        lam = jnp.maximum(lam + mu * g, 0.0)
        mu = mu * cfg.mu_growth
        return (u, lam, mu), None

    u0 = jnp.clip(u0, lo, hi)
    (u_fin, lam_fin, _), _ = jax.lax.scan(
        outer_step, (u0, lam_init, jnp.asarray(cfg.mu0, dtype)), None,
        length=cfg.n_outer,
    )

    def do_polish(u_in, n_steps=0):
        def polish_step(u, _):
            def out_aux(uu):
                yy = outputs(uu)
                return yy, yy

            jy, y = jax.jacfwd(out_aux, has_aux=True)(u)
            g = dist_small(y)
            v = jnp.maximum(g, 0.0)
            jac = jax.jacfwd(dist_small)(y) @ jy
            jtv = jac.T @ v
            jtj = jac.T @ (jac * (g > 0.0)[:, None])
            d = _newton_solve(jtj + 1e-6 * jnp.eye(n_var, dtype=dtype), -jtv)
            # backtracking over the GN direction (same Jacobian): the single
            # full-step accept/reject stalls on curved constraint boundaries
            alphas = jnp.asarray([1.0, 0.5, 0.25, 0.125], dtype)
            cands = jax.vmap(lambda al_: jnp.clip(u + al_ * d, lo, hi))(alphas)
            viols = jax.vmap(
                lambda uu: jnp.sum(jnp.maximum(dist_small(outputs(uu)), 0.0))
            )(cands)
            best = jnp.argmin(viols)
            take = viols[best] < jnp.sum(v)
            return jnp.where(take, cands[best], u), None

        u_out, _ = jax.lax.scan(polish_step, u_in, None,
                                length=n_steps or cfg.n_polish)
        return u_out

    if cfg.n_polish > 0:
        u_fin = do_polish(u_fin)

    if cfg.n_rescue_outer > 0:
        # rescue burst: continue the AL penalty schedule from the polished
        # primal with fresh multipliers (IPOPT's restore-then-reoptimize)
        mu_r = jnp.asarray(cfg.mu0 * cfg.mu_growth ** cfg.n_outer, dtype)
        (u_fin, _, _), _ = jax.lax.scan(
            outer_step, (u_fin, jnp.zeros_like(lam_init), mu_r), None,
            length=cfg.n_rescue_outer,
        )
        if cfg.n_polish > 0:
            u_fin = do_polish(u_fin)

    if cfg.n_polish_extra > 0:
        # violation-gated extra restoration (see SqpConfig.n_polish_extra):
        # free at runtime when the schedule already converged — the gate's
        # distance evaluation doubles as the return value on that path
        g_gate = dist_small(outputs(u_fin))
        still_bad = jnp.sum(jnp.maximum(g_gate, 0.0)) > cfg.feas_tol

        def _restore(u, g):
            u2 = do_polish(u, cfg.n_polish_extra)
            return u2, dist_small(outputs(u2))

        u_fin, g_fin = jax.lax.cond(
            still_bad, _restore, lambda u, g: (u, g), u_fin, g_gate
        )
        return u_fin, lam_fin, g_fin

    return u_fin, lam_fin, dist_small(outputs(u_fin))


def solve_safempc_nlp(
    ssm: GPSSM,
    x0: jax.Array,
    u_init: jax.Array,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    u_min: jax.Array,
    u_max: jax.Array,
    h_mat_obs: jax.Array,
    h_obs: jax.Array,
    h_mat_safe: jax.Array,
    h_safe: jax.Array,
    cost_fn: Callable,
    cfg: SqpConfig,
    lam_init: jax.Array | None = None,
):
    """Solve one safety(+performance) NLP.

    Returns (k_ff (n_safe, n_u), feasible, violation, info); ``info`` carries
    the FULL decision matrix as ``warm_next`` (n_warm, n_u) for the shifted
    warm start, the final multipliers as ``lam`` (dual warm start for the
    next receding-horizon solve — this is what lets a short-budget warm solve
    keep constraints active), and the final objective value.

    ``u_init`` is the warm start (shifted previous solution — the same
    warm-start scheme as the reference NLP, SURVEY.md §2.5); its row count is
    ``sqp_warm_len(cfg)``. ``lam_init`` optionally warm-starts the duals.
    """
    t_len = cfg.n_safe
    n_u = u_min.shape[0]
    dtype = x0.dtype
    k_fb_all = jnp.tile(k_fb[None], (t_len, 1, 1))

    objective, constraints, outputs, cost_small, dist_small = (
        _build_constraint_fn(
            ssm, x0, k_fb_all, a, b, cfg,
            h_mat_obs, h_obs, h_mat_safe, h_safe, cost_fn,
        )
    )

    t_total = sqp_warm_len(cfg)
    n_s = x0.shape[0]
    lo = jnp.tile(u_min, t_total)
    hi = jnp.tile(u_max, t_total)
    if cfg.opt_k_fb:
        n_dk = t_len * n_u * n_s
        lo = jnp.concatenate([lo, jnp.full((n_dk,), -cfg.k_fb_bound, dtype)])
        hi = jnp.concatenate([hi, jnp.full((n_dk,), cfg.k_fb_bound, dtype)])
    n_con = (t_len * h_obs.shape[0]) + h_safe.shape[0]

    u0 = u_init.reshape(-1)
    if cfg.opt_k_fb:
        u0 = jnp.concatenate([u0, jnp.zeros((t_len * n_u * n_s,), dtype)])
    lam0 = jnp.zeros((n_con,), dtype) if lam_init is None else lam_init
    if cfg.hessian == "gn":
        u_fin, lam_fin, g_fin = solve_al_nlp_gn(
            outputs, cost_small, dist_small, u0, lo, hi, cfg, lam0
        )
    else:
        u_fin, lam_fin, g_fin = solve_al_nlp(
            objective, constraints, u0, lo, hi, cfg, lam_init=lam0
        )
    violation = jnp.sum(jnp.maximum(g_fin, 0.0))
    feasible = violation <= cfg.feas_tol
    n_ctrl_flat = t_total * n_u
    u_mat = u_fin[:n_ctrl_flat].reshape(t_total, n_u)
    info = {
        "cost": objective(u_fin),
        "max_constraint": jnp.max(g_fin),
        "warm_next": u_mat,
        "lam": lam_fin,
    }
    if cfg.opt_k_fb:
        info["k_fb_delta"] = u_fin[n_ctrl_flat:].reshape(t_len, n_u, n_s)
    return u_mat[:t_len], feasible, violation, info


def make_sqp_planner(
    env: Env,
    k_fb: jax.Array,
    a: jax.Array,
    b: jax.Array,
    cost_fn: Callable,
    cfg: SqpConfig,
):
    """Wrap the NLP solve in the SafeMPC planner protocol
    (``planner(key, ssm, x0, warm_mean[, lam]) -> (k_ff, feasible, violation,
    info)``). The PRNG key is unused (deterministic solver) but kept for seam
    parity with the CEM planner; the optional ``lam`` is the dual warm start
    (see ``sqp_n_duals``)."""
    spec = env.spec

    def planner(key, ssm: GPSSM, x0: jax.Array, warm_mean: jax.Array,
                lam: jax.Array | None = None):
        del key
        return solve_safempc_nlp(
            ssm, x0, warm_mean, k_fb, a, b,
            spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            cost_fn, cfg, lam_init=lam,
        )

    return planner


def sqp_n_duals(env: Env, cfg: SqpConfig) -> int:
    """Number of inequality multipliers of the safety NLP (for dual warm
    starts carried in SafeMPCState)."""
    spec = env.spec
    return cfg.n_safe * spec.h_obs.shape[0] + spec.h_safe.shape[0]


def shift_duals(lam: jax.Array, n_safe: int, n_obs: int) -> jax.Array:
    """Receding-horizon dual shift: stage-t multipliers warm-start from the
    previous solve's stage t+1 (last stage duplicated); terminal multipliers
    carry over unchanged. Mirrors the primal warm-start shift (SURVEY.md §2.5).
    """
    stage = lam[: n_safe * n_obs].reshape(n_safe, n_obs)
    stage = jnp.concatenate([stage[1:], stage[-1:]], axis=0)
    return jnp.concatenate([stage.reshape(-1), lam[n_safe * n_obs:]])
