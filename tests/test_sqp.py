"""SQP (IPOPT-replacement) solver tests: feasibility, local optimality vs random
feasible perturbations, CEM cross-check, infeasibility detection, vmap batching
(SURVEY.md §7 P6 gate, adapted: no CasADi oracle available — cross-checks are
against our own CEM + perturbation optimality, per SURVEY.md hard-part #3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.runtime.config import ExperimentConfig, build_experiment
from safe_exploration_tpu.runtime.episode import collect_initial_data, run_episodic
from safe_exploration_tpu.models import make_gp_ssm, ssm_fit
from safe_exploration_tpu.models.ssm import estimate_lipschitz
from safe_exploration_tpu.solvers.cem import tube_violation
from safe_exploration_tpu.reachability import multistep_reachability


def sqp_cfg(**kw):
    base = dict(
        name="sqp_test", solver="sqp", n_safe=4, n_max=96,
        sqp_outer=10, sqp_inner=5,
        n_ep=2, n_steps=10, n_init_samples=30, hyp_iters=120,
    )
    base.update(kw)
    return ExperimentConfig(**base)


@pytest.fixture(scope="module")
def setup():
    cfg = sqp_cfg()
    exp = build_experiment(cfg, dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    xs, us, resid = collect_initial_data(exp["env"], key, 30, exp["a"], exp["b"], exp["k_fb"])
    ssm = make_gp_ssm(exp["kern_types"], xs, us, resid, n_max=96,
                      l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], log_noise=-4.0)
    ssm = ssm_fit(ssm, iters=120)
    ssm = estimate_lipschitz(ssm, ssm.gp.x)
    return exp, ssm, key


def test_sqp_feasible_and_constraint_satisfying(setup):
    exp, ssm, key = setup
    x0 = jnp.asarray([0.1, 0.2], jnp.float64)
    kff, feas, viol, info = exp["planner"](key, ssm, x0, jnp.zeros((4, 1), jnp.float64))
    assert bool(feas) and float(viol) == 0.0
    assert float(info["max_constraint"]) < 0
    # controls within bounds
    spec = exp["env"].spec
    assert np.all(np.abs(np.asarray(kff)) <= float(spec.u_max[0]) + 1e-9)


def test_sqp_local_optimality_vs_perturbations(setup):
    """No random feasible perturbation of the solution may beat its cost."""
    exp, ssm, key = setup
    spec = exp["env"].spec
    x0 = jnp.asarray([0.1, 0.2], jnp.float64)
    kff, feas, _, info = exp["planner"](key, ssm, x0, jnp.zeros((4, 1), jnp.float64))
    assert bool(feas)
    cost_star = float(info["cost"])

    kfb4 = jnp.tile(exp["k_fb"][None], (4, 1, 1))

    def eval_candidate(k):
        p_t, q_t, v_t = multistep_reachability(ssm, x0, k, kfb4, exp["a"], exp["b"], 2.0)
        viol = tube_violation(p_t, q_t, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe)
        return exp["cost_fn"](p_t, q_t, v_t, k), viol

    rng = np.random.default_rng(1)
    beaten = 0
    for scale in (1e-3, 1e-2, 5e-2):
        for _ in range(30):
            pert = jnp.asarray(rng.standard_normal((4, 1)) * scale)
            cand = jnp.clip(kff + pert, spec.u_min, spec.u_max)
            c, v = eval_candidate(cand)
            if float(v) <= 1e-9 and float(c) < cost_star - 1e-7:
                beaten += 1
    assert beaten == 0, f"{beaten} feasible perturbations beat the SQP solution"


def test_sqp_beats_or_matches_cem(setup):
    exp, ssm, key = setup
    cem_exp = build_experiment(
        sqp_cfg(name="cem_ref", solver="cem", cem_samples=128, cem_iterations=8),
        dtype=jnp.float64,
    )
    x0 = jnp.asarray([0.12, -0.15], jnp.float64)
    warm = jnp.zeros((4, 1), jnp.float64)
    _, f_sqp, _, i_sqp = exp["planner"](key, ssm, x0, warm)
    _, f_cem, _, i_cem = cem_exp["planner"](key, ssm, x0, warm)
    assert bool(f_sqp) and bool(f_cem)
    assert float(i_sqp["cost"]) <= float(i_cem["cost"]) + 1e-4


def test_sqp_detects_infeasible(setup):
    exp, ssm, key = setup
    # start far outside the obs polytope: no control sequence can recover
    x0 = jnp.asarray([2.0, 3.0], jnp.float64)
    _, feas, viol, _ = exp["planner"](key, ssm, x0, jnp.zeros((4, 1), jnp.float64))
    assert not bool(feas)
    assert float(viol) > 0.1


def test_sqp_vmaps_over_states(setup):
    """The north-star shape: a batch of NLP solves in one XLA program."""
    exp, ssm, key = setup
    x0s = jnp.asarray(np.random.default_rng(2).uniform(-0.15, 0.15, (8, 2)))
    warm = jnp.zeros((4, 1), jnp.float64)
    kffs, feas, viols, _ = jax.jit(jax.vmap(
        lambda x: exp["planner"](key, ssm, x, warm)
    ))(x0s)
    assert kffs.shape == (8, 4, 1)
    assert bool(jnp.all(feas)), np.asarray(viols)
    # batched result matches the single solve
    k_single, _, _, _ = exp["planner"](key, ssm, x0s[3], warm)
    np.testing.assert_allclose(np.asarray(kffs[3]), np.asarray(k_single), rtol=1e-8, atol=1e-10)


def test_sqp_episodic_zero_violations(key):
    cfg = sqp_cfg()
    exp = build_experiment(cfg, dtype=jnp.float64)
    out = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"],
        key=key, kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
    )
    s = out["series"]
    assert sum(s["violations"]) == 0
    assert all(f > 0.5 for f in s["feasibility_rate"]), s["feasibility_rate"]


def test_gn_matches_exact_hessian_solution(setup):
    """The default Gauss-Newton curvature model must reach the exact-Hessian
    path's solution quality on a well-conditioned instance: both feasible,
    costs within 1e-3 relative, controls close."""
    from safe_exploration_tpu.solvers.costs import tracking_cost
    from safe_exploration_tpu.solvers.sqp import SqpConfig, solve_safempc_nlp

    exp, ssm, key = setup
    spec = exp["env"].spec
    cost_fn = tracking_cost(spec.target)
    x0 = jnp.asarray([0.1, 0.25], jnp.float64)
    warm = jnp.zeros((4, 1), jnp.float64)
    base = dict(n_safe=4, c_safety=2.0, n_outer=10, n_inner=3)

    outs = {}
    for mode in ("gn", "exact"):
        cfg = SqpConfig(**base, hessian=mode)
        k_ff, feas, viol, info = solve_safempc_nlp(
            ssm, x0, warm, exp["k_fb"], exp["a"], exp["b"],
            spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            cost_fn, cfg,
        )
        assert bool(feas), (mode, float(viol))
        outs[mode] = (np.asarray(k_ff), float(info["cost"]))

    c_gn, c_ex = outs["gn"][1], outs["exact"][1]
    assert abs(c_gn - c_ex) / (abs(c_ex) + 1e-9) < 1e-3, (c_gn, c_ex)
    np.testing.assert_allclose(outs["gn"][0], outs["exact"][0], atol=5e-3)


def test_gn_handles_exploration_objective(setup):
    """GN curvature with a non-convex (information-gain) objective: the
    y-space Hessian can be indefinite; Levenberg damping must keep the
    solve finite and feasible."""
    from safe_exploration_tpu.solvers.costs import exploration_cost
    from safe_exploration_tpu.solvers.sqp import SqpConfig, solve_safempc_nlp

    exp, ssm, key = setup
    spec = exp["env"].spec
    cfg = SqpConfig(n_safe=4, c_safety=2.0, n_outer=8, n_inner=3)
    k_ff, feas, viol, info = solve_safempc_nlp(
        ssm, jnp.asarray([0.05, 0.1], jnp.float64),
        jnp.zeros((4, 1), jnp.float64),
        exp["k_fb"], exp["a"], exp["b"], spec.u_min, spec.u_max,
        spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
        exploration_cost(), cfg,
    )
    assert bool(feas), float(viol)
    assert np.isfinite(float(info["cost"]))
    # information-seeking: better than doing nothing
    assert float(info["cost"]) < 0.0


def test_linearized_linesearch_solves_easy_instances(setup):
    """The linearized line-search knob (throughput mode: candidates scored on
    y + Jy du instead of re-rolled tubes) must still converge clearly-feasible
    instances; it costs ~4pp cold-start feasibility — default stays
    "exact"."""
    from safe_exploration_tpu.solvers.sqp import SqpConfig, make_sqp_planner

    exp, ssm, key = setup
    scfg = SqpConfig(n_safe=4, c_safety=2.0, n_outer=10, n_inner=5,
                     linesearch="linearized")
    planner = make_sqp_planner(
        exp["env"], exp["k_fb"], exp["a"], exp["b"], exp["cost_fn"], scfg
    )
    for x0 in ([0.1, 0.2], [0.0, -0.3], [-0.1, 0.1]):
        kff, feas, viol, _ = planner(
            key, ssm, jnp.asarray(x0, jnp.float64),
            jnp.zeros((4, 1), jnp.float64),
        )
        assert bool(feas), (x0, float(viol))


def test_unrolled_spd_solve_matches_lapack(setup):
    """The unrolled tiny-Cholesky Newton solve (custom-call elimination) must
    match jnp.linalg solves to f64 tolerance, batched and unbatched."""
    from safe_exploration_tpu.solvers.sqp import _solve_spd_unrolled

    rng = np.random.default_rng(0)
    for n in (2, 5, 9):
        m = rng.standard_normal((n, n))
        h = jnp.asarray(m @ m.T + n * np.eye(n))
        g = jnp.asarray(rng.standard_normal(n))
        d = _solve_spd_unrolled(h, g)
        np.testing.assert_allclose(
            np.asarray(d), np.linalg.solve(np.asarray(h), np.asarray(g)),
            rtol=1e-9,
        )
    # batched under vmap
    ms = rng.standard_normal((7, 5, 5))
    hs = jnp.asarray(ms @ ms.transpose(0, 2, 1) + 5 * np.eye(5))
    gs = jnp.asarray(rng.standard_normal((7, 5)))
    ds = jax.vmap(_solve_spd_unrolled)(hs, gs)
    np.testing.assert_allclose(
        np.asarray(ds),
        np.linalg.solve(np.asarray(hs), np.asarray(gs)[..., None])[..., 0],
        rtol=1e-8,
    )
    # indefinite matrix -> NaN (the caller's fallback trigger), not garbage
    bad = jnp.asarray(np.diag([1.0, -1.0, 1.0, 1.0, 1.0]))
    d_bad = _solve_spd_unrolled(bad, jnp.ones(5))
    assert not bool(jnp.all(jnp.isfinite(d_bad)))


def test_rescue_burst_recovers_stalled_nlp():
    """The rescue burst (extra AL outers warm-started from the polished primal
    with fresh multipliers at a boosted penalty — IPOPT's restore-then-
    reoptimize move) must converge an instance the first AL pass provably
    stalls on. Deterministic synthetic stall: min (u+2)^2 s.t. u >= 0 with a
    deliberately under-penalized 1-outer budget leaves u = -1.6 (violation
    1.6); the rescue continues the penalty schedule and must land on the
    KKT point u* = 0. Pinned on BOTH AL cores (exact-Hessian and GN)."""
    from safe_exploration_tpu.solvers.sqp import (
        SqpConfig,
        solve_al_nlp,
        solve_al_nlp_gn,
    )

    obj = lambda u: jnp.sum((u + 2.0) ** 2)
    con = lambda u: -u  # u >= 0
    u0 = jnp.asarray([-1.5])
    lo, hi = jnp.asarray([-5.0]), jnp.asarray([5.0])
    outputs = lambda u: u
    cost_small = lambda y, u: jnp.sum((u + 2.0) ** 2)
    dist_small = lambda y: -y

    def solve(core, resc):
        cfg = SqpConfig(n_outer=1, n_inner=2, mu0=0.5, mu_growth=3.0,
                        n_polish=0, n_rescue_outer=resc)
        if core == "exact":
            u, _, g = solve_al_nlp(obj, con, u0, lo, hi, cfg)
        else:
            u, _, g = solve_al_nlp_gn(outputs, cost_small, dist_small,
                                      u0, lo, hi, cfg, jnp.zeros((1,)))
        return float(u[0]), float(jnp.maximum(g, 0.0).sum())

    for core in ("exact", "gn"):
        u_stall, viol_stall = solve(core, 0)
        assert viol_stall > 1.0, (core, viol_stall)  # genuinely stalled
        u_resc, viol_resc = solve(core, 6)
        assert viol_resc < 1e-4, (core, viol_resc)
        assert abs(u_resc) < 1e-3, (core, u_resc)  # at the KKT point


def test_rescue_burst_monotone_on_mpc(setup):
    """On the real MPC problem the rescue/backtracking-polish path must never
    flip a feasible lane to infeasible (every restoration step is guarded to
    reject violation-increasing candidates), and the extra optimization must
    not degrade the feasible lanes' objective."""
    from safe_exploration_tpu.solvers.sqp import SqpConfig, make_sqp_planner

    exp, ssm, key = setup

    def planner_for(**kw):
        scfg = SqpConfig(n_safe=4, c_safety=2.0, n_outer=2, n_inner=2, **kw)
        return make_sqp_planner(
            exp["env"], exp["k_fb"], exp["a"], exp["b"], exp["cost_fn"], scfg
        )

    base = planner_for(n_polish=0, n_rescue_outer=0)
    rescued = planner_for(n_polish=3, n_rescue_outer=3)
    rng = np.random.default_rng(7)
    x0s = jnp.asarray(rng.uniform(-1.0, 1.0, (16, 2)) * np.array([0.15, 0.4]))
    warm = jnp.zeros((4, 1), jnp.float64)
    _, feas_b, _, info_b = jax.jit(jax.vmap(
        lambda x: base(key, ssm, x, warm)
    ))(x0s)
    _, feas_r, _, info_r = jax.jit(jax.vmap(
        lambda x: rescued(key, ssm, x, warm)
    ))(x0s)
    feas_b = np.asarray(feas_b)
    feas_r = np.asarray(feas_r)
    assert feas_r[feas_b].all()
    both = feas_b & feas_r
    cost_b = np.asarray(info_b["cost"])[both]
    cost_r = np.asarray(info_r["cost"])[both]
    assert (cost_r <= cost_b + 1e-6).all(), (cost_b, cost_r)
