"""Runtime subsystem tests: exploration runner, MC uncertainty validation,
metrics JSONL, exact checkpoint/resume, CLI dispatch, visualization.

Parity model: the reference's integration smoke tests + sacred metric flow
(SURVEY.md §4.4, §5.4-§5.5) — sized tiny so the whole file runs in seconds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.runtime.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from safe_exploration_tpu.runtime.config import CONFIGS, ExperimentConfig
from safe_exploration_tpu.runtime.metrics import AggregatedMetrics


def _tiny_cfg(**kw):
    base = dict(
        name="tiny", solver="cem", n_safe=3, n_max=64,
        cem_samples=32, cem_elites=8, cem_iterations=3,
        n_ep=1, n_steps=4, n_init_samples=12, hyp_iters=10,
    )
    base.update(kw)
    return ExperimentConfig(**base)


# ------------------------------------------------------------------ metrics --


def test_metrics_jsonl_roundtrip(tmp_path):
    m = AggregatedMetrics(str(tmp_path), run_name="r0")
    m.log_scalar("violations", 0, step=0)
    m.log_dict({"feasibility_rate": 1.0, "model_error": 0.01}, step=0)
    m.flush()
    m.log_scalar("violations", 1, step=1)
    m.flush()
    path = tmp_path / "r0.metrics.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 4
    assert recs[0]["name"] == "violations"
    assert m.summary()["violations"] == 1.0
    assert m.history["violations"] == [(0, 0.0), (1, 1.0)]


# --------------------------------------------------------------- checkpoint --


def test_checkpoint_exact_roundtrip(tmp_path):
    from safe_exploration_tpu.models import make_gp_ssm

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (8, 2))
    u = jax.random.normal(key, (8, 1))
    y = jax.random.normal(key, (8, 2)) * 0.01
    ssm = make_gp_ssm(
        ("rbf", "rbf"), x, u, y, n_max=16,
        l_mu=jnp.ones(2), l_sigma=jnp.ones(2),
    )
    state = {"ssm": ssm, "key": key, "episode": 3}
    p = save_checkpoint(str(tmp_path / "ckpt_3.pkl"), state)
    restored = load_checkpoint(p)
    assert restored["episode"] == 3
    np.testing.assert_array_equal(restored["ssm"].gp.beta, ssm.gp.beta)
    np.testing.assert_array_equal(restored["ssm"].gp.chol, ssm.gp.chol)
    assert restored["ssm"].gp.kern_types == ("rbf", "rbf")
    # restored model predicts identically (exact resume)
    from safe_exploration_tpu.models.ssm import ssm_predict

    z = (jnp.asarray([0.1, 0.2]), jnp.asarray([0.3]))
    np.testing.assert_array_equal(
        ssm_predict(ssm, *z)[0], ssm_predict(restored["ssm"], *z)[0]
    )


def test_latest_checkpoint_selection(tmp_path):
    for step in (1, 10, 2):
        save_checkpoint(str(tmp_path / f"ckpt_{step}.pkl"), {"s": step})
    latest = latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.endswith("ckpt_10.pkl")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


# -------------------------------------------------------------- exploration --


def test_exploration_runner_gains_information():
    from safe_exploration_tpu.runtime.config import build_experiment
    from safe_exploration_tpu.runtime.exploration import run_exploration

    cfg = _tiny_cfg(objective="exploration", task="exploration")
    exp = build_experiment(cfg, dtype=jnp.float64)
    out = run_exploration(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"],
        key=jax.random.PRNGKey(0), kern_types=exp["kern_types"],
        n_max=cfg.n_max, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_iterations=5, n_init_samples=10, opt_hyp_every=0, hyp_iters=10,
    )
    s = out["series"]
    assert len(s["info_gain"]) == 5
    assert all(g >= 0.0 for g in s["info_gain"])
    assert sum(s["violations"]) == 0
    assert s["n_data"][-1] == 15  # one transition learned per iteration


# -------------------------------------------------------------- uncertainty --


def test_uncertainty_runner_containment():
    from safe_exploration_tpu.models import make_gp_ssm
    from safe_exploration_tpu.models.ssm import estimate_lipschitz
    from safe_exploration_tpu.runtime.config import build_experiment
    from safe_exploration_tpu.runtime.episode import collect_initial_data
    from safe_exploration_tpu.runtime.uncertainty import run_uncertainty_estimation

    cfg = _tiny_cfg()
    exp = build_experiment(cfg, dtype=jnp.float64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    xs, us, resid = collect_initial_data(
        exp["env"], k1, 20, exp["a"], exp["b"], exp["k_fb"]
    )
    ssm = make_gp_ssm(
        exp["kern_types"], xs, us, resid, n_max=64,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], log_noise=-4.0,
    )
    ssm = estimate_lipschitz(ssm, ssm.gp.x)
    out = run_uncertainty_estimation(
        exp["env"], ssm, exp["a"], exp["b"], exp["k_fb"],
        key=k2, x0=jnp.zeros(2, jnp.float64),
        k_ff_all=jnp.zeros((3, 1), jnp.float64),
        c_safety=2.5, n_rollouts=64,
    )
    # the tube is a high-confidence over-approximation: near-total containment
    assert out["overall_containment"] >= 0.95
    assert len(out["per_stage_containment"]) == 3


# ---------------------------------------------------------------------- CLI --


def test_cli_list_and_tiny_run(tmp_path, capsys):
    from safe_exploration_tpu.runtime.main import main

    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in CONFIGS:
        assert name in out

    rc = main([
        "--config", "pendulum_episode", "--out", str(tmp_path),
        "--set", "n_ep=1", "n_steps=3", "n_init_samples=10", "hyp_iters=10",
        "cem_samples=32", "cem_elites=8", "cem_iterations=2",
    ])
    assert rc == 0
    summary = json.loads((tmp_path / "pendulum_episode.summary.json").read_text())
    assert summary["metrics"]["violations"] == 0.0
    assert (tmp_path / "pendulum_episode.metrics.jsonl").exists()


def test_cli_rejects_unknown_config_and_field():
    from safe_exploration_tpu.runtime.main import main

    with pytest.raises(SystemExit):
        main(["--config", "nope"])
    with pytest.raises(SystemExit):
        main(["--config", "pendulum_episode", "--set", "bogus=1"])


# ------------------------------------------------------------- visualization --


def test_visualization_smoke(tmp_path):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    from safe_exploration_tpu.visualization import plot_ellipsoid_2d

    fig, ax = plt.subplots()
    plot_ellipsoid_2d(
        jnp.asarray([0.1, 0.2]),
        jnp.asarray([[0.04, 0.01], [0.01, 0.09]]),
        ax=ax,
    )
    fig.savefig(tmp_path / "e.png")
    plt.close(fig)
    assert (tmp_path / "e.png").stat().st_size > 0


def test_episodic_checkpoint_resume_bit_exact(tmp_path):
    """A run interrupted after episode 0 and resumed must produce the same
    final model and series as the uninterrupted run (SURVEY.md §5.4 — the
    reference cannot do this at all)."""
    from safe_exploration_tpu.runtime.config import build_experiment
    from safe_exploration_tpu.runtime.episode import run_episodic

    cfg = _tiny_cfg(n_ep=2)
    exp = build_experiment(cfg, dtype=jnp.float64)
    kw = dict(
        key=jax.random.PRNGKey(5), kern_types=exp["kern_types"],
        n_max=cfg.n_max, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_steps=cfg.n_steps, n_init_samples=cfg.n_init_samples,
        hyp_iters=10,
    )
    full = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"], n_ep=2,
        ckpt_dir=str(tmp_path / "full"), **kw,
    )
    # interrupted: run only episode 0 (writes ckpt_0), then resume to n_ep=2
    run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"], n_ep=1,
        ckpt_dir=str(tmp_path / "part"), **kw,
    )
    resumed = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"], n_ep=2,
        ckpt_dir=str(tmp_path / "part"), resume=True, **kw,
    )
    np.testing.assert_array_equal(
        np.asarray(full["ssm"].gp.beta), np.asarray(resumed["ssm"].gp.beta)
    )
    assert [int(v) for v in resumed["series"]["violations"]] == [
        int(v) for v in full["series"]["violations"]
    ]
    assert len(resumed["series"]["violations"]) == 2


@pytest.mark.parametrize("family", ["sparse_gp", "mc_dropout"])
def test_episodic_with_alternative_ssm_families(family):
    """Config-selected SSM backends run the full episodic loop (the
    reference's ssm_cem backend seam, SURVEY.md §2.6)."""
    from safe_exploration_tpu.runtime.config import build_experiment
    from safe_exploration_tpu.runtime.episode import run_episodic

    cfg = _tiny_cfg(
        name=f"tiny_{family}", ssm=family, n_inducing=16,
        mc_hidden=(16, 16), mc_samples=4, l_mu=0.05, l_sigma=0.02,
        log_noise=-4.0,
    )
    exp = build_experiment(cfg, dtype=jnp.float64)
    out = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"],
        key=jax.random.PRNGKey(2), kern_types=exp["kern_types"],
        n_max=cfg.n_max, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_ep=1, n_steps=4, n_init_samples=12, hyp_iters=10,
        make_ssm=exp["make_ssm"],
    )
    s = out["series"]
    assert len(s["violations"]) == 1
    assert s["violations"][0] == 0
    assert s["n_data"][0] == 12
    # the model actually learned the episode's transitions
    from safe_exploration_tpu.models.ssm import ssm_n_points

    assert int(ssm_n_points(out["ssm"])) == 16


def test_cli_exploration_and_batch_tasks(tmp_path):
    """CLI dispatch covers every reference scenario (episodic tested above,
    uncertainty via its runner test) plus the batch task (BASELINE cfg 3)."""
    from safe_exploration_tpu.runtime.main import main

    rc = main([
        "--config", "pendulum_exploration", "--out", str(tmp_path),
        "--set", "n_ep=1", "n_steps=3", "n_init_samples=10", "hyp_iters=10",
        "cem_samples=16", "cem_elites=4", "cem_iterations=2", "n_max=32",
    ])
    assert rc == 0
    assert (tmp_path / "pendulum_exploration.summary.json").exists()

    rc = main([
        "--config", "pendulum_batch", "--out", str(tmp_path),
        "--set", "batch_lanes=4", "n_steps=3", "n_init_samples=12",
        "hyp_iters=10", "cem_samples=16", "cem_elites=4",
        "cem_iterations=2", "n_max=32",
    ])
    assert rc == 0
    summary = json.loads((tmp_path / "pendulum_batch.summary.json").read_text())
    assert summary["metrics"]["violations"] == 0.0
    assert summary["metrics"]["lanes"] == 4.0


def test_cli_serve_task(tmp_path):
    """The production serving surface is reachable from the CLI (VERDICT r4
    #4c): task='serve' drives the AOT-compiled ServeController against the
    simulated plant with online observe() learning and reports latency/
    feasibility/recompile counters."""
    from safe_exploration_tpu.runtime.main import main

    rc = main([
        "--config", "pendulum_serve", "--out", str(tmp_path),
        "--set", "n_steps=4", "n_init_samples=10", "hyp_iters=5",
        "sqp_outer=2", "sqp_inner=2", "n_max=32",
    ])
    assert rc == 0
    summary = json.loads((tmp_path / "pendulum_serve.summary.json").read_text())
    s = summary["series"]
    assert s["recompiles"][0] >= 1
    assert s["dropped_points"][0] == 0
    assert s["violations"][0] == 0
    assert 0.0 <= s["feasibility_rate"][0] <= 1.0
    assert s["latency_p50_ms"][0] > 0.0


def test_cli_cfg4_large_sparse_short_schedule(tmp_path):
    """BASELINE config 4 driven end-to-end through the CLI (VERDICT r4
    missing #2): the registered pendulum_large_sparse config — an N=10,240-
    capacity sparse VFE model with m=256 trained inducing inputs inside the
    episodic SQP loop — runs on a short schedule with zero violations and
    finite whitened-refit factors."""
    import numpy as np

    from safe_exploration_tpu.runtime.config import CONFIGS, build_experiment
    from safe_exploration_tpu.runtime.main import main

    cfg = CONFIGS["pendulum_large_sparse"]
    assert cfg.ssm == "sparse_gp" and cfg.n_max == 10240
    assert cfg.n_inducing == 256 and cfg.solver == "sqp"

    rc = main([
        "--config", "pendulum_large_sparse", "--out", str(tmp_path),
        "--set", "n_ep=1", "n_steps=3", "n_init_samples=64", "hyp_iters=4",
        "sqp_outer=3", "sqp_inner=2",
    ])
    assert rc == 0
    summary = json.loads(
        (tmp_path / "pendulum_large_sparse.summary.json").read_text()
    )
    assert summary["metrics"]["violations"] == 0.0
    assert np.isfinite(summary["metrics"]["model_error"])


@pytest.mark.parametrize("field,bad", [
    ("batch_backend", "lane"),
    ("cem_backend", "fast"),
    ("perf_trajectory", "exact"),
])
def test_config_backend_validation_at_construction(field, bad):
    """ADVICE r4: backend selectors are validated when the config is BUILT,
    not only inside the task dispatch that happens to read them."""
    from safe_exploration_tpu.runtime.config import ExperimentConfig

    with pytest.raises(ValueError, match=field):
        ExperimentConfig(name="bad", **{field: bad})


def test_cartpole_sqp_config_wires_joint_trajectories():
    """BASELINE config 2 on the NLP path: the registered cartpole SQP config
    builds with an H=10 safety tube + 10-stage performance trajectory sharing
    r=2 controls, and its warm/dual state is sized accordingly."""
    from safe_exploration_tpu.runtime.config import CONFIGS, build_experiment

    cfg = CONFIGS["cartpole_episode_sqp"]
    exp = build_experiment(cfg, dtype=jnp.float64)
    state = exp["init_state"]()
    assert state.warm_mean.shape == (10 + 10 - 2, 1)
    n_duals = 10 * exp["env"].spec.h_obs.shape[0] + exp["env"].spec.h_safe.shape[0]
    assert state.lam.shape == (n_duals,)


def test_orbax_backend_roundtrips_sharded_state(tmp_path):
    """The multi-chip checkpoint path: a data-sharded SparseGP saved through
    the orbax backend restores onto the mesh with shardings AND values intact
    (closes STATUS r1 gap 'orbax-based sharded checkpointing')."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from safe_exploration_tpu.models.sparse_gp import sparse_gp_init
    from safe_exploration_tpu.parallel import make_mesh, shard_sparse_gp
    from safe_exploration_tpu.runtime.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    mesh = make_mesh(8, axis="data")
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (128, 3))
    y = jax.random.normal(jax.random.fold_in(key, 1), (128, 2))
    sgp = shard_sparse_gp(
        sparse_gp_init(("rbf", "rbf"), x, y, n_max=128, n_inducing=16), mesh
    )

    path = str(tmp_path / "sgp_ckpt")
    save_checkpoint(path, sgp, backend="orbax")
    restored = load_checkpoint(path, template=sgp)

    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(sgp)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        if hasattr(want, "sharding"):
            assert got.sharding.is_equivalent_to(want.sharding, want.ndim), (
                got.sharding, want.sharding
            )
    # static metadata survives via the treedef sidecar
    assert restored.kern_types == sgp.kern_types


def test_matmul_precision_policy_active():
    """Importing the package must pin f32-accurate matmuls: a reduced-
    precision default (bf16 passes, or TF32 on GPU tensor cores) corrupts
    posterior variances through the solve-free quadratic forms and inflates
    safety tubes."""
    import jax

    import safe_exploration_tpu  # noqa: F401  (policy applies at import)

    assert str(jax.config.jax_default_matmul_precision) == "highest"
