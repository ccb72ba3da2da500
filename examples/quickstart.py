"""Quickstart: safe episodic learning on the inverted pendulum.

Runs a small end-to-end experiment (plan -> act -> update-GP) and, if
matplotlib is available, saves a picture of the predicted safety tube over the
safe/state polytopes next to the realized trajectory.

    python examples/quickstart.py            # GPU if available, else CPU
    JAX_PLATFORMS=cpu python examples/quickstart.py
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_exploration_tpu.reachability.onestep import multistep_reachability
from safe_exploration_tpu.runtime.config import ExperimentConfig, build_experiment
from safe_exploration_tpu.runtime.episode import run_episodic


def main() -> None:
    cfg = ExperimentConfig(
        name="quickstart", solver="cem", n_safe=4, n_max=256,
        cem_samples=96, cem_elites=16, cem_iterations=5,
        n_ep=3, n_steps=25, n_init_samples=30, hyp_iters=80,
    )
    exp = build_experiment(cfg)
    out = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"],
        exp["a"], exp["b"], exp["k_fb"],
        key=jax.random.PRNGKey(cfg.seed), kern_types=exp["kern_types"],
        n_max=cfg.n_max, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
        make_ssm=exp["make_ssm"],
    )
    s = out["series"]
    print("per-episode violations:      ", s["violations"])
    print("per-episode feasibility rate:", [round(v, 3) for v in s["feasibility_rate"]])
    print("per-episode model error:     ", [f"{v:.2e}" for v in s["model_error"]])

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from safe_exploration_tpu.visualization import (
            plot_safety_bounds,
            plot_tube_2d,
        )
    except ImportError:
        print("matplotlib not available; skipping the tube plot")
        return

    # predicted tube from a nontrivial state with the learned model
    ssm = out["ssm"]
    x0 = jnp.asarray([0.1, 0.2], exp["a"].dtype)
    t_len = cfg.n_safe
    k_fb_all = jnp.tile(exp["k_fb"][None], (t_len, 1, 1))
    p_traj, q_traj, _ = multistep_reachability(
        ssm, x0, jnp.zeros((t_len, 1), x0.dtype), k_fb_all,
        exp["a"], exp["b"], cfg.c_safety,
    )
    fig, ax = plt.subplots(figsize=(6, 5))
    spec = exp["env"].spec
    plot_safety_bounds(spec.h_mat_obs, spec.h_obs, ax=ax, color="r")
    plot_safety_bounds(spec.h_mat_safe, spec.h_safe, ax=ax, color="g")
    plot_tube_2d(p_traj, q_traj, ax=ax)
    ax.scatter([float(x0[0])], [float(x0[1])], marker="*", s=80, c="k")
    ax.set_xlabel("theta [rad]")
    ax.set_ylabel("omega [rad/s]")
    ax.set_title("Predicted safety tube under the LQR fallback (H=%d)" % t_len)
    fig.savefig("quickstart_tube.png", dpi=120, bbox_inches="tight")
    print("wrote quickstart_tube.png")


if __name__ == "__main__":
    main()
