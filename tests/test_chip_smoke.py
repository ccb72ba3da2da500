"""chip_smoke.py, bench.py and their helpers on the CPU: the GPU guard, the
compile-cache rule, and each smoke phase at tiny sizes (the phases' real
widths run only on the GPU)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from safe_exploration_tpu.utils.compile_cache import (  # noqa: E402
    ENV_VAR,
    REPO_CACHE_DIR,
    compile_cache_dir,
)
from safe_exploration_tpu.utils.device import require_gpu  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout and "metric" not in proc.stdout


def test_compile_cache_dir_rule(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_VAR, str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv(ENV_VAR)
    assert compile_cache_dir() == str(REPO_CACHE_DIR)
    assert REPO_CACHE_DIR.parent == type(REPO_CACHE_DIR)(REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_in_fresh_process(tmp_path, env_set):
    """With the variable set, the cache is written there; without it, JAX is
    pointed at the fixed directory in the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(ENV_VAR, None)
    if env_set:
        env[ENV_VAR] = str(tmp_path)
    code = (
        "import jax, jax.numpy as jnp\n"
        "from safe_exploration_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        f"if {env_set}:\n"
        "    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "    jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    chosen, configured = proc.stdout.split()[:2]
    want = str(tmp_path) if env_set else str(REPO_CACHE_DIR)
    assert chosen == configured == want
    if env_set:
        assert any(tmp_path.iterdir())


def test_check_raises_outside_tolerance(capsys):
    chip_smoke.check("x", 1e-3, 1e-2, "why")
    assert "[ok]" in capsys.readouterr().out
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("x", 1.0, 1e-2, "why")
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("x", float("nan"), 1e-2, "why")


def test_phase_headline_tiny():
    chip_smoke.phase_headline(batch=8, n_max=16, n_data=8, n_safe=3, n_ref=4,
                              budget=(2, 2, 1, 0))


def test_phase_numerics_tiny():
    chip_smoke.phase_numerics(n_exact=32, n_sparse=256, m_sparse=16, n_ff=16,
                              n_ff_refit=16)


def test_phase_sharded_sparse_refit_tiny():
    chip_smoke.phase_sharded_sparse_refit(n_dev=4, n=256, m=16)
