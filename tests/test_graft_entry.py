"""Gate tests for __graft_entry__.

The public ``dryrun_multichip`` wrapper is subprocess-isolated with a forced
virtual CPU mesh; these tests pin that the wrapper survives a parent
environment that asks for another platform.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_survives_hostile_parent_env():
    """Call the public wrapper from a parent whose env requests a platform
    that does not exist here — the child must still run on the virtual CPU
    mesh."""
    env = dict(os.environ)
    # no CPU forcing, platform pinned elsewhere
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "no_such_platform"  # the wrapper must override this
    code = (
        "import __graft_entry__ as g; g.dryrun_multichip(4); print('WRAP-OK')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "WRAP-OK" in proc.stdout
    assert "dryrun_multichip OK: 4 devices" in proc.stdout


def test_entry_compiles_and_runs():
    """entry() must return (fn, args) with fn jittable on this backend."""
    import jax

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.pop(0)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    k_ff, feasible, violation, cost = out
    assert k_ff.shape == (5, 1)
