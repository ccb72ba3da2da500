"""Test harness configuration.

Tests run on a VIRTUAL 8-device CPU mesh with x64 enabled, so that:
  * multi-device sharding paths (shard_map / pjit) are exercised without
    GPUs;
  * f64 oracle parity vs scipy is available (the device runs in f32 — the
    library is dtype-polymorphic; the f64 path is the correctness gate per
    SURVEY.md §7 "numerics policy").

The env vars MUST be set before jax is imported anywhere.
"""

import os

# Force-override: unit tests run on the virtual CPU mesh whatever platform the
# environment asks for, so override both the env var and (after import) the
# config knob.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The whole suite compiles hundreds of XLA programs in one process; on
    single-CPU runners the accumulated compiler state has produced segfaults
    inside backend_compile (observed at ~130 compilations). Dropping the
    caches between modules bounds that state at the cost of a few recompiles.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
