"""The in-repo pytree dataclass (safe_exploration_tpu/utils/struct.py)."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_exploration_tpu.utils import struct


@struct.dataclass
class _State:
    a: jax.Array
    b: dict
    name: str = struct.field(pytree_node=False, default="s")


def _state():
    return _State(a=jnp.arange(3.0), b={"c": jnp.ones((2, 2))}, name="x")


def test_pytree_round_trip_and_static_fields():
    s = _state()
    leaves, treedef = jax.tree.flatten(s)
    assert len(leaves) == 2            # name is metadata, not a leaf
    back = jax.tree.unflatten(treedef, leaves)
    assert back.name == "x"
    np.testing.assert_array_equal(back.a, s.a)
    # static fields are part of the treedef: different values, different trees
    other = jax.tree.structure(s.replace(name="y"))
    assert other != treedef
    # treedefs pickle (runtime/checkpoint stores them)
    assert pickle.loads(pickle.dumps(treedef)) == treedef


def test_replace_and_frozen():
    s = _state()
    t = s.replace(a=s.a + 1.0)
    np.testing.assert_array_equal(t.a, jnp.arange(3.0) + 1.0)
    np.testing.assert_array_equal(s.a, jnp.arange(3.0))
    assert t.name == "x"
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.a = s.a


def test_jit_and_vmap_through_dataclass():
    @jax.jit
    def f(s):
        assert s.name == "x"           # static under jit
        return s.replace(a=2.0 * s.a)

    np.testing.assert_array_equal(f(_state()).a, 2.0 * jnp.arange(3.0))

    batch = jax.tree.map(lambda x: jnp.stack([x, x + 1.0]), _state())
    out = jax.vmap(lambda s: jnp.sum(s.a) + jnp.sum(s.b["c"]))(batch)
    np.testing.assert_allclose(out, [3.0 + 4.0, 6.0 + 8.0])
