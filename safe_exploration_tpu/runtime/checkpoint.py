"""Checkpoint / resume of experiment state.

The reference has NO mid-run resume (SURVEY.md §5.4 — sacred only stores config
and metrics). Here the full experiment state — GP dataset + posterior factors +
hyperparameters, SafeMPC controller state (stored safe plan, failure counters,
warm starts), RNG key and episode counter — is a pytree, so checkpointing is
exact: a resumed run continues bit-identically (same RNG stream, same factors).

Two backends behind one API:

  * ``pickle`` (default) — leaf arrays + pickled treedef in one file. Small,
    exact, host-local; right for the single-host experiment states.
  * ``orbax``  — the leaves go through orbax/tensorstore, which writes
    SHARDED arrays shard-by-shard without gathering them to one host, and
    restores them onto a mesh given a template state. This is the
    checkpoint path for the multi-chip tier (data-sharded SparseGP factors,
    parallel/sharded_gp.py); pinned on the 8-device CPU mesh in
    tests/test_runtime.py.

Auto-detection on load: a directory is an orbax checkpoint, a file is pickle.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_TREEDEF_SIDECAR = "treedef.pkl"


def _save_orbax(path: str, state: Any) -> str:
    import orbax.checkpoint as ocp

    leaves, treedef = jax.tree.flatten(state)
    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    # leaves as a list pytree: orbax stores each (possibly sharded) array via
    # tensorstore — no host gather for sharded leaves
    ckptr.save(path, leaves, force=True)
    with open(os.path.join(path, _TREEDEF_SIDECAR), "wb") as f:
        pickle.dump(treedef, f)
    return path


def _load_orbax(path: str, template: Any | None) -> Any:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with open(os.path.join(path, _TREEDEF_SIDECAR), "rb") as f:
        treedef = pickle.load(f)
    ckptr = ocp.PyTreeCheckpointer()
    if template is not None:
        # restore each leaf with the template's sharding/dtype (lands sharded
        # on the mesh directly — the multi-chip resume path)
        tmpl_leaves = jax.tree.leaves(template)
        args = ocp.args.PyTreeRestore(
            tmpl_leaves,
            restore_args=jax.tree.map(
                lambda t: ocp.ArrayRestoreArgs(sharding=t.sharding)
                if hasattr(t, "sharding") else ocp.RestoreArgs(),
                tmpl_leaves,
            ),
        )
        leaves = ckptr.restore(path, args=args)
    else:
        leaves = ckptr.restore(path)
    return jax.tree.unflatten(treedef, leaves)


def save_checkpoint(path: str, state: Any, *, backend: str = "pickle") -> str:
    """Serialize a pytree (pytree dataclasses included) to ``path``.

    Static metadata (e.g. GP kernel-type tuples) lives in the treedef and is
    pickled alongside the leaf arrays. ``backend="orbax"`` writes a directory
    checkpoint with shard-parallel array IO (see module docstring).
    """
    if backend == "orbax":
        return _save_orbax(path, state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, treedef = jax.tree.flatten(state)
    arrays = [np.asarray(jax.device_get(leaf)) for leaf in leaves]
    with open(path, "wb") as f:
        pickle.dump({"treedef": treedef, "leaves": arrays}, f)
    return path


def load_checkpoint(path: str, *, template: Any | None = None) -> Any:
    """Restore a pytree saved by :func:`save_checkpoint`.

    Backend auto-detected: directory -> orbax (``template`` restores sharded
    leaves directly onto the template's mesh placement), file -> pickle.
    """
    import jax.numpy as jnp

    if os.path.isdir(path):
        return _load_orbax(path, template)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    leaves = [jnp.asarray(a) for a in blob["leaves"]]
    return jax.tree.unflatten(blob["treedef"], leaves)


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    """Highest-numbered ``{prefix}{step}.pkl`` in ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".pkl"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best
