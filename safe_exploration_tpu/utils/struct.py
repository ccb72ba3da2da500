"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children,
except those declared with ``field(pytree_node=False)``, which are static
metadata carried in the treedef (kernel-type tuples, sample counts). Instances
get a ``.replace(**changes)`` method. Built on
``jax.tree_util.register_dataclass``, so the package needs nothing beyond JAX
for its state containers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax

__all__ = ["dataclass", "field"]


def field(*, pytree_node: bool = True, **kwargs: Any) -> Any:
    """``dataclasses.field`` that records whether the field is a pytree child
    (``pytree_node=True``) or static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes: Any):
    return dataclasses.replace(self, **changes)


def dataclass(cls: type) -> type:
    """Make ``cls`` a frozen dataclass registered as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )
