"""Immutable dataclasses that are JAX pytrees.

``class T(PyTreeNode)`` makes ``T`` a frozen dataclass registered with
``jax.tree_util``: fields are pytree children (traced, differentiable)
unless declared ``field(pytree_node=False)``, which makes them static
metadata (hashable, part of the jit cache key).  ``t.replace(**kw)``
returns a modified copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` marks it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen, pytree-registered dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        data, meta = [], []
        for f in dataclasses.fields(cls):
            (data if f.metadata.get("pytree_node", True) else meta).append(
                f.name)
        jax.tree_util.register_dataclass(cls, data_fields=data,
                                         meta_fields=meta)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
