"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children,
except those declared ``field(pytree_node=False)``, which are static
metadata (hashable, part of the tree structure). Instances get a
``replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = dataclasses.replace
    return cls
