"""Frozen dataclasses registered as JAX pytrees (State, Grid,
Fast2DState)."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Frozen dataclass whose fields are all pytree data (array leaves or
    None), with ``.replace(**changes)`` returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self,
                                                              **changes)
    return jax.tree_util.register_dataclass(cls)
