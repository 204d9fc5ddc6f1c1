"""Perfect-restart checkpointing.

The reference's RST stream (def_rst/wrt_rst/get_state with PERFECT_RESTART,
SURVEY.md §5.4) maps to one numpy ``.npz`` archive of the full State
pytree's leaves in flattening order: all explicit time levels and filter
accumulators are State fields, so a restored run is bit-identical
(tests/test_step3d.py::test_restart_equivalence).
"""

from __future__ import annotations

import os

import jax
import numpy as np


def save(path: str, state) -> None:
    """Write ``<path>.npz``."""
    leaves = jax.tree_util.tree_leaves(jax.device_get(state))
    np.savez(os.path.abspath(path) + ".npz",
             *[np.asarray(x) for x in leaves])


def restore(path: str, template):
    """Restore into the structure of `template` (a State of the right
    shapes/dtypes)."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(os.path.abspath(path) + ".npz") as data:
        new = [data[f"arr_{i}"] for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, new)
