"""Domain decomposition over a 2-D device mesh.

The reference decomposes the horizontal grid into NtileI x NtileJ MPI tiles
with 2-3 point halos exchanged via mp_exchange (SURVEY.md §2.2).  Here the
same decomposition is expressed as a `jax.sharding.Mesh(('eta','xi'))` with
NamedSharding over the last two axes of every field; XLA's SPMD partitioner
turns the roll/slice stencils and halo fills into neighbor collective
permutes automatically - the halo exchange is derived from the data
dependencies rather than hand-rolled.

(An explicit shard_map + ppermute halo path with widened halos for the fast
barotropic loop is the planned performance upgrade; this module is the
correctness-first scaling path.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple] = None) -> Mesh:
    """2-D mesh ('eta','xi').  Default shape: as square as possible with
    xi (the long, contiguous axis) getting the larger factor."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        p = int(np.sqrt(n))
        while n % p:
            p -= 1
        shape = (p, n // p)          # (eta, xi)
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, ("eta", "xi"))


def field_spec(ndim: int) -> P:
    """PartitionSpec for a field whose trailing axes are (eta, xi):
    2-D (Ny,Nx), 3-D (N,Ny,Nx), 4-D (NT,N,Ny,Nx).  Leading axes
    (k, tracer) replicated - the vertical is never decomposed."""
    lead = (None,) * (ndim - 2)
    return P(*lead, "eta", "xi")


def shard_state(mesh: Mesh, tree):
    """Place a State/Grid pytree on the mesh with (eta,xi) sharding of the
    trailing axes; scalars replicated."""
    def put(x):
        x = jax.numpy.asarray(x)
        if x.ndim < 2:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, NamedSharding(mesh, field_spec(x.ndim)))
    return jax.tree_util.tree_map(put, tree)


def make_sharded_stepper(cfg, grid, mesh: Mesh, forcing_fn=None,
                         donate: bool = True, template=None):
    """jit-compiled step with mesh-sharded state (GSPMD partitioning).

    in_shardings/out_shardings pin every State leaf to the (eta, xi)
    domain decomposition so XLA cannot silently replicate or reshard
    outputs between steps; `template` (any State) supplies the pytree
    structure (defaults to a cold-start state of cfg)."""
    from .. import stepping
    from ..state import initial_state

    def f(state):
        return stepping.step(cfg, grid, state, forcing_fn)

    if template is None:
        template = jax.eval_shape(lambda: initial_state(cfg))
    shardings = jax.tree_util.tree_map(
        lambda x: NamedSharding(
            mesh, field_spec(x.ndim) if x.ndim >= 2 else P()), template)
    return jax.jit(f, in_shardings=(shardings,), out_shardings=shardings,
                   donate_argnums=(0,) if donate else ())
