"""Explicit halo exchange with lax.ppermute (the mp_exchange facade).

The reference's mp_exchange2d/3d/4d (ROMS/Utility/mp_exchange.F:290-3429)
packs Nghost-wide edge strips, swaps them with the four lattice neighbors
in two phases (W-E first, then S-N including the just-filled corners), and
fuses up to 4 fields per call.  This module is the JAX equivalent
for shard_map code: neighbor collective-permutes over the mesh axes, same
two-phase corner handling, multi-field fusion by stacking.

The GSPMD path (parallel/shard.py) lets XLA derive these exchanges
automatically; this explicit facade exists for hand-scheduled overlap
(compute interior while halos are in flight) and halo-widening of the
fast barotropic loop - the scaling levers of SURVEY.md §5.7.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def exchange_axis(f, axis_name: str, width: int, axis: int = -1):
    """Refresh the `width`-wide halos of the mapped array axis `axis`
    using ring ppermutes along mesh axis `axis_name`.

    The local array is halo-padded: [halo | interior | halo].  My east
    interior strip becomes my east neighbor's west halo and vice versa.
    Periodic wrap falls out of the ring topology.
    """
    n = lax.psum(1, axis_name)
    if n == 1:
        # single shard: local periodic wrap
        interior = jnp.size(f, axis) - 2 * width
        west = lax.slice_in_dim(f, interior, interior + width, axis=axis)
        east = lax.slice_in_dim(f, width, 2 * width, axis=axis)
        f = _set_halo(f, west, 0, width, axis)
        f = _set_halo(f, east, -width, None, axis)
        return f
    fwd, bwd = _ring_perms(n)
    my_east = lax.slice_in_dim(
        f, jnp.size(f, axis) - 2 * width, jnp.size(f, axis) - width,
        axis=axis)
    my_west = lax.slice_in_dim(f, width, 2 * width, axis=axis)
    from_west = lax.ppermute(my_east, axis_name, fwd)   # fills my west halo
    from_east = lax.ppermute(my_west, axis_name, bwd)   # fills my east halo
    f = _set_halo(f, from_west, 0, width, axis)
    f = _set_halo(f, from_east, -width, None, axis)
    return f


def _set_halo(f, strip, lo, hi, axis):
    idx = [slice(None)] * f.ndim
    idx[axis] = slice(lo, hi)
    return f.at[tuple(idx)].set(strip)


def exchange_2d(cfg, *fields, axes=("eta", "xi"), width: int = None):
    """Two-phase halo exchange of one or more [..., j, i] arrays over a
    2-D mesh: xi (W-E) first, then eta (S-N) including corners
    (mp_exchange.F:413,538,654 ordering).  Fields are fused into one
    payload per direction like the reference's A,B,C,D optional args."""
    width = width if width is not None else cfg.halo
    stacked = jnp.stack(fields, axis=0) if len(fields) > 1 else fields[0]
    stacked = exchange_axis(stacked, axes[1], width, axis=-1)
    stacked = exchange_axis(stacked, axes[0], width, axis=-2)
    if len(fields) > 1:
        return tuple(stacked[i] for i in range(len(fields)))
    return stacked
