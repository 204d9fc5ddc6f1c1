"""shard_map domain decomposition with explicit ppermute halo exchange.

The JAX analog of the reference's MPI tiling (one tile per rank,
NtileI x NtileJ, mp_exchange halo swaps; SURVEY.md §2.2/§5.7): the global
domain is split into per-device blocks that carry their own `halo`-wide
ghost ring, the physics runs verbatim on each local block (ops/* under a
bc.ParCtx), and every halo refresh is a two-phase lax.ppermute ring
exchange (parallel/halo.py) instead of a GSPMD-derived collective.  This
makes the communication exactly halo-wide (the mp_exchange message
pattern) rather than whatever XLA derives from full-array jnp.roll shifts
— the ≥85% scaling design of SURVEY §5.7.

Layout: blocked pytrees with leading (eta_blocks, xi_blocks) axes; leaves
whose trailing dims are the padded horizontal extents are split, all
other leaves (scalars, vertical tables, weights) are replicated.

The GSPMD path (parallel/shard.py) remains for configurations the local
path does not support yet (advanced open boundaries, volume conservation,
point sources, floats).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..ops import bc


def supported(cfg: Config) -> bool:
    """Configurations the local shard_map path implements exactly.

    Open-boundary algorithms (radiation/Chapman/Flather/...),
    wetting-drying, external boundary data and OBC volume conservation
    are all supported: ops/obc.py ring writes are edge-shard-gated under
    the ParCtx, obc_volcons psums its face integrals over the mesh
    (the mp_reduce analog), and `bry` lines work when the forcing_fn
    derives them from the grid ARGUMENT (each shard then builds its
    local boundary segment - the mp_exchange2d_bry analog; see
    make_smap_stepper)."""
    return True


def _is_field(cfg: Config, a) -> bool:
    return (getattr(a, "ndim", 0) >= 2 and
            a.shape[-1] == cfg.nx_tot and a.shape[-2] == cfg.ny_tot)


def local_config(cfg: Config, mesh: Mesh) -> Config:
    py, px = mesh.shape["eta"], mesh.shape["xi"]
    if cfg.Lm % px or cfg.Mm % py:
        raise ValueError(
            f"grid {cfg.Lm}x{cfg.Mm} not divisible by mesh {py}x{px}")
    return cfg.replace(Lm=cfg.Lm // px, Mm=cfg.Mm // py)


def block(cfg: Config, mesh: Mesh, tree):
    """Global padded pytree -> blocked pytree with (py, px) leading axes
    on horizontal-field leaves.  Each block is the contiguous slice of
    the global padded array covering its interior plus the halo ring, so
    blocks start out bit-identical to the global values.  Each block is
    placed on its own mesh device; every other array is replicated over
    the mesh, as the stepper returns it, so that the stepper's second
    call finds the program its first call compiled."""
    py, px = mesh.shape["eta"], mesh.shape["xi"]
    H = cfg.halo
    l, m = cfg.Lm // px, cfg.Mm // py
    on_mesh = NamedSharding(mesh, P("eta", "xi"))
    replicated = NamedSharding(mesh, P())

    def blk(a):
        if not _is_field(cfg, a):
            if isinstance(a, (jax.Array, np.ndarray)):
                return jax.device_put(a, replicated)
            return a
        rows = []
        for r in range(py):
            cols = []
            for c in range(px):
                cols.append(a[..., r * m:r * m + m + 2 * H,
                              c * l:c * l + l + 2 * H])
            rows.append(jnp.stack(cols, axis=0))
        return jax.device_put(jnp.stack(rows, axis=0), on_mesh)

    return jax.tree_util.tree_map(blk, tree)


def unblock(cfg: Config, mesh: Mesh, tree):
    """Blocked pytree -> global padded pytree.  Interiors are stitched;
    the physical boundary rings come from the edge blocks' halo regions
    and the outer halo is rebuilt with the global fill."""
    py, px = mesh.shape["eta"], mesh.shape["xi"]
    H = cfg.halo
    l, m = cfg.Lm // px, cfg.Mm // py

    def unblk(a):
        if getattr(a, "ndim", 0) < 4 or a.shape[0] != py or \
                a.shape[1] != px or a.shape[-1] != l + 2 * H or \
                a.shape[-2] != m + 2 * H:
            return a
        rows = []
        for r in range(py):
            j0 = H - 1 if r == 0 else H
            j1 = H + m + 1 if r == py - 1 else H + m
            cols = []
            for c in range(px):
                i0 = H - 1 if c == 0 else H
                i1 = H + l + 1 if c == px - 1 else H + l
                cols.append(a[r, c][..., j0:j1, i0:i1])
            rows.append(jnp.concatenate(cols, axis=-1))
        core = jnp.concatenate(rows, axis=-2)   # rings + interior
        pad = [(0, 0)] * (core.ndim - 2) + \
            [(H - 1, H - 1), (H - 1, H - 1)]
        return bc.fill_halo(cfg, jnp.pad(core, pad))

    return jax.tree_util.tree_map(unblk, tree)


def _specs(cfg: Config, tree):
    def spec(a):
        if _is_field(cfg, a) or (getattr(a, "ndim", 0) >= 4):
            # blocked leaves get their leading axes mapped to the mesh
            return P("eta", "xi")
        return P()
    return jax.tree_util.tree_map(spec, tree)


def _blocked_specs(cfg_l: Config, tree_blocked):
    ny_l = cfg_l.Mm + 2 * cfg_l.halo
    nx_l = cfg_l.Lm + 2 * cfg_l.halo

    def spec(a):
        if getattr(a, "ndim", 0) >= 4 and a.shape[-1] == nx_l and \
                a.shape[-2] == ny_l:
            return P("eta", "xi")
        return P()
    return jax.tree_util.tree_map(spec, tree_blocked)


def make_ctx(cfg: Config) -> bc.ParCtx:
    """Edge-ownership flags from the mesh position (the reference's
    DOMAIN(ng)%Western_Edge(tile) tests)."""
    ix = lax.axis_index("xi")
    iy = lax.axis_index("eta")
    nx = lax.psum(1, "xi")
    ny = lax.psum(1, "eta")
    return bc.ParCtx(west=ix == 0, east=ix == nx - 1,
                     south=iy == 0, north=iy == ny - 1)


def make_smap_stepper(cfg: Config, grid, mesh: Mesh,
                      forcing_fn: Optional[Callable] = None,
                      nsub: int = 1):
    """jit-compiled stepper over blocked pytrees: state_blocked ->
    state_blocked advancing `nsub` slow steps per call.  Use block() /
    unblock() to convert at the boundaries (I/O, init)."""
    from .. import stepping
    cfg_l = local_config(cfg, mesh)
    grid_b = block(cfg, mesh, grid)
    grid_specs = _blocked_specs(cfg_l, grid_b)

    # NOTE on bry: forcing_fn is called with the LOCAL cfg and grid
    # block, so boundary-data lines built from the grid argument come
    # out local-sized and land on the right shard rows/cols; the obc
    # ring writes are edge-shard-gated, so non-owning shards ignore
    # them.  File-driven bry lines must be pre-blocked by the caller.

    def local_step(grid_blk, state_blk):
        gl = jax.tree_util.tree_map(
            lambda a, s: a if a is None else
            (a[0, 0] if s != P() else a), grid_blk, grid_specs,
            is_leaf=lambda x: x is None)
        ctx = make_ctx(cfg_l)
        bc.push_ctx(ctx)
        try:
            # the same spec tree drives squeeze and re-expand (State is
            # structure-preserving through step)
            state_specs = _blocked_specs(cfg_l, state_blk)
            sl = jax.tree_util.tree_map(
                lambda a, s: a[0, 0] if s != P() else a,
                state_blk, state_specs)
            for _ in range(nsub):
                sl = stepping.step(cfg_l, gl, sl, forcing_fn)
            out = jax.tree_util.tree_map(
                lambda a, s: a[None, None] if s != P() else a,
                sl, state_specs)
        finally:
            bc.pop_ctx()
        return out

    def stepper(grid_blk, state_b):
        state_specs = _blocked_specs(cfg_l, state_b)
        fn = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(grid_specs, state_specs), out_specs=state_specs,
            check_vma=False)
        return fn(grid_blk, state_b)

    # the blocked grid is a jit argument, not a constant baked into the
    # compiled program
    stepper_jit = jax.jit(stepper)
    return lambda state_b: stepper_jit(grid_b, state_b)
