"""Lateral boundary conditions and halo filling.

Replaces the reference's per-field BC kernels (ROMS/Nonlinear/zetabc.F,
u2dbc_im.F, v2dbc_im.F, u3dbc_im.F, v3dbc_im.F, t3dbc_im.F, bc_2d/3d.F) and
the periodic exchange (exchange_2d.F) for the single-device path.  The
sharded path reuses the same per-side appliers at global edges, with interior
halos filled by ppermute (roms_tpu/parallel/halo.py).

Index map (ops/stencil.py): padded array index a = roms_index + H - 1.
Boundary rho ring: west a=H-1, east a=H+Lm; u-wall west a=H, east a=H+Lm;
south a=H-1 / v-wall a=H, north a=H+Mm.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import (Config, BC_PERIODIC, BC_CLOSED, BC_GRADIENT,
                      BC_CLAMPED, BC_RADIATION, BC_CHAPMAN_EXPLICIT,
                      BC_CHAPMAN_IMPLICIT, BC_FLATHER, LBC)


# ---------------------------------------------------------------------------
# Parallel context: inside a shard_map region every op works on a LOCAL
# halo-padded block.  Halo refreshes become ppermute ring exchanges
# (parallel/halo.py, the mp_exchange analog) and global-boundary writes
# are masked so only the shard owning that physical edge applies them
# (the reference's DOMAIN(ng)%Western_Edge(tile) tests).  Single-device
# code never sets a context and takes the original paths unchanged.
# ---------------------------------------------------------------------------
@dataclass
class ParCtx:
    """Traced edge-ownership flags (0-d bool arrays) + mesh axis names."""
    west: object
    east: object
    south: object
    north: object
    axes: tuple = ("eta", "xi")


_TLS = threading.local()


def push_ctx(ctx: ParCtx):
    _TLS.ctx = ctx


def pop_ctx():
    _TLS.ctx = None


def current_ctx() -> Optional[ParCtx]:
    return getattr(_TLS, "ctx", None)


def _owns(ctx: ParCtx, side: str):
    return getattr(ctx, side)


def _col_mask(f, a):
    nx = f.shape[-1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (1, nx), 1)
    return ii == (a % nx)


def _row_mask(f, a):
    ny = f.shape[-2]
    jj = jax.lax.broadcasted_iota(jnp.int32, (ny, 1), 0)
    return jj == (a % ny)

_ADVANCED = {BC_RADIATION, BC_CHAPMAN_EXPLICIT, BC_CHAPMAN_IMPLICIT,
             BC_FLATHER, BC_CLAMPED}


def has_advanced(lbc: LBC) -> bool:
    """True when any side uses an active/open BC (radiation, Chapman,
    Flather, clamped) that needs the previous time level / external data
    (handled by ops/obc.py)."""
    return any(getattr(lbc, s) in _ADVANCED
               for s in ("west", "south", "east", "north"))


# ---------------------------------------------------------------------------
# Halo filling (the single-device analog of mp_exchange / exchange_2d)
# ---------------------------------------------------------------------------
def fill_halo(cfg: Config, f):
    """Fill the halo ring: periodic wrap (period Lm/Mm) in periodic
    directions, edge replication in closed directions.

    Replicated cells are never read by valid stencil math (kernels apply the
    reference's one-sided edge corrections), they only keep the halo free of
    stale values.  Works on any [..., j, i] array.

    Under a ParCtx (shard_map region) the wrap/replication becomes a
    two-phase ring ppermute exchange plus edge replication on the shards
    owning a closed physical boundary (mp_exchange2d/3d semantics).
    """
    ctx = current_ctx()
    if ctx is not None:
        return _fill_halo_sharded(cfg, f, ctx)
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if cfg.ew_periodic:
        # west halo a<H from a+L, east halo a>=H+L from a-L
        f = jnp.concatenate(
            [f[..., L:L + H], f[..., H:H + L], f[..., H:H + H]], axis=-1)
    else:
        west = jnp.repeat(f[..., H - 1:H], H - 1, axis=-1)
        east = jnp.repeat(f[..., H + L:H + L + 1], H - 1, axis=-1)
        f = jnp.concatenate(
            [west, f[..., H - 1:H + L + 1], east], axis=-1)
    if cfg.ns_periodic:
        f = jnp.concatenate(
            [f[..., M:M + H, :], f[..., H:H + M, :], f[..., H:H + H, :]],
            axis=-2)
    else:
        south = jnp.repeat(f[..., H - 1:H, :], H - 1, axis=-2)
        north = jnp.repeat(f[..., H + M:H + M + 1, :], H - 1, axis=-2)
        f = jnp.concatenate(
            [south, f[..., H - 1:H + M + 1, :], north], axis=-2)
    return f


def _fill_halo_sharded(cfg: Config, f, ctx: ParCtx):
    """Sharded halo refresh mirroring the single-device fill_halo exactly:
    xi phase (exchange + closed-edge fix) then eta phase, so corners ride
    the second exchange (mp_exchange.F:413,538 two-phase ordering).

    On a closed axis the boundary rho ring (local col H-1 / nx-H on the
    edge shards) sits inside the exchanged halo strip; it is real data
    written by apply_bc_*, so it is snapshotted before the exchange and
    restored after, then the outer halo replicates from it."""
    from ..parallel import halo
    H = cfg.halo
    ny, nx = f.shape[-2], f.shape[-1]

    # ---- xi (W-E) phase ----
    if not cfg.ew_periodic:
        wring = f[..., :, H - 1:H]
        ering = f[..., :, nx - H:nx - H + 1]
    f = halo.exchange_axis(f, ctx.axes[1], H, axis=-1)
    if not cfg.ew_periodic:
        ii = jnp.arange(nx)
        f = jnp.where(ctx.west & (ii <= H - 1), wring, f)
        f = jnp.where(ctx.east & (ii >= nx - H), ering, f)

    # ---- eta (S-N) phase (ships the xi-filled corners) ----
    if not cfg.ns_periodic:
        sring = f[..., H - 1:H, :]
        nring = f[..., ny - H:ny - H + 1, :]
    f = halo.exchange_axis(f, ctx.axes[0], H, axis=-2)
    if not cfg.ns_periodic:
        jj = jnp.arange(ny)[:, None]
        f = jnp.where(ctx.south & (jj <= H - 1), sring, f)
        f = jnp.where(ctx.north & (jj >= ny - H), nring, f)
    return f


# ---------------------------------------------------------------------------
# Per-side appliers for 2-D (and leading-dim batched) fields.  The `side`
# tells the sharded path which shard owns the write; single-device mode
# ignores it.  These are the shared primitives for every boundary write
# in the ops modules (set_col/set_row public aliases).
# ---------------------------------------------------------------------------
def _colvals(values):
    # `values` broadcasts against f[..., :, a] (trailing axis = eta);
    # re-insert the xi axis so it broadcasts against f itself
    vals = jnp.asarray(values)
    return vals if vals.ndim == 0 else vals[..., None]


def _rowvals(values):
    vals = jnp.asarray(values)
    return vals if vals.ndim == 0 else vals[..., None, :]


def _set_col(f, a_dst, values, side=None):
    ctx = current_ctx()
    if ctx is not None and side is not None:
        return jnp.where(_owns(ctx, side) & _col_mask(f, a_dst),
                         _colvals(values), f)
    return f.at[..., :, a_dst].set(values)


def _set_row(f, a_dst, values, side=None):
    ctx = current_ctx()
    if ctx is not None and side is not None:
        return jnp.where(_owns(ctx, side) & _row_mask(f, a_dst),
                         _rowvals(values), f)
    return f.at[..., a_dst, :].set(values)


set_col = _set_col
set_row = _set_row


def add_col(f, a_dst, delta, side=None):
    """f[..., :, a] += delta, edge-shard-gated under a ParCtx."""
    ctx = current_ctx()
    if ctx is not None and side is not None:
        return f + jnp.where(_owns(ctx, side) & _col_mask(f, a_dst),
                             _colvals(delta), 0.0)
    return f.at[..., :, a_dst].add(delta)


def add_row(f, a_dst, delta, side=None):
    ctx = current_ctx()
    if ctx is not None and side is not None:
        return f + jnp.where(_owns(ctx, side) & _row_mask(f, a_dst),
                             _rowvals(delta), 0.0)
    return f.at[..., a_dst, :].add(delta)


def apply_bc_rho(cfg: Config, lbc: LBC, f, mask=None, clamp=None,
                 fill: bool = True):
    """BCs for a rho-point field (zeta-like; zetabc.F:236-700 closed ≡
    zero-gradient onto the boundary ring).  fill=False skips the final
    halo refresh (the sharded fast loop defers it into one fused
    multi-field exchange per substep - mp_exchange.F:290-293)."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        if lbc.west in (BC_CLOSED, BC_GRADIENT):
            f = _set_col(f, H - 1, f[..., :, H], "west")
        elif lbc.west == BC_CLAMPED and clamp is not None:
            f = _set_col(f, H - 1, clamp["west"], "west")
        if lbc.east in (BC_CLOSED, BC_GRADIENT):
            f = _set_col(f, H + L, f[..., :, H + L - 1], "east")
        elif lbc.east == BC_CLAMPED and clamp is not None:
            f = _set_col(f, H + L, clamp["east"], "east")
    if not cfg.ns_periodic:
        if lbc.south in (BC_CLOSED, BC_GRADIENT):
            f = _set_row(f, H - 1, f[..., H, :], "south")
        elif lbc.south == BC_CLAMPED and clamp is not None:
            f = _set_row(f, H - 1, clamp["south"], "south")
        if lbc.north in (BC_CLOSED, BC_GRADIENT):
            f = _set_row(f, H + M, f[..., H + M - 1, :], "north")
        elif lbc.north == BC_CLAMPED and clamp is not None:
            f = _set_row(f, H + M, clamp["north"], "north")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


def apply_bc_u(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None,
               fill: bool = True):
    """BCs for a u-point field (ubar/u; u2dbc_im.F).

    West/east are the *normal* direction (closed -> u=0 on the wall face);
    south/north are tangential (closed -> gamma2 slip against the interior
    row; u2dbc_im.F:960-1135).
    """
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = _set_col(f, H, jnp.zeros_like(f[..., :, H]), "west")
        elif lbc.west == BC_GRADIENT:
            f = _set_col(f, H, f[..., :, H + 1], "west")
        # pin the u ghost column west of the boundary face: it has no
        # reference counterpart (u starts at i=1) and is the source
        # column for the halo fill - left untouched it integrates
        # garbage through the kernels and eventually overflows
        f = _set_col(f, H - 1, f[..., :, H], "west")
        if lbc.east == BC_CLOSED:
            f = _set_col(f, H + L, jnp.zeros_like(f[..., :, H + L]), "east")
        elif lbc.east == BC_GRADIENT:
            f = _set_col(f, H + L, f[..., :, H + L - 1], "east")
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = _set_row(f, H - 1, gamma2 * f[..., H, :], "south")
        elif lbc.south == BC_GRADIENT:
            f = _set_row(f, H - 1, f[..., H, :], "south")
        if lbc.north == BC_CLOSED:
            f = _set_row(f, H + M, gamma2 * f[..., H + M - 1, :], "north")
        elif lbc.north == BC_GRADIENT:
            f = _set_row(f, H + M, f[..., H + M - 1, :], "north")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


def apply_bc_v(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None,
               fill: bool = True):
    """BCs for a v-point field (vbar/v; v2dbc_im.F).

    South/north are normal (closed -> v=0 on the wall face, v2dbc_im.F
    closed sections); west/east tangential (gamma2 slip).
    """
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = _set_row(f, H, jnp.zeros_like(f[..., H, :]), "south")
        elif lbc.south == BC_GRADIENT:
            f = _set_row(f, H, f[..., H + 1, :], "south")
        # pin the v ghost row south of the boundary face (see apply_bc_u)
        f = _set_row(f, H - 1, f[..., H, :], "south")
        if lbc.north == BC_CLOSED:
            f = _set_row(f, H + M, jnp.zeros_like(f[..., H + M, :]), "north")
        elif lbc.north == BC_GRADIENT:
            f = _set_row(f, H + M, f[..., H + M - 1, :], "north")
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = _set_col(f, H - 1, gamma2 * f[..., :, H], "west")
        elif lbc.west == BC_GRADIENT:
            f = _set_col(f, H - 1, f[..., :, H], "west")
        if lbc.east == BC_CLOSED:
            f = _set_col(f, H + L, gamma2 * f[..., :, H + L - 1], "east")
        elif lbc.east == BC_GRADIENT:
            f = _set_col(f, H + L, f[..., :, H + L - 1], "east")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


def fill_halo_multi(cfg: Config, *fields):
    """One fused halo refresh for several same-shaped fields (the
    reference packs up to 4 fields per mp_exchange message,
    mp_exchange.F:290-293,398-405): stack, exchange once, unstack.
    Bitwise identical to per-field fill_halo."""
    if len(fields) == 1:
        return (fill_halo(cfg, fields[0]),)
    stacked = fill_halo(cfg, jnp.stack(fields, axis=0))
    return tuple(stacked[i] for i in range(len(fields)))


# ---------------------------------------------------------------------------
# Edge corrections for wide stencils (the reference's one-sided grad
# extrapolations at non-periodic edges, e.g. step2d_LF_AM3.h 4th-order
# advection "grad(Istr,j)=grad(Istr+1,j)")
# ---------------------------------------------------------------------------
def extrap_west(cfg: Config, g, a: int):
    """g[:, a] = g[:, a+1] at a non-periodic western edge."""
    if cfg.ew_periodic:
        return g
    return _set_col(g, a, g[..., :, a + 1], "west")


def extrap_east(cfg: Config, g, a: int):
    if cfg.ew_periodic:
        return g
    return _set_col(g, a, g[..., :, a - 1], "east")


def extrap_south(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return _set_row(g, a, g[..., a + 1, :], "south")


def extrap_north(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return _set_row(g, a, g[..., a - 1, :], "north")
