"""Open (active) lateral boundary conditions.

Implements the reference's runtime-selectable open-boundary algorithms
(SURVEY.md Appendix A.3):
 * implicit upstream radiation with optional nudging (zetabc.F:108-238
   and the matching u2dbc/v2dbc/u3dbc/v3dbc/t3dbc forms; the reference
   zeroes the tangential phase speed Ce unless RADIATION_2D - ported
   as-is),
 * Chapman explicit/implicit for the free surface,
 * Flather for 2-D normal momentum,
 * clamped (external data).

External boundary data arrives as a dict `bry` with keys like
"zeta_west" (1-D arrays along the padded boundary, or scalars); the
analog of mod_boundary.F's BOUNDARY(ng) arrays.

All routines take the field at the previous time level (know) and the
updated field (kout) and return kout with boundary rings replaced; the
caller then wraps halos (bc.fill_halo).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants as C
from ..config import (Config, LBC, BC_RADIATION, BC_CHAPMAN_EXPLICIT,
                      BC_CHAPMAN_IMPLICIT, BC_FLATHER, BC_CLAMPED,
                      BC_SHCHEPETKIN, BC_REDUCED)

_EPS = 1.0e-20
_CO = 1.0 / (2.0 + 2.0 ** 0.5)      # Shchepetkin Co (mod_scalars.F:4175)

# side descriptors: (axis, is_low_end)
_SIDES = {"west": (-1, True), "east": (-1, False),
          "south": (-2, True), "north": (-2, False)}


def _ax(a, axis):
    """Move `axis` to the last position (returns a view)."""
    return jnp.swapaxes(a, axis, -1) if axis == -2 else a


def _unax(a, axis):
    return jnp.swapaxes(a, axis, -1) if axis == -2 else a


def _col(a, i):
    return a[..., i]


def _set_ring(qo, ab, qb, side):
    """Write the boundary ring column (axis already moved to -1).
    Under a ParCtx (shard_map) the write is gated to the shard owning
    the physical side and expressed as a masked where (no scatter)."""
    from . import bc as _bc
    ctx = _bc.current_ctx()
    if ctx is None:
        return qo.at[..., ab].set(qb)
    import jax
    n = qo.shape[-1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    m = _bc._owns(ctx, side) & (ii == (ab % n))
    return jnp.where(m, qb[..., None], qo)


def radiation(cfg: Config, q_know, q_kout, side: str, ab: int,
              nudg_in: float = 0.0, nudg_out: float = 0.0,
              ext=None, dt: float = 0.0, mask=None):
    """Implicit upstream radiation at one boundary (zetabc.F:145-197 and
    twins).  ab: padded index of the boundary ring for this field kind.
    Returns updated q_kout."""
    axis, low = _SIDES[side]
    qn = _ax(q_know, axis)
    qo = _ax(q_kout, axis)
    step = 1 if low else -1
    ai = ab + step
    ai2 = ab + 2 * step

    dqdt = _col(qn, ai) - _col(qo, ai)
    dqdx = _col(qo, ai) - _col(qo, ai2)
    dqdt = jnp.where(dqdt * dqdx < 0.0, 0.0, dqdt)
    # tangential gradient (upwinded); tangential axis is the remaining one
    gi = _col(qn, ai)
    grad = gi - jnp.roll(gi, 1, axis=-1)        # grad[j] = q[j]-q[j-1]
    gradp = jnp.roll(grad, -1, axis=-1)         # grad[j+1]
    dqde = jnp.where(dqdt * (grad + gradp) > 0.0, grad, gradp)
    cff = jnp.maximum(dqdx * dqdx + dqde * dqde, _EPS)
    Cx = dqdt * dqdx
    # Ce = 0 (reference default without RADIATION_2D)
    qb = (cff * _col(qn, ab) + Cx * _col(qo, ai)) / (cff + Cx)
    if ext is not None and (nudg_in != 0.0 or nudg_out != 0.0):
        tau = jnp.where(dqdt * dqdx < 0.0, nudg_in, nudg_out) * dt
        qb = qb + tau * (ext - _col(qn, ab))
    if mask is not None:
        qb = qb * _col(_ax(mask + 0 * q_kout, axis), ab)
    qo = _set_ring(qo, ab, qb, side)
    return _unax(qo, axis)


def chapman(cfg: Config, grid, z_know, z_kout, side: str,
            implicit: bool, dt2d: float, mask=None):
    """Chapman free-surface BC (zetabc.F:200-233): boundary ring follows
    the shallow-water gravity-wave phase speed."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H - 1 if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    step = 1 if low else -1
    ai = ab + step
    zn = _ax(z_know, axis)
    zo = _ax(z_kout, axis)
    pmn = grid.pm if axis == -1 else grid.pn
    pmn_i = _col(_ax(pmn, axis), ai)
    h_i = _col(_ax(grid.h, axis), ai)
    cffc = dt2d * pmn_i * jnp.sqrt(C.g * (h_i + _col(zn, ai)))
    if implicit:
        zb = (_col(zn, ab) + cffc * _col(zo, ai)) / (1.0 + cffc)
    else:
        zb = (1.0 - cffc) * _col(zn, ab) + cffc * _col(zn, ai)
    if mask is not None:
        zb = zb * _col(_ax(mask, axis), ab)
    zo = _set_ring(zo, ab, zb, side)
    return _unax(zo, axis)


def flather(cfg: Config, grid, ub_kout, z_know, side: str,
            ext_ubar, ext_zeta=None, mask=None):
    """Flather 2-D normal-momentum BC (u2dbc_im.F Flather):
    ubar_b = ubar_ext - sqrt(g/D)*(0.5*(zeta_b+zeta_i) - zeta_ext)."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    step = 1 if low else -1
    uo = _ax(ub_kout, axis)
    zn = _ax(z_know, axis)
    hh = _ax(grid.h, axis)
    # rho columns flanking the boundary face
    ir_in = ab if low else ab
    ir_out = ab - 1 if low else ab
    # u(ab) sits between rho(ab-1) and rho(ab)
    D = 0.5 * (_col(hh, ab - 1) + _col(zn, ab - 1) +
               _col(hh, ab) + _col(zn, ab))
    Cx = jnp.sqrt(C.g / jnp.maximum(D, _EPS))
    zavg = 0.5 * (_col(zn, ab - 1) + _col(zn, ab))
    zext = 0.0 if ext_zeta is None else ext_zeta
    sign = 1.0 if low else -1.0
    ub = ext_ubar - sign * Cx * (zavg - zext)
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    uo = _set_ring(uo, ab, ub, side)
    return _unax(uo, axis)


def shchepetkin(cfg: Config, grid, ub_know, ub_kout, z_know, z_kout,
                side: str, dt2d, ext_ubar=0.0, ext_zeta=0.0, mask=None):
    """Shchepetkin 2-D normal-momentum BC (Maison et al. 2010;
    u2dbc_im.F:286-360 / v2dbc_im.F twins): free-surface-consistent
    outgoing characteristic with a supercritical-Courant correction."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    uo = _ax(ub_kout, axis)
    un = _ax(ub_know, axis)
    zn = _ax(z_know, axis)
    zo = _ax(z_kout, axis)
    hh = _ax(grid.h, axis)
    pmn = _ax(grid.pm if axis == -1 else grid.pn, axis)
    g = C.g
    # "in" = interior rho column, "out" = exterior; the boundary u/v
    # point ab sits between rho columns ab-1 and ab
    i_in = ab if low else ab - 1
    i_out = ab - 1 if low else ab
    u_inner = ab + 1 if low else ab - 1

    if cfg.wetdry:
        D = 0.5 * (_col(hh, i_out) + _col(zn, i_out) +
                   _col(hh, i_in) + _col(zn, i_in))
    else:
        D = 0.5 * (_col(hh, i_out) + _col(hh, i_in))
    cff1 = jnp.sqrt(g / jnp.maximum(D, _EPS))
    Cx = dt2d * cff1 * D * 0.5 * (_col(pmn, i_out) + _col(pmn, i_in))
    Zx = (0.5 + Cx) * _col(zn, i_in) + (0.5 - Cx) * _col(zn, i_out)
    # supercritical correction (u2dbc_im.F:345-350)
    cff2 = (1.0 - _CO / jnp.maximum(Cx, _EPS)) ** 2
    cff3 = _col(zo, i_in) + Cx * _col(zn, i_out) - \
        (1.0 + Cx) * _col(zn, i_in)
    Zx = jnp.where(Cx > _CO, Zx + cff2 * cff3, Zx)
    sign = 1.0 if low else -1.0
    ub = 0.5 * ((1.0 - Cx) * _col(un, ab) + Cx * _col(un, u_inner) +
                ext_ubar - sign * cff1 * (Zx - ext_zeta))
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    uo = _set_ring(uo, ab, ub, side)
    return _unax(uo, axis)


def reduced(cfg: Config, grid, ub_know, ub_kout, z_know, vt_know,
            side: str, dt2d, sstr=None, bstr=None, ext_zeta=None,
            mask=None):
    """Reduced-physics 2-D normal-momentum BC (u2dbc_im.F:390-430 /
    v2dbc_im.F:392-433): boundary point integrates only the surface
    pressure gradient + Coriolis + surface/bottom stress.

    vt_know: tangential depth-averaged velocity at know (vbar for the
    u boundary, ubar for the v boundary); sstr/bstr: kinematic
    surface/bottom stress components normal to the boundary."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    uo = _ax(ub_kout, axis)
    un = _ax(ub_know, axis)
    zn = _ax(z_know, axis)
    vt = _ax(vt_know, axis)
    hh = _ax(grid.h, axis)
    ff = _ax(grid.f, axis)
    pmn = _ax(grid.pm if axis == -1 else grid.pn, axis)
    g = C.g
    i_in = ab if low else ab - 1
    i_out = ab - 1 if low else ab

    if ext_zeta is not None:
        # LBC zeta acquire form: gradient against the external value
        sign = 1.0 if low else -1.0
        bry_pgr = -g * sign * (_col(zn, i_in) - ext_zeta) * \
            0.5 * _col(pmn, i_in)
    else:
        # one-sided interior gradient, oriented along the axis
        z_lo, z_hi = (_col(zn, i_out), _col(zn, i_in)) if low else \
            (_col(zn, i_in), _col(zn, i_out))
        bry_pgr = -g * (z_hi - z_lo) * \
            0.5 * (_col(pmn, i_out) + _col(pmn, i_in))
    if cfg.uv_cor:
        # tangential velocity averaged to the boundary point; the
        # tangential + offset is one roll along the boundary axis
        v4 = (_col(vt, i_out) + jnp.roll(_col(vt, i_out), -1, -1) +
              _col(vt, i_in) + jnp.roll(_col(vt, i_in), -1, -1))
        cor_sign = 1.0 if axis == -1 else -1.0
        bry_cor = cor_sign * 0.125 * v4 * (_col(ff, i_out) +
                                           _col(ff, i_in))
    else:
        bry_cor = 0.0
    D = 0.5 * (_col(hh, i_out) + _col(zn, i_out) +
               _col(hh, i_in) + _col(zn, i_in))
    bry_str = 0.0
    if sstr is not None:
        bry_str = bry_str + _col(_ax(sstr, axis), ab) / D
    if bstr is not None:
        bry_str = bry_str - _col(_ax(bstr, axis), ab) / D
    ub = _col(un, ab) + dt2d * (bry_pgr + bry_cor + bry_str)
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    uo = _set_ring(uo, ab, ub, side)
    return _unax(uo, axis)


def clamped(cfg: Config, q_kout, side: str, ab: int, ext, mask=None):
    axis, _ = _SIDES[side]
    qo = _ax(q_kout, axis)
    qb = ext + 0.0 * _col(qo, ab)
    if mask is not None:
        qb = qb * _col(_ax(mask + 0 * q_kout, axis), ab)
    qo = _set_ring(qo, ab, qb, side)
    return _unax(qo, axis)


# ---------------------------------------------------------------------------
# field-level dispatchers
# ---------------------------------------------------------------------------
def _ring_rho(cfg: Config, side: str) -> int:
    H = cfg.halo
    return {"west": H - 1, "east": H + cfg.Lm,
            "south": H - 1, "north": H + cfg.Mm}[side]


def _ring_normal_u(cfg: Config, side: str) -> int:
    H = cfg.halo
    return {"west": H, "east": H + cfg.Lm,
            "south": H, "north": H + cfg.Mm}[side]


def zetabc(cfg: Config, grid, lbc: LBC, z_know, z_kout, dt2d,
           bry=None, nudg=(0.0, 0.0)):
    """Advanced free-surface BCs per side; simple kinds (Per/Clo/Gra) are
    handled by bc.apply_bc_rho and skipped here."""
    bry = bry or {}
    for side in ("west", "south", "east", "north"):
        kind = getattr(lbc, side)
        skip = (cfg.ew_periodic and side in ("west", "east")) or \
            (cfg.ns_periodic and side in ("south", "north"))
        if skip:
            continue
        ab = _ring_rho(cfg, side)
        ext = bry.get(f"zeta_{side}")
        if kind == BC_RADIATION:
            z_kout = radiation(cfg, z_know, z_kout, side, ab,
                               nudg[0], nudg[1], ext, dt2d,
                               mask=grid.rmask)
        elif kind == BC_CHAPMAN_EXPLICIT:
            z_kout = chapman(cfg, grid, z_know, z_kout, side, False, dt2d,
                             mask=grid.rmask)
        elif kind == BC_CHAPMAN_IMPLICIT:
            z_kout = chapman(cfg, grid, z_know, z_kout, side, True, dt2d,
                             mask=grid.rmask)
        elif kind == BC_CLAMPED and ext is not None:
            z_kout = clamped(cfg, z_kout, side, ab, ext, mask=grid.rmask)
    return z_kout


def u2dbc(cfg: Config, grid, lbc: LBC, ub_know, ub_kout, z_know,
          dt2d, bry=None, z_kout=None, vb_know=None,
          sustr=None, bustr=None):
    """Advanced 2-D u-momentum BCs: Flather/Shchepetkin/reduced/
    radiation/clamped on normal (west/east) sides; radiation on
    tangential handled via the generic radiation with the tangential
    ring."""
    bry = bry or {}
    H = cfg.halo
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        ext = bry.get(f"ubar_{side}", 0.0)
        if kind == BC_FLATHER:
            ub_kout = flather(cfg, grid, ub_kout, z_know, side, ext,
                              bry.get(f"zeta_{side}"), mask=grid.umask)
        elif kind == BC_SHCHEPETKIN:
            ub_kout = shchepetkin(
                cfg, grid, ub_know, ub_kout, z_know,
                z_kout if z_kout is not None else z_know, side, dt2d,
                ext, bry.get(f"zeta_{side}", 0.0), mask=grid.umask)
        elif kind == BC_REDUCED:
            ub_kout = reduced(
                cfg, grid, ub_know, ub_kout, z_know,
                vb_know if vb_know is not None
                else jnp.zeros_like(ub_know), side, dt2d,
                sstr=sustr, bstr=bustr, ext_zeta=bry.get(f"zeta_{side}"),
                mask=grid.umask)
        elif kind == BC_RADIATION:
            ub_kout = radiation(cfg, ub_know, ub_kout, side, ab,
                                mask=grid.umask)
        elif kind == BC_CLAMPED:
            ub_kout = clamped(cfg, ub_kout, side, ab, ext, mask=grid.umask)
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            ub_kout = radiation(cfg, ub_know, ub_kout, side, ab,
                                mask=grid.umask)
        elif kind == BC_CLAMPED:
            ub_kout = clamped(cfg, ub_kout, side, ab,
                              bry.get(f"ubar_{side}", 0.0),
                              mask=grid.umask)
    return ub_kout


def v2dbc(cfg: Config, grid, lbc: LBC, vb_know, vb_kout, z_know,
          dt2d, bry=None, z_kout=None, ub_know=None,
          svstr=None, bvstr=None):
    bry = bry or {}
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        ext = bry.get(f"vbar_{side}", 0.0)
        if kind == BC_FLATHER:
            vb_kout = flather(cfg, grid, vb_kout, z_know, side, ext,
                              bry.get(f"zeta_{side}"), mask=grid.vmask)
        elif kind == BC_SHCHEPETKIN:
            vb_kout = shchepetkin(
                cfg, grid, vb_know, vb_kout, z_know,
                z_kout if z_kout is not None else z_know, side, dt2d,
                ext, bry.get(f"zeta_{side}", 0.0), mask=grid.vmask)
        elif kind == BC_REDUCED:
            vb_kout = reduced(
                cfg, grid, vb_know, vb_kout, z_know,
                ub_know if ub_know is not None
                else jnp.zeros_like(vb_know), side, dt2d,
                sstr=svstr, bstr=bvstr, ext_zeta=bry.get(f"zeta_{side}"),
                mask=grid.vmask)
        elif kind == BC_RADIATION:
            vb_kout = radiation(cfg, vb_know, vb_kout, side, ab,
                                mask=grid.vmask)
        elif kind == BC_CLAMPED:
            vb_kout = clamped(cfg, vb_kout, side, ab, ext, mask=grid.vmask)
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            vb_kout = radiation(cfg, vb_know, vb_kout, side, ab,
                                mask=grid.vmask)
        elif kind == BC_CLAMPED:
            vb_kout = clamped(cfg, vb_kout, side, ab,
                              bry.get(f"vbar_{side}", 0.0),
                              mask=grid.vmask)
    return vb_kout


def t3dbc(cfg: Config, grid, lbc: LBC, t_know, t_kout, bry=None,
          name: str = "t"):
    """3-D tracer (or momentum component) radiation/clamped BCs
    (t3dbc_im.F / u3dbc_im.F pattern); broadcasts over the leading k."""
    bry = bry or {}
    for side in ("west", "south", "east", "north"):
        kind = getattr(lbc, side)
        skip = (cfg.ew_periodic and side in ("west", "east")) or \
            (cfg.ns_periodic and side in ("south", "north"))
        if skip:
            continue
        ab = _ring_rho(cfg, side)
        ext = bry.get(f"{name}_{side}")
        if kind == BC_RADIATION:
            t_kout = radiation(cfg, t_know, t_kout, side, ab,
                               mask=grid.rmask)
        elif kind == BC_CLAMPED and ext is not None:
            t_kout = clamped(cfg, t_kout, side, ab, ext, mask=grid.rmask)
    return t_kout


def u3dbc(cfg: Config, grid, lbc: LBC, u_know, u_kout, bry=None):
    """3-D u-momentum radiation/clamped BCs (u3dbc_im.F pattern)."""
    bry = bry or {}
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        if kind == BC_RADIATION:
            u_kout = radiation(cfg, u_know, u_kout, side, ab,
                               mask=grid.umask)
        elif kind == BC_CLAMPED:
            ext = bry.get(f"u_{side}", 0.0)
            u_kout = clamped(cfg, u_kout, side, ab, ext, mask=grid.umask)
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            u_kout = radiation(cfg, u_know, u_kout, side, ab,
                               mask=grid.umask)
        elif kind == BC_CLAMPED:
            ext = bry.get(f"u_{side}", 0.0)
            u_kout = clamped(cfg, u_kout, side, ab, ext, mask=grid.umask)
    return u_kout


def v3dbc(cfg: Config, grid, lbc: LBC, v_know, v_kout, bry=None):
    """3-D v-momentum radiation/clamped BCs (v3dbc_im.F pattern)."""
    bry = bry or {}
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        if kind == BC_RADIATION:
            v_kout = radiation(cfg, v_know, v_kout, side, ab,
                               mask=grid.vmask)
        elif kind == BC_CLAMPED:
            ext = bry.get(f"v_{side}", 0.0)
            v_kout = clamped(cfg, v_kout, side, ab, ext, mask=grid.vmask)
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            v_kout = radiation(cfg, v_know, v_kout, side, ab,
                               mask=grid.vmask)
        elif kind == BC_CLAMPED:
            ext = bry.get(f"v_{side}", 0.0)
            v_kout = clamped(cfg, v_kout, side, ab, ext, mask=grid.vmask)
    return v_kout


def obc_volcons(cfg: Config, grid, ubar, vbar, zeta, volcons):
    """Integral volume conservation across open boundaries
    (obc_volcons.F obc_flux_tile): compute the net inflow and subtract a
    uniform cross-section correction velocity at every participating
    open-boundary face.  volcons: set of sides, e.g. {"west","east"}.

    Under a ParCtx (shard_map region) the boundary integrals are the
    reference's global allreduce (obc_volcons.F:487 mp_reduce): each
    edge shard sums its share of the face, gated by edge ownership, and
    the partial sums are psum'ed over both mesh axes; the ring
    correction writes stay edge-shard-gated."""
    from jax import lax
    from . import bc
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    ctx = bc.current_ctx()
    D = zeta + grid.h
    area = jnp.asarray(0.0, ubar.dtype)
    flux = jnp.asarray(0.0, ubar.dtype)
    jj = slice(H, H + M)
    ii = slice(H, H + L)

    def gate(val, side):
        # zero a non-owning shard's contribution to the face integral
        if ctx is None:
            return val
        return jnp.where(bc._owns(ctx, side), val, 0.0)

    if "west" in volcons:
        cff = 0.5 * (D[jj, H - 1] + D[jj, H])
        on_u_w = 2.0 / (grid.pn[jj, H - 1] + grid.pn[jj, H])
        cw = gate(cff * on_u_w * grid.umask[jj, H], "west")
        area = area + jnp.sum(cw)
        flux = flux + jnp.sum(cw * ubar[jj, H])
    if "east" in volcons:
        cff = 0.5 * (D[jj, H + L - 1] + D[jj, H + L])
        on_u_e = 2.0 / (grid.pn[jj, H + L - 1] + grid.pn[jj, H + L])
        ce = gate(cff * on_u_e * grid.umask[jj, H + L], "east")
        area = area + jnp.sum(ce)
        flux = flux - jnp.sum(ce * ubar[jj, H + L])
    if "south" in volcons:
        cff = 0.5 * (D[H - 1, ii] + D[H, ii])
        om_v_s = 2.0 / (grid.pm[H - 1, ii] + grid.pm[H, ii])
        cs = gate(cff * om_v_s * grid.vmask[H, ii], "south")
        area = area + jnp.sum(cs)
        flux = flux + jnp.sum(cs * vbar[H, ii])
    if "north" in volcons:
        cff = 0.5 * (D[H + M - 1, ii] + D[H + M, ii])
        om_v_n = 2.0 / (grid.pm[H + M - 1, ii] + grid.pm[H + M, ii])
        cn = gate(cff * om_v_n * grid.vmask[H + M, ii], "north")
        area = area + jnp.sum(cn)
        flux = flux - jnp.sum(cn * vbar[H + M, ii])
    if ctx is not None:
        # the reference's mp_reduce over all tiles
        area = lax.psum(lax.psum(area, ctx.axes[1]), ctx.axes[0])
        flux = lax.psum(lax.psum(flux, ctx.axes[1]), ctx.axes[0])
    ubar_xs = flux / jnp.maximum(area, _EPS)

    if ctx is None:
        if "west" in volcons:
            ubar = ubar.at[jj, H].add(-ubar_xs)
        if "east" in volcons:
            ubar = ubar.at[jj, H + L].add(ubar_xs)
        if "south" in volcons:
            vbar = vbar.at[H, ii].add(-ubar_xs)
        if "north" in volcons:
            vbar = vbar.at[H + M, ii].add(ubar_xs)
        return ubar, vbar

    # sharded ring writes: only interior rows/cols of the owning shards
    # (halo cells are rebuilt by the following fill_halo exchange)
    ny, nx = ubar.shape[-2], ubar.shape[-1]
    rowsel = (jnp.arange(ny) >= H) & (jnp.arange(ny) < H + M)
    colsel = (jnp.arange(nx) >= H) & (jnp.arange(nx) < H + L)
    if "west" in volcons:
        ubar = bc.add_col(ubar, H, jnp.where(rowsel, -ubar_xs, 0.0),
                          "west")
    if "east" in volcons:
        ubar = bc.add_col(ubar, H + L, jnp.where(rowsel, ubar_xs, 0.0),
                          "east")
    if "south" in volcons:
        vbar = bc.add_row(vbar, H, jnp.where(colsel, -ubar_xs, 0.0),
                          "south")
    if "north" in volcons:
        vbar = bc.add_row(vbar, H + M, jnp.where(colsel, ubar_xs, 0.0),
                          "north")
    return ubar, vbar
