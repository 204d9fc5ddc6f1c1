"""Slow momentum RHS assembly (reference ROMS/Nonlinear/rhs3d.F).

Adds to the pressure-gradient ru/rv (from prsgrd): Coriolis, curvilinear
metric terms, 3rd-order upstream-biased horizontal advection with
velocity-dependent hyperdiffusion (Gadv=-0.25), and 4th-order centered
vertical advection; then vertically integrates into the barotropic forcing
rufrc/rvfrc and adds the surface/bottom stress difference.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1

GADV = -0.25


def rhs3d_momentum(cfg: Config, grid: Grid, u, v, Huon, Hvom, W, Hz,
                   ru, rv, sustr, svstr, bustr, bvstr, clm=None,
                   want_diags: bool = False):
    """want_diags (DIAGNOSTICS_UV; mod_diags.F DiaRU/DiaRV): also return a
    dict of the per-term rhs contributions (same units as ru/rv) with keys
    cor/xadv/yadv/vadv, each an (N,Ny,Nx) pair (term_u, term_v).  The
    curvilinear metric terms are folded into cor (the reference spreads
    them over M3xadv/M3yadv; documented delta)."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    dia = {} if want_diags else None

    def _rec(key, term_u, term_v):
        if want_diags:
            dia[key] = (term_u, term_v)

    # ---- Coriolis (rhs3d.F:181-207) ----
    cor_u = cor_v = 0.0
    if cfg.uv_cor:
        cor = 0.5 * Hz * grid.fomn
        UFx = cor * (v + jp1(v))
        cor_u = 0.5 * (UFx + im1(UFx))
        ru = ru + cor_u
        VFe = cor * (u + ip1(u))
        cor_v = -0.5 * (VFe + jm1(VFe))
        rv = rv + cor_v

    # ---- curvilinear metric advection terms (rhs3d.F CURVGRID) ----
    if cfg.curvgrid and cfg.uv_adv:
        cff = 0.5 * (v + jp1(v)) * grid.dndx - \
            0.5 * (u + ip1(u)) * grid.dmde
        cff_v = Hz * cff * 0.5 * (v + jp1(v))
        curv_u = 0.5 * (cff_v + im1(cff_v))
        ru = ru + curv_u
        cor_u = cor_u + curv_u
        cff_u = Hz * cff * 0.5 * (u + ip1(u))
        curv_v = -0.5 * (cff_u + jm1(cff_u))
        rv = rv + curv_v
        cor_v = cor_v + curv_v
    if want_diags:
        _rec("cor", cor_u + jnp.zeros_like(ru), cor_v + jnp.zeros_like(rv))

    if cfg.uv_adv:
        # ---- U3 horizontal advection (rhs3d.F:244-430) ----
        c1, c2 = 9.0 / 16.0, 1.0 / 16.0
        N = u.shape[0]
        uxx = im1(u) - 2.0 * u + ip1(u)
        Huxx = im1(Huon) - 2.0 * Huon + ip1(Huon)
        uxx = bc.extrap_west(cfg, uxx, H)
        Huxx = bc.extrap_west(cfg, Huxx, H)
        uxx = bc.extrap_east(cfg, uxx, H + L)
        Huxx = bc.extrap_east(cfg, Huxx, H + L)
        cff1 = u + ip1(u)
        cup = jnp.where(cff1 > 0.0, uxx, ip1(uxx))
        UFx = 0.25 * (cff1 + GADV * cup) * (
            Huon + ip1(Huon) + GADV * 0.5 * (Huxx + ip1(Huxx)))

        uee = jm1(u) - 2.0 * u + jp1(u)
        uee = bc.extrap_south(cfg, uee, H - 1)
        uee = bc.extrap_north(cfg, uee, H + M)
        Hvxx = im1(Hvom) - 2.0 * Hvom + ip1(Hvom)
        cff1 = u + jm1(u)
        cff2 = Hvom + im1(Hvom)
        cup = jnp.where(cff2 > 0.0, jm1(uee), uee)
        UFe = 0.25 * (cff1 + GADV * cup) * (
            cff2 + GADV * 0.5 * (Hvxx + im1(Hvxx)))

        xadv_u = -(UFx - im1(UFx))
        yadv_u = -(jp1(UFe) - UFe)
        ru = ru + xadv_u + yadv_u

        # ---- 4th-order vertical advection (rhs3d.F:433-520) ----
        Wu = c1 * (W + im1(W)) - c2 * (ip1(W) + shift2w(W))
        # interior k=2..N-2
        flux_int = (c1 * (u[1:-2] + u[2:-1]) -
                    c2 * (u[:-3] + u[3:])) * Wu[2:-2]
        f1 = ((c1 * (u[0] + u[1]) - c2 * (u[0] + u[2])) * Wu[1])[None]
        fNm1 = ((c1 * (u[N - 2] + u[N - 1]) -
                 c2 * (u[N - 3] + u[N - 1])) * Wu[N - 1])[None]
        zero = jnp.zeros_like(f1)
        FCu = jnp.concatenate([zero, f1, flux_int, fNm1, zero], axis=0)
        vadv_u = -(FCu[1:] - FCu[:-1])
        ru = ru + vadv_u

        vxx = im1(v) - 2.0 * v + ip1(v)
        vxx = bc.extrap_west(cfg, vxx, H - 1)
        vxx = bc.extrap_east(cfg, vxx, H + L)
        Huee = jm1(Huon) - 2.0 * Huon + jp1(Huon)
        cff1 = v + im1(v)
        cff2 = Huon + jm1(Huon)
        cup = jnp.where(cff2 > 0.0, im1(vxx), vxx)
        VFx = 0.25 * (cff1 + GADV * cup) * (
            cff2 + GADV * 0.5 * (Huee + jm1(Huee)))

        vee = jm1(v) - 2.0 * v + jp1(v)
        Hvee = jm1(Hvom) - 2.0 * Hvom + jp1(Hvom)
        vee = bc.extrap_south(cfg, vee, H)
        Hvee = bc.extrap_south(cfg, Hvee, H)
        vee = bc.extrap_north(cfg, vee, H + M)
        Hvee = bc.extrap_north(cfg, Hvee, H + M)
        cff1 = v + jp1(v)
        cup = jnp.where(cff1 > 0.0, vee, jp1(vee))
        VFe = 0.25 * (cff1 + GADV * cup) * (
            Hvom + jp1(Hvom) + GADV * 0.5 * (Hvee + jp1(Hvee)))

        xadv_v = -(ip1(VFx) - VFx)
        yadv_v = -(VFe - jm1(VFe))
        rv = rv + xadv_v + yadv_v

        Wv = c1 * (W + jm1(W)) - c2 * (jp1(W) + shift2s(W))
        flux_int = (c1 * (v[1:-2] + v[2:-1]) -
                    c2 * (v[:-3] + v[3:])) * Wv[2:-2]
        f1 = ((c1 * (v[0] + v[1]) - c2 * (v[0] + v[2])) * Wv[1])[None]
        fNm1 = ((c1 * (v[N - 2] + v[N - 1]) -
                 c2 * (v[N - 3] + v[N - 1])) * Wv[N - 1])[None]
        zero = jnp.zeros_like(f1)
        FCv = jnp.concatenate([zero, f1, flux_int, fNm1, zero], axis=0)
        vadv_v = -(FCv[1:] - FCv[:-1])
        rv = rv + vadv_v
        if want_diags:
            _rec("xadv", xadv_u, xadv_v)
            _rec("yadv", yadv_u, yadv_v)
            _rec("vadv", vadv_u, vadv_v)
    elif want_diags:
        zero3 = jnp.zeros_like(ru)
        zero3v = jnp.zeros_like(rv)
        for key in ("xadv", "yadv", "vadv"):
            _rec(key, zero3, zero3v)

    # ---- nudging toward 3-D momentum climatology (rhs3d.F:211-241) ----
    if clm is not None and "uclm" in clm:
        nudg = clm.get("m3nudg", 0.0)
        area_u = grid.om_u * grid.on_u
        ru = ru + nudg * area_u * 0.5 * (Hz + im1(Hz)) * \
            (clm["uclm"] - u)
        area_v = grid.om_v * grid.on_v
        rv = rv + nudg * area_v * 0.5 * (Hz + jm1(Hz)) * \
            (clm["vclm"] - v)

    # ---- BODYFORCE: stresses as body forces over the surface/bottom
    # level ranges instead of boundary fluxes (rhs3d.F:326-470) ----
    if cfg.bodyforce:
        pm, pn = grid.pm, grid.pn
        N = cfg.N
        ks = cfg.levsfrc - 1                 # surface levels ks..N-1
        kb = cfg.levbfrc                     # bottom levels 0..kb-1
        kmask_s = (jnp.arange(N) >= ks)[:, None, None]
        kmask_b = (jnp.arange(N) < kb)[:, None, None]
        wrk_s = jnp.sum(jnp.where(kmask_s, Hz, 0.0), axis=0)
        wrk_b = jnp.sum(jnp.where(kmask_b, Hz, 0.0), axis=0)
        ocffu = 0.25 * (pm + im1(pm)) * (pn + im1(pn))
        Hz_u = Hz + im1(Hz)
        Uwrk_s = sustr / (ocffu * (wrk_s + im1(wrk_s)))
        Uwrk_b = bustr / (ocffu * (wrk_b + im1(wrk_b)))
        ru = ru + jnp.where(kmask_s, Uwrk_s[None] * Hz_u, 0.0) - \
            jnp.where(kmask_b, Uwrk_b[None] * Hz_u, 0.0)
        ocffv = 0.25 * (pm + jm1(pm)) * (pn + jm1(pn))
        Hz_v = Hz + jm1(Hz)
        Vwrk_s = svstr / (ocffv * (wrk_s + jm1(wrk_s)))
        Vwrk_b = bvstr / (ocffv * (wrk_b + jm1(wrk_b)))
        rv = rv + jnp.where(kmask_s, Vwrk_s[None] * Hz_v, 0.0) - \
            jnp.where(kmask_b, Vwrk_b[None] * Hz_v, 0.0)

    # ---- vertical integral -> barotropic forcing (rhs3d.F:523-559) ----
    rufrc = jnp.sum(ru, axis=0)
    rvfrc = jnp.sum(rv, axis=0)
    if not cfg.bodyforce:
        rufrc = rufrc + (sustr - bustr) * grid.om_u * grid.on_u
        rvfrc = rvfrc + (svstr - bvstr) * grid.om_v * grid.on_v
    if want_diags:
        return ru, rv, rufrc, rvfrc, dia
    return ru, rv, rufrc, rvfrc


def shift2w(a):
    """a[..., i-2] accessor (W(i-2) in the u-point interpolation)."""
    return jnp.roll(a, 2, axis=-1)


def shift2s(a):
    """a[..., j-2, :] accessor."""
    return jnp.roll(a, 2, axis=-2)
