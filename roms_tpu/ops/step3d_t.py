"""Tracer corrector (reference ROMS/Nonlinear/step3d_t.F).

Horizontal advection of the intermediate tracer t3 with the per-tracer
scheme, vertical advection, implicit vertical diffusion (parabolic-spline
reconstruction under SPLINES_VDIFF, else standard tridiagonal), lateral
BCs.  MPDATA tracers take the two-pass route: first-order upstream of t3
(step3d_t.F:408-428, 1167-1180), then the anti-diffusive corrected pass
with monotonically-limited velocities (ops/mpdata.py; step3d_t.F:
1213-1318).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config
from ..grid import Grid
from . import bc, obc
from .advection import hadv_fluxes, vadv_flux
from .stencil import ip1, jp1
from .tridiag import spline_vdiff_flux, thomas_implicit


def step3d_t(cfg: Config, grid: Grid, iic, t_nnew, t3, Huon, Hvom, W,
             Hz_new, z_r_new, Akt, t_old=None, bry=None, clm=None,
             sources=None, want_diags=False):
    """want_diags: additionally return the DIAGNOSTICS_TS budget terms
    (mod_diags.F DiaTrc / step3d_t.F DiaTwrk analog) - per-step tracer
    concentration increments from xi/eta/vertical advection and
    vertical diffusion; exact closure: t_new(interior) =
    t_nnew_entry/Hz_new + xadv + yadv + vadv + vdiff."""
    dt = cfg.dt
    pmn = grid.pm * grid.pn
    oHz = 1.0 / Hz_new
    out = []
    dia = {k: [] for k in ("xadv", "yadv", "vadv", "vdiff")} \
        if want_diags else None
    for itrc in range(cfg.ntracers):
        hscheme = cfg.t_hadv[itrc]
        vscheme = cfg.t_vadv[itrc]
        if hscheme == "MPDATA" or vscheme == "MPDATA":
            if not (hscheme == "MPDATA" and vscheme == "MPDATA"):
                raise ValueError("MPDATA must be used in both directions")
            from .mpdata import mpdata_adiff, mpdata_corrected_fluxes
            # first pass: first-order upstream of t3 in all directions
            FX, FE = hadv_fluxes(cfg, "U1", t3[itrc], Huon, Hvom)
            Ta = t_nnew[itrc] - dt * pmn * ((ip1(FX) - FX) +
                                            (jp1(FE) - FE))
            FC = vadv_flux("U1", t3[itrc], W, Hz_new, "corrector")
            Ta = (Ta - dt * pmn * (FC[1:] - FC[:-1])) * oHz
            Ta = bc.fill_halo(cfg, Ta)
            wet = None
            Ua, Va, Wa = mpdata_adiff(cfg, grid, t3[itrc], Ta, Huon,
                                      Hvom, W, oHz, z_r_new, wet=wet)
            FX2, FE2, FC2 = mpdata_corrected_fluxes(grid, Ta, Ua, Va, Wa,
                                                    Hz_new)
            tn = Ta * Hz_new - dt * pmn * (
                (ip1(FX2) - FX2) + (jp1(FE2) - FE2) + (FC2[1:] - FC2[:-1]))
            ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
            # vertical diffusion on the Tunits*m field (standard tridiag;
            # the spline form needs Tunits input)
            pre_vd = tn * oHz
            tn = thomas_implicit(dt, 1.0, Hz_new, z_r_new, Akt[ltrc], tn)
            if want_diags:
                dia["xadv"].append(-dt * pmn * oHz *
                                   ((ip1(FX) - FX) + (ip1(FX2) - FX2)))
                dia["yadv"].append(-dt * pmn * oHz *
                                   ((jp1(FE) - FE) + (jp1(FE2) - FE2)))
                dia["vadv"].append(-dt * pmn * oHz *
                                   ((FC[1:] - FC[:-1]) +
                                    (FC2[1:] - FC2[:-1])))
                dia["vdiff"].append(tn - pre_vd)
            tn = _finalize_tracer(
                cfg, grid, itrc, tn,
                t_old[itrc] if t_old is not None else None, bry, clm, dt)
            out.append(tn)
            continue

        ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
        res = tracer_corrector(
            cfg, grid, pmn, itrc, t_nnew[itrc], t3[itrc], Huon, Hvom,
            W, Hz_new, z_r_new, oHz, Akt[ltrc],
            t_old[itrc] if t_old is not None else None,
            bry=bry, clm=clm, sources=sources, want_diags=want_diags)
        if want_diags:
            tn, dparts = res
            for k in ("xadv", "yadv", "vadv", "vdiff"):
                dia[k].append(dparts[k])
        else:
            tn = res
        out.append(tn)
    t_stack = jnp.stack(out, axis=0)
    if want_diags:
        return t_stack, {k: jnp.stack(v, axis=0) for k, v in dia.items()}
    return t_stack


def tracer_corrector(cfg: Config, grid, pmn, itrc: int, tn_i, t3_i,
                     Huon, Hvom, W, Hz_new, z_r_new, oHz, Akt_l,
                     t_old_i=None, bry=None, clm=None, sources=None,
                     want_diags=False):
    """One tracer's corrector (the step3d_t.F:227-1142 non-MPDATA loop
    body): horizontal + vertical advection of t3, implicit vertical
    diffusion, climatology nudging, lateral BCs."""
    dt = cfg.dt
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    FX, FE = hadv_fluxes(cfg, hscheme, t3_i, Huon, Hvom,
                         grid=grid, Hz=Hz_new, dt=dt)
    if sources is not None:
        from .sources import apply_tracer_flux_sources
        FX, FE = apply_tracer_flux_sources(sources, itrc, FX, FE,
                                           Huon, Hvom)
    tn = tn_i - dt * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))

    FC = vadv_flux(vscheme, t3_i, W, Hz_new, "corrector",
                   z_r=z_r_new, pmn=pmn, dt=dt)
    tn = (tn - dt * pmn * (FC[1:] - FC[:-1])) * oHz

    pre_vd = tn
    if cfg.splines_vdiff:
        flux = spline_vdiff_flux(dt, Hz_new, oHz, Akt_l, tn)
        tn = tn + dt * oHz * (flux[1:] - flux[:-1])
    else:
        tn = thomas_implicit(dt, 1.0, Hz_new, z_r_new, Akt_l,
                             tn * Hz_new)
    dparts = None
    if want_diags:
        dparts = {"xadv": -dt * pmn * oHz * (ip1(FX) - FX),
                  "yadv": -dt * pmn * oHz * (jp1(FE) - FE),
                  "vadv": -dt * pmn * oHz * (FC[1:] - FC[:-1]),
                  "vdiff": tn - pre_vd}

    tn = _finalize_tracer(cfg, grid, itrc, tn, t_old_i, bry, clm, dt)
    if want_diags:
        return tn, dparts
    return tn


def _finalize_tracer(cfg, grid, itrc, tn, t_old_i, bry, clm, dt):
    """Climatology nudging + lateral BCs shared by all advection paths.
    t_old_i is the single-tracer previous time level (or None)."""
    # nudging toward tracer climatology (step3d_t.F:1172-1185)
    if clm is not None and "tclm" in clm:
        nudg = clm.get("tnudg", 0.0)
        coef = nudg[itrc] if hasattr(nudg, "__len__") else nudg
        tn = tn + dt * coef * (clm["tclm"][itrc] - tn)
    tn = bc.apply_bc_rho(cfg, cfg.lbc_t, tn)
    if t_old_i is not None and bc.has_advanced(cfg.lbc_t):
        tname = "temp" if itrc == 0 else ("salt" if itrc == 1
                                          else f"trc{itrc}")
        tn = bc.fill_halo(cfg, obc.t3dbc(
            cfg, grid, cfg.lbc_t, t_old_i, tn, bry, name=tname))
    return tn
