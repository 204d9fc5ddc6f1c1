"""LF-AM3 predictor stage (reference ROMS/Nonlinear/pre_step3d.F).

Computes:
 * t3      - intermediate tracers at n+1/2 (slot 3 in the reference),
 * t_nnew  - mass-weighted tracers initialized with surface/bottom flux
             contributions (m Tunits),
 * u_nnew/v_nnew - mass-weighted momentum initialized with the AB3 history
             terms and surface/bottom stresses (m2/s).

The implicit weighting lambda = 1 (mod_scalars.F) makes the explicit
vertical-diffusion part vanish; only the dt*flux boundary terms remain.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config
from ..grid import Grid
from . import bc
from .advection import hadv_fluxes, vadv_flux
from .stencil import ip1, im1, jp1, jm1


def pre_step3d(cfg: Config, grid: Grid, iic, t, t_prev, u, v,
               Hz, z_r, Huon, Hvom, W, Akt,
               sustr, svstr, bustr, bvstr, stflx, btflx,
               ru_prev, ru_prev2, rv_prev, rv_prev2,
               srflx=None, ghats=None, swdk_w=None, sources=None):
    dt = cfg.dt
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    iic = jnp.asarray(iic)
    dtype = u.dtype
    lam = 1.0  # mod_scalars lambda

    # ---------------- tracers: intermediate t3 at n+1/2 ----------------
    t3_list = []
    tn_list = []
    for itrc in range(cfg.ntracers):
        coefs = predictor_coefs(cfg, iic, itrc, dtype)
        ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
        t3_i, tn_i = tracer_predictor(
            cfg, pmn, itrc, coefs, t[itrc], t_prev[itrc], Hz, z_r,
            Huon, Hvom, W, Akt[ltrc],
            ghats[itrc] if (ghats is not None
                            and itrc < ghats.shape[0]) else None,
            srflx if itrc == 0 else None, swdk_w,
            stflx[itrc], btflx[itrc], sources=sources)
        t3_list.append(t3_i)
        tn_list.append(tn_i)

    t3 = jnp.stack(t3_list, axis=0) if t3_list else t
    t_nnew = jnp.stack(tn_list, axis=0) if tn_list else t

    # ---------------- momentum: start u(nnew)/v(nnew) ----------------
    a1, a2 = ab3_start_coefs(iic, dtype)
    u_nnew, v_nnew = momentum_init(
        cfg, pm, pn, a1, a2, u, v, Hz, ru_prev, ru_prev2, rv_prev,
        rv_prev2, sustr, svstr, bustr, bvstr)
    return t3, t_nnew, u_nnew, v_nnew


def predictor_coefs(cfg: Config, iic, itrc: int, dtype):
    """The iic-dependent LF/AM3 predictor weights (cff, cff1, cff2,
    cffv); gamma depends only on the (static) per-tracer scheme."""
    dt = cfg.dt
    iic = jnp.asarray(iic)
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    gam_h = 0.5 if hscheme in ("MPDATA", "HSIMT") else 1.0 / 6.0
    gam_v = 0.5 if vscheme in ("MPDATA", "HSIMT") else 1.0 / 6.0
    cff = jnp.where(iic == 0, 0.5 * dt, (1.0 - gam_h) * dt).astype(dtype)
    cff1 = jnp.where(iic == 0, 1.0, 0.5 + gam_h).astype(dtype)
    cff2 = jnp.where(iic == 0, 0.0, 0.5 - gam_h).astype(dtype)
    cffv = jnp.where(iic == 0, 0.5 * dt, (1.0 - gam_v) * dt).astype(dtype)
    return cff, cff1, cff2, cffv


def tracer_predictor(cfg: Config, pmn, itrc: int, coefs, q, q_prev,
                     Hz, z_r, Huon, Hvom, W, Akt_l, ghats_i, srflx,
                     swdk_w, stflx_i, btflx_i, sources=None):
    """One tracer's LF-AM3 predictor (the pre_step3d.F:336-598 tracer
    loop body): returns (t3_i, t_nnew_i)."""
    dt = cfg.dt
    lam = 1.0  # mod_scalars lambda
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    # MPDATA/HSIMT use first-order upstream fluxes in the predictor
    fx_scheme = "U1" if hscheme in ("MPDATA", "HSIMT") else hscheme
    fv_scheme = "U1" if vscheme in ("MPDATA", "HSIMT") else vscheme
    cff, cff1, cff2, cffv = coefs

    FX, FE = hadv_fluxes(cfg, fx_scheme, q, Huon, Hvom)
    if sources is not None:
        # river faces carry Huon*Tsrc, not the advective stencil
        # (pre_step3d.F:530-548 LuvSrc)
        from .sources import apply_tracer_flux_sources
        FX, FE = apply_tracer_flux_sources(sources, itrc, FX, FE,
                                           Huon, Hvom)
    t3 = Hz * (cff1 * q + cff2 * q_prev) - \
        cff * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))

    # vertical advection + artificial continuity (pre_step3d.F:556-598)
    FC = vadv_flux(fv_scheme, q, W, Hz, "predictor")
    DC = 1.0 / (Hz - cffv * pmn *
                ((ip1(Huon) - Huon) + (jp1(Hvom) - Hvom) +
                 (W[1:] - W[:-1])))
    t3 = DC * (t3 - cffv * pmn * (FC[1:] - FC[:-1]))
    t3 = bc.apply_bc_rho(cfg, cfg.lbc_t, t3)

    # start t(nnew): explicit part of vertical diffusion + flux BCs
    if lam != 1.0:
        FCd = dt * (1.0 - lam) * Akt_l[1:-1] * \
            (q[1:] - q[:-1]) / (z_r[1:] - z_r[:-1])
    else:
        FCd = jnp.zeros_like(W[1:-1])
    # KPP nonlocal transport flux (pre_step3d.F LMD_NONLOCAL branch)
    if ghats_i is not None:
        FCd = FCd - dt * Akt_l[1:-1] * ghats_i[1:-1]
    # penetrating shortwave (pre_step3d.F SOLAR_SOURCE branch)
    if srflx is not None and swdk_w is not None:
        FCd = FCd + dt * srflx[None] * swdk_w[1:-1]
    FCd = jnp.concatenate(
        [dt * btflx_i[None], FCd, dt * stflx_i[None]], axis=0)
    tn = Hz * q + (FCd[1:] - FCd[:-1])
    return t3, tn


def ab3_start_coefs(iic, dtype):
    """AB3 startup ladder (pre_step3d.F:659-700): coefficients applied to
    (r_{n-2}, r_{n-1}) histories; the 23/12 r_n term is added later in
    step3d_uv once the new RHS exists."""
    iic = jnp.asarray(iic)
    a1 = jnp.where(iic <= 1, 0.0, 5.0 / 12.0).astype(dtype)
    a2 = jnp.where(iic == 0, 0.0,
                   jnp.where(iic == 1, -0.5, -16.0 / 12.0)).astype(dtype)
    return a1, a2


def momentum_init(cfg: Config, pm, pn, a1, a2, u, v, Hz,
                  ru_prev, ru_prev2, rv_prev, rv_prev2,
                  sustr, svstr, bustr, bvstr):
    """Mass-weighted momentum start (pre_step3d.F:659-700): AB3 history
    terms plus surface/bottom stress boundary fluxes."""
    dt = cfg.dt
    # with BODYFORCE the stresses enter through ru/rv in rhs3d, not as
    # predictor boundary fluxes (pre_step3d.F:931-1106 #ifndef blocks)
    if cfg.bodyforce:
        sustr = bustr = jnp.zeros_like(sustr)
        svstr = bvstr = jnp.zeros_like(svstr)
    DC0u = dt * 0.25 * (pm + im1(pm)) * (pn + im1(pn))
    FCu = jnp.concatenate(
        [dt * bustr[None], jnp.zeros_like(u[1:]), dt * sustr[None]], axis=0)
    u_nnew = u * 0.5 * (Hz + im1(Hz)) + \
        DC0u * (a1 * ru_prev2 + a2 * ru_prev) + (FCu[1:] - FCu[:-1])

    DC0v = dt * 0.25 * (pm + jm1(pm)) * (pn + jm1(pn))
    FCv = jnp.concatenate(
        [dt * bvstr[None], jnp.zeros_like(v[1:]), dt * svstr[None]], axis=0)
    v_nnew = v * 0.5 * (Hz + jm1(Hz)) + \
        DC0v * (a1 * rv_prev2 + a2 * rv_prev) + (FCv[1:] - FCv[:-1])
    return u_nnew, v_nnew
