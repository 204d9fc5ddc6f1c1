"""Sediment transport: suspended load, bed exchange, bed layers, bedload.

JAX equivalent of ROMS/Nonlinear/Sediment/ (sediment.F driver,
sed_settling.F, sed_fluxes.F, sed_bed.F, sed_bedload.F).  Sediment
classes ride as ordinary passive tracers (concentration kg/m3) through
step3d_t; this module applies, in reference order:

 1. vertical settling with the CFL-free PPM + WENO semi-Lagrangian
    scheme (sed_settling.F:300-580 == biology.ppm_sink, shared code);
    the seabed export is the deposition flux (kg/m2),
 2. erosion from the top bed layer (Ariathurai & Arulanandan law,
    sed_fluxes.F:246-280), limited by active-layer content so bed mass
    can never go negative,
 3. Meyer-Peter & Mueller bedload with upwind face shift and
    closed-boundary zeroing (sed_bedload.F:405-780, BEDLOAD_MPM path),
 4. bed-layer bookkeeping: Harris & Wiberg active-layer thickness,
    borrow-from-below when erosion thins the top layer, new-layer
    creation on heavy deposition (sed_bed.F:246-460).

Simplifications vs the reference (documented deltas): the multi-layer
borrow cascade of sed_bed.F:396-446 is collapsed to a single
borrow-from-layer-2 per step (identical in the usual Nbed=1..3 runs;
differs only when one step erodes through multiple layers), and
SED_MORPH bed-thickness feedback to h is not yet wired.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp

from .. import constants as C
from ..config import Config
from .bc import fill_halo, set_col, set_row
from .biology import ppm_sink
from .stencil import im1, ip1, jm1, jp1

_EPS = 1.0e-14


@dataclass(frozen=True)
class SedParams:
    """Per-class sediment parameters (sediment.in keywords; mod_sediment).

    tau_ce/tau_cd are KINEMATIC critical stresses (m2/s2, i.e. N/m2
    divided by rho0 as read_sedpar does); Wsed in m/s positive down;
    Erate in kg/m2/s; Sd50 in m; Srho in kg/m3.
    """
    ised0: int = 2                    # first sediment tracer index
    Sd50: Tuple[float, ...] = (0.00015,)
    Srho: Tuple[float, ...] = (2650.0,)
    Wsed: Tuple[float, ...] = (0.001,)
    Erate: Tuple[float, ...] = (5.0e-5,)
    tau_ce: Tuple[float, ...] = (0.05 / 1025.0,)
    tau_cd: Tuple[float, ...] = (0.05 / 1025.0,)
    poros: float = 0.5
    Nbed: int = 1
    bedload: bool = False
    bedload_method: str = "mpm"       # BEDLOAD_MPM | BEDLOAD_SOULSBY
    bedload_coeff: float = 0.1
    newlayer_thick: float = 0.01      # m; threshold for stratum creation
    # SED_MORPH: feed bed-thickness changes back into the bathymetry
    # (set_depth.F:166,214) with the morphological acceleration factor
    # applied to the bed fluxes (sed_bed.F:263-270)
    sed_morph: bool = False
    morph_fac: float = 1.0

    @property
    def NST(self) -> int:
        return len(self.Sd50)


def bottom_stress_mag(bustr, bvstr):
    """Kinematic bottom stress magnitude at rho points
    (sed_fluxes.F:219-224)."""
    return 0.5 * jnp.sqrt((bustr + ip1(bustr)) ** 2 +
                          (bvstr + jp1(bvstr)) ** 2)


def _sanitize_ring(cfg: Config, f):
    """Overwrite the boundary-ring row/col outside closed edges with the
    adjacent interior value, then fill the halo.

    The u/v ghost ring outside a wall is scratch that valid stencils
    never read (ops/stencil.py docstring), but the sediment kernels
    evaluate stress at every padded point - stale ring values there
    would drive unbounded spurious erosion (the reference only computes
    sediment on Istr:Iend,Jstr:Jend and exchanges afterwards)."""
    H = cfg.halo
    if not cfg.ns_periodic:
        f = set_row(f, H - 1, f[..., H, :], "south")
        f = set_row(f, H + cfg.Mm, f[..., H + cfg.Mm - 1, :], "north")
    if not cfg.ew_periodic:
        f = set_col(f, H - 1, f[..., :, H], "west")
        f = set_col(f, H + cfg.Lm, f[..., :, H + cfg.Lm - 1], "east")
    return fill_halo(cfg, f)


def _bed_thickness(p: SedParams, bed_mass):
    """Layer thickness from per-class mass (bed(:,:,:,ithck) analog):
    thick[l] = sum_c mass[l,c] / (Srho_c * (1-poros))."""
    srho = jnp.asarray(p.Srho, bed_mass.dtype)[None, :, None, None]
    return jnp.sum(bed_mass / (srho * (1.0 - p.poros)), axis=1)


def apply_sediment(cfg: Config, grid, p: SedParams, t_new, bed_mass,
                   Hz, z_w, bustr, bvstr, tau_cw=None,
                   tau_c=None, tau_wav=None, phicw=None):
    """One dt of sediment dynamics.  t_new: (NT,N,Ny,Nx) tracer stack
    after advection/diffusion (concentrations, kg/m3); bed_mass:
    (Nbed,NST,Ny,Nx) kg/m2.  tau_cw: optional max combined wave-current
    stress from the BBL (sed_fluxes.F uses bustrcwmax when BBL_MODEL);
    falls back to the pure-current stress.  Returns (t_new, bed_mass)."""
    dt = cfg.dt
    bustr = _sanitize_ring(cfg, bustr)
    bvstr = _sanitize_ring(cfg, bvstr)
    if tau_cw is not None:
        tau_w = _sanitize_ring(cfg, tau_cw)
    else:
        tau_w = bottom_stress_mag(bustr, bvstr)
    rmask = grid.rmask

    top = bed_mass[0]                              # (NST,Ny,Nx)
    total_top = jnp.sum(top, axis=0)
    frac = top / jnp.maximum(total_top[None], _EPS)

    # mean top-layer grain size / critical stress for the active layer
    sd50 = jnp.asarray(p.Sd50, tau_w.dtype)[:, None, None]
    tce = jnp.asarray(p.tau_ce, tau_w.dtype)[:, None, None]
    d50_bed = jnp.sum(frac * sd50, axis=0)
    tauc_bed = jnp.sum(frac * tce, axis=0)

    # active layer thickness (sed_bed.F:377-383, Harris & Wiberg)
    iactv = jnp.maximum(0.0, 0.007 * (tau_w - tauc_bed) * cfg.rho0) + \
        6.0 * d50_bed

    dep = []
    ero = []
    for c in range(p.NST):
        it = p.ised0 + c
        # --- settling (sed_settling.F; shared PPM kernel) ---
        conc, flux_bot = ppm_sink(t_new[it], Hz, z_w, dt * abs(p.Wsed[c]))
        dep_c = flux_bot * rmask                     # kg/m2 deposited
        # --- erosion (sed_fluxes.F:255-280) ---
        cff1 = (1.0 - p.poros) * frac[c]
        ero_c = dt * p.Erate[c] * cff1 * \
            jnp.maximum(0.0, tau_w / p.tau_ce[c] - 1.0)
        avail = jnp.minimum(p.Srho[c] * cff1 * iactv, top[c]) + dep_c
        ero_c = jnp.minimum(ero_c, avail) * rmask
        conc = conc.at[0].add(ero_c / Hz[0])
        t_new = t_new.at[it].set(conc)
        dep.append(dep_c)
        ero.append(ero_c)
    dep = jnp.stack(dep)
    ero = jnp.stack(ero)
    # SED_MORPH: the bed sees the exchange amplified by the
    # morphological acceleration factor (sed_bed.F:263-270); the water
    # column keeps the physical fluxes
    mfac = p.morph_fac if p.sed_morph else 1.0
    bed_mass = bed_mass.at[0].add(mfac * (dep - ero))

    # --- bedload (sed_bedload.F, BEDLOAD_MPM / BEDLOAD_SOULSBY) ---
    if p.bedload:
        bed_mass = _bedload_mpm(cfg, grid, p, bed_mass, tau_w,
                                bustr, bvstr, tau_c=tau_c,
                                tau_wav=tau_wav, phicw=phicw)

    # --- bed layer bookkeeping (sed_bed.F) ---
    bed_mass = _bed_layers(cfg, p, bed_mass, iactv)
    # refresh halos (the reference exchanges t and the bed arrays at the
    # end of the sediment step via mp_exchange4d); without this, halo
    # columns integrate erosion with stale neighbours and diverge
    t_new = fill_halo(cfg, t_new)
    bed_mass = fill_halo(cfg, jnp.maximum(bed_mass, 0.0))
    return t_new, bed_mass


def bed_thickness_total(p: SedParams, bed_mass):
    """Total bed thickness (m) summed over strata and classes
    (sed_bed.F:484-493 bed_thick)."""
    srho = jnp.asarray(p.Srho, bed_mass.dtype)[None, :, None, None]
    return jnp.sum(bed_mass / (srho * (1.0 - p.poros)), axis=(0, 1))


def _soulsby_transport(cfg: Config, p: SedParams, c, tau_mean, tau_wav,
                       phicw):
    """Soulsby & Damgaard (2005) wave-averaged bedload rates along and
    across the mean-current direction (sed_bedload.F:415-478,
    BEDLOAD_SOULSBY with the reference's w_asym=0 override).  Returns
    (bedld_x, bedld_y) in kg/m/s in the current-aligned frame."""
    g = C.g
    smgd = (p.Srho[c] / cfg.rho0 - 1.0) * g * p.Sd50[c]
    osmgd = 1.0 / smgd
    smgdr = jnp.sqrt(smgd) * p.Sd50[c] * p.Srho[c]
    theta_wav = tau_wav * osmgd + _EPS
    theta_mean = tau_mean * osmgd
    # max Shields stress over the wave cycle (w_asym = 0)
    theta_max = jnp.sqrt(
        (theta_mean + theta_wav * jnp.cos(phicw)) ** 2 +
        (theta_wav * jnp.sin(phicw)) ** 2)
    # motion initiation (the reference compares the nondimensional
    # theta_max against the kinematic tau_ce - reproduced as-is)
    cff3 = jnp.where(theta_max / p.tau_ce[c] > 1.0, 1.0, 0.0)
    phi_x1 = 12.0 * jnp.sqrt(theta_mean) * \
        jnp.maximum(theta_mean - p.tau_ce[c], 0.0)
    phi_x2 = 12.0 * (0.9534 + 0.1907 * jnp.cos(2.0 * phicw)) * \
        jnp.sqrt(theta_wav) * theta_mean
    phi_x = jnp.where(jnp.abs(phi_x2) > phi_x1, phi_x2, phi_x1)
    bedld_x = phi_x * smgdr * cff3
    cff5 = theta_wav ** 1.5 + 1.5 * theta_mean ** 1.5
    phi_y = 12.0 * 0.1907 * theta_wav * theta_wav * \
        (theta_mean * jnp.sin(2.0 * phicw)) / \
        jnp.maximum(cff5, _EPS) * cff3
    bedld_y = phi_y * smgdr
    return bedld_x, bedld_y


def _bedload_mpm(cfg: Config, grid, p: SedParams, bed_mass, tau_w,
                 bustr, bvstr, tau_c=None, tau_wav=None, phicw=None):
    """Meyer-Peter & Mueller (default) or Soulsby-Damgaard
    (p.bedload_method='soulsby', requires the BBL wave/current stress
    split) bedload with upwind face shift."""
    soulsby = (p.bedload_method == "soulsby" and tau_c is not None
               and tau_wav is not None and phicw is not None)
    if soulsby:
        # mean stress enhanced by the waves (sed_bedload.F:400-403)
        tau_mean = tau_c * (1.0 + 1.2 * (tau_wav /
                                         (tau_c + tau_wav + _EPS))
                            ** 3.2)
    dt = cfg.dt
    g = C.g
    # stress direction at rho points (sed_bedload.F angleu/anglev)
    bu_r = 0.5 * (bustr + ip1(bustr))
    bv_r = 0.5 * (bvstr + jp1(bvstr))
    omag = 1.0 / jnp.maximum(tau_w, _EPS)
    angleu = bu_r * omag
    anglev = bv_r * omag
    on_r = 1.0 / grid.pn
    om_r = 1.0 / grid.pm
    area = om_r * on_r

    frac = bed_mass[0] / jnp.maximum(jnp.sum(bed_mass[0], axis=0)[None],
                                     _EPS)
    top_new = bed_mass[0]
    for c in range(p.NST):
        if soulsby:
            bx, by = _soulsby_transport(cfg, p, c, tau_mean, tau_wav,
                                        phicw)
            # rotate from the current-aligned frame to grid axes
            bed_x = bx * angleu - by * anglev
            bed_y = bx * anglev + by * angleu
            FX_r = bed_x * on_r * dt * p.bedload_coeff * frac[c]
            FE_r = bed_y * om_r * dt * p.bedload_coeff * frac[c]
        else:
            smgd = (p.Srho[c] / cfg.rho0 - 1.0) * g * p.Sd50[c]
            osmgd = 1.0 / smgd
            smgdr = jnp.sqrt(smgd) * p.Sd50[c] * p.Srho[c]
            # kg/m/s (sed_bedload.F:505-513)
            bedld = 8.0 * jnp.maximum(tau_w * osmgd - 0.047, 0.0) ** 1.5 \
                * smgdr
            FX_r = angleu * bedld * on_r * dt * p.bedload_coeff * frac[c]
            FE_r = anglev * bedld * om_r * dt * p.bedload_coeff * frac[c]
        # limit to available top-layer mass (sed_bedload.F:576-588)
        denom = jnp.abs(FX_r) + jnp.abs(FE_r) + _EPS
        cap = bed_mass[0, c] * area
        FX_r = jnp.sign(FX_r) * jnp.minimum(
            jnp.abs(FX_r), cap * jnp.abs(FX_r) / denom)
        FE_r = jnp.sign(FE_r) * jnp.minimum(
            jnp.abs(FE_r), cap * jnp.abs(FE_r) / denom)

        # upwind shift to faces (sed_bedload.F:671-698)
        def face(Fr, dm1, mask):
            s_here = jnp.sign(Fr)
            s_up = jnp.sign(dm1(Fr))
            pos1 = 0.5 * (1.0 + s_here)
            neg1 = 0.5 * (1.0 - s_here)
            posU = 0.5 * (1.0 + s_up)
            negU = 0.5 * (1.0 - s_up)
            mid = 0.5 * (dm1(Fr) + Fr)
            return (posU * (pos1 * dm1(Fr) + neg1 * mid) +
                    negU * (neg1 * Fr + pos1 * mid)) * mask

        FX = face(FX_r, im1, grid.umask)
        FE = face(FE_r, jm1, grid.vmask)
        # closed lateral boundaries carry no bedload (sed_bedload.F:
        # 722-760)
        H = cfg.halo
        if not cfg.ew_periodic:
            if cfg.lbc_t.west == "Clo":
                FX = set_col(FX, H, 0.0, "west")
            if cfg.lbc_t.east == "Clo":
                FX = set_col(FX, H + cfg.Lm, 0.0, "east")
        if not cfg.ns_periodic:
            if cfg.lbc_t.south == "Clo":
                FE = set_row(FE, H, 0.0, "south")
            if cfg.lbc_t.north == "Clo":
                FE = set_row(FE, H + cfg.Mm, 0.0, "north")

        div = (ip1(FX) - FX + jp1(FE) - FE) * grid.pm * grid.pn
        top_new = top_new.at[c].set(
            jnp.maximum(top_new[c] - div, 0.0))
    return bed_mass.at[0].set(top_new)


def _bed_layers(cfg: Config, p: SedParams, bed_mass, iactv):
    """Stratigraphy maintenance (sed_bed.F:377-460, vectorized).

    If the top layer is thinner than the active layer, borrow mass
    proportionally from layer 2.  If deposition made the top layer
    thicker than newlayer_thick + iactv, split it: the excess becomes a
    new second layer and the two bottom strata merge."""
    if p.Nbed == 1:
        return bed_mass
    thick = _bed_thickness(p, bed_mass)

    # borrow from below (sed_bed.F:392-446): full multi-layer cascade.
    # Thickness owed to the active layer is taken from layers 1..Nbed-1
    # in order: layer l contributes clip(deficit - sum(thick[1:l]), 0,
    # thick[l]) of its thickness (all of it if the deficit reaches
    # through it, the remainder if it ends inside it).
    deficit = jnp.maximum(iactv - thick[0], 0.0)
    below = thick[1:]                               # (Nbed-1, Ny, Nx)
    cum_above = jnp.cumsum(below, axis=0) - below   # sum(thick[1:l])
    take = jnp.clip(deficit[None] - cum_above, 0.0, below)
    take_frac = take / jnp.maximum(below, _EPS)
    moved = take_frac[:, None] * bed_mass[1:]       # (Nbed-1, NST, ...)
    bed_mass = bed_mass.at[0].add(jnp.sum(moved, axis=0))
    bed_mass = bed_mass.at[1:].add(-moved)

    # new-layer creation on heavy deposition (sed_bed.F:246-330)
    thick = _bed_thickness(p, bed_mass)
    split = thick[0] > (p.newlayer_thick + iactv)
    keep_frac = jnp.where(split,
                          iactv / jnp.maximum(thick[0], _EPS), 1.0)
    top_keep = keep_frac[None] * bed_mass[0]
    excess = bed_mass[0] - top_keep
    if p.Nbed == 2:
        shifted = (excess + bed_mass[1])[None]
    else:
        merged = (bed_mass[-2] + bed_mass[-1])[None]
        shifted = jnp.concatenate([excess[None], bed_mass[1:-2], merged],
                                  axis=0)
    stacked = jnp.concatenate([top_keep[None], shifted], axis=0)
    return jnp.where(split[None, None], stacked, bed_mass)


def initial_bed(cfg: Config, p: SedParams, thickness=0.10,
                frac=None):
    """Uniform initial bed: total thickness (m) split equally among
    layers, class fractions `frac` (defaults to equal)."""
    shp = (cfg.ny_tot, cfg.nx_tot)
    if frac is None:
        frac = [1.0 / p.NST] * p.NST
    per_layer = thickness / p.Nbed
    mass = jnp.stack([
        jnp.stack([jnp.full(shp, per_layer * frac[c] * p.Srho[c] *
                            (1.0 - p.poros), jnp.dtype(cfg.dtype))
                   for c in range(p.NST)])
        for _ in range(p.Nbed)])
    return mass
