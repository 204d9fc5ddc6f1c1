"""Biological source/sink terms: NPZD (Powell et al. 2006) ecosystem.

The analog of ROMS/Nonlinear/Biology/npzd_Powell.h (biology.F plugin
slot).  Four nitrogen-based compartments - nitrate (N), phytoplankton
(P), zooplankton (Z), small detritus (D) - advected/diffused as ordinary
passive tracers by step3d_t, with the food-web conversions applied here
as a chained sequence of backward-implicit stages.

Design notes:
- Every conversion stage treats the consumed compartment implicitly
  (divide by 1+cff) and adds cff * consumed to the consumer, so each
  stage conserves total nitrogen exactly and never produces negatives
  regardless of dt (npzd_Powell.h:300-330 explains the scheme).  The
  stages are pure elementwise ops on (4, N, Ny, Nx) stacks - XLA fuses
  the whole food chain into one kernel.
- Light attenuation is a top-down cumulative sum (no scan needed):
  cell-average PAR = I_top * (1 - exp(-Att)) / Att.
- Vertical sinking reproduces the reference's CFL-free PPM
  reconstruction + WENO interface reconciliation + semi-Lagrangian
  flux (npzd_Powell.h:430-630).  The departure-point search (a double
  k-loop in the reference) is a broadcast (N, N) mask sum - N is tiny
  (10-30 levels) so the quadratic form is cheaper than a sequential
  scan on the VPU.  Material crossing the seabed is exported (lost),
  exactly as the reference's FC(i,0) bottom flux.
- The increment (Bio - Bio_old) is computed from the OLD time level and
  added to the new-time tracers (forward coupling, npzd_Powell.h:640).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp

from ..config import Config
from ..constants import rho0_default as rho0, Cp

_MINVAL = 1.0e-6
_WENO_EPS = 1.0e-14


@dataclass(frozen=True)
class NPZDParams:
    """npzd_Powell.in defaults (External/npzd_Powell.in:49-131)."""
    BioIter: int = 1
    PARfrac: float = 0.43
    AttSW: float = 0.067      # 1/m, seawater attenuation
    AttPhy: float = 0.0095    # m2/mmol, self-shading
    PhyIS: float = 0.025      # m2/W, initial P-I slope
    Vm_NO3: float = 1.5       # 1/day, nitrate uptake
    PhyMRD: float = 0.1       # 1/day, P mortality -> D
    PhyMRN: float = 0.0       # 1/day, P mortality -> N
    K_NO3: float = 1.0        # mmol/m3 half-saturation
    Ivlev: float = 0.84
    ZooGR: float = 0.52       # 1/day grazing
    ZooEED: float = 0.0       # sloppy feeding -> D
    ZooEEN: float = 0.3       # sloppy feeding -> N
    ZooMRD: float = 0.145     # 1/day, Z mortality -> D
    ZooMRN: float = 0.0       # 1/day, Z mortality -> N
    DetRR: float = 1.03       # 1/day remineralization
    wPhy: float = 0.0         # m/day sinking
    wDet: float = 8.0         # m/day sinking
    const_par: Optional[float] = None   # CONST_PAR: 158.075 W/m2


def _positive_definite(bio):
    """Draw nitrogen from the most abundant pool to top negative pools
    up to MinVal (npzd_Powell.h:226-250)."""
    deficit = jnp.sum(jnp.maximum(0.0, _MINVAL - bio), axis=0)
    imax = jnp.argmax(bio, axis=0)
    clamped = jnp.maximum(bio, _MINVAL)
    take = jnp.max(bio, axis=0) > deficit
    onehot = (jnp.arange(bio.shape[0])[:, None, None, None] == imax[None])
    return clamped - jnp.where(take, deficit, 0.0)[None] * onehot


def _light(p: NPZDParams, phy, z_w, par_sur):
    """Cell-averaged PAR, attenuated top-down through seawater +
    phytoplankton self-shading (npzd_Powell.h:336-363)."""
    dz = z_w[1:] - z_w[:-1]
    att = (p.AttSW + p.AttPhy * phy) * dz                  # (N,Ny,Nx)
    # cumulative attenuation from the surface down to the TOP of cell k
    att_above = jnp.flip(jnp.cumsum(jnp.flip(att, 0), axis=0), 0) - att
    itop = par_sur[None] * jnp.exp(-att_above)
    light = itop * (1.0 - jnp.exp(-att)) / jnp.maximum(att, 1.0e-20)
    return jnp.where(par_sur[None] > 0.0, light, 0.0)


def _monotonize(qc, dltR, dltL, cffR, cffL, strict):
    """The reference's three-branch PPM slope limiter."""
    zero = dltR * dltL <= 0.0 if not strict else dltR * dltL < 0.0
    condA = jnp.abs(dltR) > jnp.abs(cffL)
    condB = jnp.abs(dltL) > jnp.abs(cffR)
    dR = jnp.where(zero, 0.0, jnp.where(condA, cffL, dltR))
    dL = jnp.where(zero, 0.0,
                   jnp.where(condA, dltL, jnp.where(condB, cffR, dltL)))
    return dR, dL


def ppm_sink(qc, Hz, z_w, dist):
    """Sink the profile qc (N,Ny,Nx) a distance `dist` (m) downward with
    the reference's PPM + WENO semi-Lagrangian flux.  Returns
    (new profile, seabed export flux in m*units)."""
    N = qc.shape[0]
    fcg = (qc[1:] - qc[:-1]) / (Hz[:-1] + Hz[1:])          # (N-1,...)

    # parabolic segments for interior boxes k=1..N-2
    q, hzm, hz, hzp = qc[1:-1], Hz[:-2], Hz[1:-1], Hz[2:]
    dltR = hz * fcg[1:]
    dltL = hz * fcg[:-1]
    cff = hzm + 2.0 * hz + hzp
    dltR, dltL = _monotonize(q, dltR, dltL, cff * fcg[1:], cff * fcg[:-1],
                             strict=False)
    c = (dltR - dltL) / (hzm + hz + hzp)
    dltR = dltR - c * hzp
    dltL = dltL + c * hzm
    bR = jnp.concatenate([qc[:1], q + dltR, qc[-1:]])
    bL = jnp.concatenate([qc[:1], q - dltL, qc[-1:]])
    WR = jnp.concatenate([jnp.zeros_like(qc[:1]),
                          (2.0 * dltR - dltL) ** 2,
                          jnp.zeros_like(qc[:1])])
    WL = jnp.concatenate([jnp.zeros_like(qc[:1]),
                          (dltR - 2.0 * dltL) ** 2,
                          jnp.zeros_like(qc[:1])])

    # WENO reconciliation of interface values, boxes k=1..N-3
    dl = jnp.maximum(_WENO_EPS, WL[1:N - 2])
    dr = jnp.maximum(_WENO_EPS, WR[2:N - 1])
    mid = (dr * bR[1:N - 2] + dl * bL[2:N - 1]) / (dr + dl)
    bR = jnp.concatenate([bR[:1], mid, bR[N - 2:]])
    bL = jnp.concatenate([bL[:2], mid, bL[N - 1:]])

    # strictly monotonic default end conditions (npzd_Powell.h:520-535)
    bR = bR.at[N - 1].set(qc[N - 1]).at[N - 2].set(qc[N - 1])
    bL = bL.at[N - 1].set(qc[N - 1])
    bR = bR.at[0].set(qc[0])
    bL = bL.at[1].set(qc[0]).at[0].set(qc[0])

    # re-monotonize inside each box
    dltR, dltL = _monotonize(qc, bR - qc, qc - bL,
                             2.0 * (bR - qc), 2.0 * (qc - bL), strict=True)
    bR = qc + dltR
    bL = qc - dltL

    # semi-Lagrangian flux through the bottom interface of every box
    wld = z_w[:-1] + dist                                   # (N,...)
    wrq = Hz * qc
    kk = jnp.arange(N)[:, None]
    ss = jnp.arange(N)[None, :]
    # boxes ks fully below the departure level sink through interface k
    full = ((ss >= kk) & (ss <= N - 2))[..., None, None] & \
        (wld[:, None] > z_w[None, 1:])
    fc_whole = jnp.sum(jnp.where(full, wrq[None], 0.0), axis=1)
    ksrc = kk[..., None] + jnp.sum(full, axis=1)
    ksrc = jnp.minimum(ksrc, N - 1)

    take = lambda a: jnp.take_along_axis(a, ksrc, axis=0)
    cu = jnp.minimum(1.0, (wld - take(z_w[:-1])) / take(Hz))
    bLs, bRs, qs = take(bL), take(bR), take(qc)
    frac = take(Hz) * cu * (
        bLs + cu * (0.5 * (bRs - bLs) -
                    (1.5 - cu) * (bRs + bLs - 2.0 * qs)))
    fc = fc_whole + frac                                    # (N,...)
    fci = jnp.concatenate([fc, jnp.zeros_like(fc[:1])])     # top flux = 0
    return qc + (fci[1:] - fci[:-1]) / Hz, fc[0]


def npzd_powell(cfg: Config, p: NPZDParams, t_old, t_new, Hz, z_w, srflx):
    """Apply one model-dt of NPZD conversions.  t_old/t_new are the full
    tracer stacks (NT,N,Ny,Nx) at the old/new time level; the increment
    computed from t_old is added to t_new (npzd_Powell.h:640-655)."""
    idb = cfg.ibio
    if len(idb) != 4 or max(idb) >= cfg.ntracers:
        raise ValueError(
            f"npzd_powell needs 4 bio tracer indices < ntracers="
            f"{cfg.ntracers}; got ibio={idb} (JAX would silently clamp "
            f"out-of-range indices)")
    iN, iP, iZ, iD = 0, 1, 2, 3
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = jnp.stack([t_old[i] for i in idb])
    bio = _positive_definite(bio)
    bio_old = bio

    if p.const_par is not None:
        par_sur = jnp.full_like(bio[0, 0], p.const_par)
    else:
        srf = srflx if srflx is not None else jnp.zeros_like(bio[0, 0])
        par_sur = p.PARfrac * srf * rho0 * Cp   # kinematic -> W/m2

    for _ in range(max(1, p.BioIter)):
        light = _light(p, bio[iP], z_w, par_sur)

        # nitrate uptake, smooth P-I curve (npzd_Powell.h:371-385)
        cff1 = dtd * p.Vm_NO3 * p.PhyIS
        cff4 = 1.0 / jnp.sqrt(p.Vm_NO3 ** 2 + p.PhyIS ** 2 * light ** 2)
        cff = bio[iP] * cff1 * cff4 * light / (p.K_NO3 + bio[iN])
        n_new = bio[iN] / (1.0 + cff)
        bio = bio.at[iN].set(n_new).at[iP].add(n_new * cff)

        # Ivlev grazing with sloppy feeding (npzd_Powell.h:391-408)
        cff = bio[iZ] * dtd * p.ZooGR * \
            (1.0 - jnp.exp(-p.Ivlev * bio[iP])) / bio[iP]
        p_new = bio[iP] / (1.0 + cff)
        bio = (bio.at[iP].set(p_new)
               .at[iZ].add(p_new * (1.0 - p.ZooEEN - p.ZooEED) * cff)
               .at[iN].add(p_new * p.ZooEEN * cff)
               .at[iD].add(p_new * p.ZooEED * cff))

        # P and Z mortality (npzd_Powell.h:413-440)
        for (src, mrn, mrd) in ((iP, p.PhyMRN, p.PhyMRD),
                                (iZ, p.ZooMRN, p.ZooMRD)):
            s_new = bio[src] / (1.0 + dtd * (mrn + mrd))
            bio = (bio.at[src].set(s_new)
                   .at[iN].add(s_new * dtd * mrn)
                   .at[iD].add(s_new * dtd * mrd))

        # remineralization (npzd_Powell.h:444-452)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio = bio.at[iD].set(d_new).at[iN].add(d_new * dtd * p.DetRR)

        # sinking of P and D
        for (comp, w) in ((iP, p.wPhy), (iD, p.wDet)):
            if w != 0.0:
                sunk, _ = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))
                bio = bio.at[comp].set(sunk)

    incr = bio - bio_old
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new


def apply_biology(cfg: Config, grid, t_old, t_new, Hz, z_w, srflx,
                  z_r=None, sustr=None, svstr=None,
                  uwind=None, vwind=None, frc=None, time=None):
    """Dispatch on cfg.biology (biology.F plugin slot).

    frc: the step's forcing dict; models with file-driven inputs read
    their extra fields from it (hypoxia_srm: "respiration"; red_tide:
    "CystIni", "DIN_obs").  time: model time (s) for models with an
    endogenous annual clock (red_tide)."""
    frc = frc or {}
    if cfg.biology == "npzd_powell":
        p = cfg.bio_params or NPZDParams()
        return npzd_powell(cfg, p, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "npzd_franks":
        from .bio_models import npzd_franks, FranksParams
        p = cfg.bio_params or FranksParams()
        return npzd_franks(cfg, p, t_old, t_new, Hz, z_w, z_r, srflx)
    if cfg.biology == "npzd_iron":
        from .bio_models import npzd_iron, IronParams
        p = cfg.bio_params or IronParams()
        return npzd_iron(cfg, p, grid, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "fennel":
        from .bio_models import fennel, FennelParams
        p = cfg.bio_params or FennelParams()
        return fennel(cfg, p, grid, t_old, t_new, Hz, z_w, srflx,
                      sustr=sustr, svstr=svstr, uwind=uwind,
                      vwind=vwind)
    if cfg.biology == "hypoxia_srm":
        from .bio_models import hypoxia_srm, HypoxiaParams
        p = cfg.bio_params or HypoxiaParams()
        return hypoxia_srm(cfg, p, grid, t_old, t_new, Hz, z_w, srflx,
                           sustr=sustr, svstr=svstr, uwind=uwind,
                           vwind=vwind,
                           respiration=frc.get("respiration", None))
    if cfg.biology == "nemuro":
        from .bio_models import nemuro, NemuroParams
        p = cfg.bio_params or NemuroParams()
        return nemuro(cfg, p, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "ecosim":
        from .bio_models import ecosim, EcosimParams
        p = cfg.bio_params or EcosimParams()
        return ecosim(cfg, p, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "red_tide":
        from .bio_models import red_tide, RedTideParams
        p = cfg.bio_params or RedTideParams()
        t = time if time is not None else 0.0
        yday = jnp.mod(t / 86400.0, 365.25)
        return red_tide(cfg, p, t_old, t_new, Hz, z_w, z_r, srflx,
                        yday, cyst_ini=frc.get("CystIni", None),
                        din_obs=frc.get("DIN_obs", None))
    raise ValueError(f"unknown biology model {cfg.biology!r}")
