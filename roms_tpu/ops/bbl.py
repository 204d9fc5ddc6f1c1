"""Wave-current bottom boundary layer (SSW closure).

JAX equivalent of ROMS/Nonlinear/bbl.F + ssw_bbl.h (Sherwood,
Signell & Warner; M94WC + SSW_CALC_UB + SSW_CALC_ZNOT + N92_RIPRUF
variant): combined wave-current bottom stress from the Madsen (1994)
wave boundary layer model, with moveable-bed roughness (Nikuradse +
Wiberg-Rubin saltation + Wiberg-Harris/Malarkey-Davies ripple
roughness).  Everything is elementwise; the reference's bisection /
while-loop solvers become fixed-count vectorized iterations (20 its,
matching MAXIT in ssw_bbl.h:1337).

Outputs (all kinematic, m2/s2): (bustr, bvstr) current stress at u/v
points for the momentum solve, and tau_cwmax at rho points - the
maximum combined wave-current stress that drives sediment resuspension
(sed_fluxes.F uses bustrcwmax).  Ripple geometry (rheight, rlength)
persists across steps (SEDBED bottom(:,:,irhgt/irlen) analog).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from .. import constants as C
from ..config import Config
from .stencil import im1, ip1, jm1, jp1, at_u, at_v

_EPS = 1.0e-10
_VONKAR = 0.41


@dataclass(frozen=True)
class BBLParams:
    """ssw_bbl.h parameters (sediment.in / mod_bbl defaults)."""
    d50: float = 0.00015          # median grain size (m)
    srho: float = 2650.0          # sediment density (kg/m3)
    tau_ce: float = 0.05 / 1025.0  # critical stress (m2/s2)
    zob: float = 0.0001           # default hydraulic roughness (m)
    ar: float = 0.267             # ripple roughness coef (Nielsen 92)
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    calc_znot: bool = True        # SSW_CALC_ZNOT moveable-bed roughness


def _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr):
    """Cap |b*str| at 0.75*Hz_bottom*|u_bottom|/dt: the bottom stress
    may only decelerate the bottom flow toward zero within a step,
    never reverse it (ssw_bbl.h:674-706; the reference applies this
    unconditionally in all three BBL closures).  Essential over thin
    WET_DRY columns where the explicit stress otherwise overshoots."""
    if cfg is None:        # closure-physics unit tests pass cfg=None
        return bustr, bvstr
    cff = 0.75 / cfg.dt
    Hzb = z_w[1] - z_w[0]
    cap_u = cff * 0.5 * (Hzb + im1(Hzb)) * jnp.abs(Ur)
    bustr = jnp.sign(bustr) * jnp.minimum(jnp.abs(bustr), cap_u)
    cap_v = cff * 0.5 * (Hzb + jm1(Hzb)) * jnp.abs(Vr)
    bvstr = jnp.sign(bvstr) * jnp.minimum(jnp.abs(bvstr), cap_v)
    return bustr, bvstr


def wave_number_kh(h, Fwave):
    """Explicit kh from the Dean & Dalrymple (1991) 6th-degree Pade
    approximation (ssw_bbl.h:264-269,SSW_CALC_UB)."""
    K1, K2, K3 = 0.6666666666, 0.3555555555, 0.1608465608
    K4, K5, K6 = 0.0632098765, 0.0217540484, 0.0065407983
    Kdh = h * Fwave ** 2 / C.g
    Kbh2 = Kdh * Kdh + Kdh / (1.0 + Kdh * (K1 + Kdh * (
        K2 + Kdh * (K3 + Kdh * (K4 + Kdh * (K5 + K6 * Kdh))))))
    return jnp.sqrt(Kbh2)


def _fwc(cukw):
    """Madsen (1994) wave friction factor, eqns 32-33 branches
    (ssw_bbl.h:1389-1398)."""
    return jnp.where(
        (cukw > 0.2) & (cukw <= 100.0),
        jnp.exp(7.02 * jnp.maximum(cukw, 0.2) ** (-0.078) - 8.82),
        jnp.where(cukw > 10000.0,
                  jnp.exp(5.61 * 10000.0 ** (-0.109) - 7.30),
                  jnp.where(cukw > 100.0,
                            jnp.exp(5.61 * jnp.maximum(cukw, 1.0) **
                                    (-0.109) - 7.30),
                            0.43)))


def madsen94(ubr, wr, ucr, zr, phiwc, kN, n_iter: int = 20):
    """Grant-Madsen wave-current model (ssw_bbl.h madsen94, :1301-1456).
    Vectorized fixed-iteration version of the reference's while loop.
    Returns (ustrc, ustrwm, ustrr, zoa)."""
    zo = kN / 30.0
    cosphiwc = jnp.abs(jnp.cos(phiwc))

    rmu = jnp.zeros_like(ubr)
    Cmu = jnp.ones_like(ubr)
    ustrc = jnp.zeros_like(ubr)
    ustrwm2 = jnp.zeros_like(ubr)
    ustrr = jnp.zeros_like(ubr)
    dwc = kN * jnp.ones_like(ubr)
    for _ in range(n_iter):
        cukw = Cmu * ubr / (kN * wr)
        fwci = Cmu * _fwc(cukw)
        ustrwm2 = 0.5 * fwci * ubr * ubr                   # Eq 29
        ustrr2 = Cmu * ustrwm2                             # Eq 26
        ustrr = jnp.sqrt(ustrr2)
        dwc = jnp.where(cukw >= 8.0,
                        2.0 * _VONKAR * ustrr / jnp.maximum(wr, _EPS),
                        kN)                                # Eq 36
        dwc = jnp.clip(dwc, kN, 0.9 * zr)
        # floors: in near-dry WET_DRY columns zr ~ mm and the roughness
        # clamp can give dwc == zo (lndw -> 0 -> inf); the reference only
        # evaluates wet cells
        lnzr = jnp.maximum(jnp.log(zr / dwc), 1.0e-3)
        lndw = jnp.maximum(jnp.log(dwc / zo), 1.0e-3)
        lnln = lnzr / lndw
        bigsqr = -1.0 + jnp.sqrt(
            1.0 + (4.0 * _VONKAR * lndw / (lnzr * lnzr)) *
            ucr / jnp.maximum(ustrr, _EPS))
        ustrc = 0.5 * ustrr * lnln * bigsqr                # Eq 38
        rmu = ustrc * ustrc / jnp.maximum(ustrwm2, _EPS)
        Cmu = jnp.sqrt(1.0 + 2.0 * rmu * cosphiwc + rmu * rmu)  # Eq 27
    zoa = dwc * (dwc / zo) ** (-jnp.sqrt(
        rmu / (1.0 + rmu)))                                # Eq 11
    ustrwm = jnp.sqrt(ustrwm2)
    return ustrc, ustrwm, ustrr, zoa


def ripple_geometry(p: BBLParams, Ab, tstar, rheight, rlength):
    """Wiberg-Harris ripple predictor, Malarkey & Davies (2003)
    explicit form (ssw_bbl.h:450-480).  Keeps relict geometry where
    the bed is not in motion (tstar < 1)."""
    a1, a2, a3 = 0.095, 0.442, 2.280
    b1 = 1.0 / a1
    b2 = 0.5 * (1.0 + a2) * b1
    b3 = b2 ** 2 - a3 * b1
    d50 = p.d50
    d0 = 2.0 * Ab
    dolam1 = d0 / (535.0 * d50)
    doeta1 = jnp.exp(b2 - jnp.sqrt(jnp.maximum(
        b3 - b1 * jnp.log(jnp.maximum(dolam1, _EPS)), 0.0)))
    lam_ratio = -jnp.log(0.62 * d0 / (535.0 * d50)) * \
        jnp.log(0.01 * doeta1) / jnp.log(5.0)
    dolam = jnp.where(doeta1 < 20.0, 1.0 / 0.62,
                      jnp.where(doeta1 > 100.0, dolam1,
                                dolam1 * jnp.exp(-lam_ratio)))
    doeta2 = jnp.exp(b2 - jnp.sqrt(jnp.maximum(
        b3 - b1 * jnp.log(jnp.maximum(dolam, _EPS)), 0.0)))
    rh_new = jnp.where(d0 / d50 > 13000.0, 0.0, d0 / doeta2)
    rl_new = jnp.where(d0 / d50 > 13000.0, 535.0 * d50, d0 / dolam)
    moving = tstar >= 1.0
    return (jnp.where(moving, rh_new, rheight),
            jnp.where(moving, rl_new, rlength))


def bblm(cfg: Config, grid, p: BBLParams, u, v, z_r, z_w,
         Hwave, Pwave, Dwave, rheight, rlength, tau_cw_prev):
    """One SSW bottom-boundary-layer evaluation.

    u, v: 3-D velocities at nrhs; Hwave/Pwave/Dwave: significant wave
    height (m), bottom wave period (s), wave direction (rad) at rho
    points; rheight/rlength: ripple geometry from the previous step;
    tau_cw_prev: previous max combined stress (for the Shields motion
    criterion, like the reference's load from SEDBED).

    Returns (bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength).
    """
    Zr = jnp.maximum(z_r[0] - z_w[0], 1.0e-3)
    Ur = u[0]
    Vr = v[0]

    Fwave = 2.0 * jnp.pi / jnp.maximum(Pwave, 0.05)
    # clamp depth: WET_DRY grids carry h<=0 on the dry beach, where the
    # Pade kh expansion is undefined (stresses there are masked anyway)
    Kbh = wave_number_kh(jnp.maximum(grid.h, 0.01), Fwave)
    Ab = 0.5 * Hwave / jnp.maximum(jnp.sinh(Kbh), _EPS) + _EPS
    Ub = Fwave * Ab + _EPS

    Ucur = 0.5 * (Ur + ip1(Ur))
    Vcur = 0.5 * (Vr + jp1(Vr))
    Umag = jnp.sqrt(Ucur * Ucur + Vcur * Vcur + _EPS)
    phic = jnp.arctan2(Vcur, Ucur)
    angler = getattr(grid, "angler", None)
    angler = jnp.zeros_like(Umag) if angler is None else angler
    phicw = 1.5 * jnp.pi - Dwave - phic - angler

    # --- moveable-bed roughness (ssw_bbl.h:420-495) ---
    zoMAX = 0.9 * Zr
    zoMIN = jnp.maximum(5.0e-5, 2.5 * p.d50 / 30.0)
    zoN = jnp.clip(2.5 * p.d50 / 30.0 * jnp.ones_like(Umag),
                   zoMIN, zoMAX)
    if p.calc_znot:
        tstar = tau_cw_prev / (p.tau_ce + _EPS)
        # Wiberg-Rubin (1989) saltation roughness (d50 in cm inside)
        logd = jnp.log(100.0 * p.d50)
        coef_st = 0.0204 * logd ** 2 + 0.0220 * logd + 0.0709
        zoST = jnp.where(tstar >= 1.0,
                         0.056 * p.d50 * 0.68 * tstar /
                         (1.0 + coef_st * tstar), 0.0)
        rheight, rlength = ripple_geometry(p, Ab, tstar, rheight,
                                           rlength)
        zoBF = p.ar * rheight ** 2 / jnp.maximum(rlength, _EPS)
        zo = zoN + zoST + zoBF
    else:
        zo = jnp.maximum(p.zob, 5.0e-5) * jnp.ones_like(Umag)
    zo = jnp.clip(zo, zoMIN, zoMAX)

    # --- stresses (ssw_bbl.h:500-560 + madsen94) ---
    cff1 = _VONKAR / jnp.log(Zr / zo)
    Cd = jnp.clip(cff1 * cff1, p.cdb_min, p.cdb_max)
    tau_c_cur = Cd * Umag * Umag                    # pure currents

    abokb = Ab / (30.0 * zo)
    fwm = jnp.where(
        (abokb > 0.2) & (abokb <= 100.0),
        jnp.exp(-8.82 + 7.02 * jnp.maximum(abokb, 0.2) ** (-0.078)),
        jnp.where(abokb > 100.0,
                  jnp.exp(-7.30 + 5.61 * jnp.maximum(abokb, 1.0) **
                          (-0.109)), 0.3))
    tau_w_pure = 0.5 * fwm * Ub * Ub                # pure waves

    m_ustrc, m_ustrwm, m_ustrr, m_zoa = madsen94(
        Ub, Fwave, Umag, Zr, phicw, 30.0 * zo)

    eps_u = 1.0e-10
    waves = Ub > 10.0 * eps_u
    currents = Umag > 1.0e-6
    both = waves & currents & (Zr > zo)
    tau_c = jnp.where(both, m_ustrc ** 2,
                      jnp.where(currents, tau_c_cur, 0.0))
    tau_w = jnp.where(both, m_ustrwm ** 2,
                      jnp.where(waves, tau_w_pure, 0.0))
    tau_cwmax = jnp.where(
        both, m_ustrr ** 2,
        jnp.where(currents, tau_c_cur, tau_w_pure))

    # --- kinematic stress components (ssw_bbl.h:668-720) ---
    anglec_u = Ur / jnp.maximum(at_u(Umag), _EPS)
    bustr = at_u(tau_c) * anglec_u * grid.umask
    anglec_v = Vr / jnp.maximum(at_v(Umag), _EPS)
    bvstr = at_v(tau_c) * anglec_v * grid.vmask
    bustr, bvstr = _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr)

    return bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength


# =====================================================================
# MB_BBL: Meinte Blaas / Soulsby (1995) wave-current bottom boundary
# layer (ROMS/Nonlinear/mb_bbl.h)
# =====================================================================

@dataclass(frozen=True)
class MBBBLParams:
    """mb_bbl.h parameters (MB_CALC_UB + MB_Z0BL + MB_Z0RIP + MB_Z0BIO
    + MB_CALC_ZNOT variant, the full moveable-bed configuration)."""
    d50: float = 0.00015          # median grain size (m)
    srho: float = 2650.0          # sediment density (kg/m3)
    tau_ce: float = 0.05 / 1025.0  # critical stress (m2/s2)
    zob: float = 0.0001           # background roughness (m)
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    z0bl: bool = True             # MB_Z0BL bedload roughness
    z0rip: bool = True            # MB_Z0RIP ripple roughness
    z0bio: bool = False           # MB_Z0BIO biogenic roughness
    calc_znot: bool = True        # MB_CALC_ZNOT


def _soulsby_tauw(znot, Fwave, Ub):
    """Soulsby (1995) pure-wave stress tau_w = scf1*(z0*w)^scf2 *
    Ub^(2-scf2) (mb_bbl.h:150-157 scf constants)."""
    scf1 = 0.5 * 1.39
    scf2 = 0.52
    return scf1 * (znot * Fwave) ** scf2 * Ub ** (2.0 - scf2)


def _soulsby_taucw(tau_c, tau_w):
    """Soulsby (1995) mean combined stress enhancement
    (mb_bbl.h:245-247): tau_cw = tau_c*(1+1.2*(tw/(tw+tc))^3.2)."""
    return tau_c * (1.0 + 1.2 * (tau_w /
                                 (tau_w + tau_c + _EPS)) ** 3.2)


def bblm_mb(cfg: Config, grid, p: MBBBLParams, u, v, z_r, z_w, rho,
            Hwave, Pwave, Dwave, rheight, rlength):
    """One MB (Blaas/Soulsby) bottom-boundary-layer evaluation
    (mb_bbl.h:183-420).  Elementwise on rho points; the reference's
    IF/ELSE regime ladder becomes nested where-masks.

    rho: in-situ density anomaly at the bottom cell (rho[0]).
    Returns (bustr, bvstr, tau_c(=tau_cw), tau_w, tau_cwmax, rheight,
    rlength) - the same surface as bblm (SSW)."""
    vonKar = _VONKAR
    pi = jnp.pi
    Zr = jnp.maximum(z_r[0] - z_w[0], 1.0e-3)
    Ur = u[0]
    Vr = v[0]
    rho_w = rho + 1000.0
    viscosity = 0.0013 / rho_w            # kinematic (mb_bbl.h:205)
    rhoSed = p.srho / rho_w               # nondimensional

    Fwave = 2.0 * pi / jnp.maximum(Pwave, 0.05)
    # Dean & Dalrymple explicit dispersion (MB_BBL_CALC_UB)
    # clamp depth: WET_DRY grids carry h<=0 on the dry beach, where the
    # Pade kh expansion is undefined (stresses there are masked anyway)
    Kbh = wave_number_kh(jnp.maximum(grid.h, 0.01), Fwave)
    Ab = 0.5 * Hwave / jnp.maximum(jnp.sinh(Kbh), _EPS) + _EPS
    Ub = Fwave * Ab

    Ucur = 0.5 * (Ur + ip1(Ur))
    Vcur = 0.5 * (Vr + jp1(Vr))
    Umag = jnp.sqrt(Ucur * Ucur + Vcur * Vcur) + _EPS
    phiC = jnp.arctan2(Vcur, Ucur)
    angler = getattr(grid, "angler", None)
    angler = jnp.zeros_like(Umag) if angler is None else angler
    phiCW = 1.5 * pi - Dwave - phiC - angler

    d50 = p.d50
    tau_cb = p.tau_ce
    # bedload/suspension regime thresholds (mb_bbl.h:214-218)
    tau_up = 0.172 * (rhoSed - 1.0) * C.g * d50 ** 0.624
    tau_bf = 0.79 * viscosity ** (-0.6) * \
        ((rhoSed - 1.0) * C.g) ** 0.3 * d50 ** 0.9 * tau_cb

    ZnotC0 = d50 / 12.0                   # Nikuradse skin roughness
    Znot = jnp.maximum(p.zob, ZnotC0)

    # pure-current stresses with total and skin roughness
    cff1 = vonKar / jnp.log(Zr / Znot)
    tauC = jnp.clip(cff1 * cff1, p.cdb_min, p.cdb_max) * Umag * Umag
    cff1s = vonKar / jnp.log(Zr / ZnotC0)
    tau_cs = cff1s * cff1s * Umag * Umag

    # --- wave-dominated branch (Ub > 1 cm/s; mb_bbl.h:240-330) ---
    tau_w_skin = _soulsby_tauw(ZnotC0, Fwave, Ub)
    tau_cw_skin = _soulsby_taucw(tau_cs, tau_w_skin)
    tau_cws = jnp.sqrt(
        (tau_cw_skin + tau_w_skin * jnp.cos(phiCW)) ** 2 +
        (tau_w_skin * jnp.sin(phiCW)) ** 2)
    tauCWmax = tau_cws
    tauW = tau_w_skin

    ZnotC = ZnotC0 * jnp.ones_like(Umag)
    if p.z0bl and p.calc_znot:
        # bedload saltation roughness (mb_bbl.h:260-266)
        tau_ex = jnp.maximum(tau_cws - tau_cb, 0.0)
        cffz = 1.0 / ((rhoSed - 1.0) * C.g * d50)
        ZnotC = ZnotC + 17.4 * d50 * (cffz * tau_ex) ** 0.75
    if p.z0bl:
        cff1b = vonKar / jnp.log(Zr / ZnotC)
        tau_c_bl = cff1b * cff1b * Umag * Umag
        tau_wb = _soulsby_tauw(ZnotC, Fwave, Ub)
        tau_cw_bl = _soulsby_taucw(tau_c_bl, tau_wb)
        tau_cwb = jnp.sqrt(
            (tau_cw_bl + tau_wb * jnp.cos(phiCW)) ** 2 +
            (tau_wb * jnp.sin(phiCW)) ** 2)
        tauCWmax = tau_cwb
        tauW = tau_wb
    else:
        tau_cwb = tau_cws

    rhgt, rlen = rheight, rlength
    if p.z0rip:
        # ripple regime ladder (mb_bbl.h:268-300), sandy beds only
        RHmin, RLmin = 0.001, 0.01
        RHmax = 0.8 * rlen / pi
        rhgt_c = jnp.clip(rhgt, RHmin, jnp.maximum(RHmax, RHmin))
        tau_en = jnp.maximum(
            tau_cws, tau_cws * (rlen / jnp.maximum(rlen - pi * rhgt_c,
                                                   _EPS)) ** 2)
        # regimes (in reference priority order)
        local_tr = (tau_cws < tau_cb) & (tau_en >= tau_cb)
        rh1 = (19.6 * jnp.sqrt(tau_cws / tau_cb) + 20.9) * d50
        bedload = (tau_cws >= tau_cb) & (tau_cwb < tau_bf)
        rh2 = (22.15 * jnp.sqrt(tau_cwb / tau_cb) + 6.38) * d50
        breakoff = (tau_cwb >= tau_bf) & (tau_cwb < tau_up)
        rl3 = 535.0 * d50
        rh3 = 0.15 * rl3 * (jnp.sqrt(tau_up) - jnp.sqrt(tau_cwb)) / \
            jnp.maximum(jnp.sqrt(tau_up) - jnp.sqrt(tau_bf), _EPS)
        sheet = tau_cwb >= tau_up
        rhgt_new = jnp.where(
            local_tr, rh1,
            jnp.where(bedload, rh2,
                      jnp.where(breakoff, rh3,
                                jnp.where(sheet, 0.0, rhgt))))
        rlen_new = jnp.where(
            local_tr, rh1 / 0.12,
            jnp.where(bedload, rh2 / 0.12,
                      jnp.where(breakoff, rl3,
                                jnp.where(sheet, 0.0, rlen))))
        sandy = d50 >= 0.000063
        if sandy:                       # d50 is a python float
            rhgt, rlen = rhgt_new, rlen_new
    if p.z0bio and d50 < 0.000063:
        # biogenic roughness for muddy beds (mb_bbl.h:302-311)
        RLbio = 0.1
        thetw = tau_cws / ((rhoSed - 1.0) * C.g * d50)
        RHbio = thetw ** (-1.67) * RLbio / jnp.exp(4.11)
        rhgt = jnp.minimum(RHbio, 0.006)
        rlen = RLbio * jnp.ones_like(rhgt)

    if (p.z0rip or p.z0bio) and p.calc_znot:
        ZnotC = ZnotC + 0.92 * rhgt * rhgt / jnp.maximum(rlen, 0.01)
    if p.z0rip or p.z0bio:
        cff1r = vonKar / jnp.log(Zr / ZnotC)
        tau_cr = cff1r * cff1r * Umag * Umag
        tau_wr = _soulsby_tauw(ZnotC, Fwave, Ub)
        tauCW_wave = _soulsby_taucw(tau_cr, tau_wr)
        tauW_wave = tau_wr
    else:
        tauCW_wave = _soulsby_taucw(tauC, _soulsby_tauw(Znot, Fwave,
                                                        Ub))
        tauW_wave = tauW

    # --- current-only branch (Ub <= 1 cm/s; mb_bbl.h:332-356) ---
    ZnotC_c = ZnotC0 * jnp.ones_like(Umag)
    rh_c, rl_c = rhgt, rlen
    if p.z0rip:
        sheet_c = tau_cs > tau_up
        relict = tau_cs < tau_cb
        rl_y = 1000.0 * d50                       # Yalin (1964)
        rh_y = 0.0308 * rl_y ** 1.19
        rh_c = jnp.where(sheet_c, 0.0,
                         jnp.where(relict, rheight, rh_y))
        rl_c = jnp.where(sheet_c, 0.0,
                         jnp.where(relict, rlength, rl_y))
        if p.calc_znot:
            ZnotC_c = ZnotC_c + 0.92 * rh_c * rh_c / \
                jnp.maximum(rl_c, 0.01)
    cff1c = vonKar / jnp.log(Zr / ZnotC_c)
    tauCW_cur = jnp.clip(cff1c * cff1c, p.cdb_min, p.cdb_max) * \
        Umag * Umag

    wave = Ub > 0.01
    tauCW = jnp.where(wave, tauCW_wave, tauCW_cur)
    tauW_o = jnp.where(wave, tauW_wave, 0.0)
    tauCWmax = jnp.where(wave, tauCWmax, tauC)
    rheight = jnp.where(wave, rhgt, rh_c)
    rlength = jnp.where(wave, rlen, rl_c)

    # stress components at u/v points (mb_bbl.h:360-380)
    anglec_u = Ur / jnp.maximum(at_u(Umag), _EPS)
    bustr = at_u(tauCW) * anglec_u * grid.umask
    anglec_v = Vr / jnp.maximum(at_v(Umag), _EPS)
    bvstr = at_v(tauCW) * anglec_v * grid.vmask
    bustr, bvstr = _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr)
    return bustr, bvstr, tauCW, tauW_o, tauCWmax, rheight, rlength


# =====================================================================
# SG_BBL: Styles & Glenn (1999/2000) wave-current bottom boundary
# layer (ROMS/Nonlinear/sg_bbl.h)
# =====================================================================

@dataclass(frozen=True)
class SGBBLParams:
    """sg_bbl.h parameters (SG_CALC_UB + SG_CALC_ZNOT variant) and the
    mod_scalars.F:1450-1468 closure constants."""
    d50: float = 0.00015
    srho: float = 2650.0
    zob: float = 0.0001
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    calc_znot: bool = True        # SG_CALC_ZNOT moveable bed roughness
    alpha: float = 1.0            # sg_alpha (constant-stress layer)
    nu: float = 1.19e-6           # sg_nu kinematic viscosity
    n_iter: int = 20              # sg_n


_SG_Z1P = 1.0                     # sg_z1p = sg_alpha
_SG_MP = complex((0.5 / _SG_Z1P) ** 0.5, (0.5 / _SG_Z1P) ** 0.5)


def _kelvin8m(x):
    """Kelvin functions ber/bei/ker/kei and derivatives for x <= 8
    (sg_bbl.h sg_kelvin8m; Abramowitz & Stegun 9.11 polynomials)."""
    c = 0.125 * x
    xp = [c]
    for _ in range(27):
        xp.append(xp[-1] * c)
    p = lambda k: xp[k - 1]
    xhalf = 0.5 * x
    lx = jnp.log(jnp.maximum(xhalf, 1e-30))
    ber = (1.0 - 64.0 * p(4) + 113.77777774 * p(8) -
           32.36345652 * p(12) + 2.64191397 * p(16) -
           0.08349609 * p(20) + 0.00122552 * p(24) -
           0.00000901 * p(28))
    bei = (16.0 * p(2) - 113.77777774 * p(6) + 72.81777742 * p(10) -
           10.56765779 * p(14) + 0.52185615 * p(18) -
           0.01103667 * p(22) + 0.00011346 * p(26))
    ker = (-ber * lx + 0.25 * jnp.pi * bei - 0.57721566 -
           59.05819744 * p(4) + 171.36272133 * p(8) -
           60.60977451 * p(12) + 5.65539121 * p(16) -
           0.19636347 * p(20) + 0.00309699 * p(24) -
           0.00002458 * p(28))
    kei = (-bei * lx - 0.25 * jnp.pi * ber + 6.76454936 * p(2) -
           142.91827687 * p(6) + 124.23569650 * p(10) -
           21.30060904 * p(14) + 1.17509064 * p(18) -
           0.02695875 * p(22) + 0.00029532 * p(26))
    berp = x * (-4.0 * p(2) + 14.22222222 * p(6) - 6.06814810 * p(10) +
                0.66047849 * p(14) - 0.02609253 * p(18) +
                0.00045957 * p(22) - 0.00000394 * p(26))
    beip = x * (0.5 - 10.66666666 * p(4) + 11.37777772 * p(8) -
                2.31167514 * p(12) + 0.14677204 * p(16) -
                0.00379386 * p(20) + 0.00004609 * p(24))
    ox = 1.0 / jnp.maximum(x, 1e-30)
    kerp = (-berp * lx - ber * ox + 0.25 * jnp.pi * beip +
            x * (-3.69113734 * p(2) + 21.42034017 * p(6) -
                 11.36433272 * p(10) + 1.41384780 * p(14) -
                 0.06136358 * p(18) + 0.00116137 * p(22) -
                 0.00001075 * p(26)))
    keip = (-beip * lx - bei * ox - 0.25 * jnp.pi * berp +
            x * (0.21139217 - 13.39858846 * p(4) + 19.41182758 * p(8) -
                 4.65950823 * p(12) + 0.33049424 * p(16) -
                 0.00926707 * p(20) + 0.00011997 * p(24)))
    return ber, bei, ker, kei, berp, beip, kerp, keip


def _kelvin8p(x):
    """Kelvin functions for x > 8 (sg_bbl.h sg_kelvin8p asymptotics)."""
    c = 8.0 / jnp.maximum(x, 1e-30)
    xps = [c]
    xms = [-c]
    for _ in range(5):
        xps.append(xps[-1] * c)
        xms.append(-xms[-1] * c)
    TH = (complex(0.0, -0.3926991), complex(0.0110486, -0.0110485),
          complex(0.0, -0.0009765), complex(-0.0000906, -0.0000901),
          complex(-0.0000252, 0.0), complex(-0.0000034, 0.0000051),
          complex(0.0000006, 0.0000019))
    PH = (complex(0.7071068, 0.7071068), complex(-0.0625001, -1e-7),
          complex(-0.0013813, 0.0013811), complex(0.0000005, 0.0002452),
          complex(0.0000346, 0.0000338), complex(0.0000117, -0.0000024),
          complex(0.0000016, -0.0000032))

    def series(coefs, xs):
        out = coefs[0] * jnp.ones_like(x) * (1.0 + 0j)
        for k in range(6):
            out = out + coefs[k + 1] * xs[k]
        return out

    thetap = series(TH, xps)
    thetam = series(TH, xms)
    phip = series(PH, xps)
    phim = series(PH, xms)
    cf = x / jnp.sqrt(2.0)
    one_i = 1.0 + 1.0j
    fofx = jnp.sqrt(jnp.pi / (2.0 * x)) * jnp.exp(-cf * one_i + thetam)
    gofx = 1.0 / jnp.sqrt(2.0 * jnp.pi * x) * jnp.exp(cf * one_i +
                                                      thetap)
    ker = fofx.real
    kei = fofx.imag
    ber = gofx.real - kei / jnp.pi
    bei = gofx.imag + ker / jnp.pi
    kerp = (-fofx * phim).real
    keip = (-fofx * phim).imag
    berp = (gofx * phip).real - keip / jnp.pi
    beip = (gofx * phip).imag + kerp / jnp.pi
    return ber, bei, ker, kei, berp, beip, kerp, keip


def _sg_phi(ubo, row):
    """|gamma| of the Styles-Glenn similarity solution at ub/u*cw = ubo
    (the Kelvin-function block shared by sg_bstress/sg_purewave)."""
    ro = row / jnp.maximum(ubo, _EPS)
    znotp = 1.0 / (_VONKAR * jnp.maximum(ro, _EPS))

    def argi_at(zp):
        x = 2.0 * jnp.sqrt(zp)
        km = _kelvin8m(jnp.minimum(x, 8.0))
        kp = _kelvin8p(jnp.maximum(x, 8.0))
        sel = lambda a, b: jnp.where(x <= 8.0, a, b)
        ber, bei, ker, kei, berp, beip, kerp, keip = \
            (sel(a, b) for a, b in zip(km, kp))
        cff = 1.0 / jnp.sqrt(zp)
        return ((ber + 1j * bei), (ker + 1j * kei),
                (berp + 1j * beip) * cff, (kerp + 1j * keip) * cff)

    bnot, knot, bnotp, knotp = argi_at(znotp)
    b1, k1, b1p, k1p = argi_at(jnp.full_like(znotp, _SG_Z1P))
    ll = _SG_MP * b1 + b1p
    nn = _SG_MP * k1 + k1p
    den1 = bnot * nn - knot * ll
    argi = bnotp * nn / jnp.where(jnp.abs(den1) > 0, den1, 1.0) + \
        knotp * ll / jnp.where(jnp.abs(den1) > 0, -den1, 1.0)
    gam_kelvin = jnp.abs(-_VONKAR * znotp * argi)
    gam_thin = jnp.abs(-_VONKAR * _SG_Z1P * _SG_MP) * \
        jnp.ones_like(znotp)
    return jnp.where(_SG_Z1P / znotp > 1.0, gam_kelvin, gam_thin)


def _sg_mu_eps_fofx(ubouc, row, zrozn, phicw, ubokur):
    """mu, epsilon and the bisection residual f(ubouc) (sg_bstress)."""
    phi = _sg_phi(ubouc, row)
    ubouc = jnp.minimum(ubouc, 1.0 / phi)     # monotone clamp loop
    for _ in range(4):
        phi = _sg_phi(ubouc, row)
        ubouc = jnp.minimum(ubouc, 1.0 / phi)
    mu = jnp.sqrt(ubouc * phi)
    mu2 = mu * mu
    cosphi = jnp.abs(jnp.cos(phicw))
    eps2 = -mu2 * cosphi + jnp.sqrt(jnp.maximum(
        1.0 + mu2 * mu2 * (cosphi * cosphi - 1.0), 0.0))
    epsilon = jnp.where(mu >= 1.0, 0.0, jnp.sqrt(jnp.maximum(eps2,
                                                             0.0)))
    ro = row / jnp.maximum(ubouc, _EPS)
    ror = ro / zrozn
    z1ozn = _VONKAR * ro                       # sg_alpha=1
    zroz1 = 1.0 / jnp.maximum(_VONKAR * ror, _EPS)
    zroz2 = epsilon * zroz1
    z2ozn = z1ozn / jnp.maximum(epsilon, _EPS)
    lz = lambda a: jnp.log(jnp.maximum(a, _EPS))
    # the 7-branch matching ladder (sg_bbl.h sg_bstress:fofx)
    f1 = ubokur * epsilon * (lz(zroz2) + 1.0 - epsilon +
                             epsilon * lz(z1ozn))
    f2 = ubokur * epsilon * epsilon * (zroz1 - 1.0 + lz(z1ozn))
    f3 = ubokur * epsilon * epsilon * lz(zrozn)
    f4 = ubokur * epsilon * (lz(zroz2) + 1.0 - 1.0 / z2ozn)
    f5 = ubokur * epsilon * epsilon * (zroz1 - 1.0 / z1ozn)
    f6 = ubokur * epsilon * lz(zrozn)
    fof = jnp.where(
        (zroz2 > 1.0) & (z1ozn > 1.0), f1,
        jnp.where((zroz2 <= 1.0) & (zroz1 > 1.0) & (z1ozn > 1.0), f2,
        jnp.where((zroz1 <= 1.0) & (z1ozn > 1.0), f3,
        jnp.where((zroz2 > 1.0) & (z1ozn <= 1.0) & (z2ozn > 1.0), f4,
        jnp.where((zroz2 <= 1.0) & (zroz1 > 1.0) & (z1ozn <= 1.0) &
                  (z2ozn > 1.0), f5,
        jnp.where((zroz2 > 1.0) & (z2ozn <= 1.0), f6, 0.0))))))
    return mu, epsilon, -ubouc + fof, ubouc


def bblm_sg(cfg: Config, grid, p: SGBBLParams, u, v, z_r, z_w, rho,
            Hwave, Pwave, Dwave):
    """One SG (Styles & Glenn 1999) bottom-boundary-layer evaluation
    (sg_bbl.h:183-470): wave friction from the Kelvin-function
    similarity solution, bisection for ub/u*cw, Shields-criterion
    moveable-bed roughness (Wiberg-Harris ripples + sheet-flow kbs).

    Returns (bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength)
    - the same surface as bblm/bblm_mb."""
    vonKar = _VONKAR
    Zr = jnp.maximum(z_r[0] - z_w[0], 1.0e-3)
    Ur = u[0]
    Vr = v[0]
    rho_w = rho + 1000.0
    ss = p.srho / rho_w

    Fwave = 2.0 * jnp.pi / jnp.maximum(Pwave, 0.05)
    # clamp depth: WET_DRY grids carry h<=0 on the dry beach, where the
    # Pade kh expansion is undefined (stresses there are masked anyway)
    Kbh = wave_number_kh(jnp.maximum(grid.h, 0.01), Fwave)
    Ab = 0.5 * Hwave / jnp.maximum(jnp.sinh(Kbh), _EPS) + _EPS
    Ub = Fwave * Ab + _EPS

    Ucur = 0.5 * (Ur + ip1(Ur))
    Vcur = 0.5 * (Vr + jp1(Vr))
    Umag = jnp.sqrt(Ucur * Ucur + Vcur * Vcur) + _EPS
    phic = jnp.arctan2(Vcur, Ucur)
    angler = getattr(grid, "angler", None)
    angler = jnp.zeros_like(Umag) if angler is None else angler
    phicw = 1.5 * jnp.pi - Dwave - phic - angler

    # pure-current log-law stress with the default roughness
    cff1 = vonKar / jnp.log(Zr / p.zob)
    TauC0 = jnp.clip(cff1 * cff1, p.cdb_min, p.cdb_max) * Umag * Umag

    # --- moveable-bed roughness (SG_CALC_ZNOT; sg_bbl.h:268-330) ---
    d50 = p.d50
    if p.calc_znot:
        star = d50 / (4.0 * p.nu) * jnp.sqrt((ss - 1.0) * C.g * d50)
        shldcr = jnp.where(
            star <= 1.5, 0.0932 * star ** (-0.707),
            jnp.where(star < 4.0, 0.0848 * star ** (-0.473),
            jnp.where(star < 10.0, 0.0680 * star ** (-0.314),
            jnp.where(star < 34.0, 0.033,
            jnp.where(star < 270.0, 0.0134 * star ** 0.255, 0.056)))))
        abokb_d = Ab / d50
        fwm0 = jnp.where(abokb_d <= 100.0,
                         jnp.exp(7.02 * jnp.maximum(abokb_d, 0.1) **
                                 (-0.078) - 8.82),
                         jnp.exp(5.61 * abokb_d ** (-0.109) - 7.30))
        ustarwm0 = jnp.sqrt(0.5 * fwm0) * Ub
        shld = ustarwm0 ** 2 / ((ss - 1.0) * d50 * C.g)
        chi = 4.0 * p.nu * Ub * Ub / (d50 * ((ss - 1.0) * C.g * d50)
                                      ** 1.5)
        eta_m = jnp.where(chi <= 2.0, Ab * 0.30 * chi ** (-0.39),
                          Ab * 0.45 * chi ** (-0.99))
        lam_m = jnp.where(chi <= 2.0, Ab * 1.96 * chi ** (-0.28),
                          Ab * 2.71 * chi ** (-0.75))
        kbs = Ab * 0.0655 * (Ub * Ub / ((ss - 1.0) * C.g * Ab)) ** 1.4
        znot_mb = (d50 + 2.3 * eta_m + kbs) / 30.0
        moving = shld / shldcr > 1.0
        znot = jnp.where(moving, znot_mb, p.zob)
        rheight = jnp.where(moving, eta_m, 0.0)
        rlength = jnp.where(moving, lam_m, 0.0)
    else:
        znot = p.zob * jnp.ones_like(Umag)
        chi = 4.0 * p.nu * Ub * Ub / (d50 * ((ss - 1.0) * C.g * d50)
                                      ** 1.5)
        rheight = jnp.where(chi <= 2.0, Ab * 0.32 * chi ** (-0.34),
                            Ab * 0.52 * chi ** (-1.01))
        rlength = jnp.where(chi <= 2.0, Ab * 2.04 * chi ** (-0.23),
                            Ab * 2.7 * chi ** (-0.78))

    # --- wave-current solution (sg_bstress bisection) ---
    row = Ab / znot
    zrozn = Zr / znot
    ubokur = Ub / (vonKar * Umag)
    # pure-wave upper bound via sg_purewave fixed point
    abokb = Ab / (30.0 * znot)
    fwm = jnp.where(abokb <= 100.0,
                    jnp.exp(-8.82 + 7.02 *
                            jnp.maximum(abokb, 0.1) ** (-0.078)),
                    jnp.exp(-7.30 + 5.61 * abokb ** (-0.109)))
    ubouwm = jnp.sqrt(2.0 / fwm)
    for _ in range(p.n_iter):
        ubouwm = 1.0 / _sg_phi(ubouwm, row)

    a1 = jnp.full_like(Umag, 1.0e-6)
    b1 = ubouwm
    _, _, fofa, _ = _sg_mu_eps_fofx(a1, row, zrozn, phicw, ubokur)
    fofb = -fofa
    c1 = 0.5 * (a1 + b1)
    for _ in range(p.n_iter):
        mu, epsilon, fofc, c1c = _sg_mu_eps_fofx(c1, row, zrozn, phicw,
                                                 ubokur)
        opposite = fofb * fofc < 0.0
        a1 = jnp.where(opposite, c1, a1)
        b1 = jnp.where(opposite, b1, c1)
        c1 = 0.5 * (a1 + b1)
    mu, epsilon, _, ubouc = _sg_mu_eps_fofx(c1, row, zrozn, phicw,
                                            ubokur)

    ustarcw = Ub / jnp.maximum(ubouc, _EPS)
    ustarwm = mu * ustarcw
    ustarc = jnp.maximum(jnp.sqrt(TauC0), epsilon * ustarcw)
    both = (Umag > 1e-6) & (Ub > 1e-4) & (zrozn > 1.0)
    TauC = jnp.where(both, ustarc * ustarc, TauC0)
    TauW = jnp.where(both, ustarwm * ustarwm, 0.5 * fwm * Ub * Ub)
    TauCWmax = jnp.where(
        both,
        jnp.sqrt((TauC + TauW * jnp.cos(phicw)) ** 2 +
                 (TauW * jnp.sin(phicw)) ** 2),
        jnp.maximum(TauC, TauW))

    anglec_u = Ur / jnp.maximum(at_u(Umag), _EPS)
    bustr = at_u(TauC) * anglec_u * grid.umask
    anglec_v = Vr / jnp.maximum(at_v(Umag), _EPS)
    bvstr = at_v(TauC) * anglec_v * grid.vmask
    bustr, bvstr = _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr)
    return bustr, bvstr, TauC, TauW, TauCWmax, rheight, rlength
