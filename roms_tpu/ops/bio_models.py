"""Additional ecosystem models: NPZD-Franks, NPZD-iron, Fennel BGC.

JAX re-implementations of the reference's biology.F plugins
(ROMS/Nonlinear/Biology/):

 * npzd_Franks.h  - classic Franks et al. (1986) NPZD
 * npzd_iron.h    - Powell NPZD + iron limitation (IRON_LIMIT/IRON_RELAX)
 * fennel.h       - Fennel et al. (2006) nitrogen-cycle BGC with
                    optional PO4, OXYGEN, CARBON (pCO2 air-sea flux),
                    DENITRIFICATION and BIO_SEDIMENT closures

All share the design of ops/biology.py: every conversion stage treats
the consumed compartment backward-implicitly (divide by 1+cff, add
cff*consumed to the consumer), so each stage conserves the total and
never produces negatives (fennel.h:645-682 documents the scheme); the
chained stages are pure elementwise ops on (N,Ny,Nx) fields that XLA
fuses into a handful of kernels.  Sinking reuses biology.ppm_sink (the
CFL-free PPM + WENO semi-Lagrangian reconstruction).

The surface CO2 system (pCO2_water, fennel.h:1938-2372) is solved with
a vectorized fixed-iteration bisection over the whole surface plane -
the branchless analog of the reference's bracket-and-bisection default
(DoNewton=0), bit-comparable after 50 halvings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp

from ..config import Config
from ..constants import rho0_default as rho0, Cp
from .biology import ppm_sink, _positive_definite, _MINVAL


# =====================================================================
# NPZD Franks (npzd_Franks.h)
# =====================================================================

@dataclass(frozen=True)
class FranksParams:
    """npzd_Franks.in defaults (External/npzd_Franks.in:49-106)."""
    BioIter: int = 1
    K_ext: float = 0.06    # 1/m light extinction
    K_NO3: float = 0.1     # mmol/m3 half-saturation
    K_Phy: float = 0.4     # mmol/m3 grazing half-saturation
    Vm_NO3: float = 2.0    # 1/day max uptake
    PhyMR: float = 0.05    # 1/day P mortality -> D
    ZooGR: float = 0.6     # 1/day max grazing
    ZooMR: float = 0.2     # 1/day Z mortality -> N
    ZooMD: float = 0.05    # 1/day Z mortality -> D
    ZooGA: float = 0.3     # grazing inefficiency -> D
    ZooEC: float = 0.15    # grazing excreted -> N
    DetRR: float = 0.1     # 1/day remineralization
    wDet: float = 5.0      # m/day detritus sinking


def npzd_franks(cfg: Config, p: FranksParams, t_old, t_new, Hz, z_w, z_r,
                srflx=None):
    """Franks NPZD conversions (npzd_Franks.h:316-380): Michaelis-Menten
    uptake with exponential light decay exp(K_ext*z_r), quadratic-
    saturation grazing, linear mortalities, remineralization, detritus
    sinking.  Increment from t_old added to t_new."""
    idb = cfg.ibio
    if len(idb) != 4:
        raise ValueError(f"npzd_franks needs 4 bio tracers, got {idb}")
    iN, iP, iZ, iD = 0, 1, 2, 3
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = jnp.stack([t_old[i] for i in idb])
    bio = _positive_definite(bio)
    bio_old = bio

    for _ in range(max(1, p.BioIter)):
        # nutrient uptake with light exp(K_ext*z_r) (npzd_Franks.h:316)
        cff = bio[iP] * dtd * p.Vm_NO3 * jnp.exp(p.K_ext * z_r) / \
            (p.K_NO3 + bio[iN])
        n_new = bio[iN] / (1.0 + cff)
        bio = bio.at[iN].set(n_new).at[iP].add(n_new * cff)

        # grazing (quadratic saturation) + P mortality, one implicit
        # stage (npzd_Franks.h:330-350)
        cff = bio[iZ] * bio[iP] * dtd * p.ZooGR / \
            (p.K_Phy * p.K_Phy + bio[iP] * bio[iP])
        cff2 = dtd * p.PhyMR
        p_new = bio[iP] / (1.0 + cff + cff2)
        bio = (bio.at[iP].set(p_new)
               .at[iZ].add(p_new * cff * (1.0 - p.ZooGA))
               .at[iD].add(p_new * (cff2 + cff * (p.ZooGA - p.ZooEC)))
               .at[iN].add(p_new * cff * p.ZooEC))

        # Z excretion -> N and mortality -> D (npzd_Franks.h:354-366)
        z_new = bio[iZ] / (1.0 + dtd * (p.ZooMR + p.ZooMD))
        bio = (bio.at[iZ].set(z_new)
               .at[iN].add(z_new * dtd * p.ZooMR)
               .at[iD].add(z_new * dtd * p.ZooMD))

        # remineralization (npzd_Franks.h:370-378)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio = bio.at[iD].set(d_new).at[iN].add(d_new * dtd * p.DetRR)

        # detritus sinking (idsink=(iSDet,), npzd_Franks.h:176-181)
        if p.wDet != 0.0:
            sunk, _ = ppm_sink(bio[iD], Hz, z_w, dtd * abs(p.wDet))
            bio = bio.at[iD].set(sunk)

    incr = bio - bio_old
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new


# =====================================================================
# NPZD iron (npzd_iron.h)
# =====================================================================

@dataclass(frozen=True)
class IronParams:
    """npzd_iron.in defaults (External/npzd_iron.in:49-120)."""
    BioIter: int = 1
    PARfrac: float = 0.43
    AttSW: float = 0.067
    AttPhy: float = 0.04
    PhyIS: float = 0.02
    Vm_NO3: float = 1.0
    PhyMRD: float = 0.1
    PhyMRN: float = 0.0
    K_NO3: float = 1.0
    Ivlev: float = 0.84
    ZooGR: float = 0.65
    ZooEED: float = 0.0
    ZooEEN: float = 0.3
    ZooMRD: float = 0.145
    ZooMRN: float = 0.0
    DetRR: float = 1.0
    wPhy: float = 0.0
    wDet: float = 8.0
    # iron (IRON_LIMIT)
    T_Fe: float = 1.0      # days, Fe uptake time scale
    A_Fe: float = 0.6      # Fe:C empirical exponent
    B_Fe: float = 64.0     # Fe:C empirical factor
    K_FeC: float = 16.9    # umol-Fe/mol-C half-saturation
    FeRR: float = 0.5      # Fe remineralization fraction
    # IRON_RELAX coastal source
    iron_relax: bool = False
    FeHmin: float = 200.0  # m, relax where h <= FeHmin
    FeNudgTime: float = 5.0   # days
    FeMax: float = 2.0     # mmol/m3 target
    const_par: Optional[float] = None


_FeN2FeC = (16.0 / 106.0) * 1.0e3     # umol-Fe/mmol-N -> umol-Fe/mol-C
_FeC2FeN = (106.0 / 16.0) * 1.0e-3


def npzd_iron(cfg: Config, p: IronParams, grid, t_old, t_new, Hz, z_w,
              srflx):
    """Powell NPZD with iron limitation (npzd_iron.h:330-612).  Six
    compartments: NO3, Phy, Zoo, SDet, Fdis, Fphy (cfg.ibio order)."""
    from .biology import _light, NPZDParams
    idb = cfg.ibio
    if len(idb) != 6:
        raise ValueError(f"npzd_iron needs 6 bio tracers, got {idb}")
    iN, iP, iZ, iD, iFd, iFp = 0, 1, 2, 3, 4, 5
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = jnp.stack([t_old[i] for i in idb])
    bio = _positive_definite(bio)

    # IRON_RELAX: coastal dissolved-iron source (npzd_iron.h:306-316);
    # applied before the reaction chain, included in the increment
    if p.iron_relax:
        coef = cfg.dt / (p.FeNudgTime * 86400.0)
        shallow = grid.h <= p.FeHmin
        bio = bio.at[iFd].add(
            jnp.where(shallow[None], coef * (p.FeMax - bio[iFd]), 0.0))
    bio_old = bio if not p.iron_relax else jnp.stack(
        [t_old[i] for i in idb])
    bio_old = _positive_definite(bio_old)

    if p.const_par is not None:
        par_sur = jnp.full_like(bio[0, 0], p.const_par)
    else:
        srf = srflx if srflx is not None else jnp.zeros_like(bio[0, 0])
        par_sur = p.PARfrac * srf * rho0 * Cp

    lp = NPZDParams(AttSW=p.AttSW, AttPhy=p.AttPhy)
    for _ in range(max(1, p.BioIter)):
        light = _light(lp, bio[iP], z_w, par_sur)

        # --- iron-limited uptake (npzd_iron.h:428-466) ---
        FNratio = bio[iFp] / jnp.maximum(_MINVAL, bio[iP])
        FCratio = FNratio * _FeN2FeC
        FCratioE = p.B_Fe * jnp.maximum(bio[iFd], 0.0) ** p.A_Fe
        Flimit = FCratio ** 2 / (FCratio ** 2 + p.K_FeC ** 2)
        Nlimit = 1.0 / (p.K_NO3 + bio[iN])
        FNlim = jnp.minimum(1.0, Flimit / jnp.maximum(
            _MINVAL, bio[iN] * Nlimit))
        cff4 = 1.0 / jnp.sqrt(p.Vm_NO3 ** 2 + p.PhyIS ** 2 * light ** 2)
        cff = bio[iP] * dtd * p.Vm_NO3 * p.PhyIS * cff4 * light * \
            FNlim * Nlimit
        n_new = bio[iN] / (1.0 + cff)
        bio = bio.at[iN].set(n_new).at[iP].add(n_new * cff)

        # iron uptake proportional to growth (npzd_iron.h:470-476)
        fac = cff * n_new * FNratio / jnp.maximum(_MINVAL, bio[iFd])
        fd_new = bio[iFd] / (1.0 + fac)
        bio = bio.at[iFd].set(fd_new).at[iFp].add(fd_new * fac)

        # relax Fe:C toward the empirical ratio (npzd_iron.h:478-492)
        cff5 = dtd * (FCratioE - FCratio) / p.T_Fe
        cff6 = bio[iP] * cff5 * _FeC2FeN
        cff_up = jnp.maximum(cff6, 0.0) / jnp.maximum(_MINVAL, bio[iFd])
        cff_dn = jnp.maximum(-cff6, 0.0) / jnp.maximum(_MINVAL, bio[iFp])
        fd1 = bio[iFd] / (1.0 + cff_up)
        fp1 = bio[iFp] + fd1 * cff_up
        fp2 = fp1 / (1.0 + cff_dn)
        fd2 = fd1 + fp2 * cff_dn
        bio = bio.at[iFd].set(fd2).at[iFp].set(fp2)

        # Ivlev grazing w/ sloppy feeding + Fe release (h:505-524)
        cff = bio[iZ] * dtd * p.ZooGR * \
            (1.0 - jnp.exp(-p.Ivlev * bio[iP])) / bio[iP]
        p_new = bio[iP] / (1.0 + cff)
        fp_new = bio[iFp] / (1.0 + cff)
        bio = (bio.at[iP].set(p_new)
               .at[iZ].add(p_new * (1.0 - p.ZooEEN - p.ZooEED) * cff)
               .at[iN].add(p_new * p.ZooEEN * cff)
               .at[iD].add(p_new * p.ZooEED * cff)
               .at[iFp].set(fp_new)
               .at[iFd].add(fp_new * cff * p.FeRR))

        # P mortality + Fe release (h:527-546)
        cffm = dtd * (p.PhyMRN + p.PhyMRD)
        p_new = bio[iP] / (1.0 + cffm)
        fp_new = bio[iFp] / (1.0 + cffm)
        bio = (bio.at[iP].set(p_new)
               .at[iN].add(p_new * dtd * p.PhyMRN)
               .at[iD].add(p_new * dtd * p.PhyMRD)
               .at[iFp].set(fp_new)
               .at[iFd].add(fp_new * cffm * p.FeRR))

        # Z mortality (h:548-562)
        z_new = bio[iZ] / (1.0 + dtd * (p.ZooMRN + p.ZooMRD))
        bio = (bio.at[iZ].set(z_new)
               .at[iN].add(z_new * dtd * p.ZooMRN)
               .at[iD].add(z_new * dtd * p.ZooMRD))

        # remineralization (h:564-574)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio = bio.at[iD].set(d_new).at[iN].add(d_new * dtd * p.DetRR)

        # sinking: Phy and SDet (npzd_iron.h:221-228)
        for (comp, w) in ((iP, p.wPhy), (iD, p.wDet)):
            if w != 0.0:
                sunk, _ = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))
                bio = bio.at[comp].set(sunk)

    incr = bio - bio_old
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new


# =====================================================================
# Fennel et al. (2006) biogeochemistry (fennel.h)
# =====================================================================

@dataclass(frozen=True)
class FennelParams:
    """bio_Fennel.in defaults (External/bio_Fennel.in:49-90)."""
    BioIter: int = 1
    AttSW: float = 0.04       # 1/m
    AttChl: float = 0.02486   # m2/mg_Chl
    PARfrac: float = 0.43
    Vp0: float = 1.0          # Eppley max growth factor
    I_thNH4: float = 0.0095   # W/m2 nitrification threshold
    D_p5NH4: float = 0.1      # W/m2 nitrification half-dose
    NitriR: float = 0.05      # 1/day
    K_NO3: float = 2.0        # 1/(mmol/m3) (inverse half-saturation!)
    K_NH4: float = 2.0        # 1/(mmol/m3)
    K_PO4: float = 32.0       # 1/(mmol/m3)
    K_Phy: float = 2.0        # (mmol/m3)^2
    Chl2C_m: float = 0.0535   # mg_Chl/mg_C max ratio
    ChlMin: float = 0.001
    PhyCN: float = 6.625      # mol_C/mol_N
    R_P2N: float = 0.0625     # mol_P/mol_N
    PhyIS: float = 0.025      # 1/(W/m2/day)
    PhyMin: float = 0.001
    PhyMR: float = 0.15       # 1/day
    ZooAE_N: float = 0.75     # assimilation efficiency
    ZooBM: float = 0.1        # 1/day basal metabolism
    ZooCN: float = 6.625
    ZooER: float = 0.1        # 1/day excretion
    ZooGR: float = 0.6        # 1/day grazing
    ZooMin: float = 0.001
    ZooMR: float = 0.025      # 1/day mortality
    LDeRRN: float = 0.01      # 1/day large-detritus N remin
    LDeRRC: float = 0.01
    CoagR: float = 0.005      # 1/day coagulation
    SDeRRN: float = 0.03
    SDeRRC: float = 0.03
    wPhy: float = 0.1         # m/day
    wLDet: float = 1.0
    wSDet: float = 0.1
    pCO2air: float = 370.0    # ppmv
    # option flags (CPP analogs)
    oxygen: bool = False      # OXYGEN
    carbon: bool = False      # CARBON (adds LDeC,SDeC,TIC,TAlk)
    po4: bool = False         # PO4
    denitrification: bool = False   # DENITRIFICATION
    bio_sediment: bool = True       # BIO_SEDIMENT (recommended)
    talk_nonconserv: bool = False   # TALK_NONCONSERV
    const_par: Optional[float] = None


# O2 Schmidt number (Wanninkhof 1992) and saturation (Garcia & Gordon
# 1992) coefficients; fennel.h:368-384
_A_O2, _B_O2, _C_O2, _D_O2, _E_O2 = 1953.4, 128.0, 3.9918, 0.050091, 0.0
_OA = (2.00907, 3.22014, 4.05010, 4.94457, -0.256847, 3.88767)
_OB = (-0.00624523, -0.00737614, -0.0103410, -0.00817083)
_OC0 = -0.000000488682
_rOxNO3 = 8.625           # 138/16, fennel.h:385
_rOxNH4 = 6.625           # 106/16
_l2mol = 1000.0 / 22.3916
# CO2 Schmidt (Wanninkhof 1992) + solubility (Weiss 1974); h:400-413
_A_CO2, _B_CO2, _C_CO2, _D_CO2, _E_CO2 = (2073.1, 125.62, 3.6276,
                                          0.043219, 0.0)
_CO2SOL = (-60.2409, 93.4517, 23.3585, 0.023517, -0.023656, 0.0047036)


def o2_saturation(temp, salt):
    """O2 saturation (mmol/m3), Garcia & Gordon (1992) (fennel.h:1128)."""
    ts = jnp.log((298.15 - temp) / (273.15 + temp))
    a0, a1, a2, a3, a4, a5 = _OA
    b0, b1, b2, b3 = _OB
    aa = a0 + ts * (a1 + ts * (a2 + ts * (a3 + ts * (a4 + ts * a5)))) + \
        salt * (b0 + ts * (b1 + ts * (b2 + ts * b3))) + \
        _OC0 * salt * salt
    return _l2mol * jnp.exp(aa)


def pco2_water(temp, salt, tic, talk, po4=0.0, sio3=0.0, iters=50):
    """Surface seawater pCO2 (ppmv): full carbonate system of
    fennel.h:1938-2372 (pCO2_water), solved by fixed-count vectorized
    bisection on total alkalinity balance (the DoNewton=0 default).

    Check value (fennel.h:1953-1956): T=24, S=36.6, TIC=2040,
    TAlk=2390, PO4=SiO3=0 -> pCO2 = 350.74945 ppmv."""
    Tk = temp + 273.15
    centiTk = 0.01 * Tk
    invTk = 1.0 / Tk
    logTk = jnp.log(Tk)
    sqrtS = jnp.sqrt(salt)
    SO4 = 19.924 * salt / (1000.0 - 1.005 * salt)
    sqrtSO4 = jnp.sqrt(SO4)
    scl = salt / 1.80655
    alk = talk * 1.0e-6
    dic = tic * 1.0e-6
    phos = po4 * 1.0e-6
    sili = sio3 * 1.0e-6

    ff = jnp.exp(-162.8301 + 218.2968 / centiTk + jnp.log(centiTk) *
                 90.9241 - centiTk * centiTk * 1.47696 +
                 salt * (0.025695 - centiTk * (0.025225 -
                                               centiTk * 0.0049867)))
    K1 = 10.0 ** (62.008 - invTk * 3670.7 - logTk * 9.7944 +
                  salt * (0.0118 - salt * 0.000116))
    K2 = 10.0 ** (-4.777 - invTk * 1394.7 + salt * (0.0184 -
                                                    salt * 0.000118))
    Kb = jnp.exp(-invTk * (8966.90 + sqrtS * (2890.53 + sqrtS * (
        77.942 - sqrtS * (1.728 - sqrtS * 0.0996)))) -
        logTk * (24.4344 + sqrtS * (25.085 + sqrtS * 0.2474)) +
        Tk * (sqrtS * 0.053105) + 148.0248 +
        sqrtS * (137.1942 + sqrtS * 1.62142))
    K1p = jnp.exp(115.525 - invTk * 4576.752 - logTk * 18.453 +
                  sqrtS * (0.69171 - invTk * 106.736) -
                  salt * (0.01844 + invTk * 0.65643))
    K2p = jnp.exp(172.0883 - invTk * 8814.715 - logTk * 27.927 +
                  sqrtS * (1.3566 - invTk * 160.340) -
                  salt * (0.05778 - invTk * 0.37335))
    K3p = jnp.exp(-18.141 - invTk * 3070.75 +
                  sqrtS * (2.81197 + invTk * 17.27039) -
                  salt * (0.09984 + invTk * 44.99486))
    Ksi = jnp.exp(117.385 - invTk * 8904.2 - logTk * 19.334 +
                  sqrtSO4 * (3.5913 - invTk * 458.79) -
                  SO4 * (1.5998 - invTk * 188.74 -
                         SO4 * (0.07871 - invTk * 12.1652)) +
                  jnp.log(1.0 - 0.001005 * salt))
    Kw = jnp.exp(148.9652 - invTk * 13847.26 - logTk * 23.6521 -
                 sqrtS * (5.977 - invTk * 118.67 - logTk * 1.0495) -
                 salt * 0.01615)
    Ks = jnp.exp(141.328 - invTk * 4276.1 - logTk * 23.093 +
                 sqrtSO4 * (324.57 - invTk * 13856.0 - logTk * 47.986 -
                            SO4 * invTk * 2698.0) -
                 SO4 * (771.54 - invTk * 35474.0 - logTk * 114.723 -
                        SO4 * invTk * 1776.0) +
                 jnp.log(1.0 - 0.001005 * salt))
    Kf = jnp.exp(-12.641 + invTk * 1590.2 + sqrtSO4 * 1.525 +
                 jnp.log(1.0 - 0.001005 * salt) +
                 jnp.log(1.0 + 0.1400 * scl / (96.062 * Ks)))
    borate = 0.000232 * scl / 10.811
    sulfate = 0.14 * scl / 96.062
    fluoride = 0.000067 * scl / 18.9984

    K12 = K1 * K2
    K12p = K1p * K2p
    K123p = K12p * K3p
    C = 1.0 / (1.0 + sulfate / Ks)

    def f_of_x(X):
        X2 = X * X
        X3 = X2 * X
        invX = 1.0 / X
        A = X * (K12p + X * (K1p + X)) + K123p
        B = X * (K1 + X) + K12
        return (dic * (K1 * X + 2.0 * K12) / B +
                borate / (1.0 + X / Kb) + Kw * invX +
                phos * (K12p * X + 2.0 * K123p - X3) / A +
                sili / (1.0 + X / Ksi) - X * C -
                sulfate / (1.0 + Ks * invX * C) -
                fluoride / (1.0 + Kf * invX) - alk)

    # bisection on [10^-10, 10^-5] (pH 10..5); f decreases with X
    x_lo = jnp.full_like(Tk, 1.0e-10)
    x_hi = jnp.full_like(Tk, 1.0e-5)
    f_hi = f_of_x(x_hi)
    for _ in range(iters):
        x_mid = 0.5 * (x_lo + x_hi)
        f_mid = f_of_x(x_mid)
        same = (f_hi * f_mid) > 0.0      # root in [lo, mid]
        x_hi = jnp.where(same, x_mid, x_hi)
        f_hi = jnp.where(same, f_mid, f_hi)
        x_lo = jnp.where(same, x_lo, x_mid)
    Ht = 0.5 * (x_lo + x_hi)
    CO2star = dic * Ht * Ht / (Ht * Ht + K1 * Ht + K12)
    return CO2star * 1.0e6 / ff, -jnp.log10(Ht)


def fennel(cfg: Config, p: FennelParams, grid, t_old, t_new, Hz, z_w,
           srflx, sustr=None, svstr=None, uwind=None, vwind=None):
    """Fennel et al. (2006) BGC source/sink terms (fennel.h:683-1575).

    cfg.ibio order: NO3, NH4, Chl, Phy, Zoo, LDeN, SDeN
    [, PO4][, LDeC, SDeC, TIC, TAlk][, Oxy]  (fennel_mod.h:497-525).
    temp/salt are tracers 0/1 of the full stack."""
    idb = cfg.ibio
    nexp = 7 + p.po4 + 4 * p.carbon + p.oxygen
    if len(idb) != nexp:
        raise ValueError(f"fennel: expected {nexp} bio tracers "
                         f"(po4={p.po4} carbon={p.carbon} "
                         f"oxygen={p.oxygen}), got {len(idb)}")
    names = ["NO3", "NH4", "Chl", "Phy", "Zoo", "LDeN", "SDeN"]
    if p.po4:
        names += ["PO4"]
    if p.carbon:
        names += ["LDeC", "SDeC", "TIC", "TAlk"]
    if p.oxygen:
        names += ["Oxy"]
    ix = {n: i for i, n in enumerate(names)}

    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    temp = jnp.minimum(t_old[0], 35.0)
    salt = jnp.maximum(t_old[1], 0.0) if cfg.ntracers >= 2 else \
        jnp.zeros_like(temp)

    bio = jnp.stack([jnp.maximum(0.0, t_old[i]) for i in idb])
    if p.carbon:
        bio = bio.at[ix["TIC"]].set(jnp.clip(bio[ix["TIC"]], 400.0,
                                             3000.0))
    bio_old = bio

    if p.const_par is not None:
        par_sur = jnp.full_like(temp[0], p.const_par)
    else:
        srf = srflx if srflx is not None else jnp.zeros_like(temp[0])
        par_sur = p.PARfrac * srf * rho0 * Cp
    day = par_sur > 0.0
    Hz_inv = 1.0 / Hz
    dz = z_w[1:] - z_w[:-1]
    eps = _MINVAL

    def get(n):
        return bio[ix[n]]

    for _ in range(max(1, p.BioIter)):
        # ---- light + uptake + nitrification (fennel.h:685-882) ----
        att = (p.AttSW + p.AttChl * get("Chl")) * dz
        att_above = jnp.flip(jnp.cumsum(jnp.flip(att, 0), axis=0),
                             0) - att
        itop = par_sur[None] * jnp.exp(-att_above)
        PAR = itop * (1.0 - jnp.exp(-att)) / jnp.maximum(att, 1e-20)

        cffc = p.PhyCN * 12.0
        Chl2C = jnp.minimum(get("Chl") / (get("Phy") * cffc + eps),
                            p.Chl2C_m)
        Vp = p.Vp0 * 0.59 * (1.066 ** temp)
        fac1 = PAR * p.PhyIS
        Epp = Vp / jnp.sqrt(Vp * Vp + fac1 * fac1)
        t_PPmax = Epp * fac1

        cff1 = get("NH4") * p.K_NH4
        cff2 = get("NO3") * p.K_NO3
        inhNH4 = 1.0 / (1.0 + cff1)
        L_NH4 = cff1 / (1.0 + cff1)
        L_NO3 = cff2 * inhNH4 / (1.0 + cff2)
        LTOT = L_NO3 + L_NH4
        if p.po4:
            cff3 = get("PO4") * p.K_PO4
            L_PO4 = cff3 / (1.0 + cff3)
            LMIN = jnp.minimum(LTOT, L_PO4)
            mu = dtd * t_PPmax * LMIN
            cff4 = mu * get("Phy") * L_NO3 / jnp.maximum(eps, LTOT) / \
                jnp.maximum(eps, get("NO3"))
            cff5 = mu * get("Phy") * L_NH4 / jnp.maximum(eps, LTOT) / \
                jnp.maximum(eps, get("NH4"))
            cff6 = p.R_P2N * mu * get("Phy") / jnp.maximum(
                eps, get("PO4"))
            chl_fac = dtd * t_PPmax * t_PPmax * LMIN * LMIN
        else:
            facu = dtd * t_PPmax
            cff4 = facu * p.K_NO3 * inhNH4 / (1.0 + cff2) * get("Phy")
            cff5 = facu * p.K_NH4 / (1.0 + cff1) * get("Phy")
            chl_fac = dtd * t_PPmax * t_PPmax * LTOT * LTOT
        # daytime only: uptake happens under PAR>0 (night loop in the
        # reference does nitrification only)
        cff4 = jnp.where(day[None], cff4, 0.0)
        cff5 = jnp.where(day[None], cff5, 0.0)
        no3 = get("NO3") / (1.0 + cff4)
        nh4 = get("NH4") / (1.0 + cff5)
        N_new = no3 * cff4
        N_reg = nh4 * cff5
        bio = bio.at[ix["NO3"]].set(no3).at[ix["NH4"]].set(nh4)
        if p.po4:
            cff6 = jnp.where(day[None], cff6, 0.0)
            bio = bio.at[ix["PO4"]].set(get("PO4") / (1.0 + cff6))
        bio = bio.at[ix["Phy"]].add(N_new + N_reg)
        chl_inc = jnp.where(
            day[None],
            chl_fac * p.Chl2C_m * get("Chl") /
            (p.PhyIS * jnp.maximum(Chl2C, eps) * PAR + eps), 0.0)
        bio = bio.at[ix["Chl"]].add(chl_inc)
        if p.oxygen:
            bio = bio.at[ix["Oxy"]].add(N_new * _rOxNO3 +
                                        N_reg * _rOxNH4)
        if p.carbon:
            bio = bio.at[ix["TIC"]].add(-p.PhyCN * (N_new + N_reg))
            if p.talk_nonconserv:
                bio = bio.at[ix["TAlk"]].add(N_new - N_reg)

        # nitrification, light-inhibited by day, max rate at night
        # (fennel.h:812-882)
        if p.oxygen:
            fac2 = jnp.maximum(get("Oxy"), 0.0)
            fac3 = fac2 / (3.0 + fac2)
            fac1n = dtd * p.NitriR * fac3
        else:
            fac1n = dtd * p.NitriR
        cffi = (PAR - p.I_thNH4) / (p.D_p5NH4 + PAR - 2.0 * p.I_thNH4)
        inhib = 1.0 - jnp.maximum(0.0, cffi)
        cff3n = jnp.where(day[None], fac1n * inhib, dtd * p.NitriR)
        nh4 = get("NH4") / (1.0 + cff3n)
        N_nit = nh4 * cff3n
        bio = bio.at[ix["NH4"]].set(nh4).at[ix["NO3"]].add(N_nit)
        if p.oxygen:
            bio = bio.at[ix["Oxy"]].add(-2.0 * N_nit)
        if p.carbon and p.talk_nonconserv:
            bio = bio.at[ix["TAlk"]].add(-2.0 * N_nit)

        # ---- grazing / P mortality (fennel.h:884-928) ----
        cff1 = dtd * p.ZooGR * get("Zoo") * get("Phy") / \
            (p.K_Phy + get("Phy") ** 2)
        cff3 = 1.0 / (1.0 + cff1)
        phy = cff3 * get("Phy")
        chl = cff3 * get("Chl")
        N_assim = cff1 * phy * p.ZooAE_N
        N_egest = cff1 * phy * (1.0 - p.ZooAE_N)
        cff2 = dtd * p.PhyMR
        N_pmort = cff2 * jnp.maximum(phy - p.PhyMin, 0.0)
        bio = (bio.at[ix["Phy"]].set(phy - N_pmort)
               .at[ix["Chl"]].set(
                   chl - cff2 * jnp.maximum(chl - p.ChlMin, 0.0))
               .at[ix["Zoo"]].add(N_assim)
               .at[ix["SDeN"]].add(N_egest + N_pmort))
        if p.carbon:
            bio = bio.at[ix["SDeC"]].add(
                p.PhyCN * (N_egest + N_pmort) +
                (p.PhyCN - p.ZooCN) * N_assim)

        # ---- Z metabolism/mortality/excretion (fennel.h:930-981) ----
        fac1z = dtd * p.ZooER * get("Phy") ** 2 / \
            (p.K_Phy + get("Phy") ** 2)
        cff2 = dtd * p.ZooMR * get("Zoo")
        cff3 = fac1z * p.ZooAE_N
        zoo = get("Zoo") / (1.0 + cff2 + cff3)
        N_zmort = cff2 * zoo
        N_zexc = cff3 * zoo
        cff1 = dtd * p.ZooBM
        N_zmet = cff1 * jnp.maximum(zoo - p.ZooMin, 0.0)
        bio = (bio.at[ix["Zoo"]].set(zoo - N_zmet)
               .at[ix["NH4"]].add(N_zexc + N_zmet)
               .at[ix["SDeN"]].add(N_zmort))
        if p.po4:
            bio = bio.at[ix["PO4"]].add(p.R_P2N * (N_zexc + N_zmet))
        if p.oxygen:
            bio = bio.at[ix["Oxy"]].add(-_rOxNH4 * (N_zmet + N_zexc))
        if p.carbon:
            bio = bio.at[ix["SDeC"]].add(p.ZooCN * N_zmort)
            bio = bio.at[ix["TIC"]].add(p.ZooCN * (N_zmet + N_zexc))
            if p.talk_nonconserv:
                bio = bio.at[ix["TAlk"]].add(N_zmet + N_zexc)

        # ---- coagulation (fennel.h:983-1007) ----
        cff1 = dtd * p.CoagR * (get("SDeN") + get("Phy"))
        cff2 = 1.0 / (1.0 + cff1)
        phy = get("Phy") * cff2
        chl = get("Chl") * cff2
        sde = get("SDeN") * cff2
        N_coagP = phy * cff1
        N_coagD = sde * cff1
        bio = (bio.at[ix["Phy"]].set(phy).at[ix["Chl"]].set(chl)
               .at[ix["SDeN"]].set(sde)
               .at[ix["LDeN"]].add(N_coagP + N_coagD))
        if p.carbon:
            bio = (bio.at[ix["SDeC"]].add(-p.PhyCN * N_coagD)
                   .at[ix["LDeC"]].add(p.PhyCN * (N_coagP + N_coagD)))

        # ---- detritus remineralization (fennel.h:1009-1092) ----
        if p.oxygen:
            fac1r = jnp.maximum(get("Oxy") - 6.0, 0.0)
            fac2r = fac1r / (3.0 + fac1r)
        else:
            fac2r = 1.0
        cff1 = dtd * p.SDeRRN * fac2r
        cff3 = dtd * p.LDeRRN * fac2r
        sde = get("SDeN") / (1.0 + cff1)
        lde = get("LDeN") / (1.0 + cff3)
        N_rem = sde * cff1 + lde * cff3
        bio = (bio.at[ix["SDeN"]].set(sde).at[ix["LDeN"]].set(lde)
               .at[ix["NH4"]].add(N_rem))
        if p.po4:
            bio = bio.at[ix["PO4"]].add(p.R_P2N * N_rem)
        if p.oxygen:
            bio = bio.at[ix["Oxy"]].add(-N_rem * _rOxNH4)
        if p.carbon and p.talk_nonconserv:
            bio = bio.at[ix["TAlk"]].add(N_rem)

        # ---- surface gas exchange (fennel.h:1095-1283) ----
        if p.oxygen or p.carbon:
            if uwind is not None and vwind is not None:
                u10sq = uwind ** 2 + vwind ** 2
            else:
                su = sustr if sustr is not None else jnp.zeros_like(
                    temp[0])
                sv = svstr if svstr is not None else jnp.zeros_like(
                    temp[0])
                u10sq = rho0 * 550.0 * jnp.sqrt(su ** 2 + sv ** 2)
            cffg = dtd * 0.31 * 24.0 / 100.0
            ts = temp[-1]
            ss = salt[-1]
        if p.oxygen:
            SchmO = _A_O2 - ts * (_B_O2 - ts * (_C_O2 - ts * (
                _D_O2 - ts * _E_O2)))
            kvO = cffg * u10sq * jnp.sqrt(660.0 / SchmO)
            O2sat = o2_saturation(ts, ss)
            o2flux = kvO * (O2sat - get("Oxy")[-1])
            bio = bio.at[ix["Oxy"], -1].add(o2flux * Hz_inv[-1])
        if p.carbon:
            cff1 = dtd * p.SDeRRC
            cff3 = dtd * p.LDeRRC
            sdc = get("SDeC") / (1.0 + cff1)
            ldc = get("LDeC") / (1.0 + cff3)
            bio = (bio.at[ix["SDeC"]].set(sdc).at[ix["LDeC"]].set(ldc)
                   .at[ix["TIC"]].add(sdc * cff1 + ldc * cff3))
            if not p.talk_nonconserv:
                # diagnostic alkalinity (Brewer et al. 1986; h:1186)
                bio = bio.at[ix["TAlk"]].set(587.05 + 50.56 * salt)
            SchmC = _A_CO2 - ts * (_B_CO2 - ts * (_C_CO2 - ts * (
                _D_CO2 - ts * _E_CO2)))
            kvC = cffg * u10sq * jnp.sqrt(660.0 / SchmC)
            pco2, _ = pco2_water(ts, ss, get("TIC")[-1],
                                 get("TAlk")[-1])
            a1, a2, a3, b1, b2, b3 = _CO2SOL
            TempK = 0.01 * (ts + 273.15)
            co2sol = jnp.exp(a1 + a2 / TempK + a3 * jnp.log(TempK) +
                             ss * (b1 + TempK * (b2 + b3 * TempK)))
            co2flux = kvC * co2sol * (p.pCO2air - pco2)
            bio = bio.at[ix["TIC"], -1].add(co2flux * Hz_inv[-1])

        # ---- sinking (fennel.h:1286-1462) + BIO_SEDIMENT ----
        sinkers = [("Phy", p.wPhy), ("Chl", p.wPhy),
                   ("SDeN", p.wSDet), ("LDeN", p.wLDet)]
        if p.carbon:
            sinkers += [("SDeC", p.wSDet), ("LDeC", p.wLDet)]
        for (name, w) in sinkers:
            if w == 0.0:
                continue
            sunk, fc0 = ppm_sink(get(name), Hz, z_w, dtd * abs(w))
            bio = bio.at[ix[name]].set(sunk)
            if p.bio_sediment:
                cffb = fc0 * Hz_inv[0]
                if name in ("Phy", "SDeN", "LDeN"):
                    if p.denitrification:
                        bio = bio.at[ix["NH4"], 0].add(
                            cffb * 4.0 / 16.0)
                        if p.oxygen:
                            bio = bio.at[ix["Oxy"], 0].add(
                                -cffb * 115.0 / 16.0)
                    else:
                        bio = bio.at[ix["NH4"], 0].add(cffb)
                        if p.oxygen:
                            bio = bio.at[ix["Oxy"], 0].add(
                                -cffb * 106.0 / 16.0)
                        if p.carbon and p.talk_nonconserv:
                            bio = bio.at[ix["TAlk"], 0].add(cffb)
                    if p.po4:
                        bio = bio.at[ix["PO4"], 0].add(cffb * p.R_P2N)
                if p.carbon and name in ("SDeC", "LDeC"):
                    bio = bio.at[ix["TIC"], 0].add(cffb)
                if p.carbon and name == "Phy":
                    bio = bio.at[ix["TIC"], 0].add(cffb * p.PhyCN)

    if p.carbon:
        bio = bio.at[ix["TIC"]].set(jnp.clip(bio[ix["TIC"]], 400.0,
                                             3000.0))
    incr = bio - bio_old
    rmask = getattr(grid, "rmask", None)
    if rmask is not None:
        incr = incr * rmask[None, None]
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new


# =====================================================================
# Hypoxia Simple Respiration Model (hypoxia_srm.h)
# =====================================================================

@dataclass(frozen=True)
class HypoxiaParams:
    """hypoxia_srm.in defaults (External/hypoxia_srm.in:49-60).

    One bio tracer: dissolved oxygen (mmol O2/m3).  Water-column
    respiration (read as a climatology field, OCEAN%respiration) is the
    only sink; the surface source is O2 air-sea gas exchange with the
    same Wanninkhof-92 transfer velocity / Garcia-Gordon saturation as
    Fennel (hypoxia_srm.h:218-266)."""
    BioIter: int = 1
    ResRate: float = 1.1e-4       # 1/day default total respiration
    surface_do_saturation: bool = False   # SURFACE_DO_SATURATION
    ocmip_sc: bool = False        # OCMIP_OXYGEN_SC Schmidt variant


def hypoxia_srm(cfg: Config, p: HypoxiaParams, grid, t_old, t_new,
                Hz, z_w, srflx, sustr=None, svstr=None,
                uwind=None, vwind=None, respiration=None):
    """Apply one dt of the simple respiration model.

    respiration: (N,Ny,Nx) respiration rate (mmol O2/m3/day); defaults
    to the uniform p.ResRate (the file-driven field in the reference,
    hypoxia_srm.h:??, is supplied through forcing["respiration"])."""
    (iOxy,) = cfg.ibio
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    temp = jnp.minimum(t_old[0], 35.0)
    salt = jnp.maximum(t_old[1], 0.0) if cfg.ntracers >= 2 else \
        jnp.zeros_like(temp)
    oxy = jnp.maximum(0.0, t_old[iOxy])
    oxy_old = oxy

    if respiration is None:
        respiration = jnp.full_like(temp, p.ResRate)

    for _ in range(max(1, p.BioIter)):
        # respiration sink, floored at zero (hypoxia_srm.h:203-209)
        oxy = jnp.maximum(oxy - dtd * respiration, 0.0)

        temp_s, salt_s = temp[-1], salt[-1]
        o2sat = o2_saturation(temp_s, salt_s)
        if p.surface_do_saturation:
            # clamp the surface cell at saturation
            oxy = oxy.at[-1].set(o2sat)
        else:
            # Wanninkhof-92 gas exchange (hypoxia_srm.h:222-262)
            if uwind is not None and vwind is not None:
                u10squ = uwind ** 2 + vwind ** 2
            else:
                zu = jnp.zeros_like(temp_s)
                su = sustr if sustr is not None else zu
                sv = svstr if svstr is not None else zu
                u10squ = rho0 * 550.0 * jnp.sqrt(
                    (0.5 * (su + jnp.roll(su, -1, -1))) ** 2 +
                    (0.5 * (sv + jnp.roll(sv, -1, -2))) ** 2)
            if p.ocmip_sc:
                sc = 1638.0 - temp_s * (81.83 - temp_s *
                                        (1.483 - temp_s * 0.008004))
            else:
                sc = 1953.4 - temp_s * (128.0 - temp_s *
                                        (3.9918 - temp_s * 0.050091))
            kw = dtd * (0.31 * 24.0 / 100.0) * u10squ * \
                jnp.sqrt(660.0 / sc)
            flux = kw * (o2sat - oxy[-1])
            oxy = oxy.at[-1].add(flux / Hz[-1])

    t_new = t_new.at[iOxy].add(oxy - oxy_old)
    return t_new


# =====================================================================
# NEMURO lower-trophic ecosystem (Kishi et al. 2007; nemuro.h)
# =====================================================================

@dataclass(frozen=True)
class NemuroParams:
    """nemuro.in defaults (External/nemuro.in:70-170).  11 compartments,
    ibio order = (Sphy, Lphy, Szoo, Lzoo, Pzoo, NO3, NH4, PON, DON,
    SiOH4, opal) (nemuro_mod.h:178-188 index assignment)."""
    BioIter: int = 1
    AttSW: float = 0.04
    AttPS: float = 0.04
    AttPL: float = 0.04
    PARfrac: float = 0.43
    AlphaPS: float = 0.01
    AlphaPL: float = 0.01
    BetaPS: float = 4.5e-4
    BetaPL: float = 4.5e-4
    VmaxS: float = 0.4
    VmaxL: float = 0.8
    KNO3S: float = 1.0
    KNO3L: float = 3.0
    KNH4S: float = 0.1
    KNH4L: float = 0.3
    KSiL: float = 6.0
    PusaiS: float = 1.5
    PusaiL: float = 1.5
    KGppS: float = 6.93e-2
    KGppL: float = 6.93e-2
    ResPS0: float = 0.03
    ResPL0: float = 0.03
    KResPS: float = 0.0519
    KResPL: float = 0.0519
    GammaS: float = 0.135
    GammaL: float = 0.135
    MorPS0: float = 58.5e-3
    MorPL0: float = 29.0e-3
    KMorPS: float = 6.93e-2
    KMorPL: float = 6.93e-2
    GRmaxSps: float = 0.40
    GRmaxLps: float = 0.10
    GRmaxLpl: float = 0.40
    GRmaxLzs: float = 0.40
    GRmaxPpl: float = 0.20
    GRmaxPzs: float = 0.20
    GRmaxPzl: float = 0.20
    KGraS: float = 6.93e-2
    KGraL: float = 6.93e-2
    KGraP: float = 6.93e-2
    LamS: float = 1.4
    LamL: float = 1.4
    LamP: float = 1.4
    PS2ZSstar: float = 4.3e-2
    PS2ZLstar: float = 4.0e-2
    PL2ZLstar: float = 4.0e-2
    ZS2ZLstar: float = 4.0e-2
    PL2ZPstar: float = 4.0e-2
    ZS2ZPstar: float = 4.0e-2
    ZL2ZPstar: float = 4.0e-2
    PusaiPL: float = 4.605
    PusaiZS: float = 3.010
    MorZS0: float = 58.5e-3
    MorZL0: float = 58.5e-3
    MorZP0: float = 58.5e-3
    KMorZS: float = 0.0693
    KMorZL: float = 0.0693
    KMorZP: float = 0.0693
    AlphaZS: float = 0.70
    AlphaZL: float = 0.70
    AlphaZP: float = 0.70
    BetaZS: float = 0.30
    BetaZL: float = 0.30
    BetaZP: float = 0.30
    Nit0: float = 0.03
    VP2N0: float = 0.10
    VP2D0: float = 0.10
    VD2N0: float = 0.20
    VO2S0: float = 0.10
    KNit: float = 6.93e-2
    KP2D: float = 6.93e-2
    KP2N: float = 6.93e-2
    KD2N: float = 6.93e-2
    KO2S: float = 6.93e-2
    RSiN: float = 2.0
    setVPON: float = 40.0     # m/day
    setVOpal: float = 40.0    # m/day
    const_par: Optional[float] = None


def nemuro(cfg: Config, p: NemuroParams, t_old, t_new, Hz, z_w, srflx):
    """NEMURO source/sink terms (nemuro.h:239-660, IVLEV_IMPLICIT
    grazing branch, the compile default).  Every conversion is the
    reference's backward-implicit consume/transfer stage - elementwise
    on (11,N,Ny,Nx) stacks, fused by XLA into one kernel."""
    idb = cfg.ibio
    if len(idb) != 11:
        raise ValueError(f"nemuro needs 11 bio tracers, got {len(idb)}")
    (iPS, iPL, iZS, iZL, iZP, iNO3, iNH4,
     iPON, iDON, iSiOH, iOpal) = range(11)
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    mv = _MINVAL

    temp = t_old[0]
    bio = jnp.stack([jnp.maximum(0.0, t_old[i]) for i in idb])
    bio_old = bio

    if p.const_par is not None:
        par_sur = jnp.full_like(temp[0], p.const_par)
    else:
        srf = srflx if srflx is not None else jnp.zeros_like(temp[0])
        par_sur = p.PARfrac * srf * rho0 * Cp

    for _ in range(max(1, p.BioIter)):
        # ---- dual-band light with photoinhibition (nemuro.h:160-186):
        # separate S/L attenuation profiles, evaluated at cell centers
        # (half-cell attenuation above + full cells above that) ----
        dzh = 0.5 * (z_w[1:] - z_w[:-1])
        phy2 = bio[iPS] + bio[iPL]
        kapS = p.AttSW + p.AttPS * phy2
        kapL = p.AttSW + p.AttPL * phy2
        attS = kapS * dzh
        attL = kapL * dzh
        # total attenuation from surface down to center of cell k =
        # sum over cells above of 2*att + att(k)
        csumS = jnp.flip(jnp.cumsum(jnp.flip(2.0 * attS, 0), axis=0), 0)
        csumL = jnp.flip(jnp.cumsum(jnp.flip(2.0 * attL, 0), axis=0), 0)
        AttS = par_sur[None] * jnp.exp(-(csumS - attS))
        AttL = par_sur[None] * jnp.exp(-(csumL - attL))
        LightS = (1.0 - jnp.exp(-p.AlphaPS * AttS / p.VmaxS)) * \
            jnp.exp(-p.BetaPS * AttS / p.VmaxS)
        LightL = (1.0 - jnp.exp(-p.AlphaPL * AttL / p.VmaxL)) * \
            jnp.exp(-p.BetaPL * AttL / p.VmaxL)
        day = par_sur[None] > 0.0
        LightS = jnp.where(day, LightS, 0.0)
        LightL = jnp.where(day, LightL, 0.0)

        # ---- small-phyto gross production (nemuro.h:188-216) ----
        cff1 = dtd * p.VmaxS * jnp.exp(p.KGppS * temp) * LightS * bio[iPS]
        cff2 = cff1 * jnp.exp(-p.PusaiS * bio[iNH4]) / \
            (p.KNO3S + bio[iNO3])
        cff3 = cff1 / (p.KNH4S + bio[iNH4])
        bio = bio.at[iNO3].set(bio[iNO3] / (1.0 + cff2))
        bio = bio.at[iNH4].set(bio[iNH4] / (1.0 + cff3))
        GppNPS = bio[iNO3] * cff2
        GppAPS = bio[iNH4] * cff3
        GppPS = GppNPS + GppAPS
        bio = bio.at[iPS].add(GppPS)
        RnewS = GppNPS / jnp.maximum(mv, GppPS)
        cff4 = dtd * p.ResPS0 * jnp.exp(p.KResPS * temp)
        bio = bio.at[iPS].set(bio[iPS] / (1.0 + cff4))
        ResPS = bio[iPS] * cff4
        bio = (bio.at[iNO3].add(ResPS * RnewS)
                  .at[iNH4].add(ResPS * (1.0 - RnewS)))
        ExcPS = GppPS * p.GammaS
        bio = bio.at[iPS].add(-ExcPS).at[iDON].add(ExcPS)

        # ---- large-phyto production with Si limitation (h:218-260) ----
        cff1 = dtd * p.VmaxL * jnp.exp(p.KGppL * temp) * LightL * bio[iPL]
        cff2 = jnp.exp(-p.PusaiL * bio[iNH4]) / (p.KNO3L + bio[iNO3])
        cff3 = 1.0 / (p.KNH4L + bio[iNH4])
        cff4n = cff2 * bio[iNO3]
        cff5n = cff3 * bio[iNH4]
        cff6 = bio[iSiOH] / (p.KSiL + bio[iSiOH])
        cff7 = cff6 / jnp.maximum(mv, cff4n + cff5n)
        silim = jnp.minimum(1.0, cff7)
        cff4 = cff1 * cff2 * silim
        cff5 = cff1 * cff3 * silim
        bio = bio.at[iNO3].set(bio[iNO3] / (1.0 + cff4))
        bio = bio.at[iNH4].set(bio[iNH4] / (1.0 + cff5))
        GppNPL = bio[iNO3] * cff4
        GppAPL = bio[iNH4] * cff5
        GppPL = GppNPL + GppAPL
        bio = bio.at[iPL].add(GppPL).at[iSiOH].add(-GppPL * p.RSiN)
        RnewL = GppNPL / jnp.maximum(mv, GppPL)
        cff7r = dtd * p.ResPL0 * jnp.exp(p.KResPL * temp)
        bio = bio.at[iPL].set(bio[iPL] / (1.0 + cff7r))
        ResPL = bio[iPL] * cff7r
        bio = (bio.at[iNO3].add(ResPL * RnewL)
                  .at[iNH4].add(ResPL * (1.0 - RnewL))
                  .at[iSiOH].add(ResPL * p.RSiN))
        ExcPL = GppPL * p.GammaL
        bio = (bio.at[iPL].add(-ExcPL).at[iDON].add(ExcPL)
                  .at[iSiOH].add(ExcPL * p.RSiN))

        # ---- phyto mortality (h:262-276) ----
        cff1 = dtd * p.MorPS0 * bio[iPS] * jnp.exp(p.KMorPS * temp)
        cff2 = dtd * p.MorPL0 * bio[iPL] * jnp.exp(p.KMorPL * temp)
        bio = bio.at[iPS].set(bio[iPS] / (1.0 + cff1))
        bio = bio.at[iPL].set(bio[iPL] / (1.0 + cff2))
        MorPS = bio[iPS] * cff1
        MorPL = bio[iPL] * cff2
        bio = (bio.at[iPON].add(MorPS + MorPL)
                  .at[iOpal].add(MorPL * p.RSiN))

        # ---- grazing chain, IVLEV_IMPLICIT branch (h:278-420):
        # cff = (1 + prey/(fac*ivlev))*exp(Ktemp)*predator; prey is
        # divided by (1+cff) and the grazed mass moves to the predator.
        # Note the reference's ZS2ZL and ZS2ZP stages use Bio(iSphy) in
        # the implicit factor (reproduced as-is). ----
        tS = jnp.exp(p.KGraS * temp)
        tL = jnp.exp(p.KGraL * temp)
        tP = jnp.exp(p.KGraP * temp)

        def ivlev_graze(bio, prey, pred, fac, lam, star, tfac,
                        inhib=None, implicit_prey=None):
            if fac == 0.0:            # rate switched off: traced out
                return bio, jnp.zeros_like(bio[prey])
            iv = 1.0 - jnp.exp(lam * (star - bio[prey]))
            # guard: the implicit form divides by fac*iv; where the
            # Ivlev factor is <= 0 there is no grazing
            safe = jnp.maximum(iv, mv)
            ip = bio[implicit_prey if implicit_prey is not None
                     else prey]
            cff = (1.0 + ip / (fac * safe)) * tfac * bio[pred]
            if inhib is not None:
                cff = cff * inhib
            cff = jnp.where(iv > 0.0, cff, 0.0)
            pnew = bio[prey] / (1.0 + cff)
            gra = cff * pnew
            return bio.at[prey].set(pnew).at[pred].add(gra), gra

        bio, GraPS2ZS = ivlev_graze(bio, iPS, iZS, dtd * p.GRmaxSps,
                                    p.LamS, p.PS2ZSstar, tS)
        bio, GraPS2ZL = ivlev_graze(bio, iPS, iZL, dtd * p.GRmaxLps,
                                    p.LamL, p.PS2ZLstar, tL)
        bio, GraPL2ZL = ivlev_graze(bio, iPL, iZL, dtd * p.GRmaxLpl,
                                    p.LamL, p.PL2ZLstar, tL)
        bio, GraZS2ZL = ivlev_graze(bio, iZS, iZL, dtd * p.GRmaxLzs,
                                    p.LamL, p.ZS2ZLstar, tL,
                                    implicit_prey=iPS)
        inh1 = jnp.exp(-p.PusaiPL * (bio[iZL] + bio[iZS]))
        bio, GraPL2ZP = ivlev_graze(bio, iPL, iZP, dtd * p.GRmaxPpl,
                                    p.LamP, p.PL2ZPstar, tP, inhib=inh1)
        inh2 = jnp.exp(-p.PusaiZS * bio[iZL])
        bio, GraZS2ZP = ivlev_graze(bio, iZS, iZP, dtd * p.GRmaxPzs,
                                    p.LamP, p.ZS2ZPstar, tP, inhib=inh2)
        bio, GraZL2ZP = ivlev_graze(bio, iZL, iZP, dtd * p.GRmaxPzl,
                                    p.LamP, p.ZL2ZPstar, tP)

        # ---- egestion and excretion (h:420-434) ----
        EgeZS = (1.0 - p.AlphaZS) * GraPS2ZS
        EgeZL = (1.0 - p.AlphaZL) * (GraPS2ZL + GraPL2ZL + GraZS2ZL)
        EgeZP = (1.0 - p.AlphaZP) * (GraPL2ZP + GraZS2ZP + GraZL2ZP)
        ExcZS = (p.AlphaZS - p.BetaZS) * GraPS2ZS
        ExcZL = (p.AlphaZL - p.BetaZL) * (GraPS2ZL + GraPL2ZL +
                                          GraZS2ZL)
        ExcZP = (p.AlphaZP - p.BetaZP) * (GraPL2ZP + GraZS2ZP +
                                          GraZL2ZP)
        bio = (bio.at[iZS].add(-EgeZS - ExcZS)
                  .at[iZL].add(-EgeZL - ExcZL)
                  .at[iZP].add(-EgeZP - ExcZP)
                  .at[iPON].add(EgeZS + EgeZL + EgeZP)
                  .at[iNH4].add(ExcZS + ExcZL + ExcZP)
                  .at[iOpal].add((GraPL2ZL + GraPL2ZP) * p.RSiN))

        # ---- zooplankton mortality (h:436-451) ----
        cff1 = dtd * p.MorZS0 * bio[iZS] * jnp.exp(p.KMorZS * temp)
        cff2 = dtd * p.MorZL0 * bio[iZL] * jnp.exp(p.KMorZL * temp)
        cff3 = dtd * p.MorZP0 * bio[iZP] * jnp.exp(p.KMorZP * temp)
        bio = bio.at[iZS].set(bio[iZS] / (1.0 + cff1))
        bio = bio.at[iZL].set(bio[iZL] / (1.0 + cff2))
        bio = bio.at[iZP].set(bio[iZP] / (1.0 + cff3))
        bio = bio.at[iPON].add(bio[iZS] * cff1 + bio[iZL] * cff2 +
                               bio[iZP] * cff3)

        # ---- remineralization chain (h:453-480) ----
        def decay(bio, src, dst, v0, kk, ratio=1.0):
            c = dtd * v0 * jnp.exp(kk * temp)
            s = bio[src] / (1.0 + c)
            return bio.at[src].set(s).at[dst].add(s * c * ratio)

        bio = decay(bio, iNH4, iNO3, p.Nit0, p.KNit)      # nitrification
        bio = decay(bio, iPON, iNH4, p.VP2N0, p.KP2N)
        bio = decay(bio, iPON, iDON, p.VP2D0, p.KP2D)
        bio = decay(bio, iDON, iNH4, p.VD2N0, p.KD2N)
        bio = decay(bio, iOpal, iSiOH, p.VO2S0, p.KO2S)

        # ---- sinking of PON and opal (h:482-660, same PPM scheme) ----
        for comp, w in ((iPON, p.setVPON), (iOpal, p.setVOpal)):
            if w != 0.0:
                sunk, _ = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))
                bio = bio.at[comp].set(sunk)

    incr = bio - bio_old
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new


# =====================================================================
# Red tide (Alexandrium fundyense) model - Stock et al. (2005),
# He et al. (2008) (red_tide.h)
# =====================================================================

@dataclass(frozen=True)
class RedTideParams:
    """red_tide.in defaults (External/red_tide.in:49-70).  One bio
    tracer: dinoflagellate concentration (cells/m3).  Germination from
    a bottom cyst map + temperature/salinity/light/DIN-limited growth +
    Q10 mortality + upward swimming."""
    BioIter: int = 1
    Gmax: float = 1.05          # 1/day maximum growth
    Dg: float = 0.18            # cm, cyst germination depth
    Kn: float = 3.0             # mmol/m3, DIN half-saturation
    G_eff: float = 0.036        # (W/m2/day)^-1 growth efficiency
    G_r: float = 0.2            # 1/day maintenance respiration
    srad_Cdepth: float = 345.5  # W/m2 surface rad for compens. depth
    AttW: float = 0.2           # 1/m water attenuation
    AttS: float = 3.5           # 1/cm sediment attenuation
    E_light: float = 2.4        # W/m2 light germination threshold
    E_dark: float = 0.024       # W/m2 dark germination threshold
    Tmin_growth: float = 5.0    # degC
    DIN_Cdepth: float = 15.0    # mmol/m3 DIN below compensation depth
    wDino: float = 10.0         # m/day upward swimming
    Mor_a: float = 0.04         # 1/day mortality amplitude
    Mor_b: float = 0.03         # 1/day mortality intercept
    Mor_Q10: float = 10.0
    Mor_T0: float = 15.0        # degC
    NsedLayers: int = 10        # red_tide.h:165


# monthly endogenous-clock germination potential (red_tide_mod.h:
# Month_MidDay + GP tables; GPN = GP / max(GP))
_MONTH_MIDDAY = jnp.array([15.5, 45.0, 74.5, 105.0, 135.5, 166.0,
                           196.5, 227.5, 258.0, 288.5, 319.0, 349.5])
_GP = jnp.array([21.90, 11.25, 78.0, 85.0, 96.8, 93.0, 60.0, 50.0,
                 10.0, 11.5, 17.0, 34.5])
_GPN = _GP / 96.8


def _endo_scale(yday):
    """Piecewise-linear interpolation of the monthly germination
    potential at year-day yday (red_tide.h:266-289)."""
    # wrap: before mid-Jan / after mid-Dec interpolates Dec->Jan
    span = 365.0 - _MONTH_MIDDAY[11] + _MONTH_MIDDAY[0]
    before = (365.0 - _MONTH_MIDDAY[11] + yday) / span
    after = (yday - _MONTH_MIDDAY[11]) / span
    wrap_cff = jnp.where(yday < _MONTH_MIDDAY[0], before, after)
    wrap_val = _GPN[11] + wrap_cff * (_GPN[0] - _GPN[11])
    # interior months
    i = jnp.clip(jnp.searchsorted(_MONTH_MIDDAY, yday) - 1, 0, 10)
    cff = (yday - _MONTH_MIDDAY[i]) / (_MONTH_MIDDAY[i + 1] -
                                       _MONTH_MIDDAY[i])
    interior = _GPN[i] + cff * (_GPN[i + 1] - _GPN[i])
    inside = (yday >= _MONTH_MIDDAY[0]) & (yday < _MONTH_MIDDAY[11])
    return jnp.where(inside, interior, wrap_val)


def ppm_swim(qc, Hz, w_dt):
    """Vertical swimming/sinking flux: the red_tide.h PPM scheme
    (red_tide.h:330-420, LIMIT_INTERIOR off, NEUMANN off).  w_dt > 0
    moves mass downward, w_dt < 0 upward; Courant-limited (|w_dt| <
    min Hz), no flux through surface or bottom.  Returns new profile."""
    N = qc.shape[0]
    FC = (qc[1:] - qc[:-1]) / (Hz[1:] + Hz[:-1])        # (N-1,...)

    # PPM slopes for interior boxes k=1..N-2
    q, hzm, hz, hzp = qc[1:-1], Hz[:-2], Hz[1:-1], Hz[2:]
    dltR = hz * FC[1:]
    dltL = hz * FC[:-1]
    zero = dltR * dltL < 0.0
    cff = hzm + 2.0 * hz + hzp
    cffR = cff * FC[1:]
    cffL = cff * FC[:-1]
    dltR = jnp.where(zero, 0.0,
                     jnp.where(jnp.abs(dltR) > jnp.abs(cffL), cffL,
                               dltR))
    dltL = jnp.where(zero, 0.0,
                     jnp.where(jnp.abs(dltL) > jnp.abs(cffR), cffR,
                               dltL))
    c = (dltR - dltL) / (hzm + hz + hzp)
    dltR = dltR - c * hzp
    dltL = dltL + c * hzm
    aR = q + dltR
    aL = q - dltL
    dR = (2.0 * dltR - dltL) ** 2
    dL = (2.0 * dltL - dltR) ** 2

    # boundary extrapolation (non-NEUMANN branch)
    aL_top = aR[-1]                     # aL(N) = aR(N-1)
    aR_top = 2.0 * qc[-1] - aL_top
    dR_top = (2.0 * aR_top + aL_top - 3.0 * qc[-1]) ** 2
    dL_top = (3.0 * qc[-1] - 2.0 * aL_top - aR_top) ** 2
    aR_bot = aL[0]                      # aR(1) = aL(2)
    aL_bot = 2.0 * qc[0] - aR_bot
    dR_bot = (2.0 * aR_bot + aL_bot - 3.0 * qc[0]) ** 2
    dL_bot = (3.0 * qc[0] - 2.0 * aL_bot - aR_bot) ** 2
    aR = jnp.concatenate([aR_bot[None], aR, aR_top[None]])
    aL = jnp.concatenate([aL_bot[None], aL, aL_top[None]])
    dR = jnp.concatenate([dR_bot[None], dR, dR_top[None]])
    dL = jnp.concatenate([dL_bot[None], dL, dL_top[None]])

    # WENO-weighted interface values r(k), k=1..N-1, + boundary r
    epsw = 1.0e-12
    wL = jnp.maximum(dL[:-1], epsw)
    wR = jnp.maximum(dR[1:], epsw)
    r_int = (wR * aR[:-1] + wL * aL[1:]) / (wR + wL)    # (N-1,...)
    r_top = 2.0 * qc[-1] - r_int[-1]
    r_bot = 2.0 * qc[0] - r_int[0]
    r = jnp.concatenate([r_bot[None], r_int, r_top[None]])  # (N+1,...)

    aRf = r[1:]
    aLf = r[:-1]
    dLf = 0.5 * (aRf - aLf)
    dRf = 0.5 * (aRf + aLf) - qc

    # Courant-limited flux through interior interfaces k=1..N-1
    down = w_dt > 0.0
    alpha = jnp.where(down, w_dt / Hz[1:], -w_dt / Hz[:-1])
    edge = jnp.where(down, aLf[1:], aRf[:-1])
    cL = jnp.where(down, dLf[1:], -dLf[:-1])
    cR = jnp.where(down, dRf[1:], dRf[:-1])
    FCk = w_dt * (edge + alpha * (cL - cR * (3.0 - 2.0 * alpha)))
    zf = jnp.zeros_like(qc[:1])
    FCi = jnp.concatenate([zf, FCk, zf])                # (N+1,...)
    return qc + (FCi[1:] - FCi[:-1]) / Hz


def red_tide(cfg: Config, p: RedTideParams, t_old, t_new, Hz, z_w, z_r,
             srflx, yday, cyst_ini=None, din_obs=None):
    """Red-tide dinoflagellate source/sink + swimming (red_tide.h).

    yday: year-day scalar (dateclock.F caldate analog); cyst_ini:
    (Ny,Nx) bottom cyst abundance map (cysts/cm3, OCEAN%CystIni);
    din_obs: (N,Ny,Nx) observed DIN climatology (mmol/m3)."""
    (iDino,) = cfg.ibio
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    rad_scale = rho0 * Cp
    temp = jnp.minimum(t_old[0], 36.0)
    salt = jnp.maximum(0.0, t_old[1]) if cfg.ntracers >= 2 else \
        jnp.zeros_like(temp)
    dino = jnp.maximum(0.0, t_old[iDino])
    dino_old = dino
    srf = srflx if srflx is not None else jnp.zeros_like(temp[0])
    if cyst_ini is None:
        cyst_ini = jnp.zeros_like(temp[0])

    # compensation depth from the surface-radiation threshold
    c_depth = jnp.log(p.G_r / (p.G_eff * p.srad_Cdepth)) / p.AttW
    endo = _endo_scale(yday)

    for _ in range(max(1, p.BioIter)):
        # ---- cyst germination at the seabed (red_tide.h:292-330):
        # light/dark germination rates from bottom temperature, light
        # level inside each of NsedLayers sediment sub-layers ----
        tb = temp[0]
        GermL = (1.50 + (8.72 - 1.50) * 0.5 *
                 (jnp.tanh(0.790 * tb - 6.27) + 1.0)) / p.NsedLayers
        GermD = (1.04 + (4.26 - 1.04) * 0.5 *
                 (jnp.tanh(0.394 * tb - 3.33) + 1.0)) / p.NsedLayers
        ksed = jnp.arange(1, p.NsedLayers + 1, dtype=temp.dtype)
        e_flux = rad_scale * srf[None] * jnp.exp(
            p.AttW * z_w[0][None] -
            p.AttS * p.Dg * (ksed[:, None, None] - 0.5))
        frac = jnp.clip((e_flux - p.E_dark) / (p.E_light - p.E_dark),
                        0.0, 1.0)
        germ = jnp.sum(GermD[None] + (GermL - GermD)[None] * frac,
                       axis=0)
        germ = germ * p.Dg * endo          # (x100 then /100 in ref)
        cell_flux = cyst_ini * germ / Hz[0]
        dino = dino.at[0].add(cell_flux * dtd)

        # ---- growth (red_tide.h:332-396): temperature cubic (linear
        # extrapolation below Tmin), salinity cubic, light-limited
        # above the compensation depth, DIN-limited Monod ----
        t_fac = jnp.where(
            temp >= p.Tmin_growth,
            0.379 + temp * (-0.0961 + temp * (0.0169 +
                                              temp * -0.000536)),
            0.254 - 0.0327 * (5.0 - temp))
        s_fac = -0.693 + salt * (0.186 + salt * (-0.00622 +
                                                 salt * 0.0000557))
        g_fac = t_fac * s_fac
        rad = srf[None] * rad_scale * jnp.exp(p.AttW * z_r)
        above = z_r > c_depth
        cffg = p.Gmax * g_fac + p.G_r
        g_light = jnp.where(
            above,
            jnp.maximum(0.0, cffg * jnp.tanh(p.G_eff * rad /
                                             jnp.maximum(cffg, 1e-20))
                        - p.G_r),
            0.0)
        din = din_obs if din_obs is not None else \
            jnp.full_like(temp, p.DIN_Cdepth)
        din = jnp.where(above, din, p.DIN_Cdepth)
        g_din = p.Gmax * g_fac * din / (jnp.maximum(p.Kn, 0.0) + din)
        g_rate = jnp.maximum(jnp.minimum(g_light, g_din), 0.0)
        dino = dino / (1.0 - g_rate * dtd)

        # ---- Q10 mortality (red_tide.h:398-410) ----
        m_rate = p.Mor_a * p.Mor_Q10 ** ((temp - p.Mor_T0) * 0.1) + \
            p.Mor_b
        dino = dino / (1.0 + m_rate * dtd)

        # ---- upward swimming (SWIM_LOOP) ----
        if p.wDino != 0.0:
            dino = ppm_swim(dino, Hz, -p.wDino * dtd)

    t_new = t_new.at[iDino].add(dino - dino_old)
    return t_new


# =====================================================================
# EcoSim (reduced): spectral bio-optics ecosystem (Biology/ecosim.h)
# =====================================================================

@dataclass(frozen=True)
class EcosimParams:
    """Reduced EcoSim (Bissett et al. 1999; Biology/ecosim.h:1-2576,
    ecosim_mod.h parameter blocks).  Documented reductions vs the
    reference: 2 phytoplankton groups (small flagellate + diatom)
    instead of 4, one chlorophyll pigment per group instead of 7
    pigments, one DOM constituent + CDOC instead of 2, one fecal class
    instead of 2, no iron pools, and 12 spectral bands (25 nm,
    400-700 nm) instead of 60 (5 nm).  The distinctive EcoSim
    mechanics are kept: spectral downward irradiance with water/
    chlorophyll/CDOC/detrital absorption, chlorophyll-specific photon
    absorption driving carbon growth, Droop cell-quota nutrient
    limitation on dynamic C:N:P (and C:Si for diatoms), carbon
    exudation to (colored) DOM, a bacterioplankton loop remineralizing
    DOM to NH4/PO4 with respiration to DIC, nitrification, and CDOC
    photolysis."""
    BioIter: int = 1
    # light
    PARfrac: float = 0.43
    avgcos: float = 0.83           # mean cosine (ecosim avgcos_min...)
    aDOC440: float = 0.012         # CDOC-specific absorption @440 (m2/mmolC)
    sDOC: float = 0.014            # CDOC spectral slope (1/nm)
    aDET440: float = 0.005         # detrital absorption @440
    sDET: float = 0.011
    # phytoplankton (group 0: small, group 1: diatom)
    GtALG_max: tuple = (1.5, 2.5)      # 1/day max C growth
    aPHYmax: tuple = (0.025, 0.015)    # m2/mg-chl peak astar @ ~440
    # carbon fixed per absorbed radiant energy (mmolC m3 / (W day));
    # sized so typical lit surface water is light-saturated (growth
    # clipped at GtALG_max) and the subsurface is light-limited
    EphotMax: float = 1.0
    maxC2nALG: tuple = (14.0, 12.0)    # max C:N (quota floor for N)
    minC2nALG: tuple = (6.0, 6.0)      # min C:N (replete)
    maxC2pALG: tuple = (250.0, 200.0)  # C:P quotas
    minC2pALG: tuple = (80.0, 80.0)
    maxC2SiALG: tuple = (0.0, 10.0)    # diatoms only
    minC2SiALG: tuple = (0.0, 5.0)
    maxC2Chl: tuple = (80.0, 60.0)     # g C : g chl bounds
    minC2Chl: tuple = (25.0, 20.0)
    KNO3: tuple = (0.5, 1.0)           # mmol/m3 half saturations
    KNH4: tuple = (0.25, 0.5)
    KPO4: tuple = (0.05, 0.1)
    KSiO: tuple = (0.0, 1.0)
    ExALG: tuple = (0.05, 0.05)        # exudation fraction of growth
    cdocfrac: float = 0.3              # colored fraction of exudation
    HsGRZ: tuple = (0.1, 0.1)          # grazing closure (1/day/(mmolC))
    WS: tuple = (0.0, 0.5)             # sinking (m/day; diatoms)
    # bacteria
    GtBAC_max: float = 2.0         # 1/day
    HsDOC_ba: float = 20.0         # mmolC/m3 half sat
    C2nBAC: float = 5.1            # bacteria C:N
    C2pBAC: float = 60.0
    BacGE: float = 0.3             # growth efficiency (rest respired)
    BacMort: float = 0.3           # 1/day to DOM
    # cycling
    RtNIT: float = 0.05            # 1/day nitrification
    KI_nit: float = 10.0           # W/m2 light inhibition scale
    RtFec: float = 0.1             # 1/day fecal remineralization
    wFec: float = 5.0              # m/day fecal sinking
    photolysis: float = 0.05       # 1/day/(100 W/m2) CDOC photo-bleach


# 12-band tables, 400-700 nm at 25 nm (band centers): pure-water
# absorption (Pope & Fry 1997, sampled) and scattering
_ES_LAM = jnp.asarray([400., 425., 450., 475., 500., 525., 550., 575.,
                       600., 625., 650., 675.])
_ES_AW = jnp.asarray([0.0066, 0.0051, 0.0092, 0.0114, 0.0204, 0.0409,
                      0.0565, 0.0844, 0.2224, 0.2834, 0.34, 0.448])
_ES_BW = 0.0076 * (400.0 / _ES_LAM) ** 4.3
# normalized chl-specific absorption shape (flat-topped blue peak,
# red secondary peak - the ecosim astar spectra collapsed to a shape)
_ES_ASHAPE = jnp.asarray([0.9, 1.0, 0.95, 0.75, 0.45, 0.25, 0.15, 0.12,
                          0.12, 0.18, 0.35, 0.85])


def ecosim(cfg: Config, p: EcosimParams, t_old, t_new, Hz, z_w, srflx):
    """Reduced EcoSim source/sink conversions; increment added to t_new.

    Tracer layout (cfg.ibio, 20 entries):
      0  iNO3   1 iNH4   2 iPO4   3 iSiO   4 iDIC
      5  PhyC1  6 PhyN1  7 PhyP1  8 Chl1
      9  PhyC2 10 PhyN2 11 PhyP2 12 PhyS2 13 Chl2
      14 BacC  15 DOC   16 DON   17 CDOC
      18 FecC  19 FecN
    """
    idb = cfg.ibio
    if len(idb) != 20:
        raise ValueError(f"ecosim needs 20 bio tracers, got {len(idb)}")
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = jnp.stack([t_old[i] for i in idb])
    bio = _positive_definite(bio)
    bio_old = bio
    (iNO3, iNH4, iPO4, iSiO, iDIC, iC1, iN1, iP1, iL1,
     iC2, iN2, iP2, iS2, iL2, iBAC, iDOC, iDON, iCDC,
     iFC, iFN) = range(20)

    par0 = p.PARfrac * jnp.maximum(srflx, 0.0) * rho0 * Cp  # W/m2
    nb = _ES_LAM.shape[0]

    for _ in range(max(1, p.BioIter)):
        chl = (bio[iL1], bio[iL2])
        # ---- spectral downward irradiance Ed(band, k) (ecosim.h
        #      "daylight" block: dATT = (aw + achl + acdoc + adet +
        #      0.5*bw) / avgcos, integrated down from the surface) ----
        lam = _ES_LAM[:, None, None, None]
        a_w = _ES_AW[:, None, None, None] + \
            0.5 * _ES_BW[:, None, None, None]
        a_chl = (_ES_ASHAPE[:, None, None, None] *
                 (p.aPHYmax[0] * chl[0][None] + p.aPHYmax[1] *
                  chl[1][None]))
        a_cdc = p.aDOC440 * bio[iCDC][None] * \
            jnp.exp(-p.sDOC * (lam - 440.0))
        a_det = p.aDET440 * 0.01 * bio[iFC][None] * \
            jnp.exp(-p.sDET * (lam - 440.0))
        dATT = (a_w + a_chl + a_cdc + a_det) / p.avgcos   # (nb,N,Ny,Nx)
        tau = jnp.cumsum((dATT * Hz[None])[:, ::-1], axis=1)[:, ::-1]
        tau_up = tau - dATT * Hz[None]                    # top of cell
        # band-mean Ed inside the cell; equal band split of PAR at z=0
        att = jnp.maximum(dATT * Hz[None], 1.0e-12)
        Ed = (par0[None, None] / nb) * jnp.exp(-tau_up) * \
            (1.0 - jnp.exp(-att)) / att
        par_tot = jnp.sum(Ed, axis=0)                     # W/m2 at cells

        # ---- phytoplankton groups ----
        for g, (iC, iN, iP, iL) in enumerate(
                ((iC1, iN1, iP1, iL1), (iC2, iN2, iP2, iL2))):
            phyC = jnp.maximum(bio[iC], _MINVAL)
            # absorbed energy -> light-limited growth (photon flux *
            # chl-specific absorption; ecosim couples growth to
            # absorbed quanta instead of a PI curve)
            Eabs = jnp.sum(Ed * _ES_ASHAPE[:, None, None, None], axis=0) \
                * p.aPHYmax[g] * bio[iL]
            mu_E = p.EphotMax * Eabs / phyC               # 1/day
            # Droop quota limitation on dynamic C:N / C:P (/ C:Si)
            QN = bio[iN] / phyC                           # N:C
            QP = bio[iP] / phyC
            limN = jnp.clip((QN - 1.0 / p.maxC2nALG[g]) /
                            (1.0 / p.minC2nALG[g] - 1.0 / p.maxC2nALG[g]),
                            0.0, 1.0)
            limP = jnp.clip((QP - 1.0 / p.maxC2pALG[g]) /
                            (1.0 / p.minC2pALG[g] - 1.0 / p.maxC2pALG[g]),
                            0.0, 1.0)
            lim = jnp.minimum(limN, limP)
            if p.maxC2SiALG[g] > 0.0:
                QS = bio[iS2] / phyC
                limS = jnp.clip(
                    (QS - 1.0 / p.maxC2SiALG[g]) /
                    (1.0 / p.minC2SiALG[g] - 1.0 / p.maxC2SiALG[g]),
                    0.0, 1.0)
                lim = jnp.minimum(lim, limS)
            mu = jnp.minimum(p.GtALG_max[g], mu_E) * lim  # 1/day
            growth = mu * phyC * dtd                      # mmolC
            exud = p.ExALG[g] * growth
            netC = growth - exud

            # nutrient uptake toward the replete quota (Droop V)
            room_n = jnp.maximum(phyC / p.minC2nALG[g] - bio[iN], 0.0)
            upNH4 = jnp.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2nALG[g] *
                bio[iNH4] / (p.KNH4[g] + bio[iNH4]), room_n)
            room_n = room_n - upNH4
            upNO3 = jnp.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2nALG[g] *
                bio[iNO3] / (p.KNO3[g] + bio[iNO3]), room_n)
            upNO3 = jnp.minimum(upNO3, 0.9 * bio[iNO3])
            upNH4 = jnp.minimum(upNH4, 0.9 * bio[iNH4])
            room_p = jnp.maximum(phyC / p.minC2pALG[g] - bio[iP], 0.0)
            upPO4 = jnp.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2pALG[g] *
                bio[iPO4] / (p.KPO4[g] + bio[iPO4]), room_p)
            upPO4 = jnp.minimum(upPO4, 0.9 * bio[iPO4])

            # grazing closure (quadratic, unresolved zooplankton;
            # ecosim losses go to fecal + DOM)
            graze = dtd * p.HsGRZ[g] * phyC * phyC / \
                jnp.maximum(phyC + 1.0, 1.0)
            fgrz = jnp.clip(graze / jnp.maximum(phyC, _MINVAL),
                            0.0, 0.5)
            # chlorophyll: photoacclimate toward C:chl between bounds
            # (low light -> more chl per C)
            c2chl_t = p.minC2Chl[g] + (p.maxC2Chl[g] - p.minC2Chl[g]) \
                * par_tot / (par_tot + 30.0)
            chl_target = 12.0 * phyC / c2chl_t     # mg chl (12 gC/molC)
            dchl = 0.5 * dtd * (chl_target - bio[iL])

            bio = (bio
                   .at[iC].add(netC - fgrz * phyC)
                   .at[iN].add(upNO3 + upNH4 - fgrz * bio[iN])
                   .at[iP].add(upPO4 - fgrz * bio[iP])
                   .at[iL].add(dchl - fgrz * bio[iL])
                   .at[iNO3].add(-upNO3)
                   .at[iNH4].add(-upNH4)
                   .at[iPO4].add(-upPO4)
                   .at[iDIC].add(-netC)
                   .at[iDOC].add(exud * (1.0 - p.cdocfrac))
                   .at[iCDC].add(exud * p.cdocfrac)
                   .at[iFC].add(fgrz * phyC)
                   .at[iFN].add(fgrz * bio[iN]))
            if p.maxC2SiALG[g] > 0.0:
                room_s = jnp.maximum(phyC / p.minC2SiALG[g] - bio[iS2],
                                     0.0)
                upSiO = jnp.minimum(
                    dtd * p.GtALG_max[g] * phyC / p.minC2SiALG[g] *
                    bio[iSiO] / (p.KSiO[g] + bio[iSiO]), room_s)
                upSiO = jnp.minimum(upSiO, 0.9 * bio[iSiO])
                bio = (bio.at[iS2].add(upSiO - fgrz * bio[iS2])
                       .at[iSiO].add(-upSiO + fgrz * bio[iS2]))

        # ---- bacterioplankton loop (DOM -> NH4/PO4/DIC) ----
        upDOC = dtd * p.GtBAC_max * bio[iBAC] * \
            bio[iDOC] / (p.HsDOC_ba + bio[iDOC])
        upDOC = jnp.minimum(upDOC, 0.9 * bio[iDOC])
        bacC = upDOC * p.BacGE                    # new bacterial C
        respC = upDOC - bacC                      # respired to DIC
        upDON = jnp.minimum(upDOC * (bio[iDON] /
                                     jnp.maximum(bio[iDOC], _MINVAL)),
                            0.9 * bio[iDON])
        exN = jnp.maximum(upDON - bacC / p.C2nBAC, 0.0)   # excess -> NH4
        mortB = dtd * p.BacMort * bio[iBAC]
        bio = (bio
               .at[iBAC].add(bacC - mortB)
               .at[iDOC].add(-upDOC + mortB)
               .at[iDON].add(-upDON + mortB / p.C2nBAC)
               .at[iDIC].add(respC)
               .at[iNH4].add(exN)
               .at[iPO4].add(respC / p.C2pBAC))

        # ---- nitrification (light inhibited) ----
        nitr = dtd * p.RtNIT * bio[iNH4] * p.KI_nit / (p.KI_nit +
                                                       par_tot)
        bio = bio.at[iNH4].add(-nitr).at[iNO3].add(nitr)

        # ---- fecal remineralization ----
        remC = dtd * p.RtFec * bio[iFC]
        remN = dtd * p.RtFec * bio[iFN]
        bio = (bio.at[iFC].add(-remC).at[iFN].add(-remN)
               .at[iDOC].add(remC).at[iDON].add(remN))

        # ---- CDOC photolysis (surface-light bleaching to DOC) ----
        photo = dtd * p.photolysis * (par_tot / 100.0) * bio[iCDC]
        bio = bio.at[iCDC].add(-photo).at[iDOC].add(photo)

        # ---- sinking: diatom pools and fecal matter ----
        sink_sets = [(iFC, p.wFec), (iFN, p.wFec)]
        if p.WS[1] != 0.0:
            sink_sets += [(i, p.WS[1]) for i in (iC2, iN2, iP2, iS2,
                                                 iL2)]
        for comp, w in sink_sets:
            sunk, _ = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))
            bio = bio.at[comp].set(sunk)
        bio = _positive_definite(bio)

    incr = bio - bio_old
    for n, i in enumerate(idb):
        t_new = t_new.at[i].add(incr[n])
    return t_new
