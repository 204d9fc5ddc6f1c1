"""Model configuration.

Replaces the reference's two-level compile-time CPP + runtime keyword system
(ROMS/Include/cppdefs.h, ROMS/Utility/read_phypar.F) with a single frozen,
hashable dataclass.  Feature selection happens by jit specialization: branches
that a Config disables are traced out, which plays the role of the reference's
textual preprocessing (dead code compiled out).

All fields are plain Python values (hashable) so a Config can be closed over
by / passed statically to jit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Lateral boundary condition kinds, per field & side.  Reference:
# ROMS/Nonlinear/zetabc.F:108-238, u2dbc_im.F, t3dbc_im.F, and the
# LBC keyword grid in roms_*.in (order: West, South, East, North).
BC_PERIODIC = "Per"
BC_CLOSED = "Clo"
BC_GRADIENT = "Gra"
BC_CLAMPED = "Cla"
BC_RADIATION = "Rad"
BC_CHAPMAN_EXPLICIT = "Che"
BC_CHAPMAN_IMPLICIT = "Chi"
BC_FLATHER = "Fla"
BC_SHCHEPETKIN = "Shc"   # Maison et al. 2010 (u2dbc_im.F:286-288)
BC_REDUCED = "Red"       # reduced-physics (u2dbc_im.F:390-392)


@dataclass(frozen=True)
class LBC:
    """Boundary condition selection for one field: (west, south, east, north)."""

    west: str = BC_CLOSED
    south: str = BC_CLOSED
    east: str = BC_CLOSED
    north: str = BC_CLOSED

    @staticmethod
    def periodic_ew() -> "LBC":
        return LBC(west=BC_PERIODIC, east=BC_PERIODIC)

    @staticmethod
    def periodic_ns() -> "LBC":
        return LBC(south=BC_PERIODIC, north=BC_PERIODIC)

    @staticmethod
    def doubly_periodic() -> "LBC":
        return LBC(BC_PERIODIC, BC_PERIODIC, BC_PERIODIC, BC_PERIODIC)


@dataclass(frozen=True)
class GLSParams:
    """GLS closure instance parameters (k-epsilon defaults;
    roms_*.in GLS_* keywords, SURVEY.md Appendix A.4)."""
    p: float = 3.0
    m: float = 1.5
    n: float = -1.0
    cmu0: float = 0.5477
    c1: float = 1.44
    c2: float = 1.92
    c3m: float = -0.4
    c3p: float = 1.0
    sigk: float = 1.0
    sigp: float = 1.3
    Kmin: float = 7.6e-6
    Pmin: float = 1.0e-12
    akk_bak: float = 5.0e-6
    akp_bak: float = 5.0e-6
    # Surface TKE wave forcing (gls_corstep.F:278-302,810-918):
    # CRAIG_BANNER breaking-wave surface TKE flux, CHARNOK stress-derived
    # surface roughness, ZOS_HSIG wave-amplitude roughness.
    craig_banner: bool = False
    charnok: bool = False
    zos_hsig: bool = False
    crgban_cw: float = 100.0          # CRGBAN_CW
    charnok_alpha: float = 1400.0     # CHARNOK_ALPHA
    zos_hsig_alpha: float = 0.5       # ZOS_HSIG_ALPHA

    @staticmethod
    def k_epsilon() -> "GLSParams":
        return GLSParams()

    @staticmethod
    def k_omega() -> "GLSParams":
        return GLSParams(p=-1.0, m=0.5, n=-1.0, cmu0=0.5477, c1=0.555,
                         c2=0.833, c3m=-0.6, c3p=1.0, sigk=2.0, sigp=2.0)

    @staticmethod
    def k_kl() -> "GLSParams":
        """Mellor-Yamada 2.5 as a GLS instance (Warner et al. 2005
        Table 1; the reference's MY25_MIXING equivalent)."""
        return GLSParams(p=0.0, m=1.0, n=1.0, cmu0=0.5544, c1=0.9,
                         c2=0.52, c3m=2.38, c3p=1.0, sigk=1.96,
                         sigp=1.96, Kmin=5.0e-6, Pmin=1.0e-12)


@dataclass(frozen=True)
class Config:
    """Static model configuration (grid sizes, schemes, coefficients).

    Field groups mirror the reference's runtime inputs (roms_*.in) and the
    per-application CPP headers (ROMS/Include/<app>.h).
    """

    name: str = "roms_tpu"

    # --- Grid dimensions (interior rho points; mod_param.F:443-444) ---
    Lm: int = 41          # xi-direction interior points
    Mm: int = 80          # eta-direction interior points
    N: int = 16           # vertical levels
    ntracers: int = 2     # NT: temp, salt, + passive
    halo: int = 3         # ghost width (NghostPoints; inp_par.F:275-280)

    # --- Periodicity (implied by LBC but used pervasively) ---
    ew_periodic: bool = True
    ns_periodic: bool = False
    spherical: bool = False

    # --- Time stepping (roms_*.in: DT, NDTFAST, NTIMES) ---
    dt: float = 300.0       # baroclinic step (s)
    ndtfast: int = 30       # barotropic substeps per baroclinic step
    nfast: int = 0          # actual fast loop length; set by finalize()
    dstart: float = 0.0     # start day
    solve3d: bool = True

    # --- Vertical coordinate (set_scoord.F) ---
    vtransform: int = 2
    vstretching: int = 4
    theta_s: float = 3.0
    theta_b: float = 0.0
    tcline: float = 25.0
    hmin: float = 0.0       # filled by grid builder (min bathymetry)

    # --- Physics switches (cppdefs.h equivalents) ---
    uv_adv: bool = True         # UV_ADV
    uv_cor: bool = True         # UV_COR
    uv_vis2: bool = True        # UV_VIS2 (harmonic)
    uv_vis4: bool = False       # UV_VIS4 (biharmonic)
    ts_dif2: bool = False       # TS_DIF2
    ts_dif4: bool = False       # TS_DIF4
    ts_mix_geo: bool = False    # MIX_GEO_TS (rotated diffusion)
    ts_mix_iso: bool = False    # MIX_ISO_TS (epineutral rotation)
    uv_mix_geo: bool = False    # MIX_GEO_UV (rotated viscosity)
    curvgrid: bool = False      # CURVGRID metric terms
    var_rho_2d: bool = False    # VAR_RHO_2D baroclinic correction in step2d
    splines_vdiff: bool = True  # SPLINES_VDIFF
    splines_vvisc: bool = True  # SPLINES_VVISC
    wetdry: bool = False
    dcrit: float = 0.10         # WET_DRY critical depth (m)
    uv_smagorinsky: bool = False   # UV_SMAGORINSKY (hmixing.F)
    ts_smagorinsky: bool = False   # TS_SMAGORINSKY
    smagor_coef: float = 0.1
    use_sponge: bool = False    # enable grid.visc/diff_factor scaling
    # open-boundary volume conservation sides (obc_volcons.F), e.g.
    # ("west", "east"); empty = off
    volcons: Tuple[str, ...] = ()
    # biological source/sink model (biology.F plugin slot):
    # None | "npzd_powell"; ibio maps (NO3, Phyt, Zoop, SDet) to tracer
    # indices; bio_params is an ops.biology.NPZDParams (hashable).
    # AGE_MEAN + T_PASSIVE inert tracer pairs (step3d_t.F:1507-1539;
    # Zhang et al. 2010): (conservative_index, age_index) tuples; the
    # age concentration is forced by dt * conservative concentration
    # each step (mean age = age / conservative at output time)
    inert_age: Tuple[Tuple[int, int], ...] = ()
    # TIDE_GENERATING_FORCES: equilibrium-tide surface-pressure body
    # force (equilibrium_tide.F); tide_ref_datenum is the tidal
    # reference time as a utils.dateclock day number (Rclock analog)
    tide_gen_forces: bool = False
    tide_ref_datenum: float = 2451545.0
    biology: Optional[str] = None
    ibio: Tuple[int, ...] = (2, 3, 4, 5)
    bio_params: Optional[object] = None

    # sediment model (SEDIMENT + SUSPLOAD/BEDLOAD_MPM): sed_params is an
    # ops.sediment.SedParams (hashable); classes ride as passive tracers
    # starting at sed_params.ised0.
    sediment: bool = False
    sed_params: Optional[object] = None

    # wave-current bottom boundary layer (bbl.F): "ssw" enables the
    # Sherwood-Signell-Warner closure (ops/bbl.py); bbl_params is an
    # ops.bbl.BBLParams.  Wave fields come from the forcing dict
    # ("Hwave", "Pwave", "Dwave").
    bbl: Optional[str] = None
    bbl_params: Optional[object] = None

    # NEARSHORE_MELLOR05 radiation-stress forcing (ops/nearshore.py);
    # wave fields from the forcing dict ("Hwave", "Dwave", "Lwave")
    nearshore: Optional[str] = None

    bulk_fluxes: bool = False   # BULK_FLUXES: COARE air-sea fluxes

    # Bottom drag: one of "linear" (UV_LDRAG), "quadratic" (UV_QDRAG),
    # "logarithmic" (UV_LOGDRAG), or None.
    bottom_drag: Optional[str] = "linear"
    rdrg: float = 3.0e-4        # linear drag (m/s)
    rdrg2: float = 3.0e-3       # quadratic drag (nondim)
    zob: float = 0.02           # bottom roughness (m)

    # --- Mixing coefficients ---
    visc2: float = 5.0                      # m2/s harmonic momentum
    visc4: float = 0.0                      # biharmonic momentum
    tnu2: Tuple[float, ...] = (0.0, 0.0)    # per-tracer harmonic
    tnu4: Tuple[float, ...] = (0.0, 0.0)
    akv_bak: float = 1.0e-5                 # background vertical viscosity
    akt_bak: Tuple[float, ...] = (1.0e-6, 1.0e-6)
    # Vertical closure: None (constant background), "ana", "gls", "kpp",
    # "my25", "bvf".
    vmix: Optional[str] = None
    kpp_bottom: bool = False    # LMD_BKPP bottom boundary layer
    # LMD_DDMIX double-diffusive interior mixing (salt fingering +
    # diffusive convection; lmd_vmix.F:360-428)
    lmd_ddmix: bool = False
    # BODYFORCE: apply surface/bottom stress as a body force spread over
    # the levels k >= levsfrc / k <= levbfrc (1-based ROMS indices)
    # instead of boundary fluxes (rhs3d.F:326-470)
    bodyforce: bool = False
    levsfrc: int = 1
    levbfrc: int = 1
    gls_params: "GLSParams" = GLSParams()
    # MY2.5 stability-function variant (KANTHA_CLAYSON vs Galperin;
    # mod_scalars.F:4481-4490)
    my25_kantha_clayson: bool = False

    # --- Pressure gradient scheme: "djs" = splines density Jacobian
    # (prsgrd32.h, DJ_GRADPS default), "dj" = standard density Jacobian
    # (prsgrd31.h) ---
    prsgrd_scheme: str = "djs"

    # --- Equation of state: "linear" or "jm95" (Jackett & McDougall) ---
    eos: str = "linear"
    rho0: float = 1025.0
    R0: float = 1027.0
    T0: float = 14.0
    S0: float = 35.0
    Tcoef: float = 1.7e-4
    Scoef: float = 0.0

    # --- Momentum advection scheme in 3D rhs ("U3" 3rd upstream-biased
    # horizontal + splines/C4 vertical is the ROMS default; rhs3d.F) ---
    uv_hadv: str = "U3"
    uv_vadv: str = "SPLINES"

    # --- Tracer advection, per tracer (tadv.F:146-178) ---
    t_hadv: Tuple[str, ...] = ("U3", "U3")
    t_vadv: Tuple[str, ...] = ("C4", "C4")

    # --- Lateral BCs per field (LBC keyword grid) ---
    lbc_zeta: LBC = LBC.periodic_ew()
    lbc_ubar: LBC = LBC.periodic_ew()
    lbc_vbar: LBC = LBC.periodic_ew()
    lbc_u: LBC = LBC.periodic_ew()
    lbc_v: LBC = LBC.periodic_ew()
    lbc_t: LBC = LBC.periodic_ew()

    gamma2: float = 1.0     # slipperiness (1=free slip, -1=no slip)
    g_override: Optional[float] = None  # nondimensional cases (SOLITON g=1)

    # --- Numerics ---
    dtype: str = "float64"

    # -------------------------------------------------------------------
    @property
    def dtfast(self) -> float:
        return self.dt / self.ndtfast

    @property
    def nx_tot(self) -> int:
        return self.Lm + 2 * self.halo

    @property
    def ny_tot(self) -> int:
        return self.Mm + 2 * self.halo

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def index_of(cfg: Config, roms_index: int) -> int:
    """Map a ROMS-convention index (rho interior 1..Lm) to padded array index.

    The padded arrays cover ROMS indices ``1-halo .. Lm+halo`` (the DISTRIBUTE
    allocation bounds with NghostPoints=halo), so array index = i + halo - 1.
    """
    return roms_index + cfg.halo - 1
