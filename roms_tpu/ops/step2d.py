"""Fast barotropic engine: LF predictor / AM3 corrector time stepping of
(zeta, ubar, vbar) with power-law fast-time averaging.

Re-implements the reference's step2d (ROMS/Nonlinear/step2d.F +
step2d_LF_AM3.h) and the fast-loop index rotation of main3d.F:592-713 /
main2d.F:449-520 in functional form: the rotating storage indices
(kstp/krhs/knew/indx1) become explicitly named fields carried through the
loop.

Two entry points:
  * fast_loop      - SOLVE3D mode: nfast LF-AM3 fast steps + auxiliary
                     averaging step per slow baroclinic step
                     (FIRST_2D_STEP == iif.eq.1, globaldefs.h:169).
  * step_2d_only   - main2d mode (no SOLVE3D): one predictor/corrector pair
                     per model step with LF history carried across steps
                     (FIRST_2D_STEP == iic.eq.ntfirst, globaldefs.h:171).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..pytree import dataclass as pytree_dataclass
from .. import constants as C
from ..config import Config
from ..grid import Grid
from . import bc, obc, wetdry
from .stencil import ip1, im1, jp1, jm1, at_u, at_v, at_p


@pytree_dataclass
class Fast2DState:
    """Carried state of the fast loop (all (Ny,Nx) padded arrays).

    zeta_n/zeta_nm1: accepted fast levels n and n-1 (slots indx1 / 3-indx1);
    r*_n/r*_nm1: predictor RHS history (the reference's 2-slot
    rzeta/rubar/rvbar); *_avg*: power-law filter accumulators
    (mod_coupling.F:12-49).
    """
    zeta_n: jax.Array
    zeta_nm1: jax.Array
    ubar_n: jax.Array
    ubar_nm1: jax.Array
    vbar_n: jax.Array
    vbar_nm1: jax.Array
    rzeta_n: jax.Array
    rzeta_nm1: jax.Array
    rubar_n: jax.Array
    rubar_nm1: jax.Array
    rvbar_n: jax.Array
    rvbar_nm1: jax.Array
    Zt_avg1: jax.Array
    DU_avg1: jax.Array
    DV_avg1: jax.Array
    DU_avg2: jax.Array
    DV_avg2: jax.Array


def make_fast_state(cfg: Config, zeta, ubar, vbar) -> Fast2DState:
    z = jnp.zeros_like(zeta)
    return Fast2DState(
        zeta_n=zeta, zeta_nm1=zeta, ubar_n=ubar, ubar_nm1=ubar,
        vbar_n=vbar, vbar_nm1=vbar,
        rzeta_n=z, rzeta_nm1=z, rubar_n=z, rubar_nm1=z,
        rvbar_n=z, rvbar_nm1=z,
        Zt_avg1=zeta, DU_avg1=z, DV_avg1=z, DU_avg2=z, DV_avg2=z)


class Forcing2D(NamedTuple):
    """Direct forcing for the 2D-only mode; kinematic stresses (m2/s2).
    In SOLVE3D mode stresses enter through rufrc instead."""
    sustr: Optional[jax.Array] = None
    svstr: Optional[jax.Array] = None


def depth_fluxes(grid: Grid, zeta, ubar, vbar, us2d=None):
    """Total depth and vertically integrated mass fluxes
    (step2d_LF_AM3.h:499-516).  us2d: optional PRECOMPUTED
    depth-integrated Stokes transports (TSu, TSv) - NEARSHORE_MELLOR
    adds the wave transport to the fluxes seen by continuity and 2-D
    advection (step2d_LF_AM3.h:529-541 DUSon/DVSom).  The transport is
    held fixed over the fast loop (the reference re-scales
    ubar_stokes by the instantaneous depth; freezing it instead makes
    the fast-filtered Stokes content of DU_avg1/2 exact - the
    difference is O(ubar_stokes * dzeta), documented delta)."""
    Drhs = zeta + grid.h
    DUon = ubar * at_u(Drhs) * grid.on_u
    DVom = vbar * at_v(Drhs) * grid.om_v
    if us2d is not None:
        DUon = DUon + us2d[0]
        DVom = DVom + us2d[1]
    return Drhs, DUon, DVom


def stokes_transport(grid: Grid, zeta, us2d_vel):
    """Depth-integrated Stokes transports (TSu, TSv) at the step-start
    free surface."""
    us, vs = us2d_vel
    Drhs = zeta + grid.h
    return (us * at_u(Drhs) * grid.on_u, vs * at_v(Drhs) * grid.om_v)


def _g(cfg: Config) -> float:
    # SOLITON and other nondimensional cases override g (ana_grid.h g=1)
    return cfg.g_override if cfg.g_override is not None else C.g


def _rhs_momentum(cfg: Config, grid: Grid, zeta_rhs, ubar, vbar,
                  Drhs, DUon, DVom, gzeta, gzeta2,
                  forcing: Optional[Forcing2D], pmask_wet=None,
                  clm=None):
    """RHS of the 2D momentum equations at the krhs time level
    (step2d_LF_AM3.h:929-1790 under SOLVE3D+UV_ADV+UV_COR+UV_VIS2)."""
    H = cfg.halo
    h = grid.h
    g = _g(cfg)
    sixth = 1.0 / 6.0

    # --- surface-slope pressure gradient (:936-1027) ---
    rhs_ubar = 0.5 * g * grid.on_u * (
        (im1(h) + h) * (im1(gzeta) - gzeta) + (im1(gzeta2) - gzeta2))
    rhs_vbar = 0.5 * g * grid.om_v * (
        (jm1(h) + h) * (jm1(gzeta) - gzeta) + (jm1(gzeta2) - gzeta2))

    # --- 4th-order centered advection (:1079-1287) ---
    if cfg.uv_adv:
        # U-flux, xi direction: UFx at rho points
        gr = im1(ubar) - 2.0 * ubar + ip1(ubar)
        Dg = im1(DUon) - 2.0 * DUon + ip1(DUon)
        gr = bc.extrap_west(cfg, gr, H)                # grad(Istr)=grad(Istr+1)
        Dg = bc.extrap_west(cfg, Dg, H)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = bc.extrap_east(cfg, Dg, H + cfg.Lm)
        UFx = 0.25 * (ubar + ip1(ubar) - sixth * (gr + ip1(gr))) * \
            (DUon + ip1(DUon) - sixth * (Dg + ip1(Dg)))

        # U-flux, eta direction: UFe at psi points
        gr = jm1(ubar) - 2.0 * ubar + jp1(ubar)
        gr = bc.extrap_south(cfg, gr, H - 1)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = im1(DVom) - 2.0 * DVom + ip1(DVom)
        UFe = 0.25 * (ubar + jm1(ubar) - sixth * (gr + jm1(gr))) * \
            (DVom + im1(DVom) - sixth * (Dg + im1(Dg)))

        # V-flux, xi direction: VFx at psi points
        gr = im1(vbar) - 2.0 * vbar + ip1(vbar)
        gr = bc.extrap_west(cfg, gr, H - 1)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = jm1(DUon) - 2.0 * DUon + jp1(DUon)
        VFx = 0.25 * (vbar + im1(vbar) - sixth * (gr + im1(gr))) * \
            (DUon + jm1(DUon) - sixth * (Dg + jm1(Dg)))

        # V-flux, eta direction: VFe at rho points
        gr = jm1(vbar) - 2.0 * vbar + jp1(vbar)
        Dg = jm1(DVom) - 2.0 * DVom + jp1(DVom)
        gr = bc.extrap_south(cfg, gr, H)
        Dg = bc.extrap_south(cfg, Dg, H)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = bc.extrap_north(cfg, Dg, H + cfg.Mm)
        VFe = 0.25 * (vbar + jp1(vbar) - sixth * (gr + jp1(gr))) * \
            (DVom + jp1(DVom) - sixth * (Dg + jp1(Dg)))

        rhs_ubar = rhs_ubar - (UFx - im1(UFx)) - (jp1(UFe) - UFe)
        rhs_vbar = rhs_vbar - (ip1(VFx) - VFx) - (VFe - jm1(VFe))

    # --- Coriolis (:1288-1326) ---
    if cfg.uv_cor:
        cor = 0.5 * Drhs * grid.fomn
        UFxc = cor * (vbar + jp1(vbar))
        VFec = cor * (ubar + ip1(ubar))
        rhs_ubar = rhs_ubar + 0.5 * (UFxc + im1(UFxc))
        rhs_vbar = rhs_vbar - 0.5 * (VFec + jm1(VFec))

    # --- curvilinear metric advection terms (:1330-1403) ---
    if cfg.curvgrid and cfg.uv_adv:
        cff = 0.5 * (vbar + jp1(vbar)) * grid.dndx - \
            0.5 * (ubar + ip1(ubar)) * grid.dmde
        cffu = 0.5 * Drhs * cff * (ubar + ip1(ubar))
        cffv = 0.5 * Drhs * cff * (vbar + jp1(vbar))
        rhs_ubar = rhs_ubar + 0.5 * (cffv + im1(cffv))
        rhs_vbar = rhs_vbar - 0.5 * (cffu + jm1(cffu))

    # --- harmonic viscosity (:1405-1474) ---
    if cfg.uv_vis2 and cfg.visc2 != 0.0:
        pm, pn = grid.pm, grid.pn
        Drhs_p = at_p(Drhs)
        cff_r = cfg.visc2 * Drhs * 0.5 * (
            (pm / pn) * ((pn + ip1(pn)) * ip1(ubar) - (im1(pn) + pn) * ubar) -
            (pn / pm) * ((pm + jp1(pm)) * jp1(vbar) - (jm1(pm) + pm) * vbar))
        UFxv = grid.on_r * grid.on_r * cff_r
        VFev = grid.om_r * grid.om_r * cff_r

        sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
        sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
        cff_p = cfg.visc2 * Drhs_p * 0.5 * (
            (sum_pm / sum_pn) *
            ((jm1(pn) + pn) * vbar - (im1(jm1(pn)) + im1(pn)) * im1(vbar)) +
            (sum_pn / sum_pm) *
            ((im1(pm) + pm) * ubar - (im1(jm1(pm)) + jm1(pm)) * jm1(ubar)))
        cff_p = cff_p * grid.pmask
        if pmask_wet is not None:              # step2d_LF_AM3.h:1436-1439
            cff_p = cff_p * pmask_wet
        om_p = 4.0 / sum_pm
        on_p = 4.0 / sum_pn
        UFev = om_p * om_p * cff_p
        VFxv = on_p * on_p * cff_p

        rhs_ubar = rhs_ubar + \
            0.5 * (im1(pn) + pn) * (UFxv - im1(UFxv)) + \
            0.5 * (im1(pm) + pm) * (jp1(UFev) - UFev)
        rhs_vbar = rhs_vbar + \
            0.5 * (jm1(pn) + pn) * (ip1(VFxv) - VFxv) - \
            0.5 * (jm1(pm) + pm) * (VFev - jm1(VFev))

    # --- 2D momentum climatology nudging (step2d_LF_AM3.h:1822-1844
    #     LnudgeM2CLM): cff = avg(M2nudgcof)*cell area, times Drhs ---
    if clm is not None and "ubarclm" in clm:
        nud = clm.get("m2nudg", 0.0)
        cff_u = 0.25 * (im1(nud) + nud) * grid.om_u * grid.on_u \
            if hasattr(nud, "shape") else 0.5 * nud * grid.om_u * grid.on_u
        rhs_ubar = rhs_ubar + cff_u * (im1(Drhs) + Drhs) * \
            (clm["ubarclm"] - ubar)
        cff_v = 0.25 * (jm1(nud) + nud) * grid.om_v * grid.on_v \
            if hasattr(nud, "shape") else 0.5 * nud * grid.om_v * grid.on_v
        rhs_vbar = rhs_vbar + cff_v * (jm1(Drhs) + Drhs) * \
            (clm["vbarclm"] - vbar)

    # --- 2D-only mode: direct surface/bottom stress (the reference's
    # non-SOLVE3D branches; stresses enter via rufrc when SOLVE3D) ---
    if not cfg.solve3d:
        area_u = grid.om_u * grid.on_u
        area_v = grid.om_v * grid.on_v
        if forcing is not None and forcing.sustr is not None:
            rhs_ubar = rhs_ubar + forcing.sustr * area_u
        if forcing is not None and forcing.svstr is not None:
            rhs_vbar = rhs_vbar + forcing.svstr * area_v
        if cfg.bottom_drag == "linear":
            rhs_ubar = rhs_ubar - cfg.rdrg * ubar * area_u
            rhs_vbar = rhs_vbar - cfg.rdrg * vbar * area_v
        elif cfg.bottom_drag == "quadratic":
            vbar_at_u = 0.25 * (vbar + jp1(vbar) + im1(vbar) + im1(jp1(vbar)))
            ubar_at_v = 0.25 * (ubar + ip1(ubar) + jm1(ubar) + jm1(ip1(ubar)))
            rhs_ubar = rhs_ubar - cfg.rdrg2 * \
                jnp.sqrt(ubar * ubar + vbar_at_u * vbar_at_u) * ubar * area_u
            rhs_vbar = rhs_vbar - cfg.rdrg2 * \
                jnp.sqrt(ubar_at_v * ubar_at_v + vbar * vbar) * vbar * area_v

    return rhs_ubar, rhs_vbar


def _step_momentum(cfg: Config, grid: Grid, u_kstp, v_kstp, Dstp, Dnew,
                   dtau_u, dtau_v):
    """ubar(knew) = (ubar(kstp)*(Dstp_i+Dstp_{i-1}) + cff*dtau) /
    (Dnew_i+Dnew_{i-1}) with cff = (pm_i+pm_{i-1})*(pn_i+pn_{i-1})
    (step2d_LF_AM3.h:2093-2258); dtau_* are the time-combined RHS."""
    pm, pn = grid.pm, grid.pn
    ubar_new = (u_kstp * (Dstp + im1(Dstp)) +
                (pm + im1(pm)) * (pn + im1(pn)) * dtau_u) / \
        (Dnew + im1(Dnew))
    ubar_new = ubar_new * grid.umask
    vbar_new = (v_kstp * (Dstp + jm1(Dstp)) +
                (pm + jm1(pm)) * (pn + jm1(pn)) * dtau_v) / \
        (Dnew + jm1(Dnew))
    vbar_new = vbar_new * grid.vmask
    return ubar_new, vbar_new


def fast_loop(cfg: Config, grid: Grid, fs: Fast2DState,
              rufrc=None, rvfrc=None,
              ru0_nm1=None, ru0_nm2=None, rv0_nm1=None, rv0_nm2=None,
              iic: int | jax.Array = 0,
              forcing: Optional[Forcing2D] = None,
              bry=None, sources=None, clm=None, us2d=None):
    """Run the full fast loop of one slow step (SOLVE3D mode): nfast LF-AM3
    fast steps plus the auxiliary averaging step.

    rufrc/rvfrc are the depth-integrated slow RHS; on the first predictor
    they are converted to forcing increments with AB3-like extrapolation
    against the (ru0_nm1, ru0_nm2) history (step2d_LF_AM3.h:1868-1990); iic
    is the slow step counter (0-based from cold start) selecting the AB3
    startup weights.

    Returns (fs_out, rufrc_converted, rvfrc_converted, wet); the converted
    values are this step's ru(:,:,0,nstp) history entries.  wet is None
    unless cfg.wetdry, in which case it is a dict with the fast-time-
    averaged rmask_wet/umask_wet/vmask_wet for the slow 3-D kernels
    (wetdry.F wetdry_avg_mask_tile).
    """
    dtype = fs.zeta_n.dtype
    dtfast = jnp.asarray(cfg.dtfast, dtype=dtype)
    h = grid.h
    pmn = grid.pm * grid.pn
    w1, w2 = grid.weight1, grid.weight2
    nfast = cfg.nfast

    zero = jnp.zeros_like(fs.zeta_n)

    # BC wrappers: simple kinds via bc.*, open-boundary kinds via obc.*
    adv_z = bc.has_advanced(cfg.lbc_zeta)
    adv_u = bc.has_advanced(cfg.lbc_ubar)
    adv_v = bc.has_advanced(cfg.lbc_vbar)
    use_wd = cfg.wetdry

    def wmasks(z_kstp):
        """New wet/dry masks from zeta at the kstp level
        (step2d_LF_AM3.h:729 -> wetdry_tile)."""
        wd = wetdry.rho_wet(cfg, grid, z_kstp)
        um, vm = wetdry.face_masks(wd)
        return wd, um, vm, wetdry.psi_wet(wd)

    def zbc(z_new, z_know, dt2d_):
        z_new = bc.apply_bc_rho(cfg, cfg.lbc_zeta, z_new, mask=grid.rmask)
        if adv_z:
            z_new = obc.zetabc(cfg, grid, cfg.lbc_zeta, z_know, z_new,
                               dt2d_, bry)
            z_new = bc.fill_halo(cfg, z_new)
        if use_wd:
            z_new = wetdry.clamp_zeta(cfg, grid, z_new)
        return z_new

    frc_su = forcing.sustr if forcing is not None else None
    frc_sv = forcing.svstr if forcing is not None else None

    # Under shard_map the ubar/vbar/rzeta refreshes of a substep are
    # DEFERRED and fused into one multi-field exchange at the substep
    # end (mp_exchange.F packs up to 4 fields per message); zeta keeps
    # its immediate refresh (its halo feeds the same substep's
    # momentum).  Single-device behavior is unchanged.
    sharded = bc.current_ctx() is not None

    def ubc(u_new, u_know, z_know, dt2d_, z_new=None, v_know=None):
        u_new = bc.apply_bc_u(cfg, cfg.lbc_ubar, u_new,
                              gamma2=cfg.gamma2, mask=grid.umask,
                              fill=not sharded)
        if adv_u:
            u_new = obc.u2dbc(cfg, grid, cfg.lbc_ubar, u_know, u_new,
                              z_know, dt2d_, bry, z_kout=z_new,
                              vb_know=v_know, sustr=frc_su)
            if not sharded:
                u_new = bc.fill_halo(cfg, u_new)
        return u_new

    def vbc(v_new, v_know, z_know, dt2d_, z_new=None, u_know=None):
        v_new = bc.apply_bc_v(cfg, cfg.lbc_vbar, v_new,
                              gamma2=cfg.gamma2, mask=grid.vmask,
                              fill=not sharded)
        if adv_v:
            v_new = obc.v2dbc(cfg, grid, cfg.lbc_vbar, v_know, v_new,
                              z_know, dt2d_, bry, z_kout=z_new,
                              ub_know=u_know, svstr=frc_sv)
            if not sharded:
                v_new = bc.fill_halo(cfg, v_new)
        return v_new

    def srcs(u_new, v_new, z_new):
        if cfg.volcons:
            u_new, v_new = obc.obc_volcons(cfg, grid, u_new, v_new,
                                           z_new, set(cfg.volcons))
            if not sharded:
                u_new = bc.fill_halo(cfg, u_new)
                v_new = bc.fill_halo(cfg, v_new)
        if sources is None:
            return u_new, v_new
        from .sources import apply_ubar_sources
        u_new, v_new = apply_ubar_sources(sources, u_new, v_new, z_new,
                                          grid.h, grid.on_u, grid.om_v)
        if sharded:
            return u_new, v_new
        return bc.fill_halo(cfg, u_new), bc.fill_halo(cfg, v_new)

    if rufrc is None:
        rufrc = zero
        rvfrc = zero
        ru0_nm1 = ru0_nm2 = rv0_nm1 = rv0_nm2 = zero

    # ================= fast step 1 (peeled: FE predictor) =================
    if use_wd:                 # FIRST_2D_STEP predictor: kstp = n
        wd_p, um_w, vm_w, pw_w = wmasks(fs.zeta_n)
        wet_avg = wd_p         # rmask_wet_avg := wetdry (wetdry.F:222-228)
    else:
        um_w = vm_w = pw_w = wet_avg = None
    Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n,
                                    fs.vbar_n, us2d=us2d)
    # averaging reset (:611-634); weight(2,iif+1) with iif=1 -> w2[1]
    cff2 = (-1.0 / 12.0) * w2[1]
    fs = fs.replace(Zt_avg1=zero, DU_avg1=zero, DV_avg1=zero,
                    DU_avg2=cff2 * DUon, DV_avg2=cff2 * DVom)

    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    zeta_new = (fs.zeta_n + pmn * dtfast * rhs_zeta) * grid.rmask
    Dnew = zeta_new + h
    zwrk = 0.5 * (fs.zeta_n + zeta_new)
    zeta_p = zbc(zeta_new, fs.zeta_n, dtfast)

    rhs_ubar, rhs_vbar = _rhs_momentum(
        cfg, grid, fs.zeta_n, fs.ubar_n, fs.vbar_n,
        Drhs, DUon, DVom, zwrk, zwrk * zwrk, forcing, pmask_wet=pw_w,
        clm=clm)

    # --- 2D-3D coupling on the first predictor (:1868-1990) ---
    iic = jnp.asarray(iic)
    rufrc_c = rufrc - rhs_ubar
    rvfrc_c = rvfrc - rhs_vbar
    w_now = jnp.where(iic == 0, 1.0,
                      jnp.where(iic == 1, 1.5, 23.0 / 12.0)).astype(dtype)
    w_m1 = jnp.where(iic == 0, 0.0,
                     jnp.where(iic == 1, 0.5, 16.0 / 12.0)).astype(dtype)
    w_m2 = jnp.where(iic <= 1, 0.0, 5.0 / 12.0).astype(dtype)
    rhs_ubar = rhs_ubar + w_now * rufrc_c - w_m1 * ru0_nm1 + w_m2 * ru0_nm2
    rhs_vbar = rhs_vbar + w_now * rvfrc_c - w_m1 * rv0_nm1 + w_m2 * rv0_nm2

    # momentum FE step (:2104-2140): cff1 = 0.5*dtfast
    ubar_p, vbar_p = _step_momentum(
        cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
        0.5 * dtfast * rhs_ubar, 0.5 * dtfast * rhs_vbar)
    if use_wd:
        # directional limiter on the new velocity, the stored rhs, and
        # (first predictor only) the coupling forcing
        # (step2d_LF_AM3.h:2123-2146)
        c7u = wetdry.limit(um_w, ubar_p)
        c7v = wetdry.limit(vm_w, vbar_p)
        ubar_p = ubar_p * c7u
        vbar_p = vbar_p * c7v
        rhs_ubar = rhs_ubar * c7u
        rhs_vbar = rhs_vbar * c7v
        rufrc_c = rufrc_c * c7u
        rvfrc_c = rvfrc_c * c7v
    ubar_p = ubc(ubar_p, fs.ubar_n, fs.zeta_n, dtfast,
                 z_new=zeta_p, v_know=fs.vbar_n)
    vbar_p = vbc(vbar_p, fs.vbar_n, fs.zeta_n, dtfast,
                 z_new=zeta_p, u_know=fs.ubar_n)
    if use_wd:
        # boundary points get the limiter inside u2dbc/v2dbc in the
        # reference (u2dbc_im.F:1187-1234); idempotent on the interior
        ubar_p = ubar_p * wetdry.limit(um_w, ubar_p)
        vbar_p = vbar_p * wetdry.limit(vm_w, vbar_p)
    ubar_p, vbar_p = srcs(ubar_p, vbar_p, zeta_p)
    if sharded:
        ubar_p, vbar_p, rhs_zeta = bc.fill_halo_multi(
            cfg, ubar_p, vbar_p, rhs_zeta)
        fs = fs.replace(
            rzeta_nm1=fs.rzeta_n, rzeta_n=rhs_zeta,
            rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
            rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)
    else:
        fs = fs.replace(
            rzeta_nm1=fs.rzeta_n, rzeta_n=bc.fill_halo(cfg, rhs_zeta),
            rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
            rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)

    def corrector(i, fs, zeta_p, ubar_p, vbar_p, first: bool, wet_avg):
        if use_wd:             # corrector: kstp = n -> masks from zeta_n
            wd_c, um_c, vm_c, pw_c = wmasks(fs.zeta_n)
            wet_avg = wet_avg + wd_c
        else:
            um_c = vm_c = pw_c = None
        Drhs, DUon, DVom = depth_fluxes(grid, zeta_p, ubar_p, vbar_p,
                                        us2d=us2d)
        # averaging, corrector branch (:688-713): weight(2,iif) -> w2[i-1]
        cff2 = w2[i - 1] if first else (5.0 / 12.0) * w2[i - 1]
        fs = fs.replace(DU_avg2=fs.DU_avg2 + cff2 * DUon,
                        DV_avg2=fs.DV_avg2 + cff2 * DVom)

        rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
        c1 = dtfast * 5.0 / 12.0
        c2 = dtfast * 8.0 / 12.0
        c3 = dtfast * 1.0 / 12.0
        zeta_new = (fs.zeta_n + pmn * (c1 * rhs_zeta + c2 * fs.rzeta_n -
                                       c3 * fs.rzeta_nm1)) * grid.rmask
        Dnew = zeta_new + h
        cff4 = 2.0 / 5.0
        zwrk = (1.0 - cff4) * zeta_new + cff4 * zeta_p
        zeta_new = zbc(zeta_new, fs.zeta_n, dtfast)

        rhs_ubar, rhs_vbar = _rhs_momentum(
            cfg, grid, zeta_p, ubar_p, vbar_p,
            Drhs, DUon, DVom, zwrk, zwrk * zwrk, forcing, pmask_wet=pw_c,
            clm=clm)
        if cfg.solve3d:
            rhs_ubar = rhs_ubar + rufrc_c
            rhs_vbar = rhs_vbar + rvfrc_c

        cm1 = 0.5 * dtfast * 5.0 / 12.0
        cm2 = 0.5 * dtfast * 8.0 / 12.0
        cm3 = 0.5 * dtfast * 1.0 / 12.0
        ubar_new, vbar_new = _step_momentum(
            cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
            cm1 * rhs_ubar + cm2 * fs.rubar_n - cm3 * fs.rubar_nm1,
            cm1 * rhs_vbar + cm2 * fs.rvbar_n - cm3 * fs.rvbar_nm1)
        if use_wd:
            ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
            vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
        ubar_new = ubc(ubar_new, fs.ubar_n, fs.zeta_n, dtfast,
                       z_new=zeta_new, v_know=fs.vbar_n)
        vbar_new = vbc(vbar_new, fs.vbar_n, fs.zeta_n, dtfast,
                       z_new=zeta_new, u_know=fs.ubar_n)
        if use_wd:
            ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
            vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
        ubar_new, vbar_new = srcs(ubar_new, vbar_new, zeta_new)
        if sharded:
            ubar_new, vbar_new = bc.fill_halo_multi(cfg, ubar_new,
                                                    vbar_new)
        return fs.replace(
            zeta_nm1=fs.zeta_n, zeta_n=zeta_new,
            ubar_nm1=fs.ubar_n, ubar_n=ubar_new,
            vbar_nm1=fs.vbar_n, vbar_n=vbar_new), wet_avg

    fs, wet_avg = corrector(1, fs, zeta_p, ubar_p, vbar_p, True, wet_avg)

    # ============== fast steps 2..nfast (LF / AM3), fori_loop ==============
    def fused_body(i, carry):
        fs, wet_avg = carry
        if use_wd:             # LF predictor: kstp = n-1
            wd_p2, um_p, vm_p, pw_p = wmasks(fs.zeta_nm1)
            wet_avg = wet_avg + wd_p2
        else:
            um_p = vm_p = pw_p = None
        Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n,
                                        fs.vbar_n, us2d=us2d)
        cff1 = w1[i - 2]                                  # weight(1,iif-1)
        cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
        if us2d is not None:
            # DU_avg1 is the EULERIAN fast-averaged transport: the 3-D
            # corrector replaces the Eulerian vertical mean only
            # (step2d_LF_AM3.h:645-655)
            du1, dv1 = DUon - us2d[0], DVom - us2d[1]
        else:
            du1, dv1 = DUon, DVom
        fs = fs.replace(
            Zt_avg1=fs.Zt_avg1 + cff1 * fs.zeta_n,
            DU_avg1=fs.DU_avg1 + cff1 * du1,
            DV_avg1=fs.DV_avg1 + cff1 * dv1,
            DU_avg2=fs.DU_avg2 + cff2 * DUon,
            DV_avg2=fs.DV_avg2 + cff2 * DVom)

        rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
        zeta_new = (fs.zeta_nm1 + pmn * (2.0 * dtfast) * rhs_zeta) * \
            grid.rmask
        Dnew = zeta_new + h
        cff4 = 4.0 / 25.0
        cff5 = 1.0 - 2.0 * cff4
        zwrk = cff5 * fs.zeta_n + cff4 * (fs.zeta_nm1 + zeta_new)
        zeta_p = zbc(zeta_new, fs.zeta_n, 2.0 * dtfast)

        rhs_ubar, rhs_vbar = _rhs_momentum(
            cfg, grid, fs.zeta_n, fs.ubar_n, fs.vbar_n,
            Drhs, DUon, DVom, zwrk, zwrk * zwrk, forcing, pmask_wet=pw_p,
            clm=clm)
        if cfg.solve3d:
            rhs_ubar = rhs_ubar + rufrc_c
            rhs_vbar = rhs_vbar + rvfrc_c

        ubar_p, vbar_p = _step_momentum(
            cfg, grid, fs.ubar_nm1, fs.vbar_nm1, fs.zeta_nm1 + h, Dnew,
            dtfast * rhs_ubar, dtfast * rhs_vbar)
        if use_wd:
            c7u = wetdry.limit(um_p, ubar_p)
            c7v = wetdry.limit(vm_p, vbar_p)
            ubar_p = ubar_p * c7u
            vbar_p = vbar_p * c7v
            rhs_ubar = rhs_ubar * c7u
            rhs_vbar = rhs_vbar * c7v
        ubar_p = ubc(ubar_p, fs.ubar_n, fs.zeta_n, 2.0 * dtfast,
                     z_new=zeta_p, v_know=fs.vbar_n)
        vbar_p = vbc(vbar_p, fs.vbar_n, fs.zeta_n, 2.0 * dtfast,
                     z_new=zeta_p, u_know=fs.ubar_n)
        if use_wd:
            ubar_p = ubar_p * wetdry.limit(um_p, ubar_p)
            vbar_p = vbar_p * wetdry.limit(vm_p, vbar_p)
        ubar_p, vbar_p = srcs(ubar_p, vbar_p, zeta_p)
        if sharded:
            ubar_p, vbar_p, rhs_zeta = bc.fill_halo_multi(
                cfg, ubar_p, vbar_p, rhs_zeta)
            fs = fs.replace(
                rzeta_nm1=fs.rzeta_n, rzeta_n=rhs_zeta,
                rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
                rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)
        else:
            fs = fs.replace(
                rzeta_nm1=fs.rzeta_n,
                rzeta_n=bc.fill_halo(cfg, rhs_zeta),
                rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
                rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)
        return corrector(i, fs, zeta_p, ubar_p, vbar_p, False, wet_avg)

    if nfast >= 2:
        fs, wet_avg = jax.lax.fori_loop(2, nfast + 1, fused_body,
                                        (fs, wet_avg))

    # ========== auxiliary predictor (iif = nfast+1): averages only ==========
    Drhs_a, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n,
                                      fs.vbar_n, us2d=us2d)
    i = nfast + 1
    cff1 = w1[i - 2]
    cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
    if us2d is not None:
        du1, dv1 = DUon - us2d[0], DVom - us2d[1]
    else:
        du1, dv1 = DUon, DVom
    if sharded:
        zt, du1f, dv1f, du2f, dv2f = bc.fill_halo_multi(
            cfg, fs.Zt_avg1 + cff1 * fs.zeta_n, fs.DU_avg1 + cff1 * du1,
            fs.DV_avg1 + cff1 * dv1, fs.DU_avg2 + cff2 * DUon,
            fs.DV_avg2 + cff2 * DVom)
        fs = fs.replace(Zt_avg1=zt, DU_avg1=du1f, DV_avg1=dv1f,
                        DU_avg2=du2f, DV_avg2=dv2f)
    else:
        fs = fs.replace(
            Zt_avg1=bc.fill_halo(cfg, fs.Zt_avg1 + cff1 * fs.zeta_n),
            DU_avg1=bc.fill_halo(cfg, fs.DU_avg1 + cff1 * du1),
            DV_avg1=bc.fill_halo(cfg, fs.DV_avg1 + cff1 * dv1),
            DU_avg2=bc.fill_halo(cfg, fs.DU_avg2 + cff2 * DUon),
            DV_avg2=bc.fill_halo(cfg, fs.DV_avg2 + cff2 * DVom))

    # --- time-averaged wet masks for the 3-D kernels (aux wetdry_tile
    #     call, wetdry.F:253-271): wet only if wet at ALL 2*nfast
    #     substeps, direction from the sign of the averaged transport ---
    wet = None
    if use_wd:
        wd_avg = jnp.floor(wet_avg / (2.0 * nfast))
        um_avg, vm_avg = wetdry.avg_face_masks(wd_avg, fs.DU_avg1,
                                               fs.DV_avg1)
        wet = {"rmask_wet": bc.fill_halo(cfg, wd_avg),
               "umask_wet": bc.fill_halo(cfg, um_avg),
               "vmask_wet": bc.fill_halo(cfg, vm_avg)}
    return fs, rufrc_c, rvfrc_c, wet


def step_2d_only(cfg: Config, grid: Grid, fs: Fast2DState, first: bool,
                 forcing: Optional[Forcing2D] = None,
                 bry=None, sources=None, clm=None) -> Fast2DState:
    """One model step in 2D-only (main2d) mode: a single predictor/corrector
    pair; LF/AM3 history carries across steps.  `first` selects the FE
    predictor used at the very first step of a run (iic == ntfirst)."""
    dtype = fs.zeta_n.dtype
    dtfast = jnp.asarray(cfg.dtfast, dtype=dtype)
    h = grid.h
    pmn = grid.pm * grid.pn

    adv_z = bc.has_advanced(cfg.lbc_zeta)
    adv_u = bc.has_advanced(cfg.lbc_ubar)
    adv_v = bc.has_advanced(cfg.lbc_vbar)
    use_wd = cfg.wetdry

    def wmasks(z_kstp):
        wd = wetdry.rho_wet(cfg, grid, z_kstp)
        um, vm = wetdry.face_masks(wd)
        return wd, um, vm, wetdry.psi_wet(wd)

    def zbc(z_new, z_know, dt2d_):
        z_new = bc.apply_bc_rho(cfg, cfg.lbc_zeta, z_new, mask=grid.rmask)
        if adv_z:
            z_new = obc.zetabc(cfg, grid, cfg.lbc_zeta, z_know, z_new,
                               dt2d_, bry)
            z_new = bc.fill_halo(cfg, z_new)
        if use_wd:
            z_new = wetdry.clamp_zeta(cfg, grid, z_new)
        return z_new

    def ubc(u_new, u_know, z_know, dt2d_, z_new=None, v_know=None):
        u_new = bc.apply_bc_u(cfg, cfg.lbc_ubar, u_new,
                              gamma2=cfg.gamma2, mask=grid.umask)
        if adv_u:
            u_new = obc.u2dbc(cfg, grid, cfg.lbc_ubar, u_know, u_new,
                              z_know, dt2d_, bry, z_kout=z_new,
                              vb_know=v_know,
                              sustr=forcing.sustr if forcing else None)
            u_new = bc.fill_halo(cfg, u_new)
        return u_new

    def vbc(v_new, v_know, z_know, dt2d_, z_new=None, u_know=None):
        v_new = bc.apply_bc_v(cfg, cfg.lbc_vbar, v_new,
                              gamma2=cfg.gamma2, mask=grid.vmask)
        if adv_v:
            v_new = obc.v2dbc(cfg, grid, cfg.lbc_vbar, v_know, v_new,
                              z_know, dt2d_, bry, z_kout=z_new,
                              ub_know=u_know,
                              svstr=forcing.svstr if forcing else None)
            v_new = bc.fill_halo(cfg, v_new)
        return v_new

    def srcs(u_new, v_new, z_new):
        if cfg.volcons:
            u_new, v_new = obc.obc_volcons(cfg, grid, u_new, v_new,
                                           z_new, set(cfg.volcons))
            u_new = bc.fill_halo(cfg, u_new)
            v_new = bc.fill_halo(cfg, v_new)
        if sources is None:
            return u_new, v_new
        from .sources import apply_ubar_sources
        u_new, v_new = apply_ubar_sources(sources, u_new, v_new, z_new,
                                          grid.h, grid.on_u, grid.om_v)
        return bc.fill_halo(cfg, u_new), bc.fill_halo(cfg, v_new)

    # --- predictor ---
    Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n)
    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    if first:
        z_kstp, u_kstp, v_kstp = fs.zeta_n, fs.ubar_n, fs.vbar_n
        cz, cm = dtfast, 0.5 * dtfast
    else:
        z_kstp, u_kstp, v_kstp = fs.zeta_nm1, fs.ubar_nm1, fs.vbar_nm1
        cz, cm = 2.0 * dtfast, dtfast
    zeta_new = (z_kstp + pmn * cz * rhs_zeta) * grid.rmask
    Dnew = zeta_new + h
    if first:
        zwrk = 0.5 * (z_kstp + zeta_new)
    else:
        cff4 = 4.0 / 25.0
        zwrk = (1.0 - 2.0 * cff4) * fs.zeta_n + cff4 * (z_kstp + zeta_new)
    zeta_p = bc.apply_bc_rho(cfg, cfg.lbc_zeta, zeta_new, mask=grid.rmask)
    if use_wd:
        wd_p, um_p, vm_p, pw_p = wmasks(z_kstp)
        zeta_p = wetdry.clamp_zeta(cfg, grid, zeta_p)
    else:
        um_p = vm_p = pw_p = None

    rhs_ubar, rhs_vbar = _rhs_momentum(
        cfg, grid, fs.zeta_n, fs.ubar_n, fs.vbar_n,
        Drhs, DUon, DVom, zwrk, zwrk * zwrk, forcing, pmask_wet=pw_p,
        clm=clm)
    ubar_p, vbar_p = _step_momentum(
        cfg, grid, u_kstp, v_kstp, z_kstp + h, Dnew,
        cm * rhs_ubar, cm * rhs_vbar)
    if use_wd:
        c7u = wetdry.limit(um_p, ubar_p)
        c7v = wetdry.limit(vm_p, vbar_p)
        ubar_p = ubar_p * c7u
        vbar_p = vbar_p * c7v
        rhs_ubar = rhs_ubar * c7u
        rhs_vbar = rhs_vbar * c7v
    ubar_p = ubc(ubar_p, fs.ubar_n, fs.zeta_n, dtfast,
                 z_new=zeta_p, v_know=fs.vbar_n)
    vbar_p = vbc(vbar_p, fs.vbar_n, fs.zeta_n, dtfast,
                 z_new=zeta_p, u_know=fs.ubar_n)
    if use_wd:
        ubar_p = ubar_p * wetdry.limit(um_p, ubar_p)
        vbar_p = vbar_p * wetdry.limit(vm_p, vbar_p)
    ubar_p, vbar_p = srcs(ubar_p, vbar_p, zeta_p)
    fs = fs.replace(
        rzeta_nm1=fs.rzeta_n, rzeta_n=bc.fill_halo(cfg, rhs_zeta),
        rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
        rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)

    # --- corrector (AM3) ---
    Drhs, DUon, DVom = depth_fluxes(grid, zeta_p, ubar_p, vbar_p)
    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    c1 = dtfast * 5.0 / 12.0
    c2 = dtfast * 8.0 / 12.0
    c3 = dtfast * 1.0 / 12.0
    zeta_new = (fs.zeta_n + pmn * (c1 * rhs_zeta + c2 * fs.rzeta_n -
                                   c3 * fs.rzeta_nm1)) * grid.rmask
    Dnew = zeta_new + h
    cff4 = 2.0 / 5.0
    zwrk = (1.0 - cff4) * zeta_new + cff4 * zeta_p
    zeta_new = zbc(zeta_new, fs.zeta_n, dtfast)

    if use_wd:
        wd_c, um_c, vm_c, pw_c = wmasks(fs.zeta_n)
    else:
        um_c = vm_c = pw_c = None
    rhs_ubar, rhs_vbar = _rhs_momentum(
        cfg, grid, zeta_p, ubar_p, vbar_p,
        Drhs, DUon, DVom, zwrk, zwrk * zwrk, forcing, pmask_wet=pw_c,
        clm=clm)
    cm1 = 0.5 * dtfast * 5.0 / 12.0
    cm2 = 0.5 * dtfast * 8.0 / 12.0
    cm3 = 0.5 * dtfast * 1.0 / 12.0
    ubar_new, vbar_new = _step_momentum(
        cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
        cm1 * rhs_ubar + cm2 * fs.rubar_n - cm3 * fs.rubar_nm1,
        cm1 * rhs_vbar + cm2 * fs.rvbar_n - cm3 * fs.rvbar_nm1)
    if use_wd:
        ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
        vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
    ubar_new = ubc(ubar_new, fs.ubar_n, fs.zeta_n, dtfast,
                   z_new=zeta_new, v_know=fs.vbar_n)
    vbar_new = vbc(vbar_new, fs.vbar_n, fs.zeta_n, dtfast,
                   z_new=zeta_new, u_know=fs.ubar_n)
    if use_wd:
        ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
        vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
    ubar_new, vbar_new = srcs(ubar_new, vbar_new, zeta_new)
    return fs.replace(
        zeta_nm1=fs.zeta_n, zeta_n=zeta_new,
        ubar_nm1=fs.ubar_n, ubar_n=ubar_new,
        vbar_nm1=fs.vbar_n, vbar_n=vbar_new)
