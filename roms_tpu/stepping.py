"""Baroclinic time-step orchestrator.

Functional re-implementation of the reference's main3d step loop
(ROMS/Nonlinear/main3d.F:183-868): one call advances the full State by one
slow step (including the nfast-substep barotropic engine).  The call order
mirrors main3d exactly; all stage kernels live in roms_tpu/ops/.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .config import Config
from .grid import Grid, hc_of
from .state import State
from . import vgrid
from .ops import bc, eos, prsgrd, vmix
from .ops.omega import set_massflux, omega
from .ops.vbc import set_vbc
from .ops.pre_step3d import pre_step3d
from .ops.rhs3d import rhs3d_momentum
from .ops.mix3d import (uv3dmix2, t3dmix2, uv3dmix4, t3dmix4,
                        t3dmix2_geo, t3dmix4_geo, t3dmix2_iso,
                        t3dmix4_iso, uv3dmix2_geo, uv3dmix4_geo)
from .ops.step2d import Fast2DState, fast_loop
from .ops.step3d_uv import step3d_uv
from .ops.step3d_t import step3d_t


def step(cfg: Config, grid: Grid, state: State,
         forcing_fn: Optional[Callable] = None,
         collect_diags: bool = False):
    """One slow (baroclinic) step.  forcing_fn(cfg, grid, time) returns a
    dict with sustr, svstr (kinematic wind stress, m2/s2) and stflux,
    btflux ((NT,Ny,Nx) surface/bottom tracer fluxes); the analytic-forcing
    analog of get_data/set_data + ana_smflux/ana_stflux.

    collect_diags (DIAGNOSTICS_TS + DIAGNOSTICS_UV; mod_diags.F
    DiaTrc/DiaRU/DiaRV): additionally return the per-step budget dict.
    Tracer keys xadv/yadv/vadv/vdiff (from step3d_t), hdiff (t3dmix),
    rate (total t change) - concentration increments per step.  Momentum
    keys u_/v_ x {prestep, prsgrd, cor, xadv, yadv, vadv, hvisc, vvisc,
    rate} - velocity increments per step (m/s) at u/v points, with exact
    closure rate = sum(terms).  Deltas vs the reference's accumulation
    (documented): terms use the current-step AB3-weighted rhs (the
    reference spreads each physical term over its 3-step AB3 history);
    pre_step3d's LF/AM3 predictor contribution is one explicit "prestep"
    bucket; "vvisc" is the closure remainder (implicit vertical
    viscosity + barotropic-mean replacement + lateral BCs + masking +
    clm nudging), the reference's M3vvis analog."""
    hc = hc_of(cfg)
    dtype = state.zeta.dtype
    zero2 = jnp.zeros_like(state.zeta)

    # --- forcing (main3d.F:207-222) ---
    if forcing_fn is not None:
        with jax.named_scope("forcing"):
            frc = forcing_fn(cfg, grid, state.time)
    else:
        frc = {}
    nt = max(cfg.ntracers, 1)
    if cfg.bulk_fluxes:
        # COARE air-sea fluxes from atmospheric state + SST (main3d.F:386)
        from .ops import bulk_flux as bfx
        srflx0 = frc.get("srflx", zero2)
        with jax.named_scope("bulk_flux"):
            blk = bfx.bulk_flux(
                cfg, grid, state.t[0, -1], srflx0,
                frc.get("Uwind", zero2), frc.get("Vwind", zero2),
                frc.get("Tair", zero2), frc.get("Pair", zero2 + 1013.0),
                frc.get("Hair", zero2), frc.get("cloud", zero2),
                frc.get("rain", zero2))
        sustr = blk["sustr"]
        svstr = blk["svstr"]
        stflux = jnp.concatenate(
            [blk["stflux_temp"][None],
             jnp.zeros((nt - 1,) + zero2.shape, dtype)], axis=0)
        btflux = frc.get("btflux", jnp.zeros((nt,) + zero2.shape, dtype))
        frc = dict(frc)
        frc["srflx"] = srflx0
    else:
        sustr = frc.get("sustr", zero2)
        svstr = frc.get("svstr", zero2)
        stflux = frc.get("stflux", jnp.zeros((nt,) + zero2.shape, dtype))
        btflux = frc.get("btflux", jnp.zeros((nt,) + zero2.shape, dtype))

    # --- ICESHELF (set_vbc.F:380-510): under the ice shelf the surface
    #     heat/salt/shortwave fluxes vanish and the wind stress is
    #     replaced by the ice-base drag on the TOP model layer (same
    #     drag law as the sea bed) ---
    if grid.zice is not None:
        from .ops.stencil import im1 as _im1, jm1 as _jm1, \
            ip1 as _ip1, jp1 as _jp1
        icy = jnp.abs(grid.zice) > 0.0
        icy_u = icy & _im1(icy)
        icy_v = icy & _jm1(icy)
        uN = state.u[-1]
        vN = state.v[-1]
        v_at_u = 0.25 * (vN + _jp1(vN) + _im1(vN) + _im1(_jp1(vN)))
        u_at_v = 0.25 * (uN + _ip1(uN) + _jm1(uN) + _jm1(_ip1(uN)))
        if cfg.bottom_drag == "linear":
            tau_iu = -cfg.rdrg * uN
            tau_iv = -cfg.rdrg * vN
        else:
            tau_iu = -cfg.rdrg2 * uN * jnp.sqrt(uN ** 2 + v_at_u ** 2)
            tau_iv = -cfg.rdrg2 * vN * jnp.sqrt(vN ** 2 + u_at_v ** 2)
        sustr = jnp.where(icy_u, tau_iu, sustr)
        svstr = jnp.where(icy_v, tau_iv, svstr)
        stflux = jnp.where(icy[None], 0.0, stflux)
        if "srflx" in frc and frc["srflx"] is not None:
            frc = dict(frc)
            frc["srflx"] = jnp.where(icy, 0.0, frc["srflx"])

    # --- SED_MORPH: bed-thickness change feeds back into h (set_depth.F
    #     :166,214; deposition shoals the column).  grid.h is the virgin
    #     bathymetry; the offset is the departure of the evolving bed
    #     from the cfg-defined initial bed. ---
    if (cfg.sediment and cfg.sed_params is not None
            and cfg.sed_params.sed_morph):
        from .ops.sediment import bed_thickness_total
        from .state import _initial_bed_mass
        p_sed = cfg.sed_params
        thick0 = bed_thickness_total(
            p_sed, _initial_bed_mass(cfg, grid.h.shape, grid.h.dtype))
        dh_bed = bed_thickness_total(p_sed, state.bed_mass) - thick0
        grid = grid.replace(h=grid.h - dh_bed)

    # --- vertical grid and mass fluxes at time n (main3d.F:307) ---
    with jax.named_scope("diag"):
        z_r, z_w, Hz = vgrid.set_depth(grid.h, state.zeta, hc,
                                       grid.sc_r, grid.Cs_r, grid.sc_w,
                                       grid.Cs_w, cfg.vtransform,
                                       zice=grid.zice)
        Huon, Hvom = set_massflux(cfg, grid, state.u, state.v, Hz)

        # --- density (main3d.F:314) ---
        rho, pden = eos.rho_eos_pden(cfg, state.t, z_r)

    # --- wave radiation stresses + Stokes drift (main3d's
    #     radiation_stress call; ops/nearshore.py Mellor05) ---
    ns = None
    if cfg.nearshore in ("mellor05", "mellor08") and "Hwave" in frc:
        if cfg.nearshore == "mellor08":
            from .ops.nearshore import radiation_stress08
            ns = radiation_stress08(
                cfg, grid, state.zeta, Hz, z_r, grid.Cs_r, grid.Cs_w,
                frc["Hwave"], frc.get("Dwave", zero2),
                frc.get("Lwave", zero2 + 100.0))
        else:
            from .ops.nearshore import radiation_stress
            ns = radiation_stress(
                cfg, grid, state.zeta, Hz, grid.Cs_r, grid.Cs_w,
                frc["Hwave"], frc.get("Dwave", zero2),
                frc.get("Lwave", zero2 + 100.0))
        # Stokes transport enters every advective mass flux
        # (set_massflux.F:140-160)
        Huon = Huon + 0.5 * (Hz + jnp.roll(Hz, 1, -1)) * ns.u_stokes * \
            grid.on_u
        Hvom = Hvom + 0.5 * (Hz + jnp.roll(Hz, 1, -2)) * ns.v_stokes * \
            grid.om_v

    # --- surface/bottom fluxes (main3d.F:386-396) ---
    with jax.named_scope("set_vbc"):
        bustr, bvstr, stflx, btflx = set_vbc(cfg, grid, state.u, state.v,
                                             state.t, stflux, btflux,
                                             z_r=z_r, z_w=z_w)
    srflx = frc.get("srflx", None)

    # --- wave-current bottom boundary layer (main3d.F:389 bblm):
    #     replaces the drag-law bottom stress and provides the max
    #     combined stress for sediment resuspension ---
    rheight, rlength, tau_cwmax = (state.rheight, state.rlength,
                                   state.tau_cwmax)
    if cfg.bbl == "ssw":
        from .ops.bbl import bblm, BBLParams
        bp = cfg.bbl_params or BBLParams()
        zero2f = jnp.zeros_like(grid.h)
        bustr, bvstr, tau_c_b, tau_w_b, tau_cwmax, rheight, rlength = bblm(
            cfg, grid, bp, state.u, state.v, z_r, z_w,
            frc.get("Hwave", zero2f),
            frc.get("Pwave", zero2f + 8.0),
            frc.get("Dwave", zero2f),
            state.rheight, state.rlength, state.tau_cwmax)
    elif cfg.bbl == "sg":
        from .ops.bbl import bblm_sg, SGBBLParams
        bp = cfg.bbl_params or SGBBLParams()
        zero2f = jnp.zeros_like(grid.h)
        bustr, bvstr, tau_c_b, tau_w_b, tau_cwmax, rheight, rlength = bblm_sg(
            cfg, grid, bp, state.u, state.v, z_r, z_w, rho[0],
            frc.get("Hwave", zero2f),
            frc.get("Pwave", zero2f + 8.0),
            frc.get("Dwave", zero2f))
    elif cfg.bbl == "mb":
        from .ops.bbl import bblm_mb, MBBBLParams
        bp = cfg.bbl_params or MBBBLParams()
        zero2f = jnp.zeros_like(grid.h)
        bustr, bvstr, tau_c_b, tau_w_b, tau_cwmax, rheight, rlength = bblm_mb(
            cfg, grid, bp, state.u, state.v, z_r, z_w, rho[0],
            frc.get("Hwave", zero2f),
            frc.get("Pwave", zero2f + 8.0),
            frc.get("Dwave", zero2f),
            state.rheight, state.rlength)

    # --- vertical mixing coefficients (main3d.F:465-469) ---
    hsbl = state.hsbl
    hbbl = state.hbbl
    ghats = None
    swdk_w = None
    if cfg.vmix == "kpp":
        with jax.named_scope("diag"):
            bvf = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
        srf = srflx if srflx is not None else zero2
        with jax.named_scope("kpp"):
            Akv, Akt, hsbl, hbbl, ghats = vmix.lmd_vmix(
                cfg, grid, state.u, state.v, state.t, rho, pden, bvf,
                Hz, z_r, z_w, sustr, svstr, bustr, bvstr, stflx, srf,
                hsbl, btflx=btflx, hbbl_prev=hbbl)
            if srflx is not None:
                swdk_w = vmix.swfrac(z_w[-1][None] - z_w)
    elif cfg.vmix == "bvf":
        with jax.named_scope("diag"):
            bvf = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
        Akv, Akt = vmix.bvf_mix(cfg, bvf)
    else:
        # "gls" keeps last step's coefficients here; gls_corstep updates
        # them after the momentum corrector (main3d.F:791)
        Akv, Akt = state.Akv, state.Akt

    # --- omega at time n (main3d.F:474) ---
    with jax.named_scope("diag"):
        W = omega(cfg, grid, Huon, Hvom, z_w)

    # --- rhs3d phase (main3d.F:563): pre_step3d, prsgrd, t3dmix, rhs,
    #     uv3dmix ---
    clm = frc.get("clm", None)
    bry = frc.get("bry", None)
    sources = frc.get("sources", None)
    with jax.named_scope("pre_step3d"):
        t3, t_nnew, u_nnew, v_nnew = pre_step3d(
            cfg, grid, state.iic, state.t, state.t_prev, state.u,
            state.v, Hz, z_r, Huon, Hvom, W, Akt,
            sustr, svstr, bustr, bvstr, stflx, btflx,
            state.ru_prev, state.ru_prev2, state.rv_prev,
            state.rv_prev2, srflx=srflx, ghats=ghats, swdk_w=swdk_w,
            sources=sources)

    eq_tide = None
    if cfg.tide_gen_forces:
        # equilibrium-tide body force (main3d.F equilibrium_tide call)
        from .ops.tides import equilibrium_tide, harmonic_constituents
        hcon = harmonic_constituents(cfg.tide_ref_datenum)
        eq_tide = equilibrium_tide(grid, state.time, hcon)
    if grid.zice is not None:
        # floating-ice load: the water pressure at the ice base carries
        # the weight of the displaced water column, i.e. P_top gains
        # g*|zice|*(1 + rho'/rho0) with rho' evaluated just below the
        # ice base (reduced-pressure form of the reference's ICESHELF
        # set_depth shift; enters through the eq_tide surface-pressure
        # slot).  Using the top-cell density for the draft-mean rho'
        # leaves only an O(drho'/draft) residual.
        ice_load = -jnp.abs(grid.zice) * (1.0 + rho[-1] / cfg.rho0)
        eq_tide = ice_load if eq_tide is None else eq_tide + ice_load
    with jax.named_scope("prsgrd"):
        ru, rv = prsgrd.prsgrd(cfg, grid, rho, z_r, z_w, Hz,
                               eq_tide=eq_tide)

    t_nnew_premix = t_nnew if collect_diags else None
    with jax.named_scope("t3dmix"):
        if any(x != 0.0 for x in cfg.tnu2):
            if cfg.ts_mix_iso:
                t_nnew = t3dmix2_iso(cfg, grid, state.t, pden, Hz, z_r,
                                     t_nnew, cfg.dt)
            elif cfg.ts_mix_geo:
                t_nnew = t3dmix2_geo(cfg, grid, state.t, Hz, z_r,
                                     t_nnew, cfg.dt)
            else:
                t_nnew = t3dmix2(cfg, grid, state.t, Hz, t_nnew, cfg.dt)
        if cfg.ts_dif4 and any(x != 0.0 for x in cfg.tnu4):
            if cfg.ts_mix_iso:
                t_nnew = t3dmix4_iso(cfg, grid, state.t, pden, Hz, z_r,
                                     t_nnew, cfg.dt)
            elif cfg.ts_mix_geo:
                t_nnew = t3dmix4_geo(cfg, grid, state.t, Hz, z_r, t_nnew,
                                     cfg.dt)
            else:
                t_nnew = t3dmix4(cfg, grid, state.t, Hz, t_nnew, cfg.dt)

    ru_prs, rv_prs = (ru, rv) if collect_diags else (None, None)
    uv_nnew_pre = (u_nnew, v_nnew) if collect_diags else None
    with jax.named_scope("rhs3d"):
        res3d = rhs3d_momentum(
            cfg, grid, state.u, state.v, Huon, Hvom, W, Hz, ru, rv,
            sustr, svstr, bustr, bvstr, clm=clm,
            want_diags=collect_diags)
    if collect_diags:
        ru, rv, rufrc, rvfrc, dia_rhs = res3d
    else:
        ru, rv, rufrc, rvfrc = res3d

    # --- wave radiation-stress body force (main3d's radiation_stress
    #     call; ops/nearshore.py Mellor05).  Applied to ru/rv like the
    #     reference's rhs3d.F:994 and folded into rufrc so the fast
    #     loop carries the depth-integrated stress ---
    if ns is not None:
        ru = ru - ns.rustr3d
        rv = rv - ns.rvstr3d
        rufrc = rufrc - ns.rustr2d
        rvfrc = rvfrc - ns.rvstr2d

    with jax.named_scope("uv3dmix"):
        if cfg.uv_vis2 and cfg.visc2 != 0.0:
            if cfg.uv_mix_geo:
                u_nnew, v_nnew, rufrc, rvfrc = uv3dmix2_geo(
                    cfg, grid, state.u, state.v, Hz, z_r, u_nnew, v_nnew,
                    rufrc, rvfrc, cfg.dt)
            else:
                u_nnew, v_nnew, rufrc, rvfrc = uv3dmix2(
                    cfg, grid, state.u, state.v, Hz, u_nnew, v_nnew,
                    rufrc, rvfrc, cfg.dt)
        if cfg.uv_vis4 and cfg.visc4 != 0.0:
            if cfg.uv_mix_geo:
                u_nnew, v_nnew, rufrc, rvfrc = uv3dmix4_geo(
                    cfg, grid, state.u, state.v, Hz, z_r, u_nnew, v_nnew,
                    rufrc, rvfrc, cfg.dt)
            else:
                u_nnew, v_nnew, rufrc, rvfrc = uv3dmix4(
                    cfg, grid, state.u, state.v, Hz, u_nnew, v_nnew,
                    rufrc, rvfrc, cfg.dt)

    # --- GLS predictor (main3d.F:565-567) ---
    tke_new, gls_new = state.tke, state.gls
    Akk_new, Akp_new, Lscale_new = state.Akk, state.Akp, state.Lscale
    if cfg.vmix in ("gls", "my25"):
        from .ops import gls as gls_mod
        with jax.named_scope("gls"):
            tke3, gls3, tke_nnew, gls_nnew = gls_mod.gls_prestep(
                cfg, grid, cfg.gls_params, state.iic, state.tke,
                state.gls, state.tke_prev, state.gls_prev, Hz, Huon,
                Hvom, W)

    # --- fast barotropic loop (main3d.F:592-713) ---
    fs = Fast2DState(
        zeta_n=state.zeta, zeta_nm1=state.zeta,
        ubar_n=state.ubar, ubar_nm1=state.ubar,
        vbar_n=state.vbar, vbar_nm1=state.vbar,
        rzeta_n=state.rzeta, rzeta_nm1=zero2,
        rubar_n=state.rubar, rubar_nm1=zero2,
        rvbar_n=state.rvbar, rvbar_nm1=zero2,
        Zt_avg1=zero2, DU_avg1=zero2, DV_avg1=zero2,
        DU_avg2=zero2, DV_avg2=zero2)
    if ns is not None:
        from .ops.step2d import stokes_transport
        us2d = stokes_transport(grid, state.zeta,
                                (ns.ubar_stokes, ns.vbar_stokes))
    else:
        us2d = None
    with jax.named_scope("fast_loop"):
        fs, rufrc_c, rvfrc_c, wet = fast_loop(
            cfg, grid, fs, rufrc=rufrc, rvfrc=rvfrc,
            ru0_nm1=state.rufrc0_prev, ru0_nm2=state.rufrc0_prev2,
            rv0_nm1=state.rvfrc0_prev, rv0_nm2=state.rvfrc0_prev2,
            iic=state.iic, bry=bry, sources=sources, clm=clm,
            us2d=us2d)

    # --- new depths from the filtered free surface (main3d.F:736) ---
    with jax.named_scope("diag"):
        z_r2, z_w2, Hz2 = vgrid.set_depth(grid.h, fs.Zt_avg1, hc,
                                          grid.sc_r, grid.Cs_r, grid.sc_w,
                                          grid.Cs_w, cfg.vtransform,
                                          zice=grid.zice)

    # --- 3D momentum corrector (main3d.F:762).  With NEARSHORE the
    #     time-centered consistency target DU_avg2 is total (Eulerian +
    #     Stokes); the Stokes column integral is removed so step3d_uv
    #     corrects the Eulerian flux only (step3d_uv.F:473 DCs) ---
    DU2_t, DV2_t = fs.DU_avg2, fs.DV_avg2
    if ns is not None:
        DU2_t = DU2_t - us2d[0]
        DV2_t = DV2_t - us2d[1]
    with jax.named_scope("step3d_uv"):
        u2, v2, ubar2, vbar2, Huon2, Hvom2 = step3d_uv(
            cfg, grid, state.iic, u_nnew, v_nnew, ru, rv, Hz2, Akv,
            fs.DU_avg1, fs.DV_avg1, DU2_t, DV2_t, Huon, Hvom,
            u_old=state.u, v_old=state.v, bry=bry, sources=sources,
            z_w_new=z_w2, wet=wet)
    if ns is not None:
        # tracer advection and omega see the total transport; the 3-D
        # Stokes flux keeps the u_stokes profile but its column sum is
        # pinned to the frozen 2-D transport (same mean-replacement
        # idea step3d_uv applies to the Eulerian part) so that
        # sum_k(Huon2) == DU_avg2 exactly -> tracer constancy holds
        Hz2_u = 0.5 * (Hz2 + jnp.roll(Hz2, 1, -1))
        Hz2_v = 0.5 * (Hz2 + jnp.roll(Hz2, 1, -2))
        FSu = Hz2_u * ns.u_stokes * grid.on_u
        FSv = Hz2_v * ns.v_stokes * grid.om_v
        D2_u = jnp.sum(Hz2_u, axis=0)
        D2_v = jnp.sum(Hz2_v, axis=0)
        FSu = FSu + (us2d[0] - jnp.sum(FSu, axis=0)) * Hz2_u / D2_u
        FSv = FSv + (us2d[1] - jnp.sum(FSv, axis=0)) * Hz2_v / D2_v
        Huon2 = Huon2 + FSu
        Hvom2 = Hvom2 + FSv
    if wet is not None:
        # the stored AB3 rhs history is limited too (step3d_uv.F:563)
        ru = ru * wet["umask_wet"]
        rv = rv * wet["vmask_wet"]

    if collect_diags:
        # --- DIAGNOSTICS_UV increments (see docstring for the term
        #     definitions and documented deltas vs mod_diags.F) ---
        from .ops.stencil import im1, jm1
        ab3 = jnp.where(state.iic == 0, 1.0,
                        jnp.where(state.iic == 1, 1.5, 23.0 / 12.0))
        ab3 = ab3.astype(dtype)
        pm, pn = grid.pm, grid.pn
        DC0u = 0.25 * cfg.dt * ab3 * (pm + im1(pm)) * (pn + im1(pn))
        DC0v = 0.25 * cfg.dt * ab3 * (pm + jm1(pm)) * (pn + jm1(pn))
        oHz_u = 1.0 / (0.5 * (Hz2 + im1(Hz2)))
        oHz_v = 1.0 / (0.5 * (Hz2 + jm1(Hz2)))
        dia_uv = {}
        u_nnew_pre, v_nnew_pre = uv_nnew_pre
        dia_uv["u_prestep"] = u_nnew_pre * oHz_u - state.u
        dia_uv["v_prestep"] = v_nnew_pre * oHz_v - state.v
        dia_uv["u_hvisc"] = (u_nnew - u_nnew_pre) * oHz_u
        dia_uv["v_hvisc"] = (v_nnew - v_nnew_pre) * oHz_v
        dia_uv["u_prsgrd"] = DC0u * ru_prs * oHz_u
        dia_uv["v_prsgrd"] = DC0v * rv_prs * oHz_v
        for key, (tu, tv) in dia_rhs.items():
            dia_uv["u_" + key] = DC0u * tu * oHz_u
            dia_uv["v_" + key] = DC0v * tv * oHz_v
        dia_uv["u_rate"] = u2 - state.u
        dia_uv["v_rate"] = v2 - state.v
        dia_uv["u_vvisc"] = dia_uv["u_rate"] - sum(
            dia_uv["u_" + k] for k in
            ("prestep", "hvisc", "prsgrd", "cor", "xadv", "yadv", "vadv"))
        dia_uv["v_vvisc"] = dia_uv["v_rate"] - sum(
            dia_uv["v_" + k] for k in
            ("prestep", "hvisc", "prsgrd", "cor", "xadv", "yadv", "vadv"))

    # --- omega with corrected fluxes (main3d.F:789) ---
    with jax.named_scope("diag"):
        W2 = omega(cfg, grid, Huon2, Hvom2, z_w2)

    # --- GLS corrector (main3d.F:791-793): updates Akv/Akt for the
    #     tracer step ---
    if cfg.vmix == "my25":
        # dedicated Mellor-Yamada 2.5 corrector (my25_corstep.F); the
        # predictor is shared with GLS (my25_prestep.F == gls_prestep.F)
        from .ops.my25 import my25_corstep
        with jax.named_scope("gls"):
            bvf_g = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
            (tke_new, gls_new, Akv, Akt, Akk_new,
             Lscale_new) = my25_corstep(
                cfg, grid, state.iic,
                state.tke, state.gls, tke3, gls3, tke_nnew, gls_nnew,
                state.u, state.v, bvf_g, Hz2, z_r2, z_w2, Huon2, Hvom2,
                W2, state.Akv, state.Akt, state.Akk, state.Lscale,
                sustr, svstr, bustr, bvstr,
                kantha_clayson=cfg.my25_kantha_clayson)
        Akp_new = Akk_new
    elif cfg.vmix == "gls":
        with jax.named_scope("gls"):
            bvf_g = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
            (tke_new, gls_new, Akv, Akt, Akk_new, Akp_new,
             Lscale_new) = gls_mod.gls_corstep(
                cfg, grid, cfg.gls_params, state.iic,
                state.tke, state.gls, tke3, gls3, tke_nnew, gls_nnew,
                state.u, state.v, bvf_g, Hz2, z_r2, z_w2, Huon2, Hvom2,
                W2, state.Akv, state.Akt, state.Akk, state.Akp,
                state.Lscale, sustr, svstr, bustr, bvstr,
                Hwave=frc.get("Hwave"))

    # --- tracer corrector (main3d.F:814) ---
    with jax.named_scope("step3d_t"):
        res = step3d_t(cfg, grid, state.iic, t_nnew, t3, Huon2, Hvom2,
                       W2, Hz2, z_r2, Akt, t_old=state.t, bry=bry,
                       clm=clm, sources=sources,
                       want_diags=collect_diags)
    if collect_diags:
        t2, dia_ts = res
        dia_ts["hdiff"] = (t_nnew - t_nnew_premix) / Hz2
    else:
        t2 = res

    # --- mean-age inert tracer pairs (AGE_MEAN; step3d_t.F:1507-1539):
    #     age concentration forced by the conservative partner ---
    for (icons, iage) in cfg.inert_age:
        t2 = t2.at[iage].add(cfg.dt * t2[icons])

    # --- biological source/sink terms (main3d.F biology call) ---
    if cfg.biology is not None:
        from .ops.biology import apply_biology
        with jax.named_scope("biology"):
            t2 = apply_biology(cfg, grid, state.t, t2, Hz2, z_w2, srflx,
                               z_r=z_r2, sustr=sustr, svstr=svstr,
                               uwind=frc.get("Uwind", None),
                               vwind=frc.get("Vwind", None),
                               frc=frc, time=state.time)

    # --- sediment settling/erosion/bed exchange (main3d.F sediment
    #     call; Sediment/sediment.F driver) ---
    bed_mass = state.bed_mass
    if cfg.sediment and cfg.sed_params is not None:
        from .ops.sediment import apply_sediment
        tau_sed = tau_cwmax if cfg.bbl else None
        sed_kw = {}
        if cfg.bbl and cfg.sed_params.bedload_method == "soulsby":
            # wave/current stress split + wave-current angle for the
            # Soulsby-Damgaard rates (sed_bedload.F:391-403)
            from .ops.stencil import ip1 as _ip1, jp1 as _jp1
            bu_r = 0.5 * (bustr + _ip1(bustr))
            bv_r = 0.5 * (bvstr + _jp1(bvstr))
            phic = jnp.arctan2(bv_r, bu_r)
            sed_kw = dict(
                tau_c=tau_c_b, tau_wav=tau_w_b,
                phicw=1.5 * jnp.pi - frc.get("Dwave", zero2) - phic -
                grid.angler)
        with jax.named_scope("sediment"):
            t2, bed_mass = apply_sediment(cfg, grid, cfg.sed_params, t2,
                                          bed_mass, Hz2, z_w2, bustr,
                                          bvstr, tau_cw=tau_sed, **sed_kw)

    new_state = state.replace(
        time=state.time + cfg.dt, iic=state.iic + 1,
        zeta=fs.Zt_avg1, ubar=ubar2, vbar=vbar2,
        u=u2, v=v2, t=t2, t_prev=state.t,
        ru_prev=ru, ru_prev2=state.ru_prev,
        rv_prev=rv, rv_prev2=state.rv_prev,
        rufrc0_prev=rufrc_c, rufrc0_prev2=state.rufrc0_prev,
        rvfrc0_prev=rvfrc_c, rvfrc0_prev2=state.rvfrc0_prev,
        rzeta=fs.rzeta_n, rubar=fs.rubar_n, rvbar=fs.rvbar_n,
        Akv=Akv, Akt=Akt, hsbl=hsbl, hbbl=hbbl,
        tke=tke_new, gls=gls_new,
        tke_prev=state.tke, gls_prev=state.gls,
        Akk=Akk_new, Akp=Akp_new, Lscale=Lscale_new,
        DU_avg1=fs.DU_avg1, DV_avg1=fs.DV_avg1,
        DU_avg2=fs.DU_avg2, DV_avg2=fs.DV_avg2,
        bed_mass=bed_mass,
        rheight=rheight, rlength=rlength, tau_cwmax=tau_cwmax)
    if collect_diags:
        dia_ts["rate"] = new_state.t - state.t
        dia_ts.update(dia_uv)
        return new_state, dia_ts
    return new_state


def make_stepper(cfg: Config, grid: Grid,
                 forcing_fn: Optional[Callable] = None,
                 donate: bool = True):
    """jit-compiled single-step function state -> state.  The grid is a
    jit argument, not a closed-over constant, so its arrays are not
    embedded in the compiled program."""
    if cfg.nfast <= 0:
        raise ValueError(
            "cfg.nfast is 0 - the fast barotropic loop would be empty. "
            "Use the cfg returned by build_grid/the case builder "
            "(it finalizes hmin and nfast).")
    f = jax.jit(lambda g, s: step(cfg, g, s, forcing_fn),
                donate_argnums=(1,) if donate else ())
    return lambda s: f(grid, s)


def run(cfg: Config, grid: Grid, state: State, nsteps: int,
        forcing_fn: Optional[Callable] = None) -> State:
    """Advance nsteps with a scan (single compiled program)."""
    def body(s, _):
        return step(cfg, grid, s, forcing_fn), None

    state, _ = jax.lax.scan(body, state, None, length=nsteps)
    return state


def run_accum(cfg: Config, grid: Grid, state: State, nsteps: int,
              forcing_fn: Optional[Callable] = None,
              fields: tuple = ("zeta", "ubar", "vbar", "u", "v", "t"),
              derived: Optional[dict] = None):
    """Advance nsteps and accumulate per-step sums of the named State
    fields ON DEVICE (the mod_average.F accumulators, sampled every step
    as set_avg.F does - correct for any steps-per-dispatch batching).

    derived: optional {name: fn(cfg, grid, state) -> array} computed and
    accumulated alongside (the set_avg.F:2352-3952 quadratic/derived
    fields: u*u, Huon means, rho, ...).  Returns (state, sums dict)."""
    derived = derived or {}

    def dvals(s):
        return {k: fn(cfg, grid, s) for k, fn in derived.items()}

    def body(carry, _):
        s, acc = carry
        s = step(cfg, grid, s, forcing_fn)
        dv = dvals(s)
        acc = {**{k: acc[k] + getattr(s, k) for k in fields},
               **{k: acc[k] + dv[k] for k in derived}}
        return (s, acc), None

    acc0 = {k: jnp.zeros_like(getattr(state, k)) for k in fields}
    acc0.update({k: jnp.zeros_like(v)
                 for k, v in dvals(state).items()})
    (state, sums), _ = jax.lax.scan(body, (state, acc0), None,
                                    length=nsteps)
    return state, sums
