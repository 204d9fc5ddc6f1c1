"""Model state pytree.

Replaces the reference's rotating-index storage (mod_ocean.F, mod_coupling.F,
mod_stepping.F) with explicitly named time levels (SURVEY.md §7 design
stance).  Everything needed for a perfect restart lives here (the
reference's PERFECT_RESTART field set, wrt_rst.F:37-156).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .pytree import dataclass as pytree_dataclass
from .config import Config


@pytree_dataclass
class State:
    time: jax.Array      # seconds since initialization
    iic: jax.Array       # slow step counter (0-based)

    # prognostic fields at time n
    zeta: jax.Array      # (Ny,Nx) free surface (= Zt_avg1 of previous step)
    ubar: jax.Array      # (Ny,Nx)
    vbar: jax.Array
    u: jax.Array         # (N,Ny,Nx)
    v: jax.Array
    t: jax.Array         # (NT,N,Ny,Nx)
    t_prev: jax.Array    # tracers at n-1 (LF-AM3 predictor history)

    # slow RHS history (ru/rv slots; pre_step3d.F AB3 ladder)
    ru_prev: jax.Array   # r_{n-1} (N,Ny,Nx)
    ru_prev2: jax.Array  # r_{n-2}
    rv_prev: jax.Array
    rv_prev2: jax.Array

    # depth-integrated slow-forcing history (ru(:,:,0,:) slots)
    rufrc0_prev: jax.Array    # (Ny,Nx)
    rufrc0_prev2: jax.Array
    rvfrc0_prev: jax.Array
    rvfrc0_prev2: jax.Array

    # fast-loop RHS history carried across slow steps (rzeta/rubar/rvbar)
    rzeta: jax.Array
    rubar: jax.Array
    rvbar: jax.Array

    # vertical mixing coefficients (closure state; constant background when
    # cfg.vmix is None)
    Akv: jax.Array       # (N+1,Ny,Nx)
    Akt: jax.Array       # (NAT,N+1,Ny,Nx)
    hsbl: jax.Array      # (Ny,Nx) KPP surface boundary layer depth (m, neg)
    hbbl: jax.Array      # (Ny,Nx) KPP bottom boundary layer top (m, neg)

    # GLS closure state (tke/gls at W-points; mod_mixing.F tke/gls/Lscale)
    tke: jax.Array       # (N+1,Ny,Nx)
    gls: jax.Array
    tke_prev: jax.Array
    gls_prev: jax.Array
    Akk: jax.Array       # tke diffusivity
    Akp: jax.Array       # gls diffusivity
    Lscale: jax.Array

    # fast-time-averaged fields of the last completed step (restart
    # completeness; also handy diagnostics)
    DU_avg1: jax.Array
    DV_avg1: jax.Array
    DU_avg2: jax.Array
    DV_avg2: jax.Array

    # sediment bed layers (Nbed,NST,Ny,Nx) kg/m2; shape (0,0,Ny,Nx) when
    # the sediment model is off (SEDBED bed_mass analog)
    bed_mass: jax.Array

    # wave-current BBL memory (SEDBED bottom irhgt/irlen + max combined
    # stress; zeros when cfg.bbl is None)
    rheight: jax.Array   # (Ny,Nx) ripple height (m)
    rlength: jax.Array   # (Ny,Nx) ripple wavelength (m)
    tau_cwmax: jax.Array  # (Ny,Nx) max wave-current stress (m2/s2)


def initial_state(cfg: Config, zeta=None, ubar=None, vbar=None,
                  u=None, v=None, t=None) -> State:
    """Cold-start state (the reference's ini_fields semantics: histories
    zeroed, mixing coefficients at background values)."""
    dtype = jnp.dtype(cfg.dtype)
    shp2 = (cfg.ny_tot, cfg.nx_tot)
    shp3 = (cfg.N,) + shp2
    shpw = (cfg.N + 1,) + shp2
    nat = min(cfg.ntracers, 2) if cfg.ntracers else 1
    # each field gets its own buffer: aliased leaves break jit donation
    z2 = lambda: jnp.zeros(shp2, dtype)
    z3 = lambda: jnp.zeros(shp3, dtype)

    zeta = z2() if zeta is None else jnp.asarray(zeta, dtype)
    ubar = z2() if ubar is None else jnp.asarray(ubar, dtype)
    vbar = z2() if vbar is None else jnp.asarray(vbar, dtype)
    u = z3() if u is None else jnp.asarray(u, dtype)
    v = z3() if v is None else jnp.asarray(v, dtype)
    if t is None:
        t = jnp.zeros((cfg.ntracers,) + shp3, dtype)
    else:
        t = jnp.asarray(t, dtype)

    Akv = jnp.full(shpw, cfg.akv_bak, dtype)
    Akt = jnp.stack([jnp.full(shpw, cfg.akt_bak[i], dtype)
                     for i in range(nat)], axis=0)
    return State(
        time=jnp.asarray(0.0, dtype), iic=jnp.asarray(0, jnp.int32),
        zeta=zeta, ubar=ubar, vbar=vbar, u=u, v=v, t=t,
        t_prev=t.copy(),
        ru_prev=z3(), ru_prev2=z3(), rv_prev=z3(), rv_prev2=z3(),
        rufrc0_prev=z2(), rufrc0_prev2=z2(), rvfrc0_prev=z2(),
        rvfrc0_prev2=z2(),
        rzeta=z2(), rubar=z2(), rvbar=z2(),
        Akv=Akv, Akt=Akt, hsbl=z2(), hbbl=z2(),
        tke=jnp.full(shpw, cfg.gls_params.Kmin, dtype),
        gls=jnp.full(shpw, cfg.gls_params.Pmin, dtype),
        tke_prev=jnp.full(shpw, cfg.gls_params.Kmin, dtype),
        gls_prev=jnp.full(shpw, cfg.gls_params.Pmin, dtype),
        Akk=jnp.full(shpw, cfg.gls_params.akk_bak, dtype),
        Akp=jnp.full(shpw, cfg.gls_params.akp_bak, dtype),
        Lscale=jnp.zeros(shpw, dtype),
        DU_avg1=z2(), DV_avg1=z2(), DU_avg2=z2(), DV_avg2=z2(),
        bed_mass=_initial_bed_mass(cfg, shp2, dtype),
        rheight=z2(),
        rlength=jnp.full(shp2, _initial_rlength(cfg), dtype),
        tau_cwmax=z2())


def _initial_rlength(cfg: Config) -> float:
    """Relict ripple wavelength floor: 535*d50 (ssw_bbl.h sheet-flow
    value) so zoBF=ar*rh^2/rl is well-defined from step one."""
    if cfg.bbl_params is not None:
        return 535.0 * cfg.bbl_params.d50
    return 535.0 * 0.00015


def _initial_bed_mass(cfg: Config, shp2, dtype):
    if not cfg.sediment or cfg.sed_params is None:
        return jnp.zeros((0, 0) + shp2, dtype)
    from .ops.sediment import initial_bed
    return initial_bed(cfg, cfg.sed_params)
