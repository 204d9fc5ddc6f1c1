"""Mass fluxes and diagnostic vertical velocity.

set_massflux (ROMS/Nonlinear/set_massflux.F:121-180) and omega
(ROMS/Nonlinear/omega.F:120-225).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import Config
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1


def set_massflux(cfg: Config, grid: Grid, u, v, Hz):
    """Huon = 0.5*(Hz_i + Hz_{i-1})*u*on_u, Hvom analog; halos filled
    (the reference exchanges Huon/Hvom after computing them)."""
    Huon = 0.5 * (Hz + im1(Hz)) * u * grid.on_u
    Hvom = 0.5 * (Hz + jm1(Hz)) * v * grid.om_v
    return bc.fill_halo(cfg, Huon), bc.fill_halo(cfg, Hvom)


def omega(cfg: Config, grid: Grid, Huon, Hvom, z_w):
    """S-coordinate vertical mass flux W (N+1,Ny,Nx) from continuity
    (omega.F): bottom-up integral of the horizontal flux divergence, with
    the moving-grid correction that enforces W=0 at the free surface.
    Halo filled with zero-gradient BCs (bc_w3d + exchange)."""
    N = Huon.shape[0]
    div = (ip1(Huon) - Huon) + (jp1(Hvom) - Hvom)     # (N,...) at rho
    Wk = -jnp.cumsum(div, axis=0)                     # k=1..N
    wrk = Wk[N - 1] / (z_w[N] - z_w[0])
    Wcorr = Wk - wrk * (z_w[1:] - z_w[0])
    # exact zero at the surface and the bottom
    W = jnp.concatenate(
        [jnp.zeros_like(Wk[:1]), Wcorr[:-1], jnp.zeros_like(Wk[:1])],
        axis=0)
    from ..config import LBC, BC_GRADIENT
    grad_all = LBC(BC_GRADIENT, BC_GRADIENT, BC_GRADIENT, BC_GRADIENT)
    return bc.apply_bc_rho(cfg, grad_all, W)


def wvelocity(cfg: Config, grid: Grid, u, v, W, z_r, z_w,
              DU_avg1, DV_avg1):
    """True vertical velocity w (m/s) at W-points for output
    (ROMS/Nonlinear/wvelocity.F): omega plus the S-surface quasi-horizontal
    contribution and the linearly distributed free-surface tendency."""
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    N = cfg.N
    # (Ui + Vj) * grad_s(z) at rho points/levels
    wrku = u * (z_r - im1(z_r)) * (pm + im1(pm))
    wrkv = v * (z_r - jm1(z_r)) * (pn + jm1(pn))
    vert = 0.25 * (wrku + ip1(wrku)) + 0.25 * (wrkv + jp1(wrkv))

    dz_col = z_w[-1] - z_w[0]
    tend = ((DU_avg1 - ip1(DU_avg1)) + (DV_avg1 - jp1(DV_avg1))) / dz_col

    c1, c2, c3 = 3.0 / 8.0, 3.0 / 4.0, 1.0 / 8.0
    c4, c5 = 9.0 / 16.0, 1.0 / 16.0
    wvel = jnp.zeros_like(W)
    # bottom (cubic extrapolation of vert)
    slope = (z_r[0] - z_w[0]) / (z_r[1] - z_r[0])
    wvel = wvel.at[0].set(
        c1 * (vert[0] - slope * (vert[1] - vert[0])) +
        c2 * vert[0] - c3 * vert[1])
    wvel = wvel.at[1].set(
        pmn * (W[1] + tend * (z_w[1] - z_w[0])) +
        c1 * vert[0] + c2 * vert[1] - c3 * vert[2])
    # interior k=2..N-2
    interior = pmn[None] * (W[2:N - 1] + tend[None] *
                            (z_w[2:N - 1] - z_w[0][None])) + \
        c4 * (vert[1:N - 2] + vert[2:N - 1]) - \
        c5 * (vert[0:N - 3] + vert[3:N])
    wvel = wvel.at[2:N - 1].set(interior)
    wvel = wvel.at[N - 1].set(
        pmn * (W[N - 1] + tend * (z_w[N - 1] - z_w[0])) +
        c1 * vert[N - 1] + c2 * vert[N - 2] - c3 * vert[N - 3])
    slope = (z_w[N] - z_r[N - 1]) / (z_r[N - 1] - z_r[N - 2])
    wvel = wvel.at[N].set(
        pmn * tend * (z_w[N] - z_w[0]) +
        c1 * (vert[N - 1] + slope * (vert[N - 1] - vert[N - 2])) +
        c2 * vert[N - 1] - c3 * vert[N - 2])
    return bc.fill_halo(cfg, wvel)
