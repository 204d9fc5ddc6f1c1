"""Grid container and analytic grid builders.

Replaces the reference's mod_grid.F state arrays plus the analytic grid
functional (ROMS/Functionals/ana_grid.h) and metric computation
(ROMS/Utility/metrics.F).  Grids are built in float64 numpy at setup time and
then cast to the compute dtype as a JAX pytree.

Layout: padded arrays [eta(j), xi(i)] of shape (Mm+2H, Lm+2H); see
ops/stencil.py for the index convention.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .pytree import dataclass as pytree_dataclass
from . import constants as C
from .config import Config
from . import vgrid


@pytree_dataclass
class Grid:
    """Static grid arrays (a JAX pytree; all padded to (ny_tot, nx_tot))."""

    h: jax.Array        # bathymetry (m, positive) at rho
    f: jax.Array        # Coriolis at rho
    pm: jax.Array       # 1/dx at rho
    pn: jax.Array       # 1/dy at rho
    xr: jax.Array       # x (or lon) at rho
    yr: jax.Array       # y (or lat) at rho
    rmask: jax.Array
    umask: jax.Array
    vmask: jax.Array
    pmask: jax.Array
    dndx: jax.Array     # d(1/pn)/dxi at rho (curvilinear terms)
    dmde: jax.Array     # d(1/pm)/deta at rho
    angler: jax.Array   # grid rotation angle at rho (rad; get_grid.F angler)
    # vertical coordinate tables
    sc_r: jax.Array
    Cs_r: jax.Array
    sc_w: jax.Array
    Cs_w: jax.Array
    # fast-time-averaging filter weights (length 2*ndtfast, zeros past nfast)
    weight1: jax.Array
    weight2: jax.Array
    # spatially varying mixing enhancement (sponge layers; the analog of
    # ini_hmixcoef.F's visc2_r/diff2_r scaling) - 1.0 in the interior
    visc_factor: jax.Array
    diff_factor: jax.Array
    # ICESHELF: ice-shelf draft (m, negative under the shelf; zero in
    # open water) at rho points (mod_grid zice; ana_grid.h:1155-1176)
    zice: Optional[jax.Array] = None

    # -- derived staggered metrics (computed lazily; fused by XLA) --------
    @property
    def on_u(self):
        """dy at u points: 2/(pn[i-1]+pn[i]) (metrics.F)."""
        return 2.0 / (jnp.roll(self.pn, 1, -1) + self.pn)

    @property
    def om_u(self):
        return 2.0 / (jnp.roll(self.pm, 1, -1) + self.pm)

    @property
    def on_v(self):
        return 2.0 / (jnp.roll(self.pn, 1, -2) + self.pn)

    @property
    def om_v(self):
        return 2.0 / (jnp.roll(self.pm, 1, -2) + self.pm)

    @property
    def om_r(self):
        return 1.0 / self.pm

    @property
    def on_r(self):
        return 1.0 / self.pn

    @property
    def omn(self):
        """Cell area 1/(pm*pn) at rho."""
        return 1.0 / (self.pm * self.pn)

    @property
    def fomn(self):
        return self.f / (self.pm * self.pn)


def _padded_index_grids(cfg: Config):
    """ROMS index arrays over the padded layout: i (xi), j (eta)."""
    H = cfg.halo
    i = np.arange(cfg.nx_tot, dtype=np.float64) - H + 1    # roms i index
    j = np.arange(cfg.ny_tot, dtype=np.float64) - H + 1
    return np.meshgrid(i, j)   # shape (ny_tot, nx_tot)


def _fill_periodic(cfg: Config, a: np.ndarray) -> np.ndarray:
    """Wrap static builder arrays in periodic directions (period Lm / Mm)."""
    H = cfg.halo
    if cfg.ew_periodic:
        L = cfg.Lm
        idx = (np.arange(cfg.nx_tot) - H) % L + H
        a = a[..., idx]
    if cfg.ns_periodic:
        M = cfg.Mm
        idx = (np.arange(cfg.ny_tot) - H) % M + H
        a = a[..., idx, :]
    return a


def _fill_closed_halo(cfg: Config, a: np.ndarray) -> np.ndarray:
    """Replicate the boundary-ring value over the deeper halo cells in
    closed directions.  The reference evaluates ana_grid only on
    IstrT:IendT/JstrT:JendT (ROMS index 0..Lm+1, padded H-1..H+Lm) and
    never initializes ghosts beyond the ring; evaluating an analytic
    depth formula out there can produce unphysical values (e.g. a
    negative depth extrapolation), which our roll-based stencils would
    read.  Keeps the ring row/column analytic."""
    a = a.copy()
    H = cfg.halo
    if not cfg.ew_periodic:
        a[..., :H - 1] = a[..., H - 1:H]
        a[..., H + cfg.Lm + 1:] = a[..., H + cfg.Lm:H + cfg.Lm + 1]
    if not cfg.ns_periodic:
        a[..., :H - 1, :] = a[..., H - 1:H, :]
        a[..., H + cfg.Mm + 1:, :] = \
            a[..., H + cfg.Mm:H + cfg.Mm + 1, :]
    return a


def build_weights(ndtfast: int):
    """Power-law fast-time filter weights (set_weights.F:55-196).

    Returns (weight1, weight2, nfast); float64 arrays of length 2*ndtfast
    (1-based ROMS index i stored at [i-1]).  Accumulations use longdouble to
    mirror the reference's r16 quad sums.
    """
    Falpha, Fbeta, Fgamma = C.Falpha, C.Fbeta, C.Fgamma
    n2 = 2 * ndtfast
    w1 = np.zeros(n2)
    w2 = np.zeros(n2)

    scale = (Falpha + 1.0) * (Falpha + Fbeta + 1.0) / (
        (Falpha + 2.0) * (Falpha + Fbeta + 2.0) * ndtfast)
    gamma = Fgamma * max(0.0, 1.0 - 10.0 / ndtfast)
    nfast = 0
    for _ in range(16):
        nfast = 0
        for i in range(1, n2 + 1):
            cff = scale * i
            w1[i - 1] = cff ** Falpha - cff ** (Falpha + Fbeta) - gamma * cff
            if w1[i - 1] > 0.0:
                nfast = i
            if nfast > 0 and w1[i - 1] < 0.0:
                w1[i - 1] = 0.0
        wsum = np.longdouble(0.0)
        shift = np.longdouble(0.0)
        for i in range(1, nfast + 1):
            wsum += np.longdouble(w1[i - 1])
            shift += np.longdouble(w1[i - 1] * i)
        scale *= float(shift / (wsum * ndtfast))

    # center-of-gravity correction by upstream advection of the weights
    # (set_weights.F:131-169)
    for _ in range(ndtfast):
        wsum = np.longdouble(0.0)
        shift = np.longdouble(0.0)
        for i in range(1, nfast + 1):
            wsum += np.longdouble(w1[i - 1])
            shift += np.longdouble(i * w1[i - 1])
        shift = shift / wsum
        cff = np.longdouble(ndtfast) - shift
        if cff > 1.0:
            nfast += 1
            for i in range(nfast, 1, -1):
                w1[i - 1] = w1[i - 2]
            w1[0] = 0.0
        elif cff > 0.0:
            wsum = 1.0 - cff
            for i in range(nfast, 1, -1):
                w1[i - 1] = float(wsum * w1[i - 1] + cff * w1[i - 2])
            w1[0] = float(wsum * w1[0])
        elif cff < -1.0:
            nfast -= 1
            for i in range(1, nfast + 1):
                w1[i - 1] = w1[i]
            w1[nfast] = 0.0
        elif cff < 0.0:
            wsum = 1.0 + cff
            for i in range(1, nfast):
                w1[i - 1] = float(wsum * w1[i - 1] - cff * w1[i])
            w1[nfast - 1] = float(wsum * w1[nfast - 1])

    # secondary weights: running partial sums (set_weights.F:171-181)
    for j in range(1, nfast + 1):
        cff = w1[j - 1]
        for i in range(1, j + 1):
            w2[i - 1] += cff

    # normalize both sets (set_weights.F:183-196)
    wsum = np.longdouble(0.0)
    cff = np.longdouble(0.0)
    for i in range(1, nfast + 1):
        wsum += np.longdouble(w1[i - 1])
        cff += np.longdouble(w2[i - 1])
    w1[:nfast] = (w1[:nfast] / np.float64(wsum)).astype(np.float64)
    w2[:nfast] = (w2[:nfast] / np.float64(cff)).astype(np.float64)
    # pad so lookups at index nfast+1 (the auxiliary fast step) are in range
    w1 = np.concatenate([w1, np.zeros(2)])
    w2 = np.concatenate([w2, np.zeros(2)])
    return w1, w2, nfast


def build_grid(
    cfg: Config,
    Xsize: float,
    Esize: float,
    f0: float,
    beta: float,
    depth_fn: Callable,   # (xr, yr, i, j, cfg) -> h  (numpy, padded arrays)
    mask_fn: Optional[Callable] = None,
):
    """Build a uniform Cartesian grid (the non-spherical ana_grid.h path).

    Coordinates (ana_grid.h:514-531): xr = dx*(i-0.5), yr = dy*(j-0.5) with
    dx = Xsize/Lm, dy = Esize/Mm; Coriolis f = f0 + beta*(yr - Esize/2)
    (ana_grid.h:884-889); pm = 1/dx, pn = 1/dy (ana_grid.h:676-693).

    Returns (grid, cfg) where cfg has hmin/hc/nfast finalized.
    """
    dx = Xsize / cfg.Lm
    dy = Esize / cfg.Mm
    i, j = _padded_index_grids(cfg)
    xr = dx * (i - 0.5)
    yr = dy * (j - 0.5)
    f = f0 + beta * (yr - 0.5 * Esize)
    pm = np.full_like(xr, 1.0 / dx)
    pn = np.full_like(xr, 1.0 / dy)

    h = np.asarray(depth_fn(xr, yr, i, j, cfg), dtype=np.float64)
    h = _fill_periodic(cfg, h)
    f = _fill_periodic(cfg, f)

    if mask_fn is not None:
        rmask = np.asarray(mask_fn(xr, yr, i, j, cfg), dtype=np.float64)
        rmask = _fill_periodic(cfg, rmask)
    else:
        rmask = np.ones_like(h)
    umask = rmask * np.roll(rmask, 1, axis=-1)
    vmask = rmask * np.roll(rmask, 1, axis=-2)
    pmask = umask * np.roll(umask, 1, axis=-2)

    return _assemble(cfg, h, f, pm, pn, xr, yr, rmask, umask, vmask, pmask)


def build_curvilinear_grid(cfg: Config, xr, yr, pm, pn, f, h,
                           rmask=None, angler=None):
    """Build a Grid from caller-supplied curvilinear arrays (padded
    (ny_tot, nx_tot) numpy): the generic analytic-curvilinear path
    (ana_grid.h LAB_CANYON-style polar set-ups).  dndx/dmde follow from
    pm/pn like metrics.F; staggered masks like set_masks.F."""
    xr = np.asarray(xr, np.float64)
    arrs = [np.asarray(a, np.float64) for a in (h, f, pm, pn)]
    h, f, pm, pn = (_fill_periodic(cfg, a) for a in arrs)
    if rmask is None:
        rmask = np.ones_like(h)
    else:
        rmask = _fill_periodic(cfg, np.asarray(rmask, np.float64))
    umask = rmask * np.roll(rmask, 1, axis=-1)
    vmask = rmask * np.roll(rmask, 1, axis=-2)
    pmask = umask * np.roll(umask, 1, axis=-2)
    return _assemble(cfg, h, f, pm, pn, xr,
                     np.asarray(yr, np.float64), rmask, umask, vmask,
                     pmask, angler=angler)


def build_spherical_grid(cfg: Config, lon_size: float, lat_min: float,
                         lat_size: float, depth_fn: Callable):
    """Spherical strip grid (BENCHMARK path, ana_grid.h:460-479,676-686).

    lonr = dx*(i-0.5), latr = lat_min + dy*(j-0.5);
    pm = Lm/(2*pi*Eradius*cos(lat)), pn = Mm*360/(2*pi*Eradius*lat_size);
    f = 2*Omega*sin(lat) with sidereal Omega (ana_grid.h:867-872).
    """
    dx = lon_size / cfg.Lm
    dy = lat_size / cfg.Mm
    i, j = _padded_index_grids(cfg)
    lonr = dx * (i - 0.5)
    latr = lat_min + dy * (j - 0.5)
    val1 = cfg.Lm / (2.0 * np.pi * C.Eradius)
    val2 = cfg.Mm * 360.0 / (2.0 * np.pi * C.Eradius * lat_size)
    pm = val1 / np.cos(latr * C.deg2rad)
    pn = np.full_like(latr, val2)
    f = C.omega_benchmark * np.sin(latr * C.deg2rad)

    h = np.asarray(depth_fn(lonr, latr, i, j, cfg), dtype=np.float64)
    for a in (h, f, pm, pn):
        a[...] = _fill_periodic(cfg, a)
    rmask = np.ones_like(h)

    return _assemble(cfg, h, f, pm, pn, lonr, latr,
                     rmask, rmask.copy(), rmask.copy(), rmask.copy())


def _assemble(cfg: Config, h, f, pm, pn, xr, yr, rmask, umask, vmask, pmask,
              angler=None):
    # curvilinear curvature terms (metrics.F: dndx = d(1/pn)/dxi at rho, via
    # centered difference of u/v-point values; uniform grids give zero)
    if cfg.curvgrid:
        inv_pn = 1.0 / pn
        inv_pm = 1.0 / pm
        dndx = 0.5 * (np.roll(inv_pn, -1, -1) - np.roll(inv_pn, 1, -1))
        dmde = 0.5 * (np.roll(inv_pm, -1, -2) - np.roll(inv_pm, 1, -2))
    else:
        dndx = np.zeros_like(pm)
        dmde = np.zeros_like(pm)

    for a in (h, f, pm, pn, rmask, umask, vmask, pmask, dndx, dmde):
        a[...] = _fill_closed_halo(cfg, a)

    H = cfg.halo
    interior = (slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
    hmin = float(np.min(h[interior]))
    hmax = float(np.max(h[interior]))
    hc = vgrid.compute_hc(cfg.vtransform, cfg.tcline, hmin)
    sc_r, Cs_r, sc_w, Cs_w = vgrid.scoord(
        cfg.vstretching, cfg.theta_s, cfg.theta_b, cfg.N)
    w1, w2, nfast = build_weights(cfg.ndtfast)
    cfg = cfg.replace(hmin=hmin, nfast=nfast)
    # stash hc on the config via tcline-normalized value: hc is fully
    # determined by (vtransform, tcline, hmin) -> recompute where needed
    dtype = jnp.dtype(cfg.dtype)
    jnpa = lambda a: jnp.asarray(a, dtype=dtype)
    grid = Grid(
        h=jnpa(h), f=jnpa(f), pm=jnpa(pm), pn=jnpa(pn),
        xr=jnpa(xr), yr=jnpa(yr),
        rmask=jnpa(rmask), umask=jnpa(umask), vmask=jnpa(vmask),
        pmask=jnpa(pmask), dndx=jnpa(dndx), dmde=jnpa(dmde),
        angler=jnpa(np.zeros_like(h) if angler is None
                    else _fill_closed_halo(cfg, angler)),
        sc_r=jnpa(sc_r), Cs_r=jnpa(Cs_r), sc_w=jnpa(sc_w), Cs_w=jnpa(Cs_w),
        weight1=jnpa(w1), weight2=jnpa(w2),
        visc_factor=jnpa(np.ones_like(h)), diff_factor=jnpa(np.ones_like(h)),
    )
    return grid, cfg


def hc_of(cfg: Config) -> float:
    return vgrid.compute_hc(cfg.vtransform, cfg.tcline, cfg.hmin)


def add_sponge(grid: Grid, cfg: Config, width: int, factor: float,
               sides=("west", "south", "east", "north")) -> Grid:
    """Linear sponge layers: ramp visc/diff factors from `factor` at open
    edges to 1 over `width` interior cells (ini_hmixcoef.F sponge logic)."""
    H = cfg.halo
    vf = np.asarray(grid.visc_factor).copy()
    ny, nx = vf.shape
    ramp = np.linspace(factor, 1.0, width, endpoint=False)
    for w in range(width):
        r = ramp[w]
        if "west" in sides and not cfg.ew_periodic:
            vf[:, H + w] = np.maximum(vf[:, H + w], r)
        if "east" in sides and not cfg.ew_periodic:
            vf[:, H + cfg.Lm - 1 - w] = np.maximum(
                vf[:, H + cfg.Lm - 1 - w], r)
        if "south" in sides and not cfg.ns_periodic:
            vf[H + w, :] = np.maximum(vf[H + w, :], r)
        if "north" in sides and not cfg.ns_periodic:
            vf[H + cfg.Mm - 1 - w, :] = np.maximum(
                vf[H + cfg.Mm - 1 - w, :], r)
    vfj = jnp.asarray(vf, dtype=grid.visc_factor.dtype)
    return grid.replace(visc_factor=vfj, diff_factor=vfj)
