"""File-driven realistic run, end-to-end through the CLI (VERDICT r4
item 8): a DAMEE-class cropped spherical domain whose grid, initial
state and surface forcing all come from NetCDF files (GRDNAME /
ININAME / FRCNAME analogs), run via `python -m roms_tpu run case.yaml`
with history output, then verified from the written file."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import yaml
from scipy.io import netcdf_file

from roms_tpu.config import Config
from roms_tpu.grid import build_spherical_grid
from roms_tpu.io import gridfile
from roms_tpu.state import initial_state
from roms_tpu.ops import bc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_domain(tmp):
    """Cropped North-Atlantic-style domain (the damee_4.h class: real
    spherical metrics, tanh shelf bathymetry, JM95 EOS, wind-forced)."""
    cfg = Config(
        name="damee_crop", Lm=20, Mm=16, N=6, ntracers=2,
        ew_periodic=False, ns_periodic=False, spherical=True,
        dt=600.0, ndtfast=20, solve3d=True,
        vtransform=2, vstretching=4, theta_s=5.0, theta_b=0.4,
        tcline=200.0,
        uv_adv=True, uv_cor=True, curvgrid=True,
        uv_vis2=True, visc2=1000.0,
        ts_dif2=True, tnu2=(100.0, 100.0), ts_mix_geo=True,
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="quadratic", rdrg2=3.0e-3,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        vmix="gls", eos="jm95", rho0=1025.0,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        dtype="float64")

    def depth(lonr, latr, i, j, c):
        return 200.0 + 4300.0 * 0.5 * (
            1.0 + np.tanh((lonr + 70.0) / 3.0))

    grid, cfg = build_spherical_grid(cfg, lon_size=10.0, lat_min=30.0,
                                     lat_size=8.0, depth_fn=depth)
    # stratified initial state
    from roms_tpu import vgrid
    from roms_tpu.grid import hc_of
    z_r, _, _ = vgrid.set_depth(grid.h, jnp.zeros_like(grid.h),
                                hc_of(cfg), grid.sc_r, grid.Cs_r,
                                grid.sc_w, grid.Cs_w, cfg.vtransform)
    temp = 4.0 + 18.0 * jnp.exp(z_r / 800.0)
    salt = 35.0 - 0.5 * jnp.exp(z_r / 500.0)
    t0 = jnp.stack([bc.fill_halo(cfg, temp), bc.fill_halo(cfg, salt)])
    state0 = initial_state(cfg, t=t0)
    return cfg, grid, state0


@pytest.mark.smoke
def test_file_driven_realistic_cli(tmp_path):
    cfg, grid, state0 = _make_domain(tmp_path)
    H = cfg.halo

    # ---- GRDNAME: write + reread the grid ----
    grd = str(tmp_path / "crop_grd.nc")
    gridfile.save_grid(grd, cfg, grid)

    # ---- ININAME: a short spin-up written as history, reread ----
    ini = str(tmp_path / "crop_ini.nc")
    from roms_tpu.io import netcdf as nc
    w = nc.HistoryWriter(ini, cfg, grid)
    w.write(state0)
    w.close()

    # ---- FRCNAME: two-record wind-stress series (days) ----
    frc = str(tmp_path / "crop_frc.nc")
    f = netcdf_file(frc, "w")
    f.createDimension("sms_time", 2)
    f.createDimension("eta_rho", cfg.Mm)
    f.createDimension("xi_rho", cfg.Lm)
    tv = f.createVariable("sms_time", "d", ("sms_time",))
    tv[:] = np.array([0.0, 1.0])          # days
    su = f.createVariable("sustr", "d", ("sms_time", "eta_rho", "xi_rho"))
    sv = f.createVariable("svstr", "d", ("sms_time", "eta_rho", "xi_rho"))
    lat = np.asarray(grid.yr)[H:H + cfg.Mm, H:H + cfg.Lm]
    su[:] = np.stack([1e-4 * np.cos(np.pi * (lat - 34.0) / 8.0)] * 2)
    sv[:] = np.zeros((2, cfg.Mm, cfg.Lm))
    f.close()

    # ---- the run configuration (roms_*.in analog) ----
    his = str(tmp_path / "crop_his.nc")
    doc = {
        "case": "file",
        "grid_file": grd,
        "ini_file": ini,
        "frc_file": frc,
        "frc_cycle": 2.0 * 86400.0,
        "nsteps": 6,
        "config": {
            "name": "damee_crop", "N": 6, "ntracers": 2,
            "dt": 600.0, "ndtfast": 20,
            "vtransform": 2, "vstretching": 4,
            "theta_s": 5.0, "theta_b": 0.4, "tcline": 200.0,
            "uv_adv": True, "uv_cor": True, "curvgrid": True,
            "spherical": True,
            "uv_vis2": True, "visc2": 1000.0,
            "ts_dif2": True, "tnu2": [100.0, 100.0],
            "ts_mix_geo": True,
            "splines_vdiff": True, "splines_vvisc": True,
            "bottom_drag": "quadratic", "rdrg2": 3.0e-3,
            "vmix": "gls", "eos": "jm95", "rho0": 1025.0,
            "t_hadv": ["U3", "U3"], "t_vadv": ["C4", "C4"],
            "dtype": "float64",
        },
        "output": {"his_file": his, "nhis": 3, "ninfo": 3},
    }
    ypath = str(tmp_path / "crop.yaml")
    with open(ypath, "w") as fy:
        yaml.safe_dump(doc, fy)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "roms_tpu", "run", ypath],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]

    # ---- verify the history output ----
    with netcdf_file(his, "r", mmap=False) as fh:
        zeta = np.asarray(fh.variables["zeta"][:], np.float64)
        temp = np.asarray(fh.variables["temp"][:], np.float64)
        assert zeta.shape[0] >= 2          # >= 2 history records
        assert np.isfinite(zeta).all() and np.isfinite(temp).all()
        # wind-driven response developed
        u = np.asarray(fh.variables["u"][:], np.float64)
        assert np.abs(u[-1]).max() > 1e-6
        assert np.abs(u[-1]).max() < 5.0