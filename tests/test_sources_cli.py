"""Point sources (river runoff) and the CLI/YAML front end."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roms_tpu.config import Config, LBC
from roms_tpu.grid import build_grid
from roms_tpu.state import initial_state
from roms_tpu.ops import bc
from roms_tpu.ops.sources import PointSources
from roms_tpu import stepping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_river_source_freshens_and_fills():
    """One u-face river discharging fresh water into a closed basin:
    salinity near the mouth drops, total volume rises by ~Qbar*t."""
    clo = LBC()
    cfg = Config(name="river", Lm=20, Mm=10, N=6, ntracers=2,
                 ew_periodic=False, ns_periodic=False,
                 dt=120.0, ndtfast=10,
                 uv_vis2=True, visc2=20.0, bottom_drag="linear",
                 rdrg=3e-4, eos="linear", Scoef=7.6e-4, Tcoef=1.7e-4,
                 lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo, lbc_u=clo,
                 lbc_v=clo, lbc_t=clo)
    grid, cfg = build_grid(cfg, 20e3, 10e3, f0=0.0, beta=0.0,
                           depth_fn=lambda x, y, i, j, c: 10.0 + 0 * x)
    H = cfg.halo
    temp = jnp.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 14.0)
    salt = jnp.full_like(temp, 30.0)
    s0 = initial_state(cfg, t=jnp.stack([temp, salt]))

    Qbar = 500.0     # m3/s river
    nsrc = 1
    src = PointSources(
        isrc=jnp.array([H]),              # western wall u-face
        jsrc=jnp.array([H + 5]),
        dsrc=jnp.array([0]),
        Qbar=jnp.array([Qbar]),
        Qshape=jnp.full((cfg.N, nsrc), 1.0 / cfg.N),
        Tsrc=jnp.stack([jnp.full((cfg.N, nsrc), 14.0),
                        jnp.zeros((cfg.N, nsrc))]))   # fresh water

    def ffn(cfg, grid, time):
        return {"sources": src}

    stepf = stepping.make_stepper(cfg, grid, ffn, donate=False)
    s = s0
    nsteps = 40
    for _ in range(nsteps):
        s = stepf(s)
    inter2 = np.s_[H:H + cfg.Mm, H:H + cfg.Lm]
    z = np.asarray(s.zeta[inter2])
    area = np.asarray(grid.omn[inter2])
    dvol = (z * area).sum()
    expected = Qbar * nsteps * cfg.dt
    assert np.isfinite(z).all()
    # volume added by the river (within 25%: free-surface waves slosh)
    assert 0.5 * expected < dvol < 1.5 * expected
    # salinity near the mouth is fresher than the far field
    S = np.asarray(s.t[1, -1])
    assert S[H + 5, H + 1] < 29.9
    assert S[H + 5, H + 15] > S[H + 5, H + 1]


def test_cli_run_and_cases(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "roms_tpu", "cases"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert out.returncode == 0
    assert "upwelling" in out.stdout and "benchmark" in out.stdout

    ycfg = tmp_path / "run.yaml"
    ycfg.write_text(
        "case: upwelling\nnsteps: 3\n"
        "config: {Lm: 12, Mm: 14, N: 4, ndtfast: 6}\n"
        f"output: {{his_file: {tmp_path}/his.nc, nhis: 3, ninfo: 2}}\n")
    out = subprocess.run(
        [sys.executable, "-m", "roms_tpu", "run", str(ycfg)],
        capture_output=True, text=True, cwd=REPO, env=env,
        timeout=500)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "roms_tpu: case=upwelling" in out.stdout
    from roms_tpu.io.netcdf import read_history
    h = read_history(str(tmp_path / "his.nc"))
    assert h["zeta"].shape[0] == 1
