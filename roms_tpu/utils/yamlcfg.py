"""YAML run configuration (the analog of the reference's roms_*.in keyword
scripts parsed by inp_par.F/read_phypar.F).

Schema::

    case: upwelling            # model case builder (models registry)
    nsteps: 1440               # NTIMES
    config:                    # overrides of Config fields (DT, NDTFAST...)
      dt: 300.0
      ndtfast: 30
      Lm: 41
    output:
      his_file: ocean_his.nc   # HISNAME
      nhis: 72                 # NHIS
      rst_file: ocean_rst      # RSTNAME
      nrst: 288                # NRST
      ninfo: 10                # NINFO
"""

from __future__ import annotations

import importlib
from typing import Tuple

CASES = {
    "upwelling": ("roms_tpu.models.upwelling", "build", "make_config"),
    "benchmark": ("roms_tpu.models.benchmark", "build", "make_config"),
    "soliton": ("roms_tpu.models.soliton", "build", "make_config"),
    "basin": ("roms_tpu.models.cases", "basin", None),
    "double_gyre": ("roms_tpu.models.cases", "double_gyre", None),
    "grav_adj": ("roms_tpu.models.cases", "grav_adj", None),
    "seamount": ("roms_tpu.models.cases", "seamount", None),
    "canyon3d": ("roms_tpu.models.cases", "canyon3d", None),
    "kelvin": ("roms_tpu.models.cases", "kelvin", None),
    "bio_toy": ("roms_tpu.models.bio_toy", "build", "make_config"),
    "sed_toy": ("roms_tpu.models.sed_toy", "build", "make_config"),
    "overflow": ("roms_tpu.models.cases", "overflow", None),
    "windbasin": ("roms_tpu.models.cases", "windbasin", None),
    "lake_signell": ("roms_tpu.models.cases", "lake_signell", None),
    "estuary": ("roms_tpu.models.cases", "estuary", None),
    "riverplume": ("roms_tpu.models.cases", "riverplume", None),
    "channel": ("roms_tpu.models.cases2", "channel", None),
    "flt_test": ("roms_tpu.models.cases2", "flt_test", None),
    "lmd_test": ("roms_tpu.models.cases2", "lmd_test", None),
    "mixed_layer": ("roms_tpu.models.cases2", "mixed_layer", None),
    "test_chan": ("roms_tpu.models.cases2", "test_chan", None),
    "sed_test1": ("roms_tpu.models.cases2", "sed_test1", None),
    "shoreface": ("roms_tpu.models.cases2", "shoreface", None),
    "riverplume2": ("roms_tpu.models.cases2", "riverplume2", None),
    "weddell": ("roms_tpu.models.cases2", "weddell", None),
    "bl_test": ("roms_tpu.models.cases2", "bl_test", None),
    "lab_canyon": ("roms_tpu.models.cases4", "lab_canyon", None),
    "channel_neck": ("roms_tpu.models.cases4", "channel_neck", None),
    "inlet_test": ("roms_tpu.models.cases4", "inlet_test", None),
    "test_head": ("roms_tpu.models.cases4", "test_head", None),
}


def build_from_yaml(path: str):
    """Returns (cfg, grid, state0, forcing_fn, run_opts dict)."""
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f)
    return build_from_dict(doc)


def build_from_dict(doc: dict):
    case = doc.get("case", "upwelling")
    if case == "file":
        # file-driven domain (get_grid/get_state path): grid_file is the
        # GRDNAME analog, ini_file the ININAME analog (io/gridfile.py)
        from ..io import gridfile
        cfg, grid = None, None
        overrides = dict(doc.get("config", {}) or {})
        grid_path = doc.get("grid_file")
        if not grid_path:
            raise ValueError("case 'file' requires grid_file")
        grid, cfg = gridfile.load_grid(grid_path, **overrides)
        ini_path = doc.get("ini_file")
        if ini_path:
            from ..io.gridfile import load_state
            state0 = load_state(cfg, ini_path, rec=doc.get("ini_rec", -1))
        else:
            from ..state import initial_state
            state0 = initial_state(cfg)
        # surface forcing file (FRCNAME analog): named time series read
        # through forcing.series_from_netcdf + two-snapshot interpolation
        forcing_fn = None
        frc_path = doc.get("frc_file")
        if frc_path:
            from .. import forcing as _frc
            frc_vars = doc.get("frc_vars", {
                "sustr": "sms_time", "svstr": "sms_time",
                "shflux": "shf_time", "swrad": "srf_time"})
            cycle = doc.get("frc_cycle")
            from scipy.io import netcdf_file
            with netcdf_file(frc_path, "r", mmap=False) as fnc:
                present = {v: tv for v, tv in frc_vars.items()
                           if v in fnc.variables}
            series = {v: _frc.series_from_netcdf(frc_path, v, tv,
                                                 cfg=cfg, cycle=cycle)
                      for v, tv in present.items()}
            # shflux (W/m2) -> kinematic heat flux enters stflux[0]
            def forcing_fn(c, g, t, _series=series):
                out = {}
                for v, fs in _series.items():
                    out[v] = _frc.series_interp(fs, t)
                if "shflux" in out:
                    import jax.numpy as jnp
                    rho0cp = c.rho0 * 3985.0
                    st = jnp.zeros((max(c.ntracers, 1),) +
                                   out["shflux"].shape,
                                   out["shflux"].dtype)
                    out["stflux"] = st.at[0].set(out.pop("shflux") /
                                                 rho0cp)
                if "swrad" in out:
                    out["srflx"] = out.pop("swrad") / (c.rho0 * 3985.0)
                return out
        run_opts = dict(doc.get("output", {}) or {})
        run_opts["nsteps"] = int(doc.get("nsteps", 0))
        run_opts["mode"] = "3d"
        return cfg, grid, state0, forcing_fn, run_opts
    if case not in CASES:
        raise ValueError(f"unknown case '{case}'; known: {sorted(CASES)}")
    modname, buildname, mkcfgname = CASES[case]
    mod = importlib.import_module(modname)
    overrides = doc.get("config", {}) or {}

    if mkcfgname is not None:
        mkcfg = getattr(mod, mkcfgname)
        import inspect
        sig = inspect.signature(mkcfg)
        mk_kwargs = {k: v for k, v in overrides.items()
                     if k in sig.parameters}
        cfg = mkcfg(**mk_kwargs)
        rest = {k: v for k, v in overrides.items()
                if k not in sig.parameters}
        if rest:
            cfg = cfg.replace(**rest)
        out = getattr(mod, buildname)(cfg)
    else:
        builder = getattr(mod, buildname)
        import inspect
        sig = inspect.signature(builder)
        b_kwargs = {k: v for k, v in overrides.items()
                    if k in sig.parameters}
        out = builder(**b_kwargs)

    if len(out) == 4:
        cfg, grid, state0, forcing_fn = out
        mode = "3d"
    else:                       # 2D-only cases (soliton): (cfg, grid, fs)
        cfg, grid, state0 = out
        forcing_fn = None
        mode = "2d"
    run_opts = dict(doc.get("output", {}) or {})
    run_opts["nsteps"] = int(doc.get("nsteps", 0))
    run_opts["mode"] = mode
    return cfg, grid, state0, forcing_fn, run_opts
