"""Sharded (parallel) NetCDF output - the mod_pio_netcdf analog.

The reference's PIO path (ROMS/Modules/mod_pio_netcdf.F) lets every MPI
rank write its tile of each field directly, avoiding the master-rank
gather that serializes output at scale.  The JAX analog: each
JAX process writes ONLY its addressable shards of the NamedSharding'd
arrays to a process-local part file (`<base>.pNNN.nc`, NetCDF3 via
scipy, one variable per shard with global interior offsets recorded as
attributes), with no `device_get` of the global array anywhere.
`assemble()` merges part files into a canonical single NetCDF after the
run (the PIO "rearranger" step, done offline), and `read_sharded()`
reconstructs global arrays directly from the parts.

Single-host multi-device runs produce one part file; under
multi-process JAX each process produces its own, keyed by
`jax.process_index()`.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np
import jax
from scipy.io import netcdf_file

from ..config import Config

_FIELDS_2D = ("zeta", "ubar", "vbar")
_FIELDS_3D = ("u", "v")


def _interior_box(cfg: Config):
    H = cfg.halo
    return H, H + cfg.Mm, H, H + cfg.Lm


class ShardedHistoryWriter:
    """Per-process sharded history stream.

    Records, for every write, each addressable shard's overlap with the
    global interior box.  Variables are named `<field>_s<k>` with
    attributes eta0/xi0 (offsets into the interior domain).
    """

    def __init__(self, base: str, cfg: Config,
                 fields: Sequence[str] = _FIELDS_2D + _FIELDS_3D + ("t",)):
        self.base = base
        self.cfg = cfg
        self.fields = tuple(fields)
        self.path = f"{base}.p{jax.process_index():03d}.nc"
        self._nc = netcdf_file(self.path, "w")
        self._nc.createDimension("time", None)
        v = self._nc.createVariable("time", "d", ("time",))
        v.units = "seconds"
        self._nc.Lm = cfg.Lm
        self._nc.Mm = cfg.Mm
        self._nc.N = cfg.N
        self._nc.ntracers = cfg.ntracers
        self._vars: Dict[str, object] = {}
        self._nrec = 0
        self._dims: Dict[str, str] = {}

    def _dim(self, n: int) -> str:
        name = f"d{n}"
        if name not in self._dims:
            self._nc.createDimension(name, n)
            self._dims[name] = name
        return name

    def _shard_var(self, key: str, shape, eta0: int, xi0: int):
        if key not in self._vars:
            dims = ("time",) + tuple(self._dim(n) for n in shape)
            v = self._nc.createVariable(key, "d", dims)
            v.eta0 = eta0
            v.xi0 = xi0
            self._vars[key] = v
        return self._vars[key]

    def write(self, state, time: float):
        cfg = self.cfg
        r0, r1, c0, c1 = _interior_box(cfg)
        n = self._nrec
        self._nc.variables["time"][n] = float(time)
        for name in self.fields:
            arr = getattr(state, name)
            for k, shard in enumerate(arr.addressable_shards):
                idx = shard.index            # global slices, padded frame
                eta_sl = idx[-2] if idx[-2] != slice(None) else \
                    slice(0, arr.shape[-2])
                xi_sl = idx[-1] if idx[-1] != slice(None) else \
                    slice(0, arr.shape[-1])
                e0 = eta_sl.start or 0
                e1 = eta_sl.stop or arr.shape[-2]
                x0 = xi_sl.start or 0
                x1 = xi_sl.stop or arr.shape[-1]
                # overlap with the global interior box
                oe0, oe1 = max(e0, r0), min(e1, r1)
                ox0, ox1 = max(x0, c0), min(x1, c1)
                if oe0 >= oe1 or ox0 >= ox1:
                    continue                  # pure-halo shard
                data = np.asarray(shard.data)
                sub = data[..., oe0 - e0:oe1 - e0, ox0 - x0:ox1 - x0]
                v = self._shard_var(f"{name}_s{k}", sub.shape,
                                    oe0 - r0, ox0 - c0)
                v[n] = sub
        self._nrec += 1
        self._nc.flush()

    def close(self):
        self._nc.close()


def _global_shape(name: str, Mm: int, Lm: int, N: int, nt: int):
    if name in _FIELDS_2D:
        return (Mm, Lm)
    if name in _FIELDS_3D:
        return (N, Mm, Lm)
    if name == "t":
        return (nt, N, Mm, Lm)
    raise KeyError(name)


def read_sharded(base: str) -> Dict[str, np.ndarray]:
    """Reconstruct {field: (T, ...global interior...)} plus 'time' from
    all part files of a sharded stream."""
    parts = sorted(glob.glob(f"{base}.p*.nc"))
    if not parts:
        raise FileNotFoundError(f"no part files match {base}.p*.nc")
    out: Dict[str, np.ndarray] = {}
    time = None
    for path in parts:
        nc = netcdf_file(path, "r", mmap=False)
        Lm, Mm, N = int(nc.Lm), int(nc.Mm), int(nc.N)
        nt = int(nc.ntracers)
        time = np.asarray(nc.variables["time"][:])
        T = len(time)
        for key, v in nc.variables.items():
            if key == "time" or "_s" not in key:
                continue
            name = key.rsplit("_s", 1)[0]
            if name not in out:
                out[name] = np.zeros(
                    (T,) + _global_shape(name, Mm, Lm, N, nt))
            e0, x0 = int(v.eta0), int(v.xi0)
            blk = np.asarray(v[:])
            sh = blk.shape
            out[name][..., e0:e0 + sh[-2], x0:x0 + sh[-1]] = blk
        nc.close()
    out["time"] = time
    return out


def assemble(base: str, out_path: Optional[str] = None) -> str:
    """Merge the part files into one canonical NetCDF (the offline PIO
    rearranger).  Returns the output path."""
    out_path = out_path or f"{base}.nc"
    data = read_sharded(base)
    time = data.pop("time")
    nc = netcdf_file(out_path, "w")
    nc.createDimension("time", None)
    tv = nc.createVariable("time", "d", ("time",))
    dims = {}

    def dim(n):
        name = f"d{n}"
        if name not in dims:
            nc.createDimension(name, n)
            dims[name] = name
        return name

    for name, arr in data.items():
        v = nc.createVariable(
            name, "d", ("time",) + tuple(dim(n) for n in arr.shape[1:]))
        v[:] = arr
    tv[:] = time
    nc.close()
    return out_path
