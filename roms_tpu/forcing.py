"""Time-dependent input forcing: snapshot series with linear time
interpolation and cycling.

JAX equivalent of the reference's forcing pipeline
(ROMS/Utility/get_cycle.F cycle resolution, get_2dfld/get_3dfld.F
snapshot reads, set_2dfld/set_3dfld.F two-snapshot linear time
interpolation, called per step from get_data/set_data - main3d.F:207,
222).  Instead of the read-ahead state machine, the whole record series
lives in device memory as a (nt, ...) array and the interpolation is a
jit-safe searchsorted + lerp; XLA hoists the gather out of the fast
loop.  For long series that do not fit in HBM, slice the series on the
host per segment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class ForcingSeries(NamedTuple):
    """Snapshot series of one field.

    times: (nt,) seconds, strictly increasing; data: (nt, ...) field
    snapshots; cycle: cycle length in seconds (get_cycle.F Lcycle /
    clength, e.g. 365.25 days of monthly climatology), or None for a
    bounded series (clamped outside its range, like the reference's
    persistence beyond Tmax with a warning)."""
    times: jax.Array
    data: jax.Array
    cycle: Optional[float] = None

    def at(self, time):
        return series_interp(self, time)


def make_series(times, data, cycle: Optional[float] = None,
                dtype=None) -> ForcingSeries:
    times = jnp.asarray(times, dtype)
    data = jnp.asarray(data, dtype)
    if times.ndim != 1 or data.shape[0] != times.shape[0]:
        raise ValueError("data leading dim must match times")
    if cycle is not None and float(times[-1]) > cycle:
        raise ValueError("record times exceed the cycle length")
    return ForcingSeries(times, data, cycle)


def series_interp(fs: ForcingSeries, time):
    """Two-snapshot linear interpolation at model time (seconds),
    set_2dfld.F:120-167 semantics with get_cycle.F cycling."""
    t = jnp.asarray(time, fs.times.dtype)
    nt = fs.times.shape[0]
    if fs.cycle is not None:
        tmod = jnp.mod(t, fs.cycle)
        # interior interval or the wrap interval [t_last, t_first+cycle)
        hi = jnp.searchsorted(fs.times, tmod, side="right")
        in_wrap = (hi <= 0) | (hi >= nt)
        i0 = jnp.where(in_wrap, nt - 1, jnp.clip(hi - 1, 0, nt - 1))
        i1 = jnp.where(in_wrap, 0, jnp.clip(hi, 0, nt - 1))
        t0 = fs.times[i0]
        t1 = fs.times[i1]
        # distance across the wrap: (cycle - t_last) + t_first
        dt_wrap = fs.cycle - fs.times[nt - 1] + fs.times[0]
        span = jnp.where(in_wrap, dt_wrap, t1 - t0)
        dist = jnp.where(in_wrap,
                         jnp.mod(tmod - t0 + fs.cycle, fs.cycle),
                         tmod - t0)
        w = jnp.where(span > 0, dist / jnp.where(span > 0, span, 1.0),
                      0.0)
    else:
        hi = jnp.searchsorted(fs.times, t, side="right")
        i0 = jnp.clip(hi - 1, 0, nt - 1)
        i1 = jnp.clip(hi, 0, nt - 1)
        span = fs.times[i1] - fs.times[i0]
        w = jnp.where(span > 0,
                      (t - fs.times[i0]) / jnp.where(span > 0, span,
                                                     1.0), 0.0)
        w = jnp.clip(w, 0.0, 1.0)      # persist first/last outside range
    lo = fs.data[i0]
    hiv = fs.data[i1]
    return (1.0 - w) * lo + w * hiv


def make_forcing_fn(series: dict, base_fn=None, statics: dict = None):
    """Build a forcing_fn(cfg, grid, time) from ForcingSeries fields.

    series: {"sustr": ForcingSeries, ...}; statics: time-constant
    entries merged verbatim; base_fn: optional underlying forcing_fn
    whose dict is updated (file fields win, like get_data overriding
    analytic defaults)."""
    statics = statics or {}

    def forcing_fn(cfg, grid, time):
        frc = dict(base_fn(cfg, grid, time)) if base_fn else {}
        frc.update(statics)
        for name, fs in series.items():
            frc[name] = series_interp(fs, time)
        return frc

    return forcing_fn


def series_from_netcdf(path: str, var: str, time_var: str,
                       cfg=None, cycle: Optional[float] = None,
                       time_scale: float = 86400.0):
    """Load a snapshot series from a NetCDF forcing file (scipy
    backend, like io/netcdf.py).  time_scale converts the file's time
    units to seconds (ROMS forcing times are in days -> 86400).  When
    cfg is given, interior-sized fields (Mm x Lm or rho-grid
    (Mm+2) x (Lm+2)) are embedded into halo-padded arrays with
    edge/periodic fill."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        times = np.array(f.variables[time_var][:], np.float64) * \
            time_scale
        data = np.array(f.variables[var][:], np.float64)
    if cfg is not None and data.ndim >= 3:
        data = np.stack([embed_padded(cfg, rec) for rec in data])
    return make_series(times, data, cycle=cycle)


def embed_padded(cfg, rec: np.ndarray) -> np.ndarray:
    """Place an interior (Mm,Lm) or rho-boundary ((Mm+2),(Lm+2)) record
    into a halo-padded array (edge-replicated; periodic wrap is applied
    by the runtime halo fill)."""
    H = cfg.halo
    out = np.zeros(rec.shape[:-2] + (cfg.ny_tot, cfg.nx_tot),
                   rec.dtype)
    if rec.shape[-2:] == (cfg.Mm, cfg.Lm):
        j0, i0 = H, H
    elif rec.shape[-2:] == (cfg.Mm + 2, cfg.Lm + 2):
        j0, i0 = H - 1, H - 1
    else:
        raise ValueError(f"unexpected record shape {rec.shape[-2:]} "
                         f"for Lm={cfg.Lm} Mm={cfg.Mm}")
    out[..., j0:j0 + rec.shape[-2], i0:i0 + rec.shape[-1]] = rec
    # replicate outward so halos are sane
    out[..., :j0, :] = out[..., j0:j0 + 1, :]
    jend = j0 + rec.shape[-2]
    out[..., jend:, :] = out[..., jend - 1:jend, :]
    out[..., :, :i0] = out[..., :, i0:i0 + 1]
    iend = i0 + rec.shape[-1]
    out[..., :, iend:] = out[..., :, iend - 1:iend]
    return out
