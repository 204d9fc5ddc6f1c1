"""Benchmark driver: BENCHMARK1-class workload on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload: the reference's BENCHMARK1 case (512x64x30, DT=150 s,
NDTFAST=20; ROMS/External/roms_benchmark1.in:94-96,224-226) with its full
physics: spherical grid, curvilinear metrics, JM95 EOS, KPP mixing, COARE
bulk fluxes from the analytic atmosphere, quadratic drag; float32.

vs_baseline is the measured fraction of an HBM-bandwidth roofline estimate
(BASELINE.md cost model: all stencil sweeps are bandwidth-bound;
bytes/point/step estimated below), since the reference repo publishes no
throughput numbers (BASELINE.md).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from roms_tpu.utils import compcache, gpuinfo  # noqa: E402


def _measure():
    from roms_tpu.models import benchmark
    from roms_tpu import stepping

    Lm, Mm, N = 512, 64, 30
    cfg = benchmark.make_config(Lm=Lm, Mm=Mm, N=N, dt=150.0, ndtfast=20,
                                dtype="float32")
    cfg, grid, state, ffn = benchmark.build(cfg)

    nsteps = 50
    runN = jax.jit(lambda g, s: stepping.run(cfg, g, s, nsteps, ffn),
                   donate_argnums=(1,))
    t0 = time.perf_counter()
    print("[bench] compiling ...", file=sys.stderr, flush=True)
    state = runN(grid, state)                # compile + warmup
    jax.block_until_ready(state)
    print(f"[bench] compile+warmup {time.perf_counter() - t0:.0f}s",
          file=sys.stderr, flush=True)

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        state = runN(grid, state)
    jax.block_until_ready(state)
    dt_wall = (time.perf_counter() - t0) / (reps * nsteps)
    return cfg, state, Lm, Mm, N, dt_wall


def main():
    dev = gpuinfo.require_gpu()[0]
    hbm_bw = gpuinfo.peak_hbm_bytes_per_s(dev)
    compcache.enable()
    print(f"[bench] {gpuinfo.card()} ({dev.device_kind})",
          file=sys.stderr, flush=True)
    cfg, state, Lm, Mm, N, dt_wall = _measure()

    pts = Lm * Mm * N
    pts_per_sec = pts / dt_wall

    # HBM roofline: the algorithmic speed-of-light for one step is
    # reading the full prognostic State once and writing it once (a
    # perfectly fused step cannot touch less): bytes_per_step =
    # 2 * sum(State leaf bytes).
    state_bytes = sum(np.prod(l.shape) * l.dtype.itemsize
                      for l in jax.tree_util.tree_leaves(state)
                      if hasattr(l, "shape"))
    bytes_per_step = 2.0 * state_bytes
    roofline_pts = hbm_bw / (bytes_per_step / pts)
    print(f"[bench] state {state_bytes/1e6:.1f} MB -> roofline "
          f"{roofline_pts:.3e} pts/s (sol {bytes_per_step/hbm_bw*1e3:.3f}"
          f" ms/step); measured {pts_per_sec:.3e}",
          file=sys.stderr, flush=True)
    finite = bool(np.isfinite(np.asarray(state.zeta)).all())

    print(json.dumps({
        "metric": "BENCHMARK1-grid (512x64x30) points/sec/chip"
                  + ("" if finite else " [NONFINITE]"),
        "value": round(pts_per_sec, 1),
        "unit": "grid-points/s/chip",
        "vs_baseline": round(pts_per_sec / roofline_pts, 4),
    }))


if __name__ == "__main__":
    main()
