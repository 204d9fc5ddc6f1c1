"""Per-stage device time, kernel launches and bytes of the BENCHMARK1
f32 step on the GPU, from one short jax.profiler trace.

    python scripts/trace_step.py [--nsteps 2] [--out chiprun_out/trace_step]

Compiles `stepping.run` over --nsteps steps, runs it once to warm up,
traces one more call, and reduces the trace with
roms_tpu.utils.stagetrace (device time and launches from the kernels'
hlo_op tags, bytes from the compiled HLO).  Prints a markdown table and
writes it with the raw numbers to <out>/stages.json.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

from roms_tpu import stepping  # noqa: E402
from roms_tpu.models import benchmark  # noqa: E402
from roms_tpu.utils import compcache, gpuinfo, stagetrace  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsteps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/trace_step")
    args = ap.parse_args()
    gpuinfo.require_gpu()
    compcache.enable()
    os.makedirs(args.out, exist_ok=True)
    card = gpuinfo.card()

    cfg = benchmark.make_config(dtype="float32")
    cfg, grid, state, ffn = benchmark.build(cfg)
    n = args.nsteps
    run = jax.jit(lambda g, s: stepping.run(cfg, g, s, n, ffn))
    t0 = time.perf_counter()
    compiled = run.lower(grid, state).compile()
    t_compile = time.perf_counter() - t0
    hlo = compiled.as_text()
    module = hlo.split()[1].rstrip(",")
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca

    state = compiled(grid, state)
    jax.block_until_ready(state)
    tdir = os.path.join(args.out, "trace")
    with jax.profiler.trace(tdir):
        t0 = time.perf_counter()
        state = compiled(grid, state)
        jax.block_until_ready(state)
        wall = time.perf_counter() - t0

    with open(os.path.join(args.out, "hlo.txt"), "w") as f:
        f.write(hlo)
    info = stagetrace.parse_hlo(hlo)
    events = stagetrace.device_events(tdir, module)
    table = stagetrace.stage_table(info, events, n)
    table.update(card=card, device_kind=jax.devices()[0].device_kind,
                 nsteps=n, compile_s=t_compile,
                 traced_wall_ms_per_step=wall * 1e3 / n,
                 cost_analysis_bytes=ca.get("bytes accessed", 0.0),
                 hlo_module=module,
                 xla_flags=os.environ.get("XLA_FLAGS", ""))
    with open(os.path.join(args.out, "stages.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print(f"card: {card}; BENCHMARK1 f32 (512x64x30), {n} steps traced; "
          f"XLA_FLAGS={table['xla_flags']!r}")
    print(f"compile {t_compile:.1f} s; traced wall "
          f"{wall * 1e3 / n:.3f} ms/step; device busy "
          f"{table['busy_ms_per_step']:.3f} ms/step; "
          f"unmatched events {table['unmatched_events']}")
    print(f"compiled.cost_analysis() bytes accessed (whole module): "
          f"{table['cost_analysis_bytes'] / 1e6:.1f} MB")
    print(stagetrace.format_table(table))


if __name__ == "__main__":
    main()
