"""XLA cost analysis of the compiled BENCHMARK1 f32 step on the GPU:
bytes accessed, flops, and the time those bytes take at the card's
published HBM bandwidth.

    python scripts/cost_analysis.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

from roms_tpu import stepping  # noqa: E402
from roms_tpu.models import benchmark  # noqa: E402
from roms_tpu.utils import compcache, gpuinfo  # noqa: E402


def main():
    dev = gpuinfo.require_gpu()[0]
    bw = gpuinfo.peak_hbm_bytes_per_s(dev)
    compcache.enable()
    cfg = benchmark.make_config(dtype="float32")
    cfg, grid, state, ffn = benchmark.build(cfg)

    one = jax.jit(lambda g, s: stepping.step(cfg, g, s, ffn))
    c = one.lower(grid, state).compile()
    ca = c.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    by = ca.get("bytes accessed", 0.0)
    print(f"card                 : {gpuinfo.card()} ({dev.device_kind})")
    print(f"bytes accessed / step: {by / 1e6:10.1f} MB")
    print(f"flops / step         : {ca.get('flops', 0.0) / 1e9:10.2f} GF")
    print(f"transcendentals      : "
          f"{ca.get('transcendentals', 0.0) / 1e6:10.1f} M")
    print(f"bytes at {bw / 1e12:.2f} TB/s : {by / bw * 1e3:10.3f} ms")
    mem = c.memory_analysis()
    print("temp size   :", mem.temp_size_in_bytes)
    print("output size :", mem.output_size_in_bytes)


if __name__ == "__main__":
    main()
