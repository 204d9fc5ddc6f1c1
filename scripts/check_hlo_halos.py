"""Evidence check for SURVEY §5.7: the shard_map step's compiled HLO
must contain ONLY halo-width collective-permutes (the mp_exchange
message pattern), never full-array shifts.

Run on CPU: JAX_PLATFORMS=cpu python scripts/check_hlo_halos.py
Round-4 result (upwelling 24x16x4 over a 2x4 mesh, local block 14x12):
148 collective-permutes, all width-3 strips.
Round-5 result after the fast loop's per-substep exchanges were fused
into multi-field payloads (bc.fill_halo_multi; the mp_exchange
4-fields-per-message analog): 108, incl. [2,*]/[3,*]/[5,*] stacked
payloads; the per-substep fast-loop exchange count dropped ~2x.
"""
import os
import re
import sys
from collections import Counter

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
jax.config.update("jax_enable_x64", True)

from roms_tpu.utils import compcache
from roms_tpu.models import upwelling
from roms_tpu.parallel import smap
from roms_tpu.parallel.shard import make_mesh


def main():
    compcache.enable()
    cfg = upwelling.make_config(Lm=24, Mm=16, N=4, ndtfast=8)
    cfg, grid, s0, ffn = upwelling.build(cfg)
    mesh = make_mesh(jax.devices()[:8], shape=(2, 4))
    stepB = smap.make_smap_stepper(cfg, grid, mesh, ffn)
    sb = smap.block(cfg, mesh, s0)
    hlo = jax.jit(stepB).lower(sb).compile().as_text()
    c = Counter()
    for line in hlo.splitlines():
        if "collective-permute" in line and "start" not in line:
            m = re.search(r"= \w*f64\[([\d,]*)\]", line)
            if m:
                c[m.group(1)] += 1
    print("total collective-permute:", sum(c.values()))
    bad = []
    H = cfg.halo
    for sh, n in c.most_common():
        dims = [int(x) for x in sh.split(",")]
        print(f"  [{sh}] x{n}")
        if min(dims[-2:]) != H:
            bad.append(sh)
    if bad:
        print("FULL-ARRAY collectives found:", bad)
        sys.exit(1)
    print("OK: every collective is a halo-width strip")


if __name__ == "__main__":
    main()
