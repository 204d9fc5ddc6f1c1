"""Smoke run of the ocean core on one GPU, through its user entry points.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-gpu    # phase 7 only, on four cards

Phases (any failure exits non-zero; nothing is turned into a pass):

1. device     - JAX's default backend must be a GPU (no CPU fallback);
                prints the card's name and power limit.
2. cli        - ``python -m roms_tpu run --case upwelling`` in-process
                (``roms_tpu.__main__.main``), 50 steps with history.
3. simulation - BENCHMARK1 (512x64x30, f32) through driver.Simulation:
                40 steps, history every 20, restart at 40.
4. restart    - 4 straight steps == 2 steps + save + restore + 2 steps,
                bit for bit on every State leaf.
5. reference  - 3 BENCHMARK1 steps: f64 on the GPU against the plain
                reference (f64 on the host CPU), and f32 against f64 on
                the GPU.
6. benchmark3 - BENCHMARK3 (2048x256x30, f32) through stepping.run for
                10 steps: compile time, step time, memory.
7. four-gpu   - BENCHMARK3 through parallel/smap on a 2x2 mesh of four
                cards against stepping.run on one card: f32 for 10
                steps, then f64 for 5 steps to a tight limit (a halo
                or collective fault shows there, not f32 noise); the
                last sharded step of each is profiled for its NCCL
                kernels.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from roms_tpu import stepping  # noqa: E402
from roms_tpu.io import checkpoint  # noqa: E402
from roms_tpu.models import benchmark  # noqa: E402
from roms_tpu.utils import compcache, diag, gpuinfo  # noqa: E402

# Fields compared against a reference, as (label, State field, tracer).
FIELDS = (("zeta", "zeta", None), ("ubar", "ubar", None),
          ("vbar", "vbar", None), ("u", "u", None), ("v", "v", None),
          ("T", "t", 0), ("S", "t", 1))

# Tolerances on max|a - ref| / max|ref| over the interior, per field.
# Starting from rest, zeta after a few steps is ~1e-4 m while set_depth
# adds it to depths of up to 4000 m, so z_w/Hz (and through them every
# field) resolve zeta only to the precision's ulp of 4000 m: 2.4e-4 m in
# f32, 9e-13 m in f64.  The 2-D fields and the velocities they drive
# therefore carry relative errors far above the precision's epsilon,
# while T and S (order 1-35 and barely changed in 3 steps) do not.
FLOW = ("zeta", "ubar", "vbar", "u", "v")
# (a) f64 on the GPU against f64 on the CPU: the same f64 arithmetic in
#     another order (fusion, FMA contraction) and another libm (exp, log,
#     pow, tanh in COARE, KPP and JM95).  Scaling the f32-vs-f64 error
#     measured on the CPU (zeta 5.5e-2 at 64x16x30) by eps64/eps32 gives
#     ~1e-10 for the flow fields; 1e-8 leaves 100x room and still fails
#     on any real difference between the two compiled programs.  On the
#     card: 7.2e-11 at most (flow), 8.3e-15 (T, S).  The same limits hold
#     the f64 2x2-mesh step to one card (phase 7), where only the local
#     block shapes change XLA's fusion and summation order.
TOL_F64 = {k: 1e-8 for k in FLOW} | {"T": 1e-12, "S": 1e-12}
# (b) f32 against f64, both on the GPU, 3 steps.  Each limit is 3x the
#     H100's reading at BENCHMARK1 (zeta 2.516e-2, ubar 7.425e-3, vbar
#     7.865e-3, u 1.382e-4, v 1.465e-2, T 1.052e-6, S 2.180e-6; the
#     compiled program is deterministic, and the readings repeat to the
#     last digit), rounded up to two digits.  Longer runs do not tighten
#     this: on the card the max-norm differences grow with the step
#     count (u 2.1e-2 at 20 steps, 0.50 at 320) as KPP thresholds flip
#     at single points.
TOL_F32_F64 = {"zeta": 7.6e-2, "ubar": 2.3e-2, "vbar": 2.4e-2,
               "u": 4.2e-4, "v": 4.4e-2, "T": 3.2e-6, "S": 6.6e-6}
# Phase 7: f32 on a 2x2 mesh against one card, 10 steps.  The blocks
# compute the same stencils but XLA fuses the local shapes differently
# (other FMA contraction and summation order), and f32 amplifies that
# through zeta as above.  On four H100s: zeta 1.623e-2, ubar 7.161e-3,
# vbar 5.087e-3, u 7.013e-4, v 3.551e-3, T 2.081e-06, S 2.943e-06.
# This bound only says the f32 result is usable; the f64 comparison of
# the same path to TOL_F64 is what tells a halo or collective fault
# from rounding.
TOL_SHARDED = {k: 2e-2 for k in FLOW} | {"T": 1e-4, "S": 1e-4}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def field_values(cfg, state):
    """{label: interior numpy array} for the FIELDS of a State."""
    out = {}
    for label, name, itrc in FIELDS:
        a = np.asarray(jax.device_get(getattr(state, name)), np.float64)
        if itrc is not None:
            a = a[itrc]
        out[label] = np.asarray(diag.interior2d(cfg, a))
    return out


def compare(cfg, state, ref):
    """{label: max|state - ref| / max|ref|} over the interior."""
    a, b = field_values(cfg, state), field_values(cfg, ref)
    out = {}
    for label in a:
        scale = float(np.max(np.abs(b[label])))
        diff = float(np.max(np.abs(a[label] - b[label])))
        out[label] = diff / scale if scale > 0 else diff
    return out


def check_within(name: str, rel: dict, tol: dict) -> None:
    log(f"[{name}] max|diff|/max|field| (tolerance): " +
        ", ".join(f"{k}={v:.3e} ({tol[k]:g})" for k, v in rel.items()))
    bad = {k: v for k, v in rel.items() if not v <= tol[k]}
    if bad:
        raise SystemExit(f"[{name}] outside tolerance: {bad}")


def copy_state(state, device=None):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(jax.device_get(x)), device),
        state)


def run_steps(cfg, grid, state, ffn, nsteps, device=None):
    """nsteps through stepping.make_stepper on `device` (default: the
    default device); jit runs where its committed arguments live."""
    g = copy_state(grid, device)
    s = copy_state(state, device)
    step = stepping.make_stepper(cfg, g, ffn)
    for _ in range(nsteps):
        s = step(s)
    return jax.block_until_ready(s)


def assert_finite(state, what: str) -> None:
    bad = [i for i, x in enumerate(jax.tree_util.tree_leaves(state))
           if not np.isfinite(np.asarray(jax.device_get(x))).all()]
    if bad:
        raise SystemExit(f"[{what}] non-finite State leaves {bad}")


def build_benchmark(Lm, Mm, N, dtype):
    return benchmark.build(benchmark.make_config(Lm=Lm, Mm=Mm, N=N,
                                                 dtype=dtype))


# ---------------------------------------------------------------- phases
def phase_cli(tmp: str, nsteps: int = 50) -> None:
    from roms_tpu.__main__ import main as roms_main
    from roms_tpu.io.netcdf import read_history
    his = os.path.join(tmp, "upwelling_his.nc")
    rc = roms_main(["run", "--case", "upwelling", "--nsteps", str(nsteps),
                    "--his", his])
    if rc != 0:
        raise SystemExit(f"[cli] main() returned {rc}")
    zeta = read_history(his)["zeta"]
    if zeta.shape[0] == 0 or not np.isfinite(zeta).all():
        raise SystemExit(f"[cli] history zeta empty or non-finite "
                         f"({zeta.shape[0]} records)")
    log(f"[cli] upwelling {nsteps} steps: rc=0, {zeta.shape[0]} history "
        f"records, max|zeta|={np.abs(zeta).max():.4e}")


def phase_simulation(built, tmp: str, card: str, nsteps: int = 40,
                     nhis: int = 20):
    """driver.Simulation with history and restart; returns final State."""
    from roms_tpu.driver import Simulation
    cfg, grid, state0, ffn = built
    rst = os.path.join(tmp, "bench_rst")
    sim = Simulation(cfg, grid, state0, ffn,
                     his_file=os.path.join(tmp, "bench_his.nc"), nhis=nhis,
                     rst_file=rst, nrst=nsteps, ninfo=nhis,
                     log=lambda m: None)
    t0 = time.perf_counter()
    sim.run(1)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(nsteps - 1)
    jax.block_until_ready(sim.state)
    dt = time.perf_counter() - t0
    sim.finalize()
    state = sim.state
    assert_finite(state, "simulation")
    d = jax.device_get(diag.diagnostics(cfg, grid, state))
    if bool(diag.blowup(cfg, d)):
        raise SystemExit(f"[simulation] blowup: {d}")
    restored = checkpoint.restore(rst, state)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(state),
                                   jax.tree_util.tree_leaves(restored))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"restart file leaf {i}")
    pts = cfg.Lm * cfg.Mm * cfg.N
    rate = (nsteps - 1) / dt
    log(f"[simulation] {cfg.Lm}x{cfg.Mm}x{cfg.N} {cfg.dtype}: compile + "
        f"first step {t_compile:.1f} s")
    log(f"[simulation] {nsteps - 1} steps after warm-up (history at every "
        f"{nhis}, restart at {nsteps}): {rate:.2f} steps/s, "
        f"{rate * pts:.4e} grid-points/s on {card}")
    log(f"[simulation] finite, no blowup: umax={float(d['umax']):.4e} "
        f"zmax={float(d['zmax']):.4e}; restart file == final state")
    return state


def phase_restart(built, tmp: str) -> None:
    """4 straight steps == 2 + save + restore + 2, bit for bit."""
    cfg, grid, state0, ffn = built
    step = stepping.make_stepper(cfg, grid, ffn)
    a = copy_state(state0)
    for _ in range(4):
        a = step(a)
    b = copy_state(state0)
    for _ in range(2):
        b = step(b)
    path = os.path.join(tmp, "restart_check")
    checkpoint.save(path, b)
    b = checkpoint.restore(path, b)
    for _ in range(2):
        b = step(b)
    leaves_a, treedef = jax.tree_util.tree_flatten(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    names = [str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(a)[0]]
    differ = [n for n, x, y in zip(names, leaves_a, leaves_b)
              if not np.array_equal(np.asarray(x), np.asarray(y))]
    if differ:
        raise SystemExit(f"[restart] leaves differ: {differ}")
    log(f"[restart] 4 steps == 2 + save/restore + 2, bitwise on all "
        f"{len(leaves_a)} State leaves")


def count_dots(cfg, grid, state, ffn) -> int:
    """dot_general ops in the lowered step (TF32 could enter only there)."""
    text = jax.jit(lambda g, s: stepping.step(cfg, g, s, ffn)).lower(
        grid, state).as_text()
    return text.count("dot_general")


def phase_reference(Lm, Mm, N, device, host, nsteps: int = 3,
                    built32=None):
    """(a) f64 on `device` vs f64 on `host`; (b) f32 vs f64 on `device`.
    Returns the two comparison dicts."""
    b64 = build_benchmark(Lm, Mm, N, "float64")
    cfg64 = b64[0]
    ndots = count_dots(*b64[:3], b64[3])
    if ndots:
        raise SystemExit(f"[reference] {ndots} dot_general ops in the step")
    ref = run_steps(*b64, nsteps, device=host)
    dev64 = run_steps(*b64, nsteps, device=device)
    rel_a = compare(cfg64, dev64, ref)
    b32 = built32 or build_benchmark(Lm, Mm, N, "float32")
    dev32 = run_steps(*b32, nsteps, device=device)
    rel_b = compare(cfg64, dev32, dev64)
    return rel_a, rel_b


def phase_benchmark3(built, card: str, nsteps: int = 10) -> None:
    cfg, grid, state, ffn = built
    run = jax.jit(lambda g, s: stepping.run(cfg, g, s, nsteps, ffn),
                  donate_argnums=(1,))
    t0 = time.perf_counter()
    compiled = run.lower(grid, state).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    state = jax.block_until_ready(compiled(grid, state))
    t0 = time.perf_counter()
    state = jax.block_until_ready(compiled(grid, state))
    dt = (time.perf_counter() - t0) / nsteps
    assert_finite(state, "benchmark3")
    stats = jax.devices()[0].memory_stats() or {}
    pts = cfg.Lm * cfg.Mm * cfg.N
    log(f"[benchmark3] {cfg.Lm}x{cfg.Mm}x{cfg.N} {cfg.dtype} via "
        f"stepping.run({nsteps}): compile {t_compile:.1f} s")
    log(f"[benchmark3] {dt * 1e3:.3f} ms/step, {pts / dt:.4e} "
        f"grid-points/s on {card}")
    log(f"[benchmark3] memory_analysis: "
        f"argument {mem.argument_size_in_bytes / 1e9:.3f} GB, "
        f"output {mem.output_size_in_bytes / 1e9:.3f} GB, "
        f"temp {mem.temp_size_in_bytes / 1e9:.3f} GB, "
        f"alias {mem.alias_size_in_bytes / 1e9:.3f} GB")
    log(f"[benchmark3] peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use', 0) / 1e9:.3f} GB")


def trace_sharded_step(stepB, sb, trace_dir: str):
    """One traced sharded step: per-device launches, NCCL kernels and
    busy time from the trace's device planes.  Returns the new state."""
    from roms_tpu.utils import stagetrace
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        sb = jax.block_until_ready(stepB(sb))
        wall = time.perf_counter() - t0
    rows = stagetrace.collective_table(stagetrace.device_planes(trace_dir),
                                       nsteps=1)
    log(f"[four-gpu] traced step: wall {wall * 1e3:.3f} ms")
    for name, r in rows.items():
        per = r["collective_ms"] / r["collectives"] if r["collectives"] \
            else 0.0
        log(f"[four-gpu] {name}: {r['launches']:.0f} kernels, "
            f"{r['collectives']:.0f} NCCL kernels taking "
            f"{r['collective_ms']:.3f} ms ({per * 1e3:.1f} us each), "
            f"busy {r['busy_ms']:.3f} ms of a {r['span_ms']:.3f} ms span")
    return sb


def phase_four_gpu(built, devices, card: str, nsteps: int = 10):
    """smap on a 2x2 mesh of devices[:4] vs stepping.run on devices[0];
    returns the comparison dict.  The last sharded step is traced and
    reduced, not timed."""
    from roms_tpu.parallel import shard, smap
    cfg, grid, state0, ffn = built
    mesh = shard.make_mesh(devices[:4], shape=(2, 2))
    sb = smap.block(cfg, mesh, state0)
    owners = {d for x in jax.tree_util.tree_leaves(sb)
              if getattr(x, "ndim", 0) >= 4 for d in x.devices()}
    if len(owners) != 4:
        raise SystemExit(f"[four-gpu] blocks live on {owners}")
    stepB = smap.make_smap_stepper(cfg, grid, mesh, ffn)
    t0 = time.perf_counter()
    sb = jax.block_until_ready(stepB(sb))
    t_compile4 = time.perf_counter() - t0
    # each step timed on its own, so that one-time set-up in an early
    # step shows instead of being spread over a mean
    times = []
    for _ in range(nsteps - 2):
        t0 = time.perf_counter()
        sb = jax.block_until_ready(stepB(sb))
        times.append(time.perf_counter() - t0)
    log(f"[four-gpu] 2x2 mesh, each step after the first (ms): " +
        ", ".join(f"{t * 1e3:.3f}" for t in times))
    with tempfile.TemporaryDirectory() as tdir:
        sb = trace_sharded_step(stepB, sb, tdir)
    sharded = smap.unblock(cfg, mesh, sb)

    run1 = jax.jit(lambda g, s: stepping.run(cfg, g, s, nsteps, ffn))
    g1, s1 = copy_state(grid, devices[0]), copy_state(state0, devices[0])
    jax.block_until_ready(run1(g1, s1))
    t0 = time.perf_counter()
    single = jax.block_until_ready(run1(g1, s1))
    dt1 = (time.perf_counter() - t0) / nsteps
    log(f"[four-gpu] {cfg.Lm}x{cfg.Mm}x{cfg.N} {cfg.dtype}, {nsteps} "
        f"steps: 1 card {dt1 * 1e3:.3f} ms/step, 2x2 mesh median "
        f"{np.median(times) * 1e3:.3f} ms/step (compile + first step "
        f"{t_compile4:.1f} s) on {card.replace(chr(10), ' | ')}")
    return compare(cfg, sharded, single)


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    jax.config.update("jax_enable_x64", True)
    devices = gpuinfo.require_gpu()
    compcache.enable()
    card = gpuinfo.card()
    print(card, flush=True)
    dev = devices[0]
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")

    if args.four_gpu:
        if len(devices) < 4:
            raise SystemExit(f"--four-gpu needs 4 GPUs, found {len(devices)}")
        for dtype, nsteps, tol in (("float32", 10, TOL_SHARDED),
                                   ("float64", 5, TOL_F64)):
            rel = phase_four_gpu(build_benchmark(2048, 256, 30, dtype),
                                 devices, card, nsteps=nsteps)
            check_within(f"four-gpu {dtype}", rel, tol)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)
            b1 = build_benchmark(512, 64, 30, "float32")
            phase_simulation(b1, tmp, card)
            phase_restart(b1, tmp)
        rel_a, rel_b = phase_reference(512, 64, 30, dev,
                                       jax.devices("cpu")[0], built32=b1)
        log("[reference] step lowers with 0 dot_general ops")
        check_within("reference f64 gpu vs f64 cpu", rel_a,
                     TOL_F64)
        check_within("reference f32 gpu vs f64 gpu", rel_b, TOL_F32_F64)
        del b1
        phase_benchmark3(build_benchmark(2048, 256, 30, "float32"), card)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
