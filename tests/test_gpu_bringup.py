"""The GPU bring-up surface, checked on the CPU: the core imports without
optional or TPU-only packages, the pytrees, restart files, compile-cache
location, the stage scopes in the lowered step, the trace reduction and
the entry points that must refuse to measure without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roms_tpu import stepping
from roms_tpu.io import checkpoint
from roms_tpu.models import benchmark, upwelling
from roms_tpu.ops.step2d import make_fast_state
from roms_tpu.state import State
from roms_tpu.utils import compcache, stagetrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == {mod!r} or name.startswith({mod!r} + "."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import roms_tpu.stepping, roms_tpu.driver, roms_tpu.__main__
assert not any(m == {mod!r} or m.startswith({mod!r} + ".")
               for m in sys.modules)
print("imported")
"""


@pytest.mark.parametrize("mod", ["jax.experimental.pallas.tpu", "flax",
                                 "orbax", "yaml"])
def test_core_imports_without(mod):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _BLOCKER.format(mod=mod)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "imported" in res.stdout


@pytest.fixture(scope="module")
def tiny_upwelling():
    cfg = upwelling.make_config(Lm=8, Mm=10, N=4, ndtfast=6)
    return upwelling.build(cfg)


def _instances(built):
    cfg, grid, state, _ = built
    fs = make_fast_state(cfg, state.zeta, state.ubar, state.vbar)
    return {"State": state, "Grid": grid, "Fast2DState": fs}


@pytest.mark.parametrize("kind", ["State", "Grid", "Fast2DState"])
def test_pytree_dataclass(tiny_upwelling, kind):
    obj = _instances(tiny_upwelling)[kind]
    assert type(obj).__name__ == kind
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(again) is type(obj)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(again)):
        assert a is b
    # every field is data: as many leaves as non-None fields
    fields = [f for f in vars(obj).values() if f is not None]
    assert len(leaves) == len(fields)
    names = [k for k, v in vars(obj).items() if v is not None]
    new = jnp.full_like(getattr(obj, names[0]), 7)
    changed = obj.replace(**{names[0]: new})
    assert type(changed) is type(obj)
    assert getattr(changed, names[0]) is new
    assert all(getattr(changed, k) is getattr(obj, k) for k in names[1:])
    with pytest.raises(Exception):
        setattr(obj, names[0], None)       # frozen
    out = jax.jit(lambda x: x)(obj)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compcache.enable() == str(tmp_path)
            # nothing set in code: JAX reads the variable itself
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert compcache.enable() == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == \
                os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_npz_restart_with_empty_bed_mass(tiny_upwelling, tmp_path):
    state = tiny_upwelling[2]
    assert state.bed_mass.size == 0
    path = str(tmp_path / "rst")
    checkpoint.save(path, state)
    assert os.path.exists(path + ".npz")
    back = checkpoint.restore(path, state)
    assert type(back) is State
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(back)):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def tiny_benchmark():
    return benchmark.build(benchmark.make_config(Lm=16, Mm=8, N=6,
                                                 ndtfast=6,
                                                 dtype="float32"))


@pytest.fixture(scope="module")
def lowered_step(tiny_benchmark):
    cfg, grid, state, ffn = tiny_benchmark
    return jax.jit(lambda g, s: stepping.step(cfg, g, s, ffn)).lower(
        grid, state)


def test_step_has_no_tpu_call_or_dot(lowered_step):
    text = lowered_step.as_text()
    for word in ("tpu_custom_call", "mosaic", "dot_general"):
        assert word not in text.lower(), word
    hlo = lowered_step.compile().as_text()
    assert "custom-call" not in hlo


def test_step_stage_scopes(lowered_step):
    """Every stage of the BENCHMARK step carries its named scope."""
    text = lowered_step.as_text(debug_info=True)
    expect = {"forcing", "bulk_flux", "diag", "set_vbc", "kpp",
              "pre_step3d", "prsgrd", "t3dmix", "rhs3d", "uv3dmix",
              "fast_loop", "step3d_uv", "step3d_t", stagetrace.VSOLVE}
    missing = {s for s in expect if f"/{s}/" not in text}
    assert not missing, missing


def test_stage_reduction_on_cpu_trace(tmp_path):
    def f(x):
        with jax.named_scope("diag"):
            x = x * 3.0

        def body(c, _):
            with jax.named_scope("fast_loop"):
                return jnp.sin(c) * 2.0, None
        return jax.lax.scan(body, x, None, length=5)[0]

    jf = jax.jit(f)
    x = jnp.ones((64, 128))
    compiled = jf.lower(x).compile()
    info = stagetrace.parse_hlo(compiled.as_text())
    fused = {d["stage"]: d for d in info.values()
             if d["stage"] != stagetrace.OTHER}
    assert fused["diag"]["count"] == 1
    assert fused["fast_loop"]["count"] == 5
    assert fused["fast_loop"]["bytes"] == 2 * x.size * x.dtype.itemsize
    jax.block_until_ready(compiled(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(compiled(x))
    module = compiled.as_text().split()[1].rstrip(",")
    events = stagetrace.device_events(str(tmp_path), module)
    table = stagetrace.stage_table(info, events, 1)
    rows = table["rows"]
    assert rows["fast_loop"]["launches"] == 5
    assert rows["diag"]["launches"] == 1
    assert rows["fast_loop"]["device_ms"] > 0
    assert table["busy_ms_per_step"] <= rows["total"]["device_ms"] + 1e-9
    assert "| fast_loop |" in stagetrace.format_table(table)


_SCAN_HLO = """HloModule jit_f, entry_computation_layout={()->f32[29,70,518]}

%fused_slice (p0: f32[29,70,518], p1: s32[]) -> f32[70,518] {
  %p0 = f32[29,70,518]{2,1,0} parameter(0)
  %p1 = s32[] parameter(1)
  %c0 = s32[] constant(0)
  %ds = f32[1,70,518]{2,1,0} dynamic-slice(%p0, %p1, %c0, %c0), dynamic_slice_sizes={1,70,518}
  ROOT %b = f32[70,518]{1,0} bitcast(%ds)
}

%fused_dus (q0: f32[29,70,518], q1: s32[], q2: f32[70,518]) -> f32[29,70,518] {
  %q0 = f32[29,70,518]{2,1,0} parameter(0)
  %q2 = f32[70,518]{1,0} parameter(2)
  %bq = f32[1,70,518]{2,1,0} bitcast(%q2)
  %q1 = s32[] parameter(1)
  %z = s32[] constant(0)
  ROOT %dus = f32[29,70,518]{2,1,0} dynamic-update-slice(%q0, %bq, %q1, %z, %z)
}

%body (t: (s32[], f32[29,70,518], f32[29,70,518])) -> (s32[], f32[29,70,518], f32[29,70,518]) {
  %t = (s32[], f32[29,70,518]{2,1,0}, f32[29,70,518]{2,1,0}) parameter(0)
  %i = s32[] get-tuple-element(%t), index=0
  %xs = f32[29,70,518]{2,1,0} get-tuple-element(%t), index=1
  %ys = f32[29,70,518]{2,1,0} get-tuple-element(%t), index=2
  %slice_fusion = f32[70,518]{1,0} fusion(%xs, %i), kind=kLoop, calls=%fused_slice, metadata={op_name="jit(f)/step3d_uv/vsolve/while/body/dynamic_slice"}
  %dus_fusion = f32[29,70,518]{2,1,0} fusion(%ys, %i, %slice_fusion), kind=kLoop, calls=%fused_dus, metadata={op_name="jit(f)/step3d_uv/vsolve/while/body/dynamic_update_slice"}
  ROOT %r = (s32[], f32[29,70,518]{2,1,0}, f32[29,70,518]{2,1,0}) tuple(%i, %xs, %dus_fusion)
}

%cond (u: (s32[], f32[29,70,518], f32[29,70,518])) -> pred[] {
  %u = (s32[], f32[29,70,518]{2,1,0}, f32[29,70,518]{2,1,0}) parameter(0)
  ROOT %lt = pred[] constant(false)
}

ENTRY %main () -> f32[29,70,518] {
  %init = (s32[], f32[29,70,518]{2,1,0}, f32[29,70,518]{2,1,0}) constant({...})
  %w = (s32[], f32[29,70,518]{2,1,0}, f32[29,70,518]{2,1,0}) while(%init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"29"}}
  ROOT %out = f32[29,70,518]{2,1,0} get-tuple-element(%w), index=2
}
"""


def test_scan_slices_count_by_the_slice():
    """A scan reads one plane of its stacked input and writes one plane
    of its stacked output per iteration: bytes count planes, not the
    whole (29, ny, nx) buffers."""
    info = stagetrace.parse_hlo(_SCAN_HLO)
    plane, index = 70 * 518 * 4, 4
    assert info["slice_fusion"] == {"stage": "step3d_uv", "vsolve": True,
                                    "bytes": 2 * plane + index, "count": 29}
    assert info["dus_fusion"]["bytes"] == 2 * plane + index
    assert info["dus_fusion"]["count"] == 29


def test_loop_body_takes_the_stage_of_its_call_site():
    """A while body cloned from another stage's loop (its instructions
    still name step3d_uv) is credited to the stage of the while."""
    hlo = _SCAN_HLO.replace(
        'body=%body, backend_config=',
        'body=%body, metadata={op_name="jit(f)/step3d_t/vsolve/while"}, '
        'backend_config=')
    info = stagetrace.parse_hlo(hlo)
    assert info["slice_fusion"]["stage"] == "step3d_t"
    assert info["dus_fusion"]["stage"] == "step3d_t"
    assert info["dus_fusion"]["vsolve"] and info["dus_fusion"]["count"] == 29


def test_collective_table():
    """NCCL kernels are picked out by name; busy time is the union of
    overlapping kernels, per device and per step."""
    planes = {
        "/device:GPU:0": [("fusion_1", 0, 1000),
                          ("ncclDevKernel_SendRecv", 500, 3000),
                          ("fusion_2", 5000, 1000)],
        "/device:GPU:1": [("ncclKernel_AllReduce", 0, 2000)],
    }
    rows = stagetrace.collective_table(planes, nsteps=2)
    r0 = rows["/device:GPU:0"]
    assert r0["launches"] == 1.5 and r0["collectives"] == 0.5
    assert r0["collective_ms"] == pytest.approx(3000 / 1e6 / 2)
    assert r0["busy_ms"] == pytest.approx(4500 / 1e6 / 2)
    assert r0["span_ms"] == pytest.approx(6000 / 1e6 / 2)
    assert rows["/device:GPU:1"]["collectives"] == 0.5


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "scripts/trace_step.py"])
def test_refuses_to_measure_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert res.stdout.strip() == ""
    assert "no GPU" in res.stderr
