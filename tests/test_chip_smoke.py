"""chip_smoke.py's phases at a tiny size on the CPU (the card runs them at
BENCHMARK1/BENCHMARK3 size).  Phases that take any built case run on a
small UPWELLING, which compiles faster than BENCHMARK's full physics."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from roms_tpu.models import upwelling


@pytest.fixture(scope="module")
def tiny32():
    return cs.build_benchmark(16, 8, 6, "float32")


def test_compare_fields(tiny32):
    cfg, _, state, _ = tiny32
    rel = cs.compare(cfg, state, state)
    assert set(rel) == {label for label, _, _ in cs.FIELDS}
    assert all(v == 0.0 for v in rel.values())
    H = cfg.halo
    t = np.array(state.t)
    t[0, 0, H, H] *= 1.5
    rel = cs.compare(cfg, state.replace(t=t), state)
    assert rel["T"] > 0 and rel["S"] == 0.0
    cs.check_within("same", cs.compare(cfg, state, state),
                    cs.TOL_F64)
    with pytest.raises(SystemExit):
        cs.check_within("perturbed", rel, cs.TOL_F64)


def test_reference_phase_tiny():
    cpu = jax.devices("cpu")[0]
    rel_a, rel_b = cs.phase_reference(16, 8, 6, cpu, cpu)
    # the same program on the same device is bitwise reproducible
    assert all(v == 0.0 for v in rel_a.values())
    cs.check_within("f32 vs f64", rel_b, cs.TOL_F32_F64)
    assert max(rel_b.values()) > 0


@pytest.fixture(scope="module")
def tiny_upwelling():
    return upwelling.build(upwelling.make_config(Lm=8, Mm=10, N=4,
                                                 ndtfast=6))


def test_restart_and_simulation_phases(tiny_upwelling, tmp_path):
    cs.phase_restart(tiny_upwelling, str(tmp_path))
    state = cs.phase_simulation(tiny_upwelling, str(tmp_path), "cpu",
                                nsteps=4, nhis=2)
    assert int(state.iic) == 4


def test_four_device_phase_tiny(tiny_upwelling):
    """In f64 the 2x2 mesh matches one device to the f64 limits; the
    traced last step runs (a CPU trace has no device planes)."""
    assert tiny_upwelling[0].dtype == "float64"
    rel = cs.phase_four_gpu(tiny_upwelling, jax.devices()[:4], "cpu",
                            nsteps=3)
    cs.check_within("2x2 vs 1", rel, cs.TOL_F64)


def test_tolerances_cover_every_field():
    labels = {label for label, _, _ in cs.FIELDS}
    for tol in (cs.TOL_F64, cs.TOL_F32_F64, cs.TOL_SHARDED):
        assert set(tol) == labels
