import os
import sys

# Tests run on the CPU, with a virtual 8-device mesh for the sharded paths
# (the reference's rank-count-independence testing model, SURVEY.md §4.7).
# The program runs on the GPU through chip_smoke.py and bench.py.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
