"""Test configuration: a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding is validated on host CPU devices
(``--xla_force_host_platform_device_count``). Tests marked ``gpu`` need a
card: they skip here and run with ``JAX_PLATFORMS=cuda python -m pytest -m
gpu tests/``; ``chip_smoke.py`` runs the same phases end to end.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_enable_x64", True)

# The XLA CPU thunk runtime JIT-maps ~3 small segments (code/rodata/data)
# per compiled kernel function; the full suite accumulates ~60k mappings
# and crosses the kernel's default vm.max_map_count=65530 mid-compile.
# The failed mmap surfaces as a SIGSEGV inside backend_compile_and_load —
# deterministic late in the suite, absent when either half runs alone
# (diagnosed round 4 via /proc/<pid>/maps: ~18k r-xp/r--p/rw-p triples;
# jax.clear_caches() does NOT release them). Raise the limit where we can
# (root containers); harmless no-op elsewhere.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _map_limit = int(_f.read())
    if _map_limit < 262144:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("262144")
except (OSError, ValueError):
    pass

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
