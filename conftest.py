"""Root conftest: force tests onto a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding tests run on CPU with
`--xla_force_host_platform_device_count=8` (SURVEY.md section 4, point 4).
Must run before the first `import jax` anywhere in the test session.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

# Pin the CPU backend in config too: a machine with an accelerator would
# otherwise hand the session to it.
jax.config.update("jax_platforms", "cpu")

# f64 support: the reference's production dtype is ti.f64 (config.py:17).
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release tracing/executable caches between test modules.

    A full-suite run accumulates hundreds of compiled XLA:CPU programs;
    at ~35 min in, LLVM segfaulted inside backend_compile_and_load on a
    program that compiles fine in isolation (observed twice at
    test_projection.py::test_incompressible_golden_stats, 2026-08-19).
    Modules rarely share jit cache entries, so the per-module clear
    costs little and bounds whatever in-process compiler state the
    crash depends on."""
    yield
    jax.clear_caches()
