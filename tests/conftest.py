"""Test configuration: CPU with 8 virtual devices and float64.

Unit tests run the same XLA programs on the CPU backend (numerics in
float64, matching the reference's double-precision end-to-end), and the
multi-device sharding tests use the 8-device virtual CPU mesh.  A run with
``JAX_PLATFORMS`` already set keeps it: ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` runs the tests marked ``gpu`` on a card.  The repo
root is put on ``sys.path`` because tests import ``chip_smoke`` and
``benchmarks``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax may already be imported by pytest plugin autoload, so the env var
# alone is not enough; the config update works until backend init.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (with a reason) without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process compiled-executable accumulation.

    Running the full suite in one process accumulates hundreds of
    XLA:CPU (LLVM JIT) executables and eventually segfaults inside
    backend_compile_and_load (observed deterministically around test 215
    of the full run; any half of the suite passes in isolation).
    Dropping the compilation caches between test modules keeps the JIT
    code cache bounded; modules re-compile what they share, which costs
    ~20% wall time and removes the crash.
    """
    yield
    jax.clear_caches()
