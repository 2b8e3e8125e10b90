"""Test configuration.

By default every test runs on the CPU, with 8 virtual devices for the
multi-device paths. Tests that need an NVIDIA GPU carry the ``gpu`` marker
and take the ``gpu_device`` fixture, which skips them on the CPU; on a
machine with a card they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os

_PLATFORM = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
# XLA:CPU's fusion emitter miscompiles error-free transforms (the double-float
# fp64-emulation core): values computed inside kLoop fusions lose the EFT
# error terms (~fp32 accuracy instead of ~fp64). The GPU backend is
# unaffected. Disabling the fusion pass on CPU restores exact semantics; CPU
# test speed is irrelevant. See respatpu.precision.eft_selfcheck.
if _PLATFORM == "cpu" and "--xla_disable_hlo_passes=fusion" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_disable_hlo_passes=fusion").strip()

import jax

jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from respatpu.config import enable_compile_cache

enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return gpus[0]


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """XLA:CPU with the fusion pass disabled accumulates compiled
    executables; with a few hundred alive in one process, writing the next
    one to the persistent compile cache has crashed the process (seen in
    tests/test_frontal.py with an empty cache). Dropping the jit caches after
    every test keeps the executable count bounded; programs that recur come
    back from the persistent cache."""
    yield
    jax.clear_caches()
