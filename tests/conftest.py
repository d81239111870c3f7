"""Test configuration: run on a virtual 8-device CPU mesh with float64 enabled.

The framework itself is dtype-polymorphic (float32 on the GPU). Tests run in
float64 on CPU so kernels can be validated against NumPy/SciPy oracles at
tight tolerances, and multi-device sharding is exercised on 8 virtual
devices. Tests marked ``gpu`` need the card and skip without one (see the
``gpu`` fixture); on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

# Raise the stack limit BEFORE jax creates its compile worker threads:
# XLA's CPU-backend compilation of the largest fused programs segfaulted
# mid-suite inside backend_compile (stack-overflow signature: crash site
# wanders between compile/serialize/deserialize of the same big programs,
# each passes in isolation). Threads inherit the limit active at creation.
import resource

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = 256 * 1024 * 1024
if _soft != resource.RLIM_INFINITY and _soft < _want:
    try:
        resource.setrlimit(
            resource.RLIMIT_STACK,
            (_want if _hard == resource.RLIM_INFINITY else min(_want, _hard), _hard),
        )
    except (ValueError, OSError):
        pass

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

from x_multi_agent_jax.utils import compile_cache

compile_cache.enable("tests")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, never while test modules are imported."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    A full-suite run accumulates hundreds of live executables on the
    8-virtual-device CPU backend and eventually SEGFAULTS inside XLA's
    backend_compile on one of the largest programs (reproducible at the
    same test; the same test passes in isolation). Releasing compiled
    programs between modules keeps the process footprint bounded; the
    persistent on-disk cache makes re-tracing cheap.
    """
    yield
    jax.clear_caches()
