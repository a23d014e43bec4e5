"""Test configuration: CPU by default, on a virtual 8-device CPU mesh.

JAX_PLATFORMS defaults to cpu, so multi-chip sharding is exercised on
virtual CPU devices. Tests marked ``gpu`` need a card: run them there
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)
# No persistent XLA compilation cache under tests: XLA's
# (de)serialization of the 8-device CPU-mesh sharded executables is
# unreliable (observed SIGSEGV on a cache read and SIGABRT inside
# put_executable_and_time on a cache write, each killing the whole
# suite). CPU compiles are cheap; skip the cache.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables at module boundaries.

    Under jax/jaxlib 0.9.0 the full suite segfaulted deterministically
    at test #182 (tests/test_sharding.py::test_matches_single_device_api,
    inside a lnZ_PTP pjit) after ~181 tests' compiled executables had
    accumulated in the 8-device CPU client — while every module passes
    standalone. This is a sibling of the cache-(de)serialization crash
    class documented above. Capping live-executable accumulation at one
    module's worth reproduces the standalone-green conditions; CPU
    recompiles across module boundaries are cheap relative to the
    scenario tests that dominate suite wall time.
    """
    yield
    jax.clear_caches()
