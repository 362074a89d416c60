"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding paths are exercised without a GPU cluster
(SURVEY.md §4).

The platform is forced through jax.config after import (before the first
backend query), so the suite stays on the CPU even where a GPU is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Tight-tolerance numerics tests (and reference-parity f64 configs) need x64.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (utils.compile_cache): XLA CPU compiles
# cost ~0.4 s per op; the cache amortizes that across test processes and
# reruns.
from levelsetfortran_jax.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402

from levelsetfortran_jax.models import fixtures  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture(scope="session")
def fixture_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fixtures"))


@pytest.fixture(scope="session")
def twocube10_stl(fixture_dir):
    """The reference's twoCube10.stl, generated (models.fixtures)."""
    return fixtures.write_twocube10(fixture_dir)


@pytest.fixture(scope="session")
def icosphere_stl(fixture_dir):
    """The 20,480-triangle seeded icosphere body (models.fixtures)."""
    return fixtures.write_icosphere(fixture_dir, seed=0)
