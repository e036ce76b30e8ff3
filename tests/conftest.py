"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Unit and conformance tests use the XLA CPU backend with 8 virtual devices
so the multi-device sharding paths — shard_map, ppermute halo exchange
(tests/test_parallel.py::TestTimeShardedFir), and all_to_all channel
redistribution (TestChannelRedistribution) — run without accelerators.
Pallas kernels run here in interpret mode, by request (``interpret=True``).

Tests that need the GPU carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them when JAX's backend is not a GPU; ``chip_smoke.py`` runs the
same checks on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from yagi_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
enable_compile_cache()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full suite; CI / round snapshots)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "autotest(names, param_map): liquid autotest identity annotation "
        "(tests/autotest.py; collected by tools/autotest_dump.py)",
    )
    config.addinivalue_line("markers", "slow: long-running CPU scan test")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see the gpu fixture)"
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's backend is not a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is %s)" % jax.default_backend())
    return jax.devices()[0]


def pytest_collection_modifyitems(config, items):
    """Default run skips ``slow``-marked tests; ``--runslow`` (or
    YAGI_RUNSLOW=1) runs everything. Keeps the default path < 15 min while
    the full conformance surface stays one flag away."""
    if config.getoption("--runslow") or os.environ.get("YAGI_RUNSLOW"):
        return
    skip = pytest.mark.skip(reason="slow test: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
