"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count), so the mesh and sharding paths run
without a card.  Tests never open a GPU: JAX_PLATFORMS is forced to cpu
before JAX starts, so no test process competes with a process on the card.
Tests of the card itself live in chip_smoke.py.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Small loop unrolls for the on-device decoders: XLA:CPU compiles the big
# production-default bodies (~12-16 symbols/step) very slowly; semantics
# are unroll-independent, and dedicated tests cover the wide configs on
# tiny inputs.
os.environ.setdefault("ZPIX_ONCHIP_K", "4")
os.environ.setdefault("ZPIX_ONCHIP_K1", "6")
os.environ.setdefault("ZPIX_ONCHIP_W", "4")
os.environ.setdefault("ZPIX_ONCHIP_W1", "4")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from zpix.utils.cache import enable_compile_cache  # noqa: E402

# XLA:CPU compiles of the on-device decoders are most of the suite's wall
# time; later runs reload executables from the persistent cache.
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute XLA:CPU compiles; run with ZPIX_SLOW=1 or -m slow",
    )


def pytest_collection_modifyitems(config, items):
    """Skip @slow tests by default so `pytest tests/ -q` stays under the
    5-minute cold budget on the 2-core host.  ZPIX_SLOW=1 or an explicit
    `-m slow` / `-m 'slow or not slow'` selection runs them."""
    if os.environ.get("ZPIX_SLOW") == "1" or config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow (set ZPIX_SLOW=1 or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)

TESTDATA = "/root/reference/src/testdata"


@pytest.fixture(scope="session")
def testdata():
    return TESTDATA


@pytest.fixture(scope="session")
def png_dir():
    return os.path.join(TESTDATA, "png")
