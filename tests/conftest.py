import os

# Tests run on a virtual 8-device CPU mesh with 64-bit numerics so oracle
# comparisons match the reference's double-precision behavior.
#
# The platform is pinned through jax.config (JAX_PLATFORMS may already
# have been read if something imported jax first).  XLA_FLAGS still works
# because the CPU client is created lazily on first use.  Tests marked
# ``gpu`` need a card: ``python -m pytest tests/ -m gpu --gpu`` on a GPU
# machine runs them with the default (GPU) platform and float32.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = flags + " --xla_force_host_platform_device_count=8"
# XLA:CPU's AVX2 codegen contracts a*b+c into FMA and (fusion-dependent)
# reorders compensated-summation chains, silently destroying the
# double-single arithmetic of ops/dsa (measured: jitted ds mul loses its
# lo word, 3e-8 error vs 6e-15 eager).  Pinning the ISA to SSE4_2 (no
# FMA) restores exact compensation in the CPU test lane.  Measured
# suite impact: none (compile time dominates).
if "xla_cpu_max_isa" not in flags:
    flags = flags + " --xla_cpu_max_isa=SSE4_2"
os.environ["XLA_FLAGS"] = flags

import sys  # noqa: E402

import jax  # noqa: E402

ON_GPU = "--gpu" in sys.argv
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Two-tier suite: the default lane must stay fast for iteration; tests
# marked ``slow`` (>~30 s each: wide-P Mosaic compiles, posterior parity
# chains, multi-process spawns) run with --runslow (CI full lane:
# ``python -m pytest tests/ -q --runslow``).


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (full lane)",
    )
    parser.addoption(
        "--gpu", action="store_true", default=False,
        help="run on the default (GPU) platform instead of the CPU",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: takes >30s; excluded from the default lane "
        "(enable with --runslow)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skipped (by the ``gpu`` fixture) elsewhere",
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with --gpu on a GPU machine)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
