"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices and x64 on:
the reference could only test its distributed path on two physical GPUs
(parallel-two-cards/README.md); here sharding is tested on a virtual
8-device CPU mesh (SURVEY.md §4), so the whole suite runs anywhere.
Tests that need a GPU are marked ``gpu`` and skip there.

``--card`` leaves the platform alone and selects only the ``gpu`` tests:
``python -m pytest -m gpu --card tests/`` on a machine with a GPU, or
phase 8 of chip_smoke.py, which runs them inside its own process.
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--card", action="store_true", default=False,
                     help="keep the default JAX platform and run only "
                          "the tests marked gpu")


def pytest_configure(config):
    if config.getoption("--card"):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8


def pytest_collection_modifyitems(config, items):
    if not config.getoption("--card"):
        return
    keep = [it for it in items if it.get_closest_marker("gpu")]
    config.hook.pytest_deselected(
        items=[it for it in items if not it.get_closest_marker("gpu")])
    items[:] = keep


@pytest.fixture
def card():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
