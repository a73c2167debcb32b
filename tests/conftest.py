"""Test bootstrap.

By default the tests run on the CPU with a virtual 8-device mesh
(multi-device tests without hardware; the reference's functional-simulator
analogue, SURVEY.md §4).  Selecting the `gpu` marker (`pytest -m gpu`)
leaves the platform to JAX, so the tests marked `gpu` run on the card;
elsewhere they skip (see the `gpu_devices` fixture).
"""

import os

import pytest


def _gpu_selected(config) -> bool:
    expr = config.getoption("markexpr") or ""
    return "gpu" in expr.replace("not gpu", "")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-dataset equality sweeps (pytest -m slow)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (pytest tests/ -m gpu)")
    if not _gpu_selected(config):
        # Before any JAX backend exists: XLA reads the flag when it creates
        # the CPU client.
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    # slow tests run only when explicitly selected (pytest -m slow)
    if config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow: run with -m slow")
    for it in items:
        if "slow" in it.keywords:
            it.add_marker(skip)


@pytest.fixture
def gpu_devices():
    """The visible NVIDIA cards; skips the test when JAX has none."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA card: run `pytest tests/ -m gpu` there")
    return devs
