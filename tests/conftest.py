"""Test configuration.

By default the tests run on the CPU, with 8 virtual devices so the sharding
tests see a mesh. ``JAX_PLATFORMS`` set before pytest starts wins: the
on-card tests (marked ``gpu``) run with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py

and skip, through the ``gpu_device`` fixture, where JAX sees no GPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pytest  # noqa: E402

# compile-heavy e2e modules (minutes each on CPU): auto-marked `slow` so the
# practical dev loop is `pytest -m "not slow"` (~2 min) and CI runs the rest
_SLOW_MODULES = {
    "test_event_slam", "test_event_continuous", "test_ev_image_slam",
    "test_event_inertial", "test_fusion", "test_vi_slam", "test_apps",
    "test_recovery", "test_stereo_rgbd", "test_loop_closing",
    "test_kf_lifecycle",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
