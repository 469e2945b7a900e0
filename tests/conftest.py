"""Test configuration.

Tests run on CPU with 8 virtual devices (the multi-chip sharding tests
use them as a stand-in mesh; the driver's dryrun does the same).  Env
must be set before jax initializes — conftest imports first.  A caller
that already set ``JAX_PLATFORMS`` (or initialised JAX on a GPU, as
``chip_smoke.py`` does before running the ``gpu``-marked tests) keeps
its platform.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none.  The
    decision is made here, at run time, so every process collects the
    same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_bgr(h, w, rng, smooth=False):
    """Synthetic HWC BGR u8 test image.

    ``smooth`` produces a natural-image-like low-frequency field (needed
    by chroma-subsampling roundtrip tests, where white noise would be an
    unrealistically hostile input).
    """
    if not smooth:
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (
        128
        + 80 * np.sin(2 * np.pi * xx / max(w, 1) * 1.7)
        + 60 * np.cos(2 * np.pi * yy / max(h, 1) * 2.3)
    )
    chans = [
        base + 20 * np.sin(2 * np.pi * (xx + yy) / max(h + w, 1) * (k + 1))
        for k in range(3)
    ]
    img = np.stack(chans, axis=-1) + rng.normal(0, 2.0, size=(h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="session")
def bgr_640x360(rng):
    return make_bgr(360, 640, rng, smooth=True)


@pytest.fixture(scope="session")
def bgr_176x144(rng):
    return make_bgr(144, 176, rng, smooth=True)


@pytest.fixture(scope="session")
def noise_64x48(rng):
    return make_bgr(48, 64, rng, smooth=False)
