"""On-card checks at real widths (skip without a GPU; run with
``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eorb_slam_tpu.event import tensorize
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.ops import matching

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("use_polarity", [False, True])
def test_splat_at_window_width(gpu_device, use_polarity):
    rng = np.random.default_rng(0)
    H, W, N = 180, 240, 65536
    xy = np.stack([rng.uniform(-3, W + 3, N),
                   rng.uniform(-3, H + 3, N)], 1).astype(np.float32)
    pol = rng.choice([-1.0, 1.0], N).astype(np.float32)
    valid = rng.uniform(size=N) < 0.95
    out = np.asarray(tensorize.splat_gauss(
        jax.device_put(xy, gpu_device), jnp.asarray(valid), jnp.asarray(pol),
        H, W, use_polarity=use_polarity), np.float64)
    ref = tensorize.splat_gauss_reference(xy, valid, pol, H, W,
                                          use_polarity=use_polarity)
    assert np.max(np.abs(out - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_hamming_exact(gpu_device):
    rng = np.random.default_rng(1)
    d1 = rng.integers(0, 2, (512, 256)).astype(np.int8) * 2 - 1
    d2 = rng.integers(0, 2, (4096, 256)).astype(np.int8) * 2 - 1
    hm = np.asarray(matching.hamming_matrix(jax.device_put(d1, gpu_device),
                                            jnp.asarray(d2)))
    ref = np.unpackbits(np.packbits(d1 > 0, axis=1)[:, None, :]
                        ^ np.packbits(d2 > 0, axis=1)[None, :, :],
                        axis=2).sum(2)
    np.testing.assert_array_equal(hm, ref)


def test_float32_products_are_not_tf32(gpu_device):
    phi = jax.device_put(
        np.random.default_rng(2).normal(size=(4096, 3)).astype(np.float32),
        gpu_device)
    R = np.asarray(lie.so3_exp(phi), np.float64)
    assert np.max(np.abs(np.einsum("nij,nkj->nik", R, R) - np.eye(3))) < 1e-5
