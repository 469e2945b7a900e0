"""Full-size parity on the GPU, at the matmul precisions the ops chose.

These run only where JAX's default device is a GPU (the ``gpu_device``
fixture skips them elsewhere); ``chip_smoke.py`` runs them on the card:

    python -m pytest tests/test_gpu_parity.py -m gpu

On a GPU, ``Precision.DEFAULT`` float32 dots run in TF32: these tests
confirm that the u8 bilinear resize stays bit-exact with the reference's
Q11 / ``>>22`` arithmetic there, and that the ``HIGHEST`` dots keep
float32 accuracy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.utils.io import bgr2nv21_numpy

from oracle import nv_to_bgr, resize_bilinear_u8, warp_affine_u8_rows

pytestmark = pytest.mark.gpu

H, W = 1080, 1920


def _frame(seed, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("out_wh,crop", [
    ((224, 224), (64, 28, 1856, 1064)),   # BASELINE config 4
    ((500, 300), None),                   # scales with no short binary form
    ((1280, 720), None),
])
def test_resize_1080p_bit_exact(gpu_device, out_wh, crop):
    src = _frame(0)
    if crop is not None:
        left, top, right, bottom = crop
        src = src[top:bottom, left:right]
    got = np.asarray(vc.resize(jax.device_put(src, gpu_device), out_wh).data)
    np.testing.assert_array_equal(got, resize_bilinear_u8(src, *out_wh))


def test_resize_f32_1080p_keeps_f32_accuracy(gpu_device):
    """Float resize runs at HIGHEST: float32 accuracy, not TF32's ~1e-3."""
    from vacv_tpu.ops.resize import _weight_matrices

    src = np.random.default_rng(1).random((H, W), dtype=np.float32) * 255
    got = np.asarray(vc.resize(jax.device_put(src, gpu_device),
                               (500, 300)).data)
    wy, wx = _weight_matrices(H, W, 300, 500, int(vc.INTER_LINEAR), False)
    want = wy.astype(np.float64) @ src.astype(np.float64) @ wx.T
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_warp_1080p_matches_oracle(gpu_device):
    m = np.array([[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]], np.float32)
    src = _frame(2)
    got = np.asarray(vc.warp_affine(jax.device_put(src, gpu_device), m,
                                    (960, 540), edge_mode="vacv").data)
    want = warp_affine_u8_rows(src, vc.invert_affine(m), 960, 540)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_separable_warp_1080p_matches_oracle(gpu_device):
    """Axis-aligned warps run as HIGHEST-precision banded matmuls."""
    m = np.array([[0.8, 0.0, 12.5], [0.0, 0.7, -3.25]], np.float32)
    src = _frame(3)
    got = np.asarray(vc.warp_affine(jax.device_put(src, gpu_device), m,
                                    (1280, 720), edge_mode="vacv").data)
    want = warp_affine_u8_rows(src, vc.invert_affine(m), 1280, 720)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


@pytest.mark.parametrize("code,is_nv12", [
    (vc.ColorCode.COLOR_YUV2BGR_NV21, False),
    (vc.ColorCode.COLOR_YUV2BGR_NV12, True),
])
def test_nv_decode_1080p_bit_exact(gpu_device, code, is_nv12):
    nv = bgr2nv21_numpy(_frame(4)).reshape(H * 3 // 2, W)
    got = np.asarray(vc.cvt_color(jax.device_put(nv, gpu_device), code).data)
    np.testing.assert_array_equal(got, nv_to_bgr(nv[:H], nv[H:], is_nv12))


def test_runtime_top_1080p_matches_static_crop(gpu_device):
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.models import preprocess_fused_batch

    frames = jax.device_put(np.stack([_frame(5), _frame(6)]), gpu_device)
    for top in (0, 44):
        rect = vc.VRect(64, top, 1856, top + 1036)
        want = Preprocessor(PreprocessConfig(
            crop_rect=rect, out_size=(224, 224))).batch(frames)
        got = preprocess_fused_batch(frames, vc.VRect(64, 0, 1856, 1036),
                                     (224, 224), top=jnp.int32(top))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)
