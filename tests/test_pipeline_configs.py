"""Preprocessor configurations end to end — crops, odd frame sizes,
interpolation modes, explicit statistics, NV camera input and warps —
single-image and batched, vs the numpy spec oracles (bilinear) or the
OpenCV chain (the modes the reference forwarded to OpenCV)."""
import cv2
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.models import PreprocessConfig, Preprocessor
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu.utils.io import bgr2nv21_numpy

from oracle import normalize_chw, nv_to_bgr, resize_bilinear_u8

H, W = 256, 384
CFG = PreprocessConfig(
    crop_rect=vc.VRect(16, 8, 16 + 352, 8 + 240),
    out_size=(112, 112),
    out_layout=vc.CHW,
    normalize=True,
)


def make(rng, n=0, h=H, w=W):
    shape = (h, w, 3) if n == 0 else (n, h, w, 3)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def np_chain(frame, rect, out_size, mean=None, stddev=None):
    if rect is not None:
        left, top, cw, ch = rect.int_bounds()
        frame = frame[top:top + ch, left:left + cw]
    r = np.transpose(resize_bilinear_u8(frame, *out_size), (2, 0, 1))
    r = r.astype(np.float32)
    if mean is None:
        return normalize_chw(r)
    m = np.asarray(mean, np.float32)[:, None, None]
    s = np.asarray(stddev, np.float32)[:, None, None]
    return (r - m) / (s + 1e-6)


def cv_chain(frame, rect, out_size, interp):
    if rect is not None:
        left, top, cw, ch = rect.int_bounds()
        frame = frame[top:top + ch, left:left + cw]
    r = cv2.resize(frame, out_size, interpolation=interp)
    return normalize_chw(np.transpose(r, (2, 0, 1)).astype(np.float32))


def test_single_image_matches_oracle(rng):
    x = make(rng)
    got = np.asarray(Preprocessor(CFG)(x))
    assert got.shape == (3, 112, 112)
    np.testing.assert_allclose(got, np_chain(x, CFG.crop_rect, (112, 112)),
                               atol=1e-4)


def test_batch_matches_single_image(rng):
    x = make(rng, n=3)
    pre = Preprocessor(CFG)
    out = np.asarray(pre.batch(x))
    assert out.shape == (3, 3, 112, 112)
    for i in range(3):
        np.testing.assert_allclose(out[i], np.asarray(pre(x[i])), atol=1e-6)


def test_batch_fn_traces_under_outer_jit(rng):
    x = make(rng, n=2)
    pre = Preprocessor(CFG)
    got = np.asarray(jax.jit(pre.batch_fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.asarray(pre.batch(x)))


@pytest.mark.parametrize("h,w", [(200, 300), (24, 256)])
def test_small_and_odd_frames(rng, h, w):
    """Odd lane counts and very short frames."""
    x = make(rng, h=h, w=w)
    got = np.asarray(Preprocessor(PreprocessConfig(out_size=(64, 64)))(x))
    assert got.shape == (3, 64, 64)
    np.testing.assert_allclose(got, np_chain(x, None, (64, 64)), atol=1e-4)


@pytest.mark.parametrize("mode,cv_mode", [
    (vc.INTER_CUBIC, cv2.INTER_CUBIC),
    (vc.INTER_NEAREST, cv2.INTER_NEAREST),
    (vc.INTER_AREA, cv2.INTER_AREA),
])
def test_interpolation_modes_vs_opencv(rng, mode, cv_mode):
    from conftest import make_bgr

    x = make_bgr(H, W, rng, smooth=True)
    cfg = dataclasses.replace(CFG, interpolation=mode)
    got = np.asarray(Preprocessor(cfg)(x))
    want = cv_chain(x, CFG.crop_rect, (112, 112), cv_mode)
    assert got.shape == want.shape == (3, 112, 112)
    assert abs(cosine_similarity(got, want) - 1) < 1e-4


def test_explicit_stats(rng):
    x = make(rng)
    mean, std = (104.0, 117.0, 123.0), (57.1, 57.4, 58.4)
    cfg = dataclasses.replace(CFG, mean=mean, stddev=std)
    got = np.asarray(Preprocessor(cfg)(x))
    np.testing.assert_allclose(
        got, np_chain(x, CFG.crop_rect, (112, 112), mean, std), atol=1e-4)


@pytest.mark.parametrize("code,is_nv12,rgb", [
    (vc.ColorCode.COLOR_YUV2BGR_NV21, False, False),
    (vc.ColorCode.COLOR_YUV2RGB_NV21, False, True),
    (vc.ColorCode.COLOR_YUV2BGR_NV12, True, False),
])
def test_nv_pipeline_matches_oracle(rng, code, is_nv12, rgb):
    h, w = 360, 640
    nv = bgr2nv21_numpy(make(rng, h=h, w=w)).reshape(h * 3 // 2, w)
    rect = vc.VRect(16, 8, 16 + 600, 8 + 336)
    cfg = PreprocessConfig(color_code=code, crop_rect=rect,
                           out_size=(112, 112))
    got = np.asarray(Preprocessor(cfg)(nv))
    dec = nv_to_bgr(nv[:h], nv[h:], is_nv12)
    if rgb:
        dec = dec[..., ::-1]
    np.testing.assert_allclose(got, np_chain(dec, rect, (112, 112)),
                               atol=1e-4)


def test_nv_cubic_pipeline(rng):
    from conftest import make_bgr

    h, w = 240, 320
    nv = bgr2nv21_numpy(make_bgr(h, w, rng, smooth=True)).reshape(
        h * 3 // 2, w)
    cfg = PreprocessConfig(color_code=vc.ColorCode.COLOR_YUV2BGR_NV21,
                           out_size=(64, 64), interpolation=vc.INTER_CUBIC)
    got = np.asarray(Preprocessor(cfg)(nv))
    dec = nv_to_bgr(nv[:h], nv[h:], False)
    want = cv_chain(dec, None, (64, 64), cv2.INTER_CUBIC)
    assert abs(cosine_similarity(got, want) - 1) < 1e-4


WARP_CFG = PreprocessConfig(
    crop_rect=vc.VRect(8, 4, 8 + 352, 4 + 240),
    warp=(((0.9, 0.03, 10.0), (-0.03, 0.9, 5.0)), (304, 168)),
    out_size=(112, 112), out_layout=vc.CHW, normalize=True)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_batch_matches_per_image(rng, dtype):
    x = make(rng, n=3).astype(dtype)
    pre = Preprocessor(WARP_CFG)
    got = np.asarray(pre.batch(x))
    per = np.stack([np.asarray(pre(x[i])) for i in range(3)])
    assert got.shape == (3, 3, 112, 112)
    np.testing.assert_allclose(got, per, atol=1e-5)


def test_warp_pipeline_vs_opencv_chain(rng):
    from conftest import make_bgr

    x = make_bgr(H, W, rng, smooth=True)
    got = np.asarray(Preprocessor(WARP_CFG)(x))
    left, top, cw, ch = WARP_CFG.crop_rect.int_bounds()
    m, dsize = WARP_CFG.warp
    warped = cv2.warpAffine(x[top:top + ch, left:left + cw],
                            np.asarray(m, np.float64), dsize)
    want = cv_chain(warped, None, (112, 112), cv2.INTER_LINEAR)
    assert abs(cosine_similarity(got, want) - 1) < 1e-4
