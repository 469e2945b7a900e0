"""Fused pipelines vs the OpenCV op chains the reference uses
(resize_normalize.cpp:15-107, warp_affine_normalize.cpp:13-189)."""
import cv2
import numpy as np

import vacv_tpu as vc
from vacv_tpu.utils.compare import cosine_similarity


def _cv_normalize(img_f32):
    m, s = cv2.meanStdDev(img_f32)
    m = m.ravel().astype(np.float32)
    s = s.ravel().astype(np.float32)
    return (img_f32 - m) / (s + 1e-6)


def test_resize_normalize_vs_opencv_chain(bgr_640x360):
    ref = _cv_normalize(
        cv2.resize(bgr_640x360, (224, 224)).astype(np.float32)
    )
    out = vc.resize_normalize(bgr_640x360, (224, 224)).numpy()
    # u8 resize rounding (cv2) vs truncation (vacv parity) dominates
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4


def test_resize_normalize_explicit_stats(bgr_640x360):
    mean = np.array([104.0, 117.0, 123.0], np.float32)
    std = np.array([57.0, 57.0, 58.0], np.float32)
    src = bgr_640x360.astype(np.float32)
    ref = (cv2.resize(src, (224, 224)) - mean) / (std + 1e-6)
    out = vc.resize_normalize(src, (224, 224), mean=mean, stddev=std).numpy()
    assert abs(cosine_similarity(out, ref) - 1) < 1e-6


def test_warp_affine_normalize_vs_opencv_chain(bgr_640x360):
    m = np.array([[0.8, 0.05, 12.0], [-0.05, 0.8, 9.0]], np.float32)
    warped = cv2.warpAffine(bgr_640x360, m.astype(np.float64), (200, 160))
    ref = _cv_normalize(warped.astype(np.float32))
    out = vc.warp_affine_normalize(bgr_640x360, m, (200, 160)).numpy()
    assert abs(cosine_similarity(out, ref) - 1) < 2e-4


def test_warp_affine_normalize_rot(bgr_640x360):
    scale, rot = 1.05, -5.0
    aux = vc.VScalar(v0=320.0, v1=180.0, v2=64.0, v3=64.0)
    rm = cv2.getRotationMatrix2D((0.0, 0.0), rot, scale)
    rm[0, 2] = aux.v2 - rm[0, 0] * aux.v0 - rm[0, 1] * aux.v1
    rm[1, 2] = aux.v3 - rm[1, 0] * aux.v0 - rm[1, 1] * aux.v1
    warped = cv2.warpAffine(bgr_640x360, rm, (128, 128))
    ref = _cv_normalize(warped.astype(np.float32))
    out = vc.warp_affine_normalize_rot(
        bgr_640x360, scale, rot, (128, 128), aux
    ).numpy()
    assert abs(cosine_similarity(out, ref) - 1) < 2e-4


def test_imencode_roundtrip(bgr_176x144):
    buf = vc.imencode(bgr_176x144, ".png")
    dec = cv2.imdecode(np.frombuffer(buf, np.uint8), 1)
    np.testing.assert_array_equal(dec, bgr_176x144)


def test_resize_normalize_odd_width_vs_opencv_chain(bgr_640x360):
    """A 176-wide (odd-lane) u8 source through the same chain."""
    src = np.ascontiguousarray(bgr_640x360[:144, :176])
    ref = _cv_normalize(cv2.resize(src, (64, 64)).astype(np.float32))
    out = vc.resize_normalize(src, (64, 64)).numpy()
    assert out.shape == (64, 64, 3)
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4


def test_resize_normalize_vsize_dsize(bgr_640x360):
    """VSize dsize (the documented va_cv parity form) equals the tuple
    form."""
    out = vc.resize_normalize(bgr_640x360, vc.VSize(224, 224)).numpy()
    ref = vc.resize_normalize(bgr_640x360, (224, 224)).numpy()
    assert out.shape == (224, 224, 3)
    np.testing.assert_array_equal(out, ref)


def test_resize_normalize_zero_dsize_raises_cleanly(bgr_640x360):
    """dsize=(0,0) with fx=fy=0 raises resize()'s documented
    ValueError."""
    import pytest

    with pytest.raises(ValueError):
        vc.resize_normalize(bgr_640x360, (0, 0))


def test_resize_normalize_traced_stats(bgr_640x360):
    """Traced (non-concrete) mean/stddev under jit give the same result
    as concrete ones."""
    import jax
    import jax.numpy as jnp

    src = jnp.asarray(bgr_640x360)

    @jax.jit
    def run(img, mean, std):
        return vc.resize_normalize(img, (224, 224), mean=mean,
                                   stddev=std).data

    mean = jnp.asarray([104.0, 117.0, 123.0], jnp.float32)
    std = jnp.asarray([57.0, 57.0, 58.0], jnp.float32)
    out = np.asarray(run(src, mean, std))
    ref = vc.resize_normalize(
        bgr_640x360, (224, 224), mean=np.asarray(mean), stddev=np.asarray(std)
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
