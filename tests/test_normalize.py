"""normalize / mean_stddev tests vs an fp64 numpy oracle and the cv2
meanStdDev chain (model: reference test_normalize.cpp:22-143)."""
import cv2
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.utils.compare import cosine_similarity


def _oracle(src_f32):
    m = src_f32.reshape(-1, src_f32.shape[-1]).mean(axis=0, dtype=np.float64)
    var = ((src_f32.astype(np.float64) - m) ** 2).reshape(-1, 3).mean(axis=0)
    s = np.sqrt(var)
    return (src_f32 - m.astype(np.float32)) / (s.astype(np.float32) + 1e-6), m, s


def test_mean_stddev_matches_cv2(bgr_176x144):
    src = bgr_176x144.astype(np.float32)
    m_ref, s_ref = cv2.meanStdDev(src)
    m, s = vc.mean_stddev(src)
    np.testing.assert_allclose(np.asarray(m), m_ref.ravel(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s), s_ref.ravel(), rtol=1e-4)


@pytest.mark.parametrize("layout", [vc.HWC, vc.CHW])
def test_normalize_self_stats(bgr_176x144, layout):
    src = bgr_176x144.astype(np.float32)
    ref, _, _ = _oracle(src)
    data = src if layout == vc.HWC else np.transpose(src, (2, 0, 1))
    out = vc.normalize(vc.Image(data, layout)).numpy()
    if layout == vc.CHW:
        out = np.transpose(out, (1, 2, 0))
    assert abs(cosine_similarity(out, ref) - 1) < 1e-6
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_normalize_explicit_stats(bgr_176x144):
    src = bgr_176x144.astype(np.float32)
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    std = np.array([50.0, 55.0, 60.0], np.float32)
    out = vc.normalize(src, mean, std).numpy()
    ref = (src - mean) / (std + 1e-6)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_normalize_u8_autoconverts(bgr_176x144):
    out_u8 = vc.normalize(bgr_176x144).numpy()
    out_f32 = vc.normalize(bgr_176x144.astype(np.float32)).numpy()
    np.testing.assert_allclose(out_u8, out_f32, atol=1e-5)


def test_normalize_flat_image():
    # Flat image: std=0, output must be 0 (epsilon in denominator).
    flat = np.full((16, 16, 3), 77, np.float32)
    out = vc.normalize(flat).numpy()
    np.testing.assert_allclose(out, 0.0, atol=1e-4)


def test_normalize_u8_hwc_matches_oracle(bgr_176x144):
    out = vc.normalize(bgr_176x144).numpy()
    ref, _, _ = _oracle(bgr_176x144.astype(np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert abs(cosine_similarity(out, ref) - 1) < 1e-7


def test_normalize_partial_stats(bgr_176x144):
    # Supplying only mean must honor it and auto-compute stddev.
    src = bgr_176x144.astype(np.float32)
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    out = vc.normalize(src, mean=mean).numpy()
    _, s = vc.mean_stddev(src)
    ref = (src - mean) / (np.asarray(s) + 1e-6)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ---- frame sizes and layouts: odd rows/lanes, large planes, vmap


def _oracle_planes(x):
    """float64-statistics normalize of a (C, H, W) array."""
    f = x.astype(np.float64)
    mu = f.mean(axis=(1, 2), keepdims=True)
    sd = f.std(axis=(1, 2), keepdims=True)
    return (f - mu) / (sd + 1e-6)


@pytest.mark.parametrize("layout,shape", [
    ("chw", (3, 300, 640)),
    ("chw", (3, 64, 96)),
    ("hwc", (300, 640, 3)),
    ("hwc", (45, 33, 3)),      # odd lanes, odd rows
])
def test_normalize_shapes_match_oracle(rng, layout, shape):
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    lay = vc.HWC if layout == "hwc" else vc.CHW
    got = np.asarray(vc.normalize(vc.Image(x, lay)).data)
    planes = np.transpose(x, (2, 0, 1)) if layout == "hwc" else x
    want = _oracle_planes(planes)
    if layout == "hwc":
        want = np.transpose(want, (1, 2, 0))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_normalize_full_hd_planes(rng):
    """A 1080p CHW f32 frame (the pipeline's post-conversion layout):
    f32 statistics over 2 M elements per plane stay within 1e-3."""
    x = rng.integers(0, 256, size=(3, 1080, 1920), dtype=np.uint8)
    got = np.asarray(vc.normalize(vc.Image(x.astype(np.float32),
                                           vc.CHW)).data)
    np.testing.assert_allclose(got, _oracle_planes(x), atol=1e-3)


def test_normalize_under_vmap(rng):
    """The batched() pipeline vmaps normalize: per-frame statistics."""
    import jax

    x = rng.integers(0, 256, size=(4, 3, 64, 96), dtype=np.uint8)
    f = jax.vmap(lambda a: vc.normalize(vc.Image(a, vc.CHW)).data)
    got = np.asarray(f(x))
    want = np.stack([_oracle_planes(x[i]) for i in range(4)])
    np.testing.assert_allclose(got, want, atol=1e-4)
