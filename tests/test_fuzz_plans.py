"""Seeded geometry fuzz: random frame sizes, crops, output shapes and
warp matrices through the preprocess chains and the warp routes, vs the
numpy spec oracles.  Sizes are drawn from fixed seeds so failures
reproduce."""
import numpy as np

import vacv_tpu as vc
from vacv_tpu.models import preprocess_fused_batch, preprocess_fused_nv_batch
from vacv_tpu.utils.io import bgr2nv21_numpy

from oracle import normalize_chw, nv_to_bgr, resize_bilinear_u8, warp_affine_u8_rows


def _np_chain(frame, rect, out_size):
    if rect is not None:
        left, top, cw, ch = rect.int_bounds()
        frame = frame[top:top + ch, left:left + cw]
    r = np.transpose(resize_bilinear_u8(frame, *out_size), (2, 0, 1))
    return normalize_chw(r.astype(np.float32))


def _random_rect(rng, h, w):
    if rng.random() < 0.5:
        return None
    left = int(rng.integers(0, w // 3))
    top = int(rng.integers(0, h // 3))
    cw = int(rng.integers(max(2, w // 2), w - left))
    ch = int(rng.integers(max(2, h // 2), h - top))
    return vc.VRect(left, top, left + cw, top + ch)


def test_fuzz_fused_preprocess_geometries():
    rng = np.random.default_rng(20260821)
    for _ in range(10):
        h = int(rng.integers(40, 400))
        w = int(rng.integers(40, 500))
        rect = _random_rect(rng, h, w)
        out = (int(rng.integers(16, 200)), int(rng.integers(16, 200)))
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = np.asarray(preprocess_fused_batch(frame[None], rect, out))[0]
        np.testing.assert_allclose(got, _np_chain(frame, rect, out),
                                   atol=1e-4, err_msg=str((h, w, rect, out)))


def test_fuzz_warp_geometries():
    rng = np.random.default_rng(4242)
    for _ in range(8):
        h = int(rng.integers(48, 360))
        w = int(rng.integers(48, 520))
        ang = float(rng.uniform(-25, 25))
        scale = float(rng.uniform(0.4, 2.2))
        c, s = np.cos(np.deg2rad(ang)) / scale, np.sin(np.deg2rad(ang)) / scale
        m = np.array([[c, -s, float(rng.uniform(-30, 30))],
                      [s, c, float(rng.uniform(-30, 30))]], np.float32)
        oh = int(rng.integers(16, 260))
        ow = int(rng.integers(16, 300))
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = vc.warp_affine(src, m, (ow, oh), edge_mode="vacv").numpy()
        want = warp_affine_u8_rows(src, vc.invert_affine(m), ow, oh)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (h, w, m.tolist(), (oh, ow), diff.max())
        assert (diff > 0).mean() < 0.01


def test_fuzz_separable_warp_geometries():
    """Axis-aligned matrices take the banded-matmul route; random
    scales, flips and offsets vs the fixed-point oracle."""
    rng = np.random.default_rng(97)
    for _ in range(8):
        h = int(rng.integers(32, 300))
        w = int(rng.integers(32, 400))
        sx = float(rng.uniform(0.3, 2.5)) * (1 if rng.random() < 0.8 else -1)
        sy = float(rng.uniform(0.3, 2.5))
        tx = float(rng.uniform(-20, 20)) + (w if sx < 0 else 0)
        m = np.array([[sx, 0.0, tx], [0.0, sy, float(rng.uniform(-20, 20))]],
                     np.float32)
        oh = int(rng.integers(16, 240))
        ow = int(rng.integers(16, 300))
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = vc.warp_affine(src, m, (ow, oh), edge_mode="vacv").numpy()
        want = warp_affine_u8_rows(src, vc.invert_affine(m), ow, oh)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (h, w, m.tolist(), (oh, ow), diff.max())
        assert (diff > 0).mean() < 0.01


def _nv_frame(rng, h, w):
    bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return bgr2nv21_numpy(bgr).reshape(h * 3 // 2, w)


def test_fuzz_nv_fused_geometries():
    rng = np.random.default_rng(777)
    for _ in range(5):
        h = int(rng.integers(6, 45)) * 8
        w = int(rng.integers(24, 250)) * 2    # even width
        rect = _random_rect(rng, h, w)
        out = (int(rng.integers(16, 160)), int(rng.integers(16, 160)))
        nv = _nv_frame(rng, h, w)
        got = np.asarray(preprocess_fused_nv_batch(nv[None], rect, out))[0]
        dec = nv_to_bgr(nv[:h], nv[h:], is_nv12=False)
        np.testing.assert_allclose(got, _np_chain(dec, rect, out),
                                   atol=1e-4, err_msg=str((h, w, rect, out)))


def test_fuzz_nv_runtime_tops():
    """Random runtime crop tops vs the equivalent static-top call (must
    agree exactly) and the decode + chain oracle."""
    rng = np.random.default_rng(4242)
    for _ in range(4):
        h = int(rng.integers(10, 45)) * 8
        w = int(rng.integers(40, 200)) * 2
        left = int(rng.integers(0, w // 8))
        cw = int(rng.integers(max(2, w // 2), w - left))
        ch = int(rng.integers(max(2, h // 2), h * 3 // 4))
        out = (int(rng.integers(16, 128)), int(rng.integers(16, 128)))
        nv = _nv_frame(rng, h, w)
        dec = nv_to_bgr(nv[:h], nv[h:], is_nv12=False)
        rect0 = vc.VRect(left, 0, left + cw, ch)
        for top in sorted(set(int(t) for t in rng.integers(0, h - ch + 1, 3))):
            got = np.asarray(preprocess_fused_nv_batch(
                nv[None], rect0, out, top=np.int32(top)))[0]
            rect = vc.VRect(left, top, left + cw, top + ch)
            want = np.asarray(preprocess_fused_nv_batch(nv[None], rect,
                                                        out))[0]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, _np_chain(dec, rect, out),
                                       atol=1e-4)
