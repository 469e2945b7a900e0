"""warp_affine geometry coverage: matrices, output shapes, dtypes,
interpolation, border modes and vmap batching, against numpy spec
oracles (bilinear u8 with Q11/Q22 arithmetic, float bilinear and
nearest with per-tap constant borders) and OpenCV.

Bilinear bars: the source coordinate ``fx = m0*dx + m1*dy + m2`` is
evaluated in f32, and XLA may contract it into a fused multiply-add, so
one f32 ulp of ``fx`` can move a Q11 weight at an exact-half knife edge:
u8 results agree with the oracle within 1 LSB on a small share of
pixels, f32 results within ~0.004 on 0..255 data.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.core.types import BorderMode, InterMode, Layout

from oracle import warp_affine_u8_rows

MATRICES = [
    np.array([[0.85, 0.05, 12.0], [-0.05, 0.85, 9.0]], np.float32),
    np.array([[1.2, -0.08, -20.0], [0.08, 1.2, 5.0]], np.float32),
    np.array([[0.5, 0.0, 300.0], [0.0, 0.5, 200.0]], np.float32),  # mostly OOB
]


def _coords(minv, w_out, h_out):
    m = minv.astype(np.float32).ravel()
    dx = np.arange(w_out, dtype=np.float32)[None, :]
    dy = np.arange(h_out, dtype=np.float32)[:, None]
    return m[0] * dx + m[1] * dy + m[2], m[3] * dx + m[4] * dy + m[5]


def _taps(src, tx, ty, bv):
    """Per-tap constant-border fetch of (h, w) tap coordinates."""
    h_in, w_in = src.shape[:2]
    ok = (tx >= 0) & (tx <= w_in - 1) & (ty >= 0) & (ty <= h_in - 1)
    v = src[np.clip(ty, 0, h_in - 1), np.clip(tx, 0, w_in - 1)]
    return np.where(ok[..., None], v.astype(np.float32), np.float32(bv))


def np_warp_f32(src, minv, w_out, h_out, bv=0.0):
    """Float bilinear warp with cv::warpAffine BORDER_CONSTANT per-tap
    semantics (exact float offsets)."""
    fx, fy = _coords(minv, w_out, h_out)
    sx, sy = np.floor(fx), np.floor(fy)
    ax, ay = (fx - sx)[..., None], (fy - sy)[..., None]
    sx, sy = sx.astype(np.int64), sy.astype(np.int64)
    return (_taps(src, sx, sy, bv) * ((1 - ax) * (1 - ay))
            + _taps(src, sx, sy + 1, bv) * ((1 - ax) * ay)
            + _taps(src, sx + 1, sy, bv) * (ax * (1 - ay))
            + _taps(src, sx + 1, sy + 1, bv) * (ax * ay))


def np_warp_nearest(src, minv, w_out, h_out, bv=0.0):
    """Nearest warp: half-up rounded source coordinate, per-tap border."""
    fx, fy = _coords(minv, w_out, h_out)
    tx = np.floor(fx + np.float32(0.5)).astype(np.int64)
    ty = np.floor(fy + np.float32(0.5)).astype(np.int64)
    return _taps(src, tx, ty, bv)


def _assert_u8_close(got, want, share=0.005):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < share


@pytest.mark.parametrize("size", [(250, 200), (187, 333)])
@pytest.mark.parametrize("mi", range(len(MATRICES)))
def test_warp_u8_matches_oracle(bgr_640x360, mi, size):
    """u8 bilinear vs the fixed-point spec oracle (skip-edge semantics,
    edge_mode='vacv'), including a tall output of odd size."""
    m = MATRICES[mi]
    w_out, h_out = size
    got = vc.warp_affine(bgr_640x360, m, size, edge_mode="vacv").numpy()
    want = warp_affine_u8_rows(bgr_640x360, vc.invert_affine(m), w_out,
                               h_out)
    _assert_u8_close(got, want)


@pytest.mark.parametrize("mi", range(len(MATRICES)))
def test_warp_f32_matches_oracle(bgr_640x360, mi):
    m = MATRICES[mi]
    src = bgr_640x360.astype(np.float32)
    got = vc.warp_affine(src, m, (250, 200)).numpy()
    want = np_warp_f32(src, vc.invert_affine(m), 250, 200)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_warp_border_value(bgr_640x360):
    m = np.array([[1.0, 0.02, -720.0], [0.0, 1.0, -440.0]], np.float32)
    out = vc.warp_affine(bgr_640x360, m, (64, 64), border_value=17.0).numpy()
    assert (out == 17).all()


def test_warp_vmap_batched(bgr_640x360, rng):
    """Preprocessor pipelines vmap over frames; a vmapped warp must equal
    the per-frame calls."""
    other = rng.integers(0, 256, bgr_640x360.shape, dtype=np.uint8)
    batch = jnp.stack([jnp.asarray(bgr_640x360), jnp.asarray(other)])

    def one(x):
        return vc.warp_affine(vc.Image(x, Layout.HWC), MATRICES[0],
                              (200, 96)).data

    out_v = np.asarray(jax.jit(jax.vmap(one))(batch))
    for i in range(2):
        np.testing.assert_array_equal(out_v[i],
                                      np.asarray(jax.jit(one)(batch[i])))


def test_warp_large_rotation(bgr_640x360):
    """40-degree rotation: every output row spans many source rows."""
    c, s = np.cos(np.deg2rad(40)), np.sin(np.deg2rad(40))
    m = np.array([[c, -s, 220.0], [s, c, -80.0]], np.float32)
    got = vc.warp_affine(bgr_640x360, m, (400, 300), edge_mode="vacv").numpy()
    want = warp_affine_u8_rows(bgr_640x360, vc.invert_affine(m), 400, 300)
    _assert_u8_close(got, want)


@pytest.mark.parametrize("scale", [3.0, 6.0])
def test_warp_large_downscale(bgr_640x360, scale):
    m = np.array([[1.0 / scale, 0.02, 4.0], [-0.02, 1.0 / scale, 6.0]],
                 np.float32)
    got = vc.warp_affine(bgr_640x360, m, (180, 96), edge_mode="vacv").numpy()
    want = warp_affine_u8_rows(bgr_640x360, vc.invert_affine(m), 180, 96)
    _assert_u8_close(got, want)


@pytest.mark.parametrize("u8", [True, False])
def test_warp_nearest_matches_oracle(bgr_640x360, u8):
    """INTER_NEAREST picks exactly the oracle's source pixels."""
    src = bgr_640x360 if u8 else bgr_640x360.astype(np.float32)
    got = vc.warp_affine(src, MATRICES[0], (250, 200),
                         flags=vc.INTER_NEAREST).numpy()
    want = np_warp_nearest(src, vc.invert_affine(MATRICES[0]), 250, 200)
    np.testing.assert_array_equal(got, want.astype(src.dtype))


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("border", ["BORDER_REPLICATE", "BORDER_REFLECT",
                                    "BORDER_REFLECT_101", "BORDER_WRAP"])
def test_warp_border_modes_vs_opencv(bgr_640x360, border, u8):
    """The coordinate-remap border modes with a small rotation, taps
    overshooting the left and top edges by ~40/30 px."""
    m = np.array([[1.0, 0.02, 40.0], [-0.02, 1.0, 30.0]], np.float32)
    src = bgr_640x360 if u8 else bgr_640x360.astype(np.float32)
    got = vc.warp_affine(src, m, (320, 200),
                         border_mode=getattr(BorderMode, border)).numpy()
    want = cv2.warpAffine(src, m.astype(np.float64), (320, 200),
                          flags=cv2.INTER_LINEAR,
                          borderMode=getattr(cv2, border))
    if u8:
        # cv2 rounds where vacv truncates, and quantizes offsets to 1/32
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    else:
        np.testing.assert_allclose(got, want, atol=0.5)


def test_warp_vacv_edge_mode_border_value(bgr_640x360):
    """edge_mode='vacv' writes the border value wherever the 2x2 support
    leaves the image."""
    m = MATRICES[0]
    got = vc.warp_affine(bgr_640x360, m, (320, 200), edge_mode="vacv",
                         border_value=7.0).numpy()
    minv = vc.invert_affine(m)
    fx, fy = _coords(minv, 320, 200)
    sx, sy = np.floor(fx), np.floor(fy)
    inside = (sx >= 0) & (sx < 639) & (sy >= 0) & (sy < 359)
    want = warp_affine_u8_rows(bgr_640x360, minv, 320, 200)
    want = np.where(inside[..., None], want, np.uint8(7))
    _assert_u8_close(got, want)


def test_warp_nearest_transparent_no_vacv_mask(bgr_640x360):
    """The vacv skip-edge mask is a LINEAR-only semantic (the reference's
    nearest path came from its OpenCV fallback): nearest with
    BORDER_TRANSPARENT equals plain per-tap constant borders."""
    m = np.array([[0.9, 0.05, 10.0], [-0.05, 0.9, 5.0]], np.float32)
    got = vc.warp_affine(bgr_640x360, m, (320, 200),
                         flags=InterMode.INTER_NEAREST,
                         border_mode=BorderMode.BORDER_TRANSPARENT).numpy()
    want = np_warp_nearest(bgr_640x360, vc.invert_affine(m), 320, 200)
    np.testing.assert_array_equal(got, want.astype(np.uint8))


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("mi", [0, 1])
def test_warp_cubic_vs_opencv(bgr_640x360, mi, u8):
    src = bgr_640x360 if u8 else bgr_640x360.astype(np.float32)
    m = MATRICES[mi]
    got = vc.warp_affine(src, m, (250, 200), flags=vc.INTER_CUBIC).numpy()
    want = cv2.warpAffine(src, m.astype(np.float64), (250, 200),
                          flags=cv2.INTER_CUBIC)
    # OpenCV quantizes fractional offsets to 1/32 (INTER_BITS=5); the
    # interior agrees closely, the cosine bar covers the whole frame.
    from vacv_tpu.utils.compare import cosine_similarity

    assert abs(cosine_similarity(got, want) - 1) < 1e-4
