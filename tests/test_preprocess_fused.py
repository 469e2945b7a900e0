"""Differential tests for the runtime-top preprocess chains.

``preprocess_fused_batch`` (crop -> bilinear resize -> CHW f32 ->
normalize) and ``preprocess_fused_nv_batch`` (NV decode first) vs the
numpy spec oracles: Q11 bilinear resize with ``>>22`` truncation, the
Q7 NV decode, and float64-statistics normalize.  The u8 resize stage is
bit-exact, so the f32 outputs agree to float32 rounding of the
statistics.

Reference parity anchors: crop.cpp:127-131 (rect), resize_naive.cpp:
10-68 (Q11 bilinear), normalize.cpp:84-120 (normalize chain),
cvt_color.cpp:151-156 (camera decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.models import preprocess_fused_batch, preprocess_fused_nv_batch
from vacv_tpu.utils.io import bgr2nv21_numpy
from vacv_tpu.utils.perf import count_traces

from oracle import normalize_chw, nv_to_bgr, resize_bilinear_u8

H, W = 360, 640
RECT = vc.VRect(17, 20, 17 + 600, 20 + 320)  # left, top, right, bottom
OUT = (112, 96)  # (w, h)
ATOL = 1e-4  # normalized units: f32 statistics vs the float64 oracle


def make_batch(rng, n=2, h=H, w=W):
    return rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def np_pipeline(frames, rect, out_size, mean=None, stddev=None,
                normalize=True):
    """crop -> Q11 resize (u8) -> CHW f32 -> normalize, in numpy."""
    outs = []
    for f in frames:
        if rect is not None:
            left, top, cw, ch = rect.int_bounds()
            f = f[top:top + ch, left:left + cw]
        r = np.transpose(resize_bilinear_u8(f, *out_size), (2, 0, 1))
        r = r.astype(np.float32)
        if normalize:
            if mean is None and stddev is None:
                r = normalize_chw(r)
            else:
                f64 = r.astype(np.float64)
                m = (f64.mean(axis=(1, 2)) if mean is None
                     else np.asarray(mean, np.float64))[:, None, None]
                s = (f64.std(axis=(1, 2))  # around the self-mean
                     if stddev is None
                     else np.asarray(stddev, np.float64))[:, None, None]
                r = ((f64 - m) / (s + 1e-6)).astype(np.float32)
        outs.append(r)
    return np.stack(outs)


def test_fused_matches_jnp_pipeline(rng):
    batch = make_batch(rng)
    got = np.asarray(preprocess_fused_batch(batch, RECT, OUT))
    want = np_pipeline(batch, RECT, OUT)
    assert got.shape == want.shape == (2, 3, OUT[1], OUT[0])
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_resize_only_lsb_parity(rng):
    """normalize=False exposes the raw truncated resize values, which
    are bit-exact with the fixed-point oracle."""
    batch = make_batch(rng, n=1)
    got = np.asarray(preprocess_fused_batch(batch, RECT, OUT,
                                            normalize=False))
    want = np_pipeline(batch, RECT, OUT, normalize=False)
    np.testing.assert_array_equal(got, want)


def test_fused_full_frame_no_crop(rng):
    batch = make_batch(rng, n=1, h=256, w=384)
    got = np.asarray(preprocess_fused_batch(batch, None, (128, 128)))
    want = np_pipeline(batch, None, (128, 128))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_explicit_stats(rng):
    batch = make_batch(rng, n=1)
    mean = (104.0, 117.0, 123.0)
    stddev = (57.1, 57.4, 58.4)
    got = np.asarray(preprocess_fused_batch(batch, RECT, OUT, mean=mean,
                                            stddev=stddev))
    want = np_pipeline(batch, RECT, OUT, mean=mean, stddev=stddev)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_partial_stats(rng):
    """mean given, stddev self-computed (around the self-mean, the
    normalize op's partial-stats convention)."""
    batch = make_batch(rng, n=1)
    mean = (104.0, 117.0, 123.0)
    got = np.asarray(preprocess_fused_batch(batch, RECT, OUT, mean=mean))
    want = np_pipeline(batch, RECT, OUT, mean=mean)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_traced_stats(rng):
    """Statistics may be traced arrays: the chain takes them as operands
    rather than baking them into the program."""
    batch = jnp.asarray(make_batch(rng, n=1))
    mean = jnp.asarray([104.0, 117.0, 123.0], jnp.float32)
    std = jnp.asarray([57.0, 57.0, 58.0], jnp.float32)

    @jax.jit
    def run(b, m, s):
        return preprocess_fused_batch(b, RECT, OUT, mean=m, stddev=s)

    got = np.asarray(run(batch, mean, std))
    want = np_pipeline(np.asarray(batch), RECT, OUT,
                       mean=np.asarray(mean), stddev=np.asarray(std))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_runtime_top(rng):
    """A traced ``top`` must give the same result as the static rect."""
    batch = make_batch(rng, n=1)
    static = np.asarray(preprocess_fused_batch(batch, RECT, OUT))
    dynamic = np.asarray(preprocess_fused_batch(
        batch, RECT, OUT, top=np.int32(int(RECT.top))))
    np.testing.assert_array_equal(static, dynamic)
    # A different runtime top equals the oracle with that rect.
    top2 = 13
    rect2 = vc.VRect(RECT.left, top2, RECT.right, top2 + 320)
    moved = np.asarray(preprocess_fused_batch(batch, RECT, OUT,
                                              top=np.int32(top2)))
    np.testing.assert_allclose(moved, np_pipeline(batch, rect2, OUT),
                               atol=ATOL)


def test_runtime_top_compiles_once(rng):
    """Every top of one geometry is served by the program the first
    call compiled: later tops trace nothing."""
    batch = jnp.asarray(make_batch(rng, n=1, h=120, w=160))
    rect = vc.VRect(8, 0, 8 + 128, 64)
    tops = (0, 9, 40, 56)
    outs = [np.asarray(preprocess_fused_batch(batch, rect, (32, 32),
                                              top=tops[0]))]
    with count_traces() as traces:
        outs += [np.asarray(preprocess_fused_batch(batch, rect, (32, 32),
                                                   top=t))
                 for t in tops[1:]]
    assert traces == []
    frames = np.asarray(batch)
    for t, got in zip(tops, outs):
        want = np_pipeline(frames, vc.VRect(8, t, 8 + 128, t + 64),
                           (32, 32))
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("h,w,rect", [
    (144, 176, None),
    (214, 284, None),
    (214, 284, vc.VRect(10, 6, 270, 202)),
])
def test_fused_odd_geometry_assets(rng, h, w, rect):
    """The reference's own odd-geometry assets (176x144, 284x214)."""
    batch = make_batch(rng, n=2, h=h, w=w)
    got = np.asarray(preprocess_fused_batch(batch, rect, (224, 224)))
    np.testing.assert_allclose(got, np_pipeline(batch, rect, (224, 224)),
                               atol=ATOL)


def test_fused_odd_output_height(rng):
    batch = make_batch(rng, n=2)
    got = np.asarray(preprocess_fused_batch(batch, None, (100, 100)))
    want = np_pipeline(batch, None, (100, 100))
    assert got.shape == want.shape == (2, 3, 100, 100)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_rejects_out_of_frame_crop(rng):
    """Crops past the frame edge, and static tops that would push the
    crop out of the frame, are rejected rather than clamped."""
    frames = make_batch(rng, n=1, h=144, w=176)
    with pytest.raises(ValueError):
        preprocess_fused_batch(frames, vc.VRect(100, 0, 200, 144), (64, 64))
    with pytest.raises(ValueError):
        preprocess_fused_batch(frames, vc.VRect(0, 0, 176, 100), (64, 64),
                               top=50)
    with pytest.raises(ValueError):
        preprocess_fused_batch(frames.astype(np.float32), None, (64, 64))


# ---- NV camera input -------------------------------------------------

def _make_nv(rng, n, h, w):
    return np.stack([
        bgr2nv21_numpy(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ).reshape(h * 3 // 2, w)
        for _ in range(n)
    ])


def _decode(nv, is_nv12=False):
    h = nv.shape[0] * 2 // 3
    return nv_to_bgr(nv[:h], nv[h:], is_nv12)


def _nv_ref_pipeline(nv_batch, rect, out_size, is_nv12=False, **kw):
    dec = np.stack([_decode(f, is_nv12) for f in nv_batch])
    return np_pipeline(dec, rect, out_size, **kw)


@pytest.mark.parametrize("is_nv12", [False, True])
def test_fused_nv_matches_decode_chain(rng, is_nv12):
    nv = _make_nv(rng, 2, 360, 640)
    rect = vc.VRect(17, 24, 17 + 600, 24 + 320)
    got = np.asarray(preprocess_fused_nv_batch(nv, rect, (112, 96),
                                               is_nv12=is_nv12))
    want = _nv_ref_pipeline(nv, rect, (112, 96), is_nv12=is_nv12)
    assert got.shape == want.shape == (2, 3, 96, 112)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_nv_rgb_order(rng):
    nv = _make_nv(rng, 1, 144, 176)
    bgr = np.asarray(preprocess_fused_nv_batch(nv, None, (64, 48)))
    rgb = np.asarray(preprocess_fused_nv_batch(nv, None, (64, 48),
                                               to_rgb=True))
    np.testing.assert_array_equal(rgb, bgr[:, ::-1])


def test_fused_nv_full_frame_explicit_stats(rng):
    nv = _make_nv(rng, 1, 144, 176)  # the akiyo_qcif camera config
    mean = (104.0, 117.0, 123.0)
    stddev = (57.1, 57.4, 58.4)
    got = np.asarray(preprocess_fused_nv_batch(nv, None, (128, 96),
                                               mean=mean, stddev=stddev))
    want = _nv_ref_pipeline(nv, None, (128, 96), mean=mean, stddev=stddev)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_nv_full_height_matches_chain(rng):
    nv = _make_nv(rng, 2, 360, 640)
    got = np.asarray(preprocess_fused_nv_batch(nv, None, (112, 96)))
    np.testing.assert_allclose(got, _nv_ref_pipeline(nv, None, (112, 96)),
                               atol=ATOL)


@pytest.mark.parametrize("top", [0, 4, 37, 120])
def test_fused_nv_runtime_top_matches_static(rng, top):
    """A runtime crop top (python int or traced scalar) reproduces the
    equivalent static-top result exactly."""
    h, w, ch = 360, 640, 224
    nv = _make_nv(rng, 1, h, w)
    rect = vc.VRect(32, top, 32 + 512, top + ch)
    want = np.asarray(preprocess_fused_nv_batch(nv, rect, (128, 96)))
    rect0 = vc.VRect(32, 0, 32 + 512, ch)
    got = np.asarray(preprocess_fused_nv_batch(nv, rect0, (128, 96),
                                               top=np.int32(top)))
    np.testing.assert_array_equal(got, want)


def test_fused_nv_rejects_bad_buffers():
    with pytest.raises(ValueError):  # odd width: VU pairs split
        preprocess_fused_nv_batch(np.zeros((1, 36, 25), np.uint8))
    with pytest.raises(ValueError):  # rows not a multiple of 3
        preprocess_fused_nv_batch(np.zeros((1, 35, 24), np.uint8))
