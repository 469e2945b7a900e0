"""cvt_color tests: bit-exactness vs the reference algorithm oracle,
plus the reference's own roundtrip-vs-original-BGR check
(test_cvt_color.cpp:23-57), plus the planar decode core."""
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu.utils.io import bgr2nv21_numpy, nv21_planes

from oracle import nv_to_bgr


def _nv_buffer(bgr):
    h, w, _ = bgr.shape
    nv21 = bgr2nv21_numpy(bgr)
    return nv21.reshape(h * 3 // 2, w)


@pytest.mark.parametrize("code,is_nv12", [
    (vc.COLOR_YUV2BGR_NV21, False),
    (vc.COLOR_YUV2BGR_NV12, True),
])
def test_nv_to_bgr_bit_exact(bgr_176x144, code, is_nv12):
    buf = _nv_buffer(bgr_176x144)
    h, w = bgr_176x144.shape[:2]
    y, vu = nv21_planes(buf.ravel(), w, h)
    ref = nv_to_bgr(y, vu, is_nv12)
    out = vc.cvt_color(buf, code)
    assert out.shape == (h, w, 3)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_nv21_roundtrip_vs_original(bgr_640x360):
    # The reference's own correctness check: convert BGR->NV21->BGR and
    # compare against the original (test_cvt_color.cpp:47-49, bar 5e-4).
    buf = _nv_buffer(bgr_640x360)
    out = vc.cvt_color(buf, vc.COLOR_YUV2BGR_NV21).numpy()
    assert abs(cosine_similarity(out, bgr_640x360) - 1) < 5e-4


def test_rgb_order(bgr_176x144):
    buf = _nv_buffer(bgr_176x144)
    bgr = vc.cvt_color(buf, vc.COLOR_YUV2BGR_NV21).numpy()
    rgb = vc.cvt_color(buf, vc.COLOR_YUV2RGB_NV21).numpy()
    np.testing.assert_array_equal(rgb, bgr[..., ::-1])


def test_bgra_alpha(bgr_176x144):
    buf = _nv_buffer(bgr_176x144)
    bgra = vc.cvt_color(buf, vc.ColorCode.COLOR_YUV2BGRA_NV21).numpy()
    assert bgra.shape[-1] == 4
    assert (bgra[..., 3] == 255).all()


def test_gray2bgr():
    gray = np.arange(64, dtype=np.uint8).reshape(8, 8)
    out = vc.cvt_color(gray, vc.COLOR_GRAY2BGR).numpy()
    assert out.shape == (8, 8, 3)
    for k in range(3):
        np.testing.assert_array_equal(out[..., k], gray)


def test_yv12(bgr_176x144):
    # Build a YV12 buffer from the NV21 synthesis (same Y; planar V,U).
    h, w, _ = bgr_176x144.shape
    nv21 = bgr2nv21_numpy(bgr_176x144)
    y, vu = nv21_planes(nv21, w, h)
    v = vu[:, 0::2]
    u = vu[:, 1::2]
    yv12 = np.concatenate([y.ravel(), v.ravel(), u.ravel()]).reshape(h * 3 // 2, w)
    out = vc.cvt_color(yv12, vc.ColorCode.COLOR_YUV2BGR_YV12).numpy()
    ref = nv_to_bgr(y, vu, is_nv12=False)
    np.testing.assert_array_equal(out, ref)


def test_nv_to_bgr_planes_matches_oracle(bgr_176x144):
    """The planar decode core (the pipeline's NV entry) matches the
    oracle plane by plane."""
    import jax.numpy as jnp

    from vacv_tpu.ops.cvt_color import nv_to_bgr_planes

    buf = _nv_buffer(bgr_176x144)
    h, w = bgr_176x144.shape[:2]
    y, vu = nv21_planes(buf.ravel(), w, h)
    ref = nv_to_bgr(y, vu, is_nv12=False)
    out = nv_to_bgr_planes(jnp.asarray(y), jnp.asarray(vu), is_nv12=False)
    for k, o in enumerate(out):
        np.testing.assert_array_equal(np.asarray(o), ref[..., k])


# ---- odd-geometry NV frames (reference zerobuf trick, cvt_color.cpp:52-66)


@pytest.mark.parametrize("h,w", [(175, 144), (143, 176), (359, 640)])
def test_nv21_odd_height_bit_exact(rng, h, w):
    from conftest import make_bgr

    bgr = make_bgr(h, w, rng, smooth=True)
    nv21 = bgr2nv21_numpy(bgr)
    buf = nv21.reshape(h + (h + 1) // 2, w)
    y, vu = nv21_planes(nv21, w, h)
    ref = nv_to_bgr(y, vu, is_nv12=False)
    out = vc.cvt_color(buf, vc.COLOR_YUV2BGR_NV21)
    np.testing.assert_array_equal(np.asarray(out.data), ref)
    assert out.data.shape == (h, w, 3)


def test_nv21_odd_height_planes(rng):
    """The planar decode core matches the oracle on an odd-height
    frame."""
    import jax.numpy as jnp

    from conftest import make_bgr
    from vacv_tpu.ops.cvt_color import nv_to_bgr_planes

    h, w = 175, 144
    bgr = make_bgr(h, w, rng, smooth=True)
    nv21 = bgr2nv21_numpy(bgr)
    y, vu = nv21_planes(nv21, w, h)
    ref = nv_to_bgr(y, vu, is_nv12=False)
    b, g, r = nv_to_bgr_planes(jnp.asarray(y), jnp.asarray(vu),
                               is_nv12=False)
    got = np.stack([np.asarray(b), np.asarray(g), np.asarray(r)], axis=-1)
    np.testing.assert_array_equal(got, ref)


def test_nv_odd_width_rejected(rng):
    with pytest.raises(ValueError):
        vc.cvt_color(np.zeros((36, 25), np.uint8), vc.COLOR_YUV2BGR_NV21)


# ---- common channel-shuffle / gray codes (OpenCV family 0-11) ----------

_SHUFFLE_CODES = [
    ("COLOR_BGR2BGRA", 3),
    ("COLOR_BGRA2BGR", 4),
    ("COLOR_BGR2RGBA", 3),
    ("COLOR_RGBA2BGR", 4),
    ("COLOR_BGR2RGB", 3),
    ("COLOR_BGRA2RGBA", 4),
    ("COLOR_BGR2GRAY", 3),
    ("COLOR_RGB2GRAY", 3),
    ("COLOR_GRAY2BGR", 1),
    ("COLOR_GRAY2BGRA", 1),
    ("COLOR_BGRA2GRAY", 4),
    ("COLOR_RGBA2GRAY", 4),
]


@pytest.mark.parametrize("name,nch", _SHUFFLE_CODES)
def test_shuffle_codes_match_cv2_u8(bgr_176x144, rng, name, nch):
    """Every common shuffle/gray code matches cv2 exactly on u8
    (the reference serves these via cvt_color_opencv; here native)."""
    import cv2

    if nch == 1:
        src = cv2.cvtColor(bgr_176x144, cv2.COLOR_BGR2GRAY)
    elif nch == 4:
        src = cv2.cvtColor(bgr_176x144, cv2.COLOR_BGR2BGRA)
        src[..., 3] = rng.integers(0, 256, src.shape[:2], dtype=np.uint8)
    else:
        src = bgr_176x144
    ref = cv2.cvtColor(src, getattr(cv2, name))
    out = vc.cvt_color(src, getattr(vc.ColorCode, name)).numpy()
    if ref.ndim == 2:
        out = out.reshape(ref.shape)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["COLOR_BGR2GRAY", "COLOR_RGB2GRAY"])
def test_gray_codes_match_cv2_f32(bgr_176x144, name):
    import cv2

    src = bgr_176x144.astype(np.float32)
    ref = cv2.cvtColor(src, getattr(cv2, name))
    out = vc.cvt_color(src, getattr(vc.ColorCode, name)).numpy()
    np.testing.assert_allclose(out.reshape(ref.shape), ref, atol=1e-3)


# ---- YCrCb / YUV / HSV families (native; reference used OpenCV) --------

_CS_CODES = ["COLOR_BGR2YCrCb", "COLOR_RGB2YCrCb", "COLOR_BGR2YUV",
             "COLOR_RGB2YUV", "COLOR_BGR2HSV", "COLOR_RGB2HSV"]


@pytest.mark.parametrize("name", _CS_CODES)
def test_colorspace_forward_vs_cv2(bgr_176x144, name):
    import cv2

    ref = cv2.cvtColor(bgr_176x144, getattr(cv2, name))
    out = vc.cvt_color(bgr_176x144, getattr(vc.ColorCode, name)).numpy()
    diff = np.abs(out.astype(int) - ref.astype(int))
    if name.endswith("HSV"):
        # hue wraps mod 180: 0 and 179 are adjacent
        diff[..., 0] = np.minimum(diff[..., 0], 180 - diff[..., 0])
    assert diff.max() <= 1, (name, diff.max())


@pytest.mark.parametrize("fwd,inv", [
    ("COLOR_BGR2YCrCb", "COLOR_YCrCb2BGR"),
    ("COLOR_BGR2YUV", "COLOR_YUV2BGR"),
    ("COLOR_BGR2HSV", "COLOR_HSV2BGR"),
])
def test_colorspace_inverse_vs_cv2(bgr_176x144, fwd, inv):
    import cv2

    mid = cv2.cvtColor(bgr_176x144, getattr(cv2, fwd))
    ref = cv2.cvtColor(mid, getattr(cv2, inv))
    out = vc.cvt_color(mid, getattr(vc.ColorCode, inv)).numpy()
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (inv, diff.max())
    if not fwd.endswith("HSV"):
        # HSV2BGR: cv2's table-based math rounds differently on ~1/3
        # of pixels (all within 1 LSB); the matrix codes are tighter.
        assert (diff > 0).mean() < 0.02
