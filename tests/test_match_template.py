"""match_template + min_max_idx vs OpenCV for all six TM_* modes."""
import cv2
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.utils.compare import cosine_similarity

MODES = [
    (vc.TM_SQDIFF, cv2.TM_SQDIFF),
    (vc.TM_SQDIFF_NORMED, cv2.TM_SQDIFF_NORMED),
    (vc.TM_CCORR, cv2.TM_CCORR),
    (vc.TM_CCORR_NORMED, cv2.TM_CCORR_NORMED),
    (vc.TM_CCOEFF, cv2.TM_CCOEFF),
    (vc.TM_CCOEFF_NORMED, cv2.TM_CCOEFF_NORMED),
]


@pytest.mark.parametrize("ours,theirs", MODES)
@pytest.mark.parametrize("channels", [1, 3])
def test_modes_vs_opencv(bgr_176x144, ours, theirs, channels):
    src = bgr_176x144.astype(np.float32)
    if channels == 1:
        src = src[..., 0]
    templ = src[40:70, 50:90] if channels == 1 else src[40:70, 50:90, :]
    ref = cv2.matchTemplate(src, templ, theirs)
    out = vc.match_template(src, templ, ours).numpy()
    assert out.shape == ref.shape
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-3)


def test_peak_location_matches(bgr_176x144):
    src = bgr_176x144.astype(np.float32)
    templ = src[30:62, 20:52]
    out = vc.match_template(src, templ, vc.TM_CCOEFF_NORMED)
    _, max_val, _, max_idx = vc.min_max_idx(out)
    h_r, w_r = out.shape[:2]
    my, mx = divmod(int(max_idx), w_r)
    assert (my, mx) == (30, 20)
    assert float(max_val) > 0.99


def test_min_max_idx_basic():
    x = np.array([[3.0, 1.0], [7.0, -2.0]], np.float32)
    mn, mx, mi, ma = vc.min_max_idx(x)
    assert float(mn) == -2.0 and float(mx) == 7.0
    assert int(mi) == 3 and int(ma) == 2


def test_min_max_idx_mask():
    x = np.array([[3.0, 1.0], [7.0, -2.0]], np.float32)
    mask = np.array([[1, 1], [0, 0]], np.uint8)
    mn, mx, mi, ma = vc.min_max_idx(x, mask)
    assert float(mn) == 1.0 and float(mx) == 3.0


def test_min_max_loc(bgr_176x144):
    src = bgr_176x144.astype(np.float32)
    templ = src[30:62, 20:52]
    out = vc.match_template(src, templ, vc.TM_CCOEFF_NORMED)
    _, mx, _, max_pt = vc.min_max_loc(out)
    assert tuple(int(v) for v in max_pt) == (20, 30)
    ref_min, ref_max, ref_minl, ref_maxl = cv2.minMaxLoc(np.asarray(out.data))
    assert tuple(int(v) for v in max_pt) == tuple(ref_maxl)


def test_min_max_idx_all_masked():
    x = np.array([[3.0, 1.0], [7.0, -2.0]], np.float32)
    mn, mx, _, _ = vc.min_max_idx(x, np.zeros_like(x, dtype=np.uint8))
    assert np.isnan(float(mn)) and np.isnan(float(mx))


def _np_corr(x, k):
    """Valid cross-correlation of (1,C,H,W) with (1,C,th,tw), float64."""
    win = np.lib.stride_tricks.sliding_window_view(
        x[0].astype(np.float64), k.shape[2:], axis=(1, 2))
    return np.einsum("cyxij,cij->yx", win, k[0].astype(np.float64))


def test_corr_matches_numpy(rng):
    """The unfold + HIGHEST-precision matmul correlation is exact for
    u8-valued images (sums < 2^24)."""
    import jax.numpy as jnp

    from vacv_tpu.ops.match_template import _corr

    x = rng.integers(0, 256, (1, 3, 96, 256)).astype(np.float32)
    k = rng.integers(0, 256, (1, 3, 24, 17)).astype(np.float32)
    got = np.asarray(_corr(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, _np_corr(x, k), rtol=1e-6, atol=1e-2)


def test_corr_fractional_f32(rng):
    """Fractional f32 images: error far below the 1e-4 cosine bar."""
    import jax.numpy as jnp

    from vacv_tpu.ops.match_template import _corr

    x = rng.random((1, 1, 64, 128), dtype=np.float32) * 2 - 1
    k = rng.random((1, 1, 16, 16), dtype=np.float32) * 2 - 1
    got = np.asarray(_corr(jnp.asarray(x), jnp.asarray(k)))
    ref = _np_corr(x, k)
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


def test_corr_wide_and_tall_templates(rng):
    """Templates wider than 128 columns and nearly as tall as the image."""
    import jax.numpy as jnp

    from vacv_tpu.ops.match_template import _corr

    x = rng.integers(0, 256, (1, 3, 40, 320)).astype(np.float32)
    k = rng.integers(0, 256, (1, 3, 32, 200)).astype(np.float32)
    got = np.asarray(_corr(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, _np_corr(x, k), rtol=1e-6)
