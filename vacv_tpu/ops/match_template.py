"""match_template + minMaxIdx — all six TM_* modes as matmuls.

The reference wraps OpenCV's ``matchTemplate``/``minMaxIdx`` with naive
/SSE/NEON slots left as todos
(``/root/reference/src/cv/match_template.cpp:13-61``).  We implement the
modes natively: the correlation core is an unfold + one matmul, and the
windowed sums the SQDIFF/NORMED/CCOEFF families need are separable
banded ones-matmuls.  Every dot runs at ``Precision.HIGHEST`` (true
float32; TF32 would lose the windowed sums of squares).  Formulas follow OpenCV's documented
definitions; multi-channel images sum the numerator/denominator over
channels.
"""
from __future__ import annotations

import functools

import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from ..core.image import Image, as_image
from ..core.types import Layout, MatchMode


@functools.lru_cache(maxsize=128)
def _ones_band(n_in: int, taps: int) -> np.ndarray:
    """(n_in - taps + 1, n_in) band-of-ones windowed-sum matrix."""
    n_out = n_in - taps + 1
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        w[o, o : o + taps] = 1.0
    return w


def _box_sum(x, th: int, tw: int):
    """Sliding-window (th, tw) sum over the trailing (H, W) axes of
    ``x`` -> (..., H-th+1, W-tw+1).

    A box sum is separable: two banded ones-matmuls replace a
    th-amplified ones-kernel unfold (the biggest traffic term of the
    NORMED/SQDIFF/CCOEFF denominators).  HIGHEST precision keeps the
    f32 accumulation faithful — windowed sums of x**2 need more than
    TF32's 11 significant bits.
    """
    wv = jnp.asarray(_ones_band(x.shape[-2], th))
    wx = jnp.asarray(_ones_band(x.shape[-1], tw))
    t = jnp.matmul(wv, x, preferred_element_type=jnp.float32,
                   precision=lax.Precision.HIGHEST)
    return jnp.matmul(t, wx.T, preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST)


def _nchw(img: Image):
    """(1, C, H, W) f32 view."""
    d = img.data.astype(jnp.float32)
    if d.ndim == 2:
        return d[None, None]
    if img.layout == Layout.HWC:
        d = jnp.transpose(d, (2, 0, 1))
    return d[None]


def _corr(x, k):
    """Valid cross-correlation: x (1,C,H,W) with k (1,C,th,tw) ->
    (H-th+1, W-tw+1).

    A shared vertical unfold ``U[(c,dy), y, xx] = x[c, y+dy, xx]``,
    ONE ``(tw, C*th) @ (C*th, rows*W)`` matmul producing every
    template-column's vertical correlation, and ``tw`` shifted adds.
    The dot runs on f32 operands at ``Precision.HIGHEST``, and y is
    chunked to bound the unfold buffer.
    """
    _, c, h, w = x.shape
    th, tw = k.shape[2], k.shape[3]
    h_out, w_out = h - th + 1, w - tw + 1
    k2 = jnp.transpose(k[0], (2, 0, 1)).reshape(tw, c * th)

    # Chunk rows so the unfold stays ~<=96 MB.
    chunk = max(8, (96 * 2**20 // max(1, c * th * w * 4)) // 8 * 8)
    pieces = []
    for y0 in range(0, h_out, chunk):
        rows = min(chunk, h_out - y0)
        u = jnp.stack(
            [
                lax.dynamic_slice_in_dim(x[0, ci], y0 + dy, rows, axis=0)
                for ci in range(c)
                for dy in range(th)
            ]
        ).reshape(c * th, rows * w)
        # HIGHEST precision: true f32 dot semantics.  The K dimension
        # is tiny (C*th), so its cost is small against the unfold
        # traffic.
        v = lax.dot_general(
            k2, u, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        ).reshape(tw, rows, w)
        pieces.append(
            sum(v[dx, :, dx : dx + w_out] for dx in range(tw))
        )
    return jnp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]


def match_template(src, target, method: MatchMode | int) -> Image:
    """Parity: ``va_cv::match_template`` (cv.h:218-219).  Returns the
    (H-th+1, W-tw+1) float32 response map as an ``Image``."""
    method = MatchMode(method)
    simg = as_image(src)
    x = _nchw(simg)
    t = _nchw(as_image(target))
    k = t  # (1, C, th, tw) used directly as the conv kernel
    th, tw = k.shape[2], k.shape[3]
    n = th * tw

    if method in (MatchMode.TM_CCORR, MatchMode.TM_CCORR_NORMED):
        num = _corr(x, k)
        if method == MatchMode.TM_CCORR:
            return Image(num, Layout.HWC)
        wnd2 = _box_sum(jnp.sum(x[0] * x[0], axis=0), th, tw)
        t2 = jnp.sum(k * k)
        denom = jnp.sqrt(wnd2 * t2)
        return Image(_normed_div(num, denom, sqdiff=False), Layout.HWC)

    if method in (MatchMode.TM_SQDIFF, MatchMode.TM_SQDIFF_NORMED):
        cc = _corr(x, k)
        wnd2 = _box_sum(jnp.sum(x[0] * x[0], axis=0), th, tw)
        t2 = jnp.sum(k * k)
        num = wnd2 - 2.0 * cc + t2
        if method == MatchMode.TM_SQDIFF:
            return Image(num, Layout.HWC)
        denom = jnp.sqrt(wnd2 * t2)
        return Image(_normed_div(num, denom, sqdiff=True), Layout.HWC)

    # CCOEFF family: mean-centred template per channel.
    t_mean = jnp.mean(k, axis=(2, 3), keepdims=True)
    kc = k - t_mean
    num = _corr(x, kc)
    if method == MatchMode.TM_CCOEFF:
        return Image(num, Layout.HWC)

    # Window variance term summed over channels:
    #   Σ_c [ Σw x² − (Σw x)²/n ]
    wnd2 = _box_sum(jnp.sum(x[0] * x[0], axis=0), th, tw)
    wnd1_per_c = _box_sum(x[0], th, tw)  # (C, H', W')
    wnd_var = wnd2 - jnp.sum(wnd1_per_c * wnd1_per_c, axis=0) / n
    t_var = jnp.sum(kc * kc)
    denom = jnp.sqrt(jnp.maximum(wnd_var, 0.0) * t_var)
    return Image(_normed_div(num, denom, sqdiff=False), Layout.HWC)


def _normed_div(num, denom, *, sqdiff: bool):
    """OpenCV's NORMED post-processing: |num| < den → num/den;
    |num| < 1.125·den → ±1; else 1 for SQDIFF_NORMED, 0 otherwise
    (guards both genuine out-of-range responses and ill-conditioned
    flat windows, exactly as cv::matchTemplate does)."""
    a = jnp.abs(num)
    safe = jnp.where(denom > 0, denom, 1.0)
    ratio = num / safe
    near = jnp.where(num > 0, 1.0, -1.0)
    far = jnp.float32(1.0 if sqdiff else 0.0)
    return jnp.where(a < denom, ratio, jnp.where(a < 1.125 * denom, near, far))


def min_max_idx(src, mask=None):
    """Parity: ``va_cv::minMaxIdx`` (cv.h:230-231).

    Returns ``(min_val, max_val, min_idx, max_idx)`` where the idx are
    flat (row-major) positions like OpenCV's single-channel contract.
    """
    img = as_image(src)
    d = img.data.astype(jnp.float32)
    flat = d.reshape(-1)
    if mask is not None:
        m = as_image(mask).data.reshape(-1) != 0
        big = jnp.float32(jnp.finfo(jnp.float32).max)
        flat_min = jnp.where(m, flat, big)
        flat_max = jnp.where(m, flat, -big)
        min_idx = jnp.argmin(flat_min)
        max_idx = jnp.argmax(flat_max)
        # All-masked input has no extrema: return NaN values (jit-safe
        # sentinel; a data-dependent raise is impossible under tracing).
        none = jnp.logical_not(jnp.any(m))
        nan = jnp.float32(jnp.nan)
        return (
            jnp.where(none, nan, flat[min_idx]),
            jnp.where(none, nan, flat[max_idx]),
            min_idx,
            max_idx,
        )
    min_idx = jnp.argmin(flat)
    max_idx = jnp.argmax(flat)
    return flat[min_idx], flat[max_idx], min_idx, max_idx


def min_max_loc(src, mask=None):
    """``cv::minMaxLoc``-style variant: returns
    ``(min_val, max_val, (min_x, min_y), (max_x, max_y))`` for a 2-D
    response map (the form template-matching callers want)."""
    img = as_image(src)
    h, w = img.data.shape[:2]
    mn, mx, mi, ma = min_max_idx(img, mask)
    return (
        mn, mx,
        (mi % w, mi // w),
        (ma % w, ma // w),
    )
