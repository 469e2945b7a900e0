"""resize — bilinear / bicubic / nearest / area / lanczos4 as two
separable matrix products (vacv op #5).

The reference resize is a per-output-pixel gather-and-blend loop —
scalar C with fixed-point coefficients
(``/root/reference/src/cv/resize_naive.cpp:10-128``) or NEON int16
lanes with row reuse (``resize_neon.cpp:20-347``).  Here separable
resampling is a pair of dense matrix products:

    dst = W_y @ src @ W_xᵀ

where ``W_y: (h_out, h_in)`` and ``W_x: (w_out, w_in)`` hold the
per-output-row / per-output-column interpolation weights.  Every
interpolation family differs only in how the weight matrices are built;
the device program is always two matmuls over channel planes — batched,
static-shaped, and fused by XLA with surrounding dtype/normalize work.
The pass order (H-first vs W-first) is chosen to minimize MACs.

Weight construction reproduces the reference's coefficient rules
exactly:

* bilinear: half-pixel mapping ``(d + 0.5) * scale - 0.5``, edge clamp
  to ``[0, n-2]`` with weight collapse (``resize_naive.cpp:20-53``);
  u8 inputs use the Q11 (×2048) quantized weights of the fixed-point
  path so the float matmul reproduces the integer kernel's arithmetic
  (``resize_naive.cpp:34-35,61-64``).
* bicubic: Catmull-Rom-like kernel with A = −0.75 and the reference's
  boundary folding of out-of-range taps (``resize_naive.cpp:130-185``).
* nearest / area follow OpenCV semantics (the reference forwards these
  modes to OpenCV, ``resize.cpp:46-49``; we implement them natively).

Matmul precision is chosen per call (``_apply_separable``): on a GPU,
``Precision.DEFAULT`` runs float32 dots in TF32 (11 significant bits),
``HIGHEST`` in true float32.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.image import Image, as_image
from ..core.types import InterMode, Layout, VSize

# Q11 fixed-point scale used by the reference's u8 kernels
# (resize_naive.cpp:34, resize_neon.cpp:14-15).
_COEF_SCALE = 2048.0


def _linear_weights(n_in: int, n_out: int, quantize: bool) -> np.ndarray:
    """Dense (n_out, n_in) bilinear weight matrix.

    Mapping and edge handling per resize_naive.cpp:20-53.  With
    ``quantize`` the two tap weights are snapped to the Q11 grid the u8
    fixed-point kernel uses.
    """
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    # float scale, double mapping, float result — the C expression
    # ``(float)((dx + 0.5) * scale_x - 0.5)`` with a float ``scale_x``.
    scale = np.float32(n_in) / np.float32(n_out)
    d = np.arange(n_out, dtype=np.float64)
    f = ((d + 0.5) * np.float64(scale) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 1.0
    s[s >= n_in - 1] = n_in - 2

    w0 = 1.0 - f
    w1 = f
    if quantize:
        w0 = np.floor(w0 * _COEF_SCALE + 0.5) / _COEF_SCALE
        w1 = np.floor(w1 * _COEF_SCALE + 0.5) / _COEF_SCALE
    W = np.zeros((n_out, n_in), dtype=np.float32)
    W[d.astype(np.int64), s] = w0
    W[d.astype(np.int64), s + 1] += w1
    return W


def _cubic_kernel(fx: np.ndarray) -> np.ndarray:
    """4 tap weights for fractional offset ``fx`` (A=-0.75 kernel,
    resize_naive.cpp:130-141).  Returns shape (len(fx), 4)."""
    A = -0.75
    fx0 = fx + 1.0
    fx1 = fx
    fx2 = 1.0 - fx
    c0 = A * fx0**3 - 5 * A * fx0**2 + 8 * A * fx0 - 4 * A
    c1 = (A + 2) * fx1**3 - (A + 3) * fx1**2 + 1
    c2 = (A + 2) * fx2**3 - (A + 3) * fx2**2 + 1
    c3 = 1.0 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bicubic weight matrix with the reference's
    boundary folding (resize_naive.cpp:143-185)."""
    if n_in < 4:
        # The reference's cubic path assumes >=4 taps fit; degrade to
        # linear exactly like its OpenCV fallback would interpolate.
        return _linear_weights(n_in, n_out, quantize=False)
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    f = np.float32((d + 0.5) * scale - 0.5)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)

    alpha = _cubic_kernel(f).astype(np.float32)  # (n_out, 4)
    sx = s.copy()

    # Fold out-of-range taps into the edge, per cubic_coeffs_naive.
    m = sx <= -1
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [1.0 - a[:, 3], a[:, 3], np.zeros_like(a[:, 0]), np.zeros_like(a[:, 0])],
            axis=-1,
        )
        sx[m] = 1
    m = s == 0
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [a[:, 0] + a[:, 1], a[:, 2], a[:, 3], np.zeros_like(a[:, 0])], axis=-1
        )
        sx[m] = 1
    m = s == n_in - 2
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [np.zeros_like(a[:, 0]), a[:, 0], a[:, 1], a[:, 2] + a[:, 3]], axis=-1
        )
        sx[m] = n_in - 3
    m = s >= n_in - 1
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [np.zeros_like(a[:, 0]), np.zeros_like(a[:, 0]), a[:, 0], 1.0 - a[:, 0]],
            axis=-1,
        )
        sx[m] = n_in - 3

    W = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    for t in range(4):
        np.add.at(W, (rows, sx - 1 + t), alpha[:, t])
    return W


def _lanczos4_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) Lanczos-4 weight matrix (OpenCV
    INTER_LANCZOS4 semantics: 8 taps of sinc(x)·sinc(x/4), normalized
    to unit sum, taps clamped to the image).  The reference forwards
    this mode to OpenCV (resize.cpp:46-49); here it is just another
    weight matrix for the same two-matmul resampler."""
    if n_in < 8:
        return _cubic_weights(n_in, n_out)
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    f = np.float32((d + 0.5) * scale - 0.5)
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float64)

    W = np.zeros((n_out, n_in), dtype=np.float64)
    taps = np.arange(-3, 5)  # 8 taps: s-3 .. s+4
    for k in taps:
        x = k - frac  # distance from the sample point
        w = np.sinc(x) * np.sinc(x / 4.0)
        w[np.abs(x) >= 4] = 0.0
        cols = np.clip(s + k, 0, n_in - 1)
        np.add.at(W, (np.arange(n_out), cols), w)
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


def _nearest_weights(n_in: int, n_out: int) -> np.ndarray:
    """One-hot (n_out, n_in) nearest-neighbour matrix (OpenCV mapping:
    ``sx = min(floor(dx * scale), n_in - 1)``)."""
    scale = n_in / n_out
    s = np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)
    W = np.zeros((n_out, n_in), dtype=np.float32)
    W[np.arange(n_out), s] = 1.0
    return W


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) box-average matrix (OpenCV INTER_AREA downscale:
    each output pixel averages the box ``[d*scale, (d+1)*scale)`` with
    fractional edge coverage).  For upscale this degrades to bilinear,
    matching OpenCV's behaviour."""
    if n_out >= n_in:
        return _linear_weights(n_in, n_out, quantize=False)
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), dtype=np.float64)
    for d in range(n_out):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            cover = min(hi, i + 1) - max(lo, i)
            if cover > 0:
                W[d, i] = cover / scale
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _weight_matrices(
    h_in: int, w_in: int, h_out: int, w_out: int, mode: int, quantize: bool
):
    """Cached (W_y, W_x) numpy weight matrices for a resize config."""
    mode = InterMode(mode)
    if mode == InterMode.INTER_LINEAR:
        wy = _linear_weights(h_in, h_out, quantize)
        wx = _linear_weights(w_in, w_out, quantize)
    elif mode == InterMode.INTER_CUBIC:
        wy = _cubic_weights(h_in, h_out)
        wx = _cubic_weights(w_in, w_out)
    elif mode == InterMode.INTER_NEAREST:
        wy = _nearest_weights(h_in, h_out)
        wx = _nearest_weights(w_in, w_out)
    elif mode == InterMode.INTER_AREA:
        wy = _area_weights(h_in, h_out)
        wx = _area_weights(w_in, w_out)
    elif mode == InterMode.INTER_LANCZOS4:
        wy = _lanczos4_weights(h_in, h_out)
        wx = _lanczos4_weights(w_in, w_out)
    else:
        raise NotImplementedError(
            f"resize mode {mode!r} not supported; supported modes are "
            "INTER_LINEAR, INTER_CUBIC, INTER_NEAREST, INTER_AREA and "
            "INTER_LANCZOS4.  The nearest workaround for other modes "
            "is INTER_LINEAR (the reference's own default fallback, "
            "resize.cpp:46-49)."
        )
    return wy, wx


# Block-banded matmul parameters.  Interpolation weight matrices are
# banded (2–8 taps per output), so a block of _BAND_BLOCK consecutive
# outputs only touches a contiguous source band of ~block*scale+taps
# elements.  Splitting the dense (n_out, n_in) matmul into per-block
# (block, band) matmuls skips the structurally-zero tiles.  Only the
# *second* pass is banded; the first consumes the original operand
# whole (on the H100 XLA writes its u8→f32 copy before the first dot
# either way, PERF.md).  The reference's row-reuse NEON trick
# (resize_neon.cpp:86-127) exploits the same band structure
# sequentially.  The block size and the slice-start alignments below
# are correct on any device; their best values on the GPU have not
# been measured.
_BAND_BLOCK = 128
_BAND_THRESHOLD = 0.85
# Band starts are rounded down to these multiples (rows, columns).
_ALIGN_ROWS = 8
_ALIGN_COLS = 128


def _band_blocks(W: np.ndarray, align: int, block: int = _BAND_BLOCK):
    """Row blocks of ``W`` with their (aligned) nonzero column bands.

    Returns (blocks, cost) where blocks is a list of (r0, r1, c0, c1)
    and cost = sum of block areas (MACs per unit of the other dim).
    """
    n_out = W.shape[0]
    nz = W != 0.0
    blocks = []
    cost = 0
    for r0 in range(0, n_out, block):
        r1 = min(r0 + block, n_out)
        cols = np.nonzero(nz[r0:r1].any(axis=0))[0]
        c0 = (int(cols[0]) // align) * align
        c1 = int(cols[-1]) + 1
        blocks.append((r0, r1, c0, c1))
        cost += (r1 - r0) * (c1 - c0)
    return blocks, cost


def _plan(W: np.ndarray, align: int):
    """Banding decision for one weight matrix: (blocks_or_None, cost)
    where cost is MACs per unit of the non-resampled dim."""
    dense = W.shape[0] * W.shape[1]
    blocks, banded = _band_blocks(W, align)
    if len(blocks) > 1 and banded <= _BAND_THRESHOLD * dense:
        return blocks, banded
    return None, dense


@functools.lru_cache(maxsize=512)
def _pass_plan(key, align):
    """Cached ``_plan`` keyed by ``_weight_matrices`` args + axis."""
    return _plan(_weight_matrices(*key[:6])[key[6]], align)


def _matmul_rows(W: np.ndarray, x, blocks, precision):
    """``W @ x`` over axis -2, optionally block-banded."""
    if blocks is None:
        return jnp.matmul(jnp.asarray(W), x, precision=precision,
                          preferred_element_type=jnp.float32)
    outs = [
        jnp.matmul(
            jnp.asarray(W[r0:r1, c0:c1]),
            x[..., c0:c1, :],
            precision=precision,
            preferred_element_type=jnp.float32,
        )
        for (r0, r1, c0, c1) in blocks
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-2)


def _matmul_cols(W: np.ndarray, x, blocks, precision):
    """``x @ Wᵀ`` over axis -1, optionally block-banded."""
    if blocks is None:
        return jnp.matmul(x, jnp.asarray(W.T), precision=precision,
                          preferred_element_type=jnp.float32)
    outs = [
        jnp.matmul(
            x[..., :, c0:c1],
            jnp.asarray(W[r0:r1, c0:c1].T),
            precision=precision,
            preferred_element_type=jnp.float32,
        )
        for (r0, r1, c0, c1) in blocks
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)


def _apply_separable(planes, wy, wx, wkey=None, quantized_u8=False):
    """``W_y @ planes @ W_xᵀ`` over the trailing (H, W) axes.

    The first pass (consuming the original operand) is always dense;
    the second pass is block-banded when that cuts MACs.  Pass order is
    chosen to minimize modeled MACs under that rule.
    ``planes``: (..., h_in, w_in) float32.

    ``quantized_u8`` (u8 source, Q11 bilinear weights) returns the
    reference's Q22 sum already truncated (``>> 22``), computed exactly:
    every matmul operand has at most 11 significant bits and every
    partial sum stays below 2^24 units, so the products are exact even
    in TF32 and both passes run at ``Precision.DEFAULT``.  The first
    pass yields ``t = T / 2048`` (integer ``T < 2^20``); the second runs
    on ``hi = floor(t)`` and ``lo = T mod 2048`` separately and the two
    halves recombine in int32.  Float data and the other weight
    families run both passes at ``HIGHEST`` (true float32; TF32 keeps
    only ~3 decimal digits).
    """
    h_out, h_in = wy.shape
    w_out, w_in = wx.shape
    if wkey is not None:
        yblocks, ycost = _pass_plan(wkey + (0,), _ALIGN_ROWS)
        xblocks, xcost = _pass_plan(wkey + (1,), _ALIGN_COLS)
    else:  # uncached weights (direct use): plan inline
        yblocks, ycost = _plan(wy, _ALIGN_ROWS)
        xblocks, xcost = _plan(wx, _ALIGN_COLS)
    precision = lax.Precision.DEFAULT if quantized_u8 else lax.Precision.HIGHEST
    # First pass dense (fusion), second pass banded (MAC savings).
    cost_h_first = h_out * h_in * w_in + xcost * h_out
    cost_w_first = w_out * w_in * h_in + ycost * w_out
    if cost_h_first <= cost_w_first:
        t = _matmul_rows(wy, planes, None, precision)
        second = lambda v: _matmul_cols(wx, v, xblocks, precision)
    else:
        t = _matmul_cols(wx, planes, None, precision)
        second = lambda v: _matmul_rows(wy, v, yblocks, precision)
    if not quantized_u8:
        return second(t)
    hi = jnp.floor(t)
    lo = (t - hi) * 2048.0
    to_i32 = lambda v: jnp.round(v * 2048.0).astype(jnp.int32)
    acc = to_i32(second(hi)) * 2048 + to_i32(second(lo))
    return (acc >> 22).astype(jnp.float32)


def resize_planes(planes, h_out: int, w_out: int, mode: InterMode, *, u8: bool):
    """Resize (..., h, w) float32 channel planes.  Returns float32.

    ``u8`` selects the Q11-quantized bilinear weights; the bilinear
    result is then the reference fixed-point kernel's truncated value
    (``>> 22``), exactly.
    """
    h_in, w_in = planes.shape[-2], planes.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        # Same-size: memcpy shortcut (resize.cpp:58-61).
        return planes
    quantize = bool(u8) and mode == InterMode.INTER_LINEAR
    wkey = (h_in, w_in, h_out, w_out, int(mode), quantize)
    wy, wx = _weight_matrices(*wkey)
    return _apply_separable(planes, wy, wx, wkey, quantized_u8=quantize)


def _resolve_dsize(h_in, w_in, dsize, fx, fy):
    w_out = dsize.w if dsize is not None else 0
    h_out = dsize.h if dsize is not None else 0
    if w_out <= 0 or h_out <= 0:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize needs dsize or positive fx/fy")
        w_out = int(round(w_in * fx))
        h_out = int(round(h_in * fy))
    return h_out, w_out


def resize(
    src,
    dsize: VSize | tuple | None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterMode | int = InterMode.INTER_LINEAR,
) -> Image:
    """Resize an image (parity: ``va_cv::resize``, cv.h:85-87).

    Accepts an ``Image`` or raw array (assumed HWC).  u8 input yields
    u8 output via truncation exactly like the fixed-point reference
    kernel (``>> 22``, resize_naive.cpp:61-64); float input stays
    float.
    """
    img = as_image(src)
    if isinstance(dsize, tuple):
        dsize = VSize(*dsize)
    mode = InterMode(interpolation)
    h_out, w_out = _resolve_dsize(img.h, img.w, dsize, fx, fy)

    data = img.data
    is_u8 = data.dtype == jnp.uint8
    squeeze = data.ndim == 2
    if squeeze:
        planes = data[None]  # (1, h, w)
    elif img.layout == Layout.HWC:
        planes = jnp.transpose(data, (2, 0, 1))
    else:
        planes = data

    out = resize_planes(
        planes.astype(jnp.float32), h_out, w_out, mode, u8=is_u8
    )
    if is_u8:
        if mode == InterMode.INTER_LINEAR:
            # Fixed-point parity: resize_planes already truncated the
            # Q22 sum (>> 22) exactly.
            out = jnp.clip(out, 0, 255).astype(jnp.uint8)
        else:
            # cubic/area/nearest have no vacv fixed-point kernel (the
            # reference forwards them to OpenCV, resize.cpp:46-49) —
            # round to nearest like cv::resize does.
            out = jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)
    elif data.dtype != jnp.float32:
        # half-precision inputs (f16/bf16): accumulate in f32, narrow
        # on write-out (the fp16 graveyard resize's design)
        out = out.astype(data.dtype)

    if squeeze:
        out = out[0]
    elif img.layout == Layout.HWC:
        out = jnp.transpose(out, (1, 2, 0))
    return img.with_data(out)
