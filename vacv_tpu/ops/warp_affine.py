"""warp_affine — inverse-mapped bilinear affine warp (vacv op #8).

Reference algorithm (``/root/reference/src/cv/warp_affine.cpp:111-169``,
``warp_affine_naive.cpp:9-106``): invert the forward 2×3 matrix, then
for every destination pixel compute the source coordinate
``(fx, fy) = M⁻¹ · (dx, dy, 1)``, skip pixels whose 2×2 support falls
outside ``[0, w-2] × [0, h-2]``, and bilinear-blend (u8: Q11
fixed-point, ``>> 22`` truncation; f32: float weights).

Design: the destination coordinate field of an affine map is *linear*,
so ``fx``/``fy`` are built with two broadcasted iotas — no per-pixel
scalar loop.  The four source taps are fetched with flattened XLA
gathers (indices clamped, invalid pixels masked to the border value).
Axis-aligned matrices (no rotation or shear) skip the gather and run
as two banded matmuls (``_warp_separable``).

Parity notes:
* The reference destructively inverts the caller's M in place
  (warp_affine.cpp:121-133) — we of course don't; pass
  ``inverse=True``-style ``WARP_INVERSE_MAP`` via ``flags`` instead.
* Out-of-bounds destination pixels are *left unwritten* by the
  reference (relying on freshly-malloc'd zeros); we write the border
  value (default 0), which is the same observable result with defined
  semantics.
* ``sx >= w_in - 1`` counts as out-of-bounds (the reference skips the
  last valid column/row rather than clamping like OpenCV).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core.image import Image, as_image
from ..core.types import BorderMode, InterMode, Layout, VPoint, VScalar, VSize

_COEF_SCALE = 2048.0


def get_rotation_matrix_2d(point: VPoint, angle: float, scale: float) -> np.ndarray:
    """2×3 rotation matrix, OpenCV-compatible (parity:
    ``WarpAffine::get_rotation_matrix_2D``, warp_affine.cpp:76-94).

    ``angle`` in degrees, positive = counter-clockwise.
    """
    a = np.deg2rad(angle)
    alpha = scale * np.cos(a)
    beta = scale * np.sin(a)
    return np.array(
        [
            [alpha, beta, (1 - alpha) * point.x - beta * point.y],
            [-beta, alpha, beta * point.x + (1 - alpha) * point.y],
        ],
        dtype=np.float32,
    )


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 2×3 affine matrix (parity: warp_affine.cpp:121-133,
    minus the reference's in-place clobbering of the caller's data)."""
    m = np.asarray(m, dtype=np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11 = m[1, 1] * d
    a22 = m[0, 0] * d
    a12 = -m[0, 1] * d
    a21 = -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], dtype=np.float32)


def _quantize_q11(w):
    """Snap a weight in [0,1] to the Q11 grid like SATURATE_CAST_SHORT
    (macro.h:25-30) does for the u8 fixed-point path."""
    return jnp.floor(w * _COEF_SCALE + 0.5) / _COEF_SCALE


def _cubic_coefs(frac):
    """jnp 4-tap A=-0.75 cubic weights for fractional offset ``frac``
    (same kernel as resize's ``_cubic_kernel``; OpenCV interpolateCubic)."""
    A = jnp.float32(-0.75)
    f0 = frac + 1.0
    f2 = 1.0 - frac
    c0 = A * f0**3 - 5 * A * f0**2 + 8 * A * f0 - 4 * A
    c1 = (A + 2) * frac**3 - (A + 3) * frac**2 + 1
    c2 = (A + 2) * f2**3 - (A + 3) * f2**2 + 1
    return c0, c1, c2, 1.0 - c0 - c1 - c2


def _reflect_index(t, n: int, *, include_edge: bool):
    """Reflect integer coordinates into [0, n): BORDER_REFLECT
    (``include_edge=True``, period 2n, edge pixel duplicated) or
    BORDER_REFLECT_101 (period 2n-2, edge not duplicated) — the same
    index maps cv::borderInterpolate computes."""
    if include_edge:
        m = jnp.mod(t, 2 * n)
        return jnp.where(m >= n, 2 * n - 1 - m, m)
    if n == 1:
        return jnp.zeros_like(t)
    m = jnp.mod(t, 2 * n - 2)
    return jnp.where(m >= n, 2 * n - 2 - m, m)


# The coordinate-remap border modes (cv::borderInterpolate index maps),
# which the separable path folds into its tap indices.
_REMAP_BORDERS = (
    BorderMode.BORDER_REPLICATE,
    BorderMode.BORDER_REFLECT,
    BorderMode.BORDER_REFLECT_101,
    BorderMode.BORDER_WRAP,
)


def _np_border_index(col: np.ndarray, n: int, border: "BorderMode") -> np.ndarray:
    """cv::borderInterpolate's index map, in numpy, for the separable
    weight builder (same rules as the jnp route's ``remap``)."""
    if border == BorderMode.BORDER_REPLICATE:
        return np.clip(col, 0, n - 1)
    if border == BorderMode.BORDER_REFLECT:
        m = np.mod(col, 2 * n)
        return np.where(m >= n, 2 * n - 1 - m, m)
    if border == BorderMode.BORDER_REFLECT_101:
        if n == 1:
            return np.zeros_like(col)
        m = np.mod(col, 2 * n - 2)
        return np.where(m >= n, 2 * n - 2 - m, m)
    if border == BorderMode.BORDER_WRAP:
        return np.mod(col, n)
    raise AssertionError(border)


@functools.lru_cache(maxsize=256)
def _axis_weights(n_in: int, n_out: int, a: float, b: float, interp: str,
                  quantize: bool, border: int):
    """1-D warp weight matrix for the axis-aligned source map
    ``f(d) = a*d + b`` (one axis of a separable affine), plus the
    per-output valid-weight row sums.

    Tap positions and weights follow the gather route exactly (f32
    coordinate math, floor/frac anchoring, Q11 quantization for the u8
    linear path, OpenCV half-up rounding for nearest, 4-tap A=-0.75 for
    cubic).  BORDER_CONSTANT zeroes out-of-image taps (the caller
    backfills the weight deficit with the border value — exact per-tap
    cv::warpAffine CONSTANT semantics); the coordinate-remap modes fold
    the border rule into the tap index, so the row sums are exactly 1.

    Returns ``(W, rowsum)`` with ``W: (n_out, n_in) float32``.
    """
    border = BorderMode(border)
    d = np.arange(n_out, dtype=np.float32)
    f = np.float32(a) * d + np.float32(b)
    if interp == "nearest":
        taps = [(np.floor(f + np.float32(0.5)).astype(np.int64),
                 np.ones(n_out, np.float32))]
    elif interp == "linear":
        s = np.floor(f).astype(np.int64)
        frac = (f - s).astype(np.float32)
        w0 = 1.0 - frac
        if quantize:
            w0 = (np.floor(w0 * _COEF_SCALE + 0.5) / _COEF_SCALE).astype(
                np.float32)
        taps = [(s, w0), (s + 1, (1.0 - w0).astype(np.float32))]
    else:  # cubic
        s = np.floor(f).astype(np.int64)
        frac = (f - s).astype(np.float32)
        A = -0.75
        f0 = frac + 1.0
        f2 = 1.0 - frac
        c0 = A * f0**3 - 5 * A * f0**2 + 8 * A * f0 - 4 * A
        c1 = (A + 2) * frac**3 - (A + 3) * frac**2 + 1
        c2 = (A + 2) * f2**3 - (A + 3) * f2**2 + 1
        c3 = 1.0 - c0 - c1 - c2
        taps = [(s - 1 + k, c.astype(np.float32))
                for k, c in enumerate((c0, c1, c2, c3))]

    W = np.zeros((n_out, n_in), dtype=np.float32)
    rowsum = np.zeros(n_out, dtype=np.float32)
    rows = np.arange(n_out)
    for col, w in taps:
        if border == BorderMode.BORDER_CONSTANT:
            valid = (col >= 0) & (col <= n_in - 1)
            np.add.at(W, (rows[valid], col[valid]), w[valid])
            rowsum += np.where(valid, w, 0.0)
        else:
            np.add.at(W, (rows, _np_border_index(col, n_in, border)), w)
            rowsum += w
    return W, rowsum.astype(np.float32)


# Row-block size for the banded separable matmuls (same banding as
# resize's _BAND_BLOCK machinery).
_SEP_BLOCK = 128


def _sep_band_plan(W: np.ndarray, align: int):
    """(blocks, cost): row blocks of ``W`` with aligned nonzero column
    bands.  Unlike resize's ``_band_blocks`` this admits all-zero
    blocks (fully out-of-bounds output spans under BORDER_CONSTANT),
    marked as ``(r0, r1, 0, 0)``."""
    blocks = []
    cost = 0
    for r0 in range(0, W.shape[0], _SEP_BLOCK):
        r1 = min(r0 + _SEP_BLOCK, W.shape[0])
        cols = np.nonzero((W[r0:r1] != 0.0).any(axis=0))[0]
        if cols.size == 0:
            blocks.append((r0, r1, 0, 0))
            continue
        c0 = (int(cols[0]) // align) * align
        c1 = int(cols[-1]) + 1
        blocks.append((r0, r1, c0, c1))
        cost += (r1 - r0) * (c1 - c0)
    return blocks, cost


def _sep_matmul_rows(W, x, blocks):
    """Banded ``W @ x`` over axis -2.  ``HIGHEST`` precision: the
    operands are arbitrary f32 image data and fractional weights, which
    TF32 (``DEFAULT`` on a GPU) would round to 11 significant bits."""
    outs = []
    for (r0, r1, c0, c1) in blocks:
        if c0 == c1:
            outs.append(jnp.zeros(x.shape[:-2] + (r1 - r0, x.shape[-1]),
                                  jnp.float32))
        else:
            outs.append(jnp.matmul(
                jnp.asarray(W[r0:r1, c0:c1]), x[..., c0:c1, :],
                precision=lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-2)


def _sep_matmul_cols(W, x, blocks):
    """Banded ``x @ Wᵀ`` over axis -1 (``HIGHEST``, as above)."""
    outs = []
    for (r0, r1, c0, c1) in blocks:
        if c0 == c1:
            outs.append(jnp.zeros(x.shape[:-1] + (r1 - r0,), jnp.float32))
        else:
            outs.append(jnp.matmul(
                x[..., :, c0:c1], jnp.asarray(W[r0:r1, c0:c1].T),
                precision=lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            ))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)


def _warp_separable(planes, minv, h_out: int, w_out: int, *, u8: bool,
                    border_value: float, edge_mode: str,
                    border: "BorderMode", interp: str):
    """Axis-aligned (m1 == m3 == 0) affine warp as two banded matmuls
    — the resize machinery generalized to affine offsets.

    A rotation-free affine map is exactly separable:
    ``dst = W_y @ src @ W_xᵀ`` with per-axis warp weight rows built
    from ``fx = m0·dx + m2`` / ``fy = m4·dy + m5``, with no gather.
    BORDER_CONSTANT's missing
    tap weight is restored as a rank-1 backfill
    ``bv · (1 − rowsum_y ⊗ rowsum_x)``; remap borders fold into the
    tap indices (exact for arbitrary overshoot).

    Both matmul passes are block-banded: a full-frame near-unit-scale
    warp has n_out ≈ n_in on both axes, where one dense pass would
    cost ~17 G MACs at 1440p against the band's ~1.8 G.

    Returns f32 planes (pre-truncation, like ``_warp_planes``).
    """
    h_in, w_in = planes.shape[-2], planes.shape[-1]
    m = np.asarray(minv, np.float32)
    q = bool(u8) and interp == "linear"
    wy, ry = _axis_weights(h_in, h_out, float(m[1, 1]), float(m[1, 2]),
                           interp, q, int(border))
    wx, rx = _axis_weights(w_in, w_out, float(m[0, 0]), float(m[0, 2]),
                           interp, q, int(border))

    yblocks, ycost = _sep_band_plan(wy, 8)
    xblocks, xcost = _sep_band_plan(wx, 128)
    # Pass order by banded MAC count (cost × the other pass's dim).
    if ycost * w_in + xcost * h_out <= xcost * h_in + ycost * w_out:
        t = _sep_matmul_rows(wy, planes, yblocks)
        out = _sep_matmul_cols(wx, t, xblocks)
    else:
        t = _sep_matmul_cols(wx, planes, xblocks)
        out = _sep_matmul_rows(wy, t, yblocks)

    if border == BorderMode.BORDER_CONSTANT:
        deficit = 1.0 - ry[:, None] * rx[None, :]
        if float(border_value) != 0.0 and np.any(deficit > 0):
            out = out + jnp.asarray(
                np.float32(border_value) * deficit.astype(np.float32))
    if edge_mode == "vacv" and interp == "linear":
        full_support = _vacv_support_mask(minv, h_out, w_out, h_in, w_in)
        out = jnp.where(full_support, out, jnp.float32(border_value))
    return out


def _vacv_support_mask(minv, h_out: int, w_out: int, h_in: int, w_in: int):
    """The reference's skip-edge predicate on the output grid: True
    where the 2x2 support is fully inside (warp_affine_naive.cpp:26-38)."""
    m = [float(v) for v in np.asarray(minv, dtype=np.float32).ravel()]
    dx = jnp.arange(w_out, dtype=jnp.float32)[None, :]
    dy = jnp.arange(h_out, dtype=jnp.float32)[:, None]
    fx = jnp.float32(m[0]) * dx + jnp.float32(m[1]) * dy + jnp.float32(m[2])
    fy = jnp.float32(m[3]) * dx + jnp.float32(m[4]) * dy + jnp.float32(m[5])
    sx = jnp.floor(fx).astype(jnp.int32)
    sy = jnp.floor(fy).astype(jnp.int32)
    return (sx >= 0) & (sx < w_in - 1) & (sy >= 0) & (sy < h_in - 1)


def _warp_planes(planes, minv: np.ndarray, h_out: int, w_out: int, *, u8: bool,
                 border_value: float, edge_mode: str,
                 border: BorderMode | int = BorderMode.BORDER_CONSTANT,
                 interp: InterMode = InterMode.INTER_LINEAR):
    """Warp (..., h_in, w_in) f32 planes with inverse matrix ``minv``.

    ``edge_mode``:
    * ``"opencv"`` (default): each of the four taps individually reads
      the border value when outside the image — exact
      ``cv::warpAffine`` BORDER_CONSTANT semantics.
    * ``"vacv"``: any output pixel whose 2×2 support is not fully
      inside ``[0, w-2]×[0, h-2]`` gets the border value outright —
      the reference's skip-and-leave-zero semantics
      (warp_affine_naive.cpp:26-38).

    ``border``: BORDER_CONSTANT (per-tap masking as above), or a
    coordinate-remap mode — REPLICATE (clamp), REFLECT, REFLECT_101,
    WRAP — matching ``cv::borderInterpolate`` (the reference serves
    the non-CONSTANT/REPLICATE modes via its OpenCV fallback,
    warp_affine.cpp:114-119; enum cv.h:39-49).

    ``interp``: INTER_LINEAR (reference-native), INTER_NEAREST and
    INTER_CUBIC (the reference served these through its OpenCV
    fallback, warp_affine.cpp:114-119 → warp_affine_opencv).
    """
    h_in, w_in = planes.shape[-2], planes.shape[-1]
    m = [float(v) for v in np.asarray(minv, dtype=np.float32).ravel()]

    # fx = m0*dx + m1*dy + m2 ; fy = m3*dx + m4*dy + m5
    # (warp_affine_naive.cpp:23-24) — float32 throughout, as reference.
    dx = jnp.arange(w_out, dtype=jnp.float32)[None, :]
    dy = jnp.arange(h_out, dtype=jnp.float32)[:, None]
    fx = jnp.float32(m[0]) * dx + jnp.float32(m[1]) * dy + jnp.float32(m[2])
    fy = jnp.float32(m[3]) * dx + jnp.float32(m[4]) * dy + jnp.float32(m[5])

    sx = jnp.floor(fx)
    sy = jnp.floor(fy)
    ax = fx - sx
    ay = fy - sy
    sx = sx.astype(jnp.int32)
    sy = sy.astype(jnp.int32)

    # Flattened gathers, one per tap, each tap's coordinates clamped
    # individually; indices (h_out*w_out,) shared across channels.
    flat = planes.reshape(planes.shape[:-2] + (h_in * w_in,))
    bv = jnp.float32(border_value)
    border = BorderMode(border)

    def remap(t, n):
        if border == BorderMode.BORDER_REPLICATE:
            return jnp.clip(t, 0, n - 1)
        if border == BorderMode.BORDER_REFLECT:
            return _reflect_index(t, n, include_edge=True)
        if border == BorderMode.BORDER_REFLECT_101:
            return _reflect_index(t, n, include_edge=False)
        if border == BorderMode.BORDER_WRAP:
            return jnp.mod(t, n)
        return jnp.clip(t, 0, n - 1)  # CONSTANT: clamp, then mask

    def tap(tx, ty):
        idx = (remap(ty, h_in) * w_in + remap(tx, w_in)).reshape(-1)
        vals = jnp.take(flat, idx, axis=-1)
        vals = vals.reshape(planes.shape[:-2] + (h_out, w_out))
        if border != BorderMode.BORDER_CONSTANT:
            # Remapped tap coordinates ARE the border handling.
            return vals
        ok = (tx >= 0) & (tx <= w_in - 1) & (ty >= 0) & (ty <= h_in - 1)
        return jnp.where(ok, vals, bv)

    if interp == InterMode.INTER_NEAREST:
        # OpenCV warpAffine INTER_NEAREST rounds the fixed-point source
        # coordinate half-up ((X0 + 512) >> 10 at AB_BITS=10).
        return tap(
            jnp.floor(fx + 0.5).astype(jnp.int32),
            jnp.floor(fy + 0.5).astype(jnp.int32),
        )

    if interp == InterMode.INTER_CUBIC:
        # 4×4 A=-0.75 taps, each border-handled individually (OpenCV
        # BORDER_CONSTANT/REPLICATE bicubic warp semantics).
        cx = _cubic_coefs(ax)
        cy = _cubic_coefs(ay)
        out = jnp.float32(0.0)
        for i in range(4):
            row = jnp.float32(0.0)
            for j in range(4):
                row = row + tap(sx - 1 + j, sy - 1 + i) * cx[j]
            out = out + row * cy[i]
        return out

    if u8:
        # cbuf[0] = SAT(round((1-f)*2048)); cbuf[1] = 2048 - cbuf[0]
        # (warp_affine_naive.cpp:31-41).
        wx0 = _quantize_q11(1.0 - ax)
        wx1 = 1.0 - wx0
        wy0 = _quantize_q11(1.0 - ay)
        wy1 = 1.0 - wy0
    else:
        wx0, wx1 = 1.0 - ax, ax
        wy0, wy1 = 1.0 - ay, ay

    p00 = tap(sx, sy)
    p01 = tap(sx + 1, sy)
    p10 = tap(sx, sy + 1)
    p11 = tap(sx + 1, sy + 1)

    out = (
        p00 * (wx0 * wy0)
        + p10 * (wx0 * wy1)
        + p01 * (wx1 * wy0)
        + p11 * (wx1 * wy1)
    )
    if edge_mode == "vacv":
        # Same predicate and f32 coordinate grid as the separable
        # route's post-mask.
        full_support = _vacv_support_mask(minv, h_out, w_out, h_in, w_in)
        out = jnp.where(full_support, out, bv)
    return out


def warp_affine(
    src,
    M,
    dsize: VSize | tuple,
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    edge_mode: str = "opencv",
) -> Image:
    """Affine warp (parity: ``va_cv::warp_affine``, cv.h:118-122).

    ``M`` is the *forward* 2×3 matrix (host-side numpy / list); pass
    ``flags | WARP_INVERSE_MAP`` if it is already the inverse.
    ``edge_mode="vacv"`` reproduces the reference's skip-edge-pixels
    semantics instead of OpenCV's per-tap border blending.
    """
    img = as_image(src)
    if isinstance(dsize, tuple):
        dsize = VSize(*dsize)
    flags = int(flags)
    inverse = bool(flags & InterMode.WARP_INVERSE_MAP)
    interp = InterMode(flags & ~int(InterMode.WARP_INVERSE_MAP))
    if interp not in (
        InterMode.INTER_LINEAR,
        InterMode.INTER_NEAREST,
        InterMode.INTER_CUBIC,
    ):
        raise NotImplementedError(
            "warp_affine supports INTER_LINEAR/INTER_NEAREST/INTER_CUBIC"
        )
    # BORDER_ISOLATED only matters for ROI submats (none here); strip it.
    border_mode = BorderMode(int(border_mode) & ~int(BorderMode.BORDER_ISOLATED))
    if border_mode == BorderMode.BORDER_TRANSPARENT:
        # cv::BORDER_TRANSPARENT leaves outlier dst pixels unwritten —
        # on a fresh dst that is the reference's own skip-and-leave-zero
        # semantics (warp_affine_naive.cpp:26-38), i.e. our "vacv" edge
        # mode with the border value.
        border_mode = BorderMode.BORDER_CONSTANT
        edge_mode = "vacv"
    bv = border_value.v0 if isinstance(border_value, VScalar) else float(border_value)

    minv = np.asarray(M, dtype=np.float32).reshape(2, 3)
    if not inverse:
        minv = invert_affine(minv)

    data = img.data
    is_u8 = data.dtype == jnp.uint8
    squeeze = data.ndim == 2
    if squeeze:
        planes = data[None]
    elif img.layout == Layout.HWC:
        planes = jnp.transpose(data, (2, 0, 1))
    else:
        planes = data

    # Axis-aligned matrices (m1 == m3 == 0 — pure scale/translate/
    # flip, the resize-with-offset case) run as two banded matmuls (see
    # _warp_separable): no gather, any dtype, vmap-safe.  Everything
    # else takes the gather route below.
    _INTERP = {InterMode.INTER_LINEAR: "linear",
               InterMode.INTER_NEAREST: "nearest",
               InterMode.INTER_CUBIC: "cubic"}
    if (
        float(minv[0, 1]) == 0.0
        and float(minv[1, 0]) == 0.0
        and (border_mode == BorderMode.BORDER_CONSTANT
             or border_mode in _REMAP_BORDERS)
    ):
        from .. import config as vconfig

        vconfig.record_kernel("warp_separable")
        out = _warp_separable(
            planes.astype(jnp.float32), minv, dsize.h, dsize.w,
            u8=is_u8, border_value=bv, edge_mode=edge_mode,
            border=border_mode, interp=_INTERP[interp],
        )
        return img.with_data(_finish(out, data.dtype, interp, squeeze,
                                     img.layout))

    out = _warp_planes(
        planes.astype(jnp.float32), minv, dsize.h, dsize.w, u8=is_u8,
        border_value=bv, edge_mode=edge_mode, border=border_mode,
        interp=interp,
    )
    return img.with_data(_finish(out, data.dtype, interp, squeeze,
                                 img.layout))


def _finish(out, dtype, interp, squeeze: bool, layout):
    """f32 warped planes -> the caller's dtype and layout."""
    if dtype == jnp.uint8:
        if interp == InterMode.INTER_LINEAR:
            # Q22 truncation parity (warp_affine_naive.cpp:50-54); the
            # epsilon absorbs f32 rounding of exactly-integral sums.
            out = jnp.clip(jnp.floor(out + 1e-4), 0, 255).astype(jnp.uint8)
        else:
            # Nearest/cubic have no vacv-native u8 path; match OpenCV's
            # saturate_cast round-to-nearest instead.
            out = jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)
    elif dtype != jnp.float32:
        out = out.astype(dtype)  # f16/bf16 passthrough
    if squeeze:
        return out[0]
    if layout == Layout.HWC:
        return jnp.transpose(out, (1, 2, 0))
    return out


def warp_affine_rot(
    src,
    scale: float,
    rot: float,
    dsize: VSize | tuple,
    aux_param: VScalar = VScalar(),
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
) -> Image:
    """Scale/rotation form with aux-param recentring (parity:
    ``va_cv::warp_affine`` overload, warp_affine.cpp:96-109: the
    translation column is overwritten so that source point
    ``(aux.v0, aux.v1)`` lands on destination ``(aux.v2, aux.v3)``)."""
    m = get_rotation_matrix_2d(VPoint(0, 0), rot, scale)
    m[0, 2] = aux_param.v2 - m[0, 0] * aux_param.v0 - m[0, 1] * aux_param.v1
    m[1, 2] = aux_param.v3 - m[1, 0] * aux_param.v0 - m[1, 1] * aux_param.v1
    return warp_affine(src, m, dsize, flags, border_mode, border_value)
