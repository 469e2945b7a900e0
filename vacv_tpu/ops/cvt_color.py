"""cvt_color — NV12/NV21 YUV → BGR/RGB(A), gray → BGR (vacv op #1).

The reference's NEON path is ~300 lines of ``vld2_u8`` deinterleave +
Q7 integer math + a 3-stage ``vtrn`` transpose network to restore pixel
order before ``vst3_u8`` (``/root/reference/src/cv/cvt_color.cpp:184-494``).
Here the same computation is a handful of elementwise integer ops on
whole planes: the 2×2 chroma upsample is a broadcast-reshape, and the
interleave/deinterleave problem disappears because we keep channels
planar.  The Q7 coefficient math matches ``nv_to_bgr_naive``
(``cvt_color.cpp:76-94``):

    ra = (179 (V-128)) >> 7
    ga = (44 (U-128) + 91 (V-128)) >> 7
    ba = (227 (U-128)) >> 7
    B = clamp(Y + ba), G = clamp(Y - ga), R = clamp(Y + ra)

with arithmetic shifts (floor division by 128) on signed int32 — the
semantics of C's ``>>`` on the reference's negative intermediates.

Dispatch notes: the reference only admits codes 91/93 natively and
routes everything else to OpenCV; its NV12 test path even processes
NV12 with NV21 chroma ordering (``cvt_color.cpp:139-149``, SURVEY §2.2).
We fix that quirk: all eight NV codes plus YV12 and GRAY2BGR are
handled natively with correct chroma order.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.image import Image, as_image
from ..core.types import ColorCode, Layout

# NV codes → (is_nv12, to_rgb, alpha)
_NV_CODES = {
    ColorCode.COLOR_YUV2RGB_NV12: (True, True, False),
    ColorCode.COLOR_YUV2BGR_NV12: (True, False, False),
    ColorCode.COLOR_YUV2RGB_NV21: (False, True, False),
    ColorCode.COLOR_YUV2BGR_NV21: (False, False, False),
    ColorCode.COLOR_YUV2RGBA_NV12: (True, True, True),
    ColorCode.COLOR_YUV2BGRA_NV12: (True, False, True),
    ColorCode.COLOR_YUV2RGBA_NV21: (False, True, True),
    ColorCode.COLOR_YUV2BGRA_NV21: (False, False, True),
}


def _upsample2(x):
    """2×2 nearest upsample of (h, w) -> (2h, 2w) via broadcast."""
    h, w = x.shape
    x = jnp.broadcast_to(x[:, None, :, None], (h, 2, w, 2))
    return x.reshape(2 * h, 2 * w)


def _yuv_to_bgr_core(y_i32, v_full, u_full):
    """Q7 integer YUV→BGR on full-resolution centred chroma planes.

    Arithmetic >> 7 == floor-division by 128 on negatives, matching
    C's signed shift in nv_to_bgr_naive (cvt_color.cpp:76-78).  Shared
    by the NV and YV12 paths.
    """
    ra = (179 * v_full) >> 7
    ga = (44 * u_full + 91 * v_full) >> 7
    ba = (227 * u_full) >> 7
    b = jnp.clip(y_i32 + ba, 0, 255).astype(jnp.uint8)
    g = jnp.clip(y_i32 - ga, 0, 255).astype(jnp.uint8)
    r = jnp.clip(y_i32 + ra, 0, 255).astype(jnp.uint8)
    return b, g, r


def nv_to_bgr_planes(y_plane, vu_plane, *, is_nv12: bool):
    """Planar NV→BGR core: returns (b, g, r) uint8 planes of Y's shape.

    ``y_plane``: (h, w) u8; ``vu_plane``: (h//2, w) u8 interleaved
    chroma pairs (NV21: V,U; NV12: U,V).  XLA fuses the whole decode
    into one elementwise kernel over the planes.

    Odd Y heights are supported: the upsampled chroma (always an even
    row count) is sliced to the Y height — the planar form of the
    reference's zerobuf/writebuf scratch-row trick for the final odd
    row pair (cvt_color.cpp:52-66).
    """
    y = y_plane.astype(jnp.int32)
    h = y.shape[0]
    vu = vu_plane.astype(jnp.int32)
    if is_nv12:
        u_s, v_s = vu[:, 0::2], vu[:, 1::2]
    else:
        v_s, u_s = vu[:, 0::2], vu[:, 1::2]
    return _yuv_to_bgr_core(
        y, _upsample2(v_s)[:h] - 128, _upsample2(u_s)[:h] - 128
    )


# OpenCV 5's fixed-point gray coefficients (shift = 15, verified
# bit-exact vs cv2 on-host): gray = (R*9798 + G*19235 + B*3735 + 2^14)
# >> 15 for u8 inputs; float inputs use the 0.299/0.587/0.114 weights
# (cv::cvtColor BGR2GRAY semantics — the reference serves this via its
# OpenCV fallback, cvt_color.cpp:166-169).
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735


def _to_gray(data, *, r_idx: int):
    """BGR(A)/RGB(A) HWC → (h, w) gray with cv2 BGR2GRAY numerics."""
    b_idx = 2 - r_idx
    r, g, b = data[..., r_idx], data[..., 1], data[..., b_idx]
    if data.dtype == jnp.uint8:
        acc = (
            r.astype(jnp.int32) * _GRAY_R
            + g.astype(jnp.int32) * _GRAY_G
            + b.astype(jnp.int32) * _GRAY_B
            + (1 << 14)
        ) >> 15
        return acc.astype(jnp.uint8)
    f = data.dtype
    return (
        r.astype(jnp.float32) * 0.299
        + g.astype(jnp.float32) * 0.587
        + b.astype(jnp.float32) * 0.114
    ).astype(f)


def _shuffle_code(img: Image, code: ColorCode) -> Image | None:
    """Native channel-shuffle / gray conversions (OpenCV codes 0-11).

    Returns None for codes outside this family.  All operate on HWC
    data; XLA fuses them into single elementwise/concat kernels.
    """
    C = ColorCode
    data = img.data
    if code in (C.COLOR_GRAY2BGR, C.COLOR_GRAY2BGRA):
        g = data if data.ndim == 2 else data[..., 0]
        chans = [g, g, g]
        if code == C.COLOR_GRAY2BGRA:
            chans.append(_full_alpha(g))
        return Image(jnp.stack(chans, axis=-1), Layout.HWC)
    if data.ndim != 3:
        raise ValueError(f"cvt_color code {code!r} needs an HWC image")
    if code == C.COLOR_BGR2BGRA:        # also RGB2RGBA
        return Image(
            jnp.concatenate([data[..., :3], _full_alpha(data[..., 0])[..., None]],
                            axis=-1),
            Layout.HWC,
        )
    if code == C.COLOR_BGRA2BGR:        # also RGBA2RGB
        return Image(data[..., :3], Layout.HWC)
    if code == C.COLOR_BGR2RGBA:        # also RGB2BGRA
        return Image(
            jnp.concatenate(
                [data[..., 2::-1], _full_alpha(data[..., 0])[..., None]], axis=-1
            ),
            Layout.HWC,
        )
    if code == C.COLOR_RGBA2BGR:        # also BGRA2RGB
        return Image(data[..., 2::-1], Layout.HWC)
    if code == C.COLOR_BGR2RGB:         # also RGB2BGR
        return Image(data[..., ::-1], Layout.HWC)
    if code == C.COLOR_BGRA2RGBA:       # also RGBA2BGRA
        return Image(
            jnp.concatenate([data[..., 2::-1], data[..., 3:4]], axis=-1),
            Layout.HWC,
        )
    if code in (C.COLOR_BGR2GRAY, C.COLOR_BGRA2GRAY):
        return Image(_to_gray(data, r_idx=2), Layout.HWC)
    if code in (C.COLOR_RGB2GRAY, C.COLOR_RGBA2GRAY):
        return Image(_to_gray(data, r_idx=0), Layout.HWC)
    return None


def _full_alpha(plane):
    if plane.dtype == jnp.uint8:
        return jnp.full_like(plane, 255)
    return jnp.ones_like(plane)


# ---- YCrCb / YUV / HSV families (u8, cv2-parity <=1 LSB) ------------
# The reference serves these via cvt_color_opencv (cvt_color.cpp:166-
# 169); here they are native.  Fixed-point constants are OpenCV's Q14
# (verified bit-exact on the forward directions; inverse and HSV are
# within 1 LSB of cv2 — the same class of difference cv2's own SIMD vs
# scalar paths exhibit).

def _q14(v):
    return (v + (1 << 13)) >> 14


def _rgb_split(data, r_idx: int):
    b_idx = 2 - r_idx
    to32 = lambda p: p.astype(jnp.int32)
    return to32(data[..., r_idx]), to32(data[..., 1]), to32(data[..., b_idx])


def _u8(x):
    return jnp.clip(x, 0, 255).astype(jnp.uint8)


def _to_ycrcb(data, *, r_idx: int):
    r, g, b = _rgb_split(data, r_idx)
    y = _q14(r * 4899 + g * 9617 + b * 1868)
    cr = _u8(_q14((r - y) * 11682) + 128)
    cb = _u8(_q14((b - y) * 9241) + 128)
    return jnp.stack([_u8(y), cr, cb], axis=-1)


def _from_ycrcb(data, *, r_idx: int):
    y = data[..., 0].astype(jnp.int32)
    cr = data[..., 1].astype(jnp.int32) - 128
    cb = data[..., 2].astype(jnp.int32) - 128
    r = _u8(y + _q14(cr * 22987))
    g = _u8(y + _q14(cr * -11698 + cb * -5662))
    b = _u8(y + _q14(cb * 29049))
    chans = [r, g, b] if r_idx == 0 else [b, g, r]
    return jnp.stack(chans, axis=-1)


def _to_yuv(data, *, r_idx: int):
    r, g, b = _rgb_split(data, r_idx)
    y = _q14(r * 4899 + g * 9617 + b * 1868)
    u = _u8(_q14((b - y) * 8061) + 128)    # 0.492 * 2^14
    v = _u8(_q14((r - y) * 14369) + 128)   # 0.877 * 2^14
    return jnp.stack([_u8(y), u, v], axis=-1)


def _from_yuv(data, *, r_idx: int):
    y = data[..., 0].astype(jnp.int32)
    u = data[..., 1].astype(jnp.int32) - 128
    v = data[..., 2].astype(jnp.int32) - 128
    r = _u8(y + _q14(v * 18678))                   # 1.140
    g = _u8(y + _q14(u * -6456 + v * -9519))       # -0.394, -0.581
    b = _u8(y + _q14(u * 33292))                   # 2.032
    chans = [r, g, b] if r_idx == 0 else [b, g, r]
    return jnp.stack(chans, axis=-1)


def _to_hsv(data, *, r_idx: int):
    r, g, b = (x.astype(jnp.float32) for x in _rgb_split(data, r_idx))
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = mx - mn
    v = mx
    s = jnp.where(mx == 0, 0.0, jnp.round(255.0 * diff / jnp.maximum(mx, 1)))
    dd = jnp.maximum(diff, 1e-6)
    h = jnp.where(
        diff == 0, 0.0,
        jnp.where(
            mx == r, 30.0 * (g - b) / dd,
            jnp.where(mx == g, 60.0 + 30.0 * (b - r) / dd,
                      120.0 + 30.0 * (r - g) / dd),
        ),
    )
    h = jnp.round(jnp.where(h < 0, h + 180.0, h)).astype(jnp.int32) % 180
    return jnp.stack(
        [h.astype(jnp.uint8), _u8(s.astype(jnp.int32)),
         _u8(v.astype(jnp.int32))], axis=-1,
    )


def _from_hsv(data, *, r_idx: int):
    """HSV (cv2's u8 convention, H in 0..180) → BGR/RGB.

    Closed-form sector evaluation ``f(n) = v − v·s·clamp(min(k, 4−k),
    0, 1)`` with ``k = (n + h/30) mod 6`` (n = 5, 3, 1 for R, G, B),
    computed on channel planes — replaces three six-way select chains
    over strided HWC lane extracts (measured 0.179 → 0.052 ms at
    1080p; ≤1 LSB of the select form and of cv2).
    """
    p = jnp.moveaxis(data, -1, 0).astype(jnp.float32)
    h, s, v = p[0], p[1] / 255.0, p[2]
    h6 = h / 30.0

    def chan(n):
        k = jnp.mod(n + h6, 6.0)
        return v - v * s * jnp.clip(jnp.minimum(k, 4.0 - k), 0.0, 1.0)

    to8 = lambda x: _u8(jnp.round(x).astype(jnp.int32))
    chans = [to8(chan(5.0)), to8(chan(3.0)), to8(chan(1.0))]  # R, G, B
    if r_idx == 2:
        chans = chans[::-1]
    return jnp.stack(chans, axis=-1)


_COLORSPACE_CODES = {
    ColorCode.COLOR_BGR2YCrCb: (_to_ycrcb, 2),
    ColorCode.COLOR_RGB2YCrCb: (_to_ycrcb, 0),
    ColorCode.COLOR_YCrCb2BGR: (_from_ycrcb, 2),
    ColorCode.COLOR_YCrCb2RGB: (_from_ycrcb, 0),
    ColorCode.COLOR_BGR2HSV: (_to_hsv, 2),
    ColorCode.COLOR_RGB2HSV: (_to_hsv, 0),
    ColorCode.COLOR_HSV2BGR: (_from_hsv, 2),
    ColorCode.COLOR_HSV2RGB: (_from_hsv, 0),
    ColorCode.COLOR_BGR2YUV: (_to_yuv, 2),
    ColorCode.COLOR_RGB2YUV: (_to_yuv, 0),
    ColorCode.COLOR_YUV2BGR: (_from_yuv, 2),
    ColorCode.COLOR_YUV2RGB: (_from_yuv, 0),
}


def cvt_color(src, code: ColorCode | int) -> Image:
    """Color conversion (parity: ``va_cv::cvt_color``, cv.h:95).

    For NV codes, ``src`` is the flat NV buffer as produced by camera
    pipelines: an ``Image``/array of shape ``(h * 3 // 2, w)`` u8 —
    i.e. the Y plane stacked above the interleaved VU/UV plane — or a
    1-D buffer of length ``w * h * 3 // 2`` is not accepted (shape
    carries w).  Output is HWC u8, height ``= input_h * 2 // 3``
    (parity: ``dst.create`` at cvt_color.cpp:151-156).
    """
    img = as_image(src)
    code = ColorCode(code)

    if int(code) < 12:  # channel-shuffle / gray family
        out = _shuffle_code(img, code)
        if out is not None:
            return out

    if code in _COLORSPACE_CODES:
        fn, r_idx = _COLORSPACE_CODES[code]
        if img.data.ndim != 3 or img.data.dtype != jnp.uint8:
            raise ValueError(f"{code!r} needs an HWC uint8 image")
        return Image(fn(img.data, r_idx=r_idx), Layout.HWC)

    if code == ColorCode.COLOR_YUV2BGR_YV12:
        # YV12: planar Y (h,w), then V (h/2, w/2), then U (h/2, w/2),
        # packed into the same (h*3/2, w) buffer.
        data = img.data
        full_h = data.shape[0] * 2 // 3
        w = data.shape[1]
        y = data[:full_h]
        chroma = data[full_h:].reshape(-1)
        half = (full_h // 2) * (w // 2)
        v_s = chroma[:half].reshape(full_h // 2, w // 2)
        u_s = chroma[half:].reshape(full_h // 2, w // 2)
        b, g, r = _yuv_to_bgr_core(
            y.astype(jnp.int32),
            _upsample2(v_s.astype(jnp.int32)) - 128,
            _upsample2(u_s.astype(jnp.int32)) - 128,
        )
        return Image(jnp.stack([b, g, r], axis=-1), Layout.HWC)

    if code not in _NV_CODES:
        raise NotImplementedError(
            f"cvt_color code {code!r} not supported; supported codes are "
            "the NV12/NV21 YUV->BGR/RGB(A) family, YV12/I420, "
            "GRAY<->BGR(A), BGR<->RGB(A) shuffles, and BGR<->YCrCb/YUV/"
            "HSV (see ColorCode).  For other conversions, decode to BGR "
            "with cv2/PIL on the host first."
        )

    chans = nv_decode_channels(img.data, code)
    return Image(jnp.stack(chans, axis=-1), Layout.HWC)


def nv_decode_channels(data, code: ColorCode) -> list:
    """Decode an NV stacked buffer into ordered u8 channel planes.

    Shared core of the HWC facade (``cvt_color``) and the planar
    pipeline fast path (``models/pipeline._decode_color``): one place
    owns the chroma ordering, channel order (BGR vs RGB) and alpha
    semantics.
    """
    is_nv12, to_rgb, alpha = _NV_CODES[ColorCode(code)]
    if data.ndim != 2:
        raise ValueError(
            f"NV input must be the (h*3//2, w) stacked buffer, got {data.shape}"
        )
    if data.shape[1] % 2:
        raise ValueError("NV buffers need an even width (interleaved VU pairs)")
    # Y-plane height: rows = h + ceil(h/2), so h = rows*2//3 for even
    # AND odd heights (odd h: rows = (3h+1)/2, (3h+1)*2//(2*3) = h).
    full_h = data.shape[0] * 2 // 3
    b, g, r = nv_to_bgr_planes(data[:full_h], data[full_h:], is_nv12=is_nv12)
    chans = [r, g, b] if to_rgb else [b, g, r]
    if alpha:
        chans.append(jnp.full_like(b, 255))
    return chans
