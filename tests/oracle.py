"""Numpy spec-oracles: bit-level reimplementations of the reference
algorithms (independent of both our JAX code and OpenCV), used where
OpenCV's semantics legitimately differ from the reference's (fixed-point
truncation, YUV coefficients, border skipping)."""
from __future__ import annotations

import numpy as np


def nv_to_bgr(y: np.ndarray, vu: np.ndarray, is_nv12: bool) -> np.ndarray:
    """Reference nv_to_bgr_naive (cvt_color.cpp:39-135) in numpy."""
    h, w = y.shape
    vu = vu.astype(np.int32)
    if is_nv12:
        u_s, v_s = vu[:, 0::2], vu[:, 1::2]
    else:
        v_s, u_s = vu[:, 0::2], vu[:, 1::2]
    v = np.repeat(np.repeat(v_s, 2, axis=0), 2, axis=1)[:h, :w] - 128
    u = np.repeat(np.repeat(u_s, 2, axis=0), 2, axis=1)[:h, :w] - 128
    yy = y.astype(np.int32)
    ra = (179 * v) >> 7
    ga = (44 * u + 91 * v) >> 7
    ba = (227 * u) >> 7
    b = np.clip(yy + ba, 0, 255)
    g = np.clip(yy - ga, 0, 255)
    r = np.clip(yy + ra, 0, 255)
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def warp_affine_u8(src: np.ndarray, m_inv: np.ndarray, w_out: int, h_out: int
                   ) -> np.ndarray:
    """Reference warp_affine_naive_hwc_u8 (warp_affine_naive.cpp:9-58)
    in numpy, including Q11 quantization and Q22 truncation.  ``src``
    is HWC u8; out-of-bounds pixels are 0 (the reference leaves them
    unwritten in calloc-fresh memory)."""
    h_in, w_in, c = src.shape
    m = m_inv.astype(np.float32).ravel()
    out = np.zeros((h_out, w_out, c), dtype=np.uint8)
    s = src.astype(np.int64)
    for dy in range(h_out):
        for dx in range(w_out):
            fx = np.float32(m[0] * dx + m[1] * dy + m[2])
            fy = np.float32(m[3] * dx + m[4] * dy + m[5])
            sy = int(np.floor(fy))
            fy -= sy
            if sy < 0 or sy >= h_in - 1:
                continue
            cy0 = int(np.floor((1.0 - fy) * 2048 + 0.5))
            cy1 = 2048 - cy0
            sx = int(np.floor(fx))
            fx -= sx
            if sx < 0 or sx >= w_in - 1:
                continue
            cx0 = int(np.floor((1.0 - fx) * 2048 + 0.5))
            cx1 = 2048 - cx0
            acc = (
                s[sy, sx] * cx0 * cy0
                + s[sy + 1, sx] * cx0 * cy1
                + s[sy, sx + 1] * cx1 * cy0
                + s[sy + 1, sx + 1] * cx1 * cy1
            )
            out[dy, dx] = (acc >> 22).astype(np.uint8)
    return out


def resize_bilinear_u8(src: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """Reference resize_naive_inter_linear_u8 (resize_naive.cpp:10-68)
    in numpy (vectorized), Q11 weights + Q22 truncation."""
    h_in, w_in = src.shape[:2]
    scale_x = np.float32(w_in) / np.float32(w_out)
    scale_y = np.float32(h_in) / np.float32(h_out)

    def coords(n_out, n_in, scale):
        f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s
        f[s < 0] = 0.0
        s[s < 0] = 0
        f[s >= n_in - 1] = 1.0
        s[s >= n_in - 1] = n_in - 2
        c0 = np.floor((1.0 - f) * 2048 + 0.5).astype(np.int64)
        c1 = np.floor(f * 2048 + 0.5).astype(np.int64)
        return s, c0, c1

    sy, cy0, cy1 = coords(h_out, h_in, scale_y)
    sx, cx0, cx1 = coords(w_out, w_in, scale_x)
    s = src.astype(np.int64)
    if s.ndim == 2:
        s = s[..., None]
    top = s[sy][:, sx] * (cx0[None, :, None] * cy0[:, None, None]) \
        + s[sy][:, sx + 1] * (cx1[None, :, None] * cy0[:, None, None])
    bot = s[sy + 1][:, sx] * (cx0[None, :, None] * cy1[:, None, None]) \
        + s[sy + 1][:, sx + 1] * (cx1[None, :, None] * cy1[:, None, None])
    out = ((top + bot) >> 22).astype(np.uint8)
    return out if src.ndim == 3 else out[..., 0]


def warp_affine_u8_rows(src: np.ndarray, m_inv: np.ndarray, w_out: int,
                        h_out: int, rows=None) -> np.ndarray:
    """``warp_affine_u8`` vectorised over the output rows ``rows``
    (default: all ``h_out``), with the same f32 coordinate arithmetic,
    Q11 weights, Q22 truncation and skip-edge zeros.  Returns
    (len(rows), w_out, C) u8."""
    h_in, w_in, c = src.shape
    m = m_inv.astype(np.float32).ravel()
    ys = np.arange(h_out) if rows is None else np.asarray(rows)
    dy = ys.astype(np.float32)[:, None]
    dx = np.arange(w_out, dtype=np.float32)[None, :]
    fx = m[0] * dx + m[1] * dy + m[2]
    fy = m[3] * dx + m[4] * dy + m[5]
    sx = np.floor(fx).astype(np.int64)
    sy = np.floor(fy).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    fy = fy - sy.astype(np.float32)
    ok = (sx >= 0) & (sx < w_in - 1) & (sy >= 0) & (sy < h_in - 1)
    sx = np.where(ok, sx, 0)
    sy = np.where(ok, sy, 0)
    cx0 = np.floor((1.0 - fx) * 2048 + 0.5).astype(np.int64)[..., None]
    cy0 = np.floor((1.0 - fy) * 2048 + 0.5).astype(np.int64)[..., None]
    cx1, cy1 = 2048 - cx0, 2048 - cy0
    s = src.astype(np.int64)
    acc = (s[sy, sx] * cx0 * cy0 + s[sy + 1, sx] * cx0 * cy1
           + s[sy, sx + 1] * cx1 * cy0 + s[sy + 1, sx + 1] * cx1 * cy1)
    return np.where(ok[..., None], acc >> 22, 0).astype(np.uint8)


def normalize_chw(x: np.ndarray) -> np.ndarray:
    """Per-channel ``(x - mean) / (std + 1e-6)`` of a (..., C, H, W)
    array with float64 statistics (population variance), as float32."""
    f = x.astype(np.float64)
    mean = f.mean(axis=(-2, -1), keepdims=True)
    std = f.std(axis=(-2, -1), keepdims=True)
    return ((f - mean) / (std + 1e-6)).astype(np.float32)
