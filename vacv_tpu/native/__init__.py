"""ctypes bindings for the native host utilities (``native/vacv_host.cpp``).

The device compute path is JAX/XLA; this module binds the C++ host
layer — camera-format synthesis/decode, staging conversions, and the
cosine metric — built with OpenMP + auto-vectorization (the x86 role of
the reference's hand-written NEON util layer, ``src/util/``).

The library is built lazily with ``make`` on first use; every entry
point has a pure-numpy fallback, so the package works without a
toolchain (mirroring the reference's capability-fallback dispatchers).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvacv_host.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-s"], cwd=_NATIVE_DIR, check=True,
                    capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            lib.vacv_bgr2nv21.restype = ctypes.c_int
            lib.vacv_bgr2nv21.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.vacv_nv_to_bgr.restype = None
            lib.vacv_nv_to_bgr.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.vacv_u8_to_f32.restype = None
            lib.vacv_u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.vacv_f32_to_u8.restype = None
            lib.vacv_f32_to_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.vacv_cosine_f32.restype = ctypes.c_double
            lib.vacv_cosine_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.vacv_cosine_u8.restype = ctypes.c_double
            lib.vacv_cosine_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.vacv_has_jpeg.restype = ctypes.c_int
            lib.vacv_jpeg_dims.restype = ctypes.c_int
            lib.vacv_jpeg_dims.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.vacv_decode_jpeg.restype = ctypes.c_int
            lib.vacv_decode_jpeg.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def bgr2nv21(bgr: np.ndarray) -> np.ndarray:
    """BGR (h,w,3) u8 -> flat NV21 buffer; bit-exact with the reference."""
    lib = _load()
    h, w, _ = bgr.shape
    if lib is None:
        from ..utils.io import bgr2nv21_numpy

        return bgr2nv21_numpy(bgr)
    if h % 2 or w % 2:
        raise ValueError("bgr2nv21 requires even width and height")
    src = np.ascontiguousarray(bgr, dtype=np.uint8)
    out = np.empty(h * w + (h // 2) * w, dtype=np.uint8)
    rc = lib.vacv_bgr2nv21(
        src.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        w, h,
    )
    if rc != 0:
        raise ValueError("bgr2nv21 failed")
    return out


def nv_to_bgr(y: np.ndarray, vu: np.ndarray, is_nv12: bool = False) -> np.ndarray:
    """Host-side NV decode: Y (h,w) + VU (h//2,w) u8 -> BGR (h,w,3) u8."""
    h, w = y.shape
    lib = _load()
    if lib is None:
        # numpy fallback mirrors the jnp op
        vu32 = vu.astype(np.int32)
        if is_nv12:
            u_s, v_s = vu32[:, 0::2], vu32[:, 1::2]
        else:
            v_s, u_s = vu32[:, 0::2], vu32[:, 1::2]
        v = np.repeat(np.repeat(v_s, 2, 0), 2, 1)[:h, :w] - 128
        u = np.repeat(np.repeat(u_s, 2, 0), 2, 1)[:h, :w] - 128
        yy = y.astype(np.int32)
        ra = (179 * v) >> 7
        ga = (44 * u + 91 * v) >> 7
        ba = (227 * u) >> 7
        return np.stack(
            [np.clip(yy + ba, 0, 255), np.clip(yy - ga, 0, 255),
             np.clip(yy + ra, 0, 255)], axis=-1,
        ).astype(np.uint8)
    ys = np.ascontiguousarray(y, dtype=np.uint8)
    vus = np.ascontiguousarray(vu, dtype=np.uint8)
    out = np.empty((h, w, 3), dtype=np.uint8)
    lib.vacv_nv_to_bgr(
        ys.ctypes.data_as(ctypes.c_void_p), vus.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), w, h, int(is_nv12),
    )
    return out


def has_jpeg() -> bool:
    lib = _load()
    return lib is not None and bool(lib.vacv_has_jpeg())


def decode_jpeg(data: bytes, bgr: bool = True) -> np.ndarray:
    """Decode a JPEG byte buffer to HWC u8 (BGR by default, like
    cv::imread).  Raises on toolchain/libjpeg absence — callers fall
    back to cv2/PIL via ``utils.io.imread``."""
    lib = _load()
    if lib is None or not lib.vacv_has_jpeg():
        raise RuntimeError("native jpeg decode unavailable")
    buf = np.frombuffer(data, dtype=np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.vacv_jpeg_dims(
        buf.ctypes.data_as(ctypes.c_void_p), buf.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if rc != 0:
        raise ValueError("invalid JPEG data")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.vacv_decode_jpeg(
        buf.ctypes.data_as(ctypes.c_void_p), buf.size,
        out.ctypes.data_as(ctypes.c_void_p), int(bgr),
    )
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out


def imread_jpeg(path: str, bgr: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), bgr)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Native cosine similarity; falls back to the numpy implementation."""
    lib = _load()
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if lib is not None and a.dtype == np.uint8 and b.dtype == np.uint8:
        return float(
            lib.vacv_cosine_u8(
                a.ctypes.data_as(ctypes.c_void_p),
                b.ctypes.data_as(ctypes.c_void_p), a.size,
            )
        )
    if lib is not None and a.dtype == np.float32 and b.dtype == np.float32:
        return float(
            lib.vacv_cosine_f32(
                a.ctypes.data_as(ctypes.c_void_p),
                b.ctypes.data_as(ctypes.c_void_p), a.size,
            )
        )
    from ..utils.compare import cosine_similarity

    return cosine_similarity(a, b)
