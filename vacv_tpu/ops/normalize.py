"""mean_stddev + normalize (vacv ops #2 / #6 / #7).

The reference computes per-channel mean and stddev in two passes over
the pixels — NEON ``vld3q_f32`` deinterleave with ``vaddvq`` horizontal
adds, accumulating ``(x-μ)²/N`` elementwise — then applies
``(x - μ) / (σ + 1e-6)``
(``/root/reference/src/cv/normalize_naive.cpp:7-90``,
``normalize_neon.cpp:13-283``).  Here those three linear passes are
two plane reductions and one elementwise op, which XLA fuses into
neighbouring ops (SURVEY §7.6).

Semantics parity:
* input is auto-converted to f32 first (normalize.cpp:84-95);
* σ uses the *population* (biased) variance, σ = sqrt(E[(x-μ)²]);
* the epsilon lives in the denominator: ``(x-μ)/(σ+1e-6)``.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.image import Image, as_image
from ..core.types import Layout

EPS = 1e-6


def _to_planes(img: Image):
    """(c, h*w) float32 view of the image + restore info."""
    data = img.data.astype(jnp.float32)
    if data.ndim == 2:
        return data[None], True
    if img.layout == Layout.HWC:
        return jnp.transpose(data, (2, 0, 1)), False
    return data, False


def mean_stddev(src):
    """Per-channel (mean, stddev) as float32 vectors of length C.

    Parity: the implicit mean/stddev computation inside
    ``Normalize::normalize`` when the caller passes empty tensors
    (normalize.cpp:96-112).
    """
    img = as_image(src)
    planes, _ = _to_planes(img)
    c = planes.shape[0]
    flat = planes.reshape(c, -1)
    mean = jnp.mean(flat, axis=1)
    var = jnp.mean(jnp.square(flat - mean[:, None]), axis=1)
    return mean, jnp.sqrt(var)


def normalize(src, mean=None, stddev=None) -> Image:
    """``(x - mean) / (stddev + 1e-6)`` per channel, f32 output.

    Parity: ``va_cv::normalize`` (cv.h:104-106).  When ``mean`` /
    ``stddev`` are None they are computed from the image itself
    (the reference's empty-tensor convention).
    """
    img = as_image(src)
    planes, squeeze = _to_planes(img)
    c = planes.shape[0]
    if mean is None or stddev is None:
        # Compute only what the caller didn't supply (the reference's
        # empty-tensor convention covers both-or-neither; honoring a
        # partially-supplied pair is strictly more useful than silently
        # discarding it).
        m_auto, s_auto = mean_stddev(img)
        m = m_auto if mean is None else None
        s = s_auto if stddev is None else None
    else:
        m = s = None
    if m is None:
        m = jnp.asarray(mean, dtype=jnp.float32).reshape(-1)[:c]
    if s is None:
        s = jnp.asarray(stddev, dtype=jnp.float32).reshape(-1)[:c]
    out = (planes - m[:, None, None]) / (s[:, None, None] + EPS)
    if squeeze:
        out = out[0]
    elif img.layout == Layout.HWC:
        out = jnp.transpose(out, (1, 2, 0))
    return img.with_data(out)
