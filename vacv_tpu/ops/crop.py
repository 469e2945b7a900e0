"""crop — rectangular ROI extraction (vacv op #2).

The reference implements crop three ways — scalar row copies, NEON
16-byte block copies with scalar tails, and an evolution ladder of CUDA
kernels culminating in a zero-copy grid-stride version
(``/root/reference/src/cv/crop.cpp:44-398``,
``crop_cuda_basic_dynamic_threads_zero_copy.cu:18-54``).  Here a crop
with a *static* rectangle is a static slice, which XLA folds into the
consumer's reads or emits as one strided copy — the NEON/CUDA kernel
ladder collapses into an indexing expression.  For rectangles
only known at run time (traced values), ``crop_dynamic`` lowers to
``lax.dynamic_slice`` (sizes must still be static under jit).

Rect semantics match the reference dispatcher: float fields are
truncated to int, size = ``(int)right - (int)... `` via
``VRect.int_bounds`` (reference ``crop.cpp:127-131``).
"""
from __future__ import annotations

import jax.lax as lax

from ..core.image import Image, as_image
from ..core.types import Layout, VRect


def crop(src, rect: VRect) -> Image:
    """Crop ``rect`` out of ``src`` (static rectangle).

    Accepts an ``Image`` or raw array (assumed HWC).
    """
    img = as_image(src)
    left, top, w, h = rect.int_bounds()
    if w <= 0 or h <= 0:
        raise ValueError(f"empty crop rect {rect}")
    if img.data.ndim == 2:
        out = img.data[top : top + h, left : left + w]
    elif img.layout == Layout.HWC:
        out = img.data[top : top + h, left : left + w, :]
    else:
        out = img.data[:, top : top + h, left : left + w]
    return img.with_data(out)


def crop_dynamic(src, left, top, w: int, h: int) -> Image:
    """Crop with traced ``left``/``top`` (sizes static, as jit requires)."""
    img = as_image(src)
    if img.data.ndim == 2:
        out = lax.dynamic_slice(img.data, (top, left), (h, w))
    elif img.layout == Layout.HWC:
        c = img.data.shape[2]
        out = lax.dynamic_slice(img.data, (top, left, 0), (h, w, c))
    else:
        c = img.data.shape[0]
        out = lax.dynamic_slice(img.data, (0, top, left), (c, h, w))
    return img.with_data(out)
