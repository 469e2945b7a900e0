"""layout_change — HWC↔CHW (vacv op #3).

The reference hand-vectorizes 3-channel de/interleave with NEON
``vld3q_u8``/``vst1q_u8`` 16-pixel blocks plus scalar fallbacks
(``/root/reference/src/common/tensor.cpp:160-295,393-457``).  Here a
layout change is a plain transpose: XLA emits an optimal tiled
relayout copy (and, when the transpose feeds another op under the same
``jit``, usually folds it into the consumer's layout assignment so no
copy materializes at all).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.image import Image, as_image
from ..core.types import Layout


def _change_layout_array(data, src_layout: Layout, dst_layout: Layout):
    if src_layout == dst_layout or data.ndim == 2:
        # Parity: same-layout / single-channel input returns a clone
        # (reference tensor.cpp:393-401).
        return data
    if src_layout == Layout.HWC:  # HWC -> CHW
        return jnp.transpose(data, (2, 0, 1))
    return jnp.transpose(data, (1, 2, 0))  # CHW -> HWC


def change_layout(src, dst_layout: Layout) -> Image:
    """Return ``src`` converted to ``dst_layout``.

    Accepts an ``Image`` or a raw array (assumed HWC).
    """
    img = as_image(src)
    out = _change_layout_array(img.data, img.layout, dst_layout)
    return Image(out, dst_layout)
