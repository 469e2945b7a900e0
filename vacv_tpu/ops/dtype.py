"""dtype_change — u8↔fp32 (vacv op #4).

Reference semantics (``/root/reference/src/common/tensor.cpp:297-502``):

* u8 → f32: plain widening (NEON u8→u16→u32→f32 ladder,
  ``tensor.cpp:297-347``) — exact, no rounding involved.
* f32 → u8: **truncation toward zero** (NEON ``vcvtq_u32_f32`` then
  saturating narrows, ``tensor.cpp:349-390``) — i.e. clamp to [0,255]
  with fractional part dropped, *not* OpenCV's round-half-to-even
  ``convertTo``.  We reproduce the truncate+saturate behaviour of the
  NEON path (the reference's scalar path, a bare ``static_cast<char>``
  at ``tensor.cpp:488-492``, wraps instead of saturating; the NEON
  behaviour is the well-defined one and is what the reference actually
  ships on its primary ARM targets).

This is a pure element-wise op; XLA fuses it into whatever
producer/consumer surrounds it.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.image import Image, as_image


def _to_f32(data):
    return data.astype(jnp.float32)


def _to_u8(data):
    # Truncate toward zero, then saturate to [0, 255] — matches the
    # reference NEON path (vcvtq_u32_f32 + vqmovn saturating narrows).
    as_int = data.astype(jnp.int32)  # XLA f32->s32 convert truncates
    return jnp.clip(as_int, 0, 255).astype(jnp.uint8)


_FLOATS = (jnp.float32, jnp.float16, jnp.bfloat16, jnp.float64)


def change_dtype(src, dtype) -> Image:
    """Convert ``src`` to ``dtype``.

    Supported: uint8 ↔ {float32, float16, bfloat16, float64} and
    conversions among the float types.  The reference implements only
    u8↔fp32 (tensor.cpp:459-502) but declares FP16 and FP64 on its
    Tensor (tensor.h:12-18, TensorConverter maps CV_64FC*,
    tensor_converter.cpp:15-44) and carries an fp16 resize in its
    graveyard (src_deprecated/paddle-resize/cubic_resize_float16.cpp)
    — half precision (bf16/f16) is first-class here, and f64 is admitted for container parity
    (JAX demotes to f32 storage unless ``jax_enable_x64`` is set; no
    reference kernel ever computes in f64).  float→u8 always
    truncates toward zero and saturates.

    Accepts an ``Image`` or raw array (assumed HWC).
    """
    img = as_image(src)
    dtype = jnp.dtype(dtype)
    if img.data.dtype == dtype:
        return img
    if dtype in (jnp.dtype(t) for t in _FLOATS):
        out = img.data.astype(dtype)
    elif dtype == jnp.uint8:
        out = _to_u8(img.data.astype(jnp.float32))
    else:
        raise NotImplementedError(
            "change_dtype supports uint8 <-> {float32,float16,bfloat16,"
            "float64} and float-to-float conversions; got "
            f"{dtype}.  For integer targets other than uint8, convert "
            "to float32 first and cast with jnp.astype."
        )
    return img.with_data(out)
