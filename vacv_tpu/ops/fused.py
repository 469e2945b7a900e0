"""Fused pipelines — resize→normalize and warp_affine→normalize.

In the reference these exist only as OpenCV call chains
(``/root/reference/src/cv/resize_normalize.cpp:15-107``,
``warp_affine_normalize.cpp:13-189``) — the naive/NEON variants are
empty todos.  Here they are first-class: composing our ops under one
``jit`` lets XLA fuse the dtype conversion and the normalize affine
into the resize matmuls / warp gather.

Semantic parity with the OpenCV chains: geometric op on the *input
dtype* (u8 stays u8 through resize, as cv::resize does), then convert
to f32, then mean/stddev (computed from the resized image if not
given), then ``(x-μ)/(σ+1e-6)``.
"""
from __future__ import annotations

from ..core.image import Image, as_image
from ..core.types import BorderMode, InterMode, VScalar, VSize
from .dtype import change_dtype
from .normalize import normalize
from .resize import resize
from .warp_affine import warp_affine, warp_affine_rot
import jax.numpy as jnp


def resize_normalize(
    src,
    dsize: VSize | tuple | None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterMode | int = InterMode.INTER_LINEAR,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::resize_normalize`` (cv.h:154-158)."""
    out = resize(as_image(src), dsize, fx, fy, interpolation)
    out = change_dtype(out, jnp.float32)
    return normalize(out, mean, stddev)


def _warp_normalize_tail(img, warp_fn, mean, stddev) -> Image:
    """Shared body of the two warp_affine_normalize forms.

    Planar hoist: the warp and normalize are plane-native, so an HWC
    input converts to CHW once BEFORE the warp — the warp op's internal
    planes→HWC transpose, the normalize op's HWC→planes transpose, and
    their inverses all disappear (the reference runs three full OpenCV
    passes, warp_affine_normalize.cpp:13-189).  The hoist changes no
    numerics.  The result keeps the caller's layout.
    """
    from ..core.types import Layout

    hwc = img.data.ndim == 3 and img.layout == Layout.HWC
    if hwc:
        img = img.change_layout(Layout.CHW)
    out = warp_fn(img)
    out = change_dtype(out, jnp.float32)
    out = normalize(out, mean, stddev)
    if hwc:
        out = out.change_layout(Layout.HWC)
    return out


def warp_affine_normalize(
    src,
    M,
    dsize: VSize | tuple,
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::warp_affine_normalize`` matrix form
    (cv.h:172-178)."""
    return _warp_normalize_tail(
        as_image(src),
        lambda im: warp_affine(im, M, dsize, flags, border_mode,
                               border_value),
        mean, stddev,
    )


def warp_affine_normalize_rot(
    src,
    scale: float,
    rot: float,
    dsize: VSize | tuple,
    aux_param: VScalar = VScalar(),
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::warp_affine_normalize`` scale/rot form
    (cv.h:194-201)."""
    return _warp_normalize_tail(
        as_image(src),
        lambda im: warp_affine_rot(im, scale, rot, dsize, aux_param,
                                   flags, border_mode, border_value),
        mean, stddev,
    )
