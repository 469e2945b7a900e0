"""vacv_tpu — an image-preprocessing engine in JAX.

From-scratch rebuild of the capabilities of the ``vacv`` library
(reference: ``b1xian/arm-neon-opencv``): the vision-model front-end ops
yuv2bgr, crop, layout_change, dtype_change, resize (bilinear/bicubic/
nearest/area), mean_stddev, normalize, warp_affine, fused
resize_normalize / warp_affine_normalize, match_template, minMaxIdx and
imencode — implemented as XLA programs instead of ARM NEON
intrinsics, with batch-of-frames scale-out over device meshes.

The flat namespace mirrors the reference's ``va_cv::`` facade
(``/root/reference/src/cv/cv.h:85-239``).
"""
from __future__ import annotations

from . import config
from .core.image import Image, as_image, as_array
from .core.types import (
    BorderMode,
    ColorCode,
    ExtreSize,
    IndexValue,
    InterMode,
    Layout,
    MatchMode,
    NormalAlg,
    SimpleSize,
    VAngle,
    VEyeInfo,
    VMatrix,
    VPoint,
    VPoint3,
    VRect,
    VScalar,
    VSize,
)
from .ops.crop import crop, crop_dynamic
from .ops.cvt_color import cvt_color
from .ops.dtype import change_dtype
from .ops.fused import (
    resize_normalize,
    warp_affine_normalize,
    warp_affine_normalize_rot,
)
from .ops.imencode import imencode
from .ops.layout import change_layout
from .ops.match_template import match_template, min_max_idx, min_max_loc
from .ops.normalize import mean_stddev, normalize
from .ops.resize import resize
from .ops.warp_affine import (
    get_rotation_matrix_2d,
    invert_affine,
    warp_affine,
    warp_affine_rot,
)

# Enum values at module scope for va_cv-style call sites
INTER_NEAREST = InterMode.INTER_NEAREST
INTER_LINEAR = InterMode.INTER_LINEAR
INTER_CUBIC = InterMode.INTER_CUBIC
INTER_AREA = InterMode.INTER_AREA
INTER_LANCZOS4 = InterMode.INTER_LANCZOS4
INTER_MAX = InterMode.INTER_MAX
WARP_INVERSE_MAP = InterMode.WARP_INVERSE_MAP
BORDER_CONSTANT = BorderMode.BORDER_CONSTANT
BORDER_REPLICATE = BorderMode.BORDER_REPLICATE
BORDER_REFLECT = BorderMode.BORDER_REFLECT
BORDER_WRAP = BorderMode.BORDER_WRAP
BORDER_REFLECT_101 = BorderMode.BORDER_REFLECT_101
BORDER_REFLECT101 = BorderMode.BORDER_REFLECT_101  # cv.h:45 alias
BORDER_DEFAULT = BorderMode.BORDER_DEFAULT
BORDER_TRANSPARENT = BorderMode.BORDER_TRANSPARENT
BORDER_ISOLATED = BorderMode.BORDER_ISOLATED
TM_SQDIFF = MatchMode.TM_SQDIFF
TM_SQDIFF_NORMED = MatchMode.TM_SQDIFF_NORMED
TM_CCORR = MatchMode.TM_CCORR
TM_CCORR_NORMED = MatchMode.TM_CCORR_NORMED
TM_CCOEFF = MatchMode.TM_CCOEFF
TM_CCOEFF_NORMED = MatchMode.TM_CCOEFF_NORMED
COLOR_YUV2BGR_NV21 = ColorCode.COLOR_YUV2BGR_NV21
COLOR_YUV2BGR_NV12 = ColorCode.COLOR_YUV2BGR_NV12
COLOR_YUV2RGB_NV21 = ColorCode.COLOR_YUV2RGB_NV21
COLOR_YUV2RGB_NV12 = ColorCode.COLOR_YUV2RGB_NV12
COLOR_GRAY2BGR = ColorCode.COLOR_GRAY2BGR
COLOR_GRAY2RGB = ColorCode.COLOR_GRAY2RGB
COLOR_YUV2BGR_YV12 = ColorCode.COLOR_YUV2BGR_YV12
COLOR_BGR2RGB = ColorCode.COLOR_BGR2RGB
COLOR_RGB2BGR = ColorCode.COLOR_RGB2BGR
COLOR_BGR2GRAY = ColorCode.COLOR_BGR2GRAY
COLOR_RGB2GRAY = ColorCode.COLOR_RGB2GRAY
COLOR_BGR2BGRA = ColorCode.COLOR_BGR2BGRA
COLOR_BGRA2BGR = ColorCode.COLOR_BGRA2BGR
COLOR_GRAY2BGRA = ColorCode.COLOR_GRAY2BGRA

HWC = Layout.HWC
CHW = Layout.CHW

__version__ = "0.4.0"

__all__ = [
    "Image", "as_image", "as_array", "config",
    "Layout", "InterMode", "BorderMode", "MatchMode", "ColorCode",
    "NormalAlg", "VSize", "VScalar", "VPoint", "VPoint3", "VRect",
    "VAngle", "VEyeInfo", "VMatrix", "SimpleSize", "ExtreSize", "IndexValue",
    "crop", "crop_dynamic", "cvt_color", "change_dtype", "change_layout",
    "resize", "mean_stddev", "normalize", "warp_affine", "warp_affine_rot",
    "get_rotation_matrix_2d", "invert_affine",
    "resize_normalize", "warp_affine_normalize", "warp_affine_normalize_rot",
    "match_template", "min_max_idx", "min_max_loc", "imencode",
]
