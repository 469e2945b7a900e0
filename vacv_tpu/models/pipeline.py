"""Preprocess pipelines — the framework's "model" layer.

The reference's end-to-end use case is a vision-model front-end: take a
camera frame (NV21 or BGR), crop the ROI, resize to the network input,
go planar fp32, normalize (BASELINE.json configs 1–5).  ``Preprocessor``
captures that as a declarative config compiled once into a single XLA
program; ``batched()`` lifts it over a sharded frame batch for
multi-chip serving.

The per-stage structure mirrors the reference call chains
(e.g. test_crop.cpp:44-89's crop→layout→dtype chain and
resize_normalize.cpp:15-107's fused pipeline); under ``jit`` XLA fuses
the stages into as few device kernels as it can.

``preprocess_fused_batch`` / ``preprocess_fused_nv_batch`` run the same
chain with a *runtime* crop top, so a moving camera ROI re-uses one
compiled program for every position.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.image import Image
from ..core.types import ColorCode, InterMode, Layout, VRect
from ..ops.crop import crop, crop_dynamic
from ..ops.cvt_color import cvt_color
from ..ops.normalize import normalize
from ..ops.resize import resize
from ..parallel.mesh import DATA_AXIS, make_mesh


def _decode_color(img: Image, code) -> Image:
    """Pipeline-internal color decode that stays planar.

    ``cvt_color`` mirrors the reference facade and emits HWC
    (cvt_color.cpp:151-156); inside a pipeline that ends planar the
    HWC interleave and the later CHW transpose would both be wasted
    lane shuffles, so NV codes decode straight to a CHW Image (the
    channel stack is a major-axis concat, which is cheap).  Every
    downstream op is layout-aware.
    """
    from ..ops.cvt_color import _NV_CODES, nv_decode_channels

    code = ColorCode(code)
    if code not in _NV_CODES:
        return cvt_color(img, code)
    return Image(jnp.stack(nv_decode_channels(img.data, code), axis=0), Layout.CHW)


@dataclass(frozen=True)
class PreprocessConfig:
    """Declarative preprocessing recipe (all fields static)."""

    # Optional color conversion applied first (input is then the NV
    # stacked buffer); None means input is already BGR/gray.
    color_code: ColorCode | None = None
    # Optional crop ROI in source coordinates.
    crop_rect: VRect | None = None
    # Optional affine warp: (2x3 forward matrix as a nested tuple,
    # (w, h) output size).  Applied after crop, before resize — the
    # BASELINE config-5 "warp_affine + full pipeline" stage.
    warp: tuple[tuple, tuple[int, int]] | None = None
    # Output spatial size (w, h); None keeps input size.
    out_size: tuple[int, int] | None = None
    interpolation: InterMode = InterMode.INTER_LINEAR
    # Output layout & normalization.
    out_layout: Layout = Layout.CHW
    normalize: bool = True
    mean: tuple[float, ...] | None = None
    stddev: tuple[float, ...] | None = None


class Preprocessor:
    """Compiled single-image preprocess pipeline.

    ``__call__`` takes an HWC u8 array (or NV stacked buffer when
    ``color_code`` is set) and returns the network-ready array.
    """

    def __init__(self, cfg: PreprocessConfig):
        self.cfg = cfg
        self._fn = jax.jit(self._build())

    def _build(self):
        cfg = self.cfg

        def run(arr):
            img = Image(arr, Layout.HWC)
            if cfg.color_code is not None:
                img = _decode_color(img, cfg.color_code)
            if cfg.crop_rect is not None:
                img = crop(img, cfg.crop_rect)
            if cfg.warp is not None:
                from ..ops.warp_affine import warp_affine

                # Planar hoist: the warp and the resize matmuls are
                # plane-native; converting to CHW once BEFORE the warp
                # removes three HWC round-trips at the intermediate
                # sizes (the warp op would otherwise transpose
                # planes→HWC, resize HWC→planes→HWC, and change_layout
                # HWC→CHW again).  Outputs are bit-identical — only
                # the layout bookkeeping moves.
                img = img.change_layout(Layout.CHW)
                m, dsize = cfg.warp
                img = warp_affine(img, [list(r) for r in m], tuple(dsize))
            if cfg.out_size is not None:
                w, h = cfg.out_size
                img = resize(img, (w, h), interpolation=cfg.interpolation)
            img = img.change_layout(cfg.out_layout)
            img = img.change_dtype(jnp.float32)
            if cfg.normalize:
                img = normalize(img, cfg.mean, cfg.stddev)
            return img.data

        return run

    def __call__(self, arr):
        return self._fn(arr)

    def batch(self, arr):
        """Single-device batch call over (N, H, W, C) frames."""
        return self._jit_batch(arr)

    @functools.cached_property
    def _jit_batch(self):
        return jax.jit(self.batch_fn)

    @property
    def fn(self):
        """The raw traceable per-image function (for vmap/shard_map)."""
        return self._build()

    @functools.cached_property
    def batch_fn(self):
        """The raw traceable (N, ...) batch function: the per-image
        chain vmapped over frames.  Cached: a fresh closure per access
        would retrace under jit."""
        return jax.vmap(self._build())

    def batched(self, mesh=None):
        """Sharded batch version: (N, ...) with N split over the mesh's
        data axis; each device runs the vmapped chain on its shard."""
        if mesh is None:
            mesh = make_mesh()
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        smapped = shard_map(
            self.batch_fn,
            mesh=mesh,
            in_specs=P(DATA_AXIS),
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )
        return jax.jit(smapped)


def slam_frontend_config() -> PreprocessConfig:
    """The BASELINE.json config-4 flagship: normalize pipeline
    (resize → chw → fp32 → normalize) for a SLAM/SfM keyframe
    front-end.  Add a ``crop_rect`` via ``dataclasses.replace`` when
    the camera ROI is known."""
    return PreprocessConfig(
        out_size=(224, 224),
        interpolation=InterMode.INTER_LINEAR,
        out_layout=Layout.CHW,
        normalize=True,
    )


# NV code for each (is_nv12, to_rgb) pair of the runtime-top NV call.
_NV_CODE = {
    (False, False): ColorCode.COLOR_YUV2BGR_NV21,
    (True, False): ColorCode.COLOR_YUV2BGR_NV12,
    (False, True): ColorCode.COLOR_YUV2RGB_NV21,
    (True, True): ColorCode.COLOR_YUV2RGB_NV12,
}


@functools.partial(
    jax.jit, static_argnames=("code", "left", "cw", "ch", "out_size", "norm")
)
def _runtime_top_chain(batch, top, mean, stddev, *, code, left, cw, ch,
                       out_size, norm):
    """decode → crop at a traced ``top`` → resize → CHW f32 → normalize,
    vmapped over the frame batch: one compiled program per geometry,
    whatever the top."""

    def one(frame):
        img = Image(frame, Layout.HWC)
        if code is not None:
            img = _decode_color(img, code)
        img = crop_dynamic(img, left, top, cw, ch)
        img = resize(img, out_size)
        img = img.change_layout(Layout.CHW).change_dtype(jnp.float32)
        if norm:
            img = normalize(img, mean, stddev)
        return img.data

    return jax.vmap(one)(batch)


def _runtime_top_call(batch, h, w, crop_rect, out_size, code, top, mean,
                      stddev, norm):
    if crop_rect is None:
        left, top0, cw, ch = 0, 0, w, h
    else:
        left, top0, cw, ch = crop_rect.int_bounds()
    if left < 0 or cw <= 0 or ch <= 0 or left + cw > w or ch > h:
        raise ValueError("crop rect outside the frame")
    if top is None:
        top = top0
    if isinstance(top, (int, np.integer)) and not 0 <= top <= h - ch:
        raise ValueError("crop rect outside the frame")
    as_f32 = lambda v: None if v is None else jnp.asarray(v, jnp.float32)
    return _runtime_top_chain(
        batch, jnp.asarray(top, jnp.int32), as_f32(mean), as_f32(stddev),
        code=code, left=left, cw=cw, ch=ch,
        out_size=(int(out_size[0]), int(out_size[1])), norm=bool(norm),
    )


def preprocess_fused_batch(batch, crop_rect=None, out_size=(224, 224), *,
                           top=None, mean=None, stddev=None, normalize=True):
    """crop → bilinear resize → CHW → f32 → normalize over a
    (N, H, W, 3) u8 batch, returning (N, 3, oh, ow) f32.

    ``top`` (python int or traced scalar) overrides ``crop_rect.top``
    at run time with the same crop height: a moving ROI re-uses one
    compiled program.  A traced top outside ``[0, H - crop_h]`` is
    clamped into the frame (``lax.dynamic_slice`` semantics).
    ``mean`` / ``stddev`` are per-channel constants or arrays; None
    computes per-image statistics.
    """
    if batch.dtype != jnp.uint8 or batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError("preprocess_fused_batch needs (N, H, W, 3) uint8")
    _, h, w, _ = batch.shape
    return _runtime_top_call(batch, h, w, crop_rect, out_size, None, top,
                             mean, stddev, normalize)


def preprocess_fused_nv_batch(batch, crop_rect=None, out_size=(224, 224), *,
                              is_nv12=False, to_rgb=False, top=None,
                              mean=None, stddev=None, normalize=True):
    """NV decode → crop → bilinear resize → planar f32 → normalize over
    a (N, H*3//2, W) u8 batch of stacked NV buffers (Y over interleaved
    VU — NV21 by default, ``is_nv12=True`` for UV order).  Returns
    (N, 3, oh, ow) f32: B, G, R planes, or R, G, B with ``to_rgb``.
    ``top``, ``mean`` and ``stddev`` as in ``preprocess_fused_batch``;
    the decode follows the reference camera chain
    (cvt_color.cpp:151-156 → resize_normalize.cpp:15-107).
    """
    if batch.dtype != jnp.uint8 or batch.ndim != 3:
        raise ValueError("preprocess_fused_nv_batch needs (N, H*3//2, W) uint8")
    _, hbuf, w = batch.shape
    if hbuf % 3 or w % 2:
        raise ValueError("NV buffer needs H*3//2 rows and even width")
    return _runtime_top_call(batch, hbuf * 2 // 3, w, crop_rect, out_size,
                             _NV_CODE[(bool(is_nv12), bool(to_rgb))], top,
                             mean, stddev, normalize)
