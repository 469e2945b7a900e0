"""The ``Image`` container — vacv_tpu's answer to ``vision::Tensor``.

The reference implements a ref-counted C++ tensor with an inline atomic
refcount, a custom allocator, and hand-written layout/dtype conversion
kernels (``/root/reference/src/common/tensor.{h,cpp}``).  In JAX none of
that machinery is needed: a ``jax.Array`` already provides dtype, shape,
device memory and lifetime management, so ``Image`` collapses to a thin
pytree of (array, layout metadata).  The layout/dtype *kernels* live in
``vacv_tpu.ops.layout`` / ``vacv_tpu.ops.dtype`` and are exposed here as
methods for API parity with ``Tensor::change_layout`` /
``Tensor::change_dtype`` (reference ``tensor.cpp:393-502``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .types import Layout


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class Image:
    """A single image: ``data`` plus static layout metadata.

    ``data`` is an HWC or CHW array (2-D arrays are treated as single
    channel).  ``layout`` is static (part of the pytree treedef), so
    jit-compiled functions specialize on it — the analogue of the
    reference's compile-time NEON kernel selection per layout.
    """

    data: Any
    layout: Layout = Layout.HWC

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.data,), (self.layout,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    # -- shape accessors (mirror Tensor fields w,h,c — tensor.h:71-78) ---
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def h(self) -> int:
        if self.data.ndim == 2:
            return self.data.shape[0]
        return self.data.shape[0] if self.layout == Layout.HWC else self.data.shape[1]

    @property
    def w(self) -> int:
        if self.data.ndim == 2:
            return self.data.shape[1]
        return self.data.shape[1] if self.layout == Layout.HWC else self.data.shape[2]

    @property
    def c(self) -> int:
        if self.data.ndim == 2:
            return 1
        return self.data.shape[2] if self.layout == Layout.HWC else self.data.shape[0]

    # -- conversions -----------------------------------------------------
    def with_data(self, data) -> "Image":
        return replace(self, data=data)

    def change_layout(self, layout: Layout) -> "Image":
        """HWC↔CHW transpose (parity: ``Tensor::change_layout``,
        reference ``tensor.cpp:393-457``)."""
        from ..ops.layout import change_layout

        return change_layout(self, layout)

    def change_dtype(self, dtype) -> "Image":
        """u8↔f32 conversion (parity: ``Tensor::change_dtype``,
        reference ``tensor.cpp:459-502``)."""
        from ..ops.dtype import change_dtype

        return change_dtype(self, dtype)

    def numpy(self) -> np.ndarray:
        return np.asarray(self.data)


def as_image(x, layout: Layout = Layout.HWC) -> Image:
    """Coerce an array / Image to an ``Image``."""
    if isinstance(x, Image):
        return x
    return Image(jnp.asarray(x), layout)


def as_array(x):
    """Coerce an array / Image to its raw array."""
    return x.data if isinstance(x, Image) else x
