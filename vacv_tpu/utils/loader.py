"""Multi-threaded batch data loader — host-side input feeding.

The reference's "loader" is a synchronous ``cv::imread`` per test
(test_crop.cpp:46); a production pipeline needs the host to keep
N devices fed, so this loader decodes JPEGs on a thread pool (native
libjpeg via ``vacv_tpu.native`` when built, else cv2/PIL), assembles
fixed-shape batches, and hands them to ``device_put`` — optionally
sharded straight onto a mesh (``parallel.put_sharded``), the JAX
analogue of the reference's pinned/zero-copy H2D strategies
(``cuda.md``).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterable, Iterator, Sequence

import numpy as np


def _decode(path: str) -> np.ndarray:
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            from .. import native

            return native.imread_jpeg(path)
        except Exception:
            pass
    from .io import imread

    return imread(path)


class BatchLoader:
    """Decode ``paths`` into (batch, h, w, 3) u8 batches.

    Images are resized on the host to ``resize_to=(w, h)`` if given
    (decode-size mismatch would otherwise break batching); resizing on
    device is the framework's job, so prefer feeding same-sized frames
    and leaving ``resize_to=None``.
    """

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        num_threads: int | None = None,
        resize_to: tuple[int, int] | None = None,
        drop_remainder: bool = True,
    ) -> None:
        self.paths = list(paths)
        self.batch_size = batch_size
        self.resize_to = resize_to
        self.drop_remainder = drop_remainder
        self.num_threads = num_threads or min(16, os.cpu_count() or 4)

    def _load_one(self, path: str) -> np.ndarray:
        img = _decode(path)
        if self.resize_to is not None:
            try:
                import cv2

                img = cv2.resize(img, self.resize_to)
            except ImportError:
                from PIL import Image as PILImage

                img = np.asarray(
                    PILImage.fromarray(img).resize(
                        self.resize_to, PILImage.BILINEAR
                    )
                )
        return img

    def __iter__(self) -> Iterator[np.ndarray]:
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            batch: list[cf.Future] = []
            for path in self.paths:
                batch.append(pool.submit(self._load_one, path))
                if len(batch) == self.batch_size:
                    yield np.stack([f.result() for f in batch])
                    batch = []
            if batch and not self.drop_remainder:
                yield np.stack([f.result() for f in batch])

    def to_device(self, mesh=None) -> Iterable:
        """Iterate device-resident (optionally mesh-sharded) batches."""
        import jax

        for host_batch in self:
            if mesh is not None:
                from ..parallel.pipeline import put_sharded

                yield put_sharded(host_batch, mesh)
            else:
                yield jax.device_put(host_batch)
