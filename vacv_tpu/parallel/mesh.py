"""Device-mesh construction and multi-host bootstrap.

The reference is single-process/single-device; its only scale-out axis
is SIMD width + OpenMP threads (SURVEY §2.5).  This rebuild's
scale-out axis is **batch data parallelism over frames**: a 1-D
``jax.sharding.Mesh`` whose single ``"data"`` axis spans all devices
(the cards of a host all reach each other over NVLink, so the mesh
follows the algorithm, not a topology).  Per-image preprocessing
is embarrassingly parallel — no collectives on the hot path — so
scaling efficiency is bounded only by input feeding; cross-batch
statistics (when requested) ride a single ``psum``.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bootstrap (``jax.distributed.initialize``) — the
    replacement for the reference's nonexistent comm backend
    (SURVEY §5.8).  No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(devices=None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over ``devices`` (default: all addressable devices)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits the leading batch axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
