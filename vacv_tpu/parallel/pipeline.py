"""Batch-of-frames sharded execution via ``shard_map``.

SURVEY §7.9: frame batches shard across chips/hosts on the mesh's
``"data"`` axis; each device runs the vmapped per-image pipeline on its
local shard.  Per-image ops need no collectives; optional cross-batch
statistics use ``psum`` over the data axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import DATA_AXIS


def shard_batched(fn, mesh: Mesh, axis: str = DATA_AXIS):
    """Lift a per-image function ``fn(img_array) -> out_array`` into a
    jitted batch function whose leading axis is sharded over ``mesh``.

    Each device vmaps ``fn`` over its local shard — the batch size must
    be divisible by the mesh size (pad the tail batch, as any serving
    stack does).
    """
    vfn = jax.vmap(fn)
    smapped = shard_map(
        vfn, mesh=mesh, in_specs=P(axis), out_specs=P(axis), check_vma=False
    )
    return jax.jit(smapped)


def shard_batched_with_stats(fn, mesh: Mesh, axis: str = DATA_AXIS):
    """Like ``shard_batched`` but also returns the cross-batch mean of
    a per-image statistic: ``fn`` must return ``(out, stat)``.  The
    global mean rides one ``psum`` over the data axis (the only
    collective in the framework, per SURVEY §2.5)."""

    def local(batch):
        outs, stats = jax.vmap(fn)(batch)
        local_sum = jnp.sum(stats, axis=0)
        total = jax.lax.psum(local_sum, axis_name=axis)
        count = jax.lax.psum(jnp.asarray(stats.shape[0], jnp.float32), axis_name=axis)
        return outs, total / count

    smapped = shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=(P(axis), P()),
        check_vma=False,
    )
    return jax.jit(smapped)


def put_sharded(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """Host→device transfer of a numpy batch, sharded on arrival (the
    JAX analogue of the reference's pinned/zero-copy H2D study in
    ``cuda.md`` — ``device_put`` with a sharding places each shard
    directly on its device)."""
    from jax.sharding import NamedSharding

    return jax.device_put(batch, NamedSharding(mesh, P(axis)))
