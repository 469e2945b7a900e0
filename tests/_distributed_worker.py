"""Worker for the 2-process jax.distributed test (see
test_distributed.py).  Each process owns 2 virtual CPU devices; the
global mesh spans 4.  Runs the sharded preprocess pipeline + psum'd
batch statistic over the global mesh and prints a checksum line.

Usage: python _distributed_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from vacv_tpu.parallel.mesh import init_distributed

init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc  # global device view

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import vacv_tpu as vc
from vacv_tpu.models import PreprocessConfig, Preprocessor
from vacv_tpu.parallel.mesh import DATA_AXIS, make_mesh
from vacv_tpu.parallel.pipeline import shard_batched_with_stats

mesh = make_mesh()  # all 4 global devices
N = 8  # global batch; 2 frames per device
rng = np.random.default_rng(7)  # same stream on every process
batch = rng.integers(0, 256, size=(N, 32, 32, 3), dtype=np.uint8)

pre = Preprocessor(
    PreprocessConfig(
        crop_rect=vc.VRect(2, 2, 30, 30), out_size=(16, 16),
        out_layout=vc.Layout.CHW, normalize=True,
    )
)


def per_image(x):
    out = pre.fn(x)
    return out, jnp.mean(out)


step = shard_batched_with_stats(per_image, mesh)

# Each process feeds its local shard of the global batch.
sharding = NamedSharding(mesh, P(DATA_AXIS))
global_batch = jax.make_array_from_process_local_data(
    sharding, batch[pid * (N // nproc) : (pid + 1) * (N // nproc)],
    global_shape=batch.shape,
)
outs, stat = step(global_batch)
jax.block_until_ready((outs, stat))

# The psum'd statistic is identical on every process; the local output
# shards must match the single-process per-image pipeline.
local_idx = [i for i, s in enumerate(outs.addressable_shards)]
for s in outs.addressable_shards:
    i = s.index[0].start
    ref = np.asarray(pre(batch[i]))
    np.testing.assert_allclose(np.asarray(s.data)[0], ref, atol=1e-5)

print(f"DIST_OK {pid} {float(stat):.6f}", flush=True)
jax.distributed.shutdown()
