"""Multi-device sharding tests on the 8-way virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.models import PreprocessConfig, Preprocessor
from vacv_tpu.parallel import make_mesh, put_sharded, shard_batched, shard_batched_with_stats


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return make_mesh()


def test_shard_batched_matches_vmap(mesh, rng):
    batch = rng.integers(0, 256, size=(16, 36, 48, 3), dtype=np.uint8)
    pre = Preprocessor(PreprocessConfig(out_size=(16, 16)))
    fn = pre.fn
    sharded = shard_batched(fn, mesh)
    ref = jax.vmap(fn)(jnp.asarray(batch))
    out = sharded(put_sharded(batch, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    assert out.shape == (16, 3, 16, 16)


def test_sharding_layout(mesh, rng):
    batch = rng.integers(0, 256, size=(8, 16, 16, 3), dtype=np.uint8)
    arr = put_sharded(batch, mesh)
    # one shard per device
    assert len(arr.addressable_shards) == 8
    assert arr.addressable_shards[0].data.shape == (1, 16, 16, 3)


def test_shard_batched_with_stats_psum(mesh, rng):
    batch = rng.integers(0, 256, size=(8, 8, 8, 3), dtype=np.uint8).astype(np.float32)

    def per_image(x):
        return x * 2.0, jnp.mean(x)

    fn = shard_batched_with_stats(per_image, mesh)
    outs, global_mean = fn(put_sharded(batch, mesh))
    np.testing.assert_allclose(np.asarray(outs), batch * 2.0, atol=1e-5)
    np.testing.assert_allclose(float(global_mean), batch.mean(), rtol=1e-5)


def test_crop_resize_pipeline_sharded(mesh, rng):
    batch = rng.integers(0, 256, size=(8, 40, 60, 3), dtype=np.uint8)
    cfg = PreprocessConfig(
        crop_rect=vc.VRect(4, 2, 52, 38), out_size=(24, 24), normalize=True
    )
    pre = Preprocessor(cfg)
    sharded = pre.batched(mesh)
    out = np.asarray(sharded(put_sharded(batch, mesh)))
    # reference: per-image single-device pipeline
    for i in range(8):
        ref = np.asarray(pre(batch[i]))
        np.testing.assert_allclose(out[i], ref, atol=1e-5)


def test_batched_pipeline_under_shard_map(mesh, rng):
    """The config-4-style pipeline (crop, resize, CHW, normalize) under
    shard_map on the CPU mesh equals the vmapped single-device batch."""
    batch = rng.integers(0, 256, size=(16, 64, 128, 3), dtype=np.uint8)
    cfg = PreprocessConfig(
        crop_rect=vc.VRect(8, 8, 8 + 112, 8 + 48),
        out_size=(32, 32), out_layout=vc.CHW, normalize=True,
    )
    pre = Preprocessor(cfg)
    out = pre.batched(mesh)(put_sharded(batch, mesh))
    assert len(out.sharding.device_set) == 8
    want = np.asarray(pre.batch(jnp.asarray(batch)))
    assert out.shape == want.shape == (16, 3, 32, 32)
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)
