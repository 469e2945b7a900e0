"""Scaling benchmark: frames/s of the sharded cfg-4-style pipeline at
1..N GPUs of one host.

Each device count runs ``Preprocessor.batched`` over a 1-D mesh of that
many GPUs with a fixed per-device batch; the time is the host-clock
median around ``jax.block_until_ready`` after a compiling warm-up.
Efficiency is frames/s over (frames/s at the smallest count × the
device ratio).  Exits non-zero without a GPU.

Run: python -m benchmarks.scaling_bench [--sizes 1 2 4]
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def run(device_counts=None, per_dev_batch=32, reps=10):
    import jax

    import vacv_tpu as vc
    from vacv_tpu.config import enable_compile_cache
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.parallel import make_mesh, put_sharded
    from vacv_tpu.utils.perf import card_info, require_gpu

    from .op_bench import _device_ms

    devices = jax.devices()
    require_gpu(devices)
    enable_compile_cache()
    card = card_info()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]

    pre = Preprocessor(PreprocessConfig(
        crop_rect=vc.VRect(64, 28, 1856, 1064), out_size=(224, 224)))
    rng = np.random.default_rng(0)
    results = []
    base = None
    for n in device_counts:
        mesh = make_mesh(devices[:n])
        batch = rng.integers(0, 256, size=(per_dev_batch * n, 1080, 1920, 3),
                             dtype=np.uint8)
        ms, _ = _device_ms(pre.batched(mesh), (put_sharded(batch, mesh),),
                           reps)
        fps = len(batch) / (ms / 1e3)
        if base is None:
            base = fps / device_counts[0]
        eff = fps / (base * n)
        results.append({"devices": n, "ms_per_step": ms, "fps": fps,
                        "efficiency": eff})
        print(f"devices={n:2d}  fps={fps:10.1f}  efficiency={eff:.3f}  "
              f"[card: {card}]")
    print(json.dumps({"scaling": results, "card": card}))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=None)
    args = ap.parse_args()
    run(args.sizes)
