#!/usr/bin/env python
"""Headline benchmark: BASELINE config 4 at 1080p on one GPU.

Pipeline: a batch of 32 1920x1080 BGR u8 frames -> crop
(64,28,1856,1064) -> bilinear resize 224x224 -> CHW -> f32 -> per-image
normalize, through ``Preprocessor.batch`` on frames already on the
device (made from ``--seed`` on the host and moved with
``jax.device_put``; set-up, not timed).

Timing: the first call (trace + compile) is reported apart; then
``--reps`` calls, each timed by the host clock around
``jax.block_until_ready``.  The headline is ``batch / median``.

Prints ONE JSON line naming the device (platform, device kind, count)
and the card (name and power limit from ``nvidia-smi``).  Exits
non-zero without a GPU.

Run:  python bench.py [--reps N] [--seed S]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BATCH = 32
H, W = 1080, 1920
CROP = (64, 28, 1856, 1064)  # left, top, right, bottom
OUT = 224


def run(reps: int = 20, seed: int = 0) -> dict:
    import jax

    import vacv_tpu as vc
    from vacv_tpu.config import enable_compile_cache
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.utils.perf import card_info, require_gpu

    devices = jax.devices()
    require_gpu(devices)
    enable_compile_cache()
    card = card_info()
    dev = devices[0]

    frames = np.random.default_rng(seed).integers(
        0, 256, size=(BATCH, H, W, 3), dtype=np.uint8)
    x = jax.block_until_ready(jax.device_put(frames, dev))
    pre = Preprocessor(PreprocessConfig(crop_rect=vc.VRect(*CROP),
                                        out_size=(OUT, OUT)))
    t0 = time.perf_counter()
    jax.block_until_ready(pre.batch(x))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(pre.batch(x))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {
        "metric": "cfg4 1080p preprocess throughput",
        "value": BATCH / med,
        "unit": "frames/s",
        "detail": {
            "batch": BATCH,
            "ms_per_batch_median": med * 1e3,
            "ms_per_batch_min": min(times) * 1e3,
            "ms_per_batch_max": max(times) * 1e3,
            "reps": reps,
            "first_call_s": first,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(devices)},
            "card": card,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="cfg4 1080p throughput")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reps, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
