"""End-to-end example: SLAM/vision front-end preprocessing.

Walks the full vacv_tpu path a production user takes:

1. load camera frames (JPEG via the native loader; falls back to a
   synthetic frame when no assets are available),
2. synthesize NV21 (what a camera ISP would hand us),
3. decode NV21 → BGR on device, crop the ROI, resize to the network
   input, normalize — one fused XLA program,
4. run the same pipeline batch-sharded over every available chip.

Run: python -m examples.slam_frontend [--assets DIR]
(The reference repo's test JPEGs at /root/reference/res work as
--assets when mounted.)
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def load_frames(assets: str | None, n: int = 8):
    paths = sorted(glob.glob(os.path.join(assets, "*.jp*g"))) if assets else []
    frames = []
    if paths:
        from vacv_tpu.utils.loader import _decode

        for p in paths:
            img = _decode(p)
            frames.append(img)
            print(f"loaded {os.path.basename(p)}: {img.shape}")
    if not frames:
        rng = np.random.default_rng(0)
        frames = [
            rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
            for _ in range(n)
        ]
        print(f"no assets — using {n} synthetic 720p frames")
    # batching needs equal shapes: standardize to the first frame's size
    import cv2

    h, w = frames[0].shape[:2]
    h -= h % 2
    w -= w % 2
    frames = [cv2.resize(f, (w, h)) for f in frames]
    while len(frames) < n:
        frames.append(frames[len(frames) % max(1, len(paths) or 1)])
    return np.stack(frames[:n])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default=None,
                    help="directory of JPEGs (e.g. /root/reference/res)")
    args = ap.parse_args()

    import vacv_tpu as vc
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.parallel import make_mesh, put_sharded
    from vacv_tpu.utils.io import bgr2nv21
    from vacv_tpu.utils.perf import time_fn

    frames = load_frames(args.assets)
    n, h, w, _ = frames.shape
    print(f"batch: {frames.shape}")

    # 2. camera-format synthesis (host, native C++ when built)
    nv_batch = np.stack(
        [bgr2nv21(f).reshape(h * 3 // 2, w) for f in frames]
    )

    # 3. fused device pipeline: NV21 -> BGR -> crop -> 224x224 -> CHW
    #    -> f32 -> normalize
    cfg = PreprocessConfig(
        color_code=vc.COLOR_YUV2BGR_NV21,
        crop_rect=vc.VRect(w // 8, h // 8, w - w // 8, h - h // 8),
        out_size=(224, 224),
        out_layout=vc.CHW,
        normalize=True,
    )
    pre = Preprocessor(cfg)
    one = np.asarray(pre(nv_batch[0]))
    print(f"single-frame output: {one.shape} {one.dtype} "
          f"mean={one.mean():.5f} std={one.std():.4f}")

    # 4. sharded batch over all devices
    mesh = make_mesh()
    batched = pre.batched(mesh)
    dev_batch = put_sharded(nv_batch, mesh)
    _, mean_ms, out = time_fn(batched, dev_batch, iters=5, warmup=2)
    print(f"sharded over {len(mesh.devices.ravel())} device(s): "
          f"out {out.shape}, {mean_ms:.2f} ms/batch (wall-clock incl. dispatch)")


if __name__ == "__main__":
    main()
