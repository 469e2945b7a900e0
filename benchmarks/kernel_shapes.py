"""XLA's time at the shapes the removed Pallas kernels served, beside the
bytes each call must move.

Cases (BASELINE geometry): the config-4 chain (32 x 1080p -> 224), its
resize alone on u8 (matmuls at DEFAULT) and on f32 (at HIGHEST), the
NV21 chain (8 x 1080p), the config-5 warp (2432x1368 -> 1216x684, 8
frames), normalize on 3x224x224 and 3x1080x1920 f32, and match_template
(TM_CCOEFF_NORMED, 640x360 BGR, 32x32 template).

Per case: the host-clock median around ``jax.block_until_ready`` (after
a compiling warm-up), then a short ``jax.profiler`` window from which
the device time per call (union of kernel intervals on the GPU's
streams), the kernel count per call and the largest kernels are read.
``min_bytes`` is what the call must read and write at least; the
bandwidth share is ``min_bytes / device time`` over 3.35 TB/s (H100 SXM
HBM3, NVIDIA data sheet).  The optimized HLO of each case is written to
``--out`` for reading the fusion structure.

Run:  python -m benchmarks.kernel_shapes [--out DIR]
Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def _cases():
    import jax

    import vacv_tpu as vc
    from vacv_tpu.core.types import Layout
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.utils.io import bgr2nv21_numpy

    rng = np.random.default_rng(0)
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)
    out224 = 3 * 224 * 224 * 4

    cfg4 = Preprocessor(PreprocessConfig(
        crop_rect=vc.VRect(64, 28, 1856, 1064), out_size=(224, 224)))
    yield ("cfg4_chain_1080p_x32", cfg4._jit_batch, (u8(32, 1080, 1920, 3),),
           32 * (1036 * 1792 * 3 + out224))

    # The resize alone at the config-4 crop: the u8 bilinear path (both
    # passes at DEFAULT, exact) vs a float source (both at HIGHEST).
    resize = jax.jit(jax.vmap(
        lambda f: vc.resize(vc.Image(f, Layout.HWC), (224, 224)).data))
    crop = u8(32, 1036, 1792, 3)
    yield ("resize_u8_default_1036x1792_x32", resize, (crop,),
           crop.nbytes + 32 * 224 * 224 * 3)
    yield ("resize_f32_highest_1036x1792_x32", resize,
           (crop.astype(np.float32),), 4 * crop.nbytes + 4 * 32 * 224 * 224 * 3)

    nv = np.stack([bgr2nv21_numpy(u8(1080, 1920, 3)).reshape(1620, 1920)
                   for _ in range(8)])
    nvp = Preprocessor(PreprocessConfig(
        color_code=vc.ColorCode.COLOR_YUV2BGR_NV21,
        crop_rect=vc.VRect(64, 28, 1856, 1064), out_size=(224, 224)))
    yield ("nv21_chain_1080p_x8", nvp._jit_batch, (nv,),
           8 * (1036 * 1792 * 3 // 2 + out224))

    m5 = [[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]]
    warp = jax.jit(jax.vmap(
        lambda f: vc.warp_affine(vc.Image(f, Layout.HWC), m5,
                                 (1216, 684)).data))
    # the inverse map reads a ~1351 x 760 source window per frame
    yield ("cfg5_warp_2432x1368_to_1216x684_x8", warp,
           (u8(8, 1368, 2432, 3),), 8 * 3 * (1351 * 760 + 1216 * 684))

    norm = jax.jit(lambda x: vc.normalize(vc.Image(x, vc.CHW)).data)
    for h, w in ((224, 224), (1080, 1920)):
        x = u8(3, h, w).astype(np.float32)
        yield (f"normalize_3x{h}x{w}_f32", norm, (x,), 2 * x.nbytes)

    mt = jax.jit(lambda x, t: vc.match_template(
        x, t, vc.TM_CCOEFF_NORMED).data)
    img = u8(360, 640, 3)
    yield ("match_template_640x360_t32", mt, (img, img[100:132, 200:232]),
           img.nbytes + 609 * 329 * 4)


def _device_windows(trace_dir):
    """(busy_ns, kernel_count, {kernel: total_ns}) over the GPU stream
    lines of the trace in ``trace_dir``."""
    import jax

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    pd = jax.profiler.ProfileData.from_file(path)
    spans, per = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                per[ev.name] = per.get(ev.name, 0.0) + ev.duration_ns
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, len(spans), per


def run(out_dir, reps=20, traced=5):
    import jax

    from vacv_tpu.config import enable_compile_cache
    from vacv_tpu.utils.perf import card_info, require_gpu

    require_gpu(jax.devices())
    enable_compile_cache()
    card = card_info()
    dev = jax.devices()[0]
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for name, fn, host_args, min_bytes in _cases():
        args = [jax.device_put(a, dev) for a in host_args]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        with open(os.path.join(out_dir, f"{name}.hlo.txt"), "w") as f:
            f.write(fn.lower(*args).compile().as_text())
        tdir = tempfile.mkdtemp(prefix=name, dir=out_dir)
        with jax.profiler.trace(tdir):
            for _ in range(traced):
                jax.block_until_ready(fn(*args))
        busy, n_kernels, per = _device_windows(tdir)
        dev_s = busy / traced / 1e9
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        row = {
            "case": name, "min_bytes": min_bytes,
            "first_call_s": first, "host_median_ms": np.median(times) * 1e3,
            "device_ms_per_call": dev_s * 1e3,
            "kernels_per_call": n_kernels / traced,
            "achieved_GBps": min_bytes / dev_s / 1e9 if dev_s else None,
            "share_of_hbm_bound": (min_bytes / HBM_BYTES_PER_S / dev_s
                                   if dev_s else None),
            "top_kernels_us_per_call": [(k, v / traced / 1e3)
                                        for k, v in top],
            "card": card,
        }
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    with open(os.path.join(out_dir, "kernel_shapes.json"), "w") as f:
        json.dump(rows, f, indent=1, default=float)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernel_shapes")
    args = ap.parse_args()
    run(args.out)
