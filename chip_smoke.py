#!/usr/bin/env python
"""Prove the preprocessing front end runs, and is right, on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py             # the one-card phases below
    python chip_smoke.py --chips 4   # only the four-card sharded phase

Phases (one process; frames are synthesised on the host from ``--seed``
and moved to the card with ``jax.device_put``):

* ``device``      JAX's platform, device kind and count, and the card's
                  name and power limit from ``nvidia-smi``; fails unless
                  the platform is ``gpu``.
* ``cfg4_1080p``  BASELINE config 4: 32 x 1080p BGR -> crop
                  (64,28,1856,1064) -> bilinear 224 -> CHW -> f32 ->
                  per-image normalize, via ``Preprocessor.batch``.  The
                  u8 resize output must be bit-exact with the numpy
                  fixed-point chain; the f32 output within 1e-4.
* ``nv21_camera`` 8 x 1080p NV21 -> decode -> crop -> bilinear 224 ->
                  normalize via ``Preprocessor.batch``, and the runtime
                  crop top (``preprocess_fused_nv_batch``) at 3 tops
                  served by one compiled program.
* ``cfg5_warp``   BASELINE config 5: 8 x 1440p -> crop 2432x1368 ->
                  rotation warp to 1216x684 -> bilinear 224 ->
                  normalize.  Every warped row is checked against the
                  numpy Q11/Q22 warp wherever the 2x2 support lies in
                  the crop (95 % of the pixels at this geometry; the
                  rest take the border value), within 1 LSB on < 0.5 %
                  of pixels (f32 coordinate rounding at knife edges);
                  the resize + normalize tail against numpy within
                  1e-4.
* ``cfg1_qcif``   BASELINE config 1: 64 x 176x144 -> crop -> bilinear
                  128x96, bit-exact.
* ``serve``       24 single 1080p frames through
                  ``StreamExecutor(depth=4)``: in order, equal to
                  ``Preprocessor.batch`` on the same frames.
* ``gpu_tests``   the ``gpu``-marked tests, in this process.

Each phase prints its wall times (host clock around
``jax.block_until_ready``; the first call, which compiles, apart from
the steady runs) beside the card's name and power limit.  Any failure
raises and exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from oracle import (  # noqa: E402  (numpy spec oracles, tests/oracle.py)
    normalize_chw,
    nv_to_bgr,
    resize_bilinear_u8,
    warp_affine_u8_rows,
)

# BASELINE.json geometry.
CFG4_RECT = (64, 28, 1856, 1064)
CFG5_RECT = (64, 36, 2496, 1404)
CFG5_M = ((0.9, 0.03, 40.0), (-0.03, 0.9, 25.0))
CFG5_DSIZE = (1216, 684)
CFG1_RECT = (8, 6, 168, 138)
NORM_ATOL = 1e-4  # normalized units: f32 statistics vs float64 numpy
WARP_LSB_SHARE = 0.005


def report(phase: str, card: str, **metrics) -> None:
    vals = " ".join(f"{k}={v}" for k, v in metrics.items())
    print(f"phase {phase}: {vals} [card: {card}]", flush=True)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _first_and_steady(fn, *args, reps=3):
    """(result, first_call_s, steady_s): the first call traces and
    compiles; ``steady_s`` is the median of ``reps`` later calls."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def _np_resize_chain(frames, rect, out_wh, layout="chw"):
    """Crop + Q11 bilinear (u8, truncated) per frame, as float32."""
    left, top, right, bottom = rect
    outs = [resize_bilinear_u8(f[top:bottom, left:right], *out_wh)
            for f in frames]
    out = np.stack(outs).astype(np.float32)
    return np.transpose(out, (0, 3, 1, 2)) if layout == "chw" else out


def _vrect(rect):
    import vacv_tpu as vc

    return vc.VRect(*rect)


def _count_mismatch(got, want):
    return int(np.count_nonzero(np.asarray(got) != np.asarray(want)))


def phase_cfg4(device, card, *, batch=32, h=1080, w=1920, rect=CFG4_RECT,
               out=224, seed=0):
    from vacv_tpu.models import PreprocessConfig, Preprocessor

    import jax

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    x = jax.device_put(frames, device)
    pre = Preprocessor(PreprocessConfig(crop_rect=_vrect(rect),
                                        out_size=(out, out)))
    y, first, steady = _first_and_steady(pre.batch, x)
    mem = pre._jit_batch.lower(x).compile().memory_analysis()
    raw = Preprocessor(PreprocessConfig(crop_rect=_vrect(rect),
                                        out_size=(out, out),
                                        normalize=False))
    u8 = np.asarray(_block(raw.batch(x)))
    ref_u8 = _np_resize_chain(frames, rect, (out, out))
    y = np.asarray(y)
    assert y.shape == (batch, 3, out, out) and np.isfinite(y).all()
    mism = _count_mismatch(u8, ref_u8)
    assert mism == 0, f"u8 resize differs from numpy in {mism} values"
    err = float(np.abs(y - normalize_chw(ref_u8)).max())
    assert err <= NORM_ATOL, err
    report("cfg4_1080p", card, batch=batch, compile_s=first - steady,
           first_call_s=first, run_s=steady, frames_per_s=batch / steady,
           u8_mismatches=mism, max_abs_f32=err)
    print(f"cfg4_1080p memory_analysis: {mem} [card: {card}]", flush=True)
    return {"run_s": steady, "max_abs_f32": err}


def _nv_frames(rng, batch, h, w):
    from vacv_tpu.utils.io import bgr2nv21_numpy

    return np.stack([
        bgr2nv21_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        .reshape(h * 3 // 2, w) for _ in range(batch)])


def phase_nv21(device, card, *, batch=8, h=1080, w=1920, rect=CFG4_RECT,
               tops=(0, 28, 44), out=224, seed=1):
    import jax

    import vacv_tpu as vc
    from vacv_tpu.models import (
        PreprocessConfig, Preprocessor, preprocess_fused_nv_batch,
    )
    from vacv_tpu.utils.perf import count_traces

    rng = np.random.default_rng(seed)
    nv = _nv_frames(rng, batch, h, w)
    x = jax.device_put(nv, device)
    pre = Preprocessor(PreprocessConfig(
        color_code=vc.ColorCode.COLOR_YUV2BGR_NV21, crop_rect=_vrect(rect),
        out_size=(out, out)))
    y, first, steady = _first_and_steady(pre.batch, x)
    dec = np.stack([nv_to_bgr(f[:h], f[h:], is_nv12=False) for f in nv])
    y = np.asarray(y)
    assert y.shape == (batch, 3, out, out) and np.isfinite(y).all()
    err = float(np.abs(
        y - normalize_chw(_np_resize_chain(dec, rect, (out, out)))).max())
    assert err <= NORM_ATOL, err

    left, _, right, bottom = rect
    rect0 = _vrect((left, 0, right, bottom - rect[1]))
    ch = bottom - rect[1]
    run = lambda t: _block(preprocess_fused_nv_batch(x, rect0, (out, out),
                                                     top=t))
    t0 = time.perf_counter()
    outs = [run(tops[0])]
    top_first = time.perf_counter() - t0
    with count_traces() as traces:
        t0 = time.perf_counter()
        outs += [run(t) for t in tops[1:]]
        top_steady = (time.perf_counter() - t0) / (len(tops) - 1)
    assert traces == [], f"runtime tops traced {len(traces)} new programs"
    top_err = 0.0
    for t, got in zip(tops, outs):
        ref = normalize_chw(_np_resize_chain(dec, (left, t, right, t + ch),
                                             (out, out)))
        top_err = max(top_err, float(np.abs(np.asarray(got) - ref).max()))
    assert top_err <= NORM_ATOL, top_err
    report("nv21_camera", card, batch=batch, compile_s=first - steady,
           first_call_s=first, run_s=steady, frames_per_s=batch / steady,
           max_abs_f32=err)
    report("nv21_camera_runtime_top", card, tops=list(tops),
           programs_for_tops=1, first_call_s=top_first, run_s=top_steady,
           max_abs_f32=top_err)
    return {"run_s": steady, "max_abs_f32": err, "top_err": top_err}


def phase_cfg5(device, card, *, batch=8, h=1440, w=2560, rect=CFG5_RECT,
               m=CFG5_M, dsize=CFG5_DSIZE, out=224, seed=2):
    import jax

    import vacv_tpu as vc
    from vacv_tpu.core.types import Layout
    from vacv_tpu.models import PreprocessConfig, Preprocessor

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    x = jax.device_put(frames, device)
    pre = Preprocessor(PreprocessConfig(
        crop_rect=_vrect(rect), warp=(m, dsize), out_size=(out, out)))
    y, first, steady = _first_and_steady(pre.batch, x)
    left, top, right, bottom = rect

    @jax.jit
    def warp_only(b):
        def one(f):
            img = vc.crop(vc.Image(f, Layout.HWC), _vrect(rect))
            return vc.warp_affine(img, [list(r) for r in m], dsize).data
        return jax.vmap(one)(b)

    warped = np.asarray(_block(warp_only(x)))
    minv = vc.invert_affine(np.asarray(m, np.float32))
    # The pipeline warps with per-tap constant borders, the oracle with
    # the reference's skip-edge zeros: compare where the 2x2 support is
    # inside the crop.
    mm = minv.ravel()
    dx = np.arange(dsize[0], dtype=np.float32)[None, :]
    dy = np.arange(dsize[1], dtype=np.float32)[:, None]
    sx = np.floor(mm[0] * dx + mm[1] * dy + mm[2])
    sy = np.floor(mm[3] * dx + mm[4] * dy + mm[5])
    inside = ((sx >= 0) & (sx < right - left - 1)
              & (sy >= 0) & (sy < bottom - top - 1))
    worst, share = 0, 0.0
    for i in range(batch):
        ref = warp_affine_u8_rows(frames[i, top:bottom, left:right], minv,
                                  *dsize)
        diff = np.abs(warped[i].astype(int) - ref.astype(int))[inside]
        worst = max(worst, int(diff.max()))
        share = max(share, float((diff > 0).mean()))
    assert worst <= 1 and share < WARP_LSB_SHARE, (worst, share)
    tail = normalize_chw(_np_resize_chain(
        warped, (0, 0, dsize[0], dsize[1]), (out, out)))
    y = np.asarray(y)
    assert y.shape == (batch, 3, out, out) and np.isfinite(y).all()
    err = float(np.abs(y - tail).max())
    assert err <= NORM_ATOL, err
    report("cfg5_warp", card, batch=batch, compile_s=first - steady,
           first_call_s=first, run_s=steady, frames_per_s=batch / steady,
           warp_max_lsb=worst, warp_lsb_share=share, max_abs_f32=err,
           warp_pixels_checked=f"{int(inside.sum())}/{inside.size}")
    return {"run_s": steady, "warp_share": share, "max_abs_f32": err}


def phase_qcif(device, card, *, batch=64, h=144, w=176, rect=CFG1_RECT,
               out_wh=(128, 96), seed=3):
    import jax

    from vacv_tpu.core.types import Layout
    from vacv_tpu.models import PreprocessConfig, Preprocessor

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    x = jax.device_put(frames, device)
    pre = Preprocessor(PreprocessConfig(
        crop_rect=_vrect(rect), out_size=out_wh, out_layout=Layout.HWC,
        normalize=False))
    y, first, steady = _first_and_steady(pre.batch, x)
    mism = _count_mismatch(y, _np_resize_chain(frames, rect, out_wh, "hwc"))
    assert mism == 0, f"qcif resize differs from numpy in {mism} values"
    report("cfg1_qcif", card, batch=batch, compile_s=first - steady,
           first_call_s=first, run_s=steady, frames_per_s=batch / steady,
           u8_mismatches=mism)
    return {"run_s": steady}


def phase_serve(device, card, *, n=24, depth=4, h=1080, w=1920,
                rect=CFG4_RECT, out=224, seed=4):
    import jax

    from vacv_tpu.models import PreprocessConfig, Preprocessor, StreamExecutor

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    pre = Preprocessor(PreprocessConfig(crop_rect=_vrect(rect),
                                        out_size=(out, out)))
    ex = StreamExecutor(pre.fn, depth=depth)
    t0 = time.perf_counter()
    _block(ex.submit(jax.device_put(frames[0], device)))
    _block(list(ex.drain()))
    first = time.perf_counter() - t0
    results = []
    t0 = time.perf_counter()
    for f in frames:
        r = ex.submit(jax.device_put(f, device))
        if r is not None:
            results.append(r)
    results.extend(ex.drain())
    results = _block(results)
    wall = time.perf_counter() - t0
    assert len(results) == n
    want = np.asarray(pre.batch(jax.device_put(frames, device)))
    err = max(float(np.abs(np.asarray(r) - want[i]).max())
              for i, r in enumerate(results))
    assert err <= 1e-5, err
    report("serve", card, frames=n, depth=depth, first_frame_s=first,
           wall_s=wall, frames_per_s=n / wall, max_abs_vs_batch=err)
    return {"wall_s": wall, "max_abs": err}


def phase_gpu_tests(card):
    """The ``gpu``-marked tests, run by pytest inside this process (the
    card is already held here; a second process could not get it)."""
    import pytest

    class Tally:
        passed = 0
        failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                self.passed += report.passed
                self.failed += report.failed

    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu_parity.py")],
                     plugins=[tally])
    wall = time.perf_counter() - t0
    assert rc == 0 and tally.failed == 0 and tally.passed > 0, (
        rc, tally.passed, tally.failed)
    report("gpu_tests", card, passed=tally.passed, wall_s=wall)


def phase_four(devices, card, *, per_dev=32, h=1080, w=1920,
               rect=CFG4_RECT, out=224, seed=5):
    """cfg 4 sharded over a 1-D mesh of ``devices``, compared frame by
    frame with the same frames on ``devices[0]``, plus the ``psum``
    batch statistic against numpy."""
    import jax
    import jax.numpy as jnp

    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.parallel import make_mesh, put_sharded, shard_batched_with_stats

    n_dev = len(devices)
    mesh = make_mesh(devices)
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (per_dev * n_dev, h, w, 3), dtype=np.uint8)
    pre = Preprocessor(PreprocessConfig(crop_rect=_vrect(rect),
                                        out_size=(out, out)))
    xs = put_sharded(frames, mesh)
    step = pre.batched(mesh)
    y, first, steady = _first_and_steady(step, xs)
    holders = {s.device for s in y.addressable_shards}
    assert holders == set(devices), holders
    assert {s.data.shape[0] for s in y.addressable_shards} == {per_dev}
    one = np.asarray(pre.batch(jax.device_put(frames, devices[0])))
    y = np.asarray(y)
    err = max(float(np.abs(y[i] - one[i]).max()) for i in range(len(y)))
    assert err <= 1e-5, err

    # Batch statistic: the mean over frames of each frame's mean square
    # (about 1 for normalized outputs), combined across cards by psum.
    stats = shard_batched_with_stats(
        lambda f: (lambda o: (o, jnp.mean(o * o)))(pre.fn(f)), mesh)
    outs, mean = _block(stats(xs))
    want = float(np.square(np.asarray(outs, np.float64)).mean())
    assert abs(float(mean) - want) <= 1e-5 * abs(want), (float(mean), want)
    report("four_card_cfg4", card, devices=n_dev, batch=len(frames),
           compile_s=first - steady, first_call_s=first, run_s=steady,
           frames_per_s=len(frames) / steady, max_abs_vs_one_card=err,
           psum_mean_square=float(mean), numpy_mean_square=want)
    return {"run_s": steady, "max_abs": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from vacv_tpu.config import enable_compile_cache
    from vacv_tpu.utils.perf import card_info, require_gpu

    devices = jax.devices()
    require_gpu(devices)
    enable_compile_cache()
    card = card_info()
    dev = devices[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    print(f"card: {card}", flush=True)
    s = args.seed
    if args.chips == 4:
        if len(devices) < 4:
            raise RuntimeError(f"--chips 4 needs 4 GPUs, JAX sees {len(devices)}")
        phase_four(devices[:4], card, seed=s + 5)
    else:
        phase_cfg4(dev, card, seed=s)
        phase_nv21(dev, card, seed=s + 1)
        phase_cfg5(dev, card, seed=s + 2)
        phase_qcif(dev, card, seed=s + 3)
        phase_serve(dev, card, seed=s + 4)
        phase_gpu_tests(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
