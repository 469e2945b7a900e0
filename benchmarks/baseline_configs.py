"""The five BASELINE.json benchmark configs, end to end.

Each config mirrors one of the reference-era scenarios (named after the
repo-root ``res/`` assets the reference's deprecated experiments used,
``/root/reference/res/``; inputs here are synthesized at the same
sizes, or loaded from ``--assets DIR`` when real frames are available):

  1. crop + bilinear resize            (salesman_qcif, 176x144)
  2. yuv2bgr + u8->f32 + HWC->CHW      (akiyo_qcif NV21, 176x144)
  3. resize bilinear+bicubic ladder 640x360 -> {224, 512, 1080p}
     with a mean_stddev reduction on each output
  4. fused normalize pipeline          (face1280720, 1280x720)
  5. warp_affine + full pipeline, batch-sharded over the device mesh
                                       (lakers25601440, 2560x1440)

Per config: single-thread OpenCV reference ms ("not measured" without
OpenCV), our device ms (host-clock median around
``jax.block_until_ready`` after a compiling warm-up, GPU only), cosine
similarity, PASS/FAIL at 1e-4 — the same four-tuple contract as the
reference's CvProfile (``src/test/src/profile/cv_profile.cpp:97-117``).

Run:  python -m benchmarks.baseline_configs
"""
from __future__ import annotations

import json

import numpy as np

from vacv_tpu.profile import CvProfile, TestFuncInfo
from .op_bench import _img, _pair, cv2


def build_tests():
    import jax
    import jax.numpy as jnp

    import vacv_tpu as vc
    from vacv_tpu.core.types import ColorCode, InterMode, Layout
    from vacv_tpu.models import PreprocessConfig, Preprocessor
    from vacv_tpu.ops.normalize import mean_stddev
    from vacv_tpu.ops.resize import resize
    from vacv_tpu.utils.io import bgr2nv21_numpy

    if cv2 is not None:
        cv2.setNumThreads(1)
    tests = []

    def jitter(b, i):
        # i-dependent input perturbation (adds 0 at the timed i = 0).
        return b + (i % 2).astype(b.dtype)

    # ---- config 1: crop + bilinear resize (salesman_qcif) ----------
    src1 = _img(144, 176, seed=11)
    rect = vc.VRect(8, 6, 168, 138)
    src1j = jax.device_put(jnp.asarray(src1))

    def c1_step(i, b):
        img = vc.crop(vc.Image(jitter(b, i), Layout.HWC), rect)
        return resize(img, (128, 96)).data

    def c1_cv():
        roi = src1[6:138, 8:168]
        return cv2.resize(roi, (128, 96), interpolation=cv2.INTER_LINEAR)

    tests.append(TestFuncInfo("cfg1_crop_resize_qcif", _pair(c1_cv, c1_step, (src1j,))))

    # ---- config 2: yuv2bgr + dtype + layout (akiyo_qcif) -----------
    h2c, w2c = 144, 176
    bgr2 = _img(h2c, w2c, seed=22)
    nv2 = bgr2nv21_numpy(bgr2).reshape(h2c * 3 // 2, w2c)
    nv2j = jax.device_put(jnp.asarray(nv2))

    def c2_step(i, b):
        img = vc.cvt_color(jitter(b, i), ColorCode.COLOR_YUV2BGR_NV21)
        img = img.change_layout(Layout.CHW).change_dtype(jnp.float32)
        return img.data

    def c2_cv():
        bgr = cv2.cvtColor(nv2, cv2.COLOR_YUV2BGR_NV21)
        return np.transpose(bgr.astype(np.float32), (2, 0, 1))

    # cv2's NV21 coefficients differ slightly from the reference's Q7
    # integer spec; cv2 provides the timing baseline while cosine is
    # measured against the bit-level spec oracle (as op_bench does).
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from oracle import nv_to_bgr as oracle_nv

    spec2 = np.transpose(
        oracle_nv(nv2[:h2c], nv2[h2c:], is_nv12=False).astype(np.float32),
        (2, 0, 1),
    )
    tests.append(TestFuncInfo(
        "cfg2_yuv_dtype_layout_qcif",
        _pair(c2_cv, c2_step, (nv2j,), ref_for_cosine=spec2),
    ))

    # ---- config 3: resize ladder with mean_stddev ------------------
    src3 = _img(360, 640, seed=33)
    src3j = jax.device_put(jnp.asarray(src3))
    ladder = [((224, 224), InterMode.INTER_LINEAR),
              ((512, 512), InterMode.INTER_CUBIC),
              ((1920, 1080), InterMode.INTER_LINEAR)]

    def c3_step(i, b):
        img = vc.Image(jitter(b, i), Layout.HWC).change_dtype(jnp.float32)
        outs = []
        for (wh, mode) in ladder:
            r = resize(img, wh, interpolation=mode)
            m, s = mean_stddev(r)
            outs.append(jnp.concatenate([m, s]))
        return jnp.concatenate(outs)

    def c3_cv():
        f = src3.astype(np.float32)
        outs = []
        for (wh, mode) in ladder:
            inter = getattr(cv2, InterMode(mode).name)
            r = cv2.resize(f, wh, interpolation=inter)
            m, s = cv2.meanStdDev(r)
            outs.append(np.concatenate([m.ravel(), s.ravel()]).astype(np.float32))
        return np.concatenate(outs)

    tests.append(TestFuncInfo("cfg3_resize_ladder_stats", _pair(c3_cv, c3_step, (src3j,))))

    # ---- config 4: fused normalize pipeline (face1280720) ----------
    src4 = _img(720, 1280, seed=44)
    src4j = jax.device_put(jnp.asarray(src4))
    pre4 = Preprocessor(PreprocessConfig(
        crop_rect=vc.VRect(16, 8, 1264, 712), out_size=(224, 224),
        out_layout=Layout.CHW, normalize=True))

    def c4_step(i, b):
        return pre4.fn(jitter(b, i))

    def c4_cv():
        roi = src4[8:712, 16:1264]
        r = cv2.resize(roi, (224, 224), interpolation=cv2.INTER_LINEAR)
        f = np.transpose(r.astype(np.float32), (2, 0, 1))
        m, s = f.mean(axis=(1, 2), keepdims=True), f.std(axis=(1, 2), keepdims=True)
        return (f - m) / (s + 1e-6)

    tests.append(TestFuncInfo("cfg4_fused_normalize_720p", _pair(c4_cv, c4_step, (src4j,))))

    # ---- config 5: warp_affine + full pipeline, batch-sharded ------
    src5 = _img(1440, 2560, seed=55)
    m5 = np.array([[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]], np.float32)
    pre5 = Preprocessor(PreprocessConfig(
        crop_rect=vc.VRect(64, 36, 2496, 1404),
        warp=(tuple(map(tuple, m5)), (1216, 684)),
        out_size=(224, 224), out_layout=Layout.CHW, normalize=True))
    n_dev = len(jax.devices())
    per = 2  # frames per device
    batch5 = np.stack([src5] * (per * n_dev))
    from vacv_tpu.parallel import make_mesh, put_sharded
    mesh = make_mesh()
    step5 = pre5.batched(mesh)
    batch5j = put_sharded(batch5, mesh)

    def c5_step(i, b):
        return step5(jitter(b, i))

    def c5_cv():
        # Process every frame of the batch (the device side preprocesses
        # per*n_dev frames per step; timing OpenCV on one frame and
        # stacking copies would overstate its per-batch speed).
        outs = []
        for _ in range(per * n_dev):
            roi = src5[36:1404, 64:2496]
            wa = cv2.warpAffine(roi, m5.astype(np.float64), (1216, 684))
            r = cv2.resize(wa, (224, 224), interpolation=cv2.INTER_LINEAR)
            f = np.transpose(r.astype(np.float32), (2, 0, 1))
            m, s = (f.mean(axis=(1, 2), keepdims=True),
                    f.std(axis=(1, 2), keepdims=True))
            outs.append((f - m) / (s + 1e-6))
        return np.stack(outs)

    tests.append(TestFuncInfo(
        "cfg5_warp_pipeline_sharded", _pair(c5_cv, c5_step, (batch5j,), iters=8)))

    return tests


def main(reps=5):
    import jax

    from vacv_tpu import config as vconfig
    from vacv_tpu.utils.perf import card_info, require_gpu

    require_gpu(jax.devices())
    vconfig.enable_compile_cache()
    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"; card: {card_info()}")
    prof = CvProfile(k_test_times=reps, k_log_batch_size=10)
    prof.profile(build_tests(), verbose=False)
    ok = prof.print_results()
    prof.save_results("bench_baseline_configs.json")
    print(json.dumps({"metric": "baseline_configs_pass", "value": int(ok)}))
    return ok


if __name__ == "__main__":
    main()
