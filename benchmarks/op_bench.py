"""Per-op differential benchmark table — the rebuild of the reference's
``test_main`` registry + ``CvProfile`` runner
(``/root/reference/src/test/src/test_main.cpp:15-67``), reporting
[opencv_ms, vacv_tpu_ms, cosine, expected] per op/config across the
reference's size ladder.

Device timings are host-clock medians around ``jax.block_until_ready``
after a warm-up call (which compiles), on a GPU only.  Step functions
take an index ``i`` (0 when timed) that selects a slice offset.  The
default ladder is two sizes; pass ``--ladder`` for the reference's full
176x144→2560x1440 set.  Without OpenCV installed, the OpenCV column
reads "not measured".

Run:  python -m benchmarks.op_bench [--ladder]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import vacv_tpu as vc
from vacv_tpu.profile import CvProfile, TestFuncInfo
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu.utils.io import bgr2nv21_numpy

try:
    import cv2
except ImportError:  # OpenCV is an optional timing/correctness baseline
    cv2 = None

# The reference's size ladder (test assets 176x144 .. 2560x1440;
# 284x214 is the test_normalize.cpp:22-143 asset).
LADDER = [(144, 176), (214, 284), (360, 640), (720, 1280), (1080, 1920),
          (1440, 2560)]
DEFAULT = [(360, 640), (1080, 1920)]


ASSETS_DIR = None  # set via --assets to use real JPEGs (e.g. the
                   # reference's /root/reference/src/test/res)


def _img(h, w, seed=0):
    if ASSETS_DIR:
        import glob

        from vacv_tpu.utils.loader import _decode

        for p in sorted(glob.glob(f"{ASSETS_DIR}/*.jp*g")):
            img = _decode(p)
            if img.shape[:2] == (h, w):
                return img
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 70 * np.sin(xx / 37.0) + 50 * np.cos(yy / 23.0)
    img = base[..., None] + rng.normal(0, 8, size=(h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _gray_img(h, w, seed=9):
    """Single-channel (h, w) u8 — prefers a *grey* asset of that size
    (the reference ships 1280x720_grey.jpg)."""
    if ASSETS_DIR:
        import glob

        from vacv_tpu.utils.loader import _decode

        for p in sorted(glob.glob(f"{ASSETS_DIR}/*gr[ae]y*.jp*g")):
            img = _decode(p)
            if img.shape[:2] == (h, w):
                return img[..., 0].copy() if img.ndim == 3 else img
    return _img(h, w, seed)[..., 0].copy()


def _device_ms(fn, args, iters):
    """(median ms, output) of ``fn(*args)`` after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def _pair(cv_fn, step_fn, dev_args, ref_for_cosine=None, iters=16):
    """TestFunc returning [cv_ms, ours_ms, cosine, 1.0].

    ``step_fn(0, *dev_args)`` is both the timed body and the output
    compared against ``ref_for_cosine`` or ``cv_fn()``'s result.  Without
    OpenCV, ``cv_ms`` (and a cosine that needs ``cv_fn``) is NaN, which
    the table prints as "not measured".
    """
    import jax
    import jax.numpy as jnp

    fn = jax.jit(step_fn)

    def run():
        ref, cv_ms = None, float("nan")
        if cv2 is not None:
            t0 = time.perf_counter()
            ref = cv_fn()
            cv_ms = (time.perf_counter() - t0) * 1e3
        ms, out = _device_ms(fn, (jnp.int32(0), *dev_args), iters)
        cmp_ref = ref if ref_for_cosine is None else ref_for_cosine
        cos = (float("nan") if cmp_ref is None
               else cosine_similarity(np.asarray(out), cmp_ref))
        return [cv_ms, ms, cos, 1.0]

    return run


def build_tests(sizes):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from vacv_tpu.core.types import Layout
    from vacv_tpu.ops.normalize import normalize
    from vacv_tpu.ops.resize import resize

    if cv2 is not None:
        cv2.setNumThreads(1)
    tests = []
    for h, w in sizes:
        src = _img(h, w)
        srcj = jax.device_put(jnp.asarray(src))
        srcf = src.astype(np.float32)
        srcfj = jax.device_put(jnp.asarray(srcf))
        name = f"{w}x{h}"

        # every step slices an i-dependent (h-2)-row window to defeat
        # loop-invariant code motion in the timing loop (bound per size
        # via default args: the loop variable would otherwise re-bind)
        def window(b, i, hh=h, ww=w):
            return lax.dynamic_slice(b, (i % 2, 0, 0), (hh - 2, ww, 3))

        # ---- crop (half-frame ROI) ----
        rect = (w // 8, h // 8, w // 2, h // 2)

        def crop_step(i, b, r=rect, win=window):
            return lax.dynamic_slice(win(b, i), (r[1], r[0], 0), (r[3], r[2], 3))

        tests.append(TestFuncInfo(
            f"crop_{name}",
            _pair(
                lambda s=src, r=rect: s[r[1]:r[1]+r[3], r[0]:r[0]+r[2]].copy(),
                crop_step, (srcj,),
            ),
        ))

        # ---- resize bilinear u8 -> 224 ----
        def rs_step(i, b, win=window):
            return resize(vc.Image(win(b, i), Layout.HWC), (224, 224)).data

        tests.append(TestFuncInfo(
            f"resize_linear_u8_{name}",
            _pair(
                lambda s=src, hh=h, ww=w: cv2.resize(s[:hh-2], (224, 224)),
                rs_step, (srcj,),
            ),
        ))

        # ---- resize bicubic f32 ----
        def rc_step(i, b, win=window):
            return resize(vc.Image(win(b, i), Layout.HWC), (224, 224),
                          interpolation=vc.INTER_CUBIC).data

        tests.append(TestFuncInfo(
            f"resize_cubic_f32_{name}",
            _pair(
                lambda s=srcf, hh=h: cv2.resize(
                    s[:hh-2], (224, 224), interpolation=cv2.INTER_CUBIC),
                rc_step, (srcfj,),
            ),
        ))

        # ---- yuv2bgr ----
        nv = bgr2nv21_numpy(src)
        y_j = jax.device_put(jnp.asarray(nv[: h * w].reshape(h, w)))
        vu_j = jax.device_put(jnp.asarray(nv[h * w:].reshape(h // 2, w)))

        def cc_step(i, yy, vv, hh=h, ww=w):
            from vacv_tpu.ops.cvt_color import nv_to_bgr_planes

            ys = lax.dynamic_slice(yy, (2 * (i % 2), 0), (hh - 2, ww))
            vs = lax.dynamic_slice(vv, (i % 2, 0), (hh // 2 - 1, ww))
            b, g, r = nv_to_bgr_planes(ys, vs, is_nv12=False)
            return jnp.stack([b, g, r], axis=-1)

        def cv_cc(n=nv, hh=h, ww=w):
            # cv2's NV21 coefficients differ from the reference's; used
            # for timing — cosine is vs our own spec output at i=0
            return cv2.cvtColor(n.reshape(hh * 3 // 2, ww),
                                cv2.COLOR_YUV2BGR_NV21)

        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
        from oracle import nv_to_bgr as oracle_nv

        spec = oracle_nv(nv[: h * w].reshape(h, w)[: h - 2],
                         nv[h * w:].reshape(h // 2, w)[: h // 2 - 1],
                         is_nv12=False)
        tests.append(TestFuncInfo(
            f"yuv2bgr_{name}",
            _pair(cv_cc, cc_step, (y_j, vu_j), ref_for_cosine=spec),
        ))

        # ---- normalize (self-stats) ----
        def nm_step(i, b):
            win = lax.dynamic_slice(b, (i % 2, 0, 0), (b.shape[0]-2, b.shape[1], 3))
            return normalize(vc.Image(win, Layout.HWC)).data

        def cv_norm(s=srcf, hh=h):
            ss = s[:hh-2]
            m, sd = cv2.meanStdDev(ss)
            return (ss - m.ravel().astype(np.float32)) / (
                sd.ravel().astype(np.float32) + 1e-6)

        tests.append(TestFuncInfo(
            f"normalize_{name}", _pair(cv_norm, nm_step, (srcfj,)),
        ))

        # ---- warp_affine ----
        m = np.array([[0.85, 0.05, w * 0.02], [-0.05, 0.85, h * 0.02]],
                     np.float32)

        def wwin(b, i, hh=h, ww=w):
            return lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (hh - 8, ww, 3))

        def wa_step(i, b, mm=m, hh=h, ww=w, win=wwin):
            return vc.warp_affine(
                vc.Image(win(b, i), Layout.HWC), mm, (ww // 2, hh // 2)).data

        tests.append(TestFuncInfo(
            f"warp_affine_{name}",
            _pair(
                lambda s=src, mm=m, hh=h, ww=w: cv2.warpAffine(
                    s[:hh-8], mm.astype(np.float64), (ww // 2, hh // 2)),
                wa_step, (srcj,),
            ),
        ))

    # ---- gray 1280x720 asset (1280x720_grey.jpg): gray2bgr + resize ----
    if (720, 1280) in sizes:
        gray = _gray_img(720, 1280)
        grayj = jax.device_put(jnp.asarray(gray))

        def gr_step(i, g):
            gs = lax.dynamic_slice(g, (i % 2, 0), (718, 1280))
            img = vc.cvt_color(gs, vc.ColorCode.COLOR_GRAY2BGR)
            return resize(img, (224, 224)).data

        def cv_gr(g=gray):
            bgr = cv2.cvtColor(g[:718], cv2.COLOR_GRAY2BGR)
            return cv2.resize(bgr, (224, 224))

        tests.append(TestFuncInfo(
            "gray2bgr_resize_1280x720", _pair(cv_gr, gr_step, (grayj,)),
        ))

    # ---- dtype / layout / match_template (the rest of the reference's
    # test registry: test_change_dtype.cpp, test_change_layout.cpp; the
    # reference served match_template via its OpenCV wrapper) --------
    if (1080, 1920) in sizes:
        src = _img(1080, 1920, seed=7)
        srcj = jax.device_put(jnp.asarray(src))

        def dt_step(i, b):
            win = lax.dynamic_slice(b, (i % 2, 0, 0), (1078, 1920, 3))
            return vc.Image(win, Layout.HWC).change_dtype(jnp.float32).data

        tests.append(TestFuncInfo(
            "change_dtype_1920x1080",
            _pair(lambda s=src: s[:1078].astype(np.float32),
                  dt_step, (srcj,)),
        ))

        def lo_step(i, b):
            win = lax.dynamic_slice(b, (i % 2, 0, 0), (1078, 1920, 3))
            return vc.Image(win, Layout.HWC).change_layout(Layout.CHW).data

        tests.append(TestFuncInfo(
            "change_layout_1920x1080",
            _pair(lambda s=src: np.transpose(s[:1078], (2, 0, 1)).copy(),
                  lo_step, (srcj,)),
        ))

    if (360, 640) in sizes:
        img6 = _img(360, 640, seed=8).astype(np.float32)
        tmpl = img6[100:132, 200:232].copy()
        img6j = jax.device_put(jnp.asarray(img6[..., 0]))
        tmplj = jax.device_put(jnp.asarray(tmpl[..., 0]))

        def mt_step(i, b, t):
            win = lax.dynamic_slice(b, (i % 2, 0), (358, 640))
            return vc.match_template(
                win, t, vc.MatchMode.TM_CCOEFF_NORMED
            ).data

        def cv_mt():
            return cv2.matchTemplate(
                img6[:358, :, 0], tmpl[..., 0], cv2.TM_CCOEFF_NORMED
            )

        tests.append(TestFuncInfo(
            "match_template_ccoeff_gray_640x360",
            _pair(cv_mt, mt_step, (img6j, tmplj)),
        ))

        # ---- match_template: every TM_* mode at 32x32, CCOEFF at
        # 16/64 ------------------------------------------------------
        mt_modes = [(m, m.name) for m in (
            vc.MatchMode.TM_SQDIFF, vc.MatchMode.TM_SQDIFF_NORMED,
            vc.MatchMode.TM_CCORR, vc.MatchMode.TM_CCORR_NORMED,
            vc.MatchMode.TM_CCOEFF)]
        src6u = _img(360, 640, seed=8)
        src6uj = jax.device_put(jnp.asarray(src6u))
        for ours, theirs in mt_modes:
            t3 = src6u[100:132, 200:232].copy()
            t3j = jax.device_put(jnp.asarray(t3))

            def mt3_step(i, b, t, mode=ours):
                win = lax.dynamic_slice(b, (i % 2, 0, 0), (358, 640, 3))
                return vc.match_template(win, t, mode).data

            def cv_mt3(s=src6u, t=t3, mode=theirs):
                return cv2.matchTemplate(
                    s[:358].astype(np.float32),
                    t.astype(np.float32), getattr(cv2, mode))

            tests.append(TestFuncInfo(
                f"match_template_{vc.MatchMode(ours).name[3:].lower()}"
                "_640x360",
                _pair(cv_mt3, mt3_step, (src6uj, t3j)),
            ))
        for ts_ in (16, 64):
            tt = src6u[100:100 + ts_, 200:200 + ts_].copy()
            ttj = jax.device_put(jnp.asarray(tt))

            def mtt_step(i, b, t):
                win = lax.dynamic_slice(b, (i % 2, 0, 0), (358, 640, 3))
                return vc.match_template(
                    win, t, vc.MatchMode.TM_CCOEFF).data

            def cv_mtt(s=src6u, t=tt):
                return cv2.matchTemplate(
                    s[:358].astype(np.float32),
                    t.astype(np.float32), cv2.TM_CCOEFF)

            tests.append(TestFuncInfo(
                f"match_template_ccoeff_t{ts_}_640x360",
                _pair(cv_mtt, mtt_step, (src6uj, ttj)),
            ))

        # ---- resize: nearest / area / lanczos4 (native modes the
        # reference forwarded to OpenCV) -----------------------------
        for mode_name, vmode in (
            ("nearest", vc.INTER_NEAREST),
            ("area", vc.INTER_AREA),
            ("lanczos4", vc.INTER_LANCZOS4),
        ):
            cvmode = vmode.name
            def rm_step(i, b, m=vmode):
                win = lax.dynamic_slice(b, (i % 2, 0, 0), (358, 640, 3))
                return resize(vc.Image(win, Layout.HWC), (224, 224),
                              interpolation=m).data

            def cv_rm(s=_img(360, 640).astype(np.float32), m=cvmode):
                return cv2.resize(s[:358], (224, 224),
                                  interpolation=getattr(cv2, m))

            tests.append(TestFuncInfo(
                f"resize_{mode_name}_f32_640x360",
                _pair(cv_rm, rm_step,
                      (jax.device_put(jnp.asarray(
                          _img(360, 640).astype(np.float32))),)),
            ))

        # ---- resize_normalize vs the OpenCV chain -------------------
        from vacv_tpu.ops.fused import resize_normalize

        def rn_step(i, b):
            win = lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (352, 640, 3))
            return resize_normalize(
                vc.Image(win, Layout.HWC), (224, 224)).data

        def cv_rn(s=_img(360, 640)):
            r = cv2.resize(s[:352], (224, 224)).astype(np.float32)
            m, sd = cv2.meanStdDev(r)
            return (r - m.ravel().astype(np.float32)) / (
                sd.ravel().astype(np.float32) + 1e-6)

        tests.append(TestFuncInfo(
            "resize_normalize_640x360",
            _pair(cv_rn, rn_step,
                  (jax.device_put(jnp.asarray(_img(360, 640))),)),
        ))

    # ---- cvt_color: YCrCb / YUV / HSV, both directions -------------
    if (1080, 1920) in sizes:
        src = _img(1080, 1920, seed=7)
        srcj = jax.device_put(jnp.asarray(src))
        C = vc.ColorCode
        conv = lambda code: np.asarray(vc.cvt_color(src, code).data)
        hsv_in = conv(C.COLOR_BGR2HSV)
        ycc_in = conv(C.COLOR_BGR2YCrCb)
        yuv_in = conv(C.COLOR_BGR2YUV)
        for cname, vcode, inp in (
            ("bgr2ycrcb", C.COLOR_BGR2YCrCb, src),
            ("ycrcb2bgr", C.COLOR_YCrCb2BGR, ycc_in),
            ("bgr2yuv", C.COLOR_BGR2YUV, src),
            ("yuv2bgr_full", C.COLOR_YUV2BGR, yuv_in),
            ("bgr2hsv", C.COLOR_BGR2HSV, src),
            ("hsv2bgr", C.COLOR_HSV2BGR, hsv_in),
        ):
            inj = jax.device_put(jnp.asarray(inp))

            def cv_cvt(x=inp, code=vcode.name):
                return cv2.cvtColor(x[:1078], getattr(cv2, code))

            def cvt_step(i, b, code=vcode):
                win = lax.dynamic_slice(b, (i % 2, 0, 0), (1078, 1920, 3))
                return vc.cvt_color(win, code).data

            tests.append(TestFuncInfo(
                f"cvt_{cname}_1920x1080",
                _pair(cv_cvt, cvt_step, (inj,)),
            ))

        # ---- warp_affine non-default modes -------------------------
        m = np.array([[0.85, 0.05, 38.4], [-0.05, 0.85, 21.6]], np.float32)

        def wn_step(i, b, mm=m):
            win = lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (1072, 1920, 3))
            return vc.warp_affine(
                vc.Image(win, Layout.HWC), mm, (960, 536),
                flags=vc.INTER_NEAREST).data

        tests.append(TestFuncInfo(
            "warp_nearest_1920x1080",
            _pair(lambda s=src, mm=m: cv2.warpAffine(
                s[:1072], mm.astype(np.float64), (960, 536),
                flags=cv2.INTER_NEAREST), wn_step, (srcj,)),
        ))

        def wr_step(i, b, mm=m):
            win = lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (1072, 1920, 3))
            return vc.warp_affine(
                vc.Image(win, Layout.HWC), mm, (960, 536),
                border_mode=vc.BorderMode.BORDER_REPLICATE).data

        tests.append(TestFuncInfo(
            "warp_replicate_1920x1080",
            _pair(lambda s=src, mm=m: cv2.warpAffine(
                s[:1072], mm.astype(np.float64), (960, 536),
                borderMode=cv2.BORDER_REPLICATE), wr_step, (srcj,)),
        ))

        def wc_step(i, b, mm=m):
            win = lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (1072, 1920, 3))
            return vc.warp_affine(
                vc.Image(win, Layout.HWC), mm, (960, 536),
                flags=vc.INTER_CUBIC).data

        tests.append(TestFuncInfo(
            "warp_cubic_1920x1080",
            _pair(lambda s=src, mm=m: cv2.warpAffine(
                s[:1072], mm.astype(np.float64), (960, 536),
                flags=cv2.INTER_CUBIC), wc_step, (srcj,)),
        ))

    # ---- full-frame f32 warp rows -----------------------------------
    import math

    for (h, w), rot in [((1080, 1920), 0.0), ((1440, 2560), 0.0),
                        ((1440, 2560), 20.0)]:
        if (h, w) not in sizes:
            continue
        a = math.radians(rot)
        mf = np.array([[0.9 * math.cos(a), 0.9 * math.sin(a), 30.0],
                       [-0.9 * math.sin(a), 0.9 * math.cos(a), 20.0]],
                      np.float32)
        hh = h - 8
        srcf32 = _img(h, w, seed=h + int(rot)).astype(np.float32)
        srcf32j = jax.device_put(jnp.asarray(srcf32))

        def wf_step(i, b, mm=mf, hh=hh, ww=w):
            win = lax.dynamic_slice(b, (8 * (i % 2), 0, 0), (hh, ww, 3))
            return vc.warp_affine(
                vc.Image(win, Layout.HWC), mm, (ww, hh)).data

        tag = f"rot{int(rot)}_" if rot else ""
        tests.append(TestFuncInfo(
            f"warp_f32_{tag}{w}x{h}",
            _pair(lambda s=srcf32, mm=mf, hh=hh, ww=w: cv2.warpAffine(
                s[:hh], mm.astype(np.float64), (ww, hh)),
                wf_step, (srcf32j,)),
        ))

    # ---- NV camera rows at 720p/1080p/1440p: runtime-top chain ------
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from oracle import normalize_chw, resize_bilinear_u8
    from oracle import nv_to_bgr as oracle_nv

    from vacv_tpu.models import preprocess_fused_nv_batch

    for h, w in [s for s in sizes if s in ((720, 1280), (1080, 1920),
                                           (1440, 2560))]:
        src = _img(h, w, seed=h)
        nv = bgr2nv21_numpy(src).reshape(h * 3 // 2, w)
        nvj = jax.device_put(jnp.asarray(nv))[None]
        left, cw, ch = 64, w - 128, (h - 64) // 8 * 8
        rect0 = vc.VRect(left, 0, left + cw, ch)

        def nvf_step(i, b, r0=rect0):
            return preprocess_fused_nv_batch(b, r0, (224, 224),
                                             top=8 * (i % 2))[0]

        def cv_nvf(n=nv, left=left, cw=cw, ch=ch):
            bgr = cv2.cvtColor(n, cv2.COLOR_YUV2BGR_NV21)
            r = cv2.resize(bgr[0:ch, left:left + cw], (224, 224))
            return normalize_chw(np.transpose(r, (2, 0, 1)))

        # cosine vs the Q7-spec decode chain (cv2's NV coefficients
        # differ from the reference's integer spec).
        dec = oracle_nv(nv[:h], nv[h:], is_nv12=False)
        r = resize_bilinear_u8(dec[0:ch, left:left + cw], 224, 224)
        spec = normalize_chw(np.transpose(r, (2, 0, 1)))

        tests.append(TestFuncInfo(
            f"nv_camera_{w}x{h}",
            _pair(cv_nvf, nvf_step, (nvj,), ref_for_cosine=spec),
        ))
    return tests


def run_op_table(sizes=None, reps=5):
    import jax

    from vacv_tpu import config as vconfig
    from vacv_tpu.utils.perf import card_info, require_gpu

    require_gpu(jax.devices())
    vconfig.enable_compile_cache()
    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"; card: {card_info()}")
    tests = build_tests(sizes or DEFAULT)
    # reps repeats every row like the reference's 10x loop
    # (cv_profile.cpp:14); each row's programs compile once.
    prof = CvProfile(k_test_times=reps, k_log_batch_size=10)
    prof.profile(tests, verbose=False)
    ok = prof.print_results()
    prof.save_results("bench_ops.json")
    return ok


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ladder", action="store_true",
                    help="full 176x144..2560x1440 ladder")
    ap.add_argument("--assets", default=None,
                    help="JPEG dir for real inputs (matched by size)")
    ap.add_argument("--reps", type=int, default=5,
                    help="repetitions per test (reference uses 10)")
    args = ap.parse_args()
    if args.assets:
        ASSETS_DIR = args.assets
    run_op_table(LADDER if args.ladder else DEFAULT, reps=args.reps)
