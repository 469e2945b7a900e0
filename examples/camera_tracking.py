"""End-to-end example: moving-ROI camera tracking.

A tracking-style camera loop where the crop window FOLLOWS a target
between frames:

1. synthesize an NV21 camera stream with a drifting target patch,
2. localize the target with ``match_template`` + ``min_max_loc``,
3. preprocess the next frame's ROI with ``preprocess_fused_nv_batch``
   (NV decode → crop → resize → normalize under one ``jit``) using a
   RUNTIME crop top — the moving window re-uses ONE compiled program
   for every position (the reference chain supports this because its
   decode and crop are separate ops, cvt_color.cpp:151-156).

Run: python -m examples.camera_tracking
"""
from __future__ import annotations

import numpy as np


def make_stream(n_frames=6, h=720, w=1280, seed=3):
    """Synthetic NV21 frames with a bright target drifting downward."""
    from vacv_tpu.utils.io import bgr2nv21_numpy

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w, 3), dtype=np.uint8)
    target = rng.integers(180, 256, (48, 48, 3), dtype=np.uint8)
    frames, tops = [], []
    for f in range(n_frames):
        bgr = base.copy()
        ty, tx = 80 + 56 * f, 600 + 8 * f
        bgr[ty:ty + 48, tx:tx + 48] = target
        frames.append(bgr2nv21_numpy(bgr).reshape(h * 3 // 2, w))
        tops.append(ty)
    return frames, target, tops


def main():
    import jax
    import jax.numpy as jnp

    import vacv_tpu as vc
    from vacv_tpu.models import preprocess_fused_nv_batch

    h, w = 720, 1280
    frames, target, true_tops = make_stream(h=h, w=w)
    roi_h, out = 320, (224, 224)
    rect0 = vc.VRect(0, 0, w, roi_h)  # runtime `top` moves this window

    tmpl = jax.device_put(jnp.asarray(target))
    est_top = 0
    for i, nv in enumerate(frames):
        nvj = jax.device_put(jnp.asarray(nv))
        # 1. localize the target in the decoded luma-ish frame
        bgr = vc.cvt_color(nvj, vc.COLOR_YUV2BGR_NV21)
        resp = vc.match_template(bgr, tmpl, vc.TM_CCOEFF_NORMED)
        _, score, _, (tx, ty) = vc.min_max_loc(resp)
        ty = int(ty)
        # 2. center the tracking window on the target (clamped);
        #    ONE compiled program serves every position.
        est_top = int(np.clip(ty - (roi_h - 48) // 2, 0, h - roi_h))
        net_in = preprocess_fused_nv_batch(
            nvj[None], rect0, out, top=jnp.int32(est_top))[0]
        print(f"frame {i}: target at y={ty} (truth {true_tops[i]}), "
              f"score={float(score):.3f}, roi_top={est_top}, "
              f"net_in {tuple(net_in.shape)} "
              f"mean={float(jnp.mean(net_in)):+.4f}")
        assert abs(ty - true_tops[i]) <= 2, "tracker lost the target"
    print("tracked", len(frames), "frames with one compiled program")


if __name__ == "__main__":
    main()
