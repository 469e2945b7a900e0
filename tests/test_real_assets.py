"""Differential tests on the reference's real photographic assets
(``/root/reference/src/test/res`` — the images the reference harness
imreads in every test, src/test/CMakeLists.txt:27-33).  JPEG-decoded
natural images stress chroma subsampling, cubic ringing and warp edges
differently from synthetic gradients; these tests mirror the
reference's harness structure (imread → OpenCV op → our op → cosine)
at the tightened 1e-4 bar.

Skipped when the asset directory isn't mounted.
"""
import os

import numpy as np
import pytest

import vacv_tpu as vc
from vacv_tpu.core.types import Layout
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu.utils.io import bgr2nv21_numpy, nv21_planes

cv2 = pytest.importorskip("cv2")

ASSET_DIR = os.environ.get(
    "VACV_ASSETS", "/root/reference/src/test/res"
)
pytestmark = pytest.mark.skipif(
    not os.path.isdir(ASSET_DIR), reason="reference assets not mounted"
)


def load(name):
    img = cv2.imread(os.path.join(ASSET_DIR, name), 1)
    assert img is not None, name
    return img


@pytest.fixture(scope="module")
def img_720p():
    return load("1280x720.jpg")


@pytest.fixture(scope="module")
def img_1440p():
    return load("2560x1440.jpeg")


def test_crop_real_1440p(img_1440p):
    # the reference's largest asset + its 1280x720 HWC crop case
    # (test_crop.cpp:107-133)
    rect = vc.VRect(640, 360, 640 + 1280, 360 + 720)
    ref = img_1440p[360:1080, 640:1920]
    out = np.asarray(vc.crop(img_1440p, rect).data)
    np.testing.assert_array_equal(out, ref)


def test_resize_bilinear_u8_real(img_1440p):
    # 2560x1440 -> 320x180, the reference's resize test target
    # (test_resize.cpp:24-210)
    out = np.asarray(vc.resize(img_1440p, (320, 180)).data)
    ref = cv2.resize(img_1440p, (320, 180), interpolation=cv2.INTER_LINEAR)
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4


def test_resize_cubic_f32_real(img_720p):
    src = img_720p.astype(np.float32)
    out = np.asarray(
        vc.resize(vc.Image(src, Layout.HWC), (320, 180),
                  interpolation=vc.INTER_CUBIC).data
    )
    ref = cv2.resize(src, (320, 180), interpolation=cv2.INTER_CUBIC)
    assert abs(cosine_similarity(out, ref) - 1) < 1e-6


def test_yuv_roundtrip_real(img_720p):
    # the reference's own cvt_color check: BGR -> NV21 -> BGR vs the
    # original photo (test_cvt_color.cpp:23-57)
    h, w, _ = img_720p.shape
    buf = bgr2nv21_numpy(img_720p).reshape(h * 3 // 2, w)
    out = np.asarray(vc.cvt_color(buf, vc.COLOR_YUV2BGR_NV21).data)
    assert abs(cosine_similarity(out, img_720p.astype(np.float32)) - 1) < 5e-4


def test_yuv_bit_exact_real(img_720p):
    from oracle import nv_to_bgr

    h, w, _ = img_720p.shape
    nv21 = bgr2nv21_numpy(img_720p)
    y, vu = nv21_planes(nv21, w, h)
    ref = nv_to_bgr(y, vu, is_nv12=False)
    out = np.asarray(
        vc.cvt_color(nv21.reshape(h * 3 // 2, w), vc.COLOR_YUV2BGR_NV21).data
    )
    np.testing.assert_array_equal(out, ref)


def test_normalize_real(img_720p):
    src = img_720p.astype(np.float32)
    out = np.asarray(vc.normalize(vc.Image(src, Layout.HWC)).data)
    m, s = cv2.meanStdDev(src)
    ref = (src - m.ravel().astype(np.float32)) / (
        s.ravel().astype(np.float32) + 1e-6
    )
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4


def test_warp_affine_real(img_720p):
    # the reference's fixed test matrix (test_warp_affine.cpp:25-149)
    m = [[0.849158, 0.012257, -474.827], [-0.01225, 0.849158, -379.18]]
    out = np.asarray(
        vc.warp_affine(img_720p, m, (240, 240)).data
    )
    ref = cv2.warpAffine(
        img_720p, np.asarray(m, np.float32), (240, 240),
        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
    )
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4


def test_gray_asset_pipeline():
    grey = cv2.imread(os.path.join(ASSET_DIR, "1280x720_grey.jpg"),
                      cv2.IMREAD_GRAYSCALE)
    assert grey is not None
    out = np.asarray(vc.cvt_color(grey, vc.COLOR_GRAY2BGR).data)
    ref = cv2.cvtColor(grey, cv2.COLOR_GRAY2BGR)
    np.testing.assert_array_equal(out, ref)
    # gray resize path (1-channel 2D image)
    r = np.asarray(vc.resize(vc.Image(grey, Layout.HWC), (320, 180)).data)
    rr = cv2.resize(grey, (320, 180), interpolation=cv2.INTER_LINEAR)
    assert abs(cosine_similarity(r, rr) - 1) < 1e-4


def test_fused_pipeline_real_photo(img_1440p):
    """BASELINE config-4 chain on the 2560x1440 photo vs the cv2 chain."""
    from vacv_tpu.models import PreprocessConfig, Preprocessor

    rect = vc.VRect(64, 28, 64 + 2432, 28 + 1388)
    cfg = PreprocessConfig(crop_rect=rect, out_size=(224, 224))
    x = img_1440p
    out = np.asarray(Preprocessor(cfg)(x))
    crop_ref = x[28 : 28 + 1388, 64 : 64 + 2432]
    resized = cv2.resize(crop_ref, (224, 224)).astype(np.float32)
    m, s = cv2.meanStdDev(resized)
    ref = np.transpose(
        (resized - m.ravel().astype(np.float32))
        / (s.ravel().astype(np.float32) + 1e-6),
        (2, 0, 1),
    )
    assert abs(cosine_similarity(out, ref) - 1) < 1e-4
