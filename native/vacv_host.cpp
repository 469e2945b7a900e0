// vacv_tpu native host-side utilities.
//
// The device compute path is JAX/XLA; this library is the native
// counterpart of the reference's C++ host layer — the pieces that run on
// the CPU feeding the device: YUV synthesis/decode for camera-format
// inputs (reference: src/util/image_util.cpp:3-41, src/cv/cvt_color.cpp:
// 39-135), dtype staging conversions (reference: src/common/tensor.cpp:
// 297-390) and the cosine-similarity correctness metric (reference:
// src/util/image_util.h:15-32).  Loops are written for compiler
// auto-vectorization (the x86 analogue of the reference's hand-written
// NEON) and parallelized with OpenMP like the reference's row loops.
//
// Built as a plain shared library; Python binds via ctypes
// (vacv_tpu/native/__init__.py).

#include <cstdint>
#include <cstddef>
#include <cmath>
#include <cstdio>
#include <csetjmp>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if defined(VACV_WITH_JPEG)
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decode — the data-loader role (the reference harness feeds itself
// with cv::imread, src/test/src/impl/test_crop.cpp:46).  Two-phase API:
// dims query, then decode into a caller-owned HWC buffer (BGR order for
// cv2 compatibility when bgr != 0).  Returns 0 on success.
#if defined(VACV_WITH_JPEG)
namespace {
struct JerrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};
void jerr_exit(j_common_ptr cinfo) {
    JerrMgr* m = reinterpret_cast<JerrMgr*>(cinfo->err);
    longjmp(m->jb, 1);
}
}  // namespace

int vacv_jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h, int* c) {
    jpeg_decompress_struct cinfo;
    JerrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    *c = 3;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int vacv_decode_jpeg(const uint8_t* buf, size_t len, uint8_t* out, int bgr) {
    jpeg_decompress_struct cinfo;
    JerrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
        if (bgr) {  // swap R<->B in place for cv2-compatible ordering
            for (int x = 0; x < w; x++) {
                uint8_t t = row[x * 3];
                row[x * 3] = row[x * 3 + 2];
                row[x * 3 + 2] = t;
            }
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

int vacv_has_jpeg(void) { return 1; }
#else
int vacv_jpeg_dims(const uint8_t*, size_t, int*, int*, int*) { return -2; }
int vacv_decode_jpeg(const uint8_t*, size_t, uint8_t*, int) { return -2; }
int vacv_has_jpeg(void) { return 0; }
#endif

// ---------------------------------------------------------------------------
// BGR -> NV21 synthesis.  Bit-exact with ImageUtil::bgr2nv21: Q14 integer
// coefficients, unsigned wraparound on (B - Y), even-size requirement.
// Returns 0 on success, -1 on odd sizes.
int vacv_bgr2nv21(const uint8_t* src, uint8_t* dst, int width, int height) {
    if (width % 2 != 0 || height % 2 != 0) return -1;
    const uint32_t B2Y = 1868, G2Y = 9617, R2Y = 4899;
    const uint32_t B2U = 9241, R2V = 11682;
    const uint32_t shift = 14, offset = 128u << shift;

    uint8_t* y_plane = dst;
    uint8_t* vu_plane = dst + (size_t)width * height;

#pragma omp parallel for schedule(static)
    for (int r = 0; r < height; r++) {
        const uint8_t* p = src + (size_t)r * width * 3;
        uint8_t* yrow = y_plane + (size_t)r * width;
        uint8_t* vurow = vu_plane + (size_t)(r / 2) * width;
        for (int c = 0; c < width; c++) {
            uint32_t b = p[0], g = p[1], rr = p[2];
            uint32_t y = (b * B2Y + g * G2Y + rr * R2Y) >> shift;
            yrow[c] = (uint8_t)y;
            if ((r & 1) == 0 && (c & 1) == 0) {
                uint32_t u = ((b - y) * B2U + offset) >> shift;   // mod-2^32
                uint32_t v = ((rr - y) * R2V + offset) >> shift;
                vurow[c] = (uint8_t)v;
                vurow[c + 1] = (uint8_t)u;
            }
            p += 3;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// NV21/NV12 -> interleaved BGR on the host (the data-loader path for
// pipelines whose camera frames arrive as NV buffers but whose device
// entry point wants BGR).  Same Q7 integer math as the device op
// (cvt_color.cpp:76-94): floor-shifts on signed intermediates, clamp.
// is_nv12 != 0 selects U-first chroma order.
void vacv_nv_to_bgr(const uint8_t* y_plane, const uint8_t* vu_plane,
                    uint8_t* dst, int width, int height, int is_nv12) {
#pragma omp parallel for schedule(static)
    for (int r = 0; r < height; r++) {
        const uint8_t* yrow = y_plane + (size_t)r * width;
        const uint8_t* vurow = vu_plane + (size_t)(r / 2) * width;
        uint8_t* out = dst + (size_t)r * width * 3;
        for (int c = 0; c < width; c++) {
            int vu_idx = c & ~1;
            int v = is_nv12 ? vurow[vu_idx + 1] : vurow[vu_idx];
            int u = is_nv12 ? vurow[vu_idx] : vurow[vu_idx + 1];
            v -= 128; u -= 128;
            int ra = (179 * v) >> 7;
            int ga = (44 * u + 91 * v) >> 7;
            int ba = (227 * u) >> 7;
            int y = yrow[c];
            int b = y + ba, g = y - ga, rr = y + ra;
            out[0] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
            out[1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
            out[2] = (uint8_t)(rr < 0 ? 0 : rr > 255 ? 255 : rr);
            out += 3;
        }
    }
}

// ---------------------------------------------------------------------------
// Host staging conversions (reference tensor.cpp:297-390 semantics:
// u8->f32 exact widen; f32->u8 truncate toward zero + saturate).
void vacv_u8_to_f32(const uint8_t* src, float* dst, size_t n) {
#pragma omp parallel for schedule(static)
    for (long long i = 0; i < (long long)n; i++) dst[i] = (float)src[i];
}

void vacv_f32_to_u8(const float* src, uint8_t* dst, size_t n) {
#pragma omp parallel for schedule(static)
    for (long long i = 0; i < (long long)n; i++) {
        int v = (int)src[i];                 // C truncation toward zero
        dst[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

// ---------------------------------------------------------------------------
// Cosine similarity (the correctness metric).  f64 accumulators with the
// reference's 1e-6 epsilon seeds (image_util.h:16-31).
double vacv_cosine_f32(const float* a, const float* b, size_t n) {
    double dot = 1e-6, na = 1e-6, nb = 1e-6;
#pragma omp parallel for reduction(+:dot, na, nb) schedule(static)
    for (long long i = 0; i < (long long)n; i++) {
        double x = a[i], y = b[i];
        dot += x * y;
        na += x * x;
        nb += y * y;
    }
    return dot / std::sqrt(na * nb);
}

double vacv_cosine_u8(const uint8_t* a, const uint8_t* b, size_t n) {
    double dot = 1e-6, na = 1e-6, nb = 1e-6;
#pragma omp parallel for reduction(+:dot, na, nb) schedule(static)
    for (long long i = 0; i < (long long)n; i++) {
        double x = a[i], y = b[i];
        dot += x * y;
        na += x * x;
        nb += y * y;
    }
    return dot / std::sqrt(na * nb);
}

int vacv_native_version(void) { return 1; }

}  // extern "C"
