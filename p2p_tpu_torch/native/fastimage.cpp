// fastimage: the port's host image path in C++ (counterpart of
// p2p_tpu/native/fastimage.cpp), bound through ctypes by native/__init__.py.
//
//   - png_probe, png_decode: 8-bit RGB/RGBA non-interlaced PNG -> RGB bytes
//     (every chunk's CRC checked, zlib inflate, the five row filters undone,
//     alpha dropped). The formats the port's writer and generate_dataset
//     write; native/__init__.py hands every other PNG to the numpy reader
//     of utils/images.py.
//   - resample_u8: the 8-bit inner loop of Pillow's ImagingResample
//     (ImagingResampleHorizontal_8bpc / Vertical_8bpc) on fixed-point
//     coefficients computed by utils/images.py, so the bytes are Pillow's.
//   - normalize_f32: uint8 -> float32 [-1, 1] as (x - 127.5) * (1 / 127.5).
//
// A plain C interface; no global state, so worker processes and threads
// may call it at once.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- PNG

static uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

static const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

// Reads the first chunk, which a PNG starts with: its IHDR. Returns 0 when
// png_decode reads the image (8-bit colour type 2 or 6, compression,
// filter and interlace methods 0, non-empty), with its size in *w, *h;
// -1 on a bad signature, -2 when the first chunk is not a 13-byte IHDR,
// -3 for any other format.
int png_probe(const uint8_t* data, int64_t size, int64_t* w, int64_t* h) {
    if (size < 8 || std::memcmp(data, kSignature, 8) != 0) return -1;
    if (size < 8 + 8 + 13 || be32(data + 8) != 13 ||
        std::memcmp(data + 12, "IHDR", 4) != 0)
        return -2;
    const uint8_t* body = data + 16;
    *w = be32(body);
    *h = be32(body + 4);
    if (body[8] != 8 || (body[9] != 2 && body[9] != 6) || body[10] != 0 ||
        body[11] != 0 || body[12] != 0 || *w == 0 || *h == 0)
        return -3;
    return 0;
}

// Deflate gives at most 1032 bytes for one byte of compressed data (a
// 258-byte match coded in two bits), so no image data inflates to more
// than kMaxInflate times its size.
static const int64_t kMaxInflate = 1032;

// Decodes a PNG that png_probe accepted into out (h * w * 3 bytes, RGB).
// Returns 0, or: -2 IHDR missing or changed, -4 the image data does not
// inflate, -5 it inflates to the wrong size, -6 a row has an unknown
// filter type, -7 a chunk's CRC is wrong, -8 the file is truncated (inside
// a chunk, or no IEND), -9 out of memory, -10 the IHDR claims more bytes
// than the image data can inflate to (refused before anything of the
// image's size is allocated).
int png_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t w,
               int64_t h) {
    try {
        int ch = 0;
        std::vector<uint8_t> idat;
        int64_t pos = 8;
        bool saw_iend = false;
        while (pos < size) {
            if (pos + 8 > size) return -8;
            const uint32_t len = be32(data + pos);
            const uint8_t* type = data + pos + 4;
            const uint8_t* body = data + pos + 8;
            if (pos + 8 + int64_t(len) + 4 > size) return -8;
            const uint32_t crc = uint32_t(
                crc32(crc32(0L, type, 4), body, len));
            if (crc != be32(body + len)) return -7;
            if (std::memcmp(type, "IHDR", 4) == 0) {
                if (len != 13 || be32(body) != w || be32(body + 4) != h ||
                    body[8] != 8 || (body[9] != 2 && body[9] != 6) ||
                    body[10] != 0 || body[11] != 0 || body[12] != 0)
                    return -2;
                ch = body[9] == 2 ? 3 : 4;
            } else if (std::memcmp(type, "IDAT", 4) == 0) {
                idat.insert(idat.end(), body, body + len);
            } else if (std::memcmp(type, "IEND", 4) == 0) {
                saw_iend = true;
                break;
            }
            pos += 8 + int64_t(len) + 4;
        }
        if (!saw_iend) return -8;
        if (ch == 0) return -2;

        const int64_t stride = w * ch;
        if (h > kMaxInflate * int64_t(idat.size()) / (stride + 1))
            return -10;
        std::vector<uint8_t> raw((stride + 1) * h);
        uLongf raw_len = raw.size();
        if (uncompress(raw.data(), &raw_len, idat.data(), idat.size())
                != Z_OK)
            return -4;
        if (int64_t(raw_len) != int64_t(raw.size())) return -5;

        std::vector<uint8_t> prev(stride, 0);
        std::vector<uint8_t> cur(stride);
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t* row = raw.data() + y * (stride + 1);
            const uint8_t* src = row + 1;
            switch (row[0]) {
                case 0:
                    std::memcpy(cur.data(), src, stride);
                    break;
                case 1:  // Sub
                    for (int64_t i = 0; i < stride; ++i)
                        cur[i] = src[i] + (i >= ch ? cur[i - ch] : 0);
                    break;
                case 2:  // Up
                    for (int64_t i = 0; i < stride; ++i)
                        cur[i] = src[i] + prev[i];
                    break;
                case 3:  // Average
                    for (int64_t i = 0; i < stride; ++i) {
                        int a = i >= ch ? cur[i - ch] : 0;
                        cur[i] = src[i] + ((a + prev[i]) >> 1);
                    }
                    break;
                case 4:  // Paeth
                    for (int64_t i = 0; i < stride; ++i) {
                        int a = i >= ch ? cur[i - ch] : 0;
                        int c = i >= ch ? prev[i - ch] : 0;
                        cur[i] = src[i] + paeth(a, prev[i], c);
                    }
                    break;
                default:
                    return -6;
            }
            uint8_t* dst = out + y * w * 3;
            if (ch == 3) {
                std::memcpy(dst, cur.data(), stride);
            } else {
                for (int64_t x = 0; x < w; ++x) {
                    dst[x * 3 + 0] = cur[x * 4 + 0];
                    dst[x * 3 + 1] = cur[x * 4 + 1];
                    dst[x * 3 + 2] = cur[x * 4 + 2];
                }
            }
            std::swap(prev, cur);
        }
        return 0;
    } catch (const std::bad_alloc&) {
        return -9;
    }
}

// ------------------------------------------------------------- resample

// Pillow's PRECISION_BITS for 8-bit images
static const int kPrecisionBits = 32 - 8 - 2;

static inline uint8_t clip8(int64_t acc) {
    const int64_t v = acc >> kPrecisionBits;
    return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// One pass of Pillow's 8-bit resample along ``axis`` (1: width, 0:
// height) of the uint8 (h, w, c) image src into dst: output index j sums
// src[xmin[j] + k] * coeffs[j * ksize + k] for k < count[j], starting from
// half of 2^22, then shifts right by 22 bits and clamps to 0..255.
// Returns 0, or -1 for an axis other than 0 and 1.
int resample_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                int axis, int64_t out_size, const int64_t* xmin,
                const int64_t* count, const int64_t* coeffs, int64_t ksize,
                uint8_t* dst) {
    const int64_t half = int64_t(1) << (kPrecisionBits - 1);
    if (axis == 1) {
        std::vector<int64_t> acc(c);
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t* row = src + y * w * c;
            uint8_t* out = dst + y * out_size * c;
            for (int64_t j = 0; j < out_size; ++j) {
                const int64_t* k = coeffs + j * ksize;
                const uint8_t* px = row + xmin[j] * c;
                std::fill(acc.begin(), acc.end(), half);
                for (int64_t t = 0; t < count[j]; ++t)
                    for (int64_t ci = 0; ci < c; ++ci)
                        acc[ci] += int64_t(px[t * c + ci]) * k[t];
                for (int64_t ci = 0; ci < c; ++ci)
                    out[j * c + ci] = clip8(acc[ci]);
            }
        }
        return 0;
    }
    if (axis == 0) {
        const int64_t n = w * c;
        std::vector<int64_t> acc(n);
        for (int64_t j = 0; j < out_size; ++j) {
            const int64_t* k = coeffs + j * ksize;
            std::fill(acc.begin(), acc.end(), half);
            for (int64_t t = 0; t < count[j]; ++t) {
                const uint8_t* row = src + (xmin[j] + t) * n;
                const int64_t kt = k[t];
                for (int64_t i = 0; i < n; ++i) acc[i] += int64_t(row[i]) * kt;
            }
            uint8_t* out = dst + j * n;
            for (int64_t i = 0; i < n; ++i) out[i] = clip8(acc[i]);
        }
        return 0;
    }
    return -1;
}

// ------------------------------------------------------------ normalize

// uint8 -> float32 in [-1, 1] as (x - 127.5) * (1 / 127.5): the subtraction
// is exact in f32, so there is one rounding, and no multiply-add a compiler
// could contract into an FMA that rounds differently. The expression of
// data/pipeline.py and utils/images.ingest, bit for bit.
void normalize_f32(const uint8_t* src, float* dst, int64_t n) {
    constexpr float k = 1.0f / 127.5f;
    for (int64_t i = 0; i < n; ++i) dst[i] = (src[i] - 127.5f) * k;
}

}  // extern "C"
