// Host decoders of the image containers other than JPEG and PNG, the
// bit-level half of tpu3dlm_torch/data/containers.py: each entry point
// takes a byte range that Python has located by the container's headers
// and returns samples or indices, held to what cv2 5.0 returns for the same
// file (its own grfmt_pxm, grfmt_bmp, grfmt_hdr and grfmt_gif
// decoders, and libtiff 4.7 for TIFF):
// - PNM text samples read as cv2's ReadNumber reads them;
// - BMP RLE4 / RLE8 as cv2's BmpDecoder walks them, skipped pixels filled
//   with palette entry 0;
// - TIFF LZW (new and old bit order) and PackBits strips, as libtiff;
// - Radiance RGBE scanlines (flat, or the new run-length form; the old form
//   is read flat, as rgbe.cpp reads it) and GIF LZW.
//
// Built by tpu3dlm_torch/kernels/build.py with the system C++ compiler
// (c++ -O3 -shared -fPIC) and called through ctypes. Every entry point has
// a plain C interface, touches only the buffers it is given and keeps no
// state, so calls run in parallel on a thread pool (ctypes releases the
// GIL). Return codes: 0 or a count on success, negative on a refusal.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool is_space(int c) { return c == ' ' || (c >= '\t' && c <= '\r'); }
inline bool is_digit(int c) { return c >= '0' && c <= '9'; }

}  // namespace

extern "C" {

// cv2's PxM ReadNumber, count times from data[*pos]: whitespace and '#'
// comments (to the end of the line) are skipped, any other non-digit is an
// error, and the byte after the digits is consumed; maxdigits 1 reads one
// digit and consumes nothing after it (P1). A number above INT_MAX is an
// error. Returns 0 and advances *pos, -1 on a bad character or number, -2
// when the data ends first (cv2's stream throws at its end).
int tl_pnm_ascii(const uint8_t* data, size_t len, size_t* pos, size_t count, int maxdigits, int32_t* out) {
    size_t p = *pos;
    for (size_t i = 0; i < count; i++) {
        if (p >= len) return -2;
        int code = data[p++];
        while (!is_digit(code)) {
            if (code == '#') {
                do {
                    if (p >= len) return -2;
                    code = data[p++];
                } while (code != '\n' && code != '\r');
                if (p >= len) return -2;
                code = data[p++];
            } else if (is_space(code)) {
                while (is_space(code)) {
                    if (p >= len) return -2;
                    code = data[p++];
                }
            } else {
                return -1;
            }
        }
        int64_t val = 0;
        int digits = 0;
        for (;;) {
            val = val * 10 + (code - '0');
            if (val > INT32_MAX) return -1;
            digits++;
            if (maxdigits != 0 && digits >= maxdigits) break;
            if (p >= len) return -2;
            code = data[p++];
            if (!is_digit(code)) break;
        }
        out[i] = static_cast<int32_t>(val);
    }
    *pos = p;
    return 0;
}

// cv2's BmpDecoder RLE4 (bits 4) or RLE8 (bits 8) loop over data, into out
// (height rows of width * nch bytes, in the order the stream fills them:
// Python flips a bottom-up file). nch 3 writes palette_bgr (256 entries of
// B, G, R), nch 1 the gray image through gray[index]. Escapes: 0 ends the line,
// 1 the bitmap, 2 is a delta (dx, dy); each fills the pixels it skips with
// entry 0 (in RLE4, as cv2 has it, an end of bitmap or a delta fills only
// to the end of the line or dx pixels, so the stream must go on). Returns 0 when the bitmap ends, -1 where cv2 gives up (a run past
// the line's end: "decode_rle_bad"), -2 when the data ends first.
int tl_bmp_rle(const uint8_t* data, size_t len, int bits, int width, int height, int nch, const uint8_t* palette_bgr,
               const uint8_t* gray, uint8_t* out) {
    const int width3 = width * nch;
    const int64_t step = width3;
    size_t p = 0;
    int y = 0;
    uint8_t* d = out;
    uint8_t* line_end = out + width3;
    int line_end_flag = 0;
    auto put = [&](uint8_t* at, int index) {
        if (nch == 3) {
            at[0] = palette_bgr[3 * index];
            at[1] = palette_bgr[3 * index + 1];
            at[2] = palette_bgr[3 * index + 2];
        } else {
            at[0] = gray[index];
        }
    };
    // FillUniColor / FillUniGray: count3 bytes of entry index, wrapping to
    // the next line at line_end; stops once y reaches height.
    auto fill = [&](int count3, int index) {
        do {
            uint8_t* end = d + count3;
            if (end > line_end) end = line_end;
            count3 -= static_cast<int>(end - d);
            for (; d < end; d += nch) put(d, index);
            if (d >= line_end) {
                line_end += step;
                d = line_end - width3;
                if (++y >= height) break;
            }
        } while (count3 > 0);
    };
    for (;;) {
        if (p + 2 > len) return -2;
        int code = data[p] | (data[p + 1] << 8);
        p += 2;
        int n = code & 255;
        code >>= 8;
        if (n != 0) {  // encoded mode
            int prev_y = y;
            if (bits == 8) {
                if (d + n * nch > line_end) return -1;
                fill(n * nch, code);
                line_end_flag = y - prev_y;
                if (y >= height) break;
            } else {
                int idx[2] = {code >> 4, code & 15};
                uint8_t* end = d + n * nch;
                if (end > line_end) return -1;
                int t = 0;
                do {
                    put(d, idx[t]);
                    t ^= 1;
                } while ((d += nch) < end);
                line_end_flag = y - prev_y;
            }
        } else if (code > 2) {  // absolute mode
            int prev_y = y;
            if (d + code * nch > line_end) return -1;
            size_t sz = bits == 8 ? static_cast<size_t>((code + 1) & ~1) : static_cast<size_t>((((code + 1) >> 1) + 1) & ~1);
            if (p + sz > len) return -2;
            const uint8_t* s = data + p;
            p += sz;
            for (int i = 0; i < code; i++, d += nch) {
                int index = bits == 8 ? s[i] : ((i & 1) ? (s[i >> 1] & 15) : (s[i >> 1] >> 4));
                put(d, index);
            }
            line_end_flag = y - prev_y;
        } else {  // escapes
            int x_shift3 = static_cast<int>(line_end - d);
            int y_shift = height - y;
            // RLE8 skips an end of line that follows a run which ended the line
            if (bits == 4 || code || !line_end_flag || x_shift3 < width3) {
                if (code == 2) {
                    if (p + 2 > len) return -2;
                    x_shift3 = data[p] * nch;
                    y_shift = data[p + 1];
                    p += 2;
                }
                // RLE8 moves dy lines more on a delta and to the last line on an
                // end of bitmap; cv2's RLE4 fills only to the line's end (or dx)
                if (bits == 8) x_shift3 += (y_shift * width3) & ((code == 0) - 1);
                if (y >= height) break;
                fill(x_shift3, 0);
                if (y >= height) break;
            }
            line_end_flag = 0;
            if (y >= height) break;
        }
    }
    return 0;
}

// libtiff's LZWDecode of one strip or tile into out (n bytes): codes MSB
// first from 9 to 12 bits, the width growing one entry early (at 511, 1023,
// 2047), Clear (256) and EOI (257). A stream that starts 00 01 is the old
// LSB-first form (LZWDecodeCompat: the width grows at 512, 1024, 2048).
// Returns the bytes written (n when complete, fewer when the data or EOI
// came first), or -1 for a code not yet in the table.
int64_t tl_tiff_lzw(const uint8_t* data, size_t len, uint8_t* out, size_t n) {
    const bool compat = len >= 2 && data[0] == 0 && (data[1] & 1);
    std::vector<uint16_t> prefix(4096);
    std::vector<uint8_t> suffix(4096), first(4096);
    std::vector<uint16_t> length(4096);
    for (int i = 0; i < 256; i++) {
        suffix[static_cast<size_t>(i)] = first[static_cast<size_t>(i)] = static_cast<uint8_t>(i);
        length[static_cast<size_t>(i)] = 1;
    }
    size_t bitpos = 0, o = 0;
    const size_t nbits_total = len * 8;
    int nbits = 9, free_ent = 258, oldcode = -1;
    auto next_code = [&]() -> int {
        if (bitpos + static_cast<size_t>(nbits) > nbits_total) return 257;  // data ends: as an EOI
        int code = 0;
        if (compat) {
            for (int b = 0; b < nbits; b++, bitpos++) code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
        } else {
            for (int b = 0; b < nbits; b++, bitpos++) code = (code << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        }
        return code;
    };
    auto emit = [&](int code) {
        size_t l = length[static_cast<size_t>(code)];
        size_t start = o;
        size_t end = o + l;
        size_t k = end;
        int c = code;
        while (k > start) {
            --k;
            if (k < n) out[k] = suffix[static_cast<size_t>(c)];
            c = prefix[static_cast<size_t>(c)];
        }
        o = end < n ? end : n;
        return end;
    };
    const int early = compat ? 0 : 1;
    while (o < n) {
        int code = next_code();
        if (code == 257) break;
        if (code == 256) {
            free_ent = 258;
            nbits = 9;
            code = next_code();
            if (code == 257) break;
            if (code > 256) return -1;
            out[o++] = static_cast<uint8_t>(code);
            oldcode = code;
            continue;
        }
        if (oldcode < 0) return -1;  // the first code must follow a Clear
        if (code > free_ent || free_ent >= 4096) return -1;
        if (code == free_ent) {  // KwKwK: the old string and its first byte
            prefix[static_cast<size_t>(free_ent)] = static_cast<uint16_t>(oldcode);
            suffix[static_cast<size_t>(free_ent)] = first[static_cast<size_t>(oldcode)];
        } else {
            prefix[static_cast<size_t>(free_ent)] = static_cast<uint16_t>(oldcode);
            suffix[static_cast<size_t>(free_ent)] = first[static_cast<size_t>(code)];
        }
        first[static_cast<size_t>(free_ent)] = first[static_cast<size_t>(oldcode)];
        length[static_cast<size_t>(free_ent)] = static_cast<uint16_t>(length[static_cast<size_t>(oldcode)] + 1);
        free_ent++;
        if (free_ent > (1 << nbits) - 1 - early && nbits < 12) nbits++;
        emit(code);
        oldcode = code;
    }
    return static_cast<int64_t>(o);
}

// PackBits (TIFF compression 32773) into out (n bytes): a count byte c,
// then c + 1 literal bytes (c < 128) or one byte repeated 257 - c times
// (c > 128); 128 is skipped. Returns the bytes written.
int64_t tl_packbits(const uint8_t* data, size_t len, uint8_t* out, size_t n) {
    size_t p = 0, o = 0;
    while (p < len && o < n) {
        int c = static_cast<int8_t>(data[p++]);
        if (c >= 0) {
            size_t k = static_cast<size_t>(c) + 1;
            if (p + k > len) k = len - p;
            if (o + k > n) k = n - o;
            std::memcpy(out + o, data + p, k);
            p += static_cast<size_t>(c) + 1;
            o += k;
        } else if (c != -128) {
            if (p >= len) break;
            size_t k = static_cast<size_t>(1 - c);
            if (o + k > n) k = n - o;
            std::memset(out + o, data[p++], k);
            o += k;
        }
    }
    return static_cast<int64_t>(o);
}

// rgbe.cpp's RGBE_ReadPixels_RLE (the reader cv2's HdrDecoder calls) into
// out (height * width RGBE quadruples): scanlines of width 8 to 32767 that
// start 2 2 hi lo are the new run-length form (four channel runs: n > 128
// repeats the next byte n - 128 times, else n literal bytes); anything else
// is read flat from that pixel on, 4 bytes a pixel (the old run-length form
// is not undone). Returns 0, -1 for a bad scanline (width or run), -2 when
// the data ends first.
int tl_hdr_rgbe(const uint8_t* data, size_t len, int width, int height, uint8_t* out) {
    size_t p = 0;
    const size_t total = static_cast<size_t>(width) * height * 4;
    auto flat = [&](size_t from) -> int {
        size_t need = total - from;
        if (p + need > len) return -2;
        std::memcpy(out + from, data + p, need);
        return 0;
    };
    if (width < 8 || width > 0x7fff) return flat(0);
    std::vector<uint8_t> line(static_cast<size_t>(width) * 4);
    for (int y = 0; y < height; y++) {
        if (p + 4 > len) return -2;
        const uint8_t* q = data + p;
        if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {
            p += 4;
            size_t at = static_cast<size_t>(y) * width * 4;
            std::memcpy(out + at, q, 4);
            return flat(at + 4);
        }
        if (((q[2] << 8) | q[3]) != width) return -1;
        p += 4;
        size_t ptr = 0;
        for (int c = 0; c < 4; c++) {
            const size_t end = static_cast<size_t>(c + 1) * width;
            while (ptr < end) {
                if (p + 2 > len) return -2;
                int n = data[p], v = data[p + 1];
                p += 2;
                if (n > 128) {
                    n -= 128;
                    if (static_cast<size_t>(n) > end - ptr) return -1;
                    std::memset(&line[ptr], v, static_cast<size_t>(n));
                    ptr += static_cast<size_t>(n);
                } else {
                    if (n == 0 || static_cast<size_t>(n) > end - ptr) return -1;
                    line[ptr++] = static_cast<uint8_t>(v);
                    size_t rest = static_cast<size_t>(n) - 1;
                    if (rest) {
                        if (p + rest > len) return -2;
                        std::memcpy(&line[ptr], data + p, rest);
                        p += rest;
                        ptr += rest;
                    }
                }
            }
        }
        uint8_t* o = out + static_cast<size_t>(y) * width * 4;
        for (int i = 0; i < width; i++) {
            for (int c = 0; c < 4; c++) o[4 * i + c] = line[static_cast<size_t>(c) * width + i];
        }
    }
    return 0;
}

// GIF LZW of one image's data (its sub-blocks joined) into out (n
// indices): codes LSB first from min_size + 1 bits, Clear resets the table,
// End stops; the width grows when the next free code reaches 1 << width, up
// to 12 bits, where the table stops growing until a Clear. Returns the
// indices written, or -1 for a code past the next free one.
int64_t tl_gif_lzw(const uint8_t* data, size_t len, int min_size, uint8_t* out, size_t n) {
    const int clear = 1 << min_size, end = clear + 1;
    std::vector<uint16_t> prefix(4096);
    std::vector<uint8_t> suffix(4096), first(4096);
    std::vector<uint16_t> length(4096);
    for (int i = 0; i < clear; i++) {
        suffix[static_cast<size_t>(i)] = first[static_cast<size_t>(i)] = static_cast<uint8_t>(i);
        length[static_cast<size_t>(i)] = 1;
    }
    size_t bitpos = 0, o = 0;
    const size_t nbits_total = len * 8;
    int width = min_size + 1, next = end + 1, old = -1;
    while (o < n) {
        if (bitpos + static_cast<size_t>(width) > nbits_total) break;
        int code = 0;
        for (int b = 0; b < width; b++, bitpos++) code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
        if (code == clear) {
            width = min_size + 1;
            next = end + 1;
            old = -1;
            continue;
        }
        if (code == end) break;
        if (code > next || (code == next && old < 0)) return -1;
        if (old >= 0 && next < 4096) {
            prefix[static_cast<size_t>(next)] = static_cast<uint16_t>(old);
            suffix[static_cast<size_t>(next)] = first[static_cast<size_t>(code == next ? old : code)];
            first[static_cast<size_t>(next)] = first[static_cast<size_t>(old)];
            length[static_cast<size_t>(next)] = static_cast<uint16_t>(length[static_cast<size_t>(old)] + 1);
            next++;
            if (next == (1 << width) && width < 12) width++;
        }
        size_t l = length[static_cast<size_t>(code)];
        size_t k = o + l;
        int c = code;
        while (k > o) {
            --k;
            if (k < n) out[k] = suffix[static_cast<size_t>(c)];
            c = prefix[static_cast<size_t>(c)];
        }
        o = o + l < n ? o + l : n;
        old = code;
    }
    return static_cast<int64_t>(o);
}

}  // extern "C"
