// Host image codecs of the port: baseline JPEG decode, PNG unfilter and
// cv2-compatible INTER_LINEAR resize of uint8 images.
//
// Built by tpu3dlm_torch/kernels/build.py with the system C++ compiler
// (c++ -O3 -shared -fPIC) and called through ctypes from
// tpu3dlm_torch/data/codecs.py, which parses PNG chunks, inflates IDAT with
// zlib and writes PNGs. Every entry point has a plain C interface, touches
// only the buffers it is given and keeps no state, so calls run in parallel
// on a thread pool (ctypes releases the GIL).
//
// The JPEG path reproduces libjpeg-turbo's default decode bit for bit:
// the integer "islow" IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
// range limit), fancy upsampling (jdsample.c: h2v1, h1v2, h2v2 triangle
// filters, replication for widths of 2 or less) and jdcolor.c's
// fixed-point YCbCr->RGB (SCALEBITS 16). It decodes sequential Huffman
// JPEG (SOF0/SOF1, 8-bit, 1 or 3 components, sampling factors up to 2x2,
// interleaved or not, restart markers). Everything else is refused with a
// message, never decoded approximately.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <type_traits>
#include <vector>

namespace {

struct DecodeError {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

void copy_message(const std::string& msg, char* err, int errlen) {
    if (err && errlen > 0) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
    }
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
    bool defined = false;
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    // 8-bit lookahead: length (0 = slow path) and symbol
    uint8_t look_len[256] = {};
    uint8_t look_sym[256] = {};
};

void build_huff(HuffTable& t, const uint8_t* bits /* [1..16] */, const uint8_t* vals, int nvals) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < bits[l]; i++) huffsize[p++] = static_cast<uint8_t>(l);
    }
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1u << si)) fail("bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (bits[l]) {
            t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
            p += bits[l];
            t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0xFFFFF;
    std::memset(t.look_len, 0, sizeof(t.look_len));
    p = 0;
    for (int l = 1; l <= 8; l++) {
        for (int i = 0; i < bits[l]; i++, p++) {
            int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
            for (int ctr = 1 << (8 - l); ctr > 0; ctr--, lookbits++) {
                t.look_len[lookbits] = static_cast<uint8_t>(l);
                t.look_sym[lookbits] = vals[p];
            }
        }
    }
    std::memcpy(t.vals, vals, static_cast<size_t>(nvals));
    t.defined = true;
}

// Entropy-coded segment reader. Byte stuffing (FF 00) is undone; at a marker
// the reader stops and feeds zero bits, as libjpeg does, but any zero bit
// that is actually consumed makes the data truncated or corrupt.
struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t pos;
    uint64_t buf = 0;
    int count = 0;
    int fake = 0;  // zero bits fed after a marker, at the low end of buf
    bool at_marker = false;

    void fill() {
        while (count <= 56) {
            uint8_t byte = 0;
            if (!at_marker) {
                if (pos >= len) {
                    at_marker = true;
                } else if (data[pos] == 0xFF) {
                    if (pos + 1 < len && data[pos + 1] == 0x00) {
                        byte = 0xFF;
                        pos += 2;
                    } else {
                        at_marker = true;
                    }
                } else {
                    byte = data[pos++];
                }
            }
            if (at_marker) fake += 8;
            buf |= static_cast<uint64_t>(byte) << (56 - count);
            count += 8;
        }
    }
    void consume(int n) {
        buf <<= n;
        count -= n;
        if (count < fake) fail("entropy-coded data ends early (truncated or corrupt)");
    }
    int get_bits(int n) {
        if (n == 0) return 0;
        if (count < n) fill();
        int v = static_cast<int>(buf >> (64 - n));
        consume(n);
        return v;
    }
    int decode(const HuffTable& t) {
        if (count < 16) fill();
        int look = static_cast<int>(buf >> 56);
        int l = t.look_len[look];
        if (l) {
            consume(l);
            return t.look_sym[look];
        }
        l = 9;
        int32_t code = static_cast<int32_t>(buf >> (64 - 9));
        while (l <= 16 && code > t.maxcode[l]) {
            l++;
            code = static_cast<int32_t>(buf >> (64 - l));
        }
        if (l > 16) fail("bad Huffman code (corrupt data)");
        consume(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    // Discard the partial byte and expect RSTn (restart) next.
    void restart(int expected) {
        buf = 0;
        count = 0;
        fake = 0;
        at_marker = false;
        // skip what is left of the interval (libjpeg discards it too) and
        // the fill bytes before the marker
        while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)) pos++;
        if (pos + 1 >= len || data[pos + 1] != 0xD0 + expected) {
            fail("missing restart marker (corrupt data)");
        }
        pos += 2;
    }
};

inline int huff_extend(int x, int s) { return x < (1 << (s - 1)) ? x + ((-1) << s) + 1 : x; }

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int width = 0, height = 0;          // downsampled size
    int bw = 0, bh = 0;                 // allocated blocks (MCU-padded)
    std::vector<int16_t> coef;          // bw*bh*64, natural order
    uint16_t quant[64] = {};
    bool quant_latched = false;
    int dc_pred = 0;
};

struct Jpeg {
    int width = 0, height = 0, ncomp = 0;
    int hmax = 1, vmax = 1;
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;
    bool have_frame = false;
    Component comp[3];
    uint16_t qt[4][64] = {};
    bool qt_defined[4] = {};
    HuffTable dc[4], ac[4];
};

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

void parse_frame(Jpeg& j, const uint8_t* p, int n, int marker) {
    if (n < 6) fail("short SOF segment");
    if (p[0] != 8) fail(std::to_string(p[0]) + "-bit JPEG is not supported (8-bit only)");
    j.height = be16(p + 1);
    j.width = be16(p + 3);
    j.ncomp = p[5];
    if (j.height == 0) fail("JPEG with a DNL height is not supported");
    if (j.width == 0) fail("JPEG of width 0");
    if (j.ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not supported");
    if (j.ncomp != 1 && j.ncomp != 3) fail(std::to_string(j.ncomp) + "-component JPEG is not supported");
    if (n < 6 + 3 * j.ncomp) fail("short SOF segment");
    (void)marker;
    j.hmax = j.vmax = 1;
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        cp.id = p[6 + 3 * c];
        cp.h = p[7 + 3 * c] >> 4;
        cp.v = p[7 + 3 * c] & 15;
        cp.tq = p[8 + 3 * c];
        if (cp.h < 1 || cp.h > 2 || cp.v < 1 || cp.v > 2) fail("sampling factors above 2x2 are not supported");
        if (cp.tq > 3) fail("bad quantization table index");
        j.hmax = cp.h > j.hmax ? cp.h : j.hmax;
        j.vmax = cp.v > j.vmax ? cp.v : j.vmax;
    }
    int mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    int mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        cp.width = (j.width * cp.h + j.hmax - 1) / j.hmax;
        cp.height = (j.height * cp.v + j.vmax - 1) / j.vmax;
        cp.bw = mcux * cp.h;
        cp.bh = mcuy * cp.v;
        cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
    }
    j.have_frame = true;
}

void decode_block(BitReader& br, Component& cp, const HuffTable& dct, const HuffTable& act, int16_t* block) {
    int s = br.decode(dct);
    if (s) {
        if (s > 11) fail("bad DC difference (corrupt data)");
        int r = br.get_bits(s);
        s = huff_extend(r, s);
    }
    cp.dc_pred += s;
    block[0] = static_cast<int16_t>(cp.dc_pred);
    for (int k = 1; k < 64; k++) {
        s = br.decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            if (k > 63) fail("AC coefficient index past 63 (corrupt data)");
            r = br.get_bits(s);
            block[kNaturalOrder[k]] = static_cast<int16_t>(huff_extend(r, s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

// Returns the position just after the scan's entropy-coded data.
size_t decode_scan(Jpeg& j, const uint8_t* data, size_t len, size_t pos, const uint8_t* sos, int n) {
    if (!j.have_frame) fail("SOS before SOF");
    if (n < 1) fail("short SOS segment");
    int ns = sos[0];
    if (ns < 1 || ns > j.ncomp || n < 1 + 2 * ns + 3) fail("bad SOS segment");
    Component* sc[3];
    int dct[3], act[3];
    for (int i = 0; i < ns; i++) {
        int cid = sos[1 + 2 * i];
        int c = 0;
        while (c < j.ncomp && j.comp[c].id != cid) c++;
        if (c == j.ncomp) fail("SOS names an unknown component");
        sc[i] = &j.comp[c];
        dct[i] = sos[2 + 2 * i] >> 4;
        act[i] = sos[2 + 2 * i] & 15;
        if (dct[i] > 3 || act[i] > 3 || !j.dc[dct[i]].defined || !j.ac[act[i]].defined) {
            fail("SOS uses an undefined Huffman table");
        }
    }
    int ss = sos[1 + 2 * ns], se = sos[2 + 2 * ns], ahal = sos[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) fail("progressive scan parameters in a sequential JPEG");
    for (int i = 0; i < ns; i++) {
        Component& cp = *sc[i];
        if (!cp.quant_latched) {
            if (!j.qt_defined[cp.tq]) fail("component uses an undefined quantization table");
            std::memcpy(cp.quant, j.qt[cp.tq], sizeof(cp.quant));
            cp.quant_latched = true;
        }
        cp.dc_pred = 0;
    }
    BitReader br{data, len, pos};
    int mcus_x, mcus_y;
    if (ns == 1) {
        mcus_x = (sc[0]->width + 7) / 8;
        mcus_y = (sc[0]->height + 7) / 8;
    } else {
        mcus_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
        mcus_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
    }
    int total = mcus_x * mcus_y;
    int restarts = 0, todo = j.restart_interval;
    for (int m = 0; m < total; m++) {
        if (j.restart_interval) {
            if (todo == 0) {
                br.restart(restarts & 7);
                restarts++;
                todo = j.restart_interval;
                for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
            }
            todo--;
        }
        int mx = m % mcus_x, my = m / mcus_x;
        if (ns == 1) {
            Component& cp = *sc[0];
            int16_t* blk = &cp.coef[(static_cast<size_t>(my) * cp.bw + mx) * 64];
            decode_block(br, cp, j.dc[dct[0]], j.ac[act[0]], blk);
        } else {
            for (int i = 0; i < ns; i++) {
                Component& cp = *sc[i];
                for (int by = 0; by < cp.v; by++) {
                    for (int bx = 0; bx < cp.h; bx++) {
                        size_t row = static_cast<size_t>(my) * cp.v + by;
                        size_t col = static_cast<size_t>(mx) * cp.h + bx;
                        decode_block(br, cp, j.dc[dct[i]], j.ac[act[i]], &cp.coef[(row * cp.bw + col) * 64]);
                    }
                }
            }
        }
    }
    // The bit buffer may hold bytes read past the last MCU: step back to
    // the first unread byte of the segment, then scan for the next marker.
    size_t p = br.pos;
    while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF)) p++;
    return p;
}

// jidctint.c jpeg_idct_islow, with dequantization and the range limit.
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// range_limit[x & 1023] of jdmaster.c's post-IDCT table.
inline uint8_t idct_limit(int64_t x) {
    int v = static_cast<int>(x & 1023);
    if (v < 128) return static_cast<uint8_t>(v + 128);
    if (v < 512) return 255;
    if (v < 896) return 0;
    return static_cast<uint8_t>(v - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
            ip[56] == 0) {
            int dcval = static_cast<int>(int64_t(ip[0]) * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
            continue;
        }
        int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
        wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
        wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
        wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
        wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
        wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
        wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
        wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    for (int r = 0; r < 8; r++) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + static_cast<size_t>(r) * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t dcval = idct_limit(descale(wp[0], PASS1_BITS + 3));
            for (int c = 0; c < 8; c++) op[c] = dcval;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = idct_limit(descale(tmp10 + tmp3, sh));
        op[7] = idct_limit(descale(tmp10 - tmp3, sh));
        op[1] = idct_limit(descale(tmp11 + tmp2, sh));
        op[6] = idct_limit(descale(tmp11 - tmp2, sh));
        op[2] = idct_limit(descale(tmp12 + tmp1, sh));
        op[5] = idct_limit(descale(tmp12 - tmp1, sh));
        op[3] = idct_limit(descale(tmp13 + tmp0, sh));
        op[4] = idct_limit(descale(tmp13 - tmp0, sh));
    }
}

// One component's samples upsampled to (out_h, out_w) >= the image size,
// as libjpeg-turbo's jdsample.c does with do_fancy_upsampling on.
std::vector<uint8_t> upsample(const Component& cp, const std::vector<uint8_t>& plane, int hmax, int vmax,
                              int out_w, int out_h) {
    const int pw = cp.bw * 8;
    const int rx = hmax / cp.h, ry = vmax / cp.v;
    std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h);
    const int W = cp.width, H = cp.height;
    auto row = [&](int r) {
        r = r < 0 ? 0 : (r >= H ? H - 1 : r);
        return plane.data() + static_cast<size_t>(r) * pw;
    };
    if (rx == 1 && ry == 1) {
        for (int y = 0; y < out_h; y++) std::memcpy(&out[static_cast<size_t>(y) * out_w], row(y), out_w);
        return out;
    }
    if (rx == 2 && ry == 1 && W > 2) {  // h2v1_fancy_upsample
        std::vector<uint8_t> tmp(static_cast<size_t>(2 * W));
        for (int y = 0; y < out_h; y++) {
            const uint8_t* in = row(y);
            uint8_t* o = &out[static_cast<size_t>(y) * out_w];
            tmp[0] = in[0];
            tmp[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
            for (int c = 1; c < W - 1; c++) {
                int v3 = in[c] * 3;
                tmp[2 * c] = static_cast<uint8_t>((v3 + in[c - 1] + 1) >> 2);
                tmp[2 * c + 1] = static_cast<uint8_t>((v3 + in[c + 1] + 2) >> 2);
            }
            tmp[2 * W - 2] = static_cast<uint8_t>((in[W - 1] * 3 + in[W - 2] + 1) >> 2);
            tmp[2 * W - 1] = in[W - 1];
            std::memcpy(o, tmp.data(), out_w);
        }
        return out;
    }
    if (rx == 1 && ry == 2) {  // h1v2_fancy_upsample
        for (int y = 0; y < out_h; y++) {
            int in_r = y / 2;
            bool below = y & 1;
            const uint8_t* i0 = row(in_r);
            const uint8_t* i1 = row(below ? in_r + 1 : in_r - 1);
            int bias = below ? 2 : 1;
            uint8_t* o = &out[static_cast<size_t>(y) * out_w];
            for (int c = 0; c < out_w; c++) o[c] = static_cast<uint8_t>((i0[c] * 3 + i1[c] + bias) >> 2);
        }
        return out;
    }
    if (rx == 2 && ry == 2 && W > 2) {  // h2v2_fancy_upsample
        std::vector<uint8_t> tmp(static_cast<size_t>(2 * W));
        for (int y = 0; y < out_h; y++) {
            int in_r = y / 2;
            bool below = y & 1;
            const uint8_t* i0 = row(in_r);
            const uint8_t* i1 = row(below ? in_r + 1 : in_r - 1);
            int thiscol = i0[0] * 3 + i1[0];
            int nextcol = i0[1] * 3 + i1[1];
            tmp[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
            tmp[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            int lastcol = thiscol;
            thiscol = nextcol;
            for (int c = 2; c < W; c++) {
                nextcol = i0[c] * 3 + i1[c];
                tmp[2 * c - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
                tmp[2 * c - 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
                lastcol = thiscol;
                thiscol = nextcol;
            }
            tmp[2 * W - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            tmp[2 * W - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
            std::memcpy(&out[static_cast<size_t>(y) * out_w], tmp.data(), out_w);
        }
        return out;
    }
    // replication (h2v1/h2v2 of widths <= 2, and the generic int_upsample)
    for (int y = 0; y < out_h; y++) {
        const uint8_t* in = plane.data() + static_cast<size_t>(y / ry) * pw;
        uint8_t* o = &out[static_cast<size_t>(y) * out_w];
        for (int c = 0; c < out_w; c++) o[c] = in[c / rx];
    }
    return out;
}

struct ColorTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    ColorTables() {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};

inline uint8_t clamp255(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

Jpeg parse_and_decode(const uint8_t* data, size_t len, bool headers_only) {
    Jpeg j;
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    size_t pos = 2;
    bool saw_scan = false;
    for (;;) {
        // next marker: skip fill bytes (and garbage, as libjpeg does)
        while (pos < len && data[pos] != 0xFF) pos++;
        while (pos < len && data[pos] == 0xFF) pos++;
        if (pos >= len) {
            if (headers_only && j.have_frame) return j;
            fail("file ends before EOI (truncated)");
        }
        int marker = data[pos++];
        if (marker == 0xD9) {  // EOI
            if (!saw_scan) fail("no image data before EOI");
            return j;
        }
        if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
        if (marker == 0x01) continue;                     // TEM
        if (pos + 2 > len) fail("truncated marker segment");
        int seglen = be16(data + pos);
        if (seglen < 2 || pos + seglen > len) fail("truncated marker segment");
        const uint8_t* seg = data + pos + 2;
        int n = seglen - 2;
        pos += seglen;
        switch (marker) {
            case 0xC0:
            case 0xC1:
                if (j.have_frame) fail("more than one SOF marker");
                parse_frame(j, seg, n, marker);
                if (headers_only) return j;
                break;
            case 0xC2:
            case 0xC6:
            case 0xCA:
            case 0xCE:
                fail("progressive JPEG is not supported (baseline sequential only)");
            case 0xC3:
            case 0xC7:
            case 0xCB:
            case 0xCF:
                fail("lossless JPEG is not supported");
            case 0xC5:
            case 0xC9:
            case 0xCD:
                fail("arithmetic-coded JPEG is not supported");
            case 0xCC:
                fail("arithmetic-coded JPEG is not supported");
            case 0xC4: {  // DHT
                int p = 0;
                while (p < n) {
                    if (p + 17 > n) fail("short DHT segment");
                    int tc = seg[p] >> 4, th = seg[p] & 15;
                    if (tc > 1 || th > 3) fail("bad DHT table index");
                    uint8_t bits[17] = {0};
                    int count = 0;
                    for (int i = 1; i <= 16; i++) {
                        bits[i] = seg[p + i];
                        count += bits[i];
                    }
                    if (count > 256 || p + 17 + count > n) fail("bad DHT segment");
                    build_huff(tc ? j.ac[th] : j.dc[th], bits, seg + p + 17, count);
                    p += 17 + count;
                }
                break;
            }
            case 0xDB: {  // DQT
                int p = 0;
                while (p < n) {
                    int pq = seg[p] >> 4, tq = seg[p] & 15;
                    if (tq > 3 || pq > 1) fail("bad DQT segment");
                    int need = 1 + 64 * (pq ? 2 : 1);
                    if (p + need > n) fail("short DQT segment");
                    for (int i = 0; i < 64; i++) {
                        j.qt[tq][kNaturalOrder[i]] =
                            pq ? be16(seg + p + 1 + 2 * i) : static_cast<uint16_t>(seg[p + 1 + i]);
                    }
                    j.qt_defined[tq] = true;
                    p += need;
                }
                break;
            }
            case 0xDD:  // DRI
                if (n < 2) fail("short DRI segment");
                j.restart_interval = be16(seg);
                break;
            case 0xDC:
                fail("DNL marker is not supported");
            case 0xDA:  // SOS
                pos = decode_scan(j, data, len, pos, seg, n);
                saw_scan = true;
                break;
            case 0xE0:
                if (n >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) j.saw_jfif = true;
                break;
            case 0xEE:
                if (n >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
                    j.saw_adobe = true;
                    j.adobe_transform = seg[11];
                }
                break;
            default:
                break;  // other APPn, COM
        }
    }
}

void jpeg_to_rgb(Jpeg& j, uint8_t* out) {
    const int W = j.width, H = j.height;
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(j.ncomp));
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        if (!cp.quant_latched) fail("a component has no scan");
        std::vector<uint8_t> plane(static_cast<size_t>(cp.bw) * 8 * cp.bh * 8);
        const int stride = cp.bw * 8;
        for (int by = 0; by < cp.bh; by++) {
            for (int bx = 0; bx < cp.bw; bx++) {
                idct_islow(&cp.coef[(static_cast<size_t>(by) * cp.bw + bx) * 64], cp.quant,
                           &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
            }
        }
        full[c] = upsample(cp, plane, j.hmax, j.vmax, W, H);
    }
    if (j.ncomp == 1) {
        const uint8_t* y = full[0].data();
        for (size_t i = 0, n = static_cast<size_t>(W) * H; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
        return;
    }
    bool rgb;
    if (j.saw_jfif) {
        rgb = false;
    } else if (j.saw_adobe) {
        rgb = j.adobe_transform == 0;
    } else {
        rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
    }
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    const size_t n = static_cast<size_t>(W) * H;
    if (rgb) {
        for (size_t i = 0; i < n; i++) {
            out[3 * i] = p0[i];
            out[3 * i + 1] = p1[i];
            out[3 * i + 2] = p2[i];
        }
        return;
    }
    static const ColorTables t;
    for (size_t i = 0; i < n; i++) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        out[3 * i] = clamp255(y + t.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
}

// ---------------------------------------------------------------------------
// PNG unfilter
// ---------------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// Image size of a JPEG: 0 on success, else -1 with a message in err.
int tl_jpeg_header(const uint8_t* data, size_t len, int* width, int* height, char* err, int errlen) {
    try {
        Jpeg j = parse_and_decode(data, len, true);
        if (!j.have_frame) fail("no SOF marker");
        *width = j.width;
        *height = j.height;
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Decode a JPEG into out (height*width*3 RGB): 0 on success, else -1.
int tl_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int width, int height, char* err, int errlen) {
    try {
        Jpeg j = parse_and_decode(data, len, false);
        if (j.width != width || j.height != height) fail("image size changed between calls");
        jpeg_to_rgb(j, out);
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Undo the PNG row filters of a non-interlaced image: raw holds height rows
// of (filter byte, rowbytes bytes), bpp is the bytes per complete pixel
// (at least 1). Writes height*rowbytes bytes to out. 0 on success, -1 for
// an unknown filter type.
int tl_png_unfilter(const uint8_t* raw, int height, int rowbytes, int bpp, uint8_t* out) {
    for (int y = 0; y < height; y++) {
        const uint8_t* in = raw + static_cast<size_t>(y) * (rowbytes + 1);
        uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
        const uint8_t* prev = y ? cur - rowbytes : nullptr;
        int f = in[0];
        in++;
        switch (f) {
            case 0:
                std::memcpy(cur, in, rowbytes);
                break;
            case 1:
                for (int i = 0; i < rowbytes; i++) cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int i = 0; i < rowbytes; i++) cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
                break;
            case 3:
                for (int i = 0; i < rowbytes; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                    cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int i = 0; i < rowbytes; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
                    int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
                }
                break;
            default:
                return -1;
        }
    }
    return 0;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) of an 8-bit image
// with cn interleaved channels. Coefficients: float32 source coordinates,
// weights rounded to 11 bits (INTER_RESIZE_COEF_BITS); the horizontal pass
// sums into int, the vertical pass is OpenCV's vector form
// ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16), rounded by 2 bits.
// Columns are clamped to the border (coefficient 1, 0); rows keep their
// weights and read clamped row indices.
void tl_resize_linear_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw) {
    auto coeffs = [](int ssize, int dsize, bool clamp, std::vector<int>& idx, std::vector<int>& w0,
                     std::vector<int>& w1) {
        double scale = 1.0 / (static_cast<double>(dsize) / ssize);
        idx.resize(dsize);
        w0.resize(dsize);
        w1.resize(dsize);
        for (int d = 0; d < dsize; d++) {
            float f = static_cast<float>((d + 0.5) * scale - 0.5);
            int s = static_cast<int>(std::floor(f));
            f -= static_cast<float>(s);
            if (clamp) {
                if (s < 0) f = 0.f, s = 0;
                if (s >= ssize - 1) f = 0.f, s = ssize - 1;
            }
            idx[d] = s;
            w0[d] = static_cast<int>(std::lrintf((1.f - f) * 2048.f));
            w1[d] = static_cast<int>(std::lrintf(f * 2048.f));
        }
    };
    std::vector<int> xi, xa0, xa1, yi, yb0, yb1;
    coeffs(sw, dw, true, xi, xa0, xa1);
    coeffs(sh, dh, false, yi, yb0, yb1);
    const int rowlen = dw * cn;
    std::vector<int32_t> h0(static_cast<size_t>(rowlen)), h1(static_cast<size_t>(rowlen));
    // source offsets of each output column's two taps (the right tap
    // clamped to the last column, where its weight is 0)
    std::vector<int> off0(dw), off1(dw);
    for (int d = 0; d < dw; d++) {
        off0[d] = xi[d] * cn;
        off1[d] = (xi[d] + 1 < sw ? xi[d] + 1 : sw - 1) * cn;
    }
    auto hpass = [&](int sy, int32_t* out) {
        const uint8_t* s = src + static_cast<size_t>(sy) * sw * cn;
        auto run = [&](auto channels) {
            constexpr int C = decltype(channels)::value;
            for (int d = 0; d < dw; d++) {
                const uint8_t *p0 = s + off0[d], *p1 = s + off1[d];
                const int a0 = xa0[d], a1 = xa1[d];
                for (int k = 0; k < C; k++) out[d * C + k] = p0[k] * a0 + p1[k] * a1;
            }
        };
        if (cn == 3) {
            run(std::integral_constant<int, 3>{});
        } else if (cn == 4) {
            run(std::integral_constant<int, 4>{});
        } else if (cn == 1) {
            run(std::integral_constant<int, 1>{});
        } else {
            for (int d = 0; d < dw; d++) {
                for (int k = 0; k < cn; k++) out[d * cn + k] = s[off0[d] + k] * xa0[d] + s[off1[d] + k] * xa1[d];
            }
        }
    };
    int have0 = -1, have1 = -1;
    for (int d = 0; d < dh; d++) {
        int r0 = yi[d] < 0 ? 0 : (yi[d] >= sh ? sh - 1 : yi[d]);
        int r1 = yi[d] + 1 < 0 ? 0 : (yi[d] + 1 >= sh ? sh - 1 : yi[d] + 1);
        if (r0 == have1 && r0 != have0) {
            std::swap(h0, h1);
            std::swap(have0, have1);
        }
        if (r0 != have0) {
            hpass(r0, h0.data());
            have0 = r0;
        }
        if (r1 != have1) {
            if (r1 == have0) {
                h1 = h0;
            } else {
                hpass(r1, h1.data());
            }
            have1 = r1;
        }
        const int b0 = yb0[d], b1 = yb1[d];
        uint8_t* o = dst + static_cast<size_t>(d) * rowlen;
        for (int i = 0; i < rowlen; i++) {
            int32_t t = (((h0[i] >> 4) * b0) >> 16) + (((h1[i] >> 4) * b1) >> 16);
            t = (t + 2) >> 2;
            o[i] = static_cast<uint8_t>(t < 0 ? 0 : (t > 255 ? 255 : t));
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG encode
// ---------------------------------------------------------------------------
//
// Baseline JPEG as cv2.imencode(".jpg", img) writes it with its bundled
// libjpeg-turbo at the defaults: quality 95, 4:2:0 chroma, the Annex K
// quantisation and Huffman tables (no optimisation), a JFIF 1.01 APP0
// header. Each stage follows libjpeg-turbo's 8-bit SIMD build bit for bit:
// jccolor.c's fixed-point RGB->YCbCr, jcsample.c's h2v2 box filter with the
// alternating 1, 2 bias, edge replication to whole blocks (jcprepct.c,
// jcsample.c), jfdctint.c's islow forward DCT, jcdctmgr.c's quantisation by
// 16-bit reciprocals (compute_reciprocal), dummy blocks past the image edge
// that repeat the previous DC (jccoefct.c), and jchuff.c's entropy coder.

namespace {

const uint8_t kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

struct HuffCodes {
    uint32_t code[256] = {};
    uint8_t size[256] = {};
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
HuffCodes make_codes(const uint8_t bits[16], const uint8_t* vals) {
    HuffCodes t;
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len - 1]; i++, k++) {
            t.code[vals[k]] = code++;
            t.size[vals[k]] = static_cast<uint8_t>(len);
        }
        code <<= 1;
    }
    return t;
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scale_quant(const uint8_t basic[64], int quality, uint16_t out[64]) {
    quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
    const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; i++) {
        long t = (basic[i] * scale + 50L) / 100L;
        t = t <= 0 ? 1 : (t > 255 ? 255 : t);
        out[i] = static_cast<uint16_t>(t);
    }
}

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM (the SIMD build)
struct Divisor {
    uint32_t recip, corr, shift;
};

Divisor reciprocal(uint16_t divisor) {
    if (divisor == 1) return {1, 0, 16};
    int b = 0;
    for (uint32_t d = divisor; d > 1; d >>= 1) b++;  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor;
    const uint32_t fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2u) {
        c++;
    } else {
        fq++;
    }
    return {fq, c, static_cast<uint32_t>(r)};
}

// jfdctint.c jpeg_fdct_islow on level-shifted samples, in place
void fdct_islow(int32_t* d) {
    constexpr int CB = 13, P1 = 2;
    auto descale = [](int64_t x, int n) { return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n); };
    for (int row = 0; row < 8; row++) {
        int32_t* p = d + row * 8;
        const int64_t t0 = p[0] + p[7], t7 = p[0] - p[7], t1 = p[1] + p[6], t6 = p[1] - p[6];
        const int64_t t2 = p[2] + p[5], t5 = p[2] - p[5], t3 = p[3] + p[4], t4 = p[3] - p[4];
        const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        p[0] = static_cast<int32_t>((t10 + t11) << P1);
        p[4] = static_cast<int32_t>((t10 - t11) << P1);
        int64_t z1 = (t12 + t13) * 4433;
        p[2] = descale(z1 + t13 * 6270, CB - P1);
        p[6] = descale(z1 + t12 * -15137, CB - P1);
        z1 = t4 + t7;
        int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
        const int64_t z5 = (z3 + z4) * 9633;
        const int64_t a4 = t4 * 2446, a5 = t5 * 16819, a6 = t6 * 25172, a7 = t7 * 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        p[7] = descale(a4 + z1 + z3, CB - P1);
        p[5] = descale(a5 + z2 + z4, CB - P1);
        p[3] = descale(a6 + z2 + z3, CB - P1);
        p[1] = descale(a7 + z1 + z4, CB - P1);
    }
    for (int col = 0; col < 8; col++) {
        int32_t* p = d + col;
        const int64_t t0 = p[0] + p[56], t7 = p[0] - p[56], t1 = p[8] + p[48], t6 = p[8] - p[48];
        const int64_t t2 = p[16] + p[40], t5 = p[16] - p[40], t3 = p[24] + p[32], t4 = p[24] - p[32];
        const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        p[0] = descale(t10 + t11, P1);
        p[32] = descale(t10 - t11, P1);
        int64_t z1 = (t12 + t13) * 4433;
        p[16] = descale(z1 + t13 * 6270, CB + P1);
        p[48] = descale(z1 + t12 * -15137, CB + P1);
        z1 = t4 + t7;
        int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
        const int64_t z5 = (z3 + z4) * 9633;
        const int64_t a4 = t4 * 2446, a5 = t5 * 16819, a6 = t6 * 25172, a7 = t7 * 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        p[56] = descale(a4 + z1 + z3, CB + P1);
        p[40] = descale(a5 + z2 + z4, CB + P1);
        p[24] = descale(a6 + z2 + z3, CB + P1);
        p[8] = descale(a7 + z1 + z4, CB + P1);
    }
}

class BitWriter {
  public:
    explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
    void put(uint32_t code, int size) {
        acc_ = (acc_ << size) | (code & ((1u << size) - 1));
        bits_ += size;
        while (bits_ >= 8) {
            const uint8_t byte = static_cast<uint8_t>(acc_ >> (bits_ - 8));
            out_.push_back(byte);
            if (byte == 0xFF) out_.push_back(0);
            bits_ -= 8;
        }
        acc_ &= (1ull << bits_) - 1;
    }
    void flush() {  // jchuff.c flush_bits: seven 1 bits, the partial byte dropped
        put(0x7F, 7);
        bits_ = 0;
        acc_ = 0;
    }

  private:
    std::vector<uint8_t>& out_;
    uint64_t acc_ = 0;
    int bits_ = 0;
};

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t bits[16], const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; i++) n += bits[i];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + n);
    o.push_back(static_cast<uint8_t>(cls_id));
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + n);
}

// One component plane, level-unshifted samples, replicated out to whole
// MCUs (right: jcsample.c expand_right_edge; bottom: jcprepct.c
// expand_bottom_edge).
struct Plane {
    int w = 0, h = 0;  // padded size
    std::vector<uint8_t> px;
};

void encode_jpeg(const uint8_t* rgb, int width, int height, int quality, std::vector<uint8_t>& o) {
    if (width < 1 || height < 1 || width > 65500 || height > 65500) fail("image size out of range");
    // jccolor.c rgb_ycc_convert (SCALEBITS 16)
    static const int32_t kFix[8] = {19595, 38470, 7471, 11059, 21709, 32768, 27439, 5329};
    const int32_t half = 1 << 15, off = (128 << 16) + half - 1;
    const int mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
    // full-resolution planes, width padded to the Y blocks (replicated),
    // height padded to an even row count (replicated) and then to whole
    // MCUs for Y
    const int ybw = (width + 7) / 8, cbw = (width + 15) / 16;  // width_in_blocks
    const int ybh = (height + 7) / 8;
    Plane Y, Cb, Cr;
    Y.w = mcux * 16;
    Y.h = mcuy * 16;
    Y.px.assign(static_cast<size_t>(Y.w) * Y.h, 0);
    const int cw_full = cbw * 16;  // downsampler input width: output_cols * 2
    const int rows2 = (height + 1) / 2 * 2;
    std::vector<uint8_t> cbf(static_cast<size_t>(cw_full) * rows2), crf(cbf.size());
    for (int y = 0; y < rows2; y++) {
        const int sy = y < height ? y : height - 1;
        const uint8_t* s = rgb + static_cast<size_t>(sy) * width * 3;
        uint8_t* yr = Y.px.data() + static_cast<size_t>(y) * Y.w;
        uint8_t* br = cbf.data() + static_cast<size_t>(y) * cw_full;
        uint8_t* rr = crf.data() + static_cast<size_t>(y) * cw_full;
        for (int x = 0; x < width; x++) {
            const int32_t r = s[3 * x], g = s[3 * x + 1], b = s[3 * x + 2];
            yr[x] = static_cast<uint8_t>((kFix[0] * r + kFix[1] * g + kFix[2] * b + half) >> 16);
            br[x] = static_cast<uint8_t>((-kFix[3] * r - kFix[4] * g + kFix[5] * b + off) >> 16);
            rr[x] = static_cast<uint8_t>((kFix[5] * r - kFix[6] * g - kFix[7] * b + off) >> 16);
        }
        for (int x = width; x < Y.w; x++) yr[x] = yr[width - 1];
        for (int x = width; x < cw_full; x++) {
            br[x] = br[width - 1];
            rr[x] = rr[width - 1];
        }
    }
    for (int y = rows2; y < Y.h; y++)  // whole MCUs: replicate the last row
        std::memcpy(Y.px.data() + static_cast<size_t>(y) * Y.w,
                    Y.px.data() + static_cast<size_t>(rows2 - 1) * Y.w, Y.w);
    // jcsample.c h2v2_downsample, then pad to whole MCUs
    auto down = [&](const std::vector<uint8_t>& full, Plane& p) {
        p.w = mcux * 8;
        p.h = mcuy * 8;
        p.px.assign(static_cast<size_t>(p.w) * p.h, 0);
        const int oh = rows2 / 2, ow = cbw * 8;
        for (int y = 0; y < oh; y++) {
            const uint8_t* a = full.data() + static_cast<size_t>(2 * y) * cw_full;
            const uint8_t* b = a + cw_full;
            uint8_t* o2 = p.px.data() + static_cast<size_t>(y) * p.w;
            int bias = 1;
            for (int x = 0; x < ow; x++) {
                o2[x] = static_cast<uint8_t>((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + bias) >> 2);
                bias ^= 3;
            }
            for (int x = ow; x < p.w; x++) o2[x] = o2[ow - 1];
        }
        for (int y = oh; y < p.h; y++)
            std::memcpy(p.px.data() + static_cast<size_t>(y) * p.w,
                        p.px.data() + static_cast<size_t>(oh - 1) * p.w, p.w);
    };
    down(cbf, Cb);
    down(crf, Cr);

    uint16_t ql[64], qc[64];
    scale_quant(kStdLumaQuant, quality, ql);
    scale_quant(kStdChromaQuant, quality, qc);
    Divisor dl[64], dc[64];
    for (int i = 0; i < 64; i++) {
        dl[i] = reciprocal(static_cast<uint16_t>(ql[i] << 3));
        dc[i] = reciprocal(static_cast<uint16_t>(qc[i] << 3));
    }

    // headers (jcmarker.c)
    o.push_back(0xFF);
    o.push_back(0xD8);
    static const uint8_t app0[18] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    o.insert(o.end(), app0, app0 + 18);
    for (int t = 0; t < 2; t++) {
        const uint16_t* q = t == 0 ? ql : qc;
        o.push_back(0xFF);
        o.push_back(0xDB);
        put16(o, 67);
        o.push_back(static_cast<uint8_t>(t));
        for (int i = 0; i < 64; i++) o.push_back(static_cast<uint8_t>(q[kNaturalOrder[i]]));
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put16(o, 17);
    o.push_back(8);
    put16(o, height);
    put16(o, width);
    o.push_back(3);
    static const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    o.insert(o.end(), comps, comps + 9);
    put_dht(o, 0x00, kDcLumaBits, kDcVals);
    put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
    static const uint8_t sos[14] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    o.insert(o.end(), sos, sos + 14);

    static const HuffCodes dcl = make_codes(kDcLumaBits, kDcVals), dcc = make_codes(kDcChromaBits, kDcVals);
    static const HuffCodes acl = make_codes(kAcLumaBits, kAcLumaVals),
                           acc = make_codes(kAcChromaBits, kAcChromaVals);
    BitWriter bw(o);
    int32_t block[64];
    auto quantize = [&](const Plane& p, int bx, int by, const Divisor* dv, int16_t out[64]) {
        for (int y = 0; y < 8; y++) {
            const uint8_t* s = p.px.data() + static_cast<size_t>(by * 8 + y) * p.w + bx * 8;
            for (int x = 0; x < 8; x++) block[y * 8 + x] = static_cast<int32_t>(s[x]) - 128;
        }
        fdct_islow(block);
        for (int i = 0; i < 64; i++) {
            int32_t t = block[i];
            const bool neg = t < 0;
            uint32_t u = static_cast<uint32_t>(neg ? -t : t);
            u = static_cast<uint32_t>((static_cast<uint64_t>(u + dv[i].corr) * dv[i].recip) >> (dv[i].shift));
            // 16-bit DCTELEM: the product is taken modulo 2^32 (UDCTELEM2)
            out[i] = static_cast<int16_t>(neg ? -static_cast<int32_t>(u) : static_cast<int32_t>(u));
        }
    };
    auto encode_block = [&](const int16_t* q, int& last_dc, const HuffCodes& dct, const HuffCodes& act) {
        int t = q[0] - last_dc;
        last_dc = q[0];
        int t2 = t;
        if (t < 0) {
            t = -t;
            t2--;
        }
        int nbits = 0;
        while (t) {
            nbits++;
            t >>= 1;
        }
        bw.put(dct.code[nbits], dct.size[nbits]);
        if (nbits) bw.put(static_cast<uint32_t>(t2), nbits);
        int r = 0;
        for (int k = 1; k < 64; k++) {
            int v = q[kNaturalOrder[k]];
            if (v == 0) {
                r++;
                continue;
            }
            while (r > 15) {
                bw.put(act.code[0xF0], act.size[0xF0]);
                r -= 16;
            }
            int v2 = v;
            if (v < 0) {
                v = -v;
                v2--;
            }
            int nb = 1;
            while ((v >>= 1)) nb++;
            const int sym = (r << 4) + nb;
            bw.put(act.code[sym], act.size[sym]);
            bw.put(static_cast<uint32_t>(v2), nb);
            r = 0;
        }
        if (r > 0) bw.put(act.code[0], act.size[0]);
    };
    int dcy = 0, dcb = 0, dcr = 0;
    int16_t q[64], above_dc = 0;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            // Y: 2x2 blocks. Past the component's blocks, jccoefct.c codes
            // dummies (zero AC): at the right edge with the DC of the block
            // to their left, in a row below the image with the DC of the
            // MCU's last block above.
            for (int yy = 0; yy < 2; yy++) {
                const int by = my * 2 + yy;
                for (int xx = 0; xx < 2; xx++) {
                    const int bx = mx * 2 + xx;
                    if (by < ybh && bx < ybw) {
                        quantize(Y, bx, by, dl, q);
                    } else {
                        const int16_t dcv = by < ybh ? q[0] : above_dc;
                        std::memset(q, 0, sizeof(q));
                        q[0] = dcv;
                    }
                    encode_block(q, dcy, dcl, acl);
                }
                if (by < ybh) above_dc = q[0];
            }
            quantize(Cb, mx, my, dc, q);
            encode_block(q, dcb, dcc, acc);
            quantize(Cr, mx, my, dc, q);
            encode_block(q, dcr, dcc, acc);
        }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
}

}  // namespace

extern "C" {

// RGB (H, W, 3) uint8 -> baseline JPEG bytes. Writes at most cap bytes to
// out; returns 0 and the length in *len, 1 with the needed length in *len
// when cap is too small, -1 on an error (message in err).
int tl_jpeg_encode(const uint8_t* rgb, int width, int height, int quality, uint8_t* out, size_t cap,
                   size_t* len, char* err, int errlen) {
    try {
        std::vector<uint8_t> o;
        o.reserve(static_cast<size_t>(width) * height / 2 + 1024);
        encode_jpeg(rgb, width, height, quality, o);
        *len = o.size();
        if (o.size() > cap) return 1;
        std::memcpy(out, o.data(), o.size());
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    }
}

}  // extern "C"
