// Host image codecs of the port: JPEG decode and encode, the PNG sample
// stage (row filters, Adam7 deinterlacing, sub-byte unpacking) and
// cv2-compatible INTER_LINEAR resize of uint8 images.
//
// Built by tpu3dlm_torch/kernels/build.py with the system C++ compiler
// (c++ -O3 -shared -fPIC) and called through ctypes from
// tpu3dlm_torch/data/codecs.py, which parses PNG chunks, inflates IDAT with
// zlib, maps PNG samples to cv2's layouts and writes PNGs. Every entry point
// has a plain C interface, touches only the buffers it is given and keeps no
// state, so calls run in parallel on a thread pool (ctypes releases the GIL).
//
// The JPEG decoder reproduces libjpeg-turbo 3.1's default decode, as cv2
// calls it, bit for bit:
// - entropy decoding of sequential and progressive Huffman (SOF0/1/2) and
//   arithmetic (SOF9/10, DAC conditioning) scans, with restart markers, into
//   a coefficient buffer for the whole image (jdhuff.c, jdphuff.c,
//   jdarith.c), padding with zero bits where a scan's data stops early;
// - jdcoefct.c's block smoothing of the coefficients that a progressive
//   file's scans leave incomplete (a partial progression or a cut file);
// - the integer "islow" IDCT of jidctint.c with its range limit;
// - jdsample.c's upsampling: the h2v1, h1v2 and h2v2 triangle filters and
//   integral replication, sampling factors 1-4 (fractional ratios refused);
// - jdcolor.c's fixed-point YCbCr->RGB and YCCK->CMYK, RGB and gray, and
//   OpenCV's CMYK->BGR step for 4-component files.
// Two stream forms: the bytes as given (cv2.imdecode: data that ends before
// EOI is an error) and a file (cv2.imread: libjpeg's stdio source feeds a
// fake EOI marker, FF D9, whenever the file is exhausted, so a cut file
// decodes with the missing data left out).
// Lossless JPEG (SOF3) follows libjpeg-turbo 3.1's jdlhuff.c, jddiffct.c
// and jdpred.c: Huffman-coded differences (category 16 is 32768), the
// seven predictors with the first row of the image and of each restart
// interval predicted from the left, the point transform undone by a shift,
// replicated (never fancy) upsampling, and only the colour conversions it
// allows: RGB as is, CMYK, gray to gray. What libjpeg-turbo or cv2 refuse
// is refused with a message, never decoded approximately: precision above 8
// bits (lossless or DCT), arithmetic-coded lossless (SOF11), hierarchical
// frames, a YCbCr or YCCK lossless file, and a gray one asked for colour.

#include <algorithm>
#include <climits>
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

// zigzag -> natural order, with jutils.c's 16 guard entries for corrupt runs
const int kNaturalOrder[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
    bool defined = false;
    int max_symbol = 0;
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
    std::memset(t.vals, 0, sizeof(t.vals));
    std::memcpy(t.vals, vals, static_cast<size_t>(nvals));
    t.max_symbol = 0;
    for (int i = 0; i < nvals; i++) t.max_symbol = vals[i] > t.max_symbol ? vals[i] : t.max_symbol;
    t.defined = true;
}

// The byte stream that libjpeg reads. In the file form the stream goes on
// past the last byte as FF D9 FF D9 ..., the fake EOI markers of
// jdatasrc.c's fill_input_buffer; in the bytes form reading past the end is
// the error cv2.imdecode reports as a failed decode.
struct Source {
    const uint8_t* data;
    size_t len;
    bool file;
    size_t pos = 0;

    int byte() {
        size_t p = pos++;
        if (p < len) return data[p];
        if (!file) fail("file ends before EOI (truncated)");
        return ((p - len) & 1) ? 0xD9 : 0xFF;
    }
};

// jdmarker.c next_marker: skip to an FF, swallow fill FFs, skip FF 00.
int next_marker(Source& s) {
    for (;;) {
        int c = s.byte();
        while (c != 0xFF) c = s.byte();
        do {
            c = s.byte();
        } while (c == 0xFF);
        if (c != 0) return c;
    }
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int width = 0, height = 0;          // downsampled size
    int wib = 0, hib = 0;               // size in blocks
    int bw = 0, bh = 0;                 // allocated blocks (MCU-padded)
    std::vector<int16_t> coef;          // bw*bh*64, natural order
    std::vector<uint8_t> samp;          // lossless: bw*bh output samples
    bool scanned = false;               // lossless: a scan has written samp
    uint16_t quant[64] = {};
    bool quant_latched = false;
    int dc_tbl = 0, ac_tbl = 0;         // of the current scan

    int16_t* block(int row, int col) { return &coef[(static_cast<size_t>(row) * bw + col) * 64]; }
};

struct Jpeg {
    explicit Jpeg(const uint8_t* data, size_t len, bool file) : src{data, len, file} {}
    Source src;
    int unread_marker = 0;
    int width = 0, height = 0, ncomp = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;  // mcuy = total iMCU rows
    bool have_frame = false, progressive = false, arith = false, lossless = false;
    int precision = 8;
    int restart_interval = 0, next_restart_num = 0;
    bool saw_jfif = false, saw_adobe = false, saw_app1 = false;
    int adobe_transform = -1;
    int orientation = 0;  // EXIF tag 0x0112 of the first APP1, 0 if none
    int colour = -1;      // -1: libjpeg's guess from the markers; 0: the components; 1: YCbCr to RGB
    Component comp[4];
    uint16_t qt[4][64] = {};
    bool qt_defined[4] = {};
    HuffTable dc[4], ac[4];
    uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
    uint8_t dc_stats[16][64], ac_stats[16][256];
    int coef_bits[4][64], prev_coef_bits[4][64];  // progression status
    int input_scan_number = 0;
    int last_good_iMCU_row = 0;  // jdmaster.c: last row decoded with data
};

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

// OpenCV's ExifReader: TIFF header, IFD0, the first 0x0112 entry's SHORT.
int exif_orientation(const uint8_t* d, size_t n) {
    if (n < 8) return 0;
    bool intel = d[0] == 'I' && d[1] == 'I';
    bool moto = d[0] == 'M' && d[1] == 'M';
    if (!intel && !moto) return 0;
    auto u16 = [&](size_t o) -> int {
        if (o + 1 >= n) return -1;
        return intel ? (d[o] | (d[o + 1] << 8)) : ((d[o] << 8) | d[o + 1]);
    };
    auto u32 = [&](size_t o) -> int64_t {
        if (o + 3 >= n) return -1;
        return intel ? (int64_t(d[o]) | (int64_t(d[o + 1]) << 8) | (int64_t(d[o + 2]) << 16) |
                        (int64_t(d[o + 3]) << 24))
                     : ((int64_t(d[o]) << 24) | (int64_t(d[o + 1]) << 16) | (int64_t(d[o + 2]) << 8) |
                        int64_t(d[o + 3]));
    };
    if (u16(2) != 0x2A) return 0;
    int64_t off = u32(4);
    if (off < 0) return 0;
    int count = u16(static_cast<size_t>(off));
    if (count < 0) return 0;
    size_t e = static_cast<size_t>(off) + 2;
    for (int i = 0; i < count; i++, e += 12) {
        int tag = u16(e);
        if (tag < 0) return 0;
        if (tag == 0x0112) {
            int v = u16(e + 8);
            return v < 0 ? 0 : v;
        }
    }
    return 0;
}

void parse_frame(Jpeg& j, const std::vector<uint8_t>& s, int marker) {
    const int n = static_cast<int>(s.size());
    if (n < 6) fail("short SOF segment");
    const uint8_t* p = s.data();
    j.lossless = marker == 0xC3;
    j.precision = p[0];
    if (j.lossless) {  // libjpeg-turbo's 8-bit lossless path takes 2 to 8 bits; cv2 asks for no other
        if (p[0] < 2 || p[0] > 8) fail(std::to_string(p[0]) + "-bit lossless JPEG is not supported (2 to 8 bits)");
    } else if (p[0] != 8) {
        fail(std::to_string(p[0]) + "-bit JPEG is not supported (8-bit only)");
    }
    j.progressive = marker == 0xC2 || marker == 0xCA;
    j.arith = marker >= 0xC9;
    j.height = be16(p + 1);
    j.width = be16(p + 3);
    j.ncomp = p[5];
    if (j.height == 0) fail("JPEG with a DNL height is not supported");
    if (j.width == 0) fail("JPEG of width 0");
    if (j.ncomp != 1 && j.ncomp != 3 && j.ncomp != 4) {
        fail(std::to_string(j.ncomp) + "-component JPEG has no colour conversion");
    }
    if (n != 6 + 3 * j.ncomp) fail("bad SOF segment length");
    j.hmax = j.vmax = 1;
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        cp.id = p[6 + 3 * c];
        cp.h = p[7 + 3 * c] >> 4;
        cp.v = p[7 + 3 * c] & 15;
        cp.tq = p[8 + 3 * c];
        if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4) fail("bad sampling factors (1 to 4 only)");
        if (cp.tq > 3) fail("bad quantization table index");
        j.hmax = cp.h > j.hmax ? cp.h : j.hmax;
        j.vmax = cp.v > j.vmax ? cp.v : j.vmax;
    }
    const int unit = j.lossless ? 1 : 8;  // a lossless data unit is one sample
    j.mcux = (j.width + unit * j.hmax - 1) / (unit * j.hmax);
    j.mcuy = (j.height + unit * j.vmax - 1) / (unit * j.vmax);
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        if (j.hmax % cp.h || j.vmax % cp.v) fail("fractional sampling ratios are not implemented (as in libjpeg)");
        cp.width = (j.width * cp.h + j.hmax - 1) / j.hmax;
        cp.height = (j.height * cp.v + j.vmax - 1) / j.vmax;
        cp.wib = (cp.width + unit - 1) / unit;
        cp.hib = (cp.height + unit - 1) / unit;
        cp.bw = j.mcux * cp.h;
        cp.bh = j.mcuy * cp.v;
        if (j.lossless) {
            cp.samp.assign(static_cast<size_t>(cp.bw) * cp.bh, 0);
        } else {
            cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
        }
        for (int k = 0; k < 64; k++) j.coef_bits[c][k] = j.prev_coef_bits[c][k] = -1;
    }
    j.have_frame = true;
}

struct Scan {
    int ns = 0;
    Component* c[4] = {};
    int ci[4] = {};  // component indices
    int Ss = 0, Se = 63, Ah = 0, Al = 0;
};

inline int huff_extend(int x, int s) { return x < (1 << (s - 1)) ? x + static_cast<int>(~0u << s) + 1 : x; }

// jdhuff.c's bit reader: bits are read greedily up to a marker; past it the
// reader feeds zero bits, and the first zero bit that is actually consumed
// sets insufficient_data (libjpeg's "premature end of data segment").
struct HuffDecoder {
    Jpeg& j;
    const Scan& s;
    uint64_t buf = 0;  // top-aligned
    int count = 0;     // bits in buf
    int real = 0;      // of which read from the stream
    bool insufficient = false;
    unsigned restarts_to_go = 0;
    int last_dc[4] = {};
    unsigned eobrun = 0;

    HuffDecoder(Jpeg& jj, const Scan& ss) : j(jj), s(ss), restarts_to_go(jj.restart_interval) {}

    void fill() {
        while (count <= 56) {
            int c = 0;
            bool data = false;
            if (!j.unread_marker) {
                c = j.src.byte();
                if (c == 0xFF) {
                    do {
                        c = j.src.byte();
                    } while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                        data = true;
                    } else {
                        j.unread_marker = c;
                        c = 0;
                    }
                } else {
                    data = true;
                }
            }
            buf |= static_cast<uint64_t>(c) << (56 - count);
            count += 8;
            if (data) real += 8;
        }
    }
    void consume(int n) {
        buf <<= n;
        count -= n;
        if (n > real) {
            insufficient = true;
            real = 0;
        } else {
            real -= n;
        }
    }
    int get_bits(int n) {
        if (n == 0) return 0;
        if (count < n) fill();
        int v = static_cast<int>(buf >> (64 - n));
        consume(n);
        return v;
    }
    int decode(const HuffTable& t) {
        if (count < 17) fill();
        int look = static_cast<int>(buf >> 56);
        int l = t.look_len[look];
        if (l) {
            consume(l);
            return t.look_sym[look];
        }
        l = 9;
        int32_t code = static_cast<int32_t>(buf >> (64 - 9));
        while (code > t.maxcode[l]) {  // maxcode[17] ends the search
            l++;
            code = static_cast<int32_t>(buf >> (64 - l));
        }
        consume(l);
        if (l > 16) return 0;  // bad code: libjpeg warns and yields 0
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }

    void process_restart();
    void mcu(int16_t* const* blk, const int* memb, int nblk);
};

// jpeg_resync_to_restart for a marker that is not the expected RSTn.
void resync_to_restart(Jpeg& j, int desired) {
    int marker = j.unread_marker;
    for (;;) {
        int action;
        if (marker < 0xC0) {
            action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
            action = 3;
        } else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) {
            action = 3;
        } else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) {
            action = 2;
        } else {
            action = 1;
        }
        if (action == 1) {
            j.unread_marker = 0;
            return;
        }
        if (action == 3) return;
        marker = j.unread_marker = next_marker(j.src);
    }
}

void read_restart_marker(Jpeg& j) {
    if (!j.unread_marker) j.unread_marker = next_marker(j.src);
    if (j.unread_marker == 0xD0 + j.next_restart_num) {
        j.unread_marker = 0;
    } else {
        resync_to_restart(j, j.next_restart_num);
    }
    j.next_restart_num = (j.next_restart_num + 1) & 7;
}

void HuffDecoder::process_restart() {
    buf = 0;
    count = real = 0;
    read_restart_marker(j);
    for (int i = 0; i < s.ns; i++) last_dc[i] = 0;
    eobrun = 0;
    restarts_to_go = static_cast<unsigned>(j.restart_interval);
    if (!j.unread_marker) insufficient = false;
}

void HuffDecoder::mcu(int16_t* const* blk, const int* memb, int nblk) {
    if (j.restart_interval && restarts_to_go == 0) process_restart();
    const int Ss = s.Ss, Se = s.Se, Al = s.Al;
    if (!j.progressive) {  // jdhuff.c decode_mcu
        if (!insufficient) {
            for (int b = 0; b < nblk; b++) {
                int16_t* block = blk[b];
                const Component& cp = *s.c[memb[b]];
                int t = decode(j.dc[cp.dc_tbl]);
                if (t) t = huff_extend(get_bits(t), t);
                last_dc[memb[b]] = static_cast<int>(static_cast<unsigned>(last_dc[memb[b]]) + t);
                block[0] = static_cast<int16_t>(last_dc[memb[b]]);
                const HuffTable& act = j.ac[cp.ac_tbl];
                for (int k = 1; k < 64; k++) {
                    int sym = decode(act);
                    int r = sym >> 4;
                    sym &= 15;
                    if (sym) {
                        k += r;
                        block[kNaturalOrder[k]] = static_cast<int16_t>(huff_extend(get_bits(sym), sym));
                    } else {
                        if (r != 15) break;
                        k += 15;
                    }
                }
            }
        }
    } else if (Ss == 0 && s.Ah == 0) {  // jdphuff.c decode_mcu_DC_first
        if (!insufficient) {
            for (int b = 0; b < nblk; b++) {
                int t = decode(j.dc[s.c[memb[b]]->dc_tbl]);
                if (t) t = huff_extend(get_bits(t), t);
                int& last = last_dc[memb[b]];
                if ((last >= 0 && t > INT_MAX - last) || (last < 0 && t < INT_MIN - last)) {
                    fail("DC coefficient out of range (corrupt data)");
                }
                last += t;
                blk[b][0] = static_cast<int16_t>(static_cast<unsigned>(last) << Al);
            }
        }
    } else if (Ss == 0) {  // decode_mcu_DC_refine: zero bits change nothing
        const int p1 = 1 << Al;
        for (int b = 0; b < nblk; b++) {
            if (get_bits(1)) blk[b][0] = static_cast<int16_t>(blk[b][0] | p1);
        }
    } else if (s.Ah == 0) {  // decode_mcu_AC_first
        if (!insufficient) {
            if (eobrun > 0) {
                eobrun--;
            } else {
                int16_t* block = blk[0];
                const HuffTable& t = j.ac[s.c[0]->ac_tbl];
                for (int k = Ss; k <= Se; k++) {
                    int sym = decode(t);
                    int r = sym >> 4;
                    sym &= 15;
                    if (sym) {
                        k += r;
                        int v = huff_extend(get_bits(sym), sym);
                        block[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << Al);
                    } else if (r == 15) {
                        k += 15;
                    } else {
                        eobrun = 1u << r;
                        if (r) eobrun += static_cast<unsigned>(get_bits(r));
                        eobrun--;
                        break;
                    }
                }
            }
        }
    } else {  // decode_mcu_AC_refine
        if (!insufficient) {
            const int p1 = 1 << Al, m1 = static_cast<int>(~0u << Al);
            int16_t* block = blk[0];
            const HuffTable& t = j.ac[s.c[0]->ac_tbl];
            int k = Ss;
            if (eobrun == 0) {
                for (; k <= Se; k++) {
                    int sym = decode(t);
                    int r = sym >> 4;
                    sym &= 15;
                    if (sym) {
                        sym = get_bits(1) ? p1 : m1;
                    } else if (r != 15) {
                        eobrun = 1u << r;
                        if (r) eobrun += static_cast<unsigned>(get_bits(r));
                        break;
                    }
                    do {
                        int16_t* c = block + kNaturalOrder[k];
                        if (*c != 0) {
                            if (get_bits(1) && (*c & p1) == 0) {
                                *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
                            }
                        } else if (--r < 0) {
                            break;
                        }
                        k++;
                    } while (k <= Se);
                    if (sym) block[kNaturalOrder[k]] = static_cast<int16_t>(sym);
                }
            }
            if (eobrun > 0) {
                for (; k <= Se; k++) {
                    int16_t* c = block + kNaturalOrder[k];
                    if (*c != 0 && get_bits(1) && (*c & p1) == 0) {
                        *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
                    }
                }
                eobrun--;
            }
        }
    }
    if (j.restart_interval) restarts_to_go--;
}

// jaricom.c jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS (ITU-T T.81 Table D.2, and entry 113 for the fixed 0.5).
#define V(qe, nl, nm, sw) ((int64_t(qe) << 16) | (int64_t(nm) << 8) | (int64_t(sw) << 7) | int64_t(nl))
const int64_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// jdarith.c: the QM decoder. A marker in the data is legal here: past it the
// decoder reads zero bytes (no insufficient_data state).
struct ArithDecoder {
    Jpeg& j;
    const Scan& s;
    int64_t c = 0, a = 0;
    int ct = -16;  // -1: error state, the rest of the segment is skipped
    int last_dc[4] = {}, dc_context[4] = {};
    unsigned restarts_to_go = 0;
    uint8_t fixed_bin[4] = {113, 0, 0, 0};
    static constexpr bool insufficient = false;

    ArithDecoder(Jpeg& jj, const Scan& ss) : j(jj), s(ss), restarts_to_go(jj.restart_interval) { reset_stats(); }

    void reset_stats() {
        for (int i = 0; i < s.ns; i++) {
            const Component& cp = *s.c[i];
            if (!j.progressive || (s.Ss == 0 && s.Ah == 0)) {
                std::memset(j.dc_stats[cp.dc_tbl], 0, 64);
                last_dc[i] = dc_context[i] = 0;
            }
            if (!j.progressive || s.Ss) std::memset(j.ac_stats[cp.ac_tbl], 0, 256);
        }
    }

    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                int data = 0;
                if (!j.unread_marker) {
                    data = j.src.byte();
                    if (data == 0xFF) {
                        do {
                            data = j.src.byte();
                        } while (data == 0xFF);
                        if (data == 0) {
                            data = 0xFF;
                        } else {
                            j.unread_marker = data;
                            data = 0;
                        }
                    }
                }
                c = (c << 8) | data;
                if ((ct += 8) < 0) {
                    if (++ct == 0) a = 0x8000;
                }
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAriTab[sv & 0x7F];
        uint8_t nl = static_cast<uint8_t>(qe & 0xFF);
        qe >>= 8;
        uint8_t nm = static_cast<uint8_t>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    void process_restart() {
        read_restart_marker(j);
        reset_stats();
        c = a = 0;
        ct = -16;
        restarts_to_go = static_cast<unsigned>(j.restart_interval);
    }

    // Figures F.19-F.24: a DC difference (st0 = the context's first bin).
    // Returns false on a magnitude overflow (error state set).
    bool dc_diff(int i, int tbl, int* out) {
        uint8_t* st = j.dc_stats[tbl] + dc_context[i];
        if (decode(st) == 0) {
            dc_context[i] = 0;
            *out = 0;
            return true;
        }
        int sign = decode(st + 1);
        st += 2 + sign;
        int m = decode(st);
        if (m != 0) {
            st = j.dc_stats[tbl] + 20;
            while (decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ct = -1;
                    return false;
                }
                st += 1;
            }
        }
        if (m < static_cast<int>((1L << j.arith_dc_L[tbl]) >> 1)) {
            dc_context[i] = 0;
        } else if (m > static_cast<int>((1L << j.arith_dc_U[tbl]) >> 1)) {
            dc_context[i] = 12 + sign * 4;
        } else {
            dc_context[i] = 4 + sign * 4;
        }
        int v = m;
        st += 14;
        while (m >>= 1) {
            if (decode(st)) v |= m;
        }
        v += 1;
        if (sign) v = -v;
        *out = v;
        return true;
    }

    // Figure F.20 from k to Se; false on an overflow (error state set).
    bool ac_values(int tbl, int k, int Se, int16_t* block, int Al) {
        for (; k <= Se; k++) {
            uint8_t* st = j.ac_stats[tbl] + 3 * (k - 1);
            if (decode(st)) break;  // EOB
            while (decode(st + 1) == 0) {
                st += 3;
                if (++k > Se) {
                    ct = -1;
                    return false;
                }
            }
            int sign = decode(fixed_bin);
            st += 2;
            int m = decode(st);
            if (m != 0) {
                if (decode(st)) {
                    m <<= 1;
                    st = j.ac_stats[tbl] + (k <= j.arith_ac_K[tbl] ? 189 : 217);
                    while (decode(st)) {
                        if ((m <<= 1) == 0x8000) {
                            ct = -1;
                            return false;
                        }
                        st += 1;
                    }
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1) {
                if (decode(st)) v |= m;
            }
            v += 1;
            if (sign) v = -v;
            block[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << Al);
        }
        return true;
    }

    void mcu(int16_t* const* blk, const int* memb, int nblk) {
        if (j.restart_interval) {
            if (restarts_to_go == 0) process_restart();
            restarts_to_go--;
        }
        if (j.progressive && s.Ss == 0 && s.Ah != 0) {  // DC refine
            const int p1 = 1 << s.Al;
            for (int b = 0; b < nblk; b++) {
                if (decode(fixed_bin)) blk[b][0] = static_cast<int16_t>(blk[b][0] | p1);
            }
            return;
        }
        if (ct == -1) return;
        if (!j.progressive) {  // decode_mcu
            for (int b = 0; b < nblk; b++) {
                const int i = memb[b];
                const Component& cp = *s.c[i];
                int v;
                if (!dc_diff(i, cp.dc_tbl, &v)) return;
                last_dc[i] += v;
                blk[b][0] = static_cast<int16_t>(last_dc[i]);
                if (!ac_values(cp.ac_tbl, 1, 63, blk[b], 0)) return;
            }
        } else if (s.Ss == 0) {  // DC first
            for (int b = 0; b < nblk; b++) {
                const int i = memb[b];
                int v;
                if (!dc_diff(i, s.c[i]->dc_tbl, &v)) return;
                last_dc[i] = (last_dc[i] + v) & 0xffff;
                blk[b][0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[i]) << s.Al);
            }
        } else if (s.Ah == 0) {  // AC first
            ac_values(s.c[0]->ac_tbl, s.Ss, s.Se, blk[0], s.Al);
        } else {  // AC refine
            const int tbl = s.c[0]->ac_tbl;
            const int p1 = 1 << s.Al, m1 = static_cast<int>(~0u << s.Al);
            int16_t* block = blk[0];
            int kex = s.Se;
            for (; kex > 0; kex--) {
                if (block[kNaturalOrder[kex]]) break;
            }
            for (int k = s.Ss; k <= s.Se; k++) {
                uint8_t* st = j.ac_stats[tbl] + 3 * (k - 1);
                if (k > kex && decode(st)) break;
                for (;;) {
                    int16_t* c = block + kNaturalOrder[k];
                    if (*c) {
                        if (decode(st + 2)) *c = static_cast<int16_t>(*c < 0 ? *c + m1 : *c + p1);
                        break;
                    }
                    if (decode(st + 1)) {
                        *c = static_cast<int16_t>(decode(fixed_bin) ? m1 : p1);
                        break;
                    }
                    st += 3;
                    if (++k > s.Se) {
                        ct = -1;
                        return;
                    }
                }
            }
        }
    }
};

Scan parse_sos(Jpeg& j, const std::vector<uint8_t>& seg) {
    if (!j.have_frame) fail("SOS before SOF");
    const int n = static_cast<int>(seg.size());
    if (n < 1) fail("short SOS segment");
    Scan s;
    s.ns = seg[0];
    if (n != 2 * s.ns + 4 || s.ns < 1 || s.ns > 4) fail("bad SOS segment");
    for (int i = 0; i < s.ns; i++) {
        int cid = seg[1 + 2 * i];
        int c = 0;
        while (c < j.ncomp && j.comp[c].id != cid) c++;
        if (c == j.ncomp) fail("SOS names an unknown component");
        for (int k = 0; k < i; k++) {
            if (s.ci[k] == c) fail("SOS names a component twice");
        }
        s.c[i] = &j.comp[c];
        s.ci[i] = c;
        s.c[i]->dc_tbl = seg[2 + 2 * i] >> 4;
        s.c[i]->ac_tbl = seg[2 + 2 * i] & 15;
    }
    s.Ss = seg[1 + 2 * s.ns];
    s.Se = seg[2 + 2 * s.ns];
    s.Ah = seg[3 + 2 * s.ns] >> 4;
    s.Al = seg[3 + 2 * s.ns] & 15;
    j.input_scan_number++;
    j.next_restart_num = 0;
    if (j.lossless) {  // jdlossls.c start_input_pass, jdlhuff.c start_pass_lhuff_decoder
        if (s.Ss < 1 || s.Ss > 7 || s.Se != 0 || s.Ah != 0 || s.Al >= j.precision) {
            fail("lossless JPEG (SOF3) with predictor " + std::to_string(s.Ss) + ", Se " + std::to_string(s.Se) +
                 ", Ah " + std::to_string(s.Ah) + ", Al " + std::to_string(s.Al) + ": bad scan parameters");
        }
        int mcus_per_row = s.ns == 1 ? s.c[0]->width : j.mcux;
        if (j.restart_interval % mcus_per_row) fail("lossless JPEG (SOF3): restart interval is not whole MCU rows");
        for (int i = 0; i < s.ns; i++) {
            if (s.c[i]->dc_tbl > 3 || !j.dc[s.c[i]->dc_tbl].defined) fail("SOS uses an undefined Huffman table");
            if (j.dc[s.c[i]->dc_tbl].max_symbol > 16) fail("bad Huffman table (lossless symbol above 16)");
        }
        if (s.ns > 1) {
            int units = 0;
            for (int i = 0; i < s.ns; i++) units += s.c[i]->h * s.c[i]->v;
            if (units > 10) fail("too many blocks in an MCU");
        }
        return s;
    }
    if (j.progressive) {  // start_pass_phuff_decoder / jdarith.c start_pass
        bool bad = false;
        if (s.Ss == 0) {
            bad = s.Se != 0;
        } else {
            bad = s.Se < s.Ss || s.Se > 63 || s.ns != 1;
        }
        if (s.Ah != 0 && s.Al != s.Ah - 1) bad = true;
        if (s.Al > 13) bad = true;
        if (bad) fail("bad progressive scan parameters");
        for (int i = 0; i < s.ns; i++) {
            int* bits = j.coef_bits[s.ci[i]];
            int* prev = j.prev_coef_bits[s.ci[i]];
            int lo = s.Ss < 1 ? s.Ss : 1, hi = s.Se > 9 ? s.Se : 9;
            for (int k = lo; k <= hi; k++) prev[k] = j.input_scan_number > 1 ? bits[k] : 0;
            for (int k = s.Ss; k <= s.Se; k++) bits[k] = s.Al;
        }
    }  // a sequential scan's Ss, Se, Ah and Al are not used (libjpeg only warns)
    for (int i = 0; i < s.ns; i++) {  // jdinput.c latch_quant_tables
        Component& cp = *s.c[i];
        if (!cp.quant_latched) {
            if (!j.qt_defined[cp.tq]) fail("component uses an undefined quantization table");
            std::memcpy(cp.quant, j.qt[cp.tq], sizeof(cp.quant));
            cp.quant_latched = true;
        }
        bool dc_used = !j.progressive || (s.Ss == 0 && s.Ah == 0);
        bool ac_used = !j.progressive || s.Ss != 0;
        if (j.arith) {
            if (cp.dc_tbl > 15 || cp.ac_tbl > 15) fail("bad arithmetic conditioning table index");
        } else {
            if ((dc_used && (cp.dc_tbl > 3 || !j.dc[cp.dc_tbl].defined)) ||
                (ac_used && (cp.ac_tbl > 3 || !j.ac[cp.ac_tbl].defined))) {
                fail("SOS uses an undefined Huffman table");
            }
            // jdhuff.c jpeg_make_d_derived_tbl: a DC symbol is a bit count
            if (dc_used && j.dc[cp.dc_tbl].max_symbol > 15) fail("bad Huffman table (DC symbol above 15)");
        }
    }
    if (s.ns > 1) {
        int blocks = 0;
        for (int i = 0; i < s.ns; i++) blocks += s.c[i]->h * s.c[i]->v;
        if (blocks > 10) fail("too many blocks in an MCU");
    }
    return s;
}

// Decode one scan's MCUs in libjpeg's order (jdcoefct.c consume_data).
template <class Decoder>
void run_scan(Jpeg& j, const Scan& s) {
    Decoder d(j, s);
    int16_t* blk[10];
    int memb[10];
    if (s.ns == 1) {
        Component& cp = *s.c[0];
        memb[0] = 0;
        for (int by = 0; by < cp.hib; by++) {
            for (int bx = 0; bx < cp.wib; bx++) {
                if (!d.insufficient) j.last_good_iMCU_row = by / cp.v;
                blk[0] = cp.block(by, bx);
                d.mcu(blk, memb, 1);
            }
        }
        return;
    }
    for (int my = 0; my < j.mcuy; my++) {
        for (int mx = 0; mx < j.mcux; mx++) {
            int n = 0;
            for (int i = 0; i < s.ns; i++) {
                Component& cp = *s.c[i];
                for (int by = 0; by < cp.v; by++) {
                    for (int bx = 0; bx < cp.h; bx++) {
                        memb[n] = i;
                        blk[n++] = cp.block(my * cp.v + by, mx * cp.h + bx);
                    }
                }
            }
            if (!d.insufficient) j.last_good_iMCU_row = my;
            d.mcu(blk, memb, n);
        }
    }
}

// jdpred.c's undifferencing of one row after its first sample: predictor
// 1-7 from the row's left neighbour Ra, the one above Rb and above-left Rc,
// each sum taken modulo 2^16 (the predictor's loop picked once per row).
template <int P>
void undifference_row(const int32_t* df, const uint16_t* pv, uint16_t* cur, int W) {
    int Ra = cur[0], Rb = pv[0], Rc;
    for (int x = 1; x < W; x++) {
        Rc = Rb;
        Rb = pv[x];
        int p;
        if (P == 1) p = Ra;
        if (P == 2) p = Rb;
        if (P == 3) p = Rc;
        if (P == 4) p = Ra + Rb - Rc;
        if (P == 5) p = Ra + ((Rb - Rc) >> 1);
        if (P == 6) p = Rb + ((Ra - Rc) >> 1);
        if (P == 7) p = (Ra + Rb) >> 1;
        Ra = (df[x] + p) & 0xFFFF;
        cur[x] = static_cast<uint16_t>(Ra);
    }
}

void undifference(int pred, const int32_t* df, const uint16_t* pv, uint16_t* cur, int W) {
    switch (pred) {
        case 1: undifference_row<1>(df, pv, cur, W); break;
        case 2: undifference_row<2>(df, pv, cur, W); break;
        case 3: undifference_row<3>(df, pv, cur, W); break;
        case 4: undifference_row<4>(df, pv, cur, W); break;
        case 5: undifference_row<5>(df, pv, cur, W); break;
        case 6: undifference_row<6>(df, pv, cur, W); break;
        default: undifference_row<7>(df, pv, cur, W); break;
    }
}

// One lossless scan (jddiffct.c decompress_data), an iMCU row at a time:
// its MCU rows' sample differences (jdlhuff.c decode_mcus), then each
// component row undifferenced against the one above (jdpred.c) and scaled
// by << Al into the component's samples. A restart (whole MCU rows) and the
// scan's start make the next undifferenced row of every component a first
// row, predicted from the left. Once the data has run out (a zero bit past
// the end was consumed), each later MCU row's differences are zero and the
// predictors are reset, so the rest of the scan is 1 << (P - 1). Both resets
// take effect before the iMCU row is undifferenced, as in libjpeg-turbo.
void run_lossless_scan(Jpeg& j, const Scan& s) {
    HuffDecoder d(j, s);
    const bool single = s.ns == 1;
    const int cols = single ? s.c[0]->width : j.mcux;
    const int restart_rows = j.restart_interval ? j.restart_interval / cols : 0;
    struct Unit {
        Component* cp;
        int uh, uv, rowlen;
        std::vector<int32_t> diff;
        std::vector<uint16_t> prev;
        bool first = true;
    };
    std::vector<Unit> units(static_cast<size_t>(s.ns));
    int rows_per_imcu = 1;
    for (int i = 0; i < s.ns; i++) {
        Unit& u = units[static_cast<size_t>(i)];
        u.cp = s.c[i];
        u.uh = single ? 1 : u.cp->h;
        u.uv = u.cp->v;
        u.rowlen = cols * u.uh;
        u.diff.assign(static_cast<size_t>(u.rowlen) * u.uv, 0);
        u.prev.assign(static_cast<size_t>(u.cp->width), 0);
    }
    if (single) rows_per_imcu = s.c[0]->v;  // MCU rows (one sample row each) per iMCU row
    const int initial = 1 << (j.precision - s.Al - 1);
    const int pred = s.Ss, Al = s.Al;
    int rows_to_go = restart_rows;
    std::vector<uint16_t> cur;
    for (int iy = 0; iy < j.mcuy; iy++) {
        const bool last = iy == j.mcuy - 1;
        int mcu_rows = single ? rows_per_imcu : 1;
        if (single && last) mcu_rows = s.c[0]->height - iy * rows_per_imcu;
        for (int yo = 0; yo < mcu_rows; yo++) {
            if (restart_rows) {
                if (rows_to_go == 0) {  // jdlhuff.c process_restart, jdpred.c predict_process_restart
                    d.buf = 0;
                    d.count = d.real = 0;
                    read_restart_marker(j);
                    if (!j.unread_marker) d.insufficient = false;
                    for (Unit& u : units) u.first = true;
                    rows_to_go = restart_rows;
                }
            }
            if (d.insufficient) {  // "leave the MCU row zero, reset the undifferencer"
                for (Unit& u : units) {
                    const size_t lo = single ? static_cast<size_t>(yo) * u.rowlen : 0;
                    std::fill(u.diff.data() + lo, single ? u.diff.data() + lo + u.rowlen : u.diff.data() + u.diff.size(), 0);
                }
                for (Unit& u : units) u.first = true;
            } else {
                for (int mx = 0; mx < cols; mx++) {
                    for (Unit& u : units) {
                        const HuffTable& t = j.dc[u.cp->dc_tbl];
                        const int ny = single ? 1 : u.uv;
                        for (int yy = 0; yy < ny; yy++) {
                            for (int xx = 0; xx < u.uh; xx++) {
                                int v = d.decode(t);
                                if (v == 16) {
                                    v = 32768;
                                } else if (v) {
                                    v = huff_extend(d.get_bits(v), v);
                                }
                                u.diff[static_cast<size_t>(single ? yo : yy) * u.rowlen + mx * u.uh + xx] = v;
                            }
                        }
                    }
                }
            }
            if (restart_rows) rows_to_go--;
        }
        for (Unit& u : units) {
            Component& cp = *u.cp;
            const int W = cp.width;
            cur.resize(static_cast<size_t>(W));
            for (int yy = 0; yy < u.uv; yy++) {
                const int r = iy * u.uv + yy;
                if (r >= cp.height) break;
                const int32_t* df = &u.diff[static_cast<size_t>(yy) * u.rowlen];
                const uint16_t* pv = u.prev.data();
                int Ra;
                if (u.first) {  // jpeg_undifference_first_row: the left neighbour
                    Ra = (df[0] + initial) & 0xFFFF;
                    cur[0] = static_cast<uint16_t>(Ra);
                    for (int x = 1; x < W; x++) cur[static_cast<size_t>(x)] = static_cast<uint16_t>(Ra = (df[x] + Ra) & 0xFFFF);
                    u.first = false;
                } else {
                    cur[0] = static_cast<uint16_t>((df[0] + pv[0]) & 0xFFFF);
                    undifference(pred, df, pv, cur.data(), W);
                }
                uint8_t* o = &cp.samp[static_cast<size_t>(r) * cp.bw];
                for (int x = 0; x < W; x++) o[x] = static_cast<uint8_t>(cur[static_cast<size_t>(x)] << Al);
                u.prev.swap(cur);
            }
        }
    }
    for (int i = 0; i < s.ns; i++) s.c[i]->scanned = true;
}

std::vector<uint8_t> read_segment(Jpeg& j) {
    int hi = j.src.byte();
    int lo = j.src.byte();
    int seglen = (hi << 8) | lo;
    if (seglen < 2) fail("bad marker segment length");
    std::vector<uint8_t> seg(static_cast<size_t>(seglen - 2));
    Source& s = j.src;
    if (s.pos + seg.size() <= s.len) {
        std::memcpy(seg.data(), s.data + s.pos, seg.size());
        s.pos += seg.size();
    } else {
        for (auto& b : seg) b = static_cast<uint8_t>(s.byte());
    }
    return seg;
}

// Read markers and decode scans (jdmarker.c read_markers). With headers_only
// the parse stops at the first SOS (jpeg_read_header).
void parse(Jpeg& j, bool headers_only) {
    Source& src = j.src;
    if (src.len < 2 || src.data[0] != 0xFF || src.data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    src.pos = 2;
    for (int i = 0; i < 16; i++) {
        j.arith_dc_L[i] = 0;
        j.arith_dc_U[i] = 1;
        j.arith_ac_K[i] = 5;
    }
    bool saw_scan = false;
    for (;;) {
        int marker = j.unread_marker ? j.unread_marker : next_marker(src);
        j.unread_marker = 0;
        if (marker == 0xD9) {  // EOI
            if (!saw_scan) fail("no image data before EOI");
            return;
        }
        if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
        if (marker == 0x01) continue;                     // TEM
        if (marker == 0xD8) fail("second SOI marker");
        std::vector<uint8_t> seg = read_segment(j);
        const int n = static_cast<int>(seg.size());
        switch (marker) {
            case 0xC0:
            case 0xC1:
            case 0xC2:
            case 0xC9:
            case 0xCA:
                if (j.have_frame) fail("more than one SOF marker");
                parse_frame(j, seg, marker);
                break;
            case 0xC3:
                if (j.have_frame) fail("more than one SOF marker");
                parse_frame(j, seg, marker);
                break;
            case 0xCB:
                fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
            case 0xC5:
            case 0xC6:
            case 0xC7:
            case 0xCD:
            case 0xCE:
            case 0xCF:
                fail("hierarchical JPEG (SOF" + std::to_string(marker - 0xC0) + ") is not supported");
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
                    build_huff(tc ? j.ac[th] : j.dc[th], bits, seg.data() + p + 17, count);
                    p += 17 + count;
                }
                break;
            }
            case 0xCC: {  // DAC
                for (int p = 0; p + 1 < n; p += 2) {
                    int index = seg[p], val = seg[p + 1];
                    if (index >= 32) fail("bad DAC table index");
                    if (index >= 16) {
                        j.arith_ac_K[index - 16] = static_cast<uint8_t>(val);
                    } else {
                        j.arith_dc_L[index] = static_cast<uint8_t>(val & 15);
                        j.arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
                        if (j.arith_dc_L[index] > j.arith_dc_U[index]) fail("bad DAC value");
                    }
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
                            pq ? be16(seg.data() + p + 1 + 2 * i) : static_cast<uint16_t>(seg[p + 1 + i]);
                    }
                    j.qt_defined[tq] = true;
                    p += need;
                }
                break;
            }
            case 0xDD:  // DRI
                if (n != 2) fail("bad DRI segment");
                j.restart_interval = be16(seg.data());
                break;
            case 0xDA: {  // SOS
                Scan s = parse_sos(j, seg);
                if (headers_only) return;
                if (j.lossless) {
                    run_lossless_scan(j, s);
                } else if (j.arith) {
                    run_scan<ArithDecoder>(j, s);
                } else {
                    run_scan<HuffDecoder>(j, s);
                }
                saw_scan = true;
                break;
            }
            case 0xE0:
                if (n >= 14 && std::memcmp(seg.data(), "JFIF\0", 5) == 0) j.saw_jfif = true;
                break;
            case 0xE1:  // OpenCV reads the first APP1 past its 6-byte header
                if (!j.saw_app1) {
                    j.saw_app1 = true;
                    if (n > 6) j.orientation = exif_orientation(seg.data() + 6, static_cast<size_t>(n - 6));
                }
                break;
            case 0xEE:
                if (n >= 12 && std::memcmp(seg.data(), "Adobe", 5) == 0) {
                    j.saw_adobe = true;
                    j.adobe_transform = seg[11];
                }
                break;
            default:  // other APPn, COM and DNL are skipped, as libjpeg does
                if (!((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE || marker == 0xDC)) {
                    fail("unknown JPEG marker 0x" + std::to_string(marker));
                }
                break;
        }
    }
}

// libjpeg-turbo's SIMD islow IDCT (jidctint-sse2.asm / -avx2.asm), which
// cv2's x86-64 build runs: jidctint.c's arithmetic (CONST_BITS 13,
// PASS1_BITS 2) in the SIMD data widths. Coefficients are dequantized by a
// 16-bit multiply (pmullw), in0 +/- in4 and the odd part's z3 = in7 + in3,
// z4 = in5 + in1 are 16-bit sums, products and sums are 32-bit, each pass's
// outputs saturate to 16 bits (packssdw) and the samples saturate to
// [-128, 127] before the +128 shift (packsswb). On every block of a valid
// file this equals the C version; on the out-of-range coefficients of a cut
// or corrupt one it is what cv2 returns. A block whose rows 1-7 are all zero
// takes the DC-only pass 1 (psllw: a 16-bit shift).
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int16_t w16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t w32(int64_t x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }
inline int16_t sat16(int32_t x) { return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }

// One 1-D pass over 8 values: out[k] = sat16((x + round) >> shift).
inline void idct_1d(const int16_t* in, int16_t* out, int shift) {
    const int32_t z2 = in[2], z3 = in[6];
    const int32_t tmp3e = w32(int64_t(z2) * (FIX_0_541196100 + FIX_0_765366865) + int64_t(z3) * FIX_0_541196100);
    const int32_t tmp2e = w32(int64_t(z2) * FIX_0_541196100 + int64_t(z3) * (FIX_0_541196100 - FIX_1_847759065));
    const int32_t tmp0e = static_cast<int32_t>(static_cast<uint32_t>(int32_t(w16(in[0] + in[4]))) << CONST_BITS);
    const int32_t tmp1e = static_cast<int32_t>(static_cast<uint32_t>(int32_t(w16(in[0] - in[4]))) << CONST_BITS);
    const int32_t tmp10 = w32(int64_t(tmp0e) + tmp3e), tmp13 = w32(int64_t(tmp0e) - tmp3e);
    const int32_t tmp11 = w32(int64_t(tmp1e) + tmp2e), tmp12 = w32(int64_t(tmp1e) - tmp2e);
    const int32_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
    const int32_t zo3 = w16(i7 + i3), zo4 = w16(i5 + i1);
    const int32_t z3o = w32(int64_t(zo3) * (FIX_1_175875602 - FIX_1_961570560) + int64_t(zo4) * FIX_1_175875602);
    const int32_t z4o = w32(int64_t(zo3) * FIX_1_175875602 + int64_t(zo4) * (FIX_1_175875602 - FIX_0_390180644));
    const int32_t t0 = w32(int64_t(i7) * (FIX_0_298631336 - FIX_0_899976223) + int64_t(i1) * -FIX_0_899976223 + z3o);
    const int32_t t3 = w32(int64_t(i7) * -FIX_0_899976223 + int64_t(i1) * (FIX_1_501321110 - FIX_0_899976223) + z4o);
    const int32_t t1 = w32(int64_t(i5) * (FIX_2_053119869 - FIX_2_562915447) + int64_t(i3) * -FIX_2_562915447 + z4o);
    const int32_t t2 = w32(int64_t(i5) * -FIX_2_562915447 + int64_t(i3) * (FIX_3_072711026 - FIX_2_562915447) + z3o);
    const int64_t r = int64_t(1) << (shift - 1);
    auto d = [&](int64_t x) { return sat16(w32(w32(x) + r) >> shift); };
    out[0] = d(int64_t(tmp10) + t3);
    out[7] = d(int64_t(tmp10) - t3);
    out[1] = d(int64_t(tmp11) + t2);
    out[6] = d(int64_t(tmp11) - t2);
    out[2] = d(int64_t(tmp12) + t1);
    out[5] = d(int64_t(tmp12) - t1);
    out[3] = d(int64_t(tmp13) + t0);
    out[4] = d(int64_t(tmp13) - t0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int16_t ws[64];  // pass 1 output, transposed: ws[c * 8 + r]
    bool ac_zero = true;
    for (int i = 8; i < 64 && ac_zero; i++) ac_zero = in[i] == 0;
    if (ac_zero) {
        for (int c = 0; c < 8; c++) {
            const int16_t dc = w16(static_cast<int32_t>(static_cast<uint32_t>(int32_t(w16(in[c] * q[c]))) << PASS1_BITS));
            for (int r = 0; r < 8; r++) ws[c * 8 + r] = dc;
        }
    } else {
        for (int c = 0; c < 8; c++) {
            int16_t col[8];
            for (int r = 0; r < 8; r++) col[r] = w16(in[r * 8 + c] * q[r * 8 + c]);
            idct_1d(col, ws + c * 8, CONST_BITS - PASS1_BITS);
        }
    }
    for (int r = 0; r < 8; r++) {
        int16_t row[8], res[8];
        for (int c = 0; c < 8; c++) row[c] = ws[c * 8 + r];
        idct_1d(row, res, CONST_BITS + PASS1_BITS + 3);
        uint8_t* op = out + static_cast<size_t>(r) * stride;
        for (int c = 0; c < 8; c++) op[c] = static_cast<uint8_t>((res[c] < -128 ? -128 : (res[c] > 127 ? 127 : res[c])) + 128);
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

// jdcoefct.c smoothing_ok: smoothing applies to a progressive file whose
// components all have their quantisation tables latched, nonzero entries at
// the DC and first 9 AC positions, some DC data, and an AC coefficient among
// the first 9 that is not known to full precision. Latches the progression
// status of coefficients 0-9 (SAVED_COEFS), now and before the last scan.
bool smoothing_ok(const Jpeg& j, int latch[4][10], int prev_latch[4][10]) {
    if (!j.progressive) return false;
    bool useful = false;
    for (int c = 0; c < j.ncomp; c++) {
        const Component& cp = j.comp[c];
        if (!cp.quant_latched) return false;
        const uint16_t* q = cp.quant;
        if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] || !q[10] || !q[17] || !q[24]) {
            return false;
        }
        if (j.coef_bits[c][0] < 0) return false;
        latch[c][0] = j.coef_bits[c][0];
        for (int k = 1; k < 10; k++) {
            prev_latch[c][k] = j.input_scan_number > 1 ? j.prev_coef_bits[c][k] : -1;
            latch[c][k] = j.coef_bits[c][k];
            if (latch[c][k] != 0) useful = true;
        }
    }
    return useful;
}

inline int smooth_pred(int64_t num, int64_t q, int Al) {
    int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    return num >= 0 ? pred : -pred;
}

// jdcoefct.c decompress_smooth_data for one component: each block's first 9
// AC coefficients, where still zero and not known to full precision, are
// estimated from the DC values of the 5x5 blocks around it (and the DC
// itself when no AC data came at all). The neighbour rows follow libjpeg's
// own indexing, including its short last iMCU row.
void idct_smoothed(const Jpeg& j, Component& cp, const int* cur_bits, const int* prev_bits, uint8_t* plane,
                   int stride) {
    const int T = j.mcuy;
    const int64_t Q00 = cp.quant[0], Q01 = cp.quant[1], Q10 = cp.quant[8], Q20 = cp.quant[16],
                  Q11 = cp.quant[9], Q02 = cp.quant[2], Q03 = cp.quant[3], Q12 = cp.quant[10],
                  Q21 = cp.quant[17], Q30 = cp.quant[24];
    int16_t ws[64];
    for (int i = 0; i < T; i++) {
        int block_rows = cp.v;
        if (i == T - 1) {
            block_rows = cp.hib % cp.v;
            if (block_rows == 0) block_rows = cp.v;
        }
        const int* bits = i > j.last_good_iMCU_row ? prev_bits : cur_bits;
        bool change_dc = true;
        for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
        const int N = block_rows * T;
        for (int b = 0; b < block_rows; b++) {
            const int R = i * cp.v + b, I = i * block_rows + b;
            const int r0 = R, r_1 = I > 0 ? R - 1 : R;
            const int r_2 = I > 1 ? R - 2 : r_1;
            const int r1 = I < N - 1 ? R + 1 : R;
            const int r2 = I < N - 2 ? R + 2 : r1;
            auto dc = [&](int row, int col) -> int { return cp.block(row, col)[0]; };
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14, DC15, DC16,
                DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = dc(r_2, 0);
            DC06 = DC07 = DC08 = DC09 = DC10 = dc(r_1, 0);
            DC11 = DC12 = DC13 = DC14 = DC15 = dc(r0, 0);
            DC16 = DC17 = DC18 = DC19 = DC20 = dc(r1, 0);
            DC21 = DC22 = DC23 = DC24 = DC25 = dc(r2, 0);
            const int last = cp.wib - 1;
            for (int bx = 0; bx <= last; bx++) {
                std::memcpy(ws, cp.block(R, bx), sizeof(ws));
                if (bx == 0 && bx < last) {
                    DC04 = DC05 = dc(r_2, 1);
                    DC09 = DC10 = dc(r_1, 1);
                    DC14 = DC15 = dc(r0, 1);
                    DC19 = DC20 = dc(r1, 1);
                    DC24 = DC25 = dc(r2, 1);
                }
                if (bx + 1 < last) {
                    DC05 = dc(r_2, bx + 2);
                    DC10 = dc(r_1, bx + 2);
                    DC15 = dc(r0, bx + 2);
                    DC20 = dc(r1, bx + 2);
                    DC25 = dc(r2, bx + 2);
                }
                int Al;
                if ((Al = bits[1]) != 0 && ws[1] == 0) {  // AC01
                    int64_t num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                                      13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                                                      3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                                      DC21 - DC22 + DC24 + DC25)
                                                   : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = static_cast<int16_t>(smooth_pred(num, Q01, Al));
                }
                if ((Al = bits[2]) != 0 && ws[8] == 0) {  // AC10
                    int64_t num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                                      13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                                      13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                                      3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                                   : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = static_cast<int16_t>(smooth_pred(num, Q10, Al));
                }
                if ((Al = bits[3]) != 0 && ws[16] == 0) {  // AC20
                    int64_t num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                                      14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                                   : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = static_cast<int16_t>(smooth_pred(num, Q20, Al));
                }
                if ((Al = bits[4]) != 0 && ws[9] == 0) {  // AC11
                    int64_t num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                                      DC21 - DC25)
                                                   : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                                      DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = static_cast<int16_t>(smooth_pred(num, Q11, Al));
                }
                if ((Al = bits[5]) != 0 && ws[2] == 0) {  // AC02
                    int64_t num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                                      14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                                   : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = static_cast<int16_t>(smooth_pred(num, Q02, Al));
                }
                if (change_dc) {
                    if ((Al = bits[6]) != 0 && ws[3] == 0) {  // AC03
                        int64_t num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
                        ws[3] = static_cast<int16_t>(smooth_pred(num, Q03, Al));
                    }
                    if ((Al = bits[7]) != 0 && ws[10] == 0) {  // AC12
                        int64_t num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
                        ws[10] = static_cast<int16_t>(smooth_pred(num, Q12, Al));
                    }
                    if ((Al = bits[8]) != 0 && ws[17] == 0) {  // AC21
                        int64_t num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
                        ws[17] = static_cast<int16_t>(smooth_pred(num, Q21, Al));
                    }
                    if ((Al = bits[9]) != 0 && ws[24] == 0) {  // AC30
                        int64_t num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
                        ws[24] = static_cast<int16_t>(smooth_pred(num, Q30, Al));
                    }
                    int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                                         6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                                         6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
                    ws[0] = static_cast<int16_t>(smooth_pred(num, Q00, 0));
                }
                idct_islow(ws, cp.quant, plane + static_cast<size_t>(R) * 8 * stride + bx * 8, stride);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

// The decoded image in cv2's colour form: channels 3 gives RGB (the order
// reversed from what cv2 returns), channels 1 the gray plane of a
// 1-component file (cv2's IMREAD_UNCHANGED).
void render_lossless(Jpeg& j, uint8_t* out, int channels);

void render(Jpeg& j, uint8_t* out, int channels) {
    if (j.lossless) {
        render_lossless(j, out, channels);
        return;
    }
    const int W = j.width, H = j.height;
    int latch[4][10], prev_latch[4][10];
    const bool smooth = smoothing_ok(j, latch, prev_latch);
    static const uint16_t kZeroQuant[64] = {};  // a component with no scan: grey
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(j.ncomp));
    for (int c = 0; c < j.ncomp; c++) {
        Component& cp = j.comp[c];
        const int stride = cp.bw * 8;
        std::vector<uint8_t> plane(static_cast<size_t>(stride) * cp.bh * 8);
        if (smooth) {
            idct_smoothed(j, cp, latch[c], prev_latch[c], plane.data(), stride);
        } else {
            const uint16_t* q = cp.quant_latched ? cp.quant : kZeroQuant;
            for (int by = 0; by < cp.hib; by++) {
                for (int bx = 0; bx < cp.wib; bx++) {
                    idct_islow(cp.block(by, bx), q, &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
                }
            }
        }
        full[c] = upsample(cp, plane, j.hmax, j.vmax, W, H);
    }
    const size_t n = static_cast<size_t>(W) * H;
    if (j.ncomp == 1) {
        const uint8_t* y = full[0].data();
        if (channels == 1) {
            std::memcpy(out, y, n);
        } else {
            for (size_t i = 0; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
        }
        return;
    }
    if (j.colour == 0) {  // JCS_UNKNOWN: the components as they are (tif_jpeg.c)
        if (channels != j.ncomp) fail("the components of a JPEG decode to one channel each");
        for (size_t i = 0; i < n; i++) {
            for (int c = 0; c < j.ncomp; c++) out[static_cast<size_t>(j.ncomp) * i + c] = full[c][i];
        }
        return;
    }
    if (channels != 3) fail("a colour JPEG decodes to 3 channels");
    static const ColorTables t;
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (j.colour == 1 && j.ncomp != 3) fail("YCbCr to RGB of a JPEG without 3 components");
    if (j.ncomp == 4) {
        // jdapimin.c: Adobe transform 0 is CMYK, any other YCCK, no Adobe
        // marker CMYK; libjpeg outputs CMYK and OpenCV's
        // icvCvt_CMYK2BGR_8u_C4C3R takes it to BGR
        const bool ycck = j.saw_adobe && j.adobe_transform != 0;
        const uint8_t* p3 = full[3].data();
        for (size_t i = 0; i < n; i++) {
            int cc = p0[i], mm = p1[i], yy = p2[i], k = p3[i];
            if (ycck) {  // jdcolor.c ycck_cmyk_convert
                int y = p0[i], cb = p1[i], cr = p2[i];
                cc = clamp255(255 - (y + t.cr_r[cr]));
                mm = clamp255(255 - (y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
                yy = clamp255(255 - (y + t.cb_b[cb]));
            }
            out[3 * i] = static_cast<uint8_t>(k - (((255 - cc) * k) >> 8));
            out[3 * i + 1] = static_cast<uint8_t>(k - (((255 - mm) * k) >> 8));
            out[3 * i + 2] = static_cast<uint8_t>(k - (((255 - yy) * k) >> 8));
        }
        return;
    }
    bool rgb;
    if (j.colour == 1) {
        rgb = false;
    } else if (j.saw_jfif) {
        rgb = false;
    } else if (j.saw_adobe) {
        rgb = j.adobe_transform == 0;
    } else {
        rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
    }
    if (rgb) {
        for (size_t i = 0; i < n; i++) {
            out[3 * i] = p0[i];
            out[3 * i + 1] = p1[i];
            out[3 * i + 2] = p2[i];
        }
        return;
    }
    for (size_t i = 0; i < n; i++) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        out[3 * i] = clamp255(y + t.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
}

// A lossless image in cv2's form. libjpeg-turbo upsamples it by replication
// (fancy upsampling needs DCT blocks) and converts colour only where the
// conversion is lossless: a 3-component file is RGB unless a JFIF or an
// Adobe marker says YCbCr (then refused; component IDs are not read), a
// 4-component one CMYK unless Adobe says YCCK (refused), and a gray file
// gives gray only (cv2's IMREAD_COLOR asks for RGB and is refused).
void render_lossless(Jpeg& j, uint8_t* out, int channels) {
    const int W = j.width, H = j.height;
    for (int c = 0; c < j.ncomp; c++) {  // jddiffct.c's whole-image buffer is not pre-zeroed
        if (!j.comp[c].scanned) fail("lossless JPEG ends before every component has a scan");
    }
    if (j.ncomp == 1 && channels != 1) fail("a gray lossless JPEG has no conversion to colour in libjpeg-turbo");
    if (j.ncomp == 3 && (j.saw_jfif || (j.saw_adobe && j.adobe_transform != 0))) {
        fail("a YCbCr lossless JPEG has no colour conversion in libjpeg-turbo");
    }
    if (j.ncomp == 4 && j.saw_adobe && j.adobe_transform != 0) {
        fail("a YCCK lossless JPEG has no colour conversion in libjpeg-turbo");
    }
    // each component replicated to the image size, one row at a time
    const int nc = j.ncomp;
    std::vector<std::vector<uint8_t>> row(static_cast<size_t>(nc), std::vector<uint8_t>(static_cast<size_t>(W)));
    const uint8_t* p[4] = {};
    for (int y = 0; y < H; y++) {
        for (int c = 0; c < nc; c++) {
            const Component& cp = j.comp[c];
            const int rx = j.hmax / cp.h, ry = j.vmax / cp.v;
            const uint8_t* in = &cp.samp[static_cast<size_t>(y / ry) * cp.bw];
            if (rx == 1) {
                p[c] = in;
            } else {
                uint8_t* r = row[static_cast<size_t>(c)].data();
                for (int x = 0; x < W; x++) r[x] = in[x / rx];
                p[c] = r;
            }
        }
        uint8_t* o = out + static_cast<size_t>(y) * W * (nc == 1 ? 1 : 3);
        if (nc == 1) {
            std::memcpy(o, p[0], static_cast<size_t>(W));
        } else if (nc == 3) {
            for (int x = 0; x < W; x++) {
                o[3 * x] = p[0][x];
                o[3 * x + 1] = p[1][x];
                o[3 * x + 2] = p[2][x];
            }
        } else {  // CMYK, then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
            for (int x = 0; x < W; x++) {
                int k = p[3][x];
                o[3 * x] = static_cast<uint8_t>(k - (((255 - p[0][x]) * k) >> 8));
                o[3 * x + 1] = static_cast<uint8_t>(k - (((255 - p[1][x]) * k) >> 8));
                o[3 * x + 2] = static_cast<uint8_t>(k - (((255 - p[2][x]) * k) >> 8));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// PNG samples
// ---------------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo the row filters of one image (or Adam7 pass): raw holds height rows
// of (filter byte, rowbytes bytes), bpp is the bytes per complete pixel
// (at least 1). False for an unknown filter type.
bool unfilter(const uint8_t* raw, int height, int rowbytes, int bpp, uint8_t* out) {
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
                return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Header of a JPEG, read as jpeg_read_header does (up to the first SOS):
// info = {width, height, components, EXIF orientation (0: none)}. file
// selects the stream form (1: a file, padded past its end; 0: bytes).
// 0 on success, else -1 with a message in err.
int tl_jpeg_info(const uint8_t* data, size_t len, int file, int* info, char* err, int errlen) {
    try {
        Jpeg j(data, len, file != 0);
        parse(j, true);
        if (!j.have_frame) fail("no SOF marker");
        info[0] = j.width;
        info[1] = j.height;
        info[2] = j.ncomp;
        info[3] = j.orientation;
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Decode a JPEG into out (height*width*channels; channels 3: RGB, 1: the
// gray plane of a 1-component file). 0 on success, else -1.
int tl_jpeg_decode(const uint8_t* data, size_t len, int file, uint8_t* out, int width, int height, int channels,
                   char* err, int errlen) {
    try {
        Jpeg j(data, len, file != 0);
        parse(j, false);
        if (j.width != width || j.height != height) fail("image size changed between calls");
        render(j, out, channels);
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Decode a JPEG of a TIFF strip or tile (tif_jpeg.c) into out: colour 1
// converts YCbCr to RGB (height*width*3), colour 0 leaves the components as
// they are (height*width*components; JCS_UNKNOWN). 0 on success, else -1.
int tl_jpeg_decode_colour(const uint8_t* data, size_t len, int file, uint8_t* out, int width, int height, int colour,
                          char* err, int errlen) {
    try {
        Jpeg j(data, len, file != 0);
        parse(j, false);
        if (j.width != width || j.height != height) fail("image size changed between calls");
        if (j.lossless) fail("a lossless JPEG in a TIFF");
        if (j.ncomp > 1 && colour == 0) {
            for (int c = 0; c < j.ncomp; c++) {
                if (j.comp[c].h != 1 || j.comp[c].v != 1) fail("subsampled components left unconverted");
            }
        }
        j.colour = colour;
        render(j, out, colour == 1 ? 3 : j.ncomp);
        return 0;
    } catch (const DecodeError& e) {
        copy_message(e.msg, err, errlen);
        return -1;
    } catch (const std::exception& e) {
        copy_message(e.what(), err, errlen);
        return -1;
    }
}

// Orientation (tag 0x0112) of a TIFF-structured EXIF block, 0 if none.
int tl_exif_orientation(const uint8_t* data, size_t len) { return exif_orientation(data, len); }

// Inflated PNG image data -> samples, (height, width, channels) of uint8
// (depth 1-8: sub-byte samples unpacked to their values) or native-endian
// uint16 (depth 16). Interlace 1 is Adam7: each of the seven passes is
// unfiltered on its own and its pixels placed. 0 on success, -1 for an
// unknown filter type, -2 when raw is too short.
int tl_png_samples(const uint8_t* raw, size_t rawlen, int width, int height, int depth, int channels, int interlace,
                   uint8_t* out) {
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};  // x0, y0, dx, dy
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int (*passes)[4] = interlace ? kAdam7 : kWhole;
    const int npass = interlace ? 7 : 1;
    const int bits_pp = depth * channels;
    const int bpp = bits_pp >= 8 ? bits_pp / 8 : 1;
    const int es = depth == 16 ? 2 : 1;
    size_t off = 0;
    std::vector<uint8_t> rows;
    for (int p = 0; p < npass; p++) {
        const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
        const int pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
        const int ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;
        const size_t rowbytes = (static_cast<size_t>(pw) * bits_pp + 7) / 8;
        const size_t need = (rowbytes + 1) * ph;
        if (off + need > rawlen) return -2;
        rows.resize(rowbytes * ph);
        if (!unfilter(raw + off, ph, static_cast<int>(rowbytes), bpp, rows.data())) return -1;
        off += need;
        for (int py = 0; py < ph; py++) {
            const uint8_t* r = rows.data() + py * rowbytes;
            uint8_t* o = out + (static_cast<size_t>(y0 + py * dy) * width) * channels * es;
            for (int px = 0; px < pw; px++) {
                const size_t x = static_cast<size_t>(x0 + px * dx);
                if (depth < 8) {
                    const int bit = px * depth;
                    o[x] = static_cast<uint8_t>((r[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1));
                } else if (depth == 8) {
                    std::memcpy(o + x * channels, r + static_cast<size_t>(px) * channels, channels);
                } else {
                    uint16_t* o16 = reinterpret_cast<uint16_t*>(o) + x * channels;
                    const uint8_t* s = r + static_cast<size_t>(px) * channels * 2;
                    for (int c = 0; c < channels; c++) o16[c] = static_cast<uint16_t>((s[2 * c] << 8) | s[2 * c + 1]);
                }
            }
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
