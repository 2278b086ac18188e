// Host decoders of TIFF's colour and bilevel codecs, the bit-level half of
// tpu3dlm_torch/data/containers.py's TIFF reader, held to libtiff 4.7 as
// cv2 5.0 drives it:
// - CCITT fax (tif_fax3.c, tif_fax3.h): Modified Huffman rows (compression
//   2, byte-aligned; 32771, word-aligned), T.4 1-D and 2-D (3) and T.6 (4),
//   with libtiff's bit accumulator, its lookup tables (mkg3states.c's
//   FillTable over the T.4 codes), its row clean-up and its zero padding at
//   the end of the data, so bad and short rows come out as libtiff leaves
//   them;
// - YCbCr to RGB (tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB with
//   YCbCrCoefficients and ReferenceBlackWhite) over the sampling units of
//   tif_getimage.c's putcontig8bitYCbCr* routines;
// - CIELab to RGB (TIFFCIELabToRGBInit, TIFFCIELabToXYZ, TIFFXYZToRGB with
//   tif_getimage.c's sRGB display), in single precision in libtiff's
//   operation order: FMA contraction is off in this file, and the flags of
//   kernels/build.py add no -march or -ffast-math.
//
// Built by tpu3dlm_torch/kernels/build.py (c++ -O3 -shared -fPIC) and called
// through ctypes. Entry points keep no state and touch only their buffers.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#pragma clang fp contract(off)
#pragma GCC optimize("fp-contract=off")

namespace {

// ---------------------------------------------------------------------------
// CCITT fax
// ---------------------------------------------------------------------------

enum State : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
                       S_MakeUp, S_EOL };

struct TabEnt {
    uint8_t state = S_Null, width = 0;
    uint32_t param = 0;
};

struct Code {
    const char* bits;  // in stream order
    uint32_t param;
};

// T.4's codes (the tables mkg3states.c builds libtiff's from)
const Code kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5}, {"1110", 6}, {"1111", 7},
    {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13}, {"110100", 14},
    {"110101", 15}, {"101010", 16}, {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20},
    {"0010111", 21}, {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31}, {"00011011", 32},
    {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37}, {"00010111", 38},
    {"00101000", 39}, {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43}, {"00101101", 44},
    {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50},
    {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61}, {"00110011", 62},
    {"00110100", 63}};
const Code kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320}, {"00110111", 384},
    {"01100100", 448}, {"01100101", 512}, {"01101000", 576}, {"01100111", 640}, {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};
const Code kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6}, {"00011", 7},
    {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18},
    {"00001100111", 19}, {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33},
    {"000011010010", 34}, {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48},
    {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kMakeUp[] = {  // the extended make-up codes, both colours
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920}, {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
const Code kEOLH[] = {{"00000000000", 0}};
const Code kPass[] = {{"0001", 0}};
const Code kHoriz[] = {{"001", 0}};
const Code kV0[] = {{"1", 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Code kExt[] = {{"0000001", 0}};
const Code kEOLV[] = {{"0000000", 0}};

// mkg3states.c's FillTable: the accumulator takes bits LSB first, so a
// code's first bit is the index's low bit and the bits past its width are
// free
template <size_t N>
void fill(std::vector<TabEnt>& t, int size, const Code (&codes)[N], State state) {
    const uint32_t limit = 1u << size;
    for (const Code& c : codes) {
        const int width = static_cast<int>(std::strlen(c.bits));
        uint32_t code = 0;
        for (int i = 0; i < width; i++) code |= static_cast<uint32_t>(c.bits[i] == '1') << i;
        for (uint32_t k = code; k < limit; k += 1u << width) t[k] = {static_cast<uint8_t>(state),
                                                                      static_cast<uint8_t>(width), c.param};
    }
}

struct FaxTables {
    std::vector<TabEnt> main = std::vector<TabEnt>(1 << 7), white = std::vector<TabEnt>(1 << 12),
                        black = std::vector<TabEnt>(1 << 13);
    uint8_t rev[256];
    FaxTables() {
        fill(main, 7, kPass, S_Pass);
        fill(main, 7, kHoriz, S_Horiz);
        fill(main, 7, kV0, S_V0);
        fill(main, 7, kVR, S_VR);
        fill(main, 7, kVL, S_VL);
        fill(main, 7, kExt, S_Ext);
        fill(main, 7, kEOLV, S_EOL);
        fill(white, 12, kMakeUpW, S_MakeUpW);
        fill(white, 12, kMakeUp, S_MakeUp);
        fill(white, 12, kTermW, S_TermW);
        fill(white, 12, kEOLH, S_EOL);
        fill(black, 13, kMakeUpB, S_MakeUpB);
        fill(black, 13, kMakeUp, S_MakeUp);
        fill(black, 13, kTermB, S_TermB);
        fill(black, 13, kEOLH, S_EOL);
        for (int i = 0; i < 256; i++) {
            int r = 0;
            for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
            rev[i] = static_cast<uint8_t>(r);
        }
    }
};

const FaxTables& tables() {
    static const FaxTables t;
    return t;
}

struct EndOfData {};
struct Overflow {};

// One strip or tile of fax data: tif_fax3.h's decoder state and macros
struct Fax {
    const uint8_t* cp;
    const uint8_t* ep;
    const uint8_t* start;
    bool lsb_first;  // FillOrder 2
    uint32_t acc = 0;
    int avail = 0;
    int eolcnt = 0;
    const FaxTables& t = tables();

    uint32_t byte() { return lsb_first ? *cp++ : t.rev[*cp++]; }
    // NeedBits8 / NeedBits16: at the end of the data, pad with zeros, or
    // fail when no bit is left
    void need8(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw EndOfData{};
                avail = n;
            } else {
                acc |= byte() << avail;
                avail += 8;
            }
        }
    }
    void need16(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw EndOfData{};
                avail = n;
            } else {
                acc |= byte() << avail;
                if ((avail += 8) < n) {
                    if (cp >= ep) {
                        avail = n;
                    } else {
                        acc |= byte() << avail;
                        avail += 8;
                    }
                }
            }
        }
    }
    uint32_t get(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc >>= n;
    }
    const TabEnt& lookup8(int w, const std::vector<TabEnt>& tab) {
        need8(w);
        const TabEnt& e = tab[get(w)];
        clr(e.width);
        return e;
    }
    const TabEnt& lookup16(int w, const std::vector<TabEnt>& tab) {
        need16(w);
        const TabEnt& e = tab[get(w)];
        clr(e.width);
        return e;
    }
    void sync_eol() {  // SYNC_EOL
        if (eolcnt == 0) {
            for (;;) {
                need16(11);
                if (get(11) == 0) break;
                clr(1);
            }
        }
        for (;;) {
            need8(8);
            if (get(8)) break;
            clr(8);
        }
        while (get(1) == 0) clr(1);
        clr(1);
        eolcnt = 0;
    }
};

// One half of libtiff's run array (nruns entries, the other half after it)
struct Runs {
    uint32_t* p;
    size_t n;
    uint32_t& operator[](size_t i) const { return p[i]; }
    size_t size() const { return n; }
};

// The runs of one row, as tif_fax3.h keeps them: pa points past the last
struct Row {
    Runs runs;
    size_t pa = 0;
    int64_t a0 = 0, run_length = 0;
    int64_t lastx;
    Row(Runs r, int64_t w) : runs(r), lastx(w) {}
    void set(int64_t x) {  // SETVALUE
        if (pa >= runs.size()) throw Overflow{};
        runs[pa++] = static_cast<uint32_t>(run_length + x);
        a0 += x;
        run_length = 0;
    }
    void cleanup() {  // CLEANUP_RUNS
        if (run_length) set(0);
        if (a0 != lastx) {
            while (a0 > lastx && pa > 0) a0 -= runs[--pa];
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if (pa & 1) set(0);
                set(lastx - a0);
            } else if (a0 > lastx) {
                set(lastx);
                set(0);
            }
        }
    }
};

// EXPAND1D; false where the data ended first (its clean-up done)
bool expand1d(Fax& f, Row& r) {
    try {
        for (;;) {
            for (;;) {
                const TabEnt& e = f.lookup16(12, f.t.white);
                if (e.state == S_EOL) {
                    f.eolcnt = 1;
                    goto done;
                }
                if (e.state == S_TermW) {
                    r.set(e.param);
                    break;
                }
                if (e.state == S_MakeUpW || e.state == S_MakeUp) {
                    r.a0 += e.param;
                    r.run_length += e.param;
                    continue;
                }
                goto done;  // a bad code word
            }
            if (r.a0 >= r.lastx) goto done;
            for (;;) {
                const TabEnt& e = f.lookup16(13, f.t.black);
                if (e.state == S_EOL) {
                    f.eolcnt = 1;
                    goto done;
                }
                if (e.state == S_TermB) {
                    r.set(e.param);
                    break;
                }
                if (e.state == S_MakeUpB || e.state == S_MakeUp) {
                    r.a0 += e.param;
                    r.run_length += e.param;
                    continue;
                }
                goto done;
            }
            if (r.a0 >= r.lastx) goto done;
            if (r.pa >= 2 && r.runs[r.pa - 1] == 0 && r.runs[r.pa - 2] == 0) r.pa -= 2;
        }
    } catch (const EndOfData&) {
        r.cleanup();
        return false;
    }
done:
    r.cleanup();
    return true;
}

// EXPAND2D against the reference runs ref (b1 and pb as libtiff keeps
// them); false where the data ended first
bool expand2d(Fax& f, Row& r, Runs ref) {
    size_t pb = 0;
    int64_t b1 = ref[pb++];
    const size_t nruns = ref.size();
    auto check_b1 = [&]() {
        if (r.pa != 0) {
            while (b1 <= r.a0 && b1 < r.lastx) {
                if (pb + 1 >= nruns) throw Overflow{};
                b1 += static_cast<int64_t>(ref[pb]) + ref[pb + 1];
                pb += 2;
            }
        }
    };
    try {
        while (r.a0 < r.lastx) {
            if (r.pa >= r.runs.size()) throw Overflow{};
            const TabEnt& e = f.lookup8(7, f.t.main);
            switch (e.state) {
                case S_Pass:
                    check_b1();
                    if (pb + 1 >= nruns) throw Overflow{};
                    b1 += ref[pb++];
                    r.run_length += b1 - r.a0;
                    r.a0 = b1;
                    b1 += ref[pb++];
                    break;
                case S_Horiz: {
                    const bool black_first = r.pa & 1;
                    for (int k = 0; k < 2; k++) {
                        const bool black = black_first ? k == 0 : k == 1;
                        for (;;) {
                            const TabEnt& h = black ? f.lookup16(13, f.t.black) : f.lookup16(12, f.t.white);
                            if (h.state == (black ? S_TermB : S_TermW)) {
                                r.set(h.param);
                                break;
                            }
                            if (h.state == (black ? S_MakeUpB : S_MakeUpW) || h.state == S_MakeUp) {
                                r.a0 += h.param;
                                r.run_length += h.param;
                                continue;
                            }
                            goto eol;  // a bad code word
                        }
                    }
                    check_b1();
                    break;
                }
                case S_V0:
                    check_b1();
                    r.set(b1 - r.a0);
                    if (pb >= nruns) throw Overflow{};
                    b1 += ref[pb++];
                    break;
                case S_VR:
                    check_b1();
                    r.set(b1 - r.a0 + e.param);
                    if (pb >= nruns) throw Overflow{};
                    b1 += ref[pb++];
                    break;
                case S_VL:
                    check_b1();
                    if (b1 < r.a0 + static_cast<int64_t>(e.param)) goto eol;
                    r.set(b1 - r.a0 - e.param);
                    b1 -= ref[--pb];
                    break;
                case S_Ext:
                    if (r.pa >= r.runs.size()) throw Overflow{};
                    r.runs[r.pa++] = static_cast<uint32_t>(r.lastx - r.a0);
                    goto eol;
                case S_EOL:
                    if (r.pa >= r.runs.size()) throw Overflow{};
                    r.runs[r.pa++] = static_cast<uint32_t>(r.lastx - r.a0);
                    f.need8(4);
                    f.clr(4);
                    f.eolcnt = 1;
                    goto eol;
                default:
                    goto eol;
            }
        }
        if (r.run_length) {
            if (r.run_length + r.a0 < r.lastx) {  // expect a final V0
                f.need8(1);
                if (!f.get(1)) goto eol;
                f.clr(1);
            }
            r.set(0);
        }
    } catch (const EndOfData&) {
        r.cleanup();
        return false;
    }
eol:
    r.cleanup();
    return true;
}

// _TIFFFax3fillruns: white runs 0 bits, black runs 1 bits, MSB first
void fill_row(uint8_t* buf, Runs runs, size_t n, int64_t lastx) {
    if (n & 1) runs[n++] = 0;
    int64_t x = 0;
    for (size_t i = 0; i < n; i += 2) {
        for (int k = 0; k < 2; k++) {
            int64_t run = runs[i + k];
            if (x + run > lastx || run > lastx) run = runs[i + k] = static_cast<uint32_t>(lastx - x);
            for (int64_t p = x; p < x + run; p++) {
                if (k) {
                    buf[p >> 3] |= static_cast<uint8_t>(0x80 >> (p & 7));
                } else {
                    buf[p >> 3] &= static_cast<uint8_t>(~(0x80 >> (p & 7)));
                }
            }
            x += runs[i + k];
        }
    }
}

}  // namespace

extern "C" {

// One strip or tile of CCITT data into out (rows rows of (width + 7) / 8
// bytes, 1 bits black), with libtiff's run array (runs: 2 * nruns + 2
// entries, nruns = TIFFroundup(width + 1, 32), doubled for 2-D, zeroed for
// the image and kept from one strip or tile to the next, as Fax3SetupState
// allocates it once a directory: a corrupt row's reference can reach the
// entries an earlier row left). mode: 2 Modified Huffman (byte-aligned rows), 32771
// the same word-aligned, 3 T.4 (twod: 2-D rows by their tag bit), 4 T.6.
// lsb_first: FillOrder 2. Returns the rows written: all of them, or, where
// the data ends first, up to the row it ends in, which is written as
// libtiff leaves it (the later ones are not written, in libtiff either; a
// T.4 row whose EOL the data ends before is not written either); -1 when a
// row's runs overflow libtiff's run buffer.
int tl_tiff_fax(const uint8_t* data, size_t len, int mode, int twod, int lsb_first, int width, int rows,
                uint32_t* runs, uint8_t* out) {
    const int64_t lastx = width;
    const size_t rowbytes = (static_cast<size_t>(width) + 7) / 8;
    const bool refline = mode == 4 || (mode == 3 && twod);
    const size_t nruns = (static_cast<size_t>(width) + 1 + 31) / 32 * 32 * (refline ? 2 : 1);
    Runs cur{runs, nruns}, ref{runs + nruns, nruns};  // Fax3PreDecode
    ref[0] = static_cast<uint32_t>(width);
    ref[1] = 0;
    Fax f{data, data + len, data, lsb_first != 0};
    std::memset(out, 0, rowbytes * static_cast<size_t>(rows));
    try {
        for (int y = 0; y < rows; y++) {
            uint8_t* buf = out + rowbytes * static_cast<size_t>(y);
            Row r(cur, lastx);
            bool ok = true;
            if (mode == 2 || mode == 32771) {
                ok = expand1d(f, r);
                if (ok) {  // align the next row
                    if (mode == 2) {
                        f.clr(f.avail - (f.avail & ~7));
                    } else {
                        f.clr(f.avail - (f.avail & ~15));
                        if (f.avail == 0 && ((f.cp - f.start) & 1)) f.cp++;
                    }
                }
            } else if (mode == 3) {
                bool is1d = true;
                try {
                    f.sync_eol();
                    if (twod) {
                        f.need8(1);
                        is1d = f.get(1);
                        f.clr(1);
                    }
                } catch (const EndOfData&) {
                    return y;  // no EOL before the data ends: libtiff 4.7 leaves this row unwritten
                }
                ok = is1d ? expand1d(f, r) : expand2d(f, r, ref);
            } else {
                ok = expand2d(f, r, ref);
                if (ok && f.eolcnt) ok = false;  // EOFB: this row is the last
            }
            fill_row(buf, cur, r.pa, lastx);
            if (!ok) return y + 1;
            if (refline) {
                if (mode == 4 || r.pa < nruns) r.set(0);  // the imaginary change for the reference
                std::swap(cur, ref);
            }
        }
    } catch (const Overflow&) {
        return -1;
    }
    return rows;
}

// tif_color.c's TIFFYCbCrToRGBInit tables from YCbCrCoefficients (luma,
// 3) and ReferenceBlackWhite (rbw, 6), then every pixel of units (the
// sampling units of an image or tile part of width x height: hs * vs luma
// samples, Cb, Cr; a row of units every stride bytes) to RGB in out, as
// the putcontig8bitYCbCr* routines put them: each pixel takes the luma of
// its place in its unit and the unit's chroma. Returns 0.
int tl_tiff_ycbcr(const uint8_t* units, int width, int height, int hs, int vs, size_t stride, const float* luma,
                  const float* rbw, uint8_t* out) {
    const int SHIFT = 16;
    const int32_t ONE_HALF = 1 << (SHIFT - 1);
    auto FIX = [](float x) { return static_cast<int32_t>(x * static_cast<float>(1L << 16) + 0.5); };
    auto CLAMP = [](float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; };
    auto Code2V = [](int32_t c, float RB, float RW, float CR) {
        return (static_cast<float>(c - static_cast<int32_t>(RB)) * CR) / ((RW - RB != 0) ? (RW - RB) : 1.0f);
    };
    int32_t Cr_r[256], Cb_b[256], Cr_g[256], Cb_g[256], Y_t[256];
    const float f1 = 2 - 2 * luma[0];
    const int32_t D1 = FIX(CLAMP(f1, 0.0F, 2.0F));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t D2 = -FIX(CLAMP(f2, 0.0F, 2.0F));
    const float f3 = 2 - 2 * luma[2];
    const int32_t D3 = FIX(CLAMP(f3, 0.0F, 2.0F));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t D4 = -FIX(CLAMP(f4, 0.0F, 2.0F));
    for (int i = 0, x = -128; i < 256; i++, x++) {
        const int32_t Cr = static_cast<int32_t>(
            CLAMP(Code2V(x, rbw[4] - 128.0F, rbw[5] - 128.0F, 127), -128.0F * 32, 128.0F * 32));
        const int32_t Cb = static_cast<int32_t>(
            CLAMP(Code2V(x, rbw[2] - 128.0F, rbw[3] - 128.0F, 127), -128.0F * 32, 128.0F * 32));
        Cr_r[i] = static_cast<int32_t>((static_cast<int64_t>(D1) * Cr + ONE_HALF) >> SHIFT);
        Cb_b[i] = static_cast<int32_t>((static_cast<int64_t>(D3) * Cb + ONE_HALF) >> SHIFT);
        Cr_g[i] = D2 * Cr;
        Cb_g[i] = D4 * Cb + ONE_HALF;
        Y_t[i] = static_cast<int32_t>(CLAMP(Code2V(x + 128, rbw[0], rbw[1], 255), -128.0F * 32, 128.0F * 32));
    }
    auto clamp = [](int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    const int unit = hs * vs + 2;
    for (int y = 0; y < height; y++) {
        const uint8_t* row = units + static_cast<size_t>(y / vs) * stride;
        for (int x = 0; x < width; x++) {
            const uint8_t* u = row + static_cast<size_t>(x / hs) * unit;
            const int Y = u[(y % vs) * hs + (x % hs)], Cb = u[hs * vs], Cr = u[hs * vs + 1];
            uint8_t* o = out + (static_cast<size_t>(y) * width + x) * 3;
            o[0] = clamp(Y_t[Y] + Cr_r[Cr]);
            o[1] = clamp(Y_t[Y] + static_cast<int32_t>((Cb_g[Cb] + Cr_g[Cr]) >> SHIFT));
            o[2] = clamp(Y_t[Y] + Cb_b[Cb]);
        }
    }
    return 0;
}

// tif_getimage.c's putcontig8bitCIELab8 (bits 8: L, a, b bytes with a and b
// signed) or putcontig8bitCIELab16 (bits 16: native uint16 L, a and b, a and
// b signed) over n pixels of spp samples (the first three read) to RGB in
// out, through TIFFCIELabToRGBInit with the sRGB display and the white point
// (x, y) given (libtiff's default is D50's). Returns 0.
int tl_tiff_cielab(const uint8_t* in, size_t n, int spp, int bits, float wx, float wy, uint8_t* out) {
    // display_sRGB
    const float d_mat[3][3] = {{3.2410F, -1.5374F, -0.4986F}, {-0.9692F, 1.8760F, 0.0416F},
                               {0.0556F, -0.2040F, 1.0570F}};
    const float d_YCR = 100.0F, d_YCG = 100.0F, d_YCB = 100.0F;
    const uint32_t d_Vrwr = 255, d_Vrwg = 255, d_Vrwb = 255;
    const float d_Y0R = 1.0F, d_Y0G = 1.0F, d_Y0B = 1.0F;
    const float d_gammaR = 2.4F, d_gammaG = 2.4F, d_gammaB = 2.4F;
    const int range = 1500;  // CIELABTORGB_TABLE_RANGE
    std::vector<float> Yr2r(range + 1), Yg2g(range + 1), Yb2b(range + 1);
    double dfGamma = 1.0 / d_gammaR;
    const float rstep = (d_YCR - d_Y0R) / range;
    for (int i = 0; i <= range; i++) Yr2r[i] = d_Vrwr * static_cast<float>(std::pow(static_cast<double>(i) / range, dfGamma));
    dfGamma = 1.0 / d_gammaG;
    const float gstep = (d_YCG - d_Y0G) / range;
    for (int i = 0; i <= range; i++) Yg2g[i] = d_Vrwg * static_cast<float>(std::pow(static_cast<double>(i) / range, dfGamma));
    dfGamma = 1.0 / d_gammaB;
    const float bstep = (d_YCB - d_Y0B) / range;
    for (int i = 0; i <= range; i++) Yb2b[i] = d_Vrwb * static_cast<float>(std::pow(static_cast<double>(i) / range, dfGamma));
    float refWhite[3];
    refWhite[1] = 100.0F;
    refWhite[0] = wx / wy * refWhite[1];
    refWhite[2] = (1.0F - wx - wy) / wy * refWhite[1];
    const float X0 = refWhite[0], Y0 = refWhite[1], Z0 = refWhite[2];
    auto rint = [](float R) { return static_cast<uint32_t>(R > 0 ? (R + 0.5) : (R - 0.5)); };
    for (size_t p = 0; p < n; p++) {
        uint32_t l;
        int32_t a, b;
        if (bits == 8) {
            const uint8_t* px = in + p * spp;
            l = static_cast<uint32_t>(px[0]) * 257;
            a = static_cast<int32_t>(static_cast<int8_t>(px[1])) * 256;
            b = static_cast<int32_t>(static_cast<int8_t>(px[2])) * 256;
        } else {
            uint16_t v[3];
            std::memcpy(v, in + p * spp * 2, sizeof v);
            l = v[0];
            a = static_cast<int16_t>(v[1]);
            b = static_cast<int16_t>(v[2]);
        }
        // TIFFCIELab16ToXYZ
        float X, Y, Z;
        const float L = static_cast<float>(l) * 100.0F / 65535.0F;
        float cby, tmp;
        if (L < 8.856F) {
            Y = (L * Y0) / 903.292F;
            cby = 7.787F * (Y / Y0) + 16.0F / 116.0F;
        } else {
            cby = (L + 16.0F) / 116.0F;
            Y = Y0 * cby * cby * cby;
        }
        tmp = static_cast<float>(a) / 256.0F / 500.0F + cby;
        if (tmp < 0.2069F) {
            X = X0 * (tmp - 0.13793F) / 7.787F;
        } else {
            X = X0 * tmp * tmp * tmp;
        }
        tmp = cby - static_cast<float>(b) / 256.0F / 200.0F;
        if (tmp < 0.2069F) {
            Z = Z0 * (tmp - 0.13793F) / 7.787F;
        } else {
            Z = Z0 * tmp * tmp * tmp;
        }
        // TIFFXYZToRGB
        float Yr = d_mat[0][0] * X + d_mat[0][1] * Y + d_mat[0][2] * Z;
        float Yg = d_mat[1][0] * X + d_mat[1][1] * Y + d_mat[1][2] * Z;
        float Yb = d_mat[2][0] * X + d_mat[2][1] * Y + d_mat[2][2] * Z;
        Yr = Yr > d_Y0R ? Yr : d_Y0R;
        Yg = Yg > d_Y0G ? Yg : d_Y0G;
        Yb = Yb > d_Y0B ? Yb : d_Y0B;
        Yr = Yr < d_YCR ? Yr : d_YCR;
        Yg = Yg < d_YCG ? Yg : d_YCG;
        Yb = Yb < d_YCB ? Yb : d_YCB;
        int i = static_cast<int>((Yr - d_Y0R) / rstep);
        i = i < range ? i : range;
        uint32_t r = rint(Yr2r[i]);
        i = static_cast<int>((Yg - d_Y0G) / gstep);
        i = i < range ? i : range;
        uint32_t g = rint(Yg2g[i]);
        i = static_cast<int>((Yb - d_Y0B) / bstep);
        i = i < range ? i : range;
        uint32_t bb = rint(Yb2b[i]);
        r = r < d_Vrwr ? r : d_Vrwr;
        g = g < d_Vrwg ? g : d_Vrwg;
        bb = bb < d_Vrwb ? bb : d_Vrwb;
        out[3 * p] = static_cast<uint8_t>(r);
        out[3 * p + 1] = static_cast<uint8_t>(g);
        out[3 * p + 2] = static_cast<uint8_t>(bb);
    }
    return 0;
}

}  // extern "C"
