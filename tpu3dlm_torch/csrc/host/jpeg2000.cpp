// JPEG 2000 codestreams (ITU-T T.800 Part 1), decoded as OpenJPEG 2.5 decodes
// them for cv2 5.0 (opj_read_header then opj_decode, default parameters,
// strict mode):
//
// - the main and tile-part headers: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM,
//   PPT, TLM/PLM/PLT/CRG/COM/CAP/CPF and Part 2's MCT/MCC/MCO and CBD
//   (skipped, as OpenJPEG does without COD's MCT 2), SOT (tile-parts,
//   Psot = 0) and SOD, EOC; OpenJPEG's scan for
//   a known marker after an unknown one in the main header, and its checks
//   of each segment;
// - tier 2: the packet iterator of every progression order and of POC
//   entries (OpenJPEG's pi.c loops, the include table), packet headers with
//   the inclusion and zero-bit-plane tag trees, pass counts, Lblock and the
//   bit reader that stuffs a bit after 0xFF, empty packets, SOP (optional)
//   and EPH (required), as OpenJPEG reads them, headers packed in PPM or PPT;
// - tier 1 (EBCOT): the MQ decoder and its 47 states with OpenJPEG's
//   0xFF 0xFF sentinel at a segment's end, the significance propagation,
//   refinement and cleanup passes with run mode, the 19 contexts, and the
//   code-block styles (bypass, reset, termination on every pass,
//   vertically causal, predictable termination, segmentation symbols);
//   coefficients carry OpenJPEG's extra half bit;
// - ROI max-shift, dequantisation (reversible: a halving; irreversible:
//   OpenJPEG's float step with its decoder gain of 1 in every band);
// - the integer 5/3 and the float 9/7 inverse wavelets with OpenJPEG's
//   operation order (K and 1.625732422 scalings first, then each lifting
//   step as w + (l + r) * c in f32, no FMA), band parities from the tile's
//   coordinates; RCT and ICT; the DC level shift, lrintf and the clamp to
//   each component's precision.
//
// Components must not be subsampled (cv2 refuses those): the caller checks
// SIZ through tl_j2k_header first. Not ported: HT code-blocks (Part 15),
// which raise. Errors return -1 with a message; "not yet ported" ones
// return -2.

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
    std::string msg;
    int code;
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg, -1}; }
[[noreturn]] void not_ported(const std::string& msg) { throw Fail{msg, -2}; }

uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
uint32_t be32(const uint8_t* p) { return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3]; }

int ceildiv(int64_t a, int64_t b) { return int((a + b - 1) / b); }
int ceildivpow2(int64_t a, int b) { return int((a + (int64_t(1) << b) - 1) >> b); }
int floordivpow2(int64_t a, int b) { return int(a >> b); }

enum {
    MS_SOC = 0xff4f, MS_SOT = 0xff90, MS_SOD = 0xff93, MS_EOC = 0xffd9, MS_CAP = 0xff50,
    MS_SIZ = 0xff51, MS_COD = 0xff52, MS_COC = 0xff53, MS_CPF = 0xff59, MS_TLM = 0xff55,
    MS_PLM = 0xff57, MS_PLT = 0xff58, MS_QCD = 0xff5c, MS_QCC = 0xff5d, MS_RGN = 0xff5e,
    MS_POC = 0xff5f, MS_PPM = 0xff60, MS_PPT = 0xff61, MS_CRG = 0xff63, MS_COM = 0xff64,
    MS_CBD = 0xff78, MS_MCT = 0xff74, MS_MCC = 0xff75, MS_MCO = 0xff77, MS_SOP = 0xff91,
};
enum { ST_MHSIZ = 0x2, ST_MH = 0x4, ST_TPHSOT = 0x8, ST_TPH = 0x10, ST_NEOC = 0x40, ST_EOC = 0x100 };

// OpenJPEG's marker table: the states in which each marker may appear (0 for
// SOP); -1 for a marker it does not know.
int marker_states(uint32_t m) {
    switch (m) {
        case MS_SOT: return ST_MH | ST_TPHSOT;
        case MS_COD: case MS_COC: case MS_RGN: case MS_QCD: case MS_QCC: case MS_POC:
        case MS_COM: case MS_MCT: case MS_MCC: case MS_MCO: return ST_MH | ST_TPH;
        case MS_SIZ: return ST_MHSIZ;
        case MS_TLM: case MS_PLM: case MS_PPM: case MS_CRG: case MS_CBD: case MS_CAP: case MS_CPF: return ST_MH;
        case MS_PLT: case MS_PPT: return ST_TPH;
        case MS_SOP: return 0;
        default: return -1;
    }
}

constexpr int MAXRLVLS = 33, MAXBANDS = 3 * MAXRLVLS - 2, MAX_POCS = 32;
constexpr int CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_SEGSYM = 32, CBLK_HT = 64;

struct Comp {
    int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct TCCP {
    int csty = 0, numres = 1, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 0;
    int prcw[MAXRLVLS], prch[MAXRLVLS];
    int qntsty = 0, numgbits = 0, roishift = 0;
    int expn[MAXBANDS], mant[MAXBANDS];
    TCCP() {
        std::fill(prcw, prcw + MAXRLVLS, 15);
        std::fill(prch, prch + MAXRLVLS, 15);
        std::fill(expn, expn + MAXBANDS, 0);
        std::fill(mant, mant + MAXBANDS, 0);
    }
};

struct POC {
    uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct TCP {
    int csty = 0, prg = 0, numlayers = 0, mct = 0;
    std::vector<TCCP> tccps;
    std::vector<POC> pocs;
    bool has_poc = false;
    std::vector<std::pair<int, std::vector<uint8_t>>> ppt_segs;  // (Zppt, data)
    std::vector<uint8_t> data;  // the tile's tile-part data, concatenated
    int cur_part = -1, nb_parts = 0;
    bool seen = false;  // a tile-part of this tile was read
};

// ---------------------------------------------------------------------------
// Bit reader of packet headers (OpenJPEG's bio.c)
// ---------------------------------------------------------------------------

struct Bio {
    const uint8_t *start, *end, *bp;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t len) : start(p), end(p + len), bp(p) {}
    bool bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return false;
        buf |= *bp++;
        return true;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
        return v;
    }
    bool inalign() {
        if ((buf & 0xff) == 0xff) {
            if (!bytein()) return false;
        }
        ct = 0;
        return true;
    }
    size_t numbytes() const { return size_t(bp - start); }
};

// ---------------------------------------------------------------------------
// Tag trees (OpenJPEG's tgt.c)
// ---------------------------------------------------------------------------

struct TagTree {
    struct Node {
        int parent, value, low;
    };
    std::vector<Node> nodes;
    void init(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw, lh;
        int nw = w, nh = h, total = 0;
        do {
            lw.push_back(nw);
            lh.push_back(nh);
            total += nw * nh;
            nw = (nw + 1) / 2;
            nh = (nh + 1) / 2;
        } while (lw.back() * lh.back() > 1);
        nodes.assign(total, Node{-1, 999, 0});
        int base = 0;
        for (size_t l = 0; l + 1 < lw.size(); ++l) {
            int pbase = base + lw[l] * lh[l];
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i) nodes[base + j * lw[l] + i].parent = pbase + (j / 2) * lw[l + 1] + i / 2;
            base = pbase;
        }
    }
    void reset() {
        for (auto& n : nodes) {
            n.value = 999;
            n.low = 0;
        }
    }
    uint32_t decode(Bio& bio, int leaf, int threshold) {
        int stk[32], sp = 0;
        int node = leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        int low = 0;
        for (;;) {
            Node& n = nodes[node];
            if (low > n.low) n.low = low;
            else low = n.low;
            while (low < threshold && low < n.value) {
                if (bio.read(1)) n.value = low;
                else ++low;
            }
            n.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return nodes[node].value < threshold ? 1 : 0;
    }
};

// ---------------------------------------------------------------------------
// Tile structure (OpenJPEG's tcd.c geometry)
// ---------------------------------------------------------------------------

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0, newlen = 0;
};

struct Cblk {
    int x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
    uint32_t numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<std::pair<size_t, uint32_t>> chunks;  // (offset in tile data, length)
};

struct Precinct {
    int x0, y0, x1, y1, cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno, x0, y0, x1, y1, numbps;
    float stepsize;
    std::vector<Precinct> precincts;
    bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
    int x0, y0, x1, y1, pdx, pdy, pw, ph, numbands;
    Band bands[3];
};

struct TileComp {
    int x0, y0, x1, y1, numres;
    std::vector<Res> res;
    std::vector<int32_t> idata;
    std::vector<float> fdata;
};

// ---------------------------------------------------------------------------
// MQ decoder (T.800 Annex C, OpenJPEG's mqc.c)
// ---------------------------------------------------------------------------

struct QeState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};

const QeState kQe[47] = {
    {0x5601, 1, 1, 1}, {0x3401, 2, 6, 0}, {0x1801, 3, 9, 0}, {0x0ac1, 4, 12, 0}, {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1}, {0x5401, 8, 14, 0}, {0x4801, 9, 14, 0}, {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1c01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02a1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct MQ {
    const uint8_t* bp;
    const uint8_t* end;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        std::memset(state, 0, sizeof state);
        std::memset(mps, 0, sizeof mps);
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    // The data must be followed by two bytes 0xFF 0xFF (OpenJPEG's sentinel).
    void init(const uint8_t* p, uint32_t len) {
        bp = p;
        end = p + len;
        c = uint32_t(len == 0 ? 0xff : *bp) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init(const uint8_t* p, uint32_t len) {
        bp = p;
        end = p + len;
        c = 0;
        ct = 0;
    }
    void bytein() {
        uint32_t next = bp[1];
        if (*bp == 0xff) {
            if (next > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += next << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += next << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        const QeState& s = kQe[state[cx]];
        uint32_t qe = s.qe;
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                a = qe;
                d = !mps[cx];
                if (s.sw) mps[cx] = !mps[cx];
                state[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = !mps[cx];
                    if (s.sw) mps[cx] = !mps[cx];
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    int raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp;
                    bp++;
                    ct = 7;
                }
            } else {
                c = *bp;
                bp++;
                ct = 8;
            }
        }
        ct--;
        return int((c >> ct) & 1);
    }
};

// ---------------------------------------------------------------------------
// Tier 1 (T.800 Annex D)
// ---------------------------------------------------------------------------

// Flags of a coefficient: its neighbours' significance and signs, its own
// state.
enum : uint32_t {
    F_SIG_N = 1 << 0, F_SIG_S = 1 << 1, F_SIG_W = 1 << 2, F_SIG_E = 1 << 3,
    F_SIG_NW = 1 << 4, F_SIG_NE = 1 << 5, F_SIG_SW = 1 << 6, F_SIG_SE = 1 << 7,
    F_SGN_N = 1 << 8, F_SGN_S = 1 << 9, F_SGN_W = 1 << 10, F_SGN_E = 1 << 11,
    F_SIG = 1 << 12, F_VISIT = 1 << 13, F_REFINE = 1 << 14,
    F_SIG_OTH = 0xff, F_VSC_MASK = F_SIG_S | F_SIG_SW | F_SIG_SE | F_SGN_S,
};

uint8_t lut_zc[4][256];
uint8_t lut_sc[256], lut_spb[256];
bool luts_ready = false;

void make_luts() {
    for (int orient = 0; orient < 4; ++orient) {
        for (int f = 0; f < 256; ++f) {
            int h = !!(f & F_SIG_W) + !!(f & F_SIG_E);
            int v = !!(f & F_SIG_N) + !!(f & F_SIG_S);
            int d = !!(f & F_SIG_NW) + !!(f & F_SIG_NE) + !!(f & F_SIG_SW) + !!(f & F_SIG_SE);
            int n = 0;
            if (orient == 1) std::swap(h, v);  // HL: horizontally high-pass
            if (orient < 3) {
                if (h == 0) n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
                else if (h == 1) n = v == 0 ? (d == 0 ? 5 : 6) : 7;
                else n = 8;
            } else {
                int hv = h + v;
                if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
                else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
                else if (d == 2) n = hv == 0 ? 6 : 7;
                else n = 8;
            }
            lut_zc[orient][f] = uint8_t(CTX_ZC + n);
        }
    }
    // sign context: index = SIG_N|S|W|E (4 bits) | SGN_N|S|W|E (4 bits)
    for (int f = 0; f < 256; ++f) {
        int sn = f & 1, ss = (f >> 1) & 1, sw = (f >> 2) & 1, se = (f >> 3) & 1;
        int gn = (f >> 4) & 1, gs = (f >> 5) & 1, gw = (f >> 6) & 1, ge = (f >> 7) & 1;
        int hc = (sw ? (gw ? -1 : 1) : 0) + (se ? (ge ? -1 : 1) : 0);
        int vc = (sn ? (gn ? -1 : 1) : 0) + (ss ? (gs ? -1 : 1) : 0);
        hc = std::max(-1, std::min(1, hc));
        vc = std::max(-1, std::min(1, vc));
        int ctx, x = 0;
        if (hc < 0) {
            hc = -hc;
            vc = -vc;
            x = 1;
        }
        if (hc == 0) {
            if (vc == 0) ctx = 9;
            else {
                ctx = 10;
                x = vc < 0;
            }
        } else {
            ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
        }
        lut_sc[f] = uint8_t(ctx);
        lut_spb[f] = uint8_t(x);
    }
    luts_ready = true;
}

inline int sc_index(uint32_t f) {
    return int((f & (F_SIG_N | F_SIG_S | F_SIG_W | F_SIG_E)) | ((f >> 4) & 0xf0));
}

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<uint32_t> flags;
    std::vector<int32_t> data;

    void alloc(int cw, int ch) {
        w = cw;
        h = ch;
        stride = w + 2;
        flags.assign(size_t(stride) * (h + 2), 0);
        data.assign(size_t(w) * h, 0);
    }
    uint32_t* fl(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }

    void update(uint32_t* fp, int s) {
        fp[-stride - 1] |= F_SIG_SE;
        fp[-stride] |= F_SIG_S | (s ? uint32_t(F_SGN_S) : 0u);
        fp[-stride + 1] |= F_SIG_SW;
        fp[-1] |= F_SIG_E | (s ? uint32_t(F_SGN_E) : 0u);
        fp[0] |= F_SIG;
        fp[1] |= F_SIG_W | (s ? uint32_t(F_SGN_W) : 0u);
        fp[stride - 1] |= F_SIG_NE;
        fp[stride] |= F_SIG_N | (s ? uint32_t(F_SGN_N) : 0u);
        fp[stride + 1] |= F_SIG_NW;
    }

    void sigpass(MQ& mq, bool raw, int bpno, int orient, int cblksty) {
        int one = 1 << bpno, oneplushalf = one | (one >> 1);
        bool vsc = cblksty & CBLK_VSC;
        for (int k = 0; k < h; k += 4)
            for (int i = 0; i < w; ++i) {
                // a full stripe column with no significance around it: nothing to code
                if (k + 3 < h && !(*fl(i, k) | *fl(i, k + 1) | *fl(i, k + 2) | *fl(i, k + 3))) continue;
                for (int j = k; j < k + 4 && j < h; ++j) {
                    uint32_t* fp = fl(i, j);
                    uint32_t f = (vsc && (j == k + 3 || j == h - 1)) ? (*fp & ~F_VSC_MASK) : *fp;
                    if ((f & F_SIG_OTH) && !(f & (F_SIG | F_VISIT))) {
                        int32_t* dp = &data[size_t(j) * w + i];
                        if (raw) {
                            if (mq.raw_decode()) {
                                int v = mq.raw_decode();
                                *dp = v ? -oneplushalf : oneplushalf;
                                update(fp, v);
                            }
                        } else if (mq.decode(lut_zc[orient][f & F_SIG_OTH])) {
                            int si = sc_index(f);
                            int v = mq.decode(lut_sc[si]) ^ lut_spb[si];
                            *dp = v ? -oneplushalf : oneplushalf;
                            update(fp, v);
                        }
                        *fp |= F_VISIT;
                    }
                }
            }
    }

    void refpass(MQ& mq, bool raw, int bpno, int cblksty) {
        int poshalf = (1 << bpno) >> 1;
        bool vsc = cblksty & CBLK_VSC;
        for (int k = 0; k < h; k += 4)
            for (int i = 0; i < w; ++i) {
                if (k + 3 < h && !((*fl(i, k) | *fl(i, k + 1) | *fl(i, k + 2) | *fl(i, k + 3)) & F_SIG)) continue;
                for (int j = k; j < k + 4 && j < h; ++j) {
                    uint32_t* fp = fl(i, j);
                    uint32_t f = (vsc && (j == k + 3 || j == h - 1)) ? (*fp & ~F_VSC_MASK) : *fp;
                    if ((f & (F_SIG | F_VISIT)) == F_SIG) {
                        int v;
                        if (raw) {
                            v = mq.raw_decode();
                        } else {
                            int ctx = (f & F_REFINE) ? CTX_MAG + 2 : (f & F_SIG_OTH) ? CTX_MAG + 1 : CTX_MAG;
                            v = mq.decode(ctx);
                        }
                        int32_t* dp = &data[size_t(j) * w + i];
                        *dp += (v ^ (*dp < 0)) ? poshalf : -poshalf;
                        *fp |= F_REFINE;
                    }
                }
            }
    }

    void clnpass(MQ& mq, int bpno, int orient, int cblksty) {
        int one = 1 << bpno, oneplushalf = one | (one >> 1);
        bool vsc = cblksty & CBLK_VSC;
        const uint32_t busy = F_SIG | F_VISIT | F_SIG_OTH;
        for (int k = 0; k < h; k += 4)
            for (int i = 0; i < w; ++i) {
                int runlen = 0;
                bool agg = false;
                if (k + 3 < h) {
                    uint32_t f3 = *fl(i, k + 3);
                    if (vsc) f3 &= ~F_VSC_MASK;
                    agg = !((*fl(i, k) & busy) || (*fl(i, k + 1) & busy) || (*fl(i, k + 2) & busy) || (f3 & busy));
                }
                if (agg) {
                    if (!mq.decode(CTX_AGG)) continue;
                    runlen = mq.decode(CTX_UNI);
                    runlen = (runlen << 1) | mq.decode(CTX_UNI);
                }
                for (int j = k + runlen; j < k + 4 && j < h; ++j) {
                    uint32_t* fp = fl(i, j);
                    uint32_t f = (vsc && (j == k + 3 || j == h - 1)) ? (*fp & ~F_VSC_MASK) : *fp;
                    bool partial = agg && j == k + runlen;
                    if (partial || !(f & (F_SIG | F_VISIT))) {
                        if (partial || mq.decode(lut_zc[orient][f & F_SIG_OTH])) {
                            int si = sc_index(f);
                            int v = mq.decode(lut_sc[si]) ^ lut_spb[si];
                            data[size_t(j) * w + i] = v ? -oneplushalf : oneplushalf;
                            update(fp, v);
                        }
                    }
                    *fp &= ~F_VISIT;
                }
            }
        if (cblksty & CBLK_SEGSYM) {
            for (int b = 0; b < 4; ++b) mq.decode(CTX_UNI);
        }
    }
};

// Decodes one code-block into t1.data; false where OpenJPEG's
// opj_t1_decode_cblk fails.
bool decode_cblk(T1& t1, const Cblk& cb, const std::vector<uint8_t>& tile_data, int orient, int roishift, int cblksty) {
    t1.alloc(cb.x1 - cb.x0, cb.y1 - cb.y0);
    int bpno_plus_one = int(uint32_t(roishift) + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    if (cb.chunks.empty()) return true;
    size_t total = 0;
    for (auto& ch : cb.chunks) total += ch.second;
    std::vector<uint8_t> buf(total + 2);
    size_t off = 0;
    for (auto& ch : cb.chunks) {
        std::memcpy(buf.data() + off, tile_data.data() + ch.first, ch.second);
        off += ch.second;
    }
    MQ mq;
    mq.reset_states();
    int passtype = 2;
    size_t idx = 0;
    for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
        const Seg& seg = cb.segs[segno];
        bool raw = bpno_plus_one <= int(cb.numbps) - 4 && passtype < 2 && (cblksty & CBLK_LAZY);
        // OpenJPEG's 0xFF 0xFF sentinel just past the segment, over the next
        // segment's first bytes until this one is decoded.
        uint8_t* endp = buf.data() + idx + seg.len;
        uint8_t save[2] = {endp[0], endp[1]};
        endp[0] = endp[1] = 0xff;
        if (raw) mq.raw_init(buf.data() + idx, seg.len);
        else mq.init(buf.data() + idx, seg.len);
        idx += seg.len;
        for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
            if (passtype == 0) t1.sigpass(mq, raw, bpno_plus_one, orient, cblksty);
            else if (passtype == 1) t1.refpass(mq, raw, bpno_plus_one, cblksty);
            else t1.clnpass(mq, bpno_plus_one, orient, cblksty);
            if ((cblksty & CBLK_RESET) && !raw) mq.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
        endp[0] = save[0];
        endp[1] = save[1];
    }
    return true;
}

// ---------------------------------------------------------------------------
// Inverse wavelets (OpenJPEG's dwt.c)
// ---------------------------------------------------------------------------

// 5/3 on one line of n = sn + dn samples (the horizontal pass): the same
// lifting with the mirrored ends taken out of the loops.
void idwt53_line(const int32_t* in, int sn, int dn, int cas, int32_t* out) {
    const int32_t* L = in;
    const int32_t* H = in + sn;
    if (sn + dn == 1) {
        out[0] = cas ? in[0] / 2 : in[0];
        return;
    }
    if (cas == 0) {  // s[i] at 2i, d[i] at 2i + 1; sn is dn or dn + 1
        out[0] = L[0] - ((H[0] + H[0] + 2) >> 2);
        int i = 1;
        for (; i < dn; ++i) out[2 * i] = L[i] - ((H[i - 1] + H[i] + 2) >> 2);
        if (sn > dn) out[2 * i] = L[i] - ((H[dn - 1] + H[dn - 1] + 2) >> 2);
        for (i = 0; i < sn - 1; ++i) out[2 * i + 1] = H[i] + ((out[2 * i] + out[2 * i + 2]) >> 1);
        if (dn == sn) out[2 * i + 1] = H[i] + ((out[2 * i] + out[2 * i]) >> 1);
    } else {  // s[i] at 2i + 1, d[i] at 2i; dn is sn or sn + 1
        int i = 0;
        for (; i < dn - 1; ++i) out[2 * i + 1] = L[i] - ((H[i] + H[i + 1] + 2) >> 2);
        if (sn == dn) out[2 * i + 1] = L[i] - ((H[i] + H[i] + 2) >> 2);
        out[0] = H[0] + ((out[1] + out[1]) >> 1);
        for (i = 1; i < sn; ++i) out[2 * i] = H[i] + ((out[2 * i - 1] + out[2 * i + 1]) >> 1);
        if (dn > sn) out[2 * i] = H[i] + ((out[2 * i - 1] + out[2 * i - 1]) >> 1);
    }
}

// 5/3 on rows of `width` samples: n = sn + dn rows, in[0..sn) low, in[sn..n)
// high, cas the parity of the first coordinate; the interleaved result to
// out. A horizontal pass calls it with width 1 and the samples as rows.
void idwt53(const int32_t* in, int sn, int dn, int cas, int width, int32_t* out) {
    int n = sn + dn;
    auto L = [&](int i) { return in + size_t(i) * width; };
    auto H = [&](int i) { return in + size_t(sn + std::max(0, std::min(i, dn - 1))) * width; };
    if (cas == 0) {
        if (n == 1) {
            std::copy(in, in + width, out);
            return;
        }
        // low at even positions: s[i] at 2i, d[i] at 2i + 1
        for (int i = 0; i < sn; ++i) {
            const int32_t *l = L(i), *h0 = H(i - 1), *h1 = H(i);
            int32_t* o = out + size_t(2 * i) * width;
            for (int k = 0; k < width; ++k) o[k] = l[k] - ((h0[k] + h1[k] + 2) >> 2);
        }
        for (int i = 0; i < dn; ++i) {
            const int32_t* h = in + size_t(sn + i) * width;
            const int32_t* s0 = out + size_t(2 * i) * width;
            const int32_t* s1 = out + size_t(2 * std::min(i + 1, sn - 1)) * width;
            int32_t* o = out + size_t(2 * i + 1) * width;
            for (int k = 0; k < width; ++k) o[k] = h[k] + ((s0[k] + s1[k]) >> 1);
        }
    } else {
        if (n == 1) {
            for (int k = 0; k < width; ++k) out[k] = in[k] / 2;
            return;
        }
        // low at odd positions: s[i] at 2i + 1, d[i] at 2i
        for (int i = 0; i < sn; ++i) {
            const int32_t *l = L(i), *h0 = H(i), *h1 = H(i + 1);
            int32_t* o = out + size_t(2 * i + 1) * width;
            for (int k = 0; k < width; ++k) o[k] = l[k] - ((h0[k] + h1[k] + 2) >> 2);
        }
        for (int i = 0; i < dn; ++i) {
            const int32_t* h = in + size_t(sn + i) * width;
            const int32_t* s0 = out + size_t(2 * std::max(i - 1, 0) + 1) * width;
            const int32_t* s1 = out + size_t(2 * std::min(i, sn - 1) + 1) * width;
            int32_t* o = out + size_t(2 * i) * width;
            for (int k = 0; k < width; ++k) o[k] = h[k] + ((s0[k] + s1[k]) >> 1);
        }
    }
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
const float kK = 1.230174105f, kTwoInvK = 1.625732422f;

// One lifting step on rows of `width` samples: w[2i - 1] += (l_prev + w[2i]) * c
// for i < min(end, m), l_prev starting at l[0]; then, where m < end, the
// last one against its mirror, (c + c) * w[2m - 2]. OpenJPEG's
// opj_v8dwt_decode_step2 with rows for its SSE lanes.
void step2_97(float* l, float* w, int end, int m, float c, int width) {
    int imax = std::min(end, m);
    auto row = [&](float* base, int i) { return base + std::ptrdiff_t(i) * width; };
    const float* prev = l;
    for (int i = 0; i < imax; ++i) {
        float* dst = row(w, 2 * i - 1);
        const float* cur = row(w, 2 * i);
        for (int k = 0; k < width; ++k) dst[k] = dst[k] + (prev[k] + cur[k]) * c;
        prev = cur;
    }
    if (m < end) {
        float* dst = row(w, 2 * imax - 1);
        const float* mir = row(w, 2 * imax - 2);
        float c2 = c + c;
        for (int k = 0; k < width; ++k) dst[k] = dst[k] + c2 * mir[k];
    }
}

// 9/7 in place on n interleaved rows of `width` samples (low at parity cas).
void idwt97(float* X, int sn, int dn, int cas, int width) {
    int a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0;
        b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1;
        b = 0;
    }
    for (int i = 0; i < sn; ++i) {
        float* r = X + size_t(a + 2 * i) * width;
        for (int k = 0; k < width; ++k) r[k] = r[k] * kK;
    }
    for (int i = 0; i < dn; ++i) {
        float* r = X + size_t(b + 2 * i) * width;
        for (int k = 0; k < width; ++k) r[k] = r[k] * kTwoInvK;
    }
    float *La = X + size_t(a) * width, *Lb = X + size_t(b) * width;
    float *Wa = X + size_t(a + 1) * width, *Wb = X + size_t(b + 1) * width;
    step2_97(Lb, Wa, sn, std::min(sn, dn - a), -kDelta, width);
    step2_97(La, Wb, dn, std::min(dn, sn - b), -kGamma, width);
    step2_97(Lb, Wa, sn, std::min(sn, dn - a), -kBeta, width);
    step2_97(La, Wb, dn, std::min(dn, sn - b), -kAlpha, width);
}

// The 2-D inverses, resolution by resolution: every row, then every column
// (the columns as rows of a whole band, lane by lane as OpenJPEG's vectors).
template <class T, class F>
void idwt_2d(TileComp& tc, std::vector<T>& data, int nres, F one_d) {
    int stride = tc.x1 - tc.x0;
    size_t area = size_t(stride) * (tc.y1 - tc.y0);
    std::vector<T> tmp(area), band(area), row(size_t(stride) * 2 + 4);
    for (int r = 1; r < nres; ++r) {
        const Res& prev = tc.res[r - 1];
        const Res& cur = tc.res[r];
        int rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
        int sn = prev.x1 - prev.x0, dn = rw - sn, cas = cur.x0 & 1;
        for (int j = 0; j < rh; ++j) {
            T* line = &data[size_t(j) * stride];
            one_d(line, sn, dn, cas, 1, row.data());
            std::copy(row.begin(), row.begin() + rw, line);
        }
        sn = prev.y1 - prev.y0;
        dn = rh - sn;
        cas = cur.y0 & 1;
        for (int j = 0; j < rh; ++j) std::copy(&data[size_t(j) * stride], &data[size_t(j) * stride] + rw, &band[size_t(j) * rw]);
        one_d(band.data(), sn, dn, cas, rw, tmp.data());
        for (int j = 0; j < rh; ++j) std::copy(&tmp[size_t(j) * rw], &tmp[size_t(j) * rw] + rw, &data[size_t(j) * stride]);
    }
}

void idwt53_2d(TileComp& tc, int nres) {
    idwt_2d(tc, tc.idata, nres, [](const int32_t* in, int sn, int dn, int cas, int width, int32_t* out) {
        if (width == 1) idwt53_line(in, sn, dn, cas, out);
        else idwt53(in, sn, dn, cas, width, out);
    });
}

void idwt97_2d(TileComp& tc, int nres) {
    idwt_2d(tc, tc.fdata, nres, [](const float* in, int sn, int dn, int cas, int width, float* out) {
        // interleave the low and high rows, then lift in place
        for (int i = 0; i < sn; ++i) std::copy(in + size_t(i) * width, in + size_t(i + 1) * width, out + size_t(cas + 2 * i) * width);
        for (int i = 0; i < dn; ++i)
            std::copy(in + size_t(sn + i) * width, in + size_t(sn + i + 1) * width, out + size_t(1 - cas + 2 * i) * width);
        idwt97(out, sn, dn, cas, width);
    });
}

// ---------------------------------------------------------------------------
// The codestream
// ---------------------------------------------------------------------------

struct Decoder {
    const uint8_t* cs;
    size_t n;
    size_t pos = 0;
    uint32_t ihdr_w = 0, ihdr_h = 0;

    // SIZ
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
    int numcomps = 0, tw = 0, th = 0;
    std::vector<Comp> comps;
    // per component, the highest resolution any packet decoded so far came
    // from (OpenJPEG's resno_decoded): the inverse wavelet stops there
    std::vector<int> resno_decoded;
    TCP def;
    std::vector<TCP> tcps;
    std::vector<std::pair<int, std::vector<uint8_t>>> ppm_segs;
    std::vector<uint8_t> ppm_data;
    size_t ppm_pos = 0;
    bool ppm = false;
    int state = 0;

    Decoder(const uint8_t* p, size_t len) : cs(p), n(len) {}

    size_t left() const { return n - pos; }
    bool read2(uint32_t& v) {
        if (left() < 2) return false;
        v = be16(cs + pos);
        pos += 2;
        return true;
    }
    TCP& cur_tcp(int tileno) { return state == ST_TPH ? tcps[tileno] : def; }

    // ---- marker segments ----

    void read_siz(const uint8_t* p, uint32_t size) {
        if (size < 36) fail("error with SIZ marker size");
        uint32_t rem = size - 36;
        if (rem % 3) fail("error with SIZ marker size");
        x1 = be32(p + 2);
        y1 = be32(p + 6);
        x0 = be32(p + 10);
        y0 = be32(p + 14);
        tdx = be32(p + 18);
        tdy = be32(p + 22);
        tx0 = be32(p + 26);
        ty0 = be32(p + 30);
        uint32_t nc = be16(p + 34);
        if (nc >= 16385) fail("SIZ: illegal number of components");
        if (nc != rem / 3) fail("SIZ: number of components does not match the segment's size");
        numcomps = int(nc);
        if (x0 >= x1 || y0 >= y1) fail("SIZ: negative or zero image size");
        if (tdx == 0 || tdy == 0) fail("SIZ: invalid tile size");
        uint64_t tx1 = uint64_t(tx0) + tdx, ty1 = uint64_t(ty0) + tdy;
        if (tx1 > 0xffffffffu) tx1 = 0xffffffffu;
        if (ty1 > 0xffffffffu) ty1 = 0xffffffffu;
        if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) fail("SIZ: illegal tile offset");
        if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != x1 - x0 || ihdr_h != y1 - y0)) fail("SIZ: size differs from the JP2 header's");
        comps.resize(numcomps);
        for (int i = 0; i < numcomps; ++i) {
            const uint8_t* q = p + 36 + 3 * i;
            comps[i].prec = (q[0] & 0x7f) + 1;
            comps[i].sgnd = q[0] >> 7;
            comps[i].dx = q[1];
            comps[i].dy = q[2];
            if (comps[i].dx < 1 || comps[i].dy < 1) fail("SIZ: invalid component subsampling");
            if (comps[i].prec > 31) fail("SIZ: precision above 31 bits");
        }
        tw = ceildiv(int64_t(x1) - tx0, tdx);
        th = ceildiv(int64_t(y1) - ty0, tdy);
        if (tw == 0 || th == 0 || tw > 65535 / th) fail("SIZ: invalid number of tiles");
        def.tccps.assign(numcomps, TCCP());
        state = ST_MH;
    }

    void read_spcod(TCCP& t, const uint8_t*& p, uint32_t& size) {
        if (size < 5) fail("error reading SPCod/SPCoc");
        t.numres = p[0] + 1;
        if (t.numres > MAXRLVLS) fail("invalid number of resolutions");
        t.cblkw = p[1] + 2;
        t.cblkh = p[2] + 2;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) fail("invalid code-block size");
        t.cblksty = p[3];
        if (t.cblksty & 0x80) fail("unsupported mixed HT code-block style");
        t.qmfbid = p[4];
        if (t.qmfbid > 1) fail("invalid wavelet transformation");
        p += 5;
        size -= 5;
        if (t.csty & 1) {
            if (size < uint32_t(t.numres)) fail("error reading SPCod/SPCoc precincts");
            for (int i = 0; i < t.numres; ++i) {
                int v = p[i];
                if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("invalid precinct size");
                t.prcw[i] = v & 0xf;
                t.prch[i] = v >> 4;
            }
            p += t.numres;
            size -= t.numres;
        } else {
            for (int i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
        }
    }

    void copy_spcod(TCP& tcp) {
        const TCCP& s = tcp.tccps[0];
        for (int i = 1; i < numcomps; ++i) {
            TCCP& d = tcp.tccps[i];
            d.numres = s.numres;
            d.cblkw = s.cblkw;
            d.cblkh = s.cblkh;
            d.cblksty = s.cblksty;
            d.qmfbid = s.qmfbid;
            std::copy(s.prcw, s.prcw + MAXRLVLS, d.prcw);
            std::copy(s.prch, s.prch + MAXRLVLS, d.prch);
        }
    }

    void read_cod(TCP& tcp, const uint8_t* p, uint32_t size) {
        if (size < 5) fail("error reading COD marker");
        tcp.csty = p[0];
        if (tcp.csty & ~7) fail("unknown Scod value in COD marker");
        tcp.prg = p[1] > 4 ? -1 : p[1];  // OpenJPEG's decode then fails
        tcp.numlayers = int(be16(p + 2));
        if (tcp.numlayers < 1) fail("invalid number of layers in COD marker");
        tcp.mct = p[4];
        if (tcp.mct > 1) fail("invalid multiple component transformation");
        p += 5;
        size -= 5;
        for (int i = 0; i < numcomps; ++i) tcp.tccps[i].csty = tcp.csty & 1;
        read_spcod(tcp.tccps[0], p, size);
        if (size != 0) fail("error reading COD marker");
        copy_spcod(tcp);
    }

    int comp_room() const { return numcomps <= 256 ? 1 : 2; }

    void read_coc(TCP& tcp, const uint8_t* p, uint32_t size) {
        int room = comp_room();
        if (size < uint32_t(room) + 1) fail("error reading COC marker");
        uint32_t c = room == 1 ? p[0] : be16(p);
        if (c >= uint32_t(numcomps)) fail("error reading COC marker (bad component)");
        tcp.tccps[c].csty = p[room];
        p += room + 1;
        size -= room + 1;
        read_spcod(tcp.tccps[c], p, size);
        if (size != 0) fail("error reading COC marker");
    }

    void read_sqcd(TCCP& t, const uint8_t*& p, uint32_t& size) {
        if (size < 1) fail("error reading SQcd/SQcc");
        size -= 1;
        int v = *p++;
        t.qntsty = v & 0x1f;
        t.numgbits = v >> 5;
        uint32_t nb;
        if (t.qntsty == 1) nb = 1;
        else nb = t.qntsty == 0 ? size : size / 2;
        if (t.qntsty == 0) {
            if (size < nb) fail("error reading SQcd/SQcc");
            for (uint32_t b = 0; b < nb; ++b) {
                if (b < uint32_t(MAXBANDS)) {
                    t.expn[b] = p[b] >> 3;
                    t.mant[b] = 0;
                }
            }
            p += nb;
            size -= nb;
        } else {
            if (size < 2 * nb) fail("error reading SQcd/SQcc");
            for (uint32_t b = 0; b < nb; ++b) {
                uint32_t s = be16(p + 2 * b);
                if (b < uint32_t(MAXBANDS)) {
                    t.expn[b] = int(s >> 11);
                    t.mant[b] = int(s & 0x7ff);
                }
            }
            p += 2 * nb;
            size -= 2 * nb;
        }
        if (t.qntsty == 1) {
            for (int b = 1; b < MAXBANDS; ++b) {
                int e = t.expn[0] - (b - 1) / 3;
                t.expn[b] = e > 0 ? e : 0;
                t.mant[b] = t.mant[0];
            }
        }
    }

    void copy_qcd(TCP& tcp) {
        const TCCP& s = tcp.tccps[0];
        for (int i = 1; i < numcomps; ++i) {
            TCCP& d = tcp.tccps[i];
            d.qntsty = s.qntsty;
            d.numgbits = s.numgbits;
            std::copy(s.expn, s.expn + MAXBANDS, d.expn);
            std::copy(s.mant, s.mant + MAXBANDS, d.mant);
        }
    }

    void read_qcd(TCP& tcp, const uint8_t* p, uint32_t size) {
        read_sqcd(tcp.tccps[0], p, size);
        if (size != 0) fail("error reading QCD marker");
        copy_qcd(tcp);
    }

    void read_qcc(TCP& tcp, const uint8_t* p, uint32_t size) {
        int room = comp_room();
        if (size < uint32_t(room)) fail("error reading QCC marker");
        uint32_t c = room == 1 ? p[0] : be16(p);
        if (c >= uint32_t(numcomps)) fail("invalid component number in QCC marker");
        p += room;
        size -= room;
        read_sqcd(tcp.tccps[c], p, size);
        if (size != 0) fail("error reading QCC marker");
    }

    void read_rgn(TCP& tcp, const uint8_t* p, uint32_t size) {
        int room = comp_room();
        if (size != uint32_t(2 + room)) fail("error reading RGN marker");
        uint32_t c = room == 1 ? p[0] : be16(p);
        if (c >= uint32_t(numcomps)) fail("bad component number in RGN");
        tcp.tccps[c].roishift = p[room + 1];
    }

    void read_poc(TCP& tcp, const uint8_t* p, uint32_t size) {
        int room = comp_room();
        uint32_t chunk = 5 + 2 * room;
        uint32_t cnt = size / chunk;
        if (cnt == 0 || size % chunk) fail("error reading POC marker");
        size_t old = tcp.has_poc ? tcp.pocs.size() : 0;
        if (old + cnt >= size_t(MAX_POCS)) fail("too many POCs");
        tcp.has_poc = true;
        tcp.pocs.resize(old);
        for (uint32_t i = 0; i < cnt; ++i) {
            POC pc;
            pc.resno0 = p[0];
            pc.compno0 = room == 1 ? p[1] : be16(p + 1);
            pc.layno1 = be16(p + 1 + room);
            pc.resno1 = p[3 + room];
            pc.compno1 = room == 1 ? p[4 + room] : be16(p + 4 + room);
            pc.prg = p[4 + 2 * room];
            pc.compno1 = std::min<uint32_t>(pc.compno1, uint32_t(numcomps));
            tcp.pocs.push_back(pc);
            p += chunk;
        }
    }

    void read_ppm(const uint8_t* p, uint32_t size) {
        if (size < 2) fail("error reading PPM marker");
        ppm = true;
        for (auto& seg : ppm_segs)
            if (seg.first == p[0]) fail("Zppm already read");
        ppm_segs.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + size));
    }

    void read_ppt(TCP& tcp, const uint8_t* p, uint32_t size) {
        if (size < 2) fail("error reading PPT marker");
        if (ppm) fail("PPT marker present while PPM marker present");
        for (auto& seg : tcp.ppt_segs)
            if (seg.first == p[0]) fail("Zppt already read");
        tcp.ppt_segs.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + size));
    }

    // The PPM segments in Zppm order, each tile-part's Nppm stripped; an Nppm
    // must lie within one segment, its headers may run on into the next
    // (OpenJPEG's opj_j2k_merge_ppm).
    void merge_ppm() {
        if (!ppm) return;
        std::stable_sort(ppm_segs.begin(), ppm_segs.end(),
                         [](const auto& a, const auto& b) { return a.first < b.first; });
        uint64_t remaining = 0;
        for (auto& seg : ppm_segs) {
            const uint8_t* d = seg.second.data();
            uint64_t rest = seg.second.size();
            uint64_t take = std::min(remaining, rest);
            ppm_data.insert(ppm_data.end(), d, d + take);
            d += take;
            rest -= take;
            remaining -= take;
            while (rest > 0) {
                if (rest < 4) fail("not enough bytes to read Nppm");
                uint32_t nppm = be32(d);
                d += 4;
                rest -= 4;
                take = std::min<uint64_t>(nppm, rest);
                ppm_data.insert(ppm_data.end(), d, d + take);
                d += take;
                rest -= take;
                remaining = nppm - take;
            }
        }
        if (remaining) fail("corrupted PPM markers");
    }

    void handle(uint32_t m, int tileno, const uint8_t* p, uint32_t size) {
        switch (m) {
            case MS_SIZ: read_siz(p, size); break;
            case MS_COD: read_cod(cur_tcp(tileno), p, size); break;
            case MS_COC: read_coc(cur_tcp(tileno), p, size); break;
            case MS_QCD: read_qcd(cur_tcp(tileno), p, size); break;
            case MS_QCC: read_qcc(cur_tcp(tileno), p, size); break;
            case MS_RGN: read_rgn(cur_tcp(tileno), p, size); break;
            case MS_POC: read_poc(cur_tcp(tileno), p, size); break;
            case MS_PPM: read_ppm(p, size); break;
            case MS_PPT: read_ppt(tcps[tileno], p, size); break;
            case MS_CRG:
                if (size != uint32_t(numcomps) * 4) fail("error reading CRG marker");
                break;
            case MS_TLM:  // a size the entries do not fill only warns
                if (size < 2) fail("error reading TLM marker");
                break;
            case MS_PLT: {  // only checked: the last packet length ends in the segment
                if (size < 1) fail("error reading PLT marker");
                uint32_t len = 0;
                for (uint32_t i = 1; i < size; ++i) {
                    len |= p[i] & 0x7f;
                    len = (p[i] & 0x80) ? len << 7 : 0;
                }
                if (len) fail("error reading PLT marker");
                break;
            }
            case MS_PLM:
                if (size < 1) fail("error reading PLM marker");
                break;
            default: break;  // COM; Part 2's MCT/MCC/MCO/CBD, used only under COD's MCT 2,
                             // which read_cod refuses; HT's CAP/CPF, whose code-blocks decode_tile names
        }
    }

    // OpenJPEG's opj_j2k_read_unk: 2-byte words up to a known marker.
    uint32_t skip_unknown() {
        for (;;) {
            uint32_t m;
            if (!read2(m)) fail("stream too short");
            if (m >= 0xff00) {
                int st = marker_states(m);
                if (st >= 0) {
                    if (!(state & st)) fail("marker is not compliant with its position");
                    return m;
                }
            }
        }
    }

    void read_main_header() {
        uint32_t m;
        if (!read2(m) || m != MS_SOC) fail("expected a SOC marker");
        state = ST_MHSIZ;
        if (!read2(m)) fail("stream too short");
        bool has_siz = false, has_cod = false, has_qcd = false;
        while (m != MS_SOT) {
            if (m < 0xff00) fail("a marker ID was expected");
            int st = marker_states(m);
            if (st < 0) {
                m = skip_unknown();
                if (m == MS_SOT) break;
                st = marker_states(m);
            }
            has_siz |= m == MS_SIZ;
            has_cod |= m == MS_COD;
            has_qcd |= m == MS_QCD;
            if (!(state & st)) fail("marker is not compliant with its position");
            uint32_t size;
            if (!read2(size)) fail("stream too short");
            if (size < 2) fail("invalid marker size");
            size -= 2;
            if (left() < size) fail("stream too short");
            const uint8_t* p = cs + pos;
            pos += size;
            handle(m, -1, p, size);
            if (!read2(m)) fail("stream too short");
        }
        if (!has_siz) fail("required SIZ marker not found in main header");
        if (!has_cod) fail("required COD marker not found in main header");
        if (!has_qcd) fail("required QCD marker not found in main header");
        merge_ppm();
        state = ST_TPHSOT;
    }

    // ---- tiles ----

    struct Tile {
        int x0, y0, x1, y1;
        std::vector<TileComp> comps;
    };

    void init_tile(Tile& t, int tileno, const TCP& tcp) {
        int p = tileno % tw, q = tileno / tw;
        t.x0 = int(std::max<int64_t>(int64_t(tx0) + int64_t(p) * tdx, x0));
        t.y0 = int(std::max<int64_t>(int64_t(ty0) + int64_t(q) * tdy, y0));
        t.x1 = int(std::min<int64_t>(int64_t(tx0) + int64_t(p + 1) * tdx, x1));
        t.y1 = int(std::min<int64_t>(int64_t(ty0) + int64_t(q + 1) * tdy, y1));
        t.comps.resize(numcomps);
        for (int c = 0; c < numcomps; ++c) {
            const TCCP& tccp = tcp.tccps[c];
            TileComp& tc = t.comps[c];
            tc.x0 = ceildiv(t.x0, comps[c].dx);
            tc.y0 = ceildiv(t.y0, comps[c].dy);
            tc.x1 = ceildiv(t.x1, comps[c].dx);
            tc.y1 = ceildiv(t.y1, comps[c].dy);
            tc.numres = tccp.numres;
            tc.res.resize(tc.numres);
            for (int r = 0; r < tc.numres; ++r) {
                Res& res = tc.res[r];
                int levelno = tc.numres - 1 - r;
                res.x0 = ceildivpow2(tc.x0, levelno);
                res.y0 = ceildivpow2(tc.y0, levelno);
                res.x1 = ceildivpow2(tc.x1, levelno);
                res.y1 = ceildivpow2(tc.y1, levelno);
                res.pdx = tccp.prcw[r];
                res.pdy = tccp.prch[r];
                int tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
                int tly = floordivpow2(res.y0, res.pdy) << res.pdy;
                int64_t brx = int64_t(ceildivpow2(res.x1, res.pdx)) << res.pdx;
                int64_t bry = int64_t(ceildivpow2(res.y1, res.pdy)) << res.pdy;
                res.pw = res.x0 == res.x1 ? 0 : int((brx - tlx) >> res.pdx);
                res.ph = res.y0 == res.y1 ? 0 : int((bry - tly) >> res.pdy);
                if (int64_t(res.pw) * res.ph > (1 << 24)) fail("too many precincts");
                int tlcbgx, tlcbgy, cbgw, cbgh;
                if (r == 0) {
                    tlcbgx = tlx;
                    tlcbgy = tly;
                    cbgw = res.pdx;
                    cbgh = res.pdy;
                    res.numbands = 1;
                } else {
                    tlcbgx = ceildivpow2(tlx, 1);
                    tlcbgy = ceildivpow2(tly, 1);
                    cbgw = res.pdx - 1;
                    cbgh = res.pdy - 1;
                    res.numbands = 3;
                }
                int cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
                for (int b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    int bi;
                    if (r == 0) {
                        band.bandno = 0;
                        band.x0 = ceildivpow2(tc.x0, levelno);
                        band.y0 = ceildivpow2(tc.y0, levelno);
                        band.x1 = ceildivpow2(tc.x1, levelno);
                        band.y1 = ceildivpow2(tc.y1, levelno);
                        bi = 0;
                    } else {
                        band.bandno = b + 1;
                        int x0b = band.bandno & 1, y0b = band.bandno >> 1;
                        band.x0 = ceildivpow2(int64_t(tc.x0) - (int64_t(x0b) << levelno), levelno + 1);
                        band.y0 = ceildivpow2(int64_t(tc.y0) - (int64_t(y0b) << levelno), levelno + 1);
                        band.x1 = ceildivpow2(int64_t(tc.x1) - (int64_t(x0b) << levelno), levelno + 1);
                        band.y1 = ceildivpow2(int64_t(tc.y1) - (int64_t(y0b) << levelno), levelno + 1);
                        bi = 3 * (r - 1) + b + 1;
                    }
                    double delta = (1.0 + tccp.mant[bi] / 2048.0) * std::pow(2.0, double(comps[c].prec - tccp.expn[bi]));
                    band.stepsize = float(delta);
                    band.numbps = tccp.expn[bi] + tccp.numgbits - 1;
                    band.precincts.clear();
                    if (band.empty()) continue;
                    band.precincts.resize(size_t(res.pw) * res.ph);
                    for (int pn = 0; pn < res.pw * res.ph; ++pn) {
                        Precinct& pr = band.precincts[pn];
                        int cbgx0 = tlcbgx + (pn % res.pw) * (1 << cbgw);
                        int cbgy0 = tlcbgy + (pn / res.pw) * (1 << cbgh);
                        pr.x0 = std::max(cbgx0, band.x0);
                        pr.y0 = std::max(cbgy0, band.y0);
                        pr.x1 = std::min(cbgx0 + (1 << cbgw), band.x1);
                        pr.y1 = std::min(cbgy0 + (1 << cbgh), band.y1);
                        int tlcbx = floordivpow2(pr.x0, cbw) << cbw;
                        int tlcby = floordivpow2(pr.y0, cbh) << cbh;
                        int brcbx = ceildivpow2(pr.x1, cbw) << cbw;
                        int brcby = ceildivpow2(pr.y1, cbh) << cbh;
                        pr.cw = (brcbx - tlcbx) >> cbw;
                        pr.ch = (brcby - tlcby) >> cbh;
                        if (pr.cw < 0 || pr.ch < 0) pr.cw = pr.ch = 0;
                        pr.cblks.resize(size_t(pr.cw) * pr.ch);
                        for (int k = 0; k < pr.cw * pr.ch; ++k) {
                            Cblk& cb = pr.cblks[k];
                            int cx = tlcbx + (k % pr.cw) * (1 << cbw);
                            int cy = tlcby + (k / pr.cw) * (1 << cbh);
                            cb.x0 = std::max(cx, pr.x0);
                            cb.y0 = std::max(cy, pr.y0);
                            cb.x1 = std::min(cx + (1 << cbw), pr.x1);
                            cb.y1 = std::min(cy + (1 << cbh), pr.y1);
                        }
                        pr.incl.init(pr.cw, pr.ch);
                        pr.imsb.init(pr.cw, pr.ch);
                    }
                }
            }
        }
    }

    // ---- packet iterator (OpenJPEG's pi.c) ----

    struct Packet {
        int layno, resno, compno, precno;
    };

    std::vector<Packet> packet_order(const Tile& t, const TCP& tcp) {
        int maxres = 0;
        uint32_t maxprec = 0;
        for (auto& tc : t.comps) {
            maxres = std::max(maxres, tc.numres);
            for (auto& r : tc.res) maxprec = std::max<uint32_t>(maxprec, uint32_t(r.pw) * r.ph);
        }
        size_t step_p = 1, step_c = maxprec * step_p, step_r = numcomps * step_c, step_l = maxres * step_r;
        size_t include_size = size_t(tcp.numlayers) * step_l;
        std::vector<uint8_t> include(include_size, 0);
        std::vector<Packet> out;
        std::vector<POC> pocs;
        if (tcp.has_poc) {
            for (auto p : tcp.pocs) {
                p.layno1 = std::min<uint32_t>(p.layno1, uint32_t(tcp.numlayers));
                pocs.push_back(p);
            }
        } else {
            pocs.push_back(POC{0, 0, uint32_t(tcp.numlayers), uint32_t(maxres), uint32_t(numcomps), uint32_t(int64_t(tcp.prg) & 0xffffffff)});
        }
        auto add = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
            size_t index = l * step_l + r * step_r + c * step_c + p * step_p;
            if (index >= include_size) fail("invalid access to the packet include table");
            if (!include[index]) {
                include[index] = 1;
                out.push_back(Packet{int(l), int(r), int(c), int(p)});
            }
        };
        for (const POC& poc : pocs) {
            uint32_t layno0 = 0;
            switch (poc.prg) {
                case 0:  // LRCP
                    for (uint32_t l = layno0; l < poc.layno1; ++l)
                        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
                            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                                const TileComp& tc = t.comps[c];
                                if (r >= uint32_t(tc.numres)) continue;
                                const Res& res = tc.res[r];
                                for (uint32_t p = 0; p < uint32_t(res.pw * res.ph); ++p) add(l, r, c, p);
                            }
                    break;
                case 1:  // RLCP
                    for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
                        for (uint32_t l = layno0; l < poc.layno1; ++l)
                            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                                const TileComp& tc = t.comps[c];
                                if (r >= uint32_t(tc.numres)) continue;
                                const Res& res = tc.res[r];
                                for (uint32_t p = 0; p < uint32_t(res.pw * res.ph); ++p) add(l, r, c, p);
                            }
                    break;
                case 2: case 3: case 4: position_order(t, poc, add); break;
                default:  // COD's unknown order fails the decode; a POC entry's iterates no packet
                    if (!tcp.has_poc) fail("unknown progression order");
            }
        }
        return out;
    }

    // The precinct of (comp c, resolution r) at reference-grid position
    // (x, y), or -1 (OpenJPEG's tests in opj_pi_next_rpcl and kin).
    int64_t precinct_at(const Tile& t, int c, uint32_t r, uint32_t x, uint32_t y) {
        const TileComp& tc = t.comps[c];
        const Res& res = tc.res[r];
        uint32_t levelno = uint32_t(tc.numres) - 1 - r;
        uint32_t cdx = uint32_t(comps[c].dx), cdy = uint32_t(comps[c].dy);
        if (levelno >= 32 || ((cdx << levelno) >> levelno) != cdx || ((cdy << levelno) >> levelno) != cdy) return -1;
        if ((uint64_t(cdx) << levelno) > 0x7fffffffu || (uint64_t(cdy) << levelno) > 0x7fffffffu) return -1;
        uint32_t sx = cdx << levelno, sy = cdy << levelno;
        uint32_t trx0 = uint32_t(ceildiv(t.x0, sx)), try0 = uint32_t(ceildiv(t.y0, sy));
        uint32_t trx1 = uint32_t(ceildiv(t.x1, sx)), try1 = uint32_t(ceildiv(t.y1, sy));
        uint32_t rpx = uint32_t(res.pdx) + levelno, rpy = uint32_t(res.pdy) + levelno;
        if (rpx >= 31 || ((cdx << rpx) >> rpx) != cdx || rpy >= 31 || ((cdy << rpy) >> rpy) != cdy) return -1;
        if (!((uint64_t(y) % (uint64_t(cdy) << rpy) == 0) ||
              (y == uint32_t(t.y0) && ((uint64_t(try0) << levelno) % (uint64_t(1) << rpy)))))
            return -1;
        if (!((uint64_t(x) % (uint64_t(cdx) << rpx) == 0) ||
              (x == uint32_t(t.x0) && ((uint64_t(trx0) << levelno) % (uint64_t(1) << rpx)))))
            return -1;
        if (res.pw == 0 || res.ph == 0) return -1;
        if (trx0 == trx1 || try0 == try1) return -1;
        uint32_t prci = (uint32_t(ceildiv(x, sx)) >> res.pdx) - (trx0 >> res.pdx);
        uint32_t prcj = (uint32_t(ceildiv(y, sy)) >> res.pdy) - (try0 >> res.pdy);
        return int64_t(prci) + int64_t(prcj) * res.pw;
    }

    bool grid_step(const Tile& t, int c0, int c1, uint32_t& dx, uint32_t& dy) {
        dx = dy = 0;
        for (int c = c0; c < c1; ++c) {
            const TileComp& tc = t.comps[c];
            for (int r = 0; r < tc.numres; ++r) {
                uint32_t sx = uint32_t(tc.res[r].pdx + tc.numres - 1 - r);
                uint32_t sy = uint32_t(tc.res[r].pdy + tc.numres - 1 - r);
                if (sx < 32 && uint32_t(comps[c].dx) <= 0xffffffffu / (1u << sx)) {
                    uint32_t v = uint32_t(comps[c].dx) * (1u << sx);
                    dx = !dx ? v : std::min(dx, v);
                }
                if (sy < 32 && uint32_t(comps[c].dy) <= 0xffffffffu / (1u << sy)) {
                    uint32_t v = uint32_t(comps[c].dy) * (1u << sy);
                    dy = !dy ? v : std::min(dy, v);
                }
            }
        }
        return dx != 0 && dy != 0;
    }

    template <class Add>
    void position_order(const Tile& t, const POC& poc, Add& add) {
        if (poc.compno0 >= uint32_t(numcomps) || poc.compno1 >= uint32_t(numcomps) + 1)
            return;  // OpenJPEG's pi_next ends this entry (it logs an error)
        uint32_t dx, dy;
        auto layers = [&](uint32_t r, uint32_t c, int64_t p) {
            for (uint32_t l = 0; l < poc.layno1; ++l) add(l, r, c, uint32_t(p));
        };
        uint32_t ty0u = uint32_t(t.y0), ty1u = uint32_t(t.y1), tx0u = uint32_t(t.x0), tx1u = uint32_t(t.x1);
        if (poc.prg == 2) {  // RPCL
            if (!grid_step(t, 0, numcomps, dx, dy)) return;
            for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
                for (uint32_t y = ty0u; y < ty1u; y += dy - (y % dy))
                    for (uint32_t x = tx0u; x < tx1u; x += dx - (x % dx))
                        for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                            if (r >= uint32_t(t.comps[c].numres)) continue;
                            int64_t p = precinct_at(t, int(c), r, x, y);
                            if (p >= 0) layers(r, c, p);
                        }
        } else if (poc.prg == 3) {  // PCRL
            if (!grid_step(t, 0, numcomps, dx, dy)) return;
            for (uint32_t y = ty0u; y < ty1u; y += dy - (y % dy))
                for (uint32_t x = tx0u; x < tx1u; x += dx - (x % dx))
                    for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                        uint32_t rmax = std::min<uint32_t>(poc.resno1, uint32_t(t.comps[c].numres));
                        for (uint32_t r = poc.resno0; r < rmax; ++r) {
                            int64_t p = precinct_at(t, int(c), r, x, y);
                            if (p >= 0) layers(r, c, p);
                        }
                    }
        } else {  // CPRL
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (!grid_step(t, int(c), int(c) + 1, dx, dy)) return;
                uint32_t rmax = std::min<uint32_t>(poc.resno1, uint32_t(t.comps[c].numres));
                for (uint32_t y = ty0u; y < ty1u; y += dy - (y % dy))
                    for (uint32_t x = tx0u; x < tx1u; x += dx - (x % dx))
                        for (uint32_t r = poc.resno0; r < rmax; ++r) {
                            int64_t p = precinct_at(t, int(c), r, x, y);
                            if (p >= 0) layers(r, c, p);
                        }
            }
        }
    }

    // ---- tier 2 ----

    static void init_seg(Cblk& cb, uint32_t index, int cblksty, bool first) {
        if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
        Seg& s = cb.segs[index];
        s = Seg();
        if (cblksty & CBLK_TERMALL) s.maxpasses = 1;
        else if (cblksty & CBLK_LAZY) {
            if (first) s.maxpasses = 10;
            else {
                uint32_t prev = cb.segs[index - 1].maxpasses;
                s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
            }
        } else s.maxpasses = 109;
    }

    static uint32_t numpasses(Bio& bio) {
        uint32_t n;
        if (!bio.read(1)) return 1;
        if (!bio.read(1)) return 2;
        if ((n = bio.read(2)) != 3) return 3 + n;
        if ((n = bio.read(5)) != 31) return 6 + n;
        return 37 + bio.read(7);
    }

    // One packet; returns the bytes of the tile data it took.
    size_t read_packet(Tile& t, TCP& tcp, const Packet& pk, const std::vector<uint8_t>& data, size_t dpos,
                       std::vector<uint8_t>* hdr_src, size_t* hdr_pos) {
        TileComp& tc = t.comps[pk.compno];
        Res& res = tc.res[pk.resno];
        const TCCP& tccp = tcp.tccps[pk.compno];
        size_t maxlen = data.size() - dpos;
        const uint8_t* src = data.data() + dpos;
        if (pk.layno == 0) {
            for (int b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                if (band.empty()) continue;
                if (size_t(pk.precno) >= band.precincts.size()) fail("invalid precinct");
                Precinct& pr = band.precincts[pk.precno];
                pr.incl.reset();
                pr.imsb.reset();
                for (auto& cb : pr.cblks) {
                    cb.numsegs = 0;
                    cb.real_num_segs = 0;
                }
            }
        }
        size_t cur = 0;  // offset in src
        if (tcp.csty & 2) {  // SOP: optional, as OpenJPEG reads it
            if (maxlen >= 6 && src[0] == 0xff && src[1] == 0x91) cur += 6;
        }
        const uint8_t* hp;
        size_t hlen;
        if (hdr_src) {
            hp = hdr_src->data() + *hdr_pos;
            hlen = hdr_src->size() - *hdr_pos;
        } else {
            hp = src + cur;
            hlen = maxlen - cur;
        }
        Bio bio(hp, hlen);
        uint32_t present = bio.read(1);
        auto finish_header = [&](bool ok) {
            if (!ok) fail("packet header ends inside a stuffed byte");
            size_t hl = bio.numbytes();
            if (tcp.csty & 4) {  // EPH: required
                if (hlen - hl < 2) fail("not enough space for required EPH marker");
                if (hp[hl] != 0xff || hp[hl + 1] != 0x92) fail("expected EPH marker");
                hl += 2;
            }
            if (hdr_src) *hdr_pos += hl;
            else cur += hl;
        };
        if (!present) {
            bio.inalign();
            finish_header(true);
            return cur;
        }
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precincts[pk.precno];
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
                Cblk& cb = pr.cblks[k];
                uint32_t included;
                if (!cb.numsegs) included = pr.incl.decode(bio, k, pk.layno + 1);
                else included = bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    int i = 0;
                    while (!pr.imsb.decode(bio, k, i)) ++i;
                    cb.numbps = uint32_t(band.numbps) + 1 - uint32_t(i);
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = numpasses(bio);
                uint32_t inc = 0;
                while (bio.read(1)) ++inc;
                cb.numlenbits += inc;
                uint32_t segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, 0, tccp.cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                }
                int32_t nleft = int32_t(cb.numnewpasses);
                do {
                    Seg& s = cb.segs[segno];
                    s.numnewpasses = uint32_t(std::min<int64_t>(int64_t(s.maxpasses) - s.numpasses, nleft));
                    uint32_t fl2 = 0;
                    for (uint32_t v = s.numnewpasses; v > 1; v >>= 1) ++fl2;
                    uint32_t bits = cb.numlenbits + fl2;
                    if (bits > 32) fail("invalid bit number in packet header");
                    s.newlen = bio.read(bits);
                    nleft -= int32_t(s.numnewpasses);
                    if (nleft > 0) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                } while (nleft > 0);
            }
        }
        finish_header(bio.inalign());
        // packet body
        size_t body = cur;
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precincts[pk.precno];
            for (auto& cb : pr.cblks) {
                if (!cb.numnewpasses) continue;
                Seg* seg;
                if (!cb.numsegs) {
                    seg = &cb.segs[0];
                    ++cb.numsegs;
                } else {
                    seg = &cb.segs[cb.numsegs - 1];
                    if (seg->numpasses == seg->maxpasses) {
                        ++seg;
                        ++cb.numsegs;
                    }
                }
                do {
                    if (body + seg->newlen > maxlen) fail("segment too long for the packet data");
                    cb.chunks.emplace_back(dpos + body, seg->newlen);
                    body += seg->newlen;
                    seg->len += seg->newlen;
                    seg->numpasses += seg->numnewpasses;
                    cb.numnewpasses -= seg->numnewpasses;
                    seg->real_num_passes = seg->numpasses;
                    if (cb.numnewpasses > 0) {
                        ++seg;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                cb.real_num_segs = cb.numsegs;
            }
        }
        return body;
    }

    // ---- a whole tile ----

    void decode_tile(int tileno, int32_t* out) {
        TCP& tcp = tcps[tileno];
        for (int c = 0; c < numcomps; ++c)
            if (tcp.tccps[c].cblksty & CBLK_HT) not_ported("HT code-blocks (Part 15)");
        Tile t;
        init_tile(t, tileno, tcp);
        std::vector<uint8_t> ppt;
        size_t ppt_pos = 0;
        if (!tcp.ppt_segs.empty()) {
            std::stable_sort(tcp.ppt_segs.begin(), tcp.ppt_segs.end(),
                             [](const auto& a, const auto& b) { return a.first < b.first; });
            for (auto& s : tcp.ppt_segs) ppt.insert(ppt.end(), s.second.begin(), s.second.end());
        }
        std::vector<uint8_t>* hsrc = ppm ? &ppm_data : (tcp.ppt_segs.empty() ? nullptr : &ppt);
        size_t* hpos = ppm ? &ppm_pos : &ppt_pos;
        size_t dpos = 0;
        for (const Packet& pk : packet_order(t, tcp)) {
            dpos += read_packet(t, tcp, pk, tcp.data, dpos, hsrc, hpos);
            resno_decoded[pk.compno] = std::max(resno_decoded[pk.compno], pk.resno);
        }
        // tier 1, dequantisation, inverse wavelet
        T1 t1;
        for (int c = 0; c < numcomps; ++c) {
            TileComp& tc = t.comps[c];
            const TCCP& tccp = tcp.tccps[c];
            int tw_ = tc.x1 - tc.x0, th_ = tc.y1 - tc.y0;
            bool rev = tccp.qmfbid == 1;
            if (rev) tc.idata.assign(size_t(tw_) * th_, 0);
            else tc.fdata.assign(size_t(tw_) * th_, 0.0f);
            for (int r = 0; r < tc.numres; ++r) {
                Res& res = tc.res[r];
                for (int b = 0; b < res.numbands; ++b) {
                    Band& band = res.bands[b];
                    if (band.empty()) continue;
                    int orient = band.bandno;
                    for (auto& pr : band.precincts)
                        for (auto& cb : pr.cblks) {
                            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                            if (!decode_cblk(t1, cb, tcp.data, orient, tccp.roishift, tccp.cblksty))
                                fail("unsupported number of bit-planes in a code-block");
                            int w = t1.w, h = t1.h;
                            std::vector<int32_t>& d = t1.data;
                            if (tccp.roishift) {
                                if (tccp.roishift >= 31) std::fill(d.begin(), d.end(), 0);
                                else {
                                    int32_t thresh = 1 << tccp.roishift;
                                    for (auto& v : d) {
                                        int32_t mag = v < 0 ? -v : v;
                                        if (mag >= thresh) {
                                            mag >>= tccp.roishift;
                                            v = v < 0 ? -mag : mag;
                                        }
                                    }
                                }
                            }
                            int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                            if (rev) {
                                for (int j = 0; j < h; ++j)
                                    for (int i = 0; i < w; ++i) tc.idata[size_t(y + j) * tw_ + x + i] = d[size_t(j) * w + i] / 2;
                            } else {
                                float step = 0.5f * band.stepsize;
                                for (int j = 0; j < h; ++j)
                                    for (int i = 0; i < w; ++i) {
                                        tc.fdata[size_t(y + j) * tw_ + x + i] = float(d[size_t(j) * w + i]) * step;
                                    }
                            }
                        }
                }
            }
            int nres = std::min(tc.numres, resno_decoded[c] + 1);
            if (rev) idwt53_2d(tc, nres);
            else idwt97_2d(tc, nres);
        }
        // multi-component transform
        if (tcp.mct == 1 && numcomps >= 3) {
            size_t npix = size_t(t.comps[0].x1 - t.comps[0].x0) * (t.comps[0].y1 - t.comps[0].y0);
            for (int c = 1; c < 3; ++c) {
                size_t m = size_t(t.comps[c].x1 - t.comps[c].x0) * (t.comps[c].y1 - t.comps[c].y0);
                if (m < npix) fail("tiles don't all have the same dimension; no MCT");
            }
            if (tcp.tccps[0].qmfbid == 1) {
                if (tcp.tccps[1].qmfbid != 1 || tcp.tccps[2].qmfbid != 1) fail("mixed wavelets under the RCT");
                int32_t *c0 = t.comps[0].idata.data(), *c1 = t.comps[1].idata.data(), *c2 = t.comps[2].idata.data();
                for (size_t i = 0; i < npix; ++i) {
                    int32_t y = c0[i], u = c1[i], v = c2[i];
                    int32_t g = y - ((u + v) >> 2);
                    int32_t r = v + g, b = u + g;
                    c0[i] = r;
                    c1[i] = g;
                    c2[i] = b;
                }
            } else {
                if (tcp.tccps[1].qmfbid != 0 || tcp.tccps[2].qmfbid != 0) fail("mixed wavelets under the ICT");
                float *c0 = t.comps[0].fdata.data(), *c1 = t.comps[1].fdata.data(), *c2 = t.comps[2].fdata.data();
                for (size_t i = 0; i < npix; ++i) {
                    float y = c0[i], u = c1[i], v = c2[i];
                    c0[i] = y + v * 1.402f;
                    c1[i] = y - u * 0.34413f - v * 0.71414f;
                    c2[i] = y + u * 1.772f;
                }
            }
        }
        // DC level shift and clamp over the decoded resolution. With every
        // resolution decoded that is the whole tile. A packet order that
        // leaves the last ones out (a POC that does not cover them): in a
        // single tile as large as the image OpenJPEG hands over the whole
        // tile buffer, the rest of it raw coefficients (a 9/7 tile's as the
        // bits of its floats); otherwise it copies only the decoded region,
        // to that resolution's coordinates (opj_j2k_update_image_data).
        int W = int(x1 - x0), H = int(y1 - y0);
        bool whole_tile = tw == 1 && th == 1 && tx0 == 0 && ty0 == 0 && x0 == 0 && y0 == 0 && x1 == tdx && y1 == tdy;
        for (int c = 0; c < numcomps; ++c) {
            TileComp& tc = t.comps[c];
            const Comp& cp = comps[c];
            int64_t lo, hi, shift;
            if (cp.sgnd) {
                lo = -(int64_t(1) << (cp.prec - 1));
                hi = (int64_t(1) << (cp.prec - 1)) - 1;
                shift = 0;
            } else {
                lo = 0;
                hi = (int64_t(1) << cp.prec) - 1;
                shift = int64_t(1) << (cp.prec - 1);
            }
            int tw_ = tc.x1 - tc.x0, th_ = tc.y1 - tc.y0;
            const Res& rd = tc.res[std::min(tc.numres - 1, resno_decoded[c])];
            int rw = rd.x1 - rd.x0, rh = rd.y1 - rd.y0;
            if (!whole_tile && (rw == 0 || rh == 0)) fail("an empty decoded region in a tile");
            int32_t* plane = out + size_t(c) * W * H;
            bool rev = tcp.tccps[c].qmfbid == 1;
            int ox = whole_tile ? tc.x0 : rd.x0, oy = whole_tile ? tc.y0 : rd.y0;
            int cw = whole_tile ? tw_ : std::min(rw, W - (ox - int(x0)));
            int chgt = whole_tile ? th_ : std::min(rh, H - (oy - int(y0)));
            for (int j = 0; j < chgt; ++j) {
                int32_t* dst = plane + size_t(oy + j - int(y0)) * W + (ox - int(x0));
                size_t k = size_t(j) * tw_;
                int shifted = std::min(cw, j < rh ? rw : 0);
                if (rev) {
                    const int32_t* srcp = &tc.idata[k];
                    for (int i = 0; i < shifted; ++i) dst[i] = int32_t(std::min(hi, std::max(lo, int64_t(srcp[i]) + shift)));
                    std::copy(srcp + shifted, srcp + cw, dst + shifted);
                } else {
                    const float* srcp = &tc.fdata[k];
                    for (int i = 0; i < shifted; ++i) {
                        float f = srcp[i];
                        int64_t v;
                        if (f > float(INT32_MAX)) v = hi;
                        else if (f < float(INT32_MIN)) v = lo;
                        else v = int64_t(std::lrintf(f)) + shift;
                        dst[i] = int32_t(std::min(hi, std::max(lo, v)));
                    }
                    std::memcpy(dst + shifted, srcp + shifted, sizeof(float) * size_t(cw - shifted));
                }
            }
        }
    }

    // ---- the tile-part loop (opj_j2k_read_tile_header / decode_tile) ----

    // After a decoded tile: OpenJPEG reads the next marker, which must be
    // EOC, SOT, or the stream's last two bytes (nothing where the stream
    // ended inside a tile-part header). Returns false at EOC or at the
    // stream's end.
    bool after_tile(uint32_t& m) {
        if (state == ST_EOC || (state == ST_NEOC && left() == 0)) return false;
        if (!read2(m)) fail("stream too short after a tile");
        if (m == MS_EOC) {
            state = ST_EOC;
            return false;
        }
        if (m != MS_SOT) {
            if (left() == 0) {
                state = ST_NEOC;
                return false;
            }
            fail("stream too short, expected SOT");
        }
        return true;
    }

    void decode(int32_t* out) {
        read_main_header();
        resno_decoded.assign(numcomps, 0);
        int ntiles = tw * th;
        tcps.assign(ntiles, TCP());
        std::vector<uint8_t> decoded(ntiles, 0);
        int ndecoded = 0;
        uint32_t m = MS_SOT;
        for (;;) {
            // read tile-parts until one tile can be decoded
            int tileno = -1;
            bool can_decode = false;
            bool last_tile_part = false;
            while (!can_decode && m != MS_EOC) {
                uint64_t sot_length = 0;
                while (m != MS_SOD) {
                    if (left() == 0) {
                        state = ST_NEOC;
                        break;
                    }
                    uint32_t size;
                    if (!read2(size)) fail("stream too short");
                    if (size < 2) fail("inconsistent marker size");
                    if (m == 0x8080 && left() == 0) {
                        state = ST_NEOC;
                        break;
                    }
                    if ((state & ST_TPH) && sot_length != 0) {
                        if (sot_length < size + 2) fail("SOT length is less than a marker's size");
                        sot_length -= size + 2;
                    }
                    size -= 2;
                    int known = marker_states(m);
                    int st = known < 0 ? (ST_MH | ST_TPH) : known;
                    if (!(state & st)) fail("marker is not compliant with its position");
                    if (left() < size) fail("marker size inconsistent with stream length");
                    if (known < 0) fail("unknown marker in a tile-part header");
                    const uint8_t* p = cs + pos;
                    pos += size;
                    if (m == MS_SOT) {
                        if (size != 8) fail("error reading SOT marker");
                        uint32_t isot = be16(p), psot = be32(p + 2), tpsot = p[6], tnsot = p[7];
                        if (isot >= uint32_t(ntiles)) fail("tile index in SOT is greater than the number of tiles");
                        tileno = int(isot);
                        TCP& tcp = tcps[tileno];
                        if (!tcp.seen) {
                            tcp.csty = def.csty;
                            tcp.prg = def.prg;
                            tcp.numlayers = def.numlayers;
                            tcp.mct = def.mct;
                            tcp.tccps = def.tccps;
                            tcp.pocs = def.pocs;
                            tcp.has_poc = def.has_poc;
                            tcp.seen = true;
                        }
                        if (tcp.cur_part + 1 != int(tpsot)) fail("invalid tile-part index");
                        ++tcp.cur_part;
                        if (psot != 0 && psot < 14 && psot != 12) fail("invalid Psot value");
                        last_tile_part = psot == 0;
                        if (tcp.nb_parts != 0 && int(tpsot) >= tcp.nb_parts) fail("TPsot is not valid");
                        if (tnsot != 0) {
                            if (int(tpsot) >= int(tnsot)) fail("TPsot is not valid for TNsot");
                            tcp.nb_parts = int(tnsot);
                        }
                        if (tcp.nb_parts && tcp.nb_parts == int(tpsot) + 1) can_decode = true;
                        sot_length = last_tile_part ? 0 : uint64_t(psot) - 12;
                        state = ST_TPH;
                    } else {
                        handle(m, tileno, p, size);
                    }
                    if (!read2(m)) fail("stream too short");
                }
                if (left() == 0 && state == ST_NEOC) break;
                // SOD
                if (last_tile_part) {
                    if (left() < 2) fail("tile part length size inconsistent with stream length");
                    sot_length = left() - 2;
                } else if (sot_length >= 2) {
                    sot_length -= 2;
                }
                if (sot_length > left()) fail("tile part length size inconsistent with stream length");
                TCP& tcp = tcps[tileno];
                tcp.data.insert(tcp.data.end(), cs + pos, cs + pos + sot_length);
                pos += sot_length;
                state = ST_TPHSOT;
                if (!can_decode) {
                    if (!read2(m)) fail("stream too short");
                }
            }
            if (m == MS_EOC) state = ST_EOC;
            if (!can_decode) {
                // a tile whose tile-parts are not counted: the first with data
                tileno = -1;
                for (int i = 0; i < ntiles; ++i)
                    if (!decoded[i] && tcps[i].seen && !tcps[i].data.empty()) {
                        tileno = i;
                        break;
                    }
                if (tileno < 0) break;
            }
            decode_tile(tileno, out);
            decoded[tileno] = 1;
            tcps[tileno].data.clear();
            tcps[tileno].data.shrink_to_fit();
            bool more = after_tile(m);
            if (++ndecoded == ntiles) break;
            if (!more && state == ST_NEOC) break;
        }
        if (ndecoded == 0) fail("no tile was decoded");
    }
};

int finish(const Fail& f, char* err, int errlen) {
    if (err && errlen > 0) {
        std::strncpy(err, f.msg.c_str(), size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
    return f.code;
}

}  // namespace

extern "C" {

// The main header: info = [x0, y0, x1, y1, numcomps, then for up to
// max_comps components prec, sgnd, dx, dy]. ihdr_w/h: a JP2 header's size,
// or 0 for a raw codestream.
int tl_j2k_header(const uint8_t* cs, size_t n, uint32_t ihdr_w, uint32_t ihdr_h, int64_t* info, int max_comps,
                  char* err, int errlen) {
    try {
        Decoder d(cs, n);
        d.ihdr_w = ihdr_w;
        d.ihdr_h = ihdr_h;
        d.read_main_header();
        info[0] = d.x0;
        info[1] = d.y0;
        info[2] = d.x1;
        info[3] = d.y1;
        info[4] = d.numcomps;
        for (int c = 0; c < std::min(d.numcomps, max_comps); ++c) {
            info[5 + 4 * c] = d.comps[c].prec;
            info[6 + 4 * c] = d.comps[c].sgnd;
            info[7 + 4 * c] = d.comps[c].dx;
            info[8 + 4 * c] = d.comps[c].dy;
        }
        return 0;
    } catch (const Fail& f) {
        return finish(f, err, errlen);
    } catch (const std::bad_alloc&) {
        return finish(Fail{"out of memory", -1}, err, errlen);
    }
}

// Decodes every tile into out: numcomps planes of (y1 - y0) x (x1 - x0)
// int32, after the MCT, the DC level shift and the clamp.
int tl_j2k_decode(const uint8_t* cs, size_t n, uint32_t ihdr_w, uint32_t ihdr_h, int32_t* out, char* err,
                  int errlen) {
    if (!luts_ready) make_luts();
    try {
        Decoder d(cs, n);
        d.ihdr_w = ihdr_w;
        d.ihdr_h = ihdr_h;
        d.decode(out);
        return 0;
    } catch (const Fail& f) {
        return finish(f, err, errlen);
    } catch (const std::bad_alloc&) {
        return finish(Fail{"out of memory", -1}, err, errlen);
    }
}

}  // extern "C"
