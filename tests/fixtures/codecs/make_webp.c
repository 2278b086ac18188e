/* Writes the WebP fixtures of tests/test_torch_codecs_webp.py: the encoder
 * settings that neither cv2 nor PIL sets (the simple loop filter, filter
 * strengths 0-100 and sharpness, 1-4 segments, 1/2/4/8 token partitions,
 * alpha compression and alpha filtering, near-lossless, lossless methods
 * and palettes of 2 to 256 colours), VP8X files with EXIF (orientations
 * 1-8), ICCP and XMP chunks, animations whose first frame is a
 * sub-rectangle of the canvas, raw ALPH chunks under each unfilter, and
 * files cv2 refuses (cut short, a RIFF size past the data, corrupt alpha).
 *
 * Build and run from the repository root, against libwebp, libwebpmux and
 * libwebpdemux:
 *
 *   cc -O2 -o make_webp tests/fixtures/codecs/make_webp.c -lwebp -lwebpmux -lwebpdemux
 *   ./make_webp tests/fixtures/codecs/webp && rm make_webp
 *   python tests/fixtures/codecs/make_digests.py
 *
 * (the last also writes the capture's frames as WebP and cv2's digests).
 * The tests read the committed files and never build this program.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>
#include <webp/mux.h>

static const char* out_dir;

static void write_file(const char* name, const uint8_t* data, size_t size) {
    char path[1024];
    snprintf(path, sizeof path, "%s/%s", out_dir, name);
    FILE* f = fopen(path, "wb");
    if (!f || fwrite(data, 1, size, f) != size) {
        perror(path);
        exit(1);
    }
    fclose(f);
}

/* RGBA rows: a smooth gradient with deterministic noise, hard edges and a
 * textured disc, so that every prediction mode and coefficient band shows
 * up; alpha a ramp with a transparent and an opaque region. */
static uint8_t* pattern(int w, int h, unsigned seed) {
    uint8_t* p = malloc((size_t)w * h * 4);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            seed = seed * 1103515245u + 12345u;
            const int noise = (int)((seed >> 16) % 41) - 20;
            const int dx = x - w / 2, dy = y - h / 2;
            const int disc = dx * dx + dy * dy < (w * h) / 10;
            const int edge = ((x / 7) + (y / 5)) & 1;
            int v[4] = {x * 255 / (w > 1 ? w - 1 : 1), y * 255 / (h > 1 ? h - 1 : 1), (x + y) * 4 % 256, 0};
            for (int c = 0; c < 3; c++) {
                if (disc) v[c] = 255 - v[c] + noise;
                if (edge && c == 1) v[c] = v[c] / 2 + 100;
                v[c] = v[c] < 0 ? 0 : v[c] > 255 ? 255 : v[c];
            }
            v[3] = x < w / 4 ? 0 : x > 3 * w / 4 ? 255 : (x * 255 / (w > 1 ? w - 1 : 1) + noise + 256) % 256;
            uint8_t* o = p + ((size_t)y * w + x) * 4;
            for (int c = 0; c < 4; c++) o[c] = (uint8_t)v[c];
        }
    }
    return p;
}

/* RGBA of at most `colours` distinct values (for the colour-indexing
 * transform and its pixel bundling). */
static uint8_t* palette_pattern(int w, int h, int colours, unsigned seed) {
    uint8_t* p = malloc((size_t)w * h * 4);
    uint8_t pal[256][4];
    for (int i = 0; i < colours; i++) {
        seed = seed * 1103515245u + 12345u;
        for (int c = 0; c < 4; c++) pal[i][c] = (uint8_t)(seed >> (8 + 5 * c));
        pal[i][3] = i % 3 ? 255 : pal[i][3];
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            seed = seed * 1103515245u + 12345u;
            const int i = ((x / 3 + y / 2) + (int)((seed >> 20) % 3)) % colours;
            memcpy(p + ((size_t)y * w + x) * 4, pal[i], 4);
        }
    return p;
}

typedef struct {
    float quality;
    int lossless, method, filter_type, filter_strength, filter_sharpness, segments, sns, partitions;
    int alpha, alpha_compression, alpha_filtering, alpha_quality, near_lossless, exact;
} Opts;

static Opts lossy(float q) {
    Opts o = {q, 0, 4, 1, 60, 0, 4, 50, 0, 0, 1, 1, 100, 100, 0};
    return o;
}

static WebPData encode(const uint8_t* rgba, int w, int h, Opts o) {
    WebPConfig cfg;
    WebPPicture pic;
    WebPMemoryWriter wr;
    if (!WebPConfigInit(&cfg) || !WebPPictureInit(&pic)) exit(1);
    cfg.quality = o.quality;
    cfg.lossless = o.lossless;
    cfg.method = o.method;
    cfg.filter_type = o.filter_type;
    cfg.filter_strength = o.filter_strength;
    cfg.filter_sharpness = o.filter_sharpness;
    cfg.segments = o.segments;
    cfg.sns_strength = o.sns;
    cfg.partitions = o.partitions;
    cfg.alpha_compression = o.alpha_compression;
    cfg.alpha_filtering = o.alpha_filtering;
    cfg.alpha_quality = o.alpha_quality;
    cfg.near_lossless = o.near_lossless;
    cfg.exact = o.exact;
    if (!WebPValidateConfig(&cfg)) {
        fprintf(stderr, "bad config\n");
        exit(1);
    }
    pic.width = w;
    pic.height = h;
    pic.use_argb = o.lossless;
    if (o.alpha) {
        if (!WebPPictureImportRGBA(&pic, rgba, w * 4)) exit(1);
    } else {
        uint8_t* rgb = malloc((size_t)w * h * 3);
        for (size_t i = 0; i < (size_t)w * h; i++) memcpy(rgb + 3 * i, rgba + 4 * i, 3);
        if (!WebPPictureImportRGB(&pic, rgb, w * 3)) exit(1);
        free(rgb);
    }
    WebPMemoryWriterInit(&wr);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &wr;
    if (!WebPEncode(&cfg, &pic)) {
        fprintf(stderr, "encode failed: %d\n", pic.error_code);
        exit(1);
    }
    WebPPictureFree(&pic);
    WebPData out = {wr.mem, wr.size};
    return out;
}

static void put(const char* name, WebPData d) {
    write_file(name, d.bytes, d.size);
    WebPDataClear(&d);
}

static void le32(uint8_t* p, uint32_t v) {
    for (int i = 0; i < 4; i++) p[i] = (uint8_t)(v >> (8 * i));
}

/* The payload of the first chunk `fourcc` of a RIFF file, or NULL. */
static const uint8_t* find_chunk(WebPData d, const char* fourcc, uint32_t* size) {
    size_t pos = 12;
    while (pos + 8 <= d.size) {
        const uint32_t n = d.bytes[pos + 4] | (d.bytes[pos + 5] << 8) | (d.bytes[pos + 6] << 16) |
                           ((uint32_t)d.bytes[pos + 7] << 24);
        if (!memcmp(d.bytes + pos, fourcc, 4)) {
            *size = n;
            return d.bytes + pos + 8;
        }
        pos += 8 + n + (n & 1);
    }
    return NULL;
}

/* VP8X (alpha flag) + ALPH (raw, unfilter `filter`, payload `alpha`) + VP8
 * of a lossy file. */
static void raw_alpha(const char* name, WebPData vp8_file, int w, int h, int filter, const uint8_t* alpha) {
    uint32_t n;
    const uint8_t* vp8 = find_chunk(vp8_file, "VP8 ", &n);
    const size_t na = 1 + (size_t)w * h;
    const size_t total = 12 + 18 + 8 + na + (na & 1) + 8 + n + (n & 1);
    uint8_t* f = calloc(total, 1);
    memcpy(f, "RIFF", 4);
    le32(f + 4, (uint32_t)(total - 8));
    memcpy(f + 8, "WEBPVP8X", 8);
    le32(f + 16, 10);
    f[20] = 0x10;
    f[24] = (uint8_t)(w - 1), f[25] = (uint8_t)((w - 1) >> 8), f[27] = (uint8_t)(h - 1), f[28] = (uint8_t)((h - 1) >> 8);
    uint8_t* p = f + 30;
    memcpy(p, "ALPH", 4);
    le32(p + 4, (uint32_t)na);
    p[8] = (uint8_t)(filter << 2);
    memcpy(p + 9, alpha, na - 1);
    p += 8 + na + (na & 1);
    memcpy(p, "VP8 ", 4);
    le32(p + 4, n);
    memcpy(p + 8, vp8, n);
    write_file(name, f, total);
    free(f);
}

/* A TIFF-structured EXIF block holding Orientation = o (big-endian). */
static WebPData exif_block(int o) {
    static uint8_t t[26];
    const uint8_t b[26] = {'M', 'M', 0, 42, 0, 0, 0, 8, 0, 1, 1, 0x12, 0, 3, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0};
    memcpy(t, b, sizeof b);
    t[19] = (uint8_t)o;
    WebPData d = {t, sizeof t};
    return d;
}

static void with_chunks(const char* name, WebPData image, int orientation, int iccp, int xmp) {
    WebPMux* mux = WebPMuxCreate(&image, 1);
    static const uint8_t icc[64] = {0, 0, 0, 64, 'l', 'c', 'm', 's'};
    static const char xmp_text[] = "<x:xmpmeta xmlns:x='adobe:ns:meta/'></x:xmpmeta>";
    if (orientation) {
        WebPData e = exif_block(orientation);
        WebPMuxSetChunk(mux, "EXIF", &e, 1);
    }
    if (iccp) {
        WebPData c = {icc, sizeof icc};
        WebPMuxSetChunk(mux, "ICCP", &c, 1);
    }
    if (xmp) {
        WebPData x = {(const uint8_t*)xmp_text, sizeof xmp_text - 1};
        WebPMuxSetChunk(mux, "XMP ", &x, 1);
    }
    WebPData out;
    if (WebPMuxAssemble(mux, &out) != WEBP_MUX_OK) exit(1);
    put(name, out);
    WebPMuxDelete(mux);
}

/* An animation on a cw x ch canvas: frames of fw x fh at the given offsets. */
static void animation(const char* name, int cw, int ch, uint32_t bgcolor, int nframes, const WebPData* frames,
                      const int* xy, int dispose, int blend, int orientation) {
    WebPMux* mux = WebPMuxNew();
    for (int i = 0; i < nframes; i++) {
        WebPMuxFrameInfo fi;
        memset(&fi, 0, sizeof fi);
        fi.bitstream = frames[i];
        fi.x_offset = xy[2 * i];
        fi.y_offset = xy[2 * i + 1];
        fi.duration = 80;
        fi.id = WEBP_CHUNK_ANMF;
        fi.dispose_method = dispose ? WEBP_MUX_DISPOSE_BACKGROUND : WEBP_MUX_DISPOSE_NONE;
        fi.blend_method = blend ? WEBP_MUX_BLEND : WEBP_MUX_NO_BLEND;
        if (WebPMuxPushFrame(mux, &fi, 1) != WEBP_MUX_OK) exit(1);
    }
    WebPMuxAnimParams ap = {bgcolor, 3};
    WebPMuxSetAnimationParams(mux, &ap);
    WebPMuxSetCanvasSize(mux, cw, ch);
    if (orientation) {
        WebPData e = exif_block(orientation);
        WebPMuxSetChunk(mux, "EXIF", &e, 1);
    }
    WebPData out;
    if (WebPMuxAssemble(mux, &out) != WEBP_MUX_OK) {
        fprintf(stderr, "animation %s failed\n", name);
        exit(1);
    }
    put(name, out);
    WebPMuxDelete(mux);
}

int main(int argc, char** argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s OUT_DIR\n", argv[0]);
        return 2;
    }
    out_dir = argv[1];
    char name[128];
    const int W = 61, H = 45;
    uint8_t* img = pattern(W, H, 1u);

    /* the loop filters: simple and normal, strengths 0-100, sharpness */
    const int strengths[] = {0, 20, 40, 60, 80, 100};
    for (int t = 0; t < 2; t++)
        for (int s = 0; s < 6; s++)
            for (int sh = 0; sh <= 7; sh += 7) {
                Opts o = lossy(70);
                o.filter_type = t;
                o.filter_strength = strengths[s];
                o.filter_sharpness = sh;
                snprintf(name, sizeof name, "lossy_%s_filter_%d_sharp_%d.webp", t ? "normal" : "simple", strengths[s], sh);
                put(name, encode(img, W, H, o));
            }
    for (int sh = 1; sh <= 6; sh++) {
        Opts o = lossy(40);
        o.filter_strength = 100;
        o.filter_sharpness = sh;
        snprintf(name, sizeof name, "lossy_normal_filter_100_sharp_%d.webp", sh);
        put(name, encode(img, W, H, o));
    }
    /* segments, with and without spatial noise shaping */
    for (int seg = 1; seg <= 4; seg++)
        for (int sns = 0; sns <= 100; sns += 100) {
            Opts o = lossy(55);
            o.segments = seg;
            o.sns = sns;
            snprintf(name, sizeof name, "lossy_segments_%d_sns_%d.webp", seg, sns);
            put(name, encode(img, W, H, o));
        }
    /* token partitions: 1, 2, 4, 8 over 9 macroblock rows */
    {
        const int pw = 53, ph = 141;
        uint8_t* tall = pattern(pw, ph, 7u);
        for (int p = 0; p <= 3; p++) {
            Opts o = lossy(80);
            o.partitions = p;
            snprintf(name, sizeof name, "lossy_partitions_%d.webp", 1 << p);
            put(name, encode(tall, pw, ph, o));
        }
        free(tall);
    }
    /* qualities at the ends of the range, methods */
    const float qs[] = {0, 5, 100};
    for (int i = 0; i < 3; i++) {
        Opts o = lossy(qs[i]);
        snprintf(name, sizeof name, "lossy_q%d.webp", (int)qs[i]);
        put(name, encode(img, W, H, o));
    }
    for (int m = 0; m <= 6; m += 3) {
        Opts o = lossy(75);
        o.method = m;
        snprintf(name, sizeof name, "lossy_method_%d.webp", m);
        put(name, encode(img, W, H, o));
    }
    /* lossy with alpha: compression 0/1 x filtering 0-2, lossy alpha */
    for (int c = 0; c <= 1; c++)
        for (int f = 0; f <= 2; f++) {
            Opts o = lossy(75);
            o.alpha = 1;
            o.alpha_compression = c;
            o.alpha_filtering = f;
            snprintf(name, sizeof name, "alpha_compression_%d_filtering_%d.webp", c, f);
            put(name, encode(img, W, H, o));
        }
    for (int aq = 10; aq <= 60; aq += 50) {
        Opts o = lossy(75);
        o.alpha = 1;
        o.alpha_quality = aq;
        snprintf(name, sizeof name, "alpha_quality_%d.webp", aq);
        put(name, encode(img, W, H, o));
    }
    /* raw ALPH chunks under each unfilter (noise as the filtered values) */
    {
        WebPData base = encode(img, W, H, lossy(75));
        uint8_t* a = malloc((size_t)W * H);
        unsigned seed = 99u;
        for (int i = 0; i < W * H; i++) {
            seed = seed * 1103515245u + 12345u;
            a[i] = (uint8_t)((seed >> 16) % 7 == 0 ? seed >> 24 : i % 5);
        }
        for (int f = 0; f <= 3; f++) {
            snprintf(name, sizeof name, "alpha_raw_unfilter_%d.webp", f);
            raw_alpha(name, base, W, H, f, a);
        }
        free(a);
        WebPDataClear(&base);
    }
    /* lossless: methods and qualities, exact, near-lossless */
    for (int m = 0; m <= 6; m += 2)
        for (int q = 0; q <= 100; q += 50) {
            Opts o = lossy(q);
            o.lossless = 1;
            o.alpha = 1;
            o.method = m;
            snprintf(name, sizeof name, "lossless_method_%d_q%d.webp", m, q);
            put(name, encode(img, W, H, o));
        }
    {
        Opts o = lossy(75);
        o.lossless = 1;
        o.alpha = 1;
        o.exact = 1;
        put("lossless_exact.webp", encode(img, W, H, o));
        o.alpha = 0;
        o.exact = 0;
        put("lossless_opaque.webp", encode(img, W, H, o));
    }
    for (int nl = 0; nl <= 80; nl += 20) {
        Opts o = lossy(75);
        o.lossless = 1;
        o.near_lossless = nl;
        snprintf(name, sizeof name, "near_lossless_%d.webp", nl);
        put(name, encode(img, W, H, o));
    }
    /* palettes: 1, 2, 3, 4, 5, 16, 17 and 256 colours (bundling 8, 4, 2, 1 pixels a byte) */
    const int colours[] = {1, 2, 3, 4, 5, 16, 17, 256};
    for (int i = 0; i < 8; i++) {
        uint8_t* p = palette_pattern(W, H, colours[i], 5u + i);
        Opts o = lossy(75);
        o.lossless = 1;
        o.alpha = 1;
        snprintf(name, sizeof name, "lossless_palette_%d.webp", colours[i]);
        put(name, encode(p, W, H, o));
        free(p);
    }
    /* small and odd sizes */
    const int sizes[][2] = {{1, 1}, {2, 3}, {17, 1}, {1, 19}, {16, 16}, {33, 17}};
    for (int i = 0; i < 6; i++) {
        uint8_t* p = pattern(sizes[i][0], sizes[i][1], 3u + i);
        for (int ll = 0; ll <= 1; ll++) {
            Opts o = lossy(60);
            o.lossless = ll;
            o.alpha = ll;
            snprintf(name, sizeof name, "%s_%dx%d.webp", ll ? "lossless" : "lossy", sizes[i][0], sizes[i][1]);
            put(name, encode(p, sizes[i][0], sizes[i][1], o));
        }
        free(p);
    }
    /* VP8X with EXIF (orientations 1-8), ICCP and XMP */
    {
        Opts o = lossy(60);
        WebPData lossy_img = encode(img, W, H, o);
        for (int r = 1; r <= 8; r++) {
            snprintf(name, sizeof name, "exif_orientation_%d.webp", r);
            with_chunks(name, lossy_img, r, 0, 0);
        }
        with_chunks("exif_iccp_xmp_lossy.webp", lossy_img, 6, 1, 1);
        with_chunks("iccp_xmp_lossy.webp", lossy_img, 0, 1, 1);
        o.alpha = 1;
        WebPData alpha_img = encode(img, W, H, o);
        with_chunks("exif_iccp_xmp_alpha.webp", alpha_img, 8, 1, 1);
        o.lossless = 1;
        WebPData ll = encode(img, W, H, o);
        with_chunks("exif_iccp_xmp_lossless.webp", ll, 5, 1, 1);
        WebPDataClear(&lossy_img);
        WebPDataClear(&alpha_img);
        WebPDataClear(&ll);
    }
    /* animations: the first frame a sub-rectangle at an offset */
    {
        const int fw = 40, fh = 30, cw = 80, ch = 64;
        uint8_t* f1 = pattern(fw, fh, 11u);
        uint8_t* f2 = pattern(fw, fh, 12u);
        Opts ll = lossy(75), ly = lossy(70), la = lossy(70);
        ll.lossless = 1, ll.alpha = 1, la.alpha = 1;
        const int xy[] = {10, 6, 30, 20, 0, 0};
        WebPData fr_ll[3] = {encode(f1, fw, fh, ll), encode(f2, fw, fh, ll), encode(f1, fw, fh, ll)};
        WebPData fr_ly[2] = {encode(f1, fw, fh, ly), encode(f2, fw, fh, ly)};
        WebPData fr_la[2] = {encode(f1, fw, fh, la), encode(f2, fw, fh, la)};
        animation("anim_lossless_offset.webp", cw, ch, 0xff336699u, 3, fr_ll, xy, 0, 1, 0);
        animation("anim_lossless_offset_dispose_noblend.webp", cw, ch, 0x11223344u, 3, fr_ll, xy, 1, 0, 0);
        animation("anim_lossy_offset.webp", cw, ch, 0xffffffffu, 2, fr_ly, xy, 0, 1, 0);
        animation("anim_lossy_alpha_offset.webp", cw, ch, 0x80402010u, 2, fr_la, xy, 1, 1, 0);
        animation("anim_lossy_alpha_offset_exif_6.webp", cw, ch, 0u, 2, fr_la, xy, 0, 0, 6);
        const int full[] = {0, 0, 0, 0};
        animation("anim_lossy_full_first.webp", fw, fh, 0xff000000u, 2, fr_ly, full, 0, 1, 0);
        for (int i = 0; i < 3; i++) WebPDataClear(&fr_ll[i]);
        for (int i = 0; i < 2; i++) WebPDataClear(&fr_ly[i]), WebPDataClear(&fr_la[i]);
        free(f1);
        free(f2);
    }
    /* files cv2 refuses: cut short, RIFF size past the data, corrupt alpha */
    {
        WebPData a = encode(img, W, H, lossy(75));
        write_file("refused_cut_lossy.webp", a.bytes, a.size / 2);
        uint8_t* big = malloc(a.size);
        memcpy(big, a.bytes, a.size);
        le32(big + 4, (uint32_t)(a.size - 8 + 2));
        write_file("refused_riff_size_past_data.webp", big, a.size);
        free(big);
        WebPDataClear(&a);
        Opts o = lossy(75);
        o.lossless = 1;
        WebPData l = encode(img, W, H, o);
        write_file("refused_cut_lossless.webp", l.bytes, l.size * 2 / 3);
        WebPDataClear(&l);
        o = lossy(75);
        o.alpha = 1;
        WebPData al = encode(img, W, H, o);
        uint32_t n;
        uint8_t* copy = malloc(al.size);
        memcpy(copy, al.bytes, al.size);
        const uint8_t* alph = find_chunk(al, "ALPH", &n);
        if (!alph || (alph[0] & 3) != 1) {
            fprintf(stderr, "expected compressed alpha\n");
            return 1;
        }
        memset(copy + (alph - al.bytes) + 1, 0xff, n - 1);
        write_file("refused_corrupt_alpha.webp", copy, al.size);
        free(copy);
        WebPDataClear(&al);
    }
    free(img);
    return 0;
}
