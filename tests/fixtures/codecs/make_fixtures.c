/* Writes the JPEG fixtures of tests/test_torch_codecs_modes.py: the modes
 * that neither cv2 nor PIL writes (arithmetic coding, YCCK, 3x1 and 1x4
 * luma sampling, partial progressions) and coefficient-exact progressive and
 * arithmetic transcodes of the committed capture's frames.
 *
 * Build and run from the repository root, against libjpeg (libjpeg-turbo
 * built with arithmetic coding):
 *
 *   cc -O2 -o make_fixtures tests/fixtures/codecs/make_fixtures.c -ljpeg
 *   ./make_fixtures tests/fixtures/codecs && rm make_fixtures
 *   python tests/fixtures/codecs/make_digests.py
 *
 * The tests read the committed files and never build this program.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static const char* out_dir;

static FILE* open_out(const char* name) {
    char path[1024];
    snprintf(path, sizeof path, "%s/%s", out_dir, name);
    FILE* f = fopen(path, "wb");
    if (!f) {
        perror(path);
        exit(1);
    }
    return f;
}

/* A smooth gradient with deterministic noise and a few hard edges, so every
 * band of coefficients carries data. */
static unsigned char* pattern(int w, int h, int nc) {
    unsigned char* p = malloc((size_t)w * h * nc);
    unsigned int seed = 12345u;
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            for (int c = 0; c < nc; c++) {
                seed = seed * 1103515245u + 12345u;
                int v = (x * (3 + c) * 255) / (w + 1) / 2 + (y * (5 - c) * 255) / (h + 1) / 3;
                v += (int)((seed >> 16) % 41) - 20;
                if (((x / 9) + (y / 7) + c) % 5 == 0) v = 255 - v;
                p[((size_t)y * w + x) * nc + c] = (unsigned char)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    return p;
}

struct spec {
    const char* name;
    int w, h, nc;
    J_COLOR_SPACE in_cs, jpeg_cs;
    int samp[4][2];   /* h, v per component; {0, 0}: the defaults */
    int progressive;  /* 1: jpeg_simple_progression */
    int num_scans;    /* > 0: the progression cut to this many scans */
    int arith;
    int restart;      /* MCUs per restart interval */
    int quality;
    int dac;          /* non-default arithmetic conditioning */
};

static void write_spec(const struct spec* s) {
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr e;
    c.err = jpeg_std_error(&e);
    jpeg_create_compress(&c);
    FILE* f = open_out(s->name);
    jpeg_stdio_dest(&c, f);
    c.image_width = (JDIMENSION)s->w;
    c.image_height = (JDIMENSION)s->h;
    c.input_components = s->nc;
    c.in_color_space = s->in_cs;
    jpeg_set_defaults(&c);
    jpeg_set_colorspace(&c, s->jpeg_cs);
    jpeg_set_quality(&c, s->quality, TRUE);
    for (int i = 0; i < c.num_components; i++) {
        if (s->samp[i][0]) {
            c.comp_info[i].h_samp_factor = s->samp[i][0];
            c.comp_info[i].v_samp_factor = s->samp[i][1];
        }
    }
    c.arith_code = s->arith ? TRUE : FALSE;
    c.restart_interval = (unsigned int)s->restart;
    if (s->dac) {
        c.arith_dc_L[0] = 1;
        c.arith_dc_U[0] = 4;
        c.arith_ac_K[0] = 2;
        c.arith_dc_L[1] = 2;
        c.arith_dc_U[1] = 2;
        c.arith_ac_K[1] = 20;
    }
    if (s->progressive) {
        jpeg_simple_progression(&c);
        if (s->num_scans > 0) c.num_scans = s->num_scans;
    }
    unsigned char* img = pattern(s->w, s->h, s->nc);
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = img + (size_t)c.next_scanline * s->w * s->nc;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    fclose(f);
    free(img);
}

/* The coefficients of src rewritten losslessly with another entropy coder. */
static void transcode(const char* src, const char* name, int progressive, int arith) {
    struct jpeg_decompress_struct d;
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr de, ce;
    d.err = jpeg_std_error(&de);
    c.err = jpeg_std_error(&ce);
    jpeg_create_decompress(&d);
    jpeg_create_compress(&c);
    FILE* in = fopen(src, "rb");
    if (!in) {
        perror(src);
        exit(1);
    }
    jpeg_stdio_src(&d, in);
    jpeg_read_header(&d, TRUE);
    jvirt_barray_ptr* coefs = jpeg_read_coefficients(&d);
    jpeg_copy_critical_parameters(&d, &c);
    c.arith_code = arith ? TRUE : FALSE;
    if (progressive) jpeg_simple_progression(&c);
    FILE* f = open_out(name);
    jpeg_stdio_dest(&c, f);
    jpeg_write_coefficients(&c, coefs);
    jpeg_finish_compress(&c);
    jpeg_finish_decompress(&d);
    jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    fclose(f);
    fclose(in);
}

#define YCC JCS_RGB, JCS_YCbCr
#define S420 {{2, 2}, {1, 1}, {1, 1}}

static const struct spec kSpecs[] = {
    /* arithmetic coding */
    {"arith_seq_420.jpg", 85, 49, 3, YCC, S420, 0, 0, 1, 0, 90, 0},
    {"arith_seq_rst_dac.jpg", 85, 49, 3, YCC, S420, 0, 0, 1, 3, 75, 1},
    {"arith_prog_420.jpg", 85, 49, 3, YCC, S420, 1, 0, 1, 0, 90, 0},
    {"arith_prog_rst_dac.jpg", 85, 49, 3, YCC, S420, 1, 0, 1, 2, 75, 1},
    {"arith_gray.jpg", 61, 37, 1, JCS_GRAYSCALE, JCS_GRAYSCALE, {{0, 0}}, 0, 0, 1, 0, 85, 0},
    /* four components: YCCK (Adobe transform 2) and CMYK (transform 0) */
    {"ycck_420.jpg", 85, 49, 4, JCS_CMYK, JCS_YCCK, {{2, 2}, {1, 1}, {1, 1}, {2, 2}}, 0, 0, 0, 0, 90, 0},
    {"ycck_prog.jpg", 85, 49, 4, JCS_CMYK, JCS_YCCK, {{1, 1}, {1, 1}, {1, 1}, {1, 1}}, 1, 0, 0, 0, 85, 0},
    {"cmyk_444.jpg", 85, 49, 4, JCS_CMYK, JCS_CMYK, {{1, 1}, {1, 1}, {1, 1}, {1, 1}}, 0, 0, 0, 0, 90, 0},
    {"cmyk_arith.jpg", 85, 49, 4, JCS_CMYK, JCS_CMYK, {{1, 1}, {1, 1}, {1, 1}, {1, 1}}, 0, 0, 1, 0, 90, 0},
    /* sampling: integral replication and the fancy filters on chroma */
    {"samp_31.jpg", 97, 45, 3, YCC, {{3, 1}, {1, 1}, {1, 1}}, 0, 0, 0, 0, 90, 0},
    {"samp_31_prog.jpg", 97, 45, 3, YCC, {{3, 1}, {1, 1}, {1, 1}}, 1, 0, 0, 0, 90, 0},
    {"samp_14.jpg", 45, 97, 3, YCC, {{1, 4}, {1, 1}, {1, 1}}, 0, 0, 0, 5, 90, 0},
    {"samp_41_arith.jpg", 97, 45, 3, YCC, {{4, 1}, {1, 1}, {1, 1}}, 0, 0, 1, 0, 90, 0},
    {"samp_22_21_12.jpg", 85, 49, 3, YCC, {{2, 2}, {1, 2}, {2, 1}}, 0, 0, 0, 0, 90, 0},
    {"samp_42_prog.jpg", 97, 45, 3, YCC, {{4, 2}, {1, 1}, {1, 1}}, 1, 0, 0, 0, 90, 0},
    /* partial progressions: the simple script cut after n scans */
    {"partial_1.jpg", 85, 49, 3, YCC, S420, 1, 1, 0, 0, 90, 0},
    {"partial_2.jpg", 85, 49, 3, YCC, S420, 1, 2, 0, 0, 90, 0},
    {"partial_5.jpg", 85, 49, 3, YCC, S420, 1, 5, 0, 0, 90, 0},
    {"partial_6.jpg", 85, 49, 3, YCC, S420, 1, 6, 0, 0, 90, 0},
    {"partial_7.jpg", 85, 49, 3, YCC, S420, 1, 7, 0, 0, 90, 0},
    {"partial_9.jpg", 85, 49, 3, YCC, S420, 1, 9, 0, 0, 90, 0},
    {"partial_3_444.jpg", 85, 49, 3, YCC, {{1, 1}, {1, 1}, {1, 1}}, 1, 3, 0, 0, 75, 0},
    {"partial_2_rst.jpg", 85, 49, 3, YCC, S420, 1, 2, 0, 4, 90, 0},
    {"partial_1_arith.jpg", 85, 49, 3, YCC, S420, 1, 1, 1, 0, 90, 0},
    {"partial_6_arith.jpg", 85, 49, 3, YCC, S420, 1, 6, 1, 0, 90, 0},
    {"partial_1_gray.jpg", 61, 37, 1, JCS_GRAYSCALE, JCS_GRAYSCALE, {{0, 0}}, 1, 1, 0, 0, 90, 0},
    {"partial_3_gray.jpg", 61, 37, 1, JCS_GRAYSCALE, JCS_GRAYSCALE, {{0, 0}}, 1, 3, 0, 0, 90, 0},
};

int main(int argc, char** argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s OUT_DIR (run from the repository root)\n", argv[0]);
        return 2;
    }
    out_dir = argv[1];
    for (size_t i = 0; i < sizeof kSpecs / sizeof kSpecs[0]; i++) write_spec(&kSpecs[i]);
    static const char* kScans[] = {"gold_std", "maintenance"};
    static const char* kVariants[] = {"prog", "arith", "arith_prog"};
    for (int s = 0; s < 2; s++) {
        for (int k = 1; k <= 5; k++) {
            char src[512], name[256];
            snprintf(src, sizeof src, "tests/fixtures/torch_project/data/%s/rtabmap_extract/data_rgb/%d.jpg",
                     kScans[s], k);
            for (int v = 0; v < 3; v++) {
                snprintf(name, sizeof name, "capture_%s_%d_%s.jpg", kScans[s], k, kVariants[v]);
                transcode(src, name, v != 1, v != 0);
            }
        }
    }
    return 0;
}
