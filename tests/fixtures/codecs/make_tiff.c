/* Writes the TIFF fixtures of tests/fixtures/codecs/tiff that PIL cannot
 * write, through the system libtiff: JPEG-in-TIFF (YCbCr at each chroma
 * subsampling, RGB and gray; strips and tiles; JPEGTables), CCITT T.4 1-D
 * and 2-D (T4Options bits 0 and 2), T.6, Modified Huffman and its
 * word-aligned form (32771) with FillOrder 1 and 2, MinIsWhite and
 * MinIsBlack, in strips and tiles, and BigTIFF ("w8") forms of them.
 *
 *   cc -O2 -o make_tiff tests/fixtures/codecs/make_tiff.c -ltiff
 *   ./make_tiff tests/fixtures/codecs/tiff && rm make_tiff
 *
 * then python tests/fixtures/codecs/make_digests.py writes digests.json.
 * Every image is made from a fixed seed (a 32-bit xorshift). */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <tiffio.h>

static uint32_t state = 2463534242u;
static uint32_t next(void) {
    state ^= state << 13;
    state ^= state >> 17;
    state ^= state << 5;
    return state;
}

static const char *dir;

static TIFF *open_tiff(const char *name, int big) {
    char path[512];
    snprintf(path, sizeof path, "%s/%s", dir, name);
    TIFF *t = TIFFOpen(path, big ? "w8" : "w");
    if (!t) {
        fprintf(stderr, "cannot open %s\n", path);
        exit(1);
    }
    return t;
}

/* a smooth colour image with noise: what the JPEG fixtures compress */
static uint8_t *colour_image(int w, int h, int nc) {
    uint8_t *p = malloc((size_t)w * h * nc);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            for (int c = 0; c < nc; c++)
                p[((size_t)y * w + x) * nc + c] = (uint8_t)((x * (3 + c) + y * (5 - c) + (c * 60)) + (next() % 24));
    return p;
}

/* bilevel rows (1 bits black, MSB first): rectangles, a diagonal band and
 * noise, with some rows all white and some all black */
static uint8_t *bilevel_image(int w, int h) {
    int rb = (w + 7) / 8;
    uint8_t *p = calloc((size_t)rb * h, 1);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            int black = 0;
            if (y % 17 == 5) black = 1;
            else if (y % 13 == 3) black = 0;
            else if ((x / 9 + y / 7) % 3 == 0) black = 1;
            if (abs(x - 2 * y) < 4) black = !black;
            if (next() % 29 == 0) black = !black;
            if (black) p[(size_t)y * rb + x / 8] |= (uint8_t)(0x80 >> (x % 8));
        }
    }
    return p;
}

static void jpeg(const char *name, int big, int w, int h, int photometric, int hs, int vs, int tile, int rps,
                 int quality) {
    TIFF *t = open_tiff(name, big);
    int nc = photometric == PHOTOMETRIC_MINISBLACK ? 1 : 3;
    uint8_t *img = colour_image(w, h, nc);
    TIFFSetField(t, TIFFTAG_IMAGEWIDTH, w);
    TIFFSetField(t, TIFFTAG_IMAGELENGTH, h);
    TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, 8);
    TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, nc);
    TIFFSetField(t, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
    TIFFSetField(t, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC, photometric);
    if (photometric == PHOTOMETRIC_YCBCR) {
        TIFFSetField(t, TIFFTAG_YCBCRSUBSAMPLING, hs, vs);
        TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    }
    TIFFSetField(t, TIFFTAG_JPEGQUALITY, quality);
    if (tile) {
        TIFFSetField(t, TIFFTAG_TILEWIDTH, tile);
        TIFFSetField(t, TIFFTAG_TILELENGTH, tile);
        uint8_t *buf = malloc((size_t)tile * tile * nc);
        for (int ty = 0; ty < h; ty += tile)
            for (int tx = 0; tx < w; tx += tile) {
                memset(buf, 0, (size_t)tile * tile * nc);
                for (int y = 0; y < tile && ty + y < h; y++)
                    for (int x = 0; x < tile && tx + x < w; x++)
                        memcpy(buf + ((size_t)y * tile + x) * nc, img + ((size_t)(ty + y) * w + tx + x) * nc, nc);
                TIFFWriteTile(t, buf, tx, ty, 0, 0);
            }
        free(buf);
    } else {
        TIFFSetField(t, TIFFTAG_ROWSPERSTRIP, rps);
        for (int y = 0; y < h; y++) TIFFWriteScanline(t, img + (size_t)y * w * nc, y, 0);
    }
    TIFFClose(t);
    free(img);
}

static void fax(const char *name, int big, int w, int h, int compression, int options, int fillorder,
                int photometric, int rps, int tile) {
    TIFF *t = open_tiff(name, big);
    uint8_t *img = bilevel_image(w, h);
    int rb = (w + 7) / 8;
    TIFFSetField(t, TIFFTAG_IMAGEWIDTH, w);
    TIFFSetField(t, TIFFTAG_IMAGELENGTH, h);
    TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, 1);
    TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, 1);
    TIFFSetField(t, TIFFTAG_COMPRESSION, compression);
    TIFFSetField(t, TIFFTAG_PHOTOMETRIC, photometric);
    TIFFSetField(t, TIFFTAG_FILLORDER, fillorder);
    if (compression == COMPRESSION_CCITTFAX3) TIFFSetField(t, TIFFTAG_GROUP3OPTIONS, options);
    if (tile) {
        TIFFSetField(t, TIFFTAG_TILEWIDTH, tile);
        TIFFSetField(t, TIFFTAG_TILELENGTH, tile);
        int tb = tile / 8;
        uint8_t *buf = malloc((size_t)tb * tile);
        for (int ty = 0; ty < h; ty += tile)
            for (int tx = 0; tx < w; tx += tile) {
                memset(buf, 0, (size_t)tb * tile);
                for (int y = 0; y < tile && ty + y < h; y++)
                    for (int x = 0; x < tile && tx + x < w; x++)
                        if (img[(size_t)(ty + y) * rb + (tx + x) / 8] & (0x80 >> ((tx + x) % 8)))
                            buf[(size_t)y * tb + x / 8] |= (uint8_t)(0x80 >> (x % 8));
                TIFFWriteTile(t, buf, tx, ty, 0, 0);
            }
        free(buf);
    } else {
        TIFFSetField(t, TIFFTAG_ROWSPERSTRIP, rps);
        for (int y = 0; y < h; y++) TIFFWriteScanline(t, img + (size_t)y * rb, y, 0);
    }
    TIFFClose(t);
    free(img);
}

int main(int argc, char **argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: %s <directory>\n", argv[0]);
        return 2;
    }
    dir = argv[1];
    /* JPEG: YCbCr at each subsampling libjpeg writes (4x4 is past its 10 blocks
     * an MCU), strips and tiles */
    jpeg("jpeg_ycbcr_22_strips.tif", 0, 61, 45, PHOTOMETRIC_YCBCR, 2, 2, 0, 16, 90);
    jpeg("jpeg_ycbcr_22_tiles.tif", 0, 61, 45, PHOTOMETRIC_YCBCR, 2, 2, 16, 0, 75);
    jpeg("jpeg_ycbcr_21_strips.tif", 0, 37, 29, PHOTOMETRIC_YCBCR, 2, 1, 0, 8, 90);
    jpeg("jpeg_ycbcr_11_tiles.tif", 0, 50, 35, PHOTOMETRIC_YCBCR, 1, 1, 32, 0, 95);
    jpeg("jpeg_ycbcr_12_strips.tif", 0, 33, 40, PHOTOMETRIC_YCBCR, 1, 2, 0, 16, 85);
    jpeg("jpeg_ycbcr_41_strips.tif", 0, 45, 23, PHOTOMETRIC_YCBCR, 4, 1, 0, 8, 90);
    jpeg("jpeg_ycbcr_42_tiles.tif", 0, 70, 41, PHOTOMETRIC_YCBCR, 4, 2, 32, 0, 90);
    jpeg("jpeg_rgb_strips.tif", 0, 41, 30, PHOTOMETRIC_RGB, 1, 1, 0, 8, 90);
    jpeg("jpeg_rgb_tiles.tif", 0, 41, 30, PHOTOMETRIC_RGB, 1, 1, 16, 0, 90);
    jpeg("jpeg_gray_strips.tif", 0, 43, 31, PHOTOMETRIC_MINISBLACK, 1, 1, 0, 16, 90);
    jpeg("jpeg_gray_tiles.tif", 0, 43, 31, PHOTOMETRIC_MINISBLACK, 1, 1, 16, 0, 60);
    jpeg("bigtiff_jpeg_ycbcr_22_tiles.tif", 1, 61, 45, PHOTOMETRIC_YCBCR, 2, 2, 16, 0, 90);
    /* CCITT: T.4 1-D and 2-D, fill bits, T.6, Modified Huffman, RLEW */
    fax("g3_1d.tif", 0, 83, 50, COMPRESSION_CCITTFAX3, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 50, 0);
    fax("g3_1d_fillbits_lsb.tif", 0, 83, 50, COMPRESSION_CCITTFAX3, GROUP3OPT_FILLBITS, FILLORDER_LSB2MSB,
        PHOTOMETRIC_MINISWHITE, 16, 0);
    fax("g3_2d.tif", 0, 83, 50, COMPRESSION_CCITTFAX3, GROUP3OPT_2DENCODING, FILLORDER_MSB2LSB,
        PHOTOMETRIC_MINISWHITE, 20, 0);
    fax("g3_2d_fillbits_min_is_black.tif", 0, 83, 50, COMPRESSION_CCITTFAX3,
        GROUP3OPT_2DENCODING | GROUP3OPT_FILLBITS, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISBLACK, 50, 0);
    fax("g3_2d_lsb.tif", 0, 83, 50, COMPRESSION_CCITTFAX3, GROUP3OPT_2DENCODING, FILLORDER_LSB2MSB,
        PHOTOMETRIC_MINISWHITE, 13, 0);
    fax("g3_2d_wide.tif", 0, 3001, 9, COMPRESSION_CCITTFAX3, GROUP3OPT_2DENCODING, FILLORDER_MSB2LSB,
        PHOTOMETRIC_MINISWHITE, 9, 0);
    fax("g4.tif", 0, 83, 50, COMPRESSION_CCITTFAX4, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 50, 0);
    fax("g4_lsb_strips.tif", 0, 83, 50, COMPRESSION_CCITTFAX4, 0, FILLORDER_LSB2MSB, PHOTOMETRIC_MINISWHITE, 11, 0);
    fax("g4_tiles.tif", 0, 83, 50, COMPRESSION_CCITTFAX4, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISBLACK, 0, 32);
    fax("g4_wide.tif", 0, 3001, 9, COMPRESSION_CCITTFAX4, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 9, 0);
    fax("mh.tif", 0, 83, 50, COMPRESSION_CCITTRLE, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 50, 0);
    fax("mh_lsb_min_is_black.tif", 0, 83, 50, COMPRESSION_CCITTRLE, 0, FILLORDER_LSB2MSB, PHOTOMETRIC_MINISBLACK,
        17, 0);
    fax("rlew.tif", 0, 83, 50, COMPRESSION_CCITTRLEW, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 50, 0);
    fax("bigtiff_g4.tif", 1, 83, 50, COMPRESSION_CCITTFAX4, 0, FILLORDER_MSB2LSB, PHOTOMETRIC_MINISWHITE, 25, 0);
    fax("bigtiff_g3_2d.tif", 1, 83, 50, COMPRESSION_CCITTFAX3, GROUP3OPT_2DENCODING, FILLORDER_MSB2LSB,
        PHOTOMETRIC_MINISWHITE, 25, 0);
    return 0;
}
