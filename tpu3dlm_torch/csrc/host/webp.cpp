// WebP's two bitstreams, decoded as libwebp decodes them for cv2 5.0
// (WebPDecodeBGRInto / WebPDecodeBGRAInto, default options):
//
// - VP8L, the lossless format, from the WebP lossless specification: the
//   predictor (14 modes), cross-colour, subtract-green and colour-indexing
//   transforms (pixel bundling at 2, 4 and 16 colours), the colour cache,
//   meta prefix codes, simple and normal code-length codes, LZ77 with the
//   120-entry distance map. ARGB out as BGR(A).
// - VP8, the lossy format (RFC 6386), key frames: the boolean decoder, 1-8
//   token partitions, segments, coefficient-probability updates, 16x16, 4x4
//   and chroma intra prediction, dequantisation, the inverse WHT and DCT
//   (libwebp's TransformOne constants), the simple and normal loop filters
//   with sharpness and the mode/ref deltas, the crop to the frame size; then
//   YUV 4:2:0 -> BGR by libwebp's fancy upsampler and its 14-bit
//   fixed-point colour conversion, without dithering.
// - ALPH: raw or VP8L-coded alpha (green channel), unfiltered (none,
//   horizontal, vertical, gradient).
//
// The RIFF container, EXIF and animation frames are parsed in Python
// (tpu3dlm_torch/data/webp.py). Tables: the quantiser and probability
// tables of RFC 6386, in libwebp's order of the 4x4 modes. Errors return -1
// with a message.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

struct Fail : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& why) { throw Fail(why); }

// ===========================================================================
// VP8L, the lossless bitstream (WebP lossless specification)
// ===========================================================================

// Bits LSB first. Reading past the data is an error, as libwebp's end of
// stream is: more bits consumed than the data holds, or than the 64 its
// first load takes when the data is shorter than 8 bytes.
struct LBits {
    const uint8_t* d;
    size_t n;
    uint64_t pos = 0;
    uint64_t limit;
    LBits(const uint8_t* d_, size_t n_, uint64_t start = 0)
        : d(d_), n(n_), pos(start), limit(n_ < 8 ? 64 : 8ull * n_) {}
    uint32_t peek() const {  // the next 32 bits, zeros past the data
        const size_t byte = static_cast<size_t>(pos >> 3);
        uint64_t v = 0;
        if (byte + 8 <= n) {
            std::memcpy(&v, d + byte, 8);
        } else {
            for (size_t i = 0; i < 8 && byte + i < n; i++) v |= static_cast<uint64_t>(d[byte + i]) << (8 * i);
        }
        return static_cast<uint32_t>(v >> (pos & 7));
    }
    void skip(int k) {
        pos += k;
        if (pos > limit) fail("VP8L data ends early");
    }
    uint32_t read(int k) {
        const uint32_t v = k ? (peek() & ((1u << k) - 1)) : 0;
        skip(k);
        return v;
    }
};

// A canonical prefix code as libwebp's BuildHuffmanTable accepts it: code
// lengths up to 15, no length over-full, not all zero, and complete unless
// it has a single symbol (which then takes no bits).
struct Huff {
    static constexpr int kLookup = 10;
    int single = -1;
    uint16_t count[16] = {0};
    std::vector<uint16_t> sorted;
    std::vector<uint32_t> table;  // (length << 16) | symbol for codes up to kLookup bits, else 0

    bool build(const int* lengths, int n) {
        int nsym = 0;
        for (int s = 0; s < n; s++) {
            if (lengths[s] > 15) return false;
            count[lengths[s]]++;
        }
        if (count[0] == n) return false;
        for (int len = 1; len < 15; len++)
            if (count[len] > (1 << len)) return false;
        for (int len = 1; len <= 15; len++) nsym += count[len];
        sorted.clear();
        for (int len = 1; len <= 15; len++)
            for (int s = 0; s < n; s++)
                if (lengths[s] == len) sorted.push_back(static_cast<uint16_t>(s));
        if (nsym == 1) {
            single = sorted[0];
            return true;
        }
        int num_nodes = 1, num_open = 1;
        for (int len = 1; len <= 15; len++) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= count[len];
            if (num_open < 0) return false;
        }
        if (num_nodes != 2 * nsym - 1) return false;
        table.assign(1u << kLookup, 0);
        uint32_t code = 0;
        int idx = 0;
        for (int len = 1; len <= 15; len++) {
            for (int k = 0; k < count[len]; k++, idx++, code++) {
                if (len > kLookup) continue;
                uint32_t rev = 0;
                for (int b = 0; b < len; b++) rev |= ((code >> b) & 1u) << (len - 1 - b);
                for (uint32_t r = rev; r < (1u << kLookup); r += 1u << len)
                    table[r] = (static_cast<uint32_t>(len) << 16) | sorted[idx];
            }
            code <<= 1;
        }
        return true;
    }

    int read(LBits& br) const {
        if (single >= 0) return single;
        const uint32_t bits = br.peek();
        const uint32_t e = table[bits & ((1u << kLookup) - 1)];
        if (e) {
            br.skip(static_cast<int>(e >> 16));
            return static_cast<int>(e & 0xffff);
        }
        int code = 0, first = 0, index = 0;
        for (int len = 1; len <= 15; len++) {
            code |= (bits >> (len - 1)) & 1;
            const int c = count[len];
            if (code - c < first) {
                br.skip(len);
                return sorted[index + (code - first)];
            }
            index += c;
            first += c;
            first <<= 1;
            code <<= 1;
        }
        fail("VP8L prefix code out of range");
    }
};

const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
};

struct VP8L {
    LBits br;
    std::vector<Transform> transforms;
    unsigned seen = 0;
    VP8L(const uint8_t* d, size_t n, uint64_t start = 0) : br(d, n, start) {}

    Huff read_code(int alphabet) {
        std::vector<int> lengths(std::max(alphabet, 256), 0);
        if (br.read(1)) {  // simple: one or two symbols of length 1
            const int num = br.read(1) + 1;
            const int first_len = br.read(1);
            lengths[br.read(first_len == 0 ? 1 : 8)] = 1;
            if (num == 2) lengths[br.read(8)] = 1;
        } else {
            int cl_lengths[19] = {0};
            const int num_codes = br.read(4) + 4;
            for (int i = 0; i < num_codes; i++) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
            Huff cl;
            if (!cl.build(cl_lengths, 19)) fail("invalid VP8L code-length code");
            int max_symbol = alphabet;
            if (br.read(1)) {
                const int length_nbits = 2 + 2 * br.read(3);
                max_symbol = 2 + br.read(length_nbits);
                if (max_symbol > alphabet) fail("VP8L code lengths past the alphabet");
            }
            int prev = 8, symbol = 0;
            while (symbol < alphabet) {
                if (max_symbol-- == 0) break;
                const int c = cl.read(br);
                if (c < 16) {
                    lengths[symbol++] = c;
                    if (c) prev = c;
                } else {
                    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
                    int repeat = br.read(kExtra[c - 16]) + kOffset[c - 16];
                    if (symbol + repeat > alphabet) fail("VP8L code lengths past the alphabet");
                    const int v = c == 16 ? prev : 0;
                    while (repeat-- > 0) lengths[symbol++] = v;
                }
            }
        }
        Huff h;
        if (!h.build(lengths.data(), alphabet)) fail("invalid VP8L prefix code");
        return h;
    }

    static int sub(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

    static int copy_distance(int symbol, LBits& br) {
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra;
        return offset + static_cast<int>(br.read(extra)) + 1;
    }

    // An entropy-coded image of xsize x ysize; the level-0 image may have
    // meta prefix codes.
    std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
        int cache_bits = 0;
        if (br.read(1)) {
            cache_bits = br.read(4);
            if (cache_bits < 1 || cache_bits > 11) fail("invalid VP8L colour cache size");
        }
        int meta_bits = 0, meta_xsize = 0;
        std::vector<uint32_t> meta;
        int groups = 1;
        if (level0 && br.read(1)) {
            meta_bits = br.read(3) + 2;
            meta_xsize = sub(xsize, meta_bits);
            meta = image(meta_xsize, sub(ysize, meta_bits), false);
            for (auto& m : meta) {
                m = (m >> 8) & 0xffff;
                groups = std::max<int>(groups, static_cast<int>(m) + 1);
            }
        }
        const int cache_size = cache_bits ? (1 << cache_bits) : 0;
        const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
        // Every group's codes are read and checked; only the groups the meta
        // image uses are kept (libwebp's mapping), so a stream naming 65536
        // groups does not hold 65536 tables.
        std::vector<int> slot(groups, meta.empty() ? 0 : -1);
        for (const uint32_t m : meta) slot[m] = 0;
        int kept = 0;
        for (int& k : slot) k = k < 0 ? -1 : kept++;
        for (auto& m : meta) m = static_cast<uint32_t>(slot[m]);
        std::vector<Huff> codes;
        codes.reserve(static_cast<size_t>(kept) * 5);
        for (int g = 0; g < groups; g++)
            for (int j = 0; j < 5; j++) {
                Huff h = read_code(alphabets[j]);
                if (slot[g] >= 0) codes.push_back(std::move(h));
            }

        const size_t total = static_cast<size_t>(xsize) * ysize;
        std::vector<uint32_t> out(total);
        std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
        const int cache_shift = 32 - cache_bits;
        size_t p = 0, cached = 0;
        int x = 0, y = 0;
        auto insert_upto = [&](size_t end) {
            if (!cache_size) return;
            for (; cached < end; cached++) cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
        };
        while (p < total) {
            const Huff* h = codes.data();
            if (!meta.empty()) h += 5 * meta[static_cast<size_t>(y >> meta_bits) * meta_xsize + (x >> meta_bits)];
            const int green = h[0].read(br);
            if (green < 256) {
                const uint32_t red = h[1].read(br), blue = h[2].read(br), alpha = h[3].read(br);
                out[p++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(green) << 8) | blue;
                if (++x >= xsize) x = 0, y++;
            } else if (green < 256 + 24) {
                const size_t length = copy_distance(green - 256, br);
                const int dist_symbol = h[4].read(br);
                const int dist_code = copy_distance(dist_symbol, br);
                size_t dist;
                if (dist_code > 120) {
                    dist = static_cast<size_t>(dist_code - 120);
                } else {
                    const int c = kCodeToPlane[dist_code - 1];
                    const long d = static_cast<long>(c >> 4) * xsize + (8 - (c & 0xf));
                    dist = d >= 1 ? static_cast<size_t>(d) : 1;
                }
                if (p < dist || total - p < length) fail("VP8L backward reference out of the image");
                for (size_t k = 0; k < length; k++, p++) out[p] = out[p - dist];
                x += static_cast<int>(length % xsize);
                y += static_cast<int>(length / xsize);
                if (x >= xsize) x -= xsize, y++;
            } else {
                const int key = green - 280;
                if (key >= cache_size) fail("VP8L colour cache index out of range");
                insert_upto(p);
                out[p++] = cache[key];
                if (++x >= xsize) x = 0, y++;
            }
            insert_upto(p);
        }
        return out;
    }

    void read_transform(int& xsize, int ysize) {
        const int type = br.read(2);
        if (seen & (1u << type)) fail("VP8L transform repeated");
        seen |= 1u << type;
        Transform t{type, 0, xsize, ysize, {}};
        if (type == 0 || type == 1) {  // predictor, cross-colour
            t.bits = br.read(3) + 2;
            t.data = image(sub(xsize, t.bits), sub(ysize, t.bits), false);
        } else if (type == 3) {  // colour indexing
            const int num_colors = br.read(8) + 1;
            t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
            xsize = sub(xsize, t.bits);
            std::vector<uint32_t> pal = image(num_colors, 1, false);
            std::vector<uint32_t> map(static_cast<size_t>(1) << (8 >> t.bits), 0);
            uint8_t* m = reinterpret_cast<uint8_t*>(map.data());
            const uint8_t* d = reinterpret_cast<const uint8_t*>(pal.data());
            std::memcpy(m, d, 4);
            for (int i = 4; i < 4 * num_colors; i++) m[i] = static_cast<uint8_t>(d[i] + m[i - 4]);
            t.data = std::move(map);
        }
        transforms.push_back(std::move(t));
    }

    static uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
    static uint32_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint32_t>(v); }
    static uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
        int d = 0;
        for (int s = 0; s < 32; s += 8) {
            const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
            d += std::abs(b - c) - std::abs(a - c);
        }
        return d <= 0 ? t : l;
    }
    static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
        uint32_t r = 0;
        for (int s = 0; s < 32; s += 8)
            r |= clip255(static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                         static_cast<int>((c >> s) & 0xff)) << s;
        return r;
    }
    static uint32_t add_sub_half(uint32_t a, uint32_t b) {
        uint32_t r = 0;
        for (int s = 0; s < 32; s += 8) {
            const int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
            r |= clip255(x + (x - y) / 2) << s;
        }
        return r;
    }
    static uint32_t add_pixels(uint32_t a, uint32_t b) {
        return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
               (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
    }

    // Inverse transform t on data (t.xsize x t.ysize out; in is the coded width).
    static std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t> in) {
        const int w = t.xsize, h = t.ysize;
        if (t.type == 2) {  // subtract green
            for (auto& v : in) {
                const uint32_t g = (v >> 8) & 0xff;
                const uint32_t rb = ((v & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
                v = (v & 0xff00ff00u) | rb;
            }
            return in;
        }
        if (t.type == 1) {  // cross colour
            const int bw = sub(w, t.bits);
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    const uint32_t c = t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)];
                    const int8_t g2r = static_cast<int8_t>(c & 0xff), g2b = static_cast<int8_t>((c >> 8) & 0xff),
                                 r2b = static_cast<int8_t>((c >> 16) & 0xff);
                    uint32_t& v = in[static_cast<size_t>(y) * w + x];
                    const int8_t green = static_cast<int8_t>(v >> 8);
                    int r = (v >> 16) & 0xff, b = v & 0xff;
                    r += (g2r * green) >> 5;
                    r &= 0xff;
                    b += (g2b * green) >> 5;
                    b += (r2b * static_cast<int8_t>(r)) >> 5;
                    b &= 0xff;
                    v = (v & 0xff00ff00u) | (static_cast<uint32_t>(r) << 16) | static_cast<uint32_t>(b);
                }
            return in;
        }
        if (t.type == 0) {  // predictor
            const int bw = sub(w, t.bits);
            uint32_t* d = in.data();
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) {
                    const size_t i = static_cast<size_t>(y) * w + x;
                    uint32_t pred;
                    if (y == 0) {
                        pred = x == 0 ? 0xff000000u : d[i - 1];
                    } else if (x == 0) {
                        pred = d[i - w];
                    } else {
                        const int mode = (t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 0xf;
                        const uint32_t L = d[i - 1], T = d[i - w], TL = d[i - w - 1], TR = d[i - w + 1];
                        switch (mode) {
                            case 1: pred = L; break;
                            case 2: pred = T; break;
                            case 3: pred = TR; break;
                            case 4: pred = TL; break;
                            case 5: pred = avg2(avg2(L, TR), T); break;
                            case 6: pred = avg2(L, TL); break;
                            case 7: pred = avg2(L, T); break;
                            case 8: pred = avg2(TL, T); break;
                            case 9: pred = avg2(T, TR); break;
                            case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
                            case 11: pred = select(T, L, TL); break;
                            case 12: pred = add_sub_full(L, T, TL); break;
                            case 13: pred = add_sub_half(avg2(L, T), TL); break;
                            default: pred = 0xff000000u; break;  // 0, and 14/15 as libwebp pads them
                        }
                    }
                    d[i] = add_pixels(d[i], pred);
                }
            return in;
        }
        // colour indexing: in is the packed width
        const int pw = sub(w, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(w) * h);
        const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                const uint32_t packed = (in[static_cast<size_t>(y) * pw + (x >> t.bits)] >> 8) & 0xff;
                const int idx = (packed >> ((x & (per - 1)) * bpp)) & mask;
                out[static_cast<size_t>(y) * w + x] = t.data[idx];
            }
        return out;
    }

    // The level-0 image: transforms, then the entropy-coded image, then the
    // transforms undone in reverse order.
    std::vector<uint32_t> decode(int width, int height) {
        int xsize = width;
        while (br.read(1)) read_transform(xsize, height);
        std::vector<uint32_t> data = image(xsize, height, true);
        for (size_t k = transforms.size(); k-- > 0;) data = inverse(transforms[k], std::move(data));
        return data;
    }
};

// ===========================================================================
// VP8, the lossy bitstream (RFC 6386 as libwebp decodes a key frame)
// ===========================================================================

// The boolean decoder, state for state as a 64-bit build of libwebp keeps
// it (seven bytes loaded at a time into a 64-bit value, the window read as
// 32 bits), so that data an encoder never writes (a first byte of 0xff, a
// corrupt partition) decodes as in cv2. End of data: libwebp sets eof when
// it needs a byte the partition does not hold; every such case fails.
struct BoolDec {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    const uint8_t* buf_max = nullptr;
    uint64_t value = 0;
    int bits = -8;
    uint32_t range = 254;  // range - 1
    bool eof = false;
    void init(const uint8_t* start, size_t size) {
        buf = start;
        end = start + size;
        buf_max = size >= 8 ? start + size - 8 + 1 : start;
        value = 0;
        bits = -8;
        range = 254;
        eof = false;
        load();
    }
    void load() {
        if (buf < buf_max) {
            uint64_t in = 0;
            for (int i = 0; i < 7; i++) in = (in << 8) | buf[i];
            buf += 7;
            value = in | (value << 56);
            bits += 56;
        } else if (buf < end) {
            bits += 8;
            value = *buf++ | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
        const uint32_t v = static_cast<uint32_t>(value >> pos);
        int bit;
        if (v > split) {
            r -= split;
            value -= static_cast<uint64_t>(split + 1) << pos;
            bit = 1;
        } else {
            r = split + 1;
            bit = 0;
        }
        int shift = 0;
        while ((r << shift) < 128) shift++;
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    // VP8GetSigned: the sign of a coefficient, a bit at probability 1/2
    // with libwebp's one-bit shortcut.
    int sign(int v) {
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = range >> 1;
        const uint32_t val = static_cast<uint32_t>(value >> pos);
        const int32_t mask = static_cast<int32_t>(split - val) >> 31;
        bits -= 1;
        range += static_cast<uint32_t>(mask);
        range |= 1;
        value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
        return (v ^ mask) - mask;
    }
    int literal(int n) {
        int v = 0;
        while (n-- > 0) v |= get(0x80) << n;
        return v;
    }
    int signed_literal(int n) {
        const int v = literal(n);
        return get(0x80) ? -v : v;
    }
};

enum {
    B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED,
    B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED
};
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED };

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // stride of the work buffer, as libwebp's

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// libwebp's TransformOne: the inverse DCT of one 4x4 block added to dst.
void transform_one(const int16_t* in, uint8_t* dst) {
    auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
    auto mul2 = [](int a) { return (a * 35468) >> 16; };
    int C[16];
    int* tmp = C;
    for (int i = 0; i < 4; i++, in++, tmp += 4) {
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; i++, tmp++, dst += BPS) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

// The same transform in 16-bit lanes, as libwebp's Transform_SSE2 computes
// it on x86 (the constants 35468 and 85627 as -30068 and 20091 plus the
// input): identical to transform_one for coefficients in the range an
// encoder writes, wrapping where corrupt data overflows 16 bits.
void transform_sse2(const int16_t* in, uint8_t* dst) {
    auto w = [](int v) { return static_cast<int16_t>(v); };
    auto mulhi = [](int16_t a, int k) { return static_cast<int16_t>((static_cast<int32_t>(a) * k) >> 16); };
    auto butterfly = [&](int16_t i0, int16_t i1, int16_t i2, int16_t i3, int16_t out[4]) {
        const int16_t a = w(i0 + i2), b = w(i0 - i2);
        const int16_t c = w(w(i1 - i3) + w(mulhi(i1, -30068) - mulhi(i3, 20091)));
        const int16_t d = w(w(i1 + i3) + w(mulhi(i1, 20091) + mulhi(i3, -30068)));
        out[0] = w(a + d), out[1] = w(b + c), out[2] = w(b - c), out[3] = w(a - d);
    };
    int16_t col[4][4];  // col[i][k]: vertical output k of column i
    for (int i = 0; i < 4; i++) butterfly(in[i], in[4 + i], in[8 + i], in[12 + i], col[i]);
    for (int r = 0; r < 4; r++, dst += BPS) {
        int16_t out[4];
        butterfly(w(col[0][r] + 4), col[1][r], col[2][r], col[3][r], out);
        for (int x = 0; x < 4; x++) dst[x] = clip8(w(dst[x] + (out[x] >> 3)));
    }
}

// libwebp's DoTransform: by the block's code (3 any coefficient past the
// third, 2 only the first three, 1 only DC, 0 none), SSE2 for the full
// transform, C (TransformAC3_C, TransformDC_C) for the others.
void do_transform(int code, const int16_t* in, uint8_t* dst) {
    if (code == 3) {
        transform_sse2(in, dst);
    } else if (code) {
        transform_one(in, dst);
    }
}

// libwebp's TransformWHT: the Y2 block's inverse Walsh-Hadamard transform,
// into the DC of each of the 16 luma blocks.
void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; i++) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; i++, out += 64) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void pred4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    switch (mode) {
        case B_DC_PRED: {
            int dc = 4;
            for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * BPS];
            dc >>= 3;
            for (int j = 0; j < 4; j++) std::memset(dst + j * BPS, dc, 4);
            break;
        }
        case B_TM_PRED: {
            const int tl = top[-1];
            for (int j = 0; j < 4; j++)
                for (int i = 0; i < 4; i++) DST(i, j) = clip8(top[i] + dst[-1 + j * BPS] - tl);
            break;
        }
        case B_VE_PRED: {
            const uint8_t v[4] = {static_cast<uint8_t>(avg3(top[-1], top[0], top[1])),
                                  static_cast<uint8_t>(avg3(top[0], top[1], top[2])),
                                  static_cast<uint8_t>(avg3(top[1], top[2], top[3])),
                                  static_cast<uint8_t>(avg3(top[2], top[3], top[4]))};
            for (int j = 0; j < 4; j++) std::memcpy(dst + j * BPS, v, 4);
            break;
        }
        case B_HE_PRED: {
            const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
            std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
            std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
            std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
            std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
            break;
        }
        case B_RD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
            const int A = top[0], B = top[1], C = top[2], D = top[3];
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        }
        case B_LD_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        }
        case B_VR_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], X = dst[-1 - BPS];
            const int A = top[0], B = top[1], C = top[2], D = top[3];
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        }
        case B_VL_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        }
        case B_HD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
            const int A = top[0], B = top[1], C = top[2];
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        }
        case B_HU_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
        }
    }
}
#undef DST

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction; DC takes libwebp's
// edge variants (no top row on the first macroblock row, no left column on
// the first column).
void pred_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
    const int shift = size == 16 ? 4 : 3;
    if (mode == DC_PRED) {
        int dc;
        if (has_top && has_left) {
            dc = size;
            for (int i = 0; i < size; i++) dc += dst[i - BPS] + dst[-1 + i * BPS];
            dc >>= shift + 1;
        } else if (has_top || has_left) {
            dc = size >> 1;
            for (int i = 0; i < size; i++) dc += has_top ? dst[i - BPS] : dst[-1 + i * BPS];
            dc >>= shift;
        } else {
            dc = 0x80;
        }
        for (int j = 0; j < size; j++) std::memset(dst + j * BPS, dc, size);
    } else if (mode == TM_PRED) {
        const uint8_t* top = dst - BPS;
        const int tl = top[-1];
        for (int j = 0; j < size; j++)
            for (int i = 0; i < size; i++) dst[i + j * BPS] = clip8(top[i] + dst[-1 + j * BPS] - tl);
    } else if (mode == V_PRED) {
        for (int j = 0; j < size; j++) std::memcpy(dst + j * BPS, dst - BPS, size);
    } else {  // H_PRED
        for (int j = 0; j < size; j++) std::memset(dst + j * BPS, dst[-1 + j * BPS], size);
    }
}

// ---- the loop filter (libwebp's dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] -> [-16, 15]

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 pixels across one edge
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; i++, p += vstride)
        if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) {
            do_filter2(p, hstride);
        } else if (edge) {
            do_filter6(p, hstride);
        } else {
            do_filter4(p, hstride);
        }
    }
}

struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MB {
    int segment = 0, skip = 0, is_i4x4 = 0, ymode = 0, uvmode = 0;
    uint8_t imodes[16] = {0};
};

struct VP8 {
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    BoolDec br;
    std::vector<BoolDec> parts;
    // segment header
    int use_segment = 0, update_map = 0, absolute_delta = 1;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    uint8_t seg_proba[3] = {255, 255, 255};
    // filter header
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    // quantisers: y1 dc/ac, y2 dc/ac, uv dc/ac per segment
    int dq[4][6] = {{0}};
    uint8_t proba[4][8][3][11];
    int use_skip = 0, skip_p = 0;
    FInfo fstrengths[4][2];
    std::vector<uint8_t> Y, U, V;
    int ystride = 0, uvstride = 0;

    static int clipq(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

    void headers(const uint8_t* buf, size_t size) {
        if (size < 4) fail("truncated VP8 header");
        const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
        const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
        const uint32_t part_len = bits >> 5;
        if (profile > 3) fail("incorrect VP8 keyframe parameters");
        if (!show) fail("VP8 frame not displayable");
        buf += 3;
        size -= 3;
        if (!key_frame) fail("VP8 frame is not a key frame");
        if (size < 7) fail("cannot parse the VP8 picture header");
        if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("bad VP8 code word");
        width = ((buf[4] << 8) | buf[3]) & 0x3fff;
        height = ((buf[6] << 8) | buf[5]) & 0x3fff;
        buf += 7;
        size -= 7;
        mb_w = (width + 15) >> 4;
        mb_h = (height + 15) >> 4;
        if (part_len > size) fail("bad VP8 partition length");
        br.init(buf, part_len);
        buf += part_len;
        size -= part_len;
        br.get(0x80);  // colour space
        br.get(0x80);  // clamping type
        // segment header
        use_segment = br.get(0x80);
        if (use_segment) {
            update_map = br.get(0x80);
            if (br.get(0x80)) {
                absolute_delta = br.get(0x80);
                for (int s = 0; s < 4; s++) quantizer[s] = br.get(0x80) ? br.signed_literal(7) : 0;
                for (int s = 0; s < 4; s++) filter_strength[s] = br.get(0x80) ? br.signed_literal(6) : 0;
            }
            if (update_map)
                for (int s = 0; s < 3; s++) seg_proba[s] = static_cast<uint8_t>(br.get(0x80) ? br.literal(8) : 255);
        }
        if (br.eof) fail("cannot parse the VP8 segment header");
        // filter header
        simple = br.get(0x80);
        level = br.literal(6);
        sharpness = br.literal(3);
        use_lf_delta = br.get(0x80);
        if (use_lf_delta && br.get(0x80)) {
            for (int i = 0; i < 4; i++)
                if (br.get(0x80)) ref_lf_delta[i] = br.signed_literal(6);
            for (int i = 0; i < 4; i++)
                if (br.get(0x80)) mode_lf_delta[i] = br.signed_literal(6);
        }
        filter_type = level == 0 ? 0 : simple ? 1 : 2;
        if (br.eof) fail("cannot parse the VP8 filter header");
        // partitions
        const int nparts = 1 << br.literal(2);
        const size_t last = static_cast<size_t>(nparts - 1);
        if (size < 3 * last) fail("cannot parse the VP8 partitions");
        const uint8_t* sz = buf;
        const uint8_t* start = buf + 3 * last;
        size_t left = size - 3 * last;
        parts.assign(nparts, BoolDec());
        for (size_t p = 0; p < last; p++, sz += 3) {
            size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > left) psize = left;
            parts[p].init(start, psize);
            start += psize;
            left -= psize;
        }
        parts[last].init(start, left);
        if (start >= buf + size) fail("cannot parse the VP8 partitions");
        // quantisers
        const int base_q0 = br.literal(7);
        int d[5];
        for (int i = 0; i < 5; i++) d[i] = br.get(0x80) ? br.signed_literal(4) : 0;
        const int dqy1_dc = d[0], dqy2_dc = d[1], dqy2_ac = d[2], dquv_dc = d[3], dquv_ac = d[4];
        for (int s = 0; s < 4; s++) {
            int q;
            if (use_segment) {
                q = quantizer[s] + (absolute_delta ? 0 : base_q0);
            } else if (s > 0) {
                std::memcpy(dq[s], dq[0], sizeof(dq[0]));
                continue;
            } else {
                q = base_q0;
            }
            dq[s][0] = kDcTable[clipq(q + dqy1_dc, 127)];
            dq[s][1] = kAcTable[clipq(q, 127)];
            dq[s][2] = kDcTable[clipq(q + dqy2_dc, 127)] * 2;
            dq[s][3] = (kAcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;
            if (dq[s][3] < 8) dq[s][3] = 8;
            dq[s][4] = kDcTable[clipq(q + dquv_dc, 117)];
            dq[s][5] = kAcTable[clipq(q + dquv_ac, 127)];
        }
        br.get(0x80);  // refresh entropy probabilities: ignored, as by libwebp
        for (int t = 0; t < 4; t++)
            for (int b = 0; b < 8; b++)
                for (int c = 0; c < 3; c++)
                    for (int p = 0; p < 11; p++)
                        proba[t][b][c][p] = static_cast<uint8_t>(
                            br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.literal(8) : kCoeffsProba0[t][b][c][p]);
        use_skip = br.get(0x80);
        if (use_skip) skip_p = br.literal(8);
    }

    void filter_strengths() {
        if (filter_type == 0) return;
        for (int s = 0; s < 4; s++) {
            int base = level;
            if (use_segment) {
                base = filter_strength[s];
                if (!absolute_delta) base += level;
            }
            for (int i4 = 0; i4 <= 1; i4++) {
                FInfo& f = fstrengths[s][i4];
                int lv = base;
                if (use_lf_delta) {
                    lv += ref_lf_delta[0];
                    if (i4) lv += mode_lf_delta[0];
                }
                lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
                if (lv > 0) {
                    int il = lv;
                    if (sharpness > 0) {
                        il >>= sharpness > 4 ? 2 : 1;
                        if (il > 9 - sharpness) il = 9 - sharpness;
                    }
                    if (il < 1) il = 1;
                    f.ilevel = il;
                    f.limit = 2 * lv + il;
                    f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
                } else {
                    f.limit = 0;
                }
                f.inner = i4;
            }
        }
    }

    void parse_modes(MB& mb, uint8_t* top, uint8_t* left) {
        if (update_map) {
            mb.segment = !br.get(seg_proba[0]) ? br.get(seg_proba[1]) : br.get(seg_proba[2]) + 2;
        } else {
            mb.segment = 0;
        }
        if (use_skip) mb.skip = br.get(skip_p);
        mb.is_i4x4 = !br.get(145);
        if (!mb.is_i4x4) {
            const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
            mb.ymode = ymode;
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            uint8_t* modes = mb.imodes;
            for (int y = 0; y < 4; y++) {
                int ymode = left[y];
                for (int x = 0; x < 4; x++) {
                    const uint8_t* prob = kBModesProba[top[x]][ymode];
                    ymode = !br.get(prob[0]) ? B_DC_PRED
                          : !br.get(prob[1]) ? B_TM_PRED
                          : !br.get(prob[2]) ? B_VE_PRED
                          : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE_PRED
                                                : !br.get(prob[5]) ? B_RD_PRED : B_VR_PRED)
                          : !br.get(prob[6]) ? B_LD_PRED
                          : !br.get(prob[7]) ? B_VL_PRED
                          : !br.get(prob[8]) ? B_HD_PRED : B_HU_PRED;
                    top[x] = static_cast<uint8_t>(ymode);
                }
                std::memcpy(modes, top, 4);
                modes += 4;
                left[y] = static_cast<uint8_t>(ymode);
            }
        }
        mb.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
    }

    static int large_value(BoolDec& t, const uint8_t* p) {
        int v;
        if (!t.get(p[3])) {
            v = !t.get(p[4]) ? 2 : 3 + t.get(p[5]);
        } else if (!t.get(p[6])) {
            if (!t.get(p[7])) {
                v = 5 + t.get(159);
            } else {
                v = 7 + 2 * t.get(165);
                v += t.get(145);
            }
        } else {
            const int bit1 = t.get(p[8]);
            const int bit0 = t.get(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.get(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    // libwebp's GetCoeffs: returns the position after the last coded one.
    int coeffs(BoolDec& t, int type, int ctx, int dc_q, int ac_q, int n, int16_t* out) {
        const uint8_t* p = proba[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!t.get(p[0])) return n;
            while (!t.get(p[1])) {
                p = proba[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            if (!t.get(p[2])) {
                v = 1;
                p = proba[type][kBands[n + 1]][1];
            } else {
                v = large_value(t, p);
                p = proba[type][kBands[n + 1]][2];
            }
            out[kZigzag[n]] = static_cast<int16_t>(t.sign(v) * (n > 0 ? ac_q : dc_q));
        }
        return 16;
    }

    // Residuals of one macroblock into coeffs (384 values: 16 Y, 4 U, 4 V
    // blocks) and libwebp's transform codes (non_zero_y, non_zero_uv: 2 bits
    // a block, the first block highest); returns whether all are zero
    // (libwebp's skip).
    bool residuals(BoolDec& t, const MB& mb, uint8_t& top_nz, uint8_t& left_nz, uint8_t& top_dc, uint8_t& left_dc,
                   int16_t* coeffs_out, uint32_t& nz_y, uint32_t& nz_uv) {
        const int* q = dq[mb.segment];
        int16_t* dst = coeffs_out;
        std::memset(dst, 0, 384 * sizeof(int16_t));
        int first, ac_type;
        if (!mb.is_i4x4) {
            int16_t dc[16] = {0};
            const int ctx = top_dc + left_dc;
            const int nz = coeffs(t, 1, ctx, q[2], q[3], 0, dc);
            top_dc = left_dc = nz > 0;
            if (nz > 1) {
                transform_wht(dc, dst);
            } else {
                const int dc0 = (dc[0] + 3) >> 3;
                for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
            }
            first = 1;
            ac_type = 0;
        } else {
            first = 0;
            ac_type = 3;
        }
        auto code = [](int nz, bool dc_nz) -> uint32_t { return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz; };
        nz_y = nz_uv = 0;
        uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
        for (int y = 0; y < 4; y++) {
            int l = lnz & 1;
            uint32_t row_codes = 0;
            for (int x = 0; x < 4; x++) {
                const int ctx = l + (tnz & 1);
                const int nz = coeffs(t, ac_type, ctx, q[0], q[1], first, dst);
                l = nz > first;
                tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
                row_codes = (row_codes << 2) | code(nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 4;
            lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
            nz_y = (nz_y << 8) | row_codes;
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
            uint32_t tn = top_nz >> (4 + ch), ln = left_nz >> (4 + ch), plane_codes = 0;
            for (int y = 0; y < 2; y++) {
                int l = ln & 1;
                for (int x = 0; x < 2; x++) {
                    const int ctx = l + (tn & 1);
                    const int nz = coeffs(t, 2, ctx, q[4], q[5], 0, dst);
                    l = nz > 0;
                    tn = (tn >> 1) | (l << 3);
                    plane_codes = (plane_codes << 2) | code(nz, dst[0] != 0);
                    dst += 16;
                }
                tn >>= 2;
                ln = (ln >> 1) | (l << 5);
            }
            nz_uv |= plane_codes << (4 * ch);
            out_t |= (tn << 4) << ch;
            out_l |= (ln & 0xf0) << ch;
        }
        top_nz = static_cast<uint8_t>(out_t);
        left_nz = static_cast<uint8_t>(out_l);
        return !(nz_y | nz_uv);
    }

    void decode(const uint8_t* data, size_t size) {
        headers(data, size);
        filter_strengths();
        ystride = mb_w * 16;
        uvstride = mb_w * 8;
        Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
        U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
        V.assign(U.size(), 0);
        std::vector<MB> row(mb_w);
        std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
        std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED), nz_top(mb_w, 0), nzdc_top(mb_w, 0);
        std::vector<int16_t> coeffs(384 * static_cast<size_t>(mb_w));
        std::vector<uint32_t> codes(2 * static_cast<size_t>(mb_w));
        for (int mb_y = 0; mb_y < mb_h; mb_y++) {
            uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
            for (int mb_x = 0; mb_x < mb_w; mb_x++) parse_modes(row[mb_x], &intra_t[4 * mb_x], intra_l);
            if (br.eof) fail("premature end of VP8 partition 0");
            BoolDec& tok = parts[mb_y & (parts.size() - 1)];
            uint8_t nz_left = 0, nzdc_left = 0;
            for (int mb_x = 0; mb_x < mb_w; mb_x++) {
                MB& mb = row[mb_x];
                int16_t* c = &coeffs[384 * static_cast<size_t>(mb_x)];
                bool sk = use_skip ? mb.skip != 0 : false;
                uint32_t& nz_y = codes[2 * mb_x];
                uint32_t& nz_uv = codes[2 * mb_x + 1];
                if (!sk) {
                    sk = residuals(tok, mb, nz_top[mb_x], nz_left, nzdc_top[mb_x], nzdc_left, c, nz_y, nz_uv);
                } else {
                    nz_left = nz_top[mb_x] = 0;
                    if (!mb.is_i4x4) nzdc_left = nzdc_top[mb_x] = 0;
                    nz_y = nz_uv = 0;
                }
                if (filter_type > 0) {
                    FInfo f = fstrengths[mb.segment][mb.is_i4x4];
                    f.inner |= !sk;
                    finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
                }
                if (tok.eof) fail("premature end of VP8 data");
            }
            for (int mb_x = 0; mb_x < mb_w; mb_x++)
                reconstruct(mb_x, mb_y, row[mb_x], &coeffs[384 * static_cast<size_t>(mb_x)], codes[2 * mb_x],
                            codes[2 * mb_x + 1]);
        }
        if (filter_type > 0)
            for (int mb_y = 0; mb_y < mb_h; mb_y++)
                for (int mb_x = 0; mb_x < mb_w; mb_x++)
                    loop_filter(mb_x, mb_y, finfo[static_cast<size_t>(mb_y) * mb_w + mb_x]);
    }

    // Prediction and residuals of one macroblock in a work buffer laid out
    // as libwebp's (unfiltered neighbours: 127 above the first row, 129 left
    // of the first column), then stored into the frame.
    void reconstruct(int mb_x, int mb_y, const MB& mb, const int16_t* coeffs, uint32_t nz_y, uint32_t nz_uv) {
        static thread_local uint8_t work[BPS * 17 + BPS * 9 * 2 + 64];
        uint8_t* const ybuf = work + BPS + 8;            // row -1 at ybuf - BPS, col -1 at ybuf - 1
        uint8_t* const ubuf = work + BPS * 18 + 8;
        uint8_t* const vbuf = work + BPS * 27 + 8;
        const int x0 = mb_x * 16, y0 = mb_y * 16;
        auto fill = [&](uint8_t* buf, const std::vector<uint8_t>& plane, int stride, int n, int px, int py) {
            // top-left
            buf[-1 - BPS] = mb_y == 0 ? 127 : mb_x == 0 ? 129 : plane[static_cast<size_t>(py - 1) * stride + px - 1];
            for (int i = 0; i < n; i++)
                buf[i - BPS] = mb_y == 0 ? 127 : plane[static_cast<size_t>(py - 1) * stride + px + i];
            for (int j = 0; j < n; j++)
                buf[j * BPS - 1] = mb_x == 0 ? 129 : plane[static_cast<size_t>(py + j) * stride + px - 1];
        };
        fill(ybuf, Y, ystride, 16, x0, y0);
        fill(ubuf, U, uvstride, 8, x0 / 2, y0 / 2);
        fill(vbuf, V, uvstride, 8, x0 / 2, y0 / 2);
        if (mb.is_i4x4) {
            uint8_t* top_right = ybuf - BPS + 16;
            for (int i = 0; i < 4; i++) {
                if (mb_y == 0) {
                    top_right[i] = 127;
                } else if (mb_x >= mb_w - 1) {
                    top_right[i] = Y[static_cast<size_t>(y0 - 1) * ystride + x0 + 15];
                } else {
                    top_right[i] = Y[static_cast<size_t>(y0 - 1) * ystride + x0 + 16 + i];
                }
            }
            for (int r = 1; r <= 3; r++) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
            for (int n = 0; n < 16; n++, nz_y <<= 2) {
                uint8_t* dst = ybuf + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                pred4(dst, mb.imodes[n]);
                do_transform(static_cast<int>(nz_y >> 30), coeffs + n * 16, dst);
            }
        } else {
            pred_block(ybuf, 16, mb.ymode, mb_y > 0, mb_x > 0);
            for (int n = 0; n < 16; n++, nz_y <<= 2)
                do_transform(static_cast<int>(nz_y >> 30), coeffs + n * 16, ybuf + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        pred_block(ubuf, 8, mb.uvmode, mb_y > 0, mb_x > 0);
        pred_block(vbuf, 8, mb.uvmode, mb_y > 0, mb_x > 0);
        for (int plane = 0; plane < 2; plane++) {  // DoUVTransform: all four blocks alike
            const uint32_t bits = (nz_uv >> (8 * plane)) & 0xff;
            if (!bits) continue;
            const int kind = (bits & 0xaa) ? 3 : 1;
            for (int n = 0; n < 4; n++)
                do_transform(kind, coeffs + 256 + 64 * plane + n * 16,
                             (plane ? vbuf : ubuf) + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        }
        for (int j = 0; j < 16; j++) std::memcpy(&Y[static_cast<size_t>(y0 + j) * ystride + x0], ybuf + j * BPS, 16);
        for (int j = 0; j < 8; j++) {
            std::memcpy(&U[static_cast<size_t>(y0 / 2 + j) * uvstride + x0 / 2], ubuf + j * BPS, 8);
            std::memcpy(&V[static_cast<size_t>(y0 / 2 + j) * uvstride + x0 / 2], vbuf + j * BPS, 8);
        }
    }

    void loop_filter(int mb_x, int mb_y, const FInfo& f) {
        const int limit = f.limit;
        if (limit == 0) return;
        uint8_t* y = &Y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
        const int ys = ystride;
        if (filter_type == 1) {
            if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; k++) simple_filter(y + 4 * k, 1, ys, limit);
            if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; k++) simple_filter(y + 4 * k * ys, ys, 1, limit);
            return;
        }
        const int uvs = uvstride;
        uint8_t* u = &U[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
        uint8_t* v = &V[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mb_x > 0) {
            filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
            filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
            filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
            filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
            filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
            filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
            filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
            filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
            filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
            filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
    }
};

// ---- YUV 4:2:0 -> BGR(A), libwebp's default output ----

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
    bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: one or two output rows from the chroma rows above
// (top_u/v) and below (cur_u/v), each chroma sample weighted 9:3:3:1.
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bot_dst, int len, int cn) {
    const int last_pair = (len - 1) >> 1;
    int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
    yuv_to_bgr(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bot_y) yuv_to_bgr(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last_pair; x++) {
        const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
        const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
        const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
        const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
        yuv_to_bgr(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * cn);
        yuv_to_bgr(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + (2 * x) * cn);
        if (bot_y) {
            yuv_to_bgr(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bot_dst + (2 * x - 1) * cn);
            yuv_to_bgr(bot_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bot_dst + (2 * x) * cn);
        }
        tl_u = t_u, tl_v = t_v, l_u = u, l_v = v;
    }
    if (!(len & 1)) {
        yuv_to_bgr(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * cn);
        if (bot_y)
            yuv_to_bgr(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst + (len - 1) * cn);
    }
}

// The decoded frame cropped to width x height, fancy-upsampled (EmitFancyRGB
// over the whole picture) into BGR or BGRA rows of out_stride bytes.
void emit_bgr(const VP8& d, uint8_t* out, int out_stride, int cn) {
    const int w = d.width, h = d.height;
    const uint8_t* Y = d.Y.data();
    const uint8_t* U = d.U.data();
    const uint8_t* V = d.V.data();
    const int ys = d.ystride, uvs = d.uvstride;
    upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w, cn);
    int y = 0;
    for (; y + 2 < h; y += 2) {  // rows y+1 (between chroma rows y/2 and y/2+1) and y+2
        const int c = y / 2;
        const size_t top = static_cast<size_t>(c) * uvs, bot = top + uvs;
        upsample_pair(Y + static_cast<size_t>(y + 1) * ys, Y + static_cast<size_t>(y + 2) * ys, U + top, V + top,
                      U + bot, V + bot, out + static_cast<size_t>(y + 1) * out_stride,
                      out + static_cast<size_t>(y + 2) * out_stride, w, cn);
    }
    if (!(h & 1)) {  // the last row of an even-height picture
        const int c = (h - 1) / 2;
        const uint8_t* cu = U + static_cast<size_t>(c) * uvs;
        const uint8_t* cv = V + static_cast<size_t>(c) * uvs;
        upsample_pair(Y + static_cast<size_t>(h - 1) * ys, nullptr, cu, cv, cu, cv,
                      out + static_cast<size_t>(h - 1) * out_stride, nullptr, w, cn);
    }
}

// ---- the ALPH chunk ----

void unfilter_alpha(uint8_t* a, int w, int h, int filter) {
    for (int y = 0; y < h; y++) {
        uint8_t* row = a + static_cast<size_t>(y) * w;
        const uint8_t* prev = y ? row - w : nullptr;
        if (filter == 1 || !prev) {  // horizontal; the first row of every filter
            uint8_t pred = prev ? prev[0] : 0;
            for (int i = 0; i < w; i++) pred = row[i] = static_cast<uint8_t>(pred + row[i]);
        } else if (filter == 2) {
            for (int i = 0; i < w; i++) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
        } else {  // gradient
            int top = prev[0], top_left = top, left = top;
            for (int i = 0; i < w; i++) {
                top = prev[i];
                const int g = left + top - top_left;
                left = static_cast<uint8_t>(row[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
                top_left = top;
                row[i] = static_cast<uint8_t>(left);
            }
        }
    }
}

void decode_alpha(const uint8_t* d, size_t n, int w, int h, uint8_t* out) {
    if (n <= 1) fail("empty ALPH chunk");
    const int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3, rsrv = (d[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) fail("invalid ALPH header");
    const size_t total = static_cast<size_t>(w) * h;
    if (method == 0) {
        if (n - 1 < total) fail("ALPH data is short");
        std::memcpy(out, d + 1, total);
    } else {
        VP8L dec(d + 1, n - 1);
        const std::vector<uint32_t> argb = dec.decode(w, h);
        for (size_t i = 0; i < total; i++) out[i] = static_cast<uint8_t>(argb[i] >> 8);
    }
    if (filter) unfilter_alpha(out, w, h, filter);
}

void copy_err(const char* what, char* err, int errlen) {
    if (err && errlen > 0) {
        std::strncpy(err, what, static_cast<size_t>(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// A VP8L bitstream (from its 0x2f signature) -> height x width BGR or BGRA
// rows of out_stride bytes. 0, or -1 with a message in err.
int tl_webp_vp8l(const uint8_t* data, size_t len, int width, int height, int channels, uint8_t* out, int out_stride,
                 char* err, int errlen) {
    try {
        if (len < 5 || data[0] != 0x2f) fail("no VP8L signature");
        const uint32_t bits = data[1] | (data[2] << 8) | (data[3] << 16) | (static_cast<uint32_t>(data[4]) << 24);
        if ((bits & 0x3fff) + 1 != static_cast<uint32_t>(width) ||
            ((bits >> 14) & 0x3fff) + 1 != static_cast<uint32_t>(height) || (bits >> 29) != 0)
            fail("VP8L header does not match");
        VP8L dec(data, len, 40);  // the stream's bits count from the signature
        const std::vector<uint32_t> argb = dec.decode(width, height);
        for (int y = 0; y < height; y++) {
            uint8_t* o = out + static_cast<size_t>(y) * out_stride;
            const uint32_t* s = &argb[static_cast<size_t>(y) * width];
            for (int x = 0; x < width; x++, o += channels) {
                o[0] = static_cast<uint8_t>(s[x]);
                o[1] = static_cast<uint8_t>(s[x] >> 8);
                o[2] = static_cast<uint8_t>(s[x] >> 16);
                if (channels == 4) o[3] = static_cast<uint8_t>(s[x] >> 24);
            }
        }
        return 0;
    } catch (const std::exception& e) {
        copy_err(e.what(), err, errlen);
        return -1;
    }
}

// A VP8 key frame (from its frame tag to the end of the data) and an ALPH
// chunk's payload (or none) -> height x width BGR or BGRA rows of
// out_stride bytes (alpha 255 without ALPH). 0, or -1 with a message.
int tl_webp_vp8(const uint8_t* data, size_t len, const uint8_t* alph, size_t alph_len, int width, int height,
                int channels, uint8_t* out, int out_stride, char* err, int errlen) {
    try {
        VP8 dec;
        dec.decode(data, len);
        if (dec.width != width || dec.height != height) fail("VP8 frame size does not match");
        std::vector<uint8_t> alpha;
        if (alph) {
            alpha.resize(static_cast<size_t>(width) * height);
            decode_alpha(alph, alph_len, width, height, alpha.data());
        }
        emit_bgr(dec, out, out_stride, channels);
        if (channels == 4)
            for (int y = 0; y < height; y++) {
                uint8_t* o = out + static_cast<size_t>(y) * out_stride + 3;
                for (int x = 0; x < width; x++, o += 4) o[0] = alph ? alpha[static_cast<size_t>(y) * width + x] : 255;
            }
        return 0;
    } catch (const std::exception& e) {
        copy_err(e.what(), err, errlen);
        return -1;
    }
}

}  // extern "C"
