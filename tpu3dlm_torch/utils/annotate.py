"""Box and label drawing on uint8 images in numpy, for the annotated frames
of ``view_img`` (``pipeline/detector.py``), without cv2.

``draw_box`` paints what ``cv2.rectangle(img, p1, p2, color, thickness=2)``
paints (8-connected lines), pixel for pixel: each edge of non-zero length
is a band one pixel either side of it, from end to end, and each corner a
filled disc of radius 1 (the corner and its four neighbours), all clipped
to the image. ``draw_label`` writes the text in a 5×7 bitmap font with its
baseline at ``origin`` (descenders one row below), 6 px a character; it is
not cv2's Hershey font, but it stays inside the box ``cv2.getTextSize``
gives cv2's text at scale 0.5 for the labels the detector writes.
"""

from __future__ import annotations

import numpy as np

# the classic 5×7 LCD font, ASCII 32-126: five column bytes a glyph, bit 0
# the top row, bit 7 a descender row below the baseline
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649562050"
    "0008070300" "001c224100" "0041221c00" "2a1c7f1c2a" "08083e0808" "0080703000" "0808080808"
    "0000606000" "2010080402" "3e5149453e" "00427f4000" "7249494946" "2141494d33" "1814127f10"
    "2745454539" "3c4a494931" "4121110907" "3649494936" "464949291e" "0000140000" "0040340000"
    "0008142241" "1414141414" "0041221408" "0201590906" "3e415d594e" "7c1211127c" "7f49494936"
    "3e41414122" "7f4141413e" "7f49494941" "7f09090901" "3e41415173" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f021c027f" "7f0408107f" "3e4141413e" "7f09090906"
    "3e4151215e" "7f09192946" "2649494932" "03017f0103" "3f4040403f" "1f2040201f" "3f4038403f"
    "6314081463" "0304780403" "6159494d43" "007f414141" "0204081020" "004141417f" "0402010204"
    "4040404040" "0003070800" "2054547840" "7f28444438" "3844444428" "384444287f" "3854545418"
    "00087e0902" "18a4a49c78" "7f08040478" "00447d4000" "2040403d00" "7f10284400" "00417f4000"
    "7c04780478" "7c08040478" "3844444438" "fc18242418" "18242418fc" "7c08040408" "4854545424"
    "04043f4424" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "4c9090907c" "4464544c44"
    "0008364100" "0000770000" "0041360800" "0201020402"
)
ADVANCE = 6  # px a character: five columns and a gap


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int, color) -> None:
    """Paint rows y0..y1 and columns x0..x1 (inclusive), clipped."""
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(y0, 0), min(y1, h - 1), max(x0, 0), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def draw_box(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int], color) -> None:
    """``cv2.rectangle(img, p1, p2, color, 2)`` in place (integer corners)."""
    (x1, y1), (x2, y2) = p1, p2
    xa, xb = min(x1, x2), max(x1, x2)
    ya, yb = min(y1, y2), max(y1, y2)
    if xa != xb:  # the two horizontal edges
        for y in (y1, y2):
            _fill(img, y - 1, y + 1, xa, xb, color)
    if ya != yb:  # the two vertical edges
        for x in (x1, x2):
            _fill(img, ya, yb, x - 1, x + 1, color)
    for x, y in ((x1, y1), (x2, y1), (x2, y2), (x1, y2)):
        _fill(img, y - 1, y + 1, x, x, color)
        _fill(img, y, y, x - 1, x + 1, color)


def draw_label(img: np.ndarray, text: str, origin: tuple[int, int], color) -> None:
    """``text`` in the 5×7 font, baseline at ``origin`` = (x, y), in place;
    characters outside ASCII 32-126 advance without ink."""
    h, w = img.shape[:2]
    x0, y0 = origin
    for i, ch in enumerate(text):
        code = ord(ch) - 32
        if not 0 <= code < len(_FONT) // 5:
            continue
        for c in range(5):
            bits = _FONT[5 * code + c]
            x = x0 + ADVANCE * i + c
            if not 0 <= x < w:
                continue
            for r in range(8):
                y = y0 - 6 + r
                if bits >> r & 1 and 0 <= y < h:
                    img[y, x] = color
