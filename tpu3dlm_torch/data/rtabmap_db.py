"""RTAB-Map SQLite (.db) frame extractor (port of
``tpu3dlm/data/rtabmap_db.py``, on stdlib ``sqlite3`` and the port's
codecs).

``SELECT Data.id, Data.image, Data.depth FROM Data JOIN Node ... ORDER BY
Data.id``; depth blobs (PNG) are decoded and written as ``<ordinal>.png``,
RGB blobs copied as ``<ordinal>.jpg``. The reference's rules hold:
ordinals number the distinct node ids 1..K (duplicate-id JOIN rows
collapse to the first), a node whose depth blob is NULL or undecodable is
skipped and its ordinal left as a gap, so every later frame keeps its own
poses.txt row. Blobs are decoded as ``cv2.imdecode`` decodes them, the
format told apart by its signature (JPEG, PNG, TIFF, BMP, PNM/PAM/PFM, Sun
raster, Radiance HDR, GIF, WebP, JPEG 2000; ``data/codecs.py``): depth
under IMREAD_UNCHANGED, RGB under IMREAD_COLOR; a blob cv2 would return
None for, or one in a format the port does not decode yet (AVIF), counts as
undecodable. A depth array PNG cannot hold (float, signed or
32-bit samples) is written as ``cv2.imwrite`` writes it: cast to 8 bits.
"""

from __future__ import annotations

import logging
import os
import sqlite3

import numpy as np

from tpu3dlm_torch.data import codecs, containers

_QUERY = (
    "SELECT Data.id, Data.image, Data.depth FROM Data JOIN Node "
    "ON Data.id = Node.id ORDER BY Data.id"
)

_log = logging.getLogger(__name__)


def _iter_unique_rows(cursor):
    """Yield (ordinal, image_blob, depth_blob) with duplicate-id JOIN rows
    collapsed to the FIRST occurrence (warned). Ordinals number the
    DISTINCT node ids 1..K in id order."""
    last_id, ordinal, dupes = None, 0, 0
    for node_id, image_blob, depth_blob in cursor:
        if node_id == last_id:
            dupes += 1
            continue
        last_id = node_id
        ordinal += 1
        yield ordinal, image_blob, depth_blob
    if dupes:
        _log.warning(
            "%d duplicate node-id row(s) in the database JOIN were "
            "collapsed to their first occurrence", dupes,
        )


def png_writable(img: np.ndarray) -> np.ndarray:
    """``img`` as ``cv2.imwrite`` hands it to the PNG encoder: uint8 and
    uint16 as they are, any other depth cast to uint8 (saturating; floats
    rounded half to even, NaN and values past int32 to 0)."""
    if img.dtype in (np.uint8, np.uint16):
        return img
    if img.dtype.kind == "f":
        return containers.saturate_u8(img)
    return np.clip(img.astype(np.int64), 0, 255).astype(np.uint8)


def _decode_depth_blob(blob):
    """Decoded depth image (cv2 layout), or None when NULL or undecodable."""
    if blob is None:
        return None
    try:
        return codecs.decode_unchanged(bytes(blob), "<depth blob>")
    except ValueError:
        return None


class ImageExtractor:
    """Extract RGB/depth frames from an RTAB-Map database."""

    def __init__(self, db_path: str, depth_dir: str, image_dir: str | None = None):
        self.db_path = db_path
        self.depth_dir = depth_dir
        self.image_dir = image_dir
        os.makedirs(depth_dir, exist_ok=True)
        if image_dir:
            os.makedirs(image_dir, exist_ok=True)
        self.conn = sqlite3.connect(db_path)

    def fetch_data(self) -> int:
        """Write depth PNGs (and the RGB blobs as ``<n>.jpg``, whatever their
        format, when image_dir given); returns the
        frame count. Rows with a NULL or undecodable depth blob are skipped
        with a warning; filenames keep the 1-based node ordinal
        (``self.node_ordinals``). The cursor streams row by row."""
        cursor = self.conn.cursor()
        cursor.execute(_QUERY)
        count, skipped = 0, 0
        self.node_ordinals: list[int] = []
        for ordinal, image_blob, depth_blob in _iter_unique_rows(cursor):
            depth = _decode_depth_blob(depth_blob)
            if depth is None:
                skipped += 1
                continue
            codecs.write_png(os.path.join(self.depth_dir, f"{ordinal}.png"), png_writable(depth))
            if self.image_dir and image_blob is not None:
                with open(os.path.join(self.image_dir, f"{ordinal}.jpg"), "wb") as f:
                    f.write(image_blob)
            self.node_ordinals.append(ordinal)
            count += 1
        if skipped:
            _log.warning(
                "%d database node(s) had no decodable depth and were "
                "skipped — filenames keep the node ordinal so the "
                "remaining %d frames still pair with their poses.txt rows",
                skipped, count,
            )
        return count

    def fetch_arrays(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """In-memory path: decode straight to (rgb_frames, depth_frames),
        depth as float32 metres. A row missing either blob, or with one that
        does not decode, is skipped (rgb and depth are kept together)."""
        cursor = self.conn.cursor()
        cursor.execute(_QUERY)
        rgbs, depths = [], []
        skipped = 0
        self.node_ordinals = []
        for ordinal, image_blob, depth_blob in _iter_unique_rows(cursor):
            depth_u8 = _decode_depth_blob(depth_blob)
            rgb = None
            if image_blob is not None:
                try:
                    rgb = codecs.decode_image(bytes(image_blob), "<image blob>")
                except ValueError:
                    rgb = None
            if depth_u8 is None or rgb is None:
                skipped += 1
                continue
            depths.append(reinterpret_depth(depth_u8))
            rgbs.append(rgb)
            self.node_ordinals.append(ordinal)
        if skipped:
            _log.warning(
                "%d database node(s) missing an RGB or depth blob were "
                "skipped from the in-memory path", skipped,
            )
        return rgbs, depths

    def close(self):
        self.conn.close()


def reinterpret_depth(depth_raw: np.ndarray) -> np.ndarray:
    """Decoded RTAB-Map depth image → (H, W) float32 metres.

    - CV_8UC4 (H, W, 4) uint8 whose bytes are little-endian float32 metres:
      a bit-level reinterpretation (NaN/±inf → 0, the invalid sentinel).
    - 16UC1 (H, W) uint16 millimetres: a value cast ÷1000.
    """
    if depth_raw.ndim == 2 and depth_raw.dtype == np.uint16:
        return depth_raw.astype(np.float32) / 1000.0
    if depth_raw.ndim != 3 or depth_raw.shape[2] != 4 or depth_raw.dtype != np.uint8:
        raise ValueError(
            "expected (H, W, 4) uint8 or (H, W) uint16 depth image, got "
            f"{depth_raw.shape} {depth_raw.dtype}"
        )
    h, w = depth_raw.shape[:2]
    depth = np.ascontiguousarray(depth_raw).reshape(h, w * 4).view(np.float32)
    return np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)


def encode_depth(depth_m: np.ndarray) -> np.ndarray:
    """(H, W) float32 metres → CV_8UC4 image carrying the raw bytes
    (inverse of `reinterpret_depth`)."""
    h, w = depth_m.shape
    return (
        np.ascontiguousarray(depth_m.astype(np.float32))
        .view(np.uint8)
        .reshape(h, w, 4)
    )
