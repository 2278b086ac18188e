"""Paired RGB/depth/calibration capture → ``Scan`` (port of
``tpu3dlm/data/dataset.py``).

Natural-sorted pairing of ``<n>.jpg`` RGB with ``<n>.png`` depth and
``<n>.yaml`` calibration, pose rows paired by the numeric stem, the
CV_8UC4→float32 byte-reinterpret depth decode (×1000 metres→mm) or 16UC1
millimetres, and the two resize modes (square or letterbox). Decoding and
resizing go through the port's own codecs (``data/codecs.py``), which give
cv2's bytes, so ``load_scan`` returns the reference's arrays exactly.
``load_scan(cache=True)`` and ``iter_scan_chunks(cache=True)`` serve a
capture from its scanpack (``data/scanpack.py``) when the pack is valid for
the files on disk, and write it when it is not; ``iter_scan_chunks``
streams a capture in fixed-shape chunks.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from tpu3dlm_torch.data import codecs, scanpack
from tpu3dlm_torch.data.calibration import load_calibration
from tpu3dlm_torch.data.poses import load_poses
from tpu3dlm_torch.data.scan import Scan
from tpu3dlm_torch.utils.natsort import natsorted
from tpu3dlm_torch.utils.shapes import pad_poses

_log = logging.getLogger(__name__)


def _pair_filenames(image_dir: str, depth_image_dir: str) -> list[tuple[str, str]]:
    image_filenames = natsorted(os.listdir(image_dir))
    depth_filenames = set(os.listdir(depth_image_dir))
    pairs = []
    for image_filename in image_filenames:
        depth_filename = os.path.splitext(image_filename)[0] + ".png"
        if depth_filename in depth_filenames:
            pairs.append((image_filename, depth_filename))
    return pairs


def _pose_rows_for_pairs(
    pairs: list[tuple[str, str]], n_poses: int
) -> tuple[list[tuple[str, str]], np.ndarray]:
    """Select the pose row for each (rgb, depth) filename pair.

    Frames are named by their 1-based node ordinal and poses.txt carries one
    row per node, so when every stem is numeric, frame ``<k>.jpg`` pairs
    with pose row ``k-1`` even across gaps (a skipped depth-less node).
    Pairs whose stem exceeds the pose table are dropped; non-numeric stems
    fall back to positional pairing. Returns ``(kept_pairs, pose_rows)``.
    """
    stems = []
    for rgb_name, _ in pairs:
        stem = os.path.splitext(rgb_name)[0]
        if not stem.isdigit() or int(stem) < 1:
            n = min(len(pairs), n_poses)
            return pairs[:n], np.arange(n)
        stems.append(int(stem))
    kept = [p for p, s in zip(pairs, stems) if s <= n_poses]
    rows = np.asarray([s - 1 for s in stems if s <= n_poses], dtype=np.int64)
    return kept, rows


def _source_fingerprint(image_dir, depth_image_dir, pairs, calibration_dir=None) -> dict:
    """Stat fingerprint (file count, bytes, max mtime) over the capture's
    paired source files and their calibration YAMLs. The scanpack cache is
    valid only while it matches, so a capture re-exported in place (same
    frame count, re-processed pixels or corrected calibration) rebuilds the
    pack: the pack stores the parsed intrinsics, so the YAMLs are part of
    the print."""
    count, total, mtime = 0, 0, 0.0
    for rgb_name, d_name in pairs:
        paths = [os.path.join(image_dir, rgb_name), os.path.join(depth_image_dir, d_name)]
        if calibration_dir is not None:
            paths.append(os.path.join(calibration_dir, os.path.splitext(rgb_name)[0] + ".yaml"))
        for p in paths:
            try:
                st = os.stat(p)
            except OSError:
                continue
            count += 1
            total += st.st_size
            mtime = max(mtime, st.st_mtime)
    return {"files": count, "bytes": total, "mtime": round(mtime, 6)}


def _fingerprint_matches(pack_path: str, fp: dict) -> bool:
    try:
        with open(pack_path + ".src") as f:
            return json.load(f) == fp
    except (OSError, ValueError):
        return False


def _write_fingerprint(pack_path: str, fp: dict) -> None:
    try:
        with open(pack_path + ".src", "w") as f:
            json.dump(fp, f)
    except OSError:
        pass  # the pack stays unvalidated and is rebuilt on the next load


def _pack_path(image_dir: str, img_size: int) -> str:
    return os.path.join(os.path.dirname(image_dir.rstrip("/")), f"scan_{img_size}.pack")


def load_depth_image(path: str, depth_height: int, depth_width: int) -> np.ndarray:
    """Decode an RTAB-Map depth frame → (depth_height, depth_width) float32 mm.

    - CV_8UC4: byte-level reinterpret as float32 metres, NaN/±inf → 0, then
      ×1000; reshaped to the calibration's (depth_height, depth_width).
    - 16UC1 uint16: already millimetres; nearest-neighbour resized if the
      stored resolution differs.

    The file is read as ``cv2.imread(path, IMREAD_UNCHANGED)`` reads it,
    whatever its format (a 16-bit TIFF or PGM is 16UC1; a 4-channel 8-bit
    TIFF, BMP or PNG is CV_8UC4; a JPEG or float frame gets the layout
    error). A missing file
    raises FileNotFoundError; one that does not decode raises ValueError
    naming the path.
    """
    raw = codecs.read_unchanged(path)
    if raw.ndim == 2 and raw.dtype == np.uint16:
        depth = raw.astype(np.float32)  # already millimetres
        if depth.shape != (depth_height, depth_width):
            depth = codecs.resize_nearest(depth, (depth_width, depth_height))
        return depth
    if raw.ndim != 3 or raw.shape[2] != 4 or raw.dtype != np.uint8:
        raise ValueError(
            f"depth PNG {path} is neither CV_8UC4 nor 16UC1 "
            f"(shape {raw.shape}, dtype {raw.dtype})"
        )
    depth = np.ascontiguousarray(raw).reshape(raw.shape[0], raw.shape[1] * 4).view(np.float32)
    depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
    depth = depth * 1000.0  # metres → millimetres
    if depth.size != depth_height * depth_width:
        raise ValueError(
            f"depth PNG {path} carries {depth.size} float32 pixels; "
            f"calibration expects {depth_height}x{depth_width}"
        )
    return depth.reshape(depth_height, depth_width)


def load_rgb_image(path: str, size_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Load a frame as (H, W, 3) RGB uint8, optionally resized to (h, w):
    ``cv2.imread(path, IMREAD_COLOR)`` of any format the port decodes,
    told apart by its signature whatever the extension, EXIF (or TIFF)
    orientation applied, a cut JPEG file padded. A missing file raises FileNotFoundError; one that does not
    decode raises ValueError naming the path."""
    rgb = codecs.read_image(path)
    if size_hw is not None and rgb.shape[:2] != tuple(size_hw):
        rgb = codecs.resize_linear(rgb, (size_hw[1], size_hw[0]))
    return rgb


class ScanDataset:
    """Per-frame indexable view (reference ``ImageDataset`` API).

    ``processing=True`` yields detector-sized square RGB; ``False`` yields
    RGB resized to the depth resolution.
    """

    def __init__(
        self,
        image_dir: str,
        depth_image_dir: str,
        calibration_dir: str,
        img_size: int,
        depth_width: int = 192,
        depth_height: int = 256,
        processing: bool = True,
    ):
        self.image_dir = image_dir
        self.depth_image_dir = depth_image_dir
        self.calibration_dir = calibration_dir
        self.img_size = img_size
        self.depth_width = depth_width
        self.depth_height = depth_height
        self.processing = processing
        self.paired_filenames = _pair_filenames(image_dir, depth_image_dir)

    def __len__(self) -> int:
        return len(self.paired_filenames)

    def __getitem__(self, idx: int):
        image_filename, depth_filename = self.paired_filenames[idx]
        depth = load_depth_image(
            os.path.join(self.depth_image_dir, depth_filename),
            self.depth_height,
            self.depth_width,
        )
        size = (self.img_size, self.img_size) if self.processing else (self.depth_height, self.depth_width)
        rgb = load_rgb_image(os.path.join(self.image_dir, image_filename), size)
        calib = load_calibration(
            os.path.join(self.calibration_dir, os.path.splitext(image_filename)[0] + ".yaml")
        )
        return rgb, depth, calib


def _letterbox_np(rgb: np.ndarray, size: int, fill: int = 114):
    """Letterbox: aspect-preserving resize + centre pad (ultralytics input
    convention) → (canvas, scale, pad_x, pad_y)."""
    h, w = rgb.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = codecs.resize_linear(rgb, (nw, nh))
    canvas = np.full((size, size, 3), fill, np.uint8)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    canvas[pad_y : pad_y + nh, pad_x : pad_x + nw] = resized
    return canvas, scale, pad_x, pad_y


def _decode_frames(
    pairs: list[tuple[str, str]],
    image_dir: str,
    depth_image_dir: str,
    calibration_dir: str,
    img_size: int,
    depth_width: int,
    depth_height: int,
    resize_mode: str,
    workers: int = 0,
):
    """Decode (rgb, depth) filename pairs into stacked arrays.

    ``workers > 1`` decodes frames on a thread pool: the codecs run in C++
    behind ctypes, which releases the GIL, so this scales with host cores.
    Each thread writes disjoint rows of the preallocated output, so the
    result is identical to the sequential path.
    """
    n = len(pairs)
    rgb = np.zeros((n, img_size, img_size, 3), np.uint8)
    depth = np.zeros((n, depth_height, depth_width), np.float32)
    intrinsics = np.zeros((n, 4), np.float32)
    rgb_size = np.zeros((n, 2), np.float32)
    lbox = np.zeros((n, 3), np.float32) if resize_mode == "letterbox" else None

    def _one(i: int) -> None:
        image_filename, depth_filename = pairs[i]
        frame = load_rgb_image(os.path.join(image_dir, image_filename))
        if resize_mode == "letterbox":
            rgb[i], scale, px, py = _letterbox_np(frame, img_size)
            lbox[i] = [scale, px, py]
        else:
            rgb[i] = codecs.resize_linear(frame, (img_size, img_size))
        depth[i] = load_depth_image(
            os.path.join(depth_image_dir, depth_filename), depth_height, depth_width
        )
        calib = load_calibration(
            os.path.join(calibration_dir, os.path.splitext(image_filename)[0] + ".yaml")
        )
        intrinsics[i] = [calib["fx"], calib["fy"], calib["cx"], calib["cy"]]
        rgb_size[i] = [calib["image_width"], calib["image_height"]]

    if workers > 1 and n > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_one, range(n)))  # list() re-raises worker errors
    else:
        for i in range(n):
            _one(i)
    return rgb, depth, intrinsics, rgb_size, lbox


def iter_scan_chunks(
    image_dir: str,
    depth_image_dir: str,
    calibration_dir: str,
    pose_path: str,
    chunk_frames: int = 64,
    img_size: int = 640,
    depth_width: int = 192,
    depth_height: int = 256,
    resize_mode: str = "square",
    cache: bool = False,
    workers: int = 0,
):
    """Stream a capture as fixed-shape ``Scan`` chunks of ``chunk_frames``.

    Host memory stays O(chunk_frames) whatever the capture's length, and
    every chunk has the same shape: the last one is zero-padded, with
    identity poses (a zero quaternion normalises to NaN) and ``rgb_size``
    1 (no division by zero in the box affine).

    ``cache=True`` (square mode): chunks are served from the capture's
    scanpack when it is valid (memory-mapped slices, no image decode);
    otherwise this pass decodes and writes the pack chunk by chunk, so the
    next run streams decode-free. A stream abandoned midway leaves the pack
    unfinalised, and it is ignored. A failed pack write warns and the
    stream goes on uncached.

    Yields ``(scan_chunk, valid)``: the first ``valid`` ≤ chunk_frames rows
    are real frames.
    """
    if resize_mode not in ("square", "letterbox"):
        raise ValueError(f"resize_mode must be square|letterbox, got {resize_mode}")
    pairs = _pair_filenames(image_dir, depth_image_dir)
    timestamps, poses = load_poses(pose_path)
    pairs, pose_rows = _pose_rows_for_pairs(pairs, poses.shape[0])
    n = len(pairs)
    if n == 0:
        raise ValueError(f"no paired frames found in {image_dir} / {depth_image_dir}")
    poses = poses[pose_rows]
    timestamps = timestamps[pose_rows]

    pack = pack_writer = None
    if cache and resize_mode == "square":
        pack_path = _pack_path(image_dir, img_size)
        src_fp = _source_fingerprint(image_dir, depth_image_dir, pairs, calibration_dir)
        pack = scanpack.scanpack_memmap(pack_path)
        if pack is not None and pack["dims"] != (n, img_size, img_size, depth_height, depth_width):
            pack = None  # another frame count or shape
        if pack is not None and not _fingerprint_matches(pack_path, src_fp):
            pack = None  # the source files were re-exported in place
        if pack is None:
            try:
                pack_writer = scanpack.scanpack_create(
                    pack_path, n, img_size, img_size, depth_height, depth_width)
            except OSError:
                pack_writer = None

    for start in range(0, n, chunk_frames):
        stop = min(start + chunk_frames, n)
        valid = stop - start
        if pack is not None:
            # contiguous copies of the mapped slices: the chunk's O(chunk) cost
            rgb = np.array(pack["rgb"][start:stop])
            depth = np.array(pack["depth"][start:stop])
            intrinsics = np.array(pack["intr"][start:stop])
            rgb_size = np.array(pack["rgb_size"][start:stop])
            lbox = None
        else:
            rgb, depth, intrinsics, rgb_size, lbox = _decode_frames(
                pairs[start:stop], image_dir, depth_image_dir, calibration_dir,
                img_size, depth_width, depth_height, resize_mode, workers,
            )
            if pack_writer is not None:
                # the cache is only an optimisation: a write failure must not
                # abort a run whose decode and compute succeed
                try:
                    pack_writer["rgb"][start:stop] = rgb
                    pack_writer["depth"][start:stop] = depth
                    pack_writer["intr"][start:stop] = intrinsics
                    pack_writer["rgb_size"][start:stop] = rgb_size
                    pack_writer["poses"][start:stop] = poses[start:stop]
                    if stop == n:
                        for name in ("rgb", "depth", "intr", "rgb_size", "poses"):
                            pack_writer[name].flush()
                        scanpack.scanpack_finalize(pack_path)
                        _write_fingerprint(pack_path, src_fp)
                except OSError as e:
                    _log.warning("scan cache write failed (%s) — continuing uncached", e)
                    pack_writer = None
        if valid < chunk_frames:
            pad = chunk_frames - valid

            def _pad(a, fill=0):
                if a is None:
                    return None
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

            rgb, depth, intrinsics, lbox = _pad(rgb), _pad(depth), _pad(intrinsics), _pad(lbox)
            rgb_size = _pad(rgb_size, fill=1)
            chunk_poses = pad_poses(poses[start:stop], chunk_frames)
            chunk_ts = np.concatenate([timestamps[start:stop], np.zeros(pad, timestamps.dtype)])
        else:
            chunk_poses = poses[start:stop]
            chunk_ts = timestamps[start:stop]
        yield (
            Scan(rgb=rgb, depth=depth, intrinsics=intrinsics, rgb_size=rgb_size,
                 poses=chunk_poses, timestamps=chunk_ts, letterbox=lbox),
            valid,
        )


def load_scan(
    image_dir: str,
    depth_image_dir: str,
    calibration_dir: str,
    pose_path: str,
    img_size: int = 640,
    depth_width: int = 192,
    depth_height: int = 256,
    resize_mode: str = "square",
    cache: bool = False,
    workers: int = 0,
) -> Scan:
    """Stack a full capture into a ``Scan``.

    RGB frames at detector resolution (img_size²) uint8 — plain square
    resize or ``resize_mode="letterbox"``; depth at native resolution in
    mm; intrinsics and poses per frame. The frame count is min(paired
    frames, pose rows).

    ``cache=True`` (square mode): a scanpack beside the image directory
    (``scan_<img_size>.pack``) is served with one sequential read when its
    depth grid and frame count match and its source fingerprint equals the
    files on disk (so re-exported pixels or calibration rebuild it); the
    poses always come from the live ``poses.txt``, never from the pack.
    Otherwise the capture is decoded and the pack written; a failed write
    warns and the scan is returned uncached.
    """
    if resize_mode not in ("square", "letterbox"):
        raise ValueError(f"resize_mode must be square|letterbox, got {resize_mode}")
    pack_path = _pack_path(image_dir, img_size)
    use_cache = cache and resize_mode == "square"
    if use_cache:
        cached = scanpack.scanpack_read(pack_path)
        if cached is not None and cached[1].shape[1:] != (depth_height, depth_width):
            cached = None  # another depth grid
        if cached is not None:
            rgb, depth, intrinsics, rgb_size, _ = cached
            timestamps, poses_now = load_poses(pose_path)
            pairs_now, rows_now = _pose_rows_for_pairs(
                _pair_filenames(image_dir, depth_image_dir), poses_now.shape[0])
            # stale when frames were added or removed, or the capture was
            # re-exported in place (same count, other source bytes)
            if rgb.shape[0] == len(pairs_now) and _fingerprint_matches(
                    pack_path, _source_fingerprint(image_dir, depth_image_dir, pairs_now, calibration_dir)):
                # the live poses: a poses.txt rewritten in place (a re-run
                # pose-graph optimisation) is not covered by the fingerprint
                return Scan(rgb=rgb, depth=depth, intrinsics=intrinsics, rgb_size=rgb_size,
                            poses=poses_now[rows_now], timestamps=timestamps[rows_now])
    pairs = _pair_filenames(image_dir, depth_image_dir)
    timestamps, poses = load_poses(pose_path)
    pairs, pose_rows = _pose_rows_for_pairs(pairs, poses.shape[0])
    n = len(pairs)
    if n == 0:
        raise ValueError(f"no paired frames found in {image_dir} / {depth_image_dir}")
    poses = poses[pose_rows]
    timestamps = timestamps[pose_rows]

    rgb, depth, intrinsics, rgb_size, lbox = _decode_frames(
        pairs, image_dir, depth_image_dir, calibration_dir,
        img_size, depth_width, depth_height, resize_mode, workers,
    )
    if use_cache:
        try:
            scanpack.scanpack_write(pack_path, rgb, depth, intrinsics, rgb_size, poses[:n])
        except OSError as e:
            _log.warning("scan cache write failed (%s) — continuing uncached", e)
        else:
            _write_fingerprint(pack_path, _source_fingerprint(image_dir, depth_image_dir, pairs,
                                                              calibration_dir))
    return Scan(
        rgb=rgb,
        depth=depth,
        intrinsics=intrinsics,
        rgb_size=rgb_size,
        poses=poses[:n],
        timestamps=timestamps[:n],
        letterbox=lbox,
    )
