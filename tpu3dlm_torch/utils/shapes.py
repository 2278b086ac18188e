"""Shape bucketing helpers (port of ``tpu3dlm/utils/shapes.py``).

The JAX package pads per-capture axes to buckets so that a serving process
compiles one program per bucket. PyTorch runs eagerly and needs no bucket
for that, but the fused runner still pads the frame axis exactly as the
reference does, so that crop selection and every output match it, and the
staged route runs fixed-size batches; these are the same helpers, kept
here so the port imports nothing of tpu3dlm.
"""

from __future__ import annotations

import numpy as np


def next_bucket(n: int, min_bucket: int = 8, quarter_from: int = 64) -> int:
    """Smallest bucket ≥ n from {min_bucket·2^k} ∪ quarter-octave steps.

    Below ``quarter_from`` buckets are powers of two of ``min_bucket``;
    above it, quarter-octave steps {1, 1.25, 1.5, 1.75}·2^k cap the padding
    at 25%.
    """
    if n <= min_bucket:
        return min_bucket
    p = 1 << (n - 1).bit_length()  # next power of two ≥ n
    if p <= quarter_from:
        return p
    half = p // 2  # always < n
    for q in (1, 2, 3):
        c = half + (half * q) // 4
        if c >= n:
            return c
    return p


def pad_axis0(x, size: int, fill=0) -> np.ndarray:
    """Pad a numpy array along axis 0 to ``size`` with ``fill``."""
    x = np.asarray(x)
    if x.shape[0] >= size:
        return x
    pad = np.full((size - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0)


def padded_batches(arrays, batch: int):
    """Iterate axis 0 of ``arrays`` in fixed ``batch``-size chunks, the
    ragged tail zero-padded, so every call downstream sees one shape (the
    staged route's detector and classifier batches, and with them kernel
    B1's launch shape). Yields ``(chunk_list, start, n_valid)``; callers
    keep the first ``n_valid`` rows. Yields nothing for empty arrays."""
    n = arrays[0].shape[0]
    for start in range(0, n, batch):
        yield [pad_axis0(a[start:start + batch], batch) for a in arrays], start, min(batch, n - start)


def pad_poses(poses, size: int) -> np.ndarray:
    """Pad (F, 7) xyz+quat poses to ``size`` frames with IDENTITY poses
    (zero translation, qw = 1): a zero quaternion normalises to NaN."""
    poses = np.asarray(poses)
    if poses.shape[0] >= size:
        return poses
    pad = np.zeros((size - poses.shape[0],) + poses.shape[1:], poses.dtype)
    pad[:, 6] = 1.0
    return np.concatenate([poses, pad], axis=0)
