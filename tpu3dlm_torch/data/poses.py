"""RTAB-Map ``poses.txt`` trajectory parser (port of
``tpu3dlm/data/poses.py``).

``load_poses`` is the reference's. The reference's ``poses_to_dataframe``
builds a pandas DataFrame, which the Pipeline pickles; the port has no
pandas, so ``poses_to_frame`` builds a ``PoseFrame``: the same column names
(``timestamp``, ``tx`` … ``qw``) with ``timestamp`` as ``datetime64[ns]``
equal to ``pd.to_datetime(ts, unit="s")``, and the two accessors the
system uses, ``frame[col]`` and ``frame[cols].to_numpy(dtype=...)``.
``PoseDataExtractor`` is the reference's reader class over them.
"""

from __future__ import annotations

import numpy as np

POSE_COLUMNS = ["tx", "ty", "tz", "qx", "qy", "qz", "qw"]


def load_poses(pose_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse poses.txt → (timestamps (F,), poses (F, 7) [tx..qw])."""
    raw = np.loadtxt(pose_path, skiprows=1, dtype=np.float64, ndmin=2)
    if raw.shape[1] == 9:
        raw = raw[:, :8]  # drop trailing id column
    elif raw.shape[1] != 8:
        raise ValueError(
            f"poses.txt must have 8 or 9 columns, got {raw.shape[1]} in {pose_path}"
        )
    timestamps = raw[:, 0]
    poses = raw[:, 1:8].astype(np.float32)
    return timestamps, poses


def seconds_to_datetime64(seconds: np.ndarray) -> np.ndarray:
    """Float seconds → ``datetime64[ns]`` as pandas' ``to_datetime(unit="s")``
    converts them: whole seconds and the fraction rounded to 9 digits are
    scaled apart, then summed in int64."""
    seconds = np.asarray(seconds, np.float64)
    base = seconds.astype(np.int64)
    frac = np.round(seconds - base, 9)
    ns = base * 1_000_000_000 + (frac * 1_000_000_000).astype(np.int64)
    return ns.astype("datetime64[ns]")


class PoseFrame:
    """A small column table with the reference DataFrame's layout."""

    def __init__(self, data: dict[str, np.ndarray]):
        self._data = dict(data)

    @property
    def columns(self) -> list[str]:
        return list(self._data)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._data[key]
        return PoseFrame({k: self._data[k] for k in key})

    def to_numpy(self, dtype=None) -> np.ndarray:
        return np.stack([np.asarray(v, dtype) for v in self._data.values()], axis=1)


def poses_to_frame(timestamps: np.ndarray, poses: np.ndarray) -> PoseFrame:
    """PoseFrame with the reference's column layout (timestamp as datetime)."""
    poses = np.asarray(poses)
    cols = {"timestamp": seconds_to_datetime64(timestamps)}
    cols.update({name: poses[:, i] for i, name in enumerate(POSE_COLUMNS)})
    return PoseFrame(cols)


class PoseDataExtractor:
    """The reference's ``PoseDataExtractor``: ``fetch_data`` → PoseFrame;
    ``plot_pose`` returns the trajectory as a point set ({points}), what
    the reference returns where Open3D is absent (the port opens no
    window)."""

    def __init__(self, pose_path: str):
        self.pose_path = pose_path

    def fetch_data(self) -> PoseFrame:
        return poses_to_frame(*load_poses(self.pose_path))

    def plot_pose(self, df) -> dict:
        from tpu3dlm_torch.utils.visualisation import Visualiser

        return Visualiser().overlay_pose(df)
