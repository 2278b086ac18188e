"""Map alignment: register a maintenance scan onto the gold standard (port
of ``tpu3dlm/alignment/align.py``).

    Alignment(base_pose_df, comparison_pose_df, base_bboxes,
              comparison_bboxes, visualise, ...).compare(data_folder)
      → (aligned_comparison_bboxes, transformations, base_map, comparison_map)

``transformations`` is the recorded list of stepwise rigid transforms — a
pure-translation 4×4 (coarse centroid alignment), a rotation tuple when a
principal-axes init is chosen, then every ICP increment — which the
reference's visualiser replays.

``compare`` builds the init candidates on the host, then runs the compare
program (``_compare_program``) on the device: init scoring and selection,
three coarse-to-fine ICP stages (point-to-plane against grid-PCA normals
when the target is a real cloud), the exact final measurement, and the
auction box matching, with ONE readback of its results at the end. Every
exact nearest-neighbour search in it is kernel B2, or B2's plain twin on any
device with ``use_pallas=False`` (the reference's escape hatch from its
kernels, which the Pipeline passes for ``use_pallas = false``). The gold side (normals,
padded target, init subsample, moments) is cached across calls, keyed by
the gold cloud's content.

With a ``mesh`` (``parallel/mesh.py``; every rank of the world calls
``compare`` on the same inputs) the ICP query axis shards over the ranks,
as the reference's ``_place_query`` shards it over its mesh: each stage's
query and the init-scoring subsample are padded to a multiple of the world
size by repeating their first rows (a repeated point only double-counts an
existing constraint) and each rank takes its contiguous block; the target
and its normals replicate. Every NN search stays B2 on the rank's own rows;
every reduction is summed across the ranks (``ops/icp.py``), so all ranks
hold the same transform. The box matching runs on rank 0 alone, which
keeps ``last_match``. The gold and index caches key on the world and on
``use_pallas``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.ops.ann import build_anchor_index, default_index_shape
from tpu3dlm_torch.ops.icp import (
    centroid_align_np,
    icp,
    icp_point_to_plane,
    init_residuals_batched,
    pad_target_bucket,
    pca_init_candidates_np,
    target_moments_np,
)
from tpu3dlm_torch.ops.matching import auction_assign
from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid
from tpu3dlm_torch.parallel.mesh import shard_batch
from tpu3dlm_torch.utils.shapes import next_bucket

# Gold-target cache: in serving every capture registers against the same
# gold cloud through a fresh Alignment, so its normals, padded target, init
# subsample and moments are built once per gold cloud and kept on the
# device (~28 MB at 1M points), keyed by the cloud's content, the device and
# the knobs that shape them. The lock makes get-or-build atomic for
# concurrent captures.
_CACHE_LOCK = threading.Lock()
_GOLD_CACHE: OrderedDict = OrderedDict()
_GOLD_CACHE_MAX = 2

# Anchor-index cache, for the same reason: keyed by the stage target's
# content fingerprint, its padded size, the index shape and the device
# (~67 MB on the device at 1M points, so the LRU stays small). The lock
# above covers it too.
_ANN_INDEX_CACHE: OrderedDict = OrderedDict()
_ANN_CACHE_MAX = 4

# ann="auto" builds the anchor index for stage targets of this many points
ANN_AUTO_MIN_TARGET = 131_072


def _target_fingerprint(x: np.ndarray) -> tuple:
    """Cheap content key for a host point cloud: shape + blake2b over a
    strided ≤4096-row sample, plus f64 sum and sum of squares over all rows
    (an edit between the stride points still moves the moments)."""
    n = x.shape[0]
    sample = np.ascontiguousarray(x[:: max(1, n // 4096)])
    x64 = x.astype(np.float64, copy=False)
    moments = (float(x64.sum()), float((x64 * x64).sum()))
    return (
        n,
        hashlib.blake2b(sample.tobytes(), digest_size=16).digest(),
        moments,
    )


@dataclasses.dataclass
class RegistrationVerdict:
    """Registration-confidence verdict from values the compare program
    already reads back, plus host numpy. Reasons:

      low_overlap          inlier_frac below the floor;
      high_rmse            converged far from the surface;
      box_mismatch         the MAX same-label box-anchor residual under the
                           final transform exceeds the match threshold;
      ambiguous_init       a candidate rotated > 45° from the chosen one
                           scored within ``init_margin_min`` of it, with no
                           box anchors to break the tie;
      degenerate_geometry  near-planar query cloud and no box anchors.
    """

    ok: bool
    reasons: tuple[str, ...]
    rmse: float
    inlier_frac: float
    box_residual_m: float | None  # MEAN anchor residual; None = no boxes
    box_residual_max_m: float | None  # MAX — the box_mismatch signal
    init_margin: float | None  # runner-up/chosen residual ratio (rot>45°)
    planarity: float  # λ_min/λ_max of the query-cloud covariance
    n_anchor_boxes: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _relative_angles_deg(T_cands: np.ndarray, chosen: np.ndarray) -> np.ndarray:
    """Rotation angle (deg) of each candidate relative to the chosen one."""
    R_rel = T_cands[:, :3, :3] @ chosen[:3, :3].T
    cos = (np.trace(R_rel, axis1=1, axis2=2) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _poses_to_array(pose_df) -> np.ndarray:
    """Accept a pandas-like DataFrame (reference shape) or an (F, 7) array."""
    if hasattr(pose_df, "columns"):
        cols = ["tx", "ty", "tz", "qx", "qy", "qz", "qw"]
        return pose_df[cols].to_numpy(dtype=np.float32)
    return np.asarray(pose_df, np.float32)


def _boxes_to_records(bboxes) -> list[dict]:
    """Flatten GlobalBoxes (anything with ``to_frame_dict``) or the
    reference dict-of-frames record shape into
    [{frame, corners (4,3), damage, conf, label}]."""
    records = []
    if hasattr(bboxes, "to_frame_dict"):
        bboxes = bboxes.to_frame_dict()
    for frame, rows in sorted(bboxes.items()):
        for row in rows:
            corners = np.stack([np.asarray(c, np.float32) for c in row[:4]])
            records.append(
                {
                    "frame": int(frame),
                    "corners": corners,
                    "damage": int(row[4]),
                    "conf": float(row[5]),
                    "label": int(row[6]),
                }
            )
    return records


def _records_to_frame_dict(records: list[dict]) -> dict[int, list[list]]:
    out: dict[int, list[list]] = {}
    for r in records:
        out.setdefault(r["frame"], []).append(
            [r["corners"][i] for i in range(4)] + [r["damage"], r["conf"], r["label"]]
        )
    return out


def _pad_box_arrays(records: list[dict]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centroids (Nb, 3), labels (Nb,), mask (Nb,)) padded to the box
    bucket, the padding policy of the auction."""
    n = len(records)
    nb = next_bucket(max(n, 1), 16)
    cent = np.zeros((nb, 3), np.float32)
    lab = np.full((nb,), -1, np.int32)
    mask = np.zeros((nb,), bool)
    for i, r in enumerate(records):
        cent[i] = r["corners"].mean(axis=0)
        lab[i] = r["label"]
        mask[i] = True
    return cent, lab, mask


def _box_anchor_residuals(Ts, bc, bl, bm, cc, cl, cm) -> torch.Tensor:
    """(K,) per candidate transform: the mean over (masked) comparison boxes
    of the distance from the moved centroid to the nearest same-label base
    centroid, or to the nearest base centroid of any label when the label
    is absent on the base side — the device twin of
    ``Alignment._box_residual``."""
    same = (cl[:, None] == bl[None, :]) & bm[None, :]  # (Nc, Nb)
    anyb = bm[None, :].expand_as(same)
    pool = torch.where(same.any(dim=1, keepdim=True), same, anyb)
    Ts = Ts.to(torch.float32)
    moved = cc[None] @ Ts[:, :3, :3].transpose(1, 2) + Ts[:, None, :3, 3]  # (K, Nc, 3)
    d = torch.linalg.vector_norm(bc[None, None, :, :] - moved[:, :, None, :], dim=-1)
    dmin = torch.where(pool[None], d, torch.full_like(d, float("inf"))).min(dim=-1).values
    w = cm.to(torch.float32)
    total = torch.where(cm[None], dmin, torch.zeros_like(dmin)).sum(dim=-1)
    return total / torch.clamp(w.sum(), min=1.0)


def _compare_program(
    T_cands,  # (K, 4, 4) — row 0 = centroid init, rows 1: = PCA candidates
    angles,  # (K-1,) rotation angle (degrees) of each PCA candidate
    score_q,  # (n_score, 3) | None — init-scoring query subsample
    score_t,  # (m_score, 3) | None — init-scoring target subsample
    anchors,  # None | (base_cent, base_lab, base_mask, comp_cent, comp_lab, comp_mask)
    stages,  # per-ICP-stage (query, target, normals|None, AnchorIndex|None)
    match,  # None | (base_cent, base_lab, base_mask, comp_cent, comp_lab, comp_mask, unmatch_cost)
    *,
    global_init: str,
    dists: tuple,
    iterations: int,
    mesh=None,
    use_pallas: bool = True,
) -> dict:
    """The whole compare on the device, the reference's
    ``_fused_compare_program`` as one plain function. The tensors stay on
    the device; the caller reads the dict back once.

    Returns: T, steps, rmse, inlier — always; init_res, init_best,
    init_use_pca — when global_init != "centroid"; match_assign,
    match_matched — when ``match`` is given. Non-final ICP stages skip
    their measurement sweep (the reference's compiler drops it as unused).
    With a ``mesh`` the queries (``score_q`` and each stage's) are this
    rank's rows and the solvers reduce across the ranks. ``use_pallas=False``
    runs every exact search on B2's twin.
    """
    out = {}
    if global_init == "centroid":
        T = T_cands[0]
    else:
        res = init_residuals_batched(score_q, score_t, T_cands, mesh, use_pallas=use_pallas)
        if anchors is not None:
            res = res + _box_anchor_residuals(T_cands, *anchors)
        best = torch.argmin(res[1:])
        if global_init == "pca":
            use_pca = torch.ones((), dtype=torch.bool, device=res.device)
        else:
            # auto: PCA only when it clearly beats centroid AND implies a
            # large rotation (small rotations are already in the ICP basin)
            use_pca = (res[1:][best] < 0.7 * res[0]) & (angles[best] > 30.0)
        T = torch.where(use_pca, T_cands[1:][best], T_cands[0])
        out.update(init_res=res, init_best=best, init_use_pca=use_pca)

    steps = []
    res_icp = None
    for si, ((qj, tj, nj, t_index), d) in enumerate(zip(stages, dists)):
        kw = dict(
            init_transform=T,
            max_correspondence_dist=float(d),
            iterations=iterations,
            target_index=t_index,
            mesh=mesh,
            use_pallas=use_pallas,
            _measure=si == len(stages) - 1,
        )
        if nj is not None:
            res_icp = icp_point_to_plane(qj, tj, nj, **kw)
        else:
            res_icp = icp(qj, tj, **kw)
        steps.append(res_icp.step_transforms)
        T = res_icp.transform
    out.update(T=T, steps=tuple(steps), rmse=res_icp.rmse, inlier=res_icp.inlier_frac)

    if match is not None:
        mb_c, mb_l, mb_m, mc_c, mc_l, mc_m, thr = match
        moved = mc_c @ T[:3, :3].T + T[:3, 3]
        d = torch.linalg.vector_norm(mb_c[:, None, :] - moved[None, :, :], dim=-1)
        ok = (mb_l[:, None] == mc_l[None, :]) & mb_m[:, None] & mc_m[None, :]
        cost = torch.where(ok, d, torch.full_like(d, float("inf")))
        assign, matched = auction_assign(cost, unmatch_cost=thr)
        out.update(match_assign=assign, match_matched=matched)
    return out


def _to_host(tree):
    """dict/tuple of tensors → the same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def _subsample(points: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    if points.shape[0] == 0:
        raise ValueError(
            "cannot subsample an empty point set — the map has no cloud, "
            "poses, or boxes to register with"
        )
    if points.shape[0] <= n:
        reps = -(-n // points.shape[0])
        return np.tile(points, (reps, 1))[:n]
    idx = np.random.default_rng(seed).choice(points.shape[0], n, replace=False)
    return points[idx]


class Alignment:
    """Aligns the comparison (maintenance) map onto the base (gold-std) map.

    The constructor takes the reference's arguments and ``device`` (default
    "cuda"; raises without CUDA unless "cpu" is passed). ``mesh`` (a
    ``parallel.mesh.Mesh``) shards the ICP query axis over its ranks, which
    then run on the mesh's device. ``use_pallas``: None or True run kernel
    B2 on CUDA tensors (its twin on CPU tensors); False runs the twin
    everywhere, the kernel never."""

    def __init__(
        self,
        base_pose_df,
        comparison_pose_df,
        base_bboxes,
        comparison_bboxes,
        visualise: bool = False,
        base_cloud: np.ndarray | None = None,
        comparison_cloud: np.ndarray | None = None,
        max_points: int = 16384,
        icp_iterations: int = 30,
        max_correspondence_dist: float | tuple[float, ...] = (1.0, 0.25, 0.1),
        mesh=None,
        coarse_query_cap: int = 4096,
        coarse_target_cap: int = 262_144,
        global_init: str = "auto",  # "centroid" | "pca" | "auto"
        ann: str = "auto",  # "auto" | "on" | "off" — anchor-bucketed NN
        # when set, the compare program also solves the box assignment at
        # this unmatch threshold (``self.last_match``), so a following
        # BBoxComparison with the same threshold runs no auction
        match_dist_threshold: float | None = 0.5,
        verdict_inlier_floor: float = 0.35,
        verdict_rmse_ceiling: float = 0.08,
        verdict_planarity_floor: float = 1e-4,
        verdict_init_margin_min: float = 1.15,
        use_pallas: bool | None = None,
        device: str | torch.device = "cuda",
    ):
        if global_init not in ("centroid", "pca", "auto"):
            raise ValueError(f"unknown global_init {global_init!r}")
        if ann not in ("auto", "on", "off"):
            raise ValueError(f"unknown ann {ann!r}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.use_pallas = use_pallas is not False
        self.base_poses = _poses_to_array(base_pose_df)
        self.comparison_poses = _poses_to_array(comparison_pose_df)
        self.base_records = _boxes_to_records(base_bboxes)
        self.comparison_records = _boxes_to_records(comparison_bboxes)
        self.visualise = visualise
        self.max_points = max_points
        self.icp_iterations = icp_iterations
        self.max_correspondence_dist = max_correspondence_dist
        self.coarse_query_cap = coarse_query_cap
        self.coarse_target_cap = coarse_target_cap
        self.global_init = global_init
        self.ann = ann
        self.match_dist_threshold = match_dist_threshold
        self.last_match: dict | None = None
        self.verdict_inlier_floor = verdict_inlier_floor
        self.verdict_rmse_ceiling = verdict_rmse_ceiling
        self.verdict_planarity_floor = verdict_planarity_floor
        self.verdict_init_margin_min = verdict_init_margin_min
        self.last_verdict: RegistrationVerdict | None = None
        self.logger = logging.getLogger(__name__)

        # registration point sets: full clouds when available, else the
        # trajectory + box-corner geometry
        self.base_cloud = base_cloud
        self.comparison_cloud = comparison_cloud
        self.transformations: list = []
        self.final_transform = np.eye(4, dtype=np.float32)

    def _registration_sets(self) -> tuple[np.ndarray, np.ndarray]:
        def build(poses, records, cloud):
            if cloud is not None and len(cloud):
                return np.asarray(cloud, np.float32)
            pts = [poses[:, :3]]
            for r in records:
                pts.append(r["corners"])
            return np.concatenate(pts).astype(np.float32)

        base = build(self.base_poses, self.base_records, self.base_cloud)
        comp = build(self.comparison_poses, self.comparison_records, self.comparison_cloud)
        return base, comp

    def _box_residual(self, T: np.ndarray) -> float | None:
        """Mean distance from T·(comparison box centroid) to the nearest
        same-label base box centroid (any label when absent on the base
        side); None when either record set is empty."""
        stats = self._box_residual_stats(T)
        return None if stats is None else stats[0]

    def _box_residual_stats(self, T: np.ndarray) -> tuple[float, float] | None:
        """(mean, max) of the per-box anchor residuals under ``T``: the mean
        ranks init candidates, the MAX feeds box_mismatch (one dissenting
        anchor is enough to distrust a registration)."""
        if not self.base_records or not self.comparison_records:
            return None
        by_label: dict[int, list[np.ndarray]] = {}
        for r in self.base_records:
            by_label.setdefault(r["label"], []).append(r["corners"].mean(0))
        all_base = np.stack([r["corners"].mean(0) for r in self.base_records])
        ds = []
        for r in self.comparison_records:
            c = r["corners"].mean(0) @ T[:3, :3].T + T[:3, 3]
            pool = by_label.get(r["label"])
            pool = np.stack(pool) if pool else all_base
            ds.append(float(np.linalg.norm(pool - c, axis=1).min()))
        return float(np.mean(ds)), float(np.max(ds))

    def _init_candidates(self, comp_s: np.ndarray, base_s: np.ndarray, gold: dict):
        """Host candidate generation: (T_cands (K, 4, 4), angles (K-1,),
        pending). Row 0 is the centroid translation, the rest the
        principal-axes candidates; scoring and choice run in the compare
        program. ``pending`` carries what ``_resolve_init_steps`` needs
        after the readback."""
        moments = gold.get("moments")
        Tc = centroid_align_np(comp_s, base_s, target_moments=moments)
        if self.global_init == "centroid":
            return (
                Tc[None].astype(np.float32),
                np.zeros((0,), np.float32),
                {"static_steps": [Tc]},
            )
        cands = pca_init_candidates_np(comp_s, base_s, target_moments=moments)
        T_cands = np.concatenate([Tc[None], cands]).astype(np.float32)
        cos = (np.trace(cands[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0
        angles = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))).astype(np.float32)
        center = (
            moments[0] if moments is not None else base_s.mean(axis=0)
        ).astype(np.float32)
        pending = {"Tc": Tc, "cands": cands, "angles": angles, "center": center}
        return T_cands, angles, pending

    def _resolve_init_steps(self, pending: dict, host_vals) -> list:
        """Animation-contract init steps from the readback: a pure
        translation, plus an (R, center) rotation tuple when a
        principal-axes init was chosen."""
        if "static_steps" in pending:
            return list(pending["static_steps"])
        res, best, use_pca = host_vals
        best = int(best)
        use_pca = bool(use_pca)
        angle = float(pending["angles"][best])
        self.logger.info(
            "global init: centroid residual %.3f m, best PCA candidate %.3f m "
            "(%.0f° rotation) → %s",
            float(res[0]), float(res[1:][best]), angle,
            "pca" if use_pca else "centroid",
        )
        if not use_pca:
            return [pending["Tc"]]
        T_init = pending["cands"][best].astype(np.float32)
        R, t_full = T_init[:3, :3], T_init[:3, 3]
        center = pending["center"]
        # T_init = rot_about(R, center) ∘ translate(tr): a slide, then a turn
        tr = R.T @ (t_full - center) + center
        T0 = np.eye(4, dtype=np.float32)
        T0[:3, 3] = tr
        return [T0, (R, center)]

    def _place(self, x) -> torch.Tensor | None:
        if x is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)

    def _place_query(self, q: np.ndarray) -> torch.Tensor:
        """Query rows on the device; with a mesh, padded to a multiple of
        the world size by repeating the first rows, then this rank's
        contiguous block."""
        if self.mesh is not None:
            extra = (-q.shape[0]) % self.mesh.size
            if extra:
                q = np.concatenate([q, q[:extra]])
            q = shard_batch(q, self.mesh)
        return self._place(q)

    @property
    def _world_key(self):
        return str(self.device) if self.mesh is None else self.mesh.key

    def _gold_entry(self, base_s: np.ndarray, normals_wanted: bool) -> dict:
        """Fetch-or-build the gold-target state on the device:
          fp      — content fingerprint of the unpadded target
          full    — (padded points, padded normals | None)
          init_t  — 65536-point init-scoring subsample
          moments — f64 moments for the host init candidates
          coarse  — ((points, normals), fp) of the coarse-stage target,
                    filled on first need"""
        fp = _target_fingerprint(base_s)
        key = (fp, self._world_key, self.coarse_target_cap, normals_wanted, self.use_pallas)
        with _CACHE_LOCK:
            entry = _GOLD_CACHE.get(key)
            if entry is not None:
                _GOLD_CACHE.move_to_end(key)
                return entry
            normals_np = estimate_normals_grid(base_s) if normals_wanted else None
            pts, nrm = pad_target_bucket(base_s, normals_np)
            entry = {
                "fp": fp,
                "full": (self._place(pts), self._place(nrm)),
                "init_t": self._place(_subsample(base_s, 65536, seed=1)),
                "moments": target_moments_np(base_s),
                "_normals_np": normals_np,
                "coarse": None,
            }
            _GOLD_CACHE[key] = entry
            while len(_GOLD_CACHE) > _GOLD_CACHE_MAX:
                _GOLD_CACHE.popitem(last=False)
            return entry

    def _gold_coarse(self, entry: dict, base_s: np.ndarray):
        """Coarse-stage target placement, built once per gold entry."""
        with _CACHE_LOCK:
            if entry["coarse"] is None:
                normals_np = entry["_normals_np"]
                if base_s.shape[0] > self.coarse_target_cap:
                    t_idx = np.random.default_rng(1).choice(
                        base_s.shape[0], self.coarse_target_cap, replace=False
                    )
                    t_c = base_s[t_idx]
                    n_c = normals_np[t_idx] if normals_np is not None else None
                    fp_c = _target_fingerprint(t_c)
                else:
                    t_c, n_c, fp_c = base_s, normals_np, entry["fp"]
                pts, nrm = pad_target_bucket(t_c, n_c)
                entry["coarse"] = ((self._place(pts), self._place(nrm)), fp_c)
            return entry["coarse"]

    def _index_for(self, tj: torch.Tensor, fp: tuple):
        """The anchor index over one (padded) stage target, or None: "off"
        never builds one, "auto" only from ``ANN_AUTO_MIN_TARGET`` points,
        and none when the index would have more anchors than points. Built
        once per target content and device and kept across compare calls
        (``fp`` is the unpadded target's fingerprint, which the gold entry
        already carries)."""
        if self.ann == "off":
            return None
        m = int(tj.shape[0])
        if self.ann == "auto" and m < ANN_AUTO_MIN_TARGET:
            return None
        c, b = default_index_shape(m)
        if c > m:
            return None
        key = (fp, m, c, b, self.use_pallas, self._world_key)
        with _CACHE_LOCK:
            index = _ANN_INDEX_CACHE.get(key)
            if index is not None:
                _ANN_INDEX_CACHE.move_to_end(key)
                return index
            index = build_anchor_index(tj, n_anchors=c, bucket_cap=b, use_pallas=self.use_pallas)
            _ANN_INDEX_CACHE[key] = index
            while len(_ANN_INDEX_CACHE) > _ANN_CACHE_MAX:
                _ANN_INDEX_CACHE.popitem(last=False)
            return index

    def compare(self, data_folder: str = ""):
        """Run registration; returns
        (aligned_comparison_bboxes, transformations, base_map, aligned_comparison_map)."""
        base, comp = self._registration_sets()
        # raw (unaligned) registration sets, kept for the animation
        self.base_points = base
        self.comparison_points = comp
        # only the QUERY cloud is subsampled; the target stays at full
        # resolution (kernel B2 streams it)
        base_s = np.asarray(base, np.float32)
        comp_s = _subsample(comp, self.max_points)

        self.logger.info(
            "Aligning %s: %d pts (query subsampled to %d) → %d-pt target",
            data_folder, comp.shape[0], comp_s.shape[0], base.shape[0],
        )

        dists = self.max_correspondence_dist
        if isinstance(dists, (int, float)):
            dists = (float(dists),)
        dists = tuple(float(x) for x in dists)
        use_coarse = len(dists) > 1 and (
            comp_s.shape[0] > self.coarse_query_cap
            or base_s.shape[0] > self.coarse_target_cap
        )

        # point-to-plane needs the target to be the real cloud: sparse
        # pose+corner geometry has no meaningful normals
        base_is_cloud = self.base_cloud is not None and len(self.base_cloud) > 0
        normals_wanted = base_is_cloud and len(base_s) >= 1000
        gold = self._gold_entry(base_s, normals_wanted)

        T_cands, angles, init_pending = self._init_candidates(comp_s, base_s, gold)
        score_q = score_t = None
        if self.global_init != "centroid":
            score_q = self._place_query(_subsample(comp_s, 2048))
            score_t = gold["init_t"]
        box_arrays = None
        if self.base_records and self.comparison_records:
            box_arrays = tuple(
                tuple(torch.as_tensor(a, device=self.device) for a in _pad_box_arrays(recs))
                for recs in (self.base_records, self.comparison_records)
            )
        anchors = None
        if box_arrays is not None and self.global_init != "centroid":
            anchors = (*box_arrays[0], *box_arrays[1])

        # coarse-to-fine stages: the coarse ones on a subsampled query and
        # target, the final one on the full query budget and full target;
        # each distinct stage target gets its anchor index (or None)
        coarse = None
        if use_coarse:
            (tj_c, nj_c), fp_c = self._gold_coarse(gold, base_s)
            q_c = _subsample(comp_s, min(self.coarse_query_cap, comp_s.shape[0]))
            coarse = ((self._place_query(q_c), tj_c, nj_c), fp_c)
        tj_f, nj_f = gold["full"]
        full = ((self._place_query(comp_s), tj_f, nj_f), gold["fp"])
        indices: dict = {}  # id(stage target) → AnchorIndex | None
        stages = []
        for si in range(len(dists)):
            (qj, tj, nj), tgt_fp = full if si == len(dists) - 1 or coarse is None else coarse
            if id(tj) not in indices:
                indices[id(tj)] = self._index_for(tj, tgt_fp)
            stages.append((qj, tj, nj, indices[id(tj)]))

        match_args = None
        on_rank0 = self.mesh is None or self.mesh.rank == 0
        if self.match_dist_threshold is not None and box_arrays is not None and on_rank0:
            match_args = (*box_arrays[0], *box_arrays[1], float(self.match_dist_threshold))

        out = _compare_program(
            self._place(T_cands),
            self._place(angles),
            score_q,
            score_t,
            anchors,
            stages,
            match_args,
            global_init=self.global_init,
            dists=dists,
            iterations=self.icp_iterations,
            mesh=self.mesh,
            use_pallas=self.use_pallas,
        )
        host = _to_host(out)

        init_host = ()
        if "static_steps" not in init_pending:
            init_host = (host["init_res"], host["init_best"], host["init_use_pca"])
        self.transformations = self._resolve_init_steps(init_pending, init_host)
        for steps in host["steps"]:
            self.transformations += [steps[i] for i in range(steps.shape[0])]
        self.final_transform = host["T"]
        self.logger.info(
            "ICP done: rmse=%.4f inliers=%.1f%%",
            float(host["rmse"]), 100 * float(host["inlier"]),
        )
        self.last_verdict = self._registration_verdict(host, T_cands, comp_s, init_pending)
        if not self.last_verdict.ok:
            self.logger.warning(
                "ALIGNMENT SUSPECT (%s): rmse=%.4f inliers=%.2f "
                "box_residual=%s init_margin=%s planarity=%.2e",
                ",".join(self.last_verdict.reasons),
                self.last_verdict.rmse, self.last_verdict.inlier_frac,
                self.last_verdict.box_residual_m,
                self.last_verdict.init_margin, self.last_verdict.planarity,
            )

        self.last_match = None
        if match_args is not None:
            n_real = len(self.base_records)
            m_real = len(self.comparison_records)
            a = host["match_assign"]
            ok = host["match_matched"]
            # trim the bucket padding on both axes: padded rows drop, an
            # assignment to a padded column counts as unmatched
            self.last_match = {
                "assign": np.where(ok & (a < m_real), a, -1)[:n_real].astype(np.int64),
                "threshold": float(self.match_dist_threshold),
                "n": n_real,
                "m": m_real,
            }

        T = self.final_transform
        aligned_records = [
            {**r, "corners": (r["corners"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)}
            for r in self.comparison_records
        ]
        aligned_bboxes = _records_to_frame_dict(aligned_records)
        comp_aligned = comp @ T[:3, :3].T + T[:3, 3]
        return aligned_bboxes, self.transformations, base, comp_aligned

    def _registration_verdict(
        self, host: dict, T_cands: np.ndarray, comp_s: np.ndarray, init_pending: dict,
    ) -> RegistrationVerdict:
        """Build the registration-confidence verdict from the readback and
        host numpy (RegistrationVerdict lists the reasons)."""
        reasons: list[str] = []
        rmse = float(host["rmse"])
        inlier = float(host["inlier"])
        if inlier < self.verdict_inlier_floor:
            reasons.append("low_overlap")
        if rmse > self.verdict_rmse_ceiling:
            reasons.append("high_rmse")

        stats = self._box_residual_stats(self.final_transform)
        box_res = box_max = None
        if stats is not None:
            box_res, box_max = stats
        n_boxes = min(len(self.base_records), len(self.comparison_records))
        thr = self.match_dist_threshold or 0.5
        if box_max is not None and box_max > thr:
            reasons.append("box_mismatch")

        init_margin = None
        if "static_steps" not in init_pending and "init_res" in host:
            res = np.asarray(host["init_res"], np.float64)
            chosen = (
                T_cands[1:][int(host["init_best"])]
                if bool(host["init_use_pca"])
                else T_cands[0]
            )
            rel = _relative_angles_deg(T_cands, np.asarray(chosen))
            chosen_res = float(
                res[1:][int(host["init_best"])]
                if bool(host["init_use_pca"]) else res[0]
            )
            far = rel > 45.0
            if far.any() and chosen_res > 0:
                init_margin = float(res[far].min() / max(chosen_res, 1e-9))
                if init_margin < self.verdict_init_margin_min and n_boxes == 0:
                    reasons.append("ambiguous_init")

        c = comp_s - comp_s.mean(axis=0)
        ev = np.linalg.eigvalsh((c.T @ c) / max(len(c), 1))
        planarity = float(ev[0] / max(ev[-1], 1e-12))
        if n_boxes == 0 and planarity < self.verdict_planarity_floor:
            reasons.append("degenerate_geometry")

        return RegistrationVerdict(
            ok=not reasons,
            reasons=tuple(reasons),
            rmse=rmse,
            inlier_frac=inlier,
            box_residual_m=None if box_res is None else float(box_res),
            box_residual_max_m=None if box_max is None else float(box_max),
            init_margin=init_margin,
            planarity=planarity,
            n_anchor_boxes=n_boxes,
        )
