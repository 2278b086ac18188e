"""ICP registration (port of ``tpu3dlm/ops/icp.py``).

Point-to-point and hybrid point-to-plane ICP with per-iteration increments
recorded for the animation contract, the batched init scoring, and the host
numpy helpers that build init candidates and pad targets to power-of-two
buckets; ``rotation_about`` builds the (R, center) steps the animation
replays. Every correspondence search is kernel B2
(``ops/kernels/pairwise.nearest_neighbors``), except the iterations of a
solve given an anchor index (``target_index``, ``ops/ann.py``), which use
the anchored search; the measurement pass stays on B2 either way.

The reference runs each solver as one ``lax.scan`` whose iterations turn
into identity increments once converged (``lax.cond`` skips the NN sweep).
Here the loop runs eagerly: after each iteration the host reads one scalar,
whether the increment fell below ``early_stop_tol``, and from then on
appends identity increments without sweeping. The tensors stay on the
device of the inputs; only that flag crosses to the host.

Query-sharded (``mesh``, a ``parallel.mesh.Mesh``): each rank passes its
own rows of the source (the init scoring's queries likewise) and the whole
target; every reduction over the source rows (the Kabsch means and
covariance, the 6×6 normal equations, the measurement's sums, the init
residuals) is the rank's local sum plus an ``all_reduce``, so every rank
solves the same system and holds the same transform.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tpu3dlm_torch.ops.ann import AnchorIndex, nn_anchored
from tpu3dlm_torch.ops.geometry import so3_exp
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors


def _total(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, summed over the ranks when a mesh is given."""
    return x if mesh is None else mesh.all_reduce(x)


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor, mesh=None) -> torch.Tensor:
    """Weighted rigid solve: the 4×4 T minimising Σ w‖T·src − dst‖², with
    the reflection guard. With a ``mesh`` the rows are this rank's and the
    sums run over every rank's."""
    w = weights / torch.clamp(_total(weights.sum(), mesh), min=1e-12)
    mu_s = (src * w[:, None]).sum(0)
    mu_d = (dst * w[:, None]).sum(0)
    if mesh is not None:
        mu_s, mu_d = mesh.all_reduce(torch.stack([mu_s, mu_d]))
    sc = src - mu_s
    dc = dst - mu_d
    H = _total((sc * w[:, None]).T @ dc, mesh)  # (3, 3) covariance
    U, _, Vh = torch.linalg.svd(H)
    det = torch.linalg.det(Vh.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = Vh.T @ D @ U.T
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


@dataclasses.dataclass
class ICPResult:
    transform: Any  # (4, 4) final source→destination transform
    step_transforms: Any  # (iters, 4, 4) incremental transform per iteration
    rmse: Any  # () final inlier RMSE; None when the measurement was skipped
    inlier_frac: Any  # () fraction of source points within max_dist; None likewise


def _increment_magnitude(T_inc: torch.Tensor) -> torch.Tensor:
    """Scalar size of a rigid increment: |t| + rotation angle (radians)."""
    cos = torch.clamp((torch.trace(T_inc[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return torch.linalg.vector_norm(T_inc[:3, 3]) + torch.arccos(cos)


def _run_icp_loop(
    live_inc: Callable, measure: Callable | None, T0: torch.Tensor, iterations: int,
    early_stop_tol: float,
) -> ICPResult:
    """Shared loop of both solvers: ``iterations`` increments, identity
    once converged (no NN sweep), then ONE measurement pass under the final
    transform (``measure`` reports rmse = inf when nothing matches). With
    ``measure=None`` the pass is skipped and rmse/inlier_frac are None."""
    eye = torch.eye(4, dtype=torch.float32, device=T0.device)
    T = T0
    incs = []
    done = False
    for _ in range(iterations):
        if done:
            incs.append(eye)
            continue
        T_inc = live_inc(T)
        T = T_inc @ T
        incs.append(T_inc)
        # a tolerance ≤ 0 never stops the loop, so the flag needs no read
        if early_stop_tol > 0:
            done = bool(_increment_magnitude(T_inc) < early_stop_tol)
    rmse = frac = None
    if measure is not None:
        rmse, frac = measure(T)
    return ICPResult(transform=T, step_transforms=torch.stack(incs), rmse=rmse, inlier_frac=frac)


def _moved(src: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return src @ T[:3, :3].T + T[:3, 3]


def _iteration_nn(target_index: AnchorIndex | None, ann_top_p: int) -> Callable:
    """The per-iteration correspondence search: the anchored search when
    an index over the target is given, else kernel B2. (The measurement
    pass always calls B2.)"""
    if target_index is None:
        return nearest_neighbors
    return lambda q, _tgt: nn_anchored(q, target_index, top_p=ann_top_p)


def _init_T(init_transform, like: torch.Tensor) -> torch.Tensor:
    if init_transform is None:
        return torch.eye(4, dtype=torch.float32, device=like.device)
    return init_transform.to(torch.float32)


def _measurement(w: torch.Tensor, sq: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(rmse of the squared residuals ``sq`` over the inliers ``w`` — inf
    when none — and the inlier fraction), over every rank's rows."""
    if mesh is None:
        sw, num, frac = w.sum(), (sq * w).sum(), w.mean()
    else:
        sw, num = mesh.all_reduce(torch.stack([w.sum(), (sq * w).sum()]))
        frac = sw / (w.shape[0] * mesh.size)
    rmse = torch.where(
        sw > 0, torch.sqrt(num / torch.clamp(sw, min=1.0)), torch.full_like(sw, float("inf")),
    )
    return rmse, frac


def icp(
    source: torch.Tensor,  # (N, 3) — cloud to move
    target: torch.Tensor,  # (M, 3) — fixed cloud
    init_transform: torch.Tensor | None = None,
    max_correspondence_dist: float = 0.5,
    iterations: int = 20,
    early_stop_tol: float = 1e-5,
    target_index: AnchorIndex | None = None,
    ann_top_p: int = 4,
    mesh=None,
    *,
    _measure: bool = True,
) -> ICPResult:
    """Rigid point-to-point ICP: final transform + per-iteration increments.

    ``early_stop_tol``: once an increment (|t| + angle) falls below it, the
    remaining iterations record identity increments and skip the NN sweep;
    0 disables. ``target_index``: an ``ops.ann.AnchorIndex`` over
    ``target``; the iterations then use the anchored search over the top
    ``ann_top_p`` buckets, and the measurement stays exact.
    ``mesh``: ``source`` is this rank's rows (the module docstring).
    ``_measure=False`` skips the final measurement sweep (the compare
    program's non-final stages, whose rmse nobody reads)."""
    src0 = source.to(torch.float32)
    tgt = target.to(torch.float32)
    max_d2 = max_correspondence_dist ** 2
    nn = _iteration_nn(target_index, ann_top_p)

    def live_inc(T):
        moved = _moved(src0, T)
        idx, d2 = nn(moved, tgt)
        w = (d2 <= max_d2).to(torch.float32)
        return kabsch(moved, tgt[idx], w, mesh)

    def measure(T):
        _, d2 = nearest_neighbors(_moved(src0, T), tgt)
        w = (d2 <= max_d2).to(torch.float32)
        return _measurement(w, d2, mesh)

    return _run_icp_loop(
        live_inc, measure if _measure else None, _init_T(init_transform, src0), iterations,
        early_stop_tol,
    )


def icp_point_to_plane(
    source: torch.Tensor,  # (N, 3) — cloud to move
    target: torch.Tensor,  # (M, 3) — fixed cloud
    target_normals: torch.Tensor,  # (M, 3) unit normals (ops/pointcloud.py)
    init_transform: torch.Tensor | None = None,
    max_correspondence_dist: float = 0.5,
    iterations: int = 20,
    damping: float = 1e-6,
    point_weight: float = 0.1,
    early_stop_tol: float = 1e-5,
    target_index: AnchorIndex | None = None,
    ann_top_p: int = 4,
    mesh=None,
    *,
    _measure: bool = True,
) -> ICPResult:
    """Hybrid plane+point ICP (Gauss-Newton on the linearised SE(3) step).

    The plane residual n·(p−q) cannot slide along the dominant planes of
    man-made scenes; a small ``point_weight``·‖p−q‖² term pins the
    plane-parallel directions. Per iteration: NN correspondences (kernel
    B2), a damped 6×6 normal-equation solve over both residuals
    (``solve_ex``: no hidden host sync), increment exp(ω) and t composed
    onto T. ``target_index``, ``ann_top_p``, ``mesh`` and ``_measure`` as in
    ``icp``; rmse is the plane residual's."""
    src0 = source.to(torch.float32)
    tgt = target.to(torch.float32)
    nrm = target_normals.to(torch.float32)
    max_d2 = max_correspondence_dist ** 2
    nn = _iteration_nn(target_index, ann_top_p)
    dev = src0.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def live_inc(T):
        moved = _moved(src0, T)
        idx, d2 = nn(moved, tgt)
        q = tgt[idx]
        n = nrm[idx]
        w = (d2 <= max_d2).to(torch.float32)

        # plane term: r = n·(p−q), J row = [(p×n)ᵀ nᵀ]
        r = ((moved - q) * n).sum(-1)  # (N,)
        J = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J  # (6, 6)
        g = Jw.T @ r  # (6,)

        # point term: e = p−q (3 rows/corr), J = [−[p]×  I]
        e = moved - q
        Z = torch.zeros_like(moved[:, 0])
        px, py, pz = moved.unbind(1)
        skew = torch.stack([
            torch.stack([Z, -pz, py], -1),
            torch.stack([pz, Z, -px], -1),
            torch.stack([-py, px, Z], -1),
        ], dim=1)  # (N, 3, 3) = [p]×
        Jp = torch.cat([-skew, eye3.expand_as(skew)], dim=2)  # (N, 3, 6)
        Jpw = Jp * w[:, None, None]
        Hp = torch.einsum("nij,nik->jk", Jpw, Jp)
        gp = torch.einsum("nij,ni->j", Jpw, e)
        if mesh is not None:
            # each term summed over the ranks, then combined as on one device
            parts = mesh.all_reduce(torch.cat([H.reshape(-1), g, Hp.reshape(-1), gp]))
            H, g, Hp, gp = parts[:36].view(6, 6), parts[36:42], parts[42:78].view(6, 6), parts[78:]
        H = H + point_weight * Hp
        g = g + point_weight * gp

        lam = damping * torch.trace(H) + 1e-12
        xi = torch.linalg.solve_ex(H + lam * eye6, -g).result
        T_inc = torch.eye(4, dtype=torch.float32, device=dev)
        T_inc[:3, :3] = so3_exp(xi[:3])
        T_inc[:3, 3] = xi[3:]
        return T_inc

    def measure(T):
        moved = _moved(src0, T)
        idx, d2 = nearest_neighbors(moved, tgt)
        r = ((moved - tgt[idx]) * nrm[idx]).sum(-1)
        w = (d2 <= max_d2).to(torch.float32)
        return _measurement(w, r * r, mesh)

    return _run_icp_loop(
        live_inc, measure if _measure else None, _init_T(init_transform, src0), iterations,
        early_stop_tol,
    )


def init_residuals_batched(
    source: torch.Tensor,  # (N, 3)
    target: torch.Tensor,  # (M, 3)
    Ts: torch.Tensor,  # (K, 4, 4) candidate inits
    mesh=None,
) -> torch.Tensor:
    """(K,) clipped-mean NN distance of each T·source into target, in ONE
    NN sweep over the K·N stacked queries. The clip (5% of the target bbox
    diagonal) bounds the non-overlapping tail of partial scans. With a
    ``mesh`` ``source`` is this rank's rows and the means run over every
    rank's."""
    tgt = target.to(torch.float32)
    src = source.to(torch.float32)
    Ts = Ts.to(torch.float32)
    moved = src[None] @ Ts[:, :3, :3].transpose(1, 2) + Ts[:, None, :3, 3]  # (K, N, 3)
    _, d2 = nearest_neighbors(moved.reshape(-1, 3), tgt)
    diag = torch.linalg.vector_norm(tgt.max(0).values - tgt.min(0).values)
    clipped = torch.minimum(torch.sqrt(d2), 0.05 * diag).reshape(Ts.shape[0], -1)
    if mesh is None:
        return clipped.mean(1)
    return mesh.all_reduce(clipped.sum(1)) / (clipped.shape[1] * mesh.size)


# Host numpy, copied from the reference so the same seeds give the same
# subsets and the same init candidates.

# above this size the moment math runs on a fixed-seed with-replacement
# subsample (sub-mm centroid error on scan-scale clouds; both feed inits
# that ICP refines)
_MOMENT_SAMPLE_CAP = 262144


def _moment_sample(x, cap: int = _MOMENT_SAMPLE_CAP, seed: int = 0):
    x = np.asarray(x)
    if x.shape[0] <= cap:
        return x
    idx = np.random.default_rng(seed).integers(0, x.shape[0], cap)
    return x[idx]


def target_moments_np(target):
    """(mu, C) f64 moments of the (``_moment_sample``-subsampled) cloud, as
    ``centroid_align_np`` / ``pca_init_candidates_np`` derive them; cached
    once per gold cloud by the alignment."""
    t = np.asarray(_moment_sample(target), np.float64)
    mu = t.mean(axis=0)
    tc = t - mu
    return mu, tc.T @ tc / t.shape[0]


def centroid_align_np(source, target, target_moments=None):
    """4×4 pure translation moving the source centroid onto the target's."""
    mu_t = (
        target_moments[0]
        if target_moments is not None
        else np.mean(np.asarray(_moment_sample(target), np.float64), axis=0)
    )
    t = mu_t - np.mean(np.asarray(_moment_sample(source), np.float64), axis=0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t.astype(np.float32)
    return T


def pca_init_candidates_np(source, target, target_moments=None):
    """(4, 4, 4) principal-axes init candidates: the four proper rotations
    of the eigenvector sign ambiguity, centroid translation composed in."""
    src = np.asarray(_moment_sample(source), np.float64)
    mu_s = src.mean(axis=0)
    sc = src - mu_s
    Cs = sc.T @ sc / src.shape[0]
    if target_moments is not None:
        mu_t, Ct = target_moments
    else:
        mu_t, Ct = target_moments_np(target)
    _, Vs = np.linalg.eigh(Cs)
    _, Vt = np.linalg.eigh(Ct)
    Vs[:, 0] *= np.sign(np.linalg.det(Vs)) or 1.0
    Vt[:, 0] *= np.sign(np.linalg.det(Vt)) or 1.0
    signs = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float64)
    out = np.empty((4, 4, 4), np.float32)
    for i, s in enumerate(signs):
        R = Vt @ np.diag(s) @ Vs.T
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R
        T[:3, 3] = mu_t - R @ mu_s
        out[i] = T.astype(np.float32)
    return out


# Targets are padded to a power-of-two bucket with far sentinels. That is
# exact for the solve: a sentinel is never a query's nearest neighbour while
# a real point lies within the correspondence radius.
PAD_SENTINEL = 1.0e6


def target_bucket(m: int, min_bucket: int = 1024) -> int:
    """The padded size of an m-point target: the next power of two."""
    return max(min_bucket, 1 << (max(m - 1, 1)).bit_length())


def pad_target_bucket(points, normals=None, min_bucket: int = 1024):
    """(padded_points, padded_normals) at ``target_bucket`` size; normals
    pass through None."""
    m = points.shape[0]
    bucket = target_bucket(m, min_bucket)
    if bucket == m:
        return points, normals
    pad = np.full((bucket - m, 3), PAD_SENTINEL, points.dtype)
    out = np.concatenate([points, pad])
    if normals is None:
        return out, None
    npad = np.zeros((bucket - m, 3), normals.dtype)
    npad[:, 2] = 1.0
    return out, np.concatenate([normals, npad])


def rotation_about(R: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """4×4 rotating by R about a fixed point (t = c − R·c), on R's device."""
    T = torch.eye(4, dtype=torch.float32, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = center - R @ center
    return T
