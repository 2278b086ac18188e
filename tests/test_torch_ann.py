"""The anchor-bucketed NN index (``tpu3dlm_torch/ops/ann.py``) against the
JAX package's ``ops/ann.py`` on the CPU, on the anchors JAX draws
(``jax.random.permutation``, fed into the port through
``sample_anchor_ids``): the index identical (anchors, buckets and ids), the
anchored picks equal (or their d² within 1e-6 m²), ICP with an index within
1e-4 of JAX's transform. The port's own sampler is deterministic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.ops import ann as JANN
from tpu3dlm.ops import icp as JICP
from tpu3dlm_torch.ops import ann as PANN
from tpu3dlm_torch.ops import icp as PICP

torch.set_num_threads(1)


def scan_like_cloud(rng, n):
    """Wall + floor + clutter, the geometry of the JAX package's ANN tests."""
    n_wall, n_floor = n // 2, n // 3
    n_clut = n - n_wall - n_floor
    wall = np.stack([rng.uniform(0, 8, n_wall), rng.normal(0, 0.01, n_wall), rng.uniform(0, 3, n_wall)], -1)
    floor = np.stack([rng.uniform(0, 8, n_floor), rng.uniform(0, 5, n_floor), rng.normal(0, 0.01, n_floor)], -1)
    clut = rng.uniform([0, 0, 0], [8, 5, 3], (n_clut, 3))
    return np.concatenate([wall, floor, clut]).astype(np.float32)


def jax_anchor_ids(m, c, seed=0):
    return torch.from_numpy(np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), m)[:c]).astype(np.int64))


@pytest.fixture
def jax_anchors(monkeypatch):
    """The port's builder draws JAX's anchors."""
    monkeypatch.setattr(PANN, "sample_anchor_ids", jax_anchor_ids)


def both_indices(tgt, c, b):
    j = JANN.build_anchor_index(jnp.asarray(tgt), n_anchors=c, bucket_cap=b)
    p = PANN.build_anchor_index(torch.from_numpy(tgt), n_anchors=c, bucket_cap=b)
    return j, p


def assert_index_identical(p, j):
    for got, want in zip(p, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert p.bucket_ids.dtype == torch.int32 and p.buckets.dtype == torch.float32


def test_default_index_shape_matches_jax():
    for m in [1, 2, 63, 64, 100, 1000, 1024, 8191, 8192, 32768, 65536, 131072, 262144,
              1 << 20, 1 << 21, 1 << 23, 1 << 25]:
        assert PANN.default_index_shape(m) == JANN.default_index_shape(m), m
    assert PANN.default_index_shape(1 << 20) == (8192, 512)
    assert PANN.default_index_shape(262144) == (2048, 512)


def _padded_target(rng):
    pts, _ = PICP.pad_target_bucket(scan_like_cloud(rng, 700))  # 1024 rows, 1e6 sentinels
    return pts


def _cluster_target(rng):
    dense = rng.normal(0, 0.01, (2000, 3)).astype(np.float32)
    sparse = rng.uniform(5, 10, (48, 3)).astype(np.float32)
    return np.concatenate([dense, sparse])


@pytest.mark.parametrize("case,make,shape", [
    ("plain", lambda rng: scan_like_cloud(rng, 4096), None),
    ("sentinel_padded", _padded_target, None),
    ("overflowing_cluster", _cluster_target, (8, 32)),
])
def test_index_identical_from_the_same_anchors(jax_anchors, case, make, shape):
    tgt = make(np.random.default_rng(7))
    c, b = shape or PANN.default_index_shape(tgt.shape[0])
    j, p = both_indices(tgt, c, b)
    assert_index_identical(p, j)
    real = p.buckets[..., 0] < 1e7  # filled slots
    kept = p.bucket_ids[real].long()
    assert torch.equal(p.buckets[real], torch.from_numpy(tgt)[kept])
    if case == "plain":
        assert len(set(kept.tolist())) == tgt.shape[0]  # every point in one bucket
    elif case == "sentinel_padded":  # every real point kept; the 1e6 rows overflow their bucket
        assert set(range(700)) <= set(kept.tolist()) and int(real.sum()) < tgt.shape[0]
    else:
        assert bool(real.all(dim=1).any()) and int(real.sum()) < tgt.shape[0]  # a full bucket dropped points


def test_nn_anchored_matches_jax(jax_anchors):
    """Query count not a multiple of the 4096-query chunk; picks equal, or
    the two d² within 1e-6 m² (a tie in f32)."""
    rng = np.random.default_rng(11)
    tgt = scan_like_cloud(rng, 16384)
    c, b = PANN.default_index_shape(tgt.shape[0])
    j, p = both_indices(tgt, c, b)
    q = (scan_like_cloud(rng, 4099) + rng.normal(0, 0.05, (4099, 3))).astype(np.float32)
    ji, jd2 = (np.asarray(x) for x in JANN.nn_anchored(jnp.asarray(q), j, top_p=4))
    pi, pd2 = PANN.nn_anchored(torch.from_numpy(q), p, top_p=4)
    assert pi.shape == (4099,) and pi.dtype == torch.int64 and pd2.dtype == torch.float32
    pi, pd2 = pi.numpy(), pd2.numpy()
    same = pi == ji
    assert same.mean() >= 0.999
    np.testing.assert_allclose(pd2, jd2, rtol=0, atol=1e-6)
    # every pick is a real target point at the reported distance
    np.testing.assert_allclose(((q - tgt[pi]) ** 2).sum(1), pd2, rtol=1e-5, atol=1e-7)


def _rigid(omega, t):
    from tpu3dlm_torch.ops.geometry import so3_exp

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = so3_exp(torch.tensor(omega, dtype=torch.float32)).numpy()
    T[:3, 3] = t
    return T


@pytest.mark.parametrize("solver", ["point_to_point", "point_to_plane"])
def test_icp_with_index_matches_jax(jax_anchors, solver):
    from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid

    rng = np.random.default_rng(3)
    tgt = scan_like_cloud(rng, 8192)
    T_true = _rigid([0.0, 0.0, 0.06], [0.12, -0.08, 0.04])
    src = ((tgt - T_true[:3, 3]) @ T_true[:3, :3])[::4].copy()
    c, b = PANN.default_index_shape(tgt.shape[0])
    j, p = both_indices(tgt, c, b)
    kw = dict(max_correspondence_dist=0.5, iterations=15)
    if solver == "point_to_point":
        rj = JICP.icp(jnp.asarray(src), jnp.asarray(tgt), target_index=j, **kw)
        rp = PICP.icp(torch.from_numpy(src), torch.from_numpy(tgt), target_index=p, **kw)
    else:
        nrm = estimate_normals_grid(tgt)
        rj = JICP.icp_point_to_plane(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(nrm),
                                     target_index=j, **kw)
        rp = PICP.icp_point_to_plane(torch.from_numpy(src), torch.from_numpy(tgt),
                                     torch.from_numpy(nrm), target_index=p, **kw)
    np.testing.assert_allclose(rp.transform.numpy(), np.asarray(rj.transform), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rp.step_transforms.numpy(), np.asarray(rj.step_transforms), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rp.transform.numpy(), T_true, atol=2e-2)
    assert abs(float(rp.inlier_frac) - float(rj.inlier_frac)) <= 1e-5


def test_icp_measurement_stays_exact(monkeypatch):
    """With an index the iterations call the anchored search and the final
    measurement calls the exact sweep, once."""
    rng = np.random.default_rng(5)
    tgt = torch.from_numpy(scan_like_cloud(rng, 2048))
    index = PANN.build_anchor_index(tgt, 64, 128)
    calls = []
    real_anchored, real_exact = PICP.nn_anchored, PICP.nearest_neighbors
    monkeypatch.setattr(PICP, "nn_anchored", lambda *a, **k: calls.append("anchored") or real_anchored(*a, **k))
    monkeypatch.setattr(PICP, "nearest_neighbors", lambda *a: calls.append("exact") or real_exact(*a))
    PICP.icp(tgt[::4].contiguous(), tgt, iterations=3, early_stop_tol=0.0, target_index=index)
    assert calls == ["anchored"] * 3 + ["exact"]


def test_own_sampler_is_deterministic():
    a = PANN.sample_anchor_ids(100_000, 512, 0)
    assert a.dtype == torch.int64 and a.shape == (512,)
    assert torch.equal(a, PANN.sample_anchor_ids(100_000, 512, 0))
    assert len(set(a.tolist())) == 512 and int(a.min()) >= 0 and int(a.max()) < 100_000
    assert not torch.equal(a, PANN.sample_anchor_ids(100_000, 512, 1))
    tgt = torch.from_numpy(scan_like_cloud(np.random.default_rng(2), 4096))
    first, second = (PANN.build_anchor_index(tgt, 32, 256) for _ in range(2))
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.equal(first.anchors, tgt[PANN.sample_anchor_ids(4096, 32, 0)])


def test_anchor_count_validation():
    with pytest.raises(ValueError, match="n_anchors"):
        PANN.build_anchor_index(torch.zeros(128, 3), n_anchors=256, bucket_cap=16)
