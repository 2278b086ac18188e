"""Where the two-rank Pipeline's report distances part from the JAX
package's two-device run (tests/test_torch_parallel_pipeline.py), on the
same ``make_project`` capture and config as that test (3 frames a scan,
800 points/m², the fixture checkpoints, fused route, f32,
``mesh_devices = 2``):

* each run's ICP walk: the live (non-identity) iterations of each stage,
  the first recorded step where the two walks differ, the final transforms'
  gap and both report CSVs;
* every live iteration of JAX's walk replayed from JAX's own transform
  (teacher forcing) on JAX's two devices, on the port's two ranks, on the
  port's one device and in float64 (numpy, a k-d tree for the
  correspondences), with the correspondences each package picks.

    python tests/torch_icp_walk.py [--icp-max-points N] [--icp-iterations N]

The defaults are the config's (16384, 30). Prints one JSON object. Takes
~4 minutes on a CPU; the port's ranks are gloo ranks on the CPU."""

import argparse
import json
import os
import shutil
import sys
import tempfile
import unittest.mock as mock

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2").strip()
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

import torch_parallel_legs as legs  # noqa: E402
from test_torch_pipeline import EXTRA, FIXTURES, two_scans  # noqa: E402
from tpu3dlm.alignment import align as JA  # noqa: E402
from tpu3dlm.ops.icp import icp_point_to_plane as jax_icp  # noqa: E402
from tpu3dlm.ops.pallas.pairwise import nearest_neighbors_xla  # noqa: E402
from tpu3dlm.parallel.mesh import make_mesh  # noqa: E402
from tpu3dlm.pipeline import evaluate  # noqa: E402
from tpu3dlm.pipeline import task as JT  # noqa: E402
from tpu3dlm.utils.config import ConfigLoader as JCfg  # noqa: E402
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors  # noqa: E402
from tpu3dlm_torch.parallel.mesh import spawn_world  # noqa: E402

EYE = np.eye(4, dtype=np.float32)


def gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def live_per_stage(walk, iterations: int) -> list:
    """Live iterations of each stage; ``walk`` is the init step, then
    ``iterations`` increments a stage."""
    incs = walk[1:]
    return [sum(not np.array_equal(x, EYE) for x in incs[s:s + iterations])
            for s in range(0, len(incs), iterations)]


def so3_exp(w):
    th = np.linalg.norm(w)
    if th < 1e-8:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def f64_step(q, t, n, T, d, tree):
    """The point-to-plane iteration (tpu3dlm/ops/icp.py) in float64."""
    T = T.astype(np.float64)
    p = q.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    dist, idx = tree.query(p)
    w = (dist * dist <= d * d).astype(np.float64)
    qq, nn = t[idx].astype(np.float64), n[idx].astype(np.float64)
    J = np.concatenate([np.cross(p, nn), nn], -1)
    H, g = (J * w[:, None]).T @ J, (J * w[:, None]).T @ ((p - qq) * nn).sum(-1)
    z = np.zeros(len(p))
    skew = np.stack([np.stack([z, -p[:, 2], p[:, 1]], -1), np.stack([p[:, 2], z, -p[:, 0]], -1),
                     np.stack([-p[:, 1], p[:, 0], z], -1)], 1)
    Jp = np.concatenate([-skew, np.broadcast_to(np.eye(3), skew.shape)], 2)
    H = H + 0.1 * np.einsum("nij,nik->jk", Jp * w[:, None, None], Jp)
    g = g + 0.1 * np.einsum("nij,ni->j", Jp * w[:, None, None], p - qq)
    xi = np.linalg.solve(H + (1e-6 * np.trace(H) + 1e-12) * np.eye(6), -g)
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = so3_exp(xi[:3]), xi[3:]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--icp-max-points", type=int, default=16384)
    ap.add_argument("--icp-iterations", type=int, default=30)
    args = ap.parse_args()
    torch.set_num_threads(1)
    work = tempfile.mkdtemp(prefix="icp_walk_")
    try:
        cut = [("icp_max_points = 16384", f"icp_max_points = {args.icp_max_points}"),
               ("icp_iterations = 30", f"icp_iterations = {args.icp_iterations}")]
        cfg_jax, _, _, _ = evaluate.make_project(
            os.path.join(work, "jax"), os.path.join(FIXTURES, "yolo_synthetic.msgpack"),
            os.path.join(FIXTURES, "beit_synthetic.msgpack"),
            extra_cfg=EXTRA + [("mesh_devices = 1", "mesh_devices = 2")] + cut, num_frames=3,
            cloud_points_per_m2=800)
        shutil.copytree(os.path.join(work, "jax", "configs"), os.path.join(work, "port", "configs"))
        cfg_port = os.path.join(work, "port", "configs", "variables.cfg")

        cap = {}
        real_program, real_compare = JA._fused_compare_program, JA.Alignment.compare

        def program(T_cands, angles, score_q, score_t, anchors, stages, match, **kw):
            out = real_program(T_cands, angles, score_q, score_t, anchors, stages, match, **kw)
            cap.update(T_cands=np.asarray(T_cands), kw=kw, out=jax.device_get(out),
                       stages=[(np.asarray(q), np.asarray(t), np.asarray(n), float(d))
                               for (q, t, n, _), d in zip(stages, kw["dists"])])
            return out

        def compare(self, *a, **kw):
            out = real_compare(self, *a, **kw)
            cap["walk"] = [np.asarray(s) for s in self.transformations]
            cap["final"] = np.asarray(self.final_transform)
            return out

        with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None), \
                mock.patch.object(JA, "_fused_compare_program", program), \
                mock.patch.object(JA.Alignment, "compare", compare):
            jax_runs = two_scans(cfg_jax, JT, JCfg)
        jax_csv = open(jax_runs[1].cfg.csv_output).read()

        # JAX's walk, live iterations only, each with the transform it started from
        out, kw = cap["out"], cap["kw"]
        T = cap["T_cands"][1 + int(out["init_best"])] if bool(out["init_use_pca"]) else cap["T_cands"][0]
        T = np.asarray(T, np.float32)
        starts, jax_fused = [], []
        for s, incs in enumerate(out["steps"]):
            for inc in np.asarray(incs):
                if np.array_equal(inc, EYE):
                    break
                starts.append((s, T.copy()))
                jax_fused.append(inc)
                T = (inc @ T).astype(np.float32)

        with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
            todo = {"pipeline_walk": dict(argv=["--data", "maintenance", "--config", cfg_port, "--device", "cpu"]),
                    "icp_steps": dict(stages=cap["stages"], starts=starts)}
            ranks = spawn_world(legs.run, 2, device="cpu", args=(todo,))
        port_walk, port_final = ranks[0]["pipeline_walk"]["walks"][0]
        port = ranks[0]["icp_steps"]

        mesh = make_mesh(2)
        shard = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(mesh.axis_names[0]))
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        step = jax.jit(lambda q, t, n, T0, d: jax_icp(q, t, n, init_transform=T0, max_correspondence_dist=d,
                                                       iterations=1, early_stop_tol=0.0).step_transforms[0],
                       static_argnums=4)
        moved = jax.jit(lambda q, T0: jnp.matmul(q, T0[:3, :3].T, precision=jax.lax.Precision.HIGHEST) + T0[:3, 3])
        trees, replay = {}, []
        for i, (s, T0) in enumerate(starts):
            q, t, n, d = cap["stages"][s]
            j2 = np.asarray(step(jax.device_put(q, shard), jax.device_put(t, repl), jax.device_put(n, repl),
                                 jnp.asarray(T0), d))
            f64 = f64_step(q, t, n, T0, d, trees.setdefault(s, cKDTree(t.astype(np.float64))))
            mj = np.asarray(moved(q, T0))
            ij, dj = (np.asarray(x) for x in nearest_neighbors_xla(jnp.asarray(mj), jnp.asarray(t)))
            mp = torch.from_numpy(q.copy()) @ torch.from_numpy(T0)[:3, :3].T + torch.from_numpy(T0)[:3, 3]
            ip, dp = (x.numpy() for x in nearest_neighbors(mp, torch.from_numpy(t.copy())))
            p2 = port["world"][i]
            replay.append(dict(
                stage=s, jax2_port2=gap(j2, p2), port2_port1=gap(p2, port["one"][i]), jax2_f64=gap(j2, f64),
                port2_f64=gap(p2, f64), jax_fused_jax2=gap(jax_fused[i], j2),
                moved_rows_apart=int((mj != mp.numpy()).any(1).sum()), picks_apart=int((ij != ip).sum()),
                inliers_apart=int(((dj <= d * d) != (dp <= d * d)).sum())))

        walk_gaps = [gap(a, b) for a, b in zip(cap["walk"], port_walk)]
        same = [r for r in replay if r["picks_apart"] == 0]
        apart = [r for r in replay if r["picks_apart"] > 0]
        it = args.icp_iterations
        print(json.dumps(dict(
            icp_max_points=args.icp_max_points, icp_iterations=it, dists=list(kw["dists"]),
            query_rows=[int(q.shape[0]) for q, *_ in cap["stages"]],
            csv=dict(jax=jax_csv.splitlines(), port=ranks[0]["pipeline_walk"]["csv"].splitlines()),
            live_iterations=dict(jax=live_per_stage(cap["walk"], it), port=live_per_stage(port_walk, it)),
            first_step_apart=next((i for i, g in enumerate(walk_gaps) if g > 0), None),
            first_step_apart_by_1e6=next((i for i, g in enumerate(walk_gaps) if g > 1e-6), None),
            step_gaps_first_four=walk_gaps[:4], final_transform_gap=gap(cap["final"], port_final),
            ranks_agree=all(np.array_equal(a, b) for a, b in zip(ranks[0]["icp_steps"]["world"],
                                                                ranks[1]["icp_steps"]["world"])),
            replay=dict(live_steps=len(replay), same_picks=len(same),
                        same_picks_max_jax2_port2=max((r["jax2_port2"] for r in same), default=None),
                        picks_apart=[(r["stage"], r["picks_apart"], r["jax2_port2"]) for r in apart],
                        max_inliers_apart=max(r["inliers_apart"] for r in replay),
                        max_moved_rows_apart=max(r["moved_rows_apart"] for r in replay),
                        max_port2_port1=max(r["port2_port1"] for r in replay),
                        median_jax2_f64=float(np.median([r["jax2_f64"] for r in replay])),
                        median_port2_f64=float(np.median([r["port2_f64"] for r in replay])),
                        max_jax_fused_jax2=max(r["jax_fused_jax2"] for r in replay)),
        )))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
