"""Pipeline orchestrator (port of ``tpu3dlm/pipeline/task.py``).

``Pipeline(data_folder, cfg, cfg_goldstd, goldstd_var, device).run()``
follows the reference's order: extract (``ImageExtractor`` when the
database exists, then ``load_scan``) → detect + classify → map (pose table,
projection, 3D NMS) → atomic pickle of the intermediates under the
reference's keys → with a gold-standard baseline, the maintenance compare
(``Alignment`` + ``BBoxComparison``). Detection takes the route the config
selects: ``fused_inference = false`` (the default) the staged route,
``ObjectDetector`` then ``DamageDetector`` (every valid box classified),
with the map stage projecting the detections; ``fused_inference = true``
the fused step (``FusedScanRunner``, the top ``crop_budget`` boxes
classified, projection inside the step). With ``streaming_chunk > 0`` on
the fused route, extract only indexes the capture and detect streams it in
chunks of that many frames (``iter_scan_chunks`` → ``FusedScanRunner.
run_stream``), so host memory stays bounded by the chunk; under the staged
route ``streaming_chunk`` is ignored with a warning, as in the reference.
``scan_cache = true`` serves the decoded capture from its scanpack on both
routes. ``resume=True`` reuses the pickled detections and re-projects them
(ignored under streaming, which keeps no frames to re-project). Weights
come from a JAX-package ``.msgpack``, a torch ``.pt`` (ultralytics YOLOv10,
HF BEiT) or a ``.safetensors`` file, or are seeded when the path is empty.
With ``visualise = true`` the run writes the 3D map, ``map_mesh.ply`` next
to the cloud, after the pickle: ``mesh_source = tsdf`` fuses the scan's
depth frames on the device (``mapper/meshing.py::mesh_scan``), ``cloud``
meshes ``cloud.ply`` through ``Mapping.make_mesh`` with the ``mesher`` the
config names (``density`` or ``poisson``), both at ``mesh_voxel``; a
streamed run keeps no frames and skips the map with a warning, as the
reference does. Per-stage wall-clock lands in ``stage_times`` (extract,
detect, map, plot, compare).

``beit_quant = int8`` serves the int8 classifier on every route: the
checkpoint (or the seeded draw) is loaded as float, then quantised
(``quantize_beit_variables`` on a Flax tree, ``quantize_beit`` on a module),
as the reference does.

The views of a run follow the reference. ``view_img = true`` writes each
frame with its boxes and class labels drawn to ``processing_path`` as
``image_<f>.png`` on the staged route (``ObjectDetector(save_img=...)``);
the fused route ignores it, as the reference's does. ``alignment_vis =
true`` replays the maintenance registration from the raw comparison points
into ``alignment_animation.mp4`` (or ``.npz`` without an mp4 encoder)
beside the report (``alignment/visualise.py``). ``comparison_vis`` goes to
``BBoxComparison`` and changes nothing, as in the reference. None of them
changes the report.

``mesh_devices = n > 1`` runs the Pipeline on every rank of a running
world of n ranks (``parallel/mesh.py``; ``python -m tpu3dlm_torch.cli``
starts them): every rank reads the capture (rank 0 alone first extracts
the database and writes the scanpack), the fused route shards its frames
(``FusedScanRunner(mesh_devices=n)``), the staged route ignores the mesh
for detection as the reference does, and the compare shards its ICP
queries (``Alignment(mesh=...)``). Rank 0 alone writes the pickle, the
CSV, the map and the views; ``run`` returns on every rank once they are
written. Without a world of n ranks the Pipeline raises ``ValueError``.
A ``mesh`` given to the Pipeline (the watcher's, ``pipeline/watch.py``)
is used in place of the world's own, at its size, which must be
``mesh_devices``: a 1-rank world runs the sharded paths at world 1.

``use_pallas = false`` is the reference's escape hatch from its kernels,
and the port's: the compare runs every nearest-neighbour search on the
plain twin (``Alignment(use_pallas=False)``) and BEiT takes the reference's
einsum attention (``attn_impl = "einsum"``), on every route and device, so
neither kernel B1 nor B2 is launched. ``icp_ann`` goes to ``Alignment`` as
is.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import threading
import time

import numpy as np
import torch

from tpu3dlm_torch.alignment.align import Alignment
from tpu3dlm_torch.alignment.comparison import BBoxComparison
from tpu3dlm_torch.data.dataset import _pair_filenames, _pose_rows_for_pairs, iter_scan_chunks, load_scan
from tpu3dlm_torch.data.poses import load_poses, poses_to_frame
from tpu3dlm_torch.data.rtabmap_db import ImageExtractor
from tpu3dlm_torch.data.scan import Detections, Scan, detections_from_frame_dict
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.mapper.nms3d import suppress_bboxes
from tpu3dlm_torch.mapper.projection import project_detections
from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig, quantize_beit, seeded_beit
from tpu3dlm_torch.models.layers import init_seeded_
from tpu3dlm_torch.models.yolov10 import YOLOv10
from tpu3dlm_torch.parallel.mesh import make_mesh

_WEIGHTS: dict = {}
_WEIGHTS_LOCK = threading.Lock()


def _cached_weights(key, builder):
    """Port modules on their device, shared across Pipeline instances: a
    two-scan run reads and converts each checkpoint once. The key holds the
    kind, the absolute path and mtime, the model config, the device and the
    dtype, so an updated file or another shape misses."""
    with _WEIGHTS_LOCK:
        if key not in _WEIGHTS:
            _WEIGHTS[key] = builder()
        return _WEIGHTS[key]


class Pipeline:
    def __init__(self, data_folder, cfg, cfg_goldstd=None, goldstd_var=None,
                 device: str | torch.device = "cuda", mesh=None):
        n = getattr(cfg, "mesh_devices", 1)
        if mesh is not None and mesh.size != n:
            raise ValueError(f"the Pipeline's mesh has {mesh.size} ranks, the config's mesh_devices is {n}")
        self.mesh = mesh if mesh is not None else (make_mesh(n, device=device) if n > 1 else None)
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.cfg = cfg
        self.cfg_goldstd = cfg_goldstd
        self.data_folder = data_folder
        self.goldstd_var = goldstd_var
        self.data_to_save: dict = {}
        self.stage_times: dict[str, float] = {}
        logging.basicConfig(level=logging.INFO)
        self.logger = logging.getLogger(__name__)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if getattr(self.cfg, "infer_dtype", "bf16") == "bf16" else torch.float32

    @property
    def _rank0(self) -> bool:
        """Whether this process writes the run's files (always on one device)."""
        return self.mesh is None or self.mesh.rank == 0

    def _rank0_first(self, fn):
        """``fn()`` on rank 0, then on the other ranks once it has finished
        (what it writes, the others then read)."""
        if self.mesh is None:
            return fn()
        out = fn() if self._rank0 else None
        self.mesh.barrier()
        return out if self._rank0 else fn()

    def _labels(self) -> list[str]:
        return getattr(self.cfg, "damage_labels", "undamaged,damaged").split(",")

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_times[name] = time.perf_counter() - t0
        return out

    def run(self, resume: bool = False) -> dict:
        """Full pipeline; ``resume=True`` reuses detections from the stage
        pickle when present, so a crash after detect does not repeat it."""
        stream_n = getattr(self.cfg, "streaming_chunk", 0)
        use_stream = stream_n > 0 and getattr(self.cfg, "fused_inference", False)
        if stream_n > 0 and not use_stream:
            # the staged route materialises the capture, as the reference does
            self.logger.warning(
                "streaming_chunk = %d ignored: streaming requires fused_inference = true; "
                "the full capture will be materialised in host memory", stream_n,
            )
        scan = self._timed("extract", self._extract_light if use_stream else self._extract_images)
        detections = None
        if resume and use_stream:
            # resumed detections would re-project through the placeholder
            # scan, which holds no depth: re-run the streamed detect instead
            self.logger.info("resume ignored under streaming ingestion — re-running detect")
            resume = False
        if resume and os.path.exists(self.cfg.pickle_path):
            try:
                with open(self.cfg.pickle_path, "rb") as f:
                    prior = pickle.load(f)
                if "predictions" in prior:
                    detections = detections_from_frame_dict(prior["predictions"], scan.num_frames)
                    self.logger.info("Resumed detections from checkpoint.")
            except Exception as e:
                self.logger.warning("resume failed (%s); re-running detect", e)
        fused_gboxes = None
        if detections is None:
            if use_stream:
                detections, fused_gboxes = self._timed("detect", self._fused_streaming, stream_n)
            elif getattr(self.cfg, "fused_inference", False):
                detections, fused_gboxes = self._timed("detect", self._fused_inference, scan)
            else:
                detections = self._timed("detect", self._detect_signs, scan)
        global_bboxes, optimised, pose_df = self._timed(
            "map", self._map_detected_objects, scan, detections, fused_gboxes
        )

        self.data_to_save = {
            "predictions": detections.to_frame_dict(),
            "global_bboxes_data": global_bboxes.to_frame_dict(),
            "optimised_bboxes": optimised.to_frame_dict(),
            "pose_df": pose_df,
            "stage_times": dict(self.stage_times),
        }
        try:
            if self._rank0:
                os.makedirs(os.path.dirname(self.cfg.pickle_path) or ".", exist_ok=True)
                # atomic write: a crash mid-dump must not leave a truncated pickle
                tmp = self.cfg.pickle_path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    pickle.dump(self.data_to_save, f)
                os.replace(tmp, self.cfg.pickle_path)
                self.logger.info("Variables stored to pickle file.")
        except Exception as e:
            self.logger.info(f"Failed to write to file: {e}")

        if self.cfg.visualise and self._rank0:
            if use_stream:
                self.logger.warning(
                    "visualise skipped: streaming ingestion keeps no frames in memory "
                    "(set streaming_chunk = 0 to plot)"
                )
            else:
                self._timed("plot", self._plot_map, scan, global_bboxes, optimised, pose_df)

        if self.cfg_goldstd and self.goldstd_var:
            self._timed(
                "compare", self._goldstd_vs_maintenance, pose_df,
                self.data_to_save["optimised_bboxes"],
            )

        if self.mesh is not None:
            self.mesh.barrier()  # rank 0's files are written when run returns
        frames = scan.num_frames
        core = self.stage_times.get("detect", 0) + self.stage_times.get("map", 0)
        if core > 0:
            self.logger.info(
                "Throughput: %.2f frames/sec (detect+project, %d frames)", frames / core, frames,
            )
        return self.data_to_save

    def _fetch_from_db(self) -> None:
        """The capture's database, when present, to frame files."""
        if os.path.exists(self.cfg.db_path):
            extractor = ImageExtractor(self.cfg.db_path, self.cfg.depth_image_dir, self.cfg.image_dir)
            extractor.fetch_data()
            extractor.close()

    def _extract_images(self) -> Scan:
        self.logger.info("Extracting frames...")
        scan = self._rank0_first(self._load_scan)
        self.logger.info("Frames extracted.")
        return scan

    def _load_scan(self) -> Scan:
        if self._rank0:  # the other ranks read the frames rank 0 wrote
            self._fetch_from_db()
        return load_scan(
            image_dir=self.cfg.image_dir,
            depth_image_dir=self.cfg.depth_image_dir,
            calibration_dir=self.cfg.calibration_dir,
            pose_path=self.cfg.pose_path,
            img_size=self.cfg.img_size,
            depth_width=self.cfg.depth_width,
            depth_height=self.cfg.depth_height,
            cache=getattr(self.cfg, "scan_cache", False),
            workers=getattr(self.cfg, "decode_workers", 0),
        )

    def _extract_light(self) -> Scan:
        """Streaming extract: the database to files as usual, but only the
        poses and the frame count come into memory; the frames stay on disk
        for ``iter_scan_chunks`` to decode chunk by chunk."""
        self.logger.info("Extracting frames (streaming mode)...")
        self._rank0_first(self._fetch_from_db)
        pairs = _pair_filenames(self.cfg.image_dir, self.cfg.depth_image_dir)
        ts, poses = load_poses(self.cfg.pose_path)
        pairs, pose_rows = _pose_rows_for_pairs(pairs, poses.shape[0])
        n = len(pairs)
        if n == 0:
            raise ValueError(f"no paired frames found in {self.cfg.image_dir} / {self.cfg.depth_image_dir}")
        self.logger.info("Frames indexed (%d, decode deferred).", n)
        # 1×1 placeholders keep Scan's shape contract (num_frames is
        # depth.shape[0]) without holding frames
        return Scan(
            rgb=np.zeros((n, 1, 1, 3), np.uint8),
            depth=np.zeros((n, 1, 1), np.float32),
            intrinsics=np.zeros((n, 4), np.float32),
            rgb_size=np.ones((n, 2), np.float32),
            poses=poses[pose_rows],
            timestamps=ts[pose_rows],
        )

    def _fused_streaming(self, chunk_frames: int):
        """Chunked fused inference: ``iter_scan_chunks`` into
        ``FusedScanRunner.run_stream``; host memory bounded by the chunk."""
        chunks = iter_scan_chunks(
            image_dir=self.cfg.image_dir,
            depth_image_dir=self.cfg.depth_image_dir,
            calibration_dir=self.cfg.calibration_dir,
            pose_path=self.cfg.pose_path,
            chunk_frames=chunk_frames,
            img_size=self.cfg.img_size,
            depth_width=self.cfg.depth_width,
            depth_height=self.cfg.depth_height,
            # the stream writes its scanpack as it goes: rank 0 alone does
            cache=getattr(self.cfg, "scan_cache", False) and self._rank0,
            workers=getattr(self.cfg, "decode_workers", 0),
        )
        return self._make_fused_runner().run_stream(chunks)

    def _detect_signs(self, scan: Scan) -> Detections:
        """The staged route: ``ObjectDetector`` over the frames, then
        ``DamageDetector`` over every valid box."""
        from tpu3dlm_torch.pipeline.classifier import DamageDetector
        from tpu3dlm_torch.pipeline.detector import ObjectDetector

        self.logger.info("Detecting Signs...")
        save_img = self.cfg.processing_path if getattr(self.cfg, "view_img", False) and self._rank0 else None
        if save_img:
            os.makedirs(save_img, exist_ok=True)
        detector = ObjectDetector(
            conf_thresh=self.cfg.conf_thresh,
            iou_thresh=self.cfg.iou_thresh,
            img_size=self.cfg.img_size,
            batch_size=self.cfg.batch_size,
            max_det=getattr(self.cfg, "max_det", 64),
            nc=getattr(self.cfg, "num_classes", 80),
            variant=getattr(self.cfg, "yolo_variant", "n"),
            yolo=self._load_yolo_weights(),
            dtype=self.dtype,
            save_img=save_img,
            device=self.device,
        )
        detections = detector(scan)

        labels = self._labels()
        classifier = DamageDetector(
            num_labels=len(labels),
            id2label=dict(enumerate(labels)),
            config=self._beit_config(len(labels)),
            beit=self._load_beit_weights(len(labels)),
            dtype=self.dtype,
            device=self.device,
        )
        detections = classifier.classify_detections(scan, detections)
        self.logger.info("Inference Complete.")
        return detections

    def _fused_inference(self, scan: Scan):
        """Detect + classify + project in one step (``pipeline/fused.py``)."""
        return self._make_fused_runner()(scan)

    def _make_fused_runner(self):
        from tpu3dlm_torch.pipeline.fused import FusedScanRunner

        labels = self._labels()
        return FusedScanRunner(
            img_size=self.cfg.img_size,
            conf_thresh=self.cfg.conf_thresh,
            max_det=getattr(self.cfg, "max_det", 64),
            nc=getattr(self.cfg, "num_classes", 80),
            variant=getattr(self.cfg, "yolo_variant", "n"),
            beit_config=self._beit_config(len(labels)),
            yolo=self._load_yolo_weights(),
            beit=self._load_beit_weights(len(labels)),
            mesh_devices=getattr(self.cfg, "mesh_devices", 1),
            dtype=self.dtype,
            crop_budget=getattr(self.cfg, "crop_budget", 128),
            device=self.device,
            mesh=self.mesh,
        )

    def _map_detected_objects(self, scan: Scan, detections: Detections, fused_gboxes=None):
        self.logger.info("Extracting Pose Information...")
        pose_df = poses_to_frame(np.asarray(scan.timestamps), np.asarray(scan.poses))
        self.logger.info("Processing Pose...")
        global_bboxes = (
            fused_gboxes if fused_gboxes is not None
            else project_detections(scan, detections, device=self.device)
        )
        self.logger.info("Executing 3D NMS...")
        optimised = suppress_bboxes(
            global_bboxes, np.asarray(scan.poses),
            top_k=getattr(self.cfg, "nms_top_k", 1024), device=self.device,
        )
        self.logger.info("3D NMS Executed.")
        return global_bboxes, optimised, pose_df

    def _plot_map(self, scan: Scan, global_bboxes, optimised, pose_df) -> str:
        """The 3D map: a triangle-mesh PLY next to the cloud, from the scan's
        fused TSDF (``mesh_source = tsdf``) or from ``cloud.ply`` (``cloud``,
        the default). Returns its path."""
        from tpu3dlm_torch.data.ply import save_ply_mesh
        from tpu3dlm_torch.mapper.mapping import Mapping
        from tpu3dlm_torch.mapper.meshing import mesh_scan

        self.logger.info("Generating 3D Map...")
        out = os.path.join(os.path.dirname(self.cfg.ply_path) or ".", "map_mesh.ply")
        voxel = getattr(self.cfg, "mesh_voxel", 0.04)
        if getattr(self.cfg, "mesh_source", "cloud") == "tsdf":
            verts, faces = mesh_scan(scan, voxel=voxel, device=self.device)
            save_ply_mesh(out, verts, faces)
            self.logger.info("TSDF mesh: %d vertices / %d triangles → %s", len(verts), len(faces), out)
        else:
            mapper = Mapping(
                global_bboxes_data=global_bboxes,
                optimised_bboxes=optimised,
                pose=pose_df,
                eps=self.cfg.eps,
                min_points=self.cfg.min_points,
                ply_filepath=self.cfg.ply_path,
                preprocess_point_cloud=self.cfg.preprocess_point_cloud,
                overlay_pose=self.cfg.overlay_pose,
                device=self.device,
            )
            mapper.make_mesh(output_path=out, voxel=voxel, mesher=getattr(self.cfg, "mesher", "density"))
        self.logger.info("3D Map Generated.")
        return out

    def _goldstd_vs_maintenance(self, pose_df, optimised_bboxes):
        from tpu3dlm_torch.data.ply import load_ply

        base_cloud = comp_cloud = None
        try:
            if os.path.exists(self.cfg_goldstd.ply_path):
                base_cloud, _ = load_ply(self.cfg_goldstd.ply_path)
            if os.path.exists(self.cfg.ply_path):
                comp_cloud, _ = load_ply(self.cfg.ply_path)
        except Exception as e:
            self.logger.warning("cloud load failed (%s); aligning on poses+boxes", e)

        align = make_alignment(self.cfg, self.goldstd_var, pose_df, optimised_bboxes, base_cloud, comp_cloud,
                               self.device, self.mesh)
        aligned_bboxes, transformations, base_map, _ = align.compare(self.data_folder)
        self.data_to_save["transformations"] = transformations
        self.data_to_save["aligned_bboxes"] = aligned_bboxes
        verdict = align.last_verdict.to_dict() if align.last_verdict else None
        self.data_to_save["alignment_verdict"] = verdict
        if not self._rank0:
            return  # the report and the animation are rank 0's

        compare = BBoxComparison(
            self.goldstd_var["optimised_bboxes"],
            aligned_bboxes,
            base_map,
            csv_output_file=self.cfg.csv_output,
            id2damage=dict(enumerate(self._labels())),
            visualise=self.cfg.comparison_vis,
            precomputed_match=align.last_match,
            alignment_verdict=verdict,
            device=self.device,
        )
        self.data_to_save["comparison_rows"] = compare.match_bboxes()

        if self.cfg.alignment_vis:
            from tpu3dlm_torch.alignment.visualise import VisualiseAlignment

            # the animation replays the recorded transforms, so it starts
            # from the raw comparison points (base_map's partner is aligned)
            vis = VisualiseAlignment(base_map, align.comparison_points,
                                     mesher=getattr(self.cfg, "mesher", "density"), device=self.device)
            out = os.path.join(os.path.dirname(self.cfg.csv_output) or ".", "alignment_animation.mp4")
            vis.create_video(transformations, out)

    # -- weights ----------------------------------------------------------

    def _beit_config(self, num_labels: int) -> BeitConfig:
        """BeitConfig from the cfg's beit_* architecture knobs (BEiT-base
        defaults); ``use_pallas = false`` selects the einsum attention."""
        base = BeitConfig()
        return BeitConfig(
            image_size=getattr(self.cfg, "beit_image_size", base.image_size),
            patch_size=getattr(self.cfg, "beit_patch_size", base.patch_size),
            hidden_size=getattr(self.cfg, "beit_hidden_size", base.hidden_size),
            num_layers=getattr(self.cfg, "beit_num_layers", base.num_layers),
            num_heads=getattr(self.cfg, "beit_num_heads", base.num_heads),
            intermediate_size=getattr(self.cfg, "beit_intermediate_size", base.intermediate_size),
            num_labels=num_labels,
            quant=getattr(self.cfg, "beit_quant", "none"),
            attn_impl="auto" if getattr(self.cfg, "use_pallas", True) else "einsum",
        )

    def _weights_key(self, kind: str, path: str, model_cfg) -> tuple:
        stamp = (os.path.abspath(path), os.path.getmtime(path)) if path else (None, None)
        return (kind, *stamp, model_cfg, str(self.device), self.dtype)

    def _load_yolo_weights(self) -> YOLOv10:
        from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
        from tpu3dlm_torch.models.weights import load_torch_state_dict, yolov10_from_flax, yolov10_from_ultralytics

        path = getattr(self.cfg, "yolo_weights", "") or ""
        path = path if os.path.exists(path) else ""
        nc, variant = getattr(self.cfg, "num_classes", 80), getattr(self.cfg, "yolo_variant", "n")

        def build():
            if path.endswith(".msgpack"):
                self.logger.info("Loading native YOLOv10 checkpoint %s", path)
                model = yolov10_from_flax(read_flax_msgpack(path), variant=variant, nc=nc)
            elif path:
                self.logger.info("Converting YOLOv10 torch checkpoint %s", path)
                model = yolov10_from_ultralytics(load_torch_state_dict(path), variant=variant, nc=nc)
            else:
                model = init_seeded_(YOLOv10(nc=nc, variant=variant), torch.Generator().manual_seed(0))
            return model.to(self.device, self.dtype).eval()

        return _cached_weights(self._weights_key("yolo", path, (nc, variant)), build)

    def _load_beit_weights(self, num_labels: int) -> BeitClassifier:
        from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
        from tpu3dlm_torch.models.weights import (
            beit_from_flax, beit_from_hf, load_torch_state_dict, quantize_beit_variables,
        )

        path = getattr(self.cfg, "beit_weights", "") or ""
        path = path if os.path.exists(path) else ""
        cfg = self._beit_config(num_labels)
        int8 = cfg.quant == "int8"
        # checkpoints are stored float whatever beit_quant says: load as
        # float, quantise after
        float_cfg = dataclasses.replace(cfg, quant="none")

        def build():
            if path.endswith(".msgpack"):
                self.logger.info("Loading native BEiT checkpoint %s", path)
                variables = read_flax_msgpack(path)
                if int8:
                    self.logger.info("Quantizing BEiT weights to int8 (beit_quant)")
                    variables = quantize_beit_variables(variables)
                model = beit_from_flax(variables, cfg)
            else:
                if path:
                    self.logger.info("Converting BEiT torch checkpoint %s", path)
                    model = beit_from_hf(load_torch_state_dict(path), float_cfg)
                else:
                    model = seeded_beit(float_cfg, torch.Generator().manual_seed(1))
                if int8:
                    self.logger.info("Quantizing BEiT weights to int8 (beit_quant)")
                    model = quantize_beit(model)
            return model.to(self.device, self.dtype).eval()

        return _cached_weights(self._weights_key("beit", path, cfg), build)


def make_alignment(cfg, gold_var: dict, pose_df, optimised_bboxes, base_cloud, comp_cloud,
                   device: str | torch.device = "cuda", mesh=None) -> Alignment:
    """The maintenance scan's ``Alignment`` onto the gold scan's record, with
    the config's registration settings (its ICP queries sharded over
    ``mesh`` when given; every NN search on the plain twin under
    ``use_pallas = false``)."""
    return Alignment(
        base_pose_df=gold_var["pose_df"],
        comparison_pose_df=pose_df,
        base_bboxes=gold_var["optimised_bboxes"],
        comparison_bboxes=optimised_bboxes,
        visualise=cfg.alignment_vis,
        base_cloud=base_cloud,
        comparison_cloud=comp_cloud,
        max_points=getattr(cfg, "icp_max_points", 16384),
        icp_iterations=getattr(cfg, "icp_iterations", 30),
        global_init=getattr(cfg, "icp_global_init", "auto"),
        ann=getattr(cfg, "icp_ann", "auto"),
        verdict_inlier_floor=getattr(cfg, "align_inlier_floor", 0.35),
        verdict_rmse_ceiling=getattr(cfg, "align_rmse_ceiling", 0.08),
        mesh=mesh,
        use_pallas=None if getattr(cfg, "use_pallas", True) else False,
        device=device,
    )


def load_gold_std(pickle_path: str):
    """None on a missing or corrupt pickle (reference task_def.py:200-209)."""
    try:
        with open(pickle_path, "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        logging.error(f"The file {pickle_path} was not found.")
        return None
    except (pickle.UnpicklingError, EOFError, AttributeError, ModuleNotFoundError) as e:
        # truncated file, or a pickle of classes this process cannot load
        # (a gold pickle written by the JAX package holds a pandas DataFrame)
        logging.error(f"Failed to unpickle the file {pickle_path}: {e}")
        return None


def setup_pipeline(data_folder, cfg, cfg_goldstd=None, goldstd_var=None,
                   device: str | torch.device = "cuda", mesh=None) -> Pipeline:
    pipeline = Pipeline(data_folder, cfg, cfg_goldstd, goldstd_var, device=device, mesh=mesh)
    pipeline.run()
    return pipeline
