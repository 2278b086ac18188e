"""Config system: INI file with per-data-folder expansion (port of
``tpu3dlm/utils/config.py``, stdlib ``configparser`` only).

`ConfigLoader(config_path, data_folder)` reads an INI file and exposes typed
attributes with the reference's keys and coercions. Values may contain
``{data}`` (the data folder name) and ``{root}`` (the config file's
directory); a section named exactly like the data folder overrides
[default] entries. ``DEFAULT_CONFIG`` is the reference's default file, key
for key; some of its settings raise in the port's Pipeline
(``pipeline/task.py`` lists them).
"""

from __future__ import annotations

import configparser
import os

_BOOL = {
    "true": True, "1": True, "yes": True, "on": True,
    "false": False, "0": False, "no": False, "off": False,
}

# attribute → type coercion ("" stays str); every name the reference reads
_SCHEMA: dict[str, str] = {
    "db_path": "path",
    "image_dir": "path",
    "depth_image_dir": "path",
    "calibration_dir": "path",
    "img_size": "int",
    "batch_size": "int",
    "conf_thresh": "float",
    "iou_thresh": "float",
    "view_img": "bool",
    "processing_path": "path",
    "pose_path": "path",
    "depth_width": "int",
    "depth_height": "int",
    "display_3d_pose": "bool",
    "eps": "float",
    "min_points": "int",
    "ply_path": "path",
    "preprocess_point_cloud": "bool",
    "overlay_pose": "bool",
    "visualise": "bool",
    "pickle_path": "path",
    "alignment_vis": "bool",
    "comparison_vis": "bool",
    "csv_output": "path",
    # framework additions (runtime knobs)
    "max_det": "int",
    "num_classes": "int",
    "yolo_variant": "str",
    "yolo_weights": "path",
    "beit_weights": "path",
    "damage_labels": "str",
    # classifier architecture (defaults = BEiT-base; override for compact
    # task-specific classifiers trained with pipeline/selftrain.py)
    "beit_image_size": "int",
    "beit_patch_size": "int",
    "beit_hidden_size": "int",
    "beit_num_layers": "int",
    "beit_num_heads": "int",
    "beit_intermediate_size": "int",
    # "none" | "int8": quantized classifier serving (ops/quant.py)
    "beit_quant": "str",
    "nms_top_k": "int",
    "crop_budget": "int",
    "streaming_chunk": "int",
    "scan_cache": "bool",
    "decode_workers": "int",
    "mesh_devices": "int",
    "use_pallas": "bool",
    "icp_max_points": "int",
    "icp_iterations": "int",
    "icp_global_init": "str",
    "icp_ann": "str",
    "mesh_source": "str",
    "mesher": "str",
    "mesh_voxel": "float",
    "infer_dtype": "str",
    "fused_inference": "bool",
}


class ConfigLoader:
    def __init__(self, config_path: str, data_folder: str, data_root: str | None = None):
        self.config_path = config_path
        self.data_folder = data_folder
        # interpolation=None: this file's own templating is {data}/{root},
        # and BasicInterpolation would reject legitimate '%' in values
        # (e.g. /data/5%_sample) — inconsistently, since [DEFAULT] values
        # read via parser.defaults() bypass interpolation anyway
        parser = configparser.ConfigParser(interpolation=None)
        read = parser.read(config_path)
        if not read:
            raise FileNotFoundError(config_path)

        values: dict[str, str] = dict(parser.defaults())
        if parser.has_section("default"):
            values.update(dict(parser.items("default")))
        if parser.has_section(data_folder):
            values.update(dict(parser.items(data_folder)))

        root = data_root or os.path.dirname(os.path.abspath(config_path))
        for key, raw in values.items():
            val = raw.replace("{data}", data_folder).replace("{root}", root)
            kind = _SCHEMA.get(key, "str")
            if kind == "int":
                parsed = int(float(val))
            elif kind == "float":
                parsed = float(val)
            elif kind == "bool":
                try:
                    parsed = _BOOL[val.strip().lower()]
                except KeyError:
                    raise ValueError(
                        f"config option '{key}' in {config_path}: expected "
                        f"a boolean (true/false/1/0/yes/no/on/off), got "
                        f"{val!r}"
                    ) from None
            else:
                parsed = val
            setattr(self, key, parsed)

    def __repr__(self):
        attrs = {k: v for k, v in vars(self).items() if not k.startswith("_")}
        return f"ConfigLoader({attrs})"


DEFAULT_CONFIG = """\
[default]
# per-scan paths ({data} expands to the data folder name, {root} to the
# config file's directory)
db_path = {root}/data/{data}/data.db
image_dir = {root}/data/{data}/rtabmap_extract/data_rgb
depth_image_dir = {root}/data/{data}/rtabmap_extract/data_depth
calibration_dir = {root}/data/{data}/rtabmap_extract/calibration
pose_path = {root}/data/{data}/poses.txt
ply_path = {root}/data/{data}/cloud.ply
processing_path = {root}/data/{data}/processed_img
pickle_path = {root}/data/{data}/variables.pkl
csv_output = {root}/data/{data}/comparison_output.csv

# detector
img_size = 640
# detect-stage device batch (staged route)
batch_size = 64
conf_thresh = 0.5
iou_thresh = 0.7
view_img = false
max_det = 64
# 3D NMS confidence cap: candidates beyond this are dropped lowest-conf
# first before suppression (static O(K^2) pairwise-IoU shape)
nms_top_k = 1024
num_classes = 80
# fused-path classifier budget: BEiT runs on only the top-crop_budget
# crops by detection confidence across the scan (parallel/inference.py)
crop_budget = 128
# 0 = whole-scan ingestion; N>0 streams the capture in N-frame chunks
# with host-decode/device-compute overlap (bounded memory for scans
# larger than host RAM/HBM — data/dataset.iter_scan_chunks)
streaming_chunk = 0
# serve streamed chunks from the scanpack cache (memory-mapped, zero
# decodes after the first pass — data/scanpack.py)
scan_cache = false
# host decode thread pool (0/1 = sequential; the decoders release the GIL
# so this scales with host cores)
decode_workers = 0
yolo_variant = n
yolo_weights =
beit_weights =
damage_labels = undamaged,damaged

# damage classifier architecture (BEiT-base defaults)
beit_image_size = 224
beit_patch_size = 16
beit_hidden_size = 768
beit_num_layers = 12
beit_num_heads = 12
beit_intermediate_size = 3072
# none | int8 — int8 quantizes every encoder Dense at load
beit_quant = none

# depth / projection
depth_width = 192
depth_height = 256
display_3d_pose = false

# point cloud
eps = 0.04
min_points = 1000
preprocess_point_cloud = true
overlay_pose = false
visualise = false
# 3D map artifact: mesh cloud.ply ("cloud") or TSDF-fuse the scan's depth
# frames on device ("tsdf"); cloud reconstructor: density shell ("density")
# or device FFT Poisson ("poisson")
mesh_source = cloud
mesher = density
mesh_voxel = 0.04

# maintenance comparison
alignment_vis = false
comparison_vis = false
icp_max_points = 16384
icp_iterations = 30
icp_global_init = auto
# anchor-bucketed NN for ICP iterations: auto | on | off (auto and on
# raise on targets of 131,072 points or more until the index is ported)
icp_ann = auto

# device runtime
mesh_devices = 1
# true = the hand-written kernels; false (a plain path on the device) is
# not available in the port
use_pallas = true
infer_dtype = bf16
fused_inference = false
"""


def write_default_config(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(DEFAULT_CONFIG)
