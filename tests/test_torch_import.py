"""tpu3dlm_torch stands alone: it imports neither jax/flax nor anything of
the JAX package, nor cv2, PIL, yaml, pandas, msgpack, safetensors,
ultralytics, transformers or open3d, so it runs on a GPU host that has none
of them."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dlm", "cv2", "PIL", "yaml", "pandas", "msgpack", "safetensors",
             "ultralytics", "transformers", "open3d")

_PROBE = """
import importlib, pkgutil, sys
FORBIDDEN = %r
for name in FORBIDDEN:
    sys.modules[name] = None  # any import of them now raises ImportError
import tpu3dlm_torch
mods = [m.name for m in pkgutil.walk_packages(tpu3dlm_torch.__path__, "tpu3dlm_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN and sys.modules[k] is not None)
assert not bad, bad
assert {"tpu3dlm_torch.data.scanpack", "tpu3dlm_torch.pipeline.watch", "tpu3dlm_torch.native",
        "tpu3dlm_torch.mapper.clustering", "tpu3dlm_torch.mapper.meshing", "tpu3dlm_torch.mapper.poisson",
        "tpu3dlm_torch.mapper.mapping", "tpu3dlm_torch.ops.quant", "tpu3dlm_torch.data.synthetic",
        "tpu3dlm_torch.pipeline.metrics", "tpu3dlm_torch.pipeline.evaluate", "tpu3dlm_torch.pipeline.selftrain",
        "tpu3dlm_torch.pipeline.hardeval", "tpu3dlm_torch.scripts.hard_eval", "tpu3dlm_torch.utils.render",
        "tpu3dlm_torch.utils.visualisation", "tpu3dlm_torch.utils.transformations", "tpu3dlm_torch.utils.annotate",
        "tpu3dlm_torch.alignment.visualise", "tpu3dlm_torch.scripts.alignment_envelope",
        "tpu3dlm_torch.models.yolo_loss", "tpu3dlm_torch.ops.augment",
        "tpu3dlm_torch.scripts.e2e_accuracy", "tpu3dlm_torch.parallel.mesh", "tpu3dlm_torch.parallel.nn",
        "tpu3dlm_torch.scripts.distributed_smoke"} <= set(mods), mods
print(len(mods))
""" % (FORBIDDEN,)


def test_port_imports_without_jax_or_tpu3dlm():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 77  # every module of the twelve slices was imported


def test_cli_imports_none_of_the_forbidden_packages():
    # only what the import itself loads (an interpreter may preload jax)
    probe = ("import sys; before = set(sys.modules); import tpu3dlm_torch.cli; "
             f"bad = sorted(k for k in set(sys.modules) - before if k.split('.')[0] in {FORBIDDEN!r}); "
             "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", ["tpu3dlm_torch", "chip_smoke.py"])
def test_no_jax_or_tpu3dlm_import_statements(path):
    """Static check, lazy imports included."""
    files = [REPO / path] if path.endswith(".py") else sorted((REPO / path).rglob("*.py"))
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in FORBIDDEN, f"{f}: {line}"
