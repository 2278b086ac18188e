"""Where kernel B4's time goes: its sweep built with a part left out, and
with other column tiles, timed on the card beside the shipped build.

    python -m tpu3dlm_torch.scripts.nn_variants_ablation [--iters 5]

Builds ``csrc/nn_variants.cu`` four times, all at once, with the flags of
``kernels/build.py`` plus ``-Xptxas -v`` and one set of ``-D`` each:

* ``shipped``: the shipped build (v1 and v3 at N = 32, v2 at N = 64, v4 at
  N = 16 with two row tiles);
* ``no_min`` (``NNV_SKIP=1``): the MMAs and the ring, no minimum;
* ``no_mma`` (``NNV_SKIP=2``): the ring and the minimum, no MMAs (the
  minimum then runs over the zeroed accumulators);
* ``other_n``: v1 and v3 at N = 64, v2 at N = 32, v4 at N = 32, so that
  each variant also runs at its counterpart's column tile.

Then, on the probe's inputs at 16384 × 1,048,576 (``bench_nn_variants``'s
``probe_inputs``), the targets packed once, it times the sweep and fold of
every variant of every build (CUDA events around ``--iters`` launches after
one warm-up, the builds taken in turn for each variant), checks that
``other_n`` gives the shipped build's picks and d² bit for bit, and prints
ptxas's registers and spill bytes per kernel and, as its last line, one
JSON object with all of it and the card's name and power limit. Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys

import torch

from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.kernels import build
from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS, bind, pack_targets, sweep
from tpu3dlm_torch.scripts.bench_nn_variants import probe_inputs

BUILDS = {
    "shipped": [],
    "no_min": ["-DNNV_SKIP=1"],
    "no_mma": ["-DNNV_SKIP=2"],
    "other_n": ["-DNNV_V1_N=64", "-DNNV_V2_N=32", "-DNNV_V4_N=32"],
}
_KERNEL = re.compile(r"nn_variant_kernelILi(\d+)ELi(\d+)ELb([01])E")


def build_variants() -> dict[str, tuple[ctypes.CDLL, list[dict]]]:
    """{build: (the bound library, ptxas's [{N, R, two_level, registers,
    spill_stores, spill_loads}] per sweep kernel)}; the compilers run at
    once."""
    src = build.CSRC / "nn_variants.cu"
    key = src.read_bytes() + (build.CSRC / "nn_fold.cuh").read_bytes()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defs in BUILDS.items():
        flags = [*build.NVCC_FLAGS, "-Xptxas", "-v", *defs]
        digest = hashlib.sha256(key + " ".join(flags).encode()).hexdigest()[:16]
        out = build.BUILD_DIR / f"nn_variants-{name}-{digest}.so"
        cmd = [build._nvcc(), *flags, "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {name} failed:\n{log}")
        libs[name] = (bind(ctypes.CDLL(str(out))), ptxas_report(log))
    return libs


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of each sweep kernel in a ``ptxas -v`` log."""
    rows, current = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            found = _KERNEL.search(line)
            current = None
            if found:
                n, r, two = found.groups()
                current = {"N": int(n), "R": int(r), "two_level": two == "1"}
                rows.append(current)
        elif current is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            current["spill_stores"], current["spill_loads"] = int(stores), int(loads)
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    dev = resolve_device("cuda")
    libs = build_variants()
    for name, (_, report) in libs.items():
        for row in report:
            print(name, json.dumps(row), file=sys.stderr)
    _, _, a_np, b_np = probe_inputs()
    a = torch.as_tensor(a_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    m = b.shape[0]
    packed = pack_targets(b)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = {name: {} for name in BUILDS}
    outs = {name: {} for name in BUILDS}
    for variant in VARIANTS:
        for name, (lib, _) in libs.items():
            outs[name][variant] = sweep(a, packed, m, variant, lib)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.iters):
                sweep(a, packed, m, variant, lib)
            end.record()
            torch.cuda.synchronize()
            ms[name][variant] = start.elapsed_time(end) / args.iters
    same = {v: torch.equal(outs["other_n"][v][0], outs["shipped"][v][0])
            and torch.equal(outs["other_n"][v][1], outs["shipped"][v][1]) for v in VARIANTS}
    print(json.dumps({"shape": [a.shape[0], m], "iters": args.iters, "card": card(),
                      "sweep_ms": ms, "other_n_bit_identical": same,
                      "ptxas": {name: report for name, (_, report) in libs.items()}}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
