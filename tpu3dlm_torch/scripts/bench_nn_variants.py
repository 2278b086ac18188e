"""NN-kernel variant probe on the card (port of
``scripts/bench_nn_variants.py``): can the exact kernel B2 go faster with a
bf16 cross term on the tensor cores and a cheaper minimum?

    python -m tpu3dlm_torch.scripts.bench_nn_variants

Variants (kernel B4, ``ops/kernels/nn_variants.py``): v1 running
(min, argmin); v2 the two-level minimum; v3 v1 with the target axis split
across blocks; v4 v1 with twice the queries per block. ``v0_production`` is kernel B2 (``ops/kernels/pairwise.py``),
which stays the production kernel: its cross term is exact f32, the
variants' is one bf16 pass, whose near-tie flips the reference retired.

Verify first, as the reference does: on the seeded 512 × 4096 instance in
[−2, 2]³, each variant's picks against the exact B2 twin by their true f64
d² — never better than the exact pick's, and at most
2⁻⁷·|a|·max|b| + 1e-6 worse (the bf16 rounding band of the cross term; a
logic fault lands far outside it) — with the near-tie flips counted. Then
time each variant and B2 at 16384 × 1,048,576 in [−3, 3]³ (CUDA events,
one warm-up, 5 launches). Prints one JSON line per variant,
``{"metric": "nn_16k_x_1M_<name>", "value": ms, "unit": "ms",
"vs_baseline": B2 ms / ms, "device": ...}``; the verification goes to
stderr. Needs a CUDA card: it measures the card and has no CPU mode.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS, nn_variant
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors, nearest_neighbors_reference

TIME_SHAPE = (16384, 1 << 20)
ITERS = 5


def probe_inputs(seed: int = 0):
    """(a_small, b_small, a, b) as f32 numpy, drawn from one seeded
    generator in the reference's order."""
    rng = np.random.default_rng(seed)
    a_s = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    b_s = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    n, m = TIME_SHAPE
    a = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    return a_s, b_s, a, b


def verify(a_s: np.ndarray, b_s: np.ndarray, device) -> dict:
    """Each variant against the exact B2 twin by the true f64 d² of every
    pick (the reference's gate); raises on a pick outside the bf16 band.
    Returns {variant: {"flips", "max_excess", "max_band"}}."""
    a = torch.as_tensor(a_s, device=device)
    b = torch.as_tensor(b_s, device=device)
    ref_i = nearest_neighbors_reference(a, b)[0].cpu().numpy()
    a64, b64 = a_s.astype(np.float64), b_s.astype(np.float64)
    true_d2 = lambda idx: np.sum((a64 - b64[idx]) ** 2, axis=1)  # noqa: E731
    ref_true = true_d2(ref_i)
    band = 2.0 ** -7 * np.linalg.norm(a64, axis=1) * np.linalg.norm(b64, axis=1).max() + 1e-6
    rows = {}
    for name in VARIANTS:
        gi = nn_variant(a, b, name)[0].cpu().numpy()
        excess = true_d2(gi) - ref_true
        if not (excess >= -1e-9).all():
            raise RuntimeError(f"{name}: a pick beat the exact reference by {-excess.min():.3e} m²")
        worst = int((excess - band).argmax())
        if not (excess <= band).all():
            raise RuntimeError(
                f"{name}: pick {worst} is {excess[worst]:.4f} m² worse than optimal "
                f"(bf16 band {band[worst]:.4f}): a logic fault, not precision noise")
        flips = int((gi != ref_i).sum())
        rows[name] = {"flips": flips, "queries": len(ref_i), "max_excess": float(excess.max()),
                      "max_band": float(band.max())}
        print(f"{name}: {flips}/{len(ref_i)} near-tie flips vs the exact reference, "
              f"max true-d² excess {excess.max():.2e}", file=sys.stderr)
    return rows


def cuda_ms(fn):
    """(mean device ms of one call, the warm-up call's result): CUDA events
    around ``ITERS`` calls after one drained warm-up."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, out


def time_variants(a_np: np.ndarray, b_np: np.ndarray, device):
    """(device ms of B2 (``v0_production``) and of each variant, each one's
    (idx, d2) from its warm-up call)."""
    a = torch.as_tensor(a_np, device=device)
    b = torch.as_tensor(b_np, device=device)
    rows, outs = {}, {}
    rows["v0_production"], outs["v0_production"] = cuda_ms(lambda: nearest_neighbors(a, b))
    for name in VARIANTS:
        rows[name], outs[name] = cuda_ms(lambda: nn_variant(a, b, name))
    return rows, outs


def result_lines(ms: dict[str, float], device_name: str) -> list[dict]:
    return [{"metric": f"nn_16k_x_1M_{name}", "value": t, "unit": "ms",
             "vs_baseline": ms["v0_production"] / t, "device": device_name}
            for name, t in ms.items()]


def main() -> int:
    dev = resolve_device("cuda")
    a_s, b_s, a, b = probe_inputs()
    verify(a_s, b_s, dev)
    print("correctness OK", file=sys.stderr)
    ms, _ = time_variants(a, b, dev)
    for line in result_lines(ms, torch.cuda.get_device_name(dev)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
