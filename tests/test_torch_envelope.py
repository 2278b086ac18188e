"""The port's convergence-envelope sweep
(``tpu3dlm_torch/scripts/alignment_envelope.py``) against the JAX
package's script (``scripts/alignment_envelope.py``) on the CPU: three
cells, each on the reference's numpy stream, through both ``run_cell``s.

Bars: ``success`` and ``flagged`` (and the verdict's reasons) equal;
``rot_err_deg`` within 0.05° and ``t_err_m`` within 0.005 m on the cell in
the basin (30°, auto) and the half-overlap cell (both land in the same
place). Out of the basin (150°, centroid init) ICP never converges: all 75
increments move, and the last-ulp differences of XLA's and PyTorch's f32
sums (8e-6 after the first increment) grow along the walk to 2.7e-3 in the
final transform, so its rotation error is 176.86° against 177.04° (0.18°;
t_err 0.640 against 0.641 m). That cell is held within 0.25° and 0.005 m
(ROADMAP §C)."""

import json
import os
import sys

import numpy as np
import pytest

from tpu3dlm_torch.scripts import alignment_envelope as P

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import alignment_envelope as J  # noqa: E402  (the JAX package's script)

NOMINAL = dict(overlap=1.0, outlier_rate=0.0, noise_m=0.005)
CELLS = {
    "basin": (dict(NOMINAL, rot_deg=30), "auto", 0.05),
    "out_of_basin_150": (dict(NOMINAL, rot_deg=150), "centroid", 0.25),
    "half_overlap": (dict(NOMINAL, rot_deg=30, overlap=0.5), "auto", 0.05),
}


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_matches_the_jax_script(name):
    cfg, init, rot_bar = CELLS[name]
    rng = P.cell_rng(cfg, 0)
    cloud, boxes, _, _ = J.make_scene(rng)
    want = J.run_cell(cloud, boxes, rng, global_init=init, **cfg)
    rng = P.cell_rng(cfg, 0)
    p_cloud, p_boxes, _, _ = P.make_scene(rng)
    np.testing.assert_array_equal(p_cloud, cloud)  # the same stream
    got = P.run_cell(p_cloud, p_boxes, rng, global_init=init, device="cpu", **cfg)
    assert got["success"] == want["success"] and got["flagged"] == want["flagged"]
    assert got["reasons"] == want["reasons"]
    assert abs(got["rot_err_deg"] - want["rot_err_deg"]) <= rot_bar
    assert abs(got["t_err_m"] - want["t_err_m"]) <= 0.005
    assert got["success"] == (name == "basin")


def test_sweep_is_the_reference_sweep():
    """The cells and their streams in the reference's order: the full sweep
    is the 144 records of ``docs/ALIGNMENT_ENVELOPE.json``, the quick one
    16."""
    with open(P.DOCS / "ALIGNMENT_ENVELOPE.json") as f:
        ref = json.load(f)
    keys = ("rot_deg", "overlap", "outlier_rate", "noise_m", "init", "seed")
    got = [(c["rot_deg"], c["overlap"], c["outlier_rate"], c["noise_m"], i, s) for c, i, s in P.sweep(False, 3)]
    assert got == [tuple(c[k] for k in keys) for c in ref["cells"]]
    assert len(P.sweep(True)) == 16
    assert P.gate_quality(ref["cells"]) == ref["gate_quality"]


def test_main_writes_the_reference_schema_and_refuses_docs(tmp_path, monkeypatch, capsys):
    one = P.sweep(False, 1)[:1]
    monkeypatch.setattr(P, "sweep", lambda quick, seeds: one)
    out = tmp_path / "env.json"
    report = P.main(["--out", str(out), "--device", "cpu"])
    with open(P.DOCS / "ALIGNMENT_ENVELOPE.json") as f:
        ref = json.load(f)
    assert set(json.loads(out.read_text())) == set(ref) and len(report["cells"]) == 1
    assert set(report["cells"][0]) == set(ref["cells"][0])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report["gate_quality"]
    with pytest.raises(SystemExit, match="docs/"):
        P.main(["--out", str(P.DOCS / "x.json"), "--device", "cpu"])
