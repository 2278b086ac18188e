"""Missing/damaged-object report: bipartite box matching + CSV (port of
``tpu3dlm/alignment/comparison.py``).

Gold-standard boxes are matched against the aligned maintenance boxes
(cost = centroid distance, pairs with different detector labels
forbidden, unmatch cost = ``dist_threshold``); each gold box becomes a
``matched``, ``damaged`` or ``missing`` row, each unmatched maintenance box
a ``new`` row, and the rows go to a CSV with the reference's header and row
order. The assignment comes from ``Alignment.last_match`` when it fits
(``precomputed_match``), else from the auction (``ops/matching.py``) on
``device`` over the bucket-padded cost matrix.
"""

from __future__ import annotations

import csv
import logging

import numpy as np
import torch

from tpu3dlm_torch.alignment.align import _boxes_to_records
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.ops.matching import auction_assign
from tpu3dlm_torch.utils.shapes import next_bucket


class BBoxComparison:
    def __init__(
        self,
        base_optimised_bboxes,
        aligned_comparison_bboxes,
        base_mesh=None,  # parity slot (the reference passes the gold-std mesh for viz)
        visualise: bool = False,
        csv_output_file: str = "comparison_output.csv",
        dist_threshold: float = 0.5,
        id2damage: dict[int, str] | None = None,
        precomputed_match: dict | None = None,
        alignment_verdict: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.base_records = _boxes_to_records(base_optimised_bboxes)
        self.comparison_records = _boxes_to_records(aligned_comparison_bboxes)
        self.base_mesh = base_mesh
        self.visualise = visualise
        self.csv_output_file = csv_output_file
        self.dist_threshold = dist_threshold
        self.id2damage = id2damage or {}
        # Alignment.last_match: used when its record counts and threshold
        # fit this instance, else the auction runs (a stale carry-over can
        # cost a solve, never a wrong report)
        self.precomputed_match = precomputed_match
        # Alignment.last_verdict.to_dict(): when given, every row carries an
        # `alignment` column ("ok" or "suspect:<reason|reason>"); None keeps
        # the historical CSV schema
        self.alignment_verdict = alignment_verdict
        self.logger = logging.getLogger(__name__)

    def _centroids(self, records) -> np.ndarray:
        if not records:
            return np.zeros((0, 3), np.float32)
        return np.stack([r["corners"].mean(axis=0) for r in records])

    def match_bboxes(self) -> list[dict]:
        """Match boxes, write the CSV, return the report rows."""
        base_c = self._centroids(self.base_records)
        comp_c = self._centroids(self.comparison_records)
        n, m = base_c.shape[0], comp_c.shape[0]

        rows: list[dict] = []
        assign = np.full(n, -1, np.int64)
        pm = self.precomputed_match
        if (
            pm is not None
            and n
            and m
            and pm.get("n") == n
            and pm.get("m") == m
            and float(pm.get("threshold", float("nan"))) == float(self.dist_threshold)
            and np.shape(pm.get("assign", ()))[0:1] == (n,)
        ):
            assign = np.asarray(pm["assign"], np.int64)
        elif n and m:
            dist = np.linalg.norm(base_c[:, None, :] - comp_c[None, :, :], axis=-1)
            labels_b = np.array([r["label"] for r in self.base_records])
            labels_c = np.array([r["label"] for r in self.comparison_records])
            cost = np.where(
                labels_b[:, None] == labels_c[None, :], dist, np.inf
            ).astype(np.float32)
            # pad to bucket sizes with forbidden pairs: padded rows can only
            # take their slack, padded columns only the dummy class, so the
            # real rows' assignment is unchanged
            nb, mb = next_bucket(n, 16), next_bucket(m, 16)
            padded = np.full((nb, mb), np.inf, np.float32)
            padded[:n, :m] = cost
            a, matched = auction_assign(
                torch.as_tensor(padded, device=self.device), unmatch_cost=self.dist_threshold
            )
            a_h, matched_h = a.cpu().numpy(), matched.cpu().numpy()
            # drop padded rows; an assignment to a padded column is unmatched
            assign = np.where(matched_h & (a_h < m), a_h, -1)[:n]

        matched_cols = set(int(j) for j in assign if j >= 0)
        for i, rec in enumerate(self.base_records):
            j = int(assign[i])
            if j >= 0:
                comp = self.comparison_records[j]
                d = float(np.linalg.norm(base_c[i] - comp_c[j]))
                damage_changed = comp["damage"] != rec["damage"]
                rows.append(
                    {
                        "base_id": i,
                        "frame": rec["frame"],
                        "label": rec["label"],
                        "status": "damaged" if damage_changed else "matched",
                        "comparison_id": j,
                        "distance": round(d, 4),
                        "base_damage": self._dmg(rec["damage"]),
                        "comparison_damage": self._dmg(comp["damage"]),
                    }
                )
            else:
                rows.append(
                    {
                        "base_id": i,
                        "frame": rec["frame"],
                        "label": rec["label"],
                        "status": "missing",
                        "comparison_id": -1,
                        "distance": -1.0,
                        "base_damage": self._dmg(rec["damage"]),
                        "comparison_damage": "",
                    }
                )
        for j, rec in enumerate(self.comparison_records):
            if j not in matched_cols:
                rows.append(
                    {
                        "base_id": -1,
                        "frame": rec["frame"],
                        "label": rec["label"],
                        "status": "new",
                        "comparison_id": j,
                        "distance": -1.0,
                        "base_damage": "",
                        "comparison_damage": self._dmg(rec["damage"]),
                    }
                )

        if self.alignment_verdict is not None:
            v = self.alignment_verdict
            flag = (
                "ok"
                if v.get("ok", True)
                else "suspect:" + "|".join(v.get("reasons", ()))
            )
            for r in rows:
                r["alignment"] = flag

        self._write_csv(rows)
        n_missing = sum(1 for r in rows if r["status"] == "missing")
        n_damaged = sum(1 for r in rows if r["status"] == "damaged")
        self.logger.info(
            "BBox comparison: %d gold, %d maintenance, %d missing, %d damage-changed",
            n, m, n_missing, n_damaged,
        )
        return rows

    def _dmg(self, idx: int):
        return self.id2damage.get(int(idx), int(idx))

    def _write_csv(self, rows: list[dict]):
        fields = [
            "base_id", "frame", "label", "status", "comparison_id",
            "distance", "base_damage", "comparison_damage",
        ]
        if rows and "alignment" in rows[0]:
            fields.append("alignment")
        with open(self.csv_output_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            writer.writerows(rows)
        self.logger.info("Comparison CSV written to %s", self.csv_output_file)
