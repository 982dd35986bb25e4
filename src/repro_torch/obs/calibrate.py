"""Stored cost-model calibrations (the loading half of
``repro.obs.calibrate``).

A ``CalibrationPreset`` holds the ``CostModel`` constants a measured
replay fitted, with their provenance; ``load_calibrated`` overlays the
preset stored as ``results/CALIB_<name>.json`` on a base model and is
the repack scheduler's default pricing. The fitting half
(``fit_cost_model``, ``calibrate``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

from repro_torch.core.iostats import CostModel


@dataclasses.dataclass
class CalibrationPreset:
    """A stored per-backend calibration: the fitted constants plus the
    provenance needed to trust them (sample count, residual error)."""
    backend: str                       # base CostModel name it fits
    constants: Dict[str, float]        # fitted constants only
    unfit: List[str]                   # requested but unidentifiable
    n_samples: int
    error: Dict[str, float]            # post-fit modeled-vs-measured
    source: str = ""                   # workload that produced it

    def apply(self, base: CostModel) -> CostModel:
        """Overlay the fitted constants on ``base``; unfit constants
        keep the base's defaults."""
        if base.name != self.backend:
            raise ValueError(
                f"preset calibrates backend {self.backend!r}, "
                f"got model {base.name!r}")
        return dataclasses.replace(base, **self.constants)

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2,
                      sort_keys=True)

    @classmethod
    def load(cls, path) -> "CalibrationPreset":
        with open(path) as f:
            raw = json.load(f)
        return cls(**raw)

    @classmethod
    def from_report(cls, report: Dict,
                    source: str = "") -> "CalibrationPreset":
        return cls(backend=report["backend"],
                   constants=dict(report["fitted"]),
                   unfit=list(report["unfit"]),
                   n_samples=int(report["n_samples"]),
                   error=dict(report["error_after"]),
                   source=source)


def load_calibrated(base: CostModel, results_dir=None) -> CostModel:
    """``base`` with the stored calibration ``results/CALIB_<base.name>.
    json`` (under the repository root unless ``results_dir`` is given)
    applied on top; ``base`` unchanged when the file is missing,
    unparseable or fitted for another backend."""
    if results_dir is None:
        # src/repro_torch/obs/calibrate.py -> repository root / results
        here = os.path.dirname(os.path.abspath(__file__))
        results_dir = os.path.join(here, "..", "..", "..", "results")
    path = os.path.join(results_dir, f"CALIB_{base.name}.json")
    if not os.path.exists(path):
        return base
    try:
        return CalibrationPreset.load(path).apply(base)
    except (ValueError, KeyError, TypeError, json.JSONDecodeError,
            OSError):
        return base
