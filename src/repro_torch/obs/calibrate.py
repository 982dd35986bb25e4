"""Measured-vs-modeled cost calibration (port of ``repro.obs.
calibrate``).

Every latency the serving plane prices flows through ``core.iostats.
CostModel`` constants. This module fits them to measurements: replay a
workload, record wall-clock per batch beside the ``IOStats`` the same
batch produced, and fit the constants so the model predicts the
measurement.

Within one pricing regime (host hops-granular vs device round-granular:
the switch is ``t_round > 0 and batch_rounds > 0``),
``CostModel.latency_us`` is affine in the constants, speculation
included. So each sample row's coefficient vector is recovered exactly
by finite differences at the base model (bump one constant by 1.0,
re-price, subtract), and the fit is one numpy least-squares solve.
Constants whose coefficient column is all-zero on the given workload
(e.g. ``t_round`` on host samples) are unidentifiable there and keep
their base values, reported as ``unfit``.

Presets are stored as JSON (``CalibrationPreset.save`` / ``load``) and
applied with ``preset.apply(base)``; ``load_calibrated`` overlays the
preset stored as ``results/CALIB_<name>.json`` on a base model and is
the repack scheduler's and the router's default pricing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.iostats import CostModel, IOStats

# the constants calibration targets by default — the ones the bench
# regimes actually exercise (DMA round trip, streamed block, lockstep
# round chain, occupancy-weighted round compute)
DEFAULT_FIELDS = ("t_block_io", "t_batch_block", "t_round",
                  "t_round_comp")


@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One replayed batch: the stats the model prices, the wall-clock
    the clock measured (µs; same scope — whole batch), and the pricing
    mode used when comparing."""
    stats: IOStats
    measured_us: float
    pipeline: bool = False


def _coefficients(base: CostModel, s: CalibrationSample,
                  fields: Sequence[str]) -> Tuple[np.ndarray, float]:
    """Affine decomposition of one sample's modeled latency:
    ``latency(c) = coeffs . c + intercept`` over ``fields`` (exact
    within a regime — latency is linear in each constant)."""
    l0 = base.latency_us(s.stats, s.pipeline)
    coeffs = np.zeros(len(fields))
    for j, f in enumerate(fields):
        bumped = dataclasses.replace(base, **{f: getattr(base, f) + 1.0})
        coeffs[j] = bumped.latency_us(s.stats, s.pipeline) - l0
    intercept = l0 - float(
        coeffs @ np.array([getattr(base, f) for f in fields]))
    return coeffs, intercept


def _error_report(model: CostModel,
                  samples: Sequence[CalibrationSample]) -> Dict[str, float]:
    measured = np.array([s.measured_us for s in samples], float)
    modeled = np.array([model.latency_us(s.stats, s.pipeline)
                        for s in samples], float)
    denom = np.maximum(np.abs(measured), 1e-9)
    rel = np.abs(modeled - measured) / denom
    return {"mean_abs_rel_err": float(rel.mean()),
            "max_abs_rel_err": float(rel.max()),
            "mean_measured_us": float(measured.mean()),
            "mean_modeled_us": float(modeled.mean())}


def fit_cost_model(base: CostModel,
                   samples: Sequence[CalibrationSample],
                   fields: Sequence[str] = DEFAULT_FIELDS,
                   ) -> Tuple[CostModel, Dict]:
    """Least-squares fit of ``fields`` to the measured latencies.

    Returns ``(fitted_model, report)`` where the report carries the
    fitted constants, which fields were unidentifiable (``unfit``), and
    modeled-vs-measured error before and after the fit. Fitted values
    are clipped at 0 (a negative latency constant is a fit artifact,
    not physics)."""
    if not samples:
        raise ValueError("calibration needs at least one sample")
    rows = [_coefficients(base, s, fields) for s in samples]
    a = np.stack([c for c, _ in rows])                 # [S, F]
    b = np.array([s.measured_us for s in samples]) \
        - np.array([i for _, i in rows])               # [S]

    identifiable = [j for j in range(len(fields))
                    if np.abs(a[:, j]).max() > 0]
    unfit = [fields[j] for j in range(len(fields))
             if j not in identifiable]
    fitted: Dict[str, float] = {}
    if identifiable:
        sol, *_ = np.linalg.lstsq(a[:, identifiable], b, rcond=None)
        for j, col in enumerate(identifiable):
            fitted[fields[col]] = float(max(sol[j], 0.0))
    model = dataclasses.replace(base, **fitted) if fitted else base
    report = {
        "backend": base.name,
        "n_samples": len(samples),
        "fields": list(fields),
        "fitted": fitted,
        "unfit": unfit,
        "base": {f: getattr(base, f) for f in fields},
        "error_before": _error_report(base, samples),
        "error_after": _error_report(model, samples),
    }
    return model, report


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
        keep the base's documented defaults."""
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
    """The shipped preset with any stored calibration applied on top.

    Looks for ``results/CALIB_<base.name>.json`` (under the repository
    root unless ``results_dir`` is given) and overlays its fitted
    constants via ``CalibrationPreset.apply``. Any way the preset cannot
    be honored — file missing, unparseable, or fitted for a different
    backend — falls back to ``base`` unchanged, so callers (the
    ``RepackScheduler``, the router) can use this as their default
    pricing unconditionally."""
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


def calibrate(base: CostModel, samples: Sequence[CalibrationSample],
              fields: Sequence[str] = DEFAULT_FIELDS,
              source: str = "",
              preset_path: Optional[str] = None,
              ) -> Tuple[CostModel, CalibrationPreset, Dict]:
    """Fit + package + (optionally) store — the one-call harness the
    obs bench uses per backend regime."""
    model, report = fit_cost_model(base, samples, fields)
    preset = CalibrationPreset.from_report(report, source=source)
    if preset_path is not None:
        preset.save(preset_path)
    return model, preset, report
