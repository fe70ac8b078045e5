"""Held-out validation — score fitted profiles on mixes the fitter never saw.

The fit sweep uses single-stressor probes; a fit that only reproduces
its own training points is just a second analytic model (PAPERS.md,
"Characterizing ... Workloads Under Interference").  This module builds
*held-out* colocations — k-way victim+cohort mixes and off-grid stressor
intensities — measures them on the backend (which knows the hidden
truth), predicts them with the fitted profiles, and reports per-mix and
per-axis relative error.  ``ValidationReport.max_rel_error`` is the
number the bench gate holds under 5%.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.calib.fit import predict_slowdowns
from repro_torch.calib.measure import Colocation, StressorSpec
from repro_torch.core.profile import KernelProfile
from repro_torch.core.resources import RESOURCE_AXES

# intensities BETWEEN the fit grid points (FIT_LAMBDAS) — per-axis
# generalization off the training grid
HOLDOUT_LAMBDAS: Tuple[float, ...] = (0.33, 0.66, 0.85)


def holdout_mixes(names: Sequence[str], rng: np.random.Generator,
                  n_mixes: int = 24, ks: Sequence[int] = (2, 3),
                  axes: Sequence[str] = RESOURCE_AXES,
                  lambdas: Sequence[float] = HOLDOUT_LAMBDAS
                  ) -> List[Colocation]:
    """Held-out plan: per-axis off-grid stressor probes for every victim,
    plus ``n_mixes`` random k-way victim+cohort colocations (optionally
    with one random stressor riding along).  Seeded → reproducible."""
    names = list(names)
    out: List[Colocation] = []
    for v in names:
        for axis in axes:
            for lam in lambdas:
                out.append(Colocation(v, (StressorSpec(axis, lam),)))
    if len(names) >= 2:
        for _ in range(n_mixes):
            k = int(rng.choice(list(ks)))
            k = min(k, len(names))
            picks = list(rng.choice(names, size=k, replace=False))
            victim, cohort = picks[0], tuple(picks[1:])
            stressors: Tuple[StressorSpec, ...] = ()
            if rng.random() < 0.5:
                axis = str(rng.choice(list(axes)))
                stressors = (StressorSpec(
                    axis, float(rng.uniform(0.2, 0.8))),)
            out.append(Colocation(victim, stressors, cohort))
    return out


@dataclass
class ValidationReport:
    device: str
    n_mixes: int
    max_rel_error: float
    mean_rel_error: float
    per_victim: Dict[str, float]          # victim -> max rel error
    per_axis: Dict[str, float]            # axis (single-stressor) -> max
    worst_mix: str = ""

    def to_json(self) -> Dict[str, object]:
        return {"device": self.device, "n_mixes": self.n_mixes,
                "max_rel_error": self.max_rel_error,
                "mean_rel_error": self.mean_rel_error,
                "per_victim": dict(sorted(self.per_victim.items())),
                "per_axis": dict(sorted(self.per_axis.items())),
                "worst_mix": self.worst_mix}


def _mix_label(c: Colocation) -> str:
    parts = [c.victim]
    parts += [f"{s.axis}@{s.intensity:.2f}" for s in c.stressors]
    parts += list(c.cohort)
    return "+".join(parts)


def validate(fitted: Mapping[str, KernelProfile], backend,
             mixes: Sequence[Colocation]) -> ValidationReport:
    """Measure ``mixes`` on ``backend`` (truth), predict them with
    ``fitted``, report relative error.  Backend is any object with
    ``measure(colocations) -> np.ndarray`` and a ``device`` attr —
    ``SyntheticBackend`` on the CPU, ``TorchBackend`` on the card."""
    mixes = list(mixes)
    dev = backend.device
    observed = np.asarray(backend.measure(mixes), np.float64)
    predicted = predict_slowdowns(fitted, mixes, dev)
    rel = np.abs(predicted - observed) / np.maximum(observed, 1e-9)

    per_victim: Dict[str, float] = {}
    per_axis: Dict[str, float] = {}
    for i, c in enumerate(mixes):
        per_victim[c.victim] = max(per_victim.get(c.victim, 0.0),
                                   float(rel[i]))
        axis = c.single_axis
        if axis is not None:
            per_axis[axis] = max(per_axis.get(axis, 0.0), float(rel[i]))
    worst = int(np.argmax(rel)) if len(rel) else 0
    return ValidationReport(
        device=dev.name, n_mixes=len(mixes),
        max_rel_error=float(np.max(rel)) if len(rel) else 0.0,
        mean_rel_error=float(np.mean(rel)) if len(rel) else 0.0,
        per_victim=per_victim, per_axis=per_axis,
        worst_mix=_mix_label(mixes[worst]) if len(mixes) else "")
