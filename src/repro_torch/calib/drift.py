"""Online drift monitor — when the model and the hardware disagree, say so.

Calibration decays: a tenant changes its batch shape, a compiler upgrade
moves a kernel off the MXU, and the fitted profile quietly stops
predicting.  ``DriftMonitor`` watches every resident workload's
predicted-vs-observed slowdown as an EWMA of ``ln(observed/predicted)``
(log-space so over- and under-prediction are symmetric), flags a tenant
whose smoothed divergence exceeds the threshold after a warmup count,
and can **re-fit** the flagged workload from its recent observations —
a 1-D demand-scale search through the estimator against the stored
colocation contexts, which fixes the dominant drift mode (the workload
got uniformly heavier/lighter) without a full sweep.

``FleetScheduler.attach_calibration`` wires a monitor into the fleet
event loop; ``repro_torch.sim`` feeds it per-tick observations and surfaces
the counters in the sim report (the reference's ``bench_calib`` gates
flag/refit behaviour and bit-identical reports).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.profile import KernelProfile, WorkloadProfile
from repro_torch.core.resources import DeviceModel
from repro_torch.core.scenario import Scenario


@dataclass(frozen=True)
class DriftConfig:
    alpha: float = 0.3           # EWMA smoothing of ln(obs/pred)
    threshold: float = 0.15      # flag when |ewma| > ln(1+threshold)
    warmup: int = 5              # observations before flagging is allowed
    history: int = 32            # stored samples per workload (refit data)
    max_refits: int = 5          # per-workload refit budget
    scale_grid: int = 13         # candidates per refit search stage


@dataclass(frozen=True)
class DriftSample:
    """One observation with enough context to re-predict it later: the
    colocation the workload was in when the slowdown was observed."""
    observed: float
    predicted: float
    background: Tuple[KernelProfile, ...]
    slot_fraction: Optional[Mapping[str, float]]
    device: DeviceModel


@dataclass
class _State:
    ewma: float = 0.0
    count: int = 0
    flagged: bool = False
    refits: int = 0
    samples: Deque[DriftSample] = field(default_factory=deque)


class DriftMonitor:
    """Per-workload EWMA drift detection + observation-driven re-fit."""

    def __init__(self, cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self._states: Dict[str, _State] = {}
        self.flag_log: List[str] = []    # every name ever flagged, in order
        self.observations = 0

    # -------------------------------------------------------------- #
    #  Observation path                                               #
    # -------------------------------------------------------------- #
    def observe(self, name: str, predicted: float, observed: float,
                background: Sequence[KernelProfile] = (),
                slot_fraction: Optional[Mapping[str, float]] = None,
                device: Optional[DeviceModel] = None) -> bool:
        """Record one predicted-vs-observed pair; returns True iff this
        observation NEWLY flags the workload."""
        st = self._states.setdefault(name, _State())
        if len(st.samples) >= self.cfg.history:
            st.samples.popleft()
        if device is not None:
            st.samples.append(DriftSample(
                float(observed), float(predicted), tuple(background),
                dict(slot_fraction) if slot_fraction else None, device))
        r = math.log(max(observed, 1e-9) / max(predicted, 1e-9))
        st.ewma = r if st.count == 0 else \
            self.cfg.alpha * r + (1.0 - self.cfg.alpha) * st.ewma
        st.count += 1
        self.observations += 1
        if st.flagged or st.count < self.cfg.warmup:
            return False
        if abs(st.ewma) > math.log1p(self.cfg.threshold):
            st.flagged = True
            self.flag_log.append(name)
            return True
        return False

    def is_flagged(self, name: str) -> bool:
        st = self._states.get(name)
        return bool(st and st.flagged)

    @property
    def flagged(self) -> List[str]:
        return sorted(n for n, s in self._states.items() if s.flagged)

    @property
    def flags(self) -> int:
        return len(self.flag_log)

    @property
    def refits(self) -> int:
        return sum(s.refits for s in self._states.values())

    def divergence(self, name: str) -> float:
        """Current smoothed |obs/pred − 1| estimate (0 if unseen)."""
        st = self._states.get(name)
        return math.expm1(abs(st.ewma)) if st and st.count else 0.0

    def forget(self, name: str) -> None:
        """Workload left the fleet — drop its state entirely."""
        self._states.pop(name, None)

    # -------------------------------------------------------------- #
    #  Re-fit path                                                    #
    # -------------------------------------------------------------- #
    def can_refit(self, name: str) -> bool:
        st = self._states.get(name)
        return bool(st and st.samples
                    and st.refits < self.cfg.max_refits)

    def refit(self, name: str,
              believed: WorkloadProfile) -> Optional[WorkloadProfile]:
        """Re-fit ``believed`` from the stored observations: search a
        global demand scale ``s`` (all kernel demands × s) minimizing
        squared relative error of re-predicted vs observed slowdowns
        over the sample history, coarse log grid then one refinement.
        Returns the corrected profile (and resets the drift state), or
        None when no samples / refit budget is spent."""
        st = self._states.get(name)
        if st is None or not st.samples \
                or st.refits >= self.cfg.max_refits:
            return None
        # fit against the samples that actually diverged: the history
        # spans the shift boundary, and pre-shift obs==pred samples
        # would drag the scale back toward 1 (costing extra
        # flag-refit-flag rounds before convergence)
        gate = 0.5 * math.log1p(self.cfg.threshold)
        samples = [s for s in st.samples
                   if abs(math.log(max(s.observed, 1e-9)
                                   / max(s.predicted, 1e-9))) > gate]
        if not samples:
            samples = list(st.samples)
        dev = samples[0].device
        t_believed = max(believed.total_time(dev), 1e-12)

        def candidates_for(scales: np.ndarray) -> np.ndarray:
            # price each candidate exactly like the fleet does: the
            # workload's ACTUAL kernels as victims (a representative
            # kernel renormalizes away the demand scale we are trying
            # to recover), folded duration-weighted, rebased to the
            # believed baseline the observations were recorded against
            scenarios = []
            rebase = np.empty(len(scales), np.float64)
            weights = []
            for i, s in enumerate(scales):
                w = scale_workload(believed, float(s))
                rebase[i] = w.total_time(dev) / t_believed
                wts = np.asarray([k.isolated_time(dev) * k.duration_weight
                                  for k in w.kernels], np.float64)
                weights.append(wts / max(wts.sum(), 1e-12))
                for k in w.kernels:
                    for smp in samples:
                        scenarios.append(Scenario(
                            (k,), smp.background, smp.slot_fraction,
                            smp.device))
            raw = np.asarray(
                solve_scenarios(scenarios, dev).slowdowns[:, 0],
                np.float64).reshape(len(scales), len(believed.kernels),
                                    len(samples))
            obs = np.asarray([smp.observed for smp in samples], np.float64)
            fold = np.einsum("ck,cks->cs", np.asarray(weights), raw)
            pred = np.maximum(fold * rebase[:, None], 1.0)
            rel = (pred - obs[None, :]) / np.maximum(obs[None, :], 1e-9)
            return np.mean(rel * rel, axis=1)

        # wide coarse grid: for a duration-bound workload every scale
        # below 1/u_max predicts identically (background reps normalize,
        # own demand stays below the water level), so the informative
        # region can sit far from 1 — cover [1/16, 16], then refine
        coarse = np.exp(np.linspace(math.log(1.0 / 16.0), math.log(16.0),
                                    2 * self.cfg.scale_grid - 1))
        losses = candidates_for(coarse)
        s0 = float(coarse[int(np.argmin(losses))])
        fine = s0 * np.exp(np.linspace(-0.35, 0.35, self.cfg.scale_grid))
        losses = candidates_for(fine)
        s1 = float(fine[int(np.argmin(losses))])
        finer = s1 * np.exp(np.linspace(-0.06, 0.06, self.cfg.scale_grid))
        losses = candidates_for(finer)
        s_best = float(finer[int(np.argmin(losses))])

        st.refits += 1
        st.ewma = 0.0
        st.count = 0
        st.flagged = False
        st.samples.clear()
        return scale_workload(believed, s_best)

    def to_json(self) -> Dict[str, object]:
        return {"observations": self.observations,
                "flags": self.flags,
                "refits": self.refits,
                "flagged_tenants": sorted(set(self.flag_log))}


def scale_workload(w: WorkloadProfile, s: float) -> WorkloadProfile:
    kernels = tuple(replace(
        k, demand={r: d * s for r, d in k.demand.items()})
        for k in w.kernels)
    return replace(w, kernels=kernels)
