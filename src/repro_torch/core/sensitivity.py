"""Sensitivity quantification — the paper's §4 methodology as a library.

For a workload kernel K and each resource axis r, colocate K with a
calibrated stressor that consumes intensity lambda on r (and nothing
else), sweep lambda in [0, 1], and record K's predicted slowdown. The
resulting per-axis curves are the workload's *interference fingerprint*:
the multi-dimensional replacement for occupancy/arithmetic-intensity
scalars (pitfalls 1-2).

On the card the same sweep runs the CUDA stressor kernels
(repro_torch.kernels.stressors) next to the workload on separate streams
(repro_torch.calib.measure.TorchBackend); here the estimator provides the
predicted curves.

A full fingerprint (axes x lambda grid) is ONE batched estimator solve
(`sensitivity_batch` fingerprints many kernels in a single pass).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.fracsearch import member_slowdowns
from repro_torch.core.profile import KernelProfile, WorkloadProfile
from repro_torch.core.resources import RESOURCE_AXES, DeviceModel
from repro_torch.core.scenario import Scenario, group_victim_scenarios


def stressor(axis: str, intensity: float, dev: DeviceModel,
             working_set: float = 0.0) -> KernelProfile:
    """Synthetic kernel consuming `intensity` of axis capacity.

    Maps 1:1 to the stressor kernels: mxu -> stress_mxu, vpu/issue
    -> stress_vpu(ilp), hbm/l2 -> stress_hbm, smem -> stress_vmem.
    """
    demand = {r: 0.0 for r in RESOURCE_AXES}
    demand[axis] = intensity * dev.capacity(axis)
    # duration=1: the stressor occupies exactly `intensity` of the axis
    return KernelProfile(f"stress:{axis}:{intensity:.2f}", demand=demand,
                         duration=1.0, cache_working_set=working_set)


@dataclass
class SensitivityReport:
    kernel: str
    curves: Dict[str, List[float]]       # axis -> slowdown per lambda
    lambdas: List[float]
    scores: Dict[str, float]             # axis -> slowdown at lambda=0.9

    def ranked(self) -> List[str]:
        return sorted(self.scores, key=lambda a: -self.scores[a])

    def dominant(self) -> str:
        return self.ranked()[0]


def sensitivity_batch(kernels: Sequence[KernelProfile], dev: DeviceModel,
                      lambdas: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 0.9),
                      axes: Sequence[str] = RESOURCE_AXES
                      ) -> List[SensitivityReport]:
    """Fingerprint every kernel in one batched solve: scenarios are the
    (kernel x axis x lambda) grid, each pairing the kernel with the
    matching single-axis stressor."""
    kernels = list(kernels)
    if not kernels:
        return []
    stressors = [stressor(axis, lam, dev) for axis in axes for lam in lambdas]
    # one Scenario per (kernel, stressor) grid point — kernels dedup by
    # identity, so the matrix still has one row per distinct profile
    br = solve_scenarios([Scenario((k,), (st,)) for k in kernels
                          for st in stressors], dev)
    slow = br.slowdowns[:, 0].reshape(len(kernels), len(axes), len(lambdas))
    reports = []
    for ki, k in enumerate(kernels):
        curves = {a: [float(s) for s in slow[ki, ai]]
                  for ai, a in enumerate(axes)}
        scores = {a: curves[a][-1] for a in axes}
        reports.append(SensitivityReport(k.name, curves, list(lambdas),
                                         scores))
    return reports


def sensitivity(kernel: KernelProfile, dev: DeviceModel,
                lambdas: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 0.9),
                axes: Sequence[str] = RESOURCE_AXES) -> SensitivityReport:
    return sensitivity_batch([kernel], dev, lambdas, axes)[0]


def partition_curve(workloads: Sequence[WorkloadProfile], dev: DeviceModel,
                    member: int, fractions: Sequence[float]
                    ) -> Dict[str, List[float]]:
    """Paper §5.3 sweep: every member's workload slowdown as ``member``'s
    slot fraction varies (the others split the complement evenly) — the
    one-dimensional ray of the simplex the legacy fixed grid explored,
    exposed as a diagnostic for the k-way fraction search.  The whole
    (fractions x member-kernel) grid is ONE batched solve.
    """
    works = list(workloads)
    fractions = list(fractions)
    if not works or not fractions:
        return {}
    if not 0 <= member < len(works):
        raise ValueError(f"member index {member} out of range for "
                         f"{len(works)} workloads")
    reps = {w.name: w.representative_kernel(dev) for w in works}
    rest = max(len(works) - 1, 1)
    scenarios = []
    for f in fractions:
        sf = {w.name: (f if i == member else (1.0 - f) / rest)
              for i, w in enumerate(works)}
        scenarios.extend(group_victim_scenarios(works, reps, sf))
    br = solve_scenarios(scenarios, dev)
    rows_per = sum(len(w.kernels) for w in works)
    curves: Dict[str, List[float]] = {w.name: [] for w in works}
    for fi in range(len(fractions)):
        slows = member_slowdowns(
            works, dev, br.slowdowns[fi * rows_per:(fi + 1) * rows_per, 0])
        for n, s in slows.items():
            curves[n].append(float(s))
    return curves


def cache_pollution_curve(kernel: KernelProfile, dev: DeviceModel,
                          polluter_ws: Sequence[float]) -> List[float]:
    """Paper Fig. 3: slowdown of `kernel` vs a polluter's working set —
    the whole sweep is one batched solve."""
    polluter_ws = list(polluter_ws)
    if not polluter_ws:
        return []
    base_demand = {**{r: 0.0 for r in RESOURCE_AXES},
                   "hbm": dev.hbm_bw * 0.5, "l2": dev.l2_bw * 0.5}
    polluters = [KernelProfile("polluter", demand=base_demand,
                               cache_working_set=ws, cache_hit_fraction=1.0)
                 for ws in polluter_ws]
    br = solve_scenarios([Scenario((kernel,), (p,)) for p in polluters], dev)
    return [float(s) for s in br.slowdowns[:, 0]]
