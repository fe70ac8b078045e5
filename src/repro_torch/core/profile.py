"""Kernel / workload resource profiles — the paper's per-kernel NCU metric
vector, one level deeper than any single utilization scalar.

A ``KernelProfile`` records absolute demand per execution on every resource
axis (FLOPs, bytes, instructions); ``utilization(dev)`` converts to the
fraction of each axis consumed while the kernel runs at full speed, which
is what the interference estimator consumes.

Profiles come from two sources here:
  * ``analytic_*``: closed-form profiles of the microbenchmark stressors;
  * the serve engine's analytic per-phase profiles
    (``repro_torch.serve.engine.Engine._phase_profile``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.resources import AXIS_INDEX, RESOURCE_AXES, DeviceModel

_HBM = AXIS_INDEX["hbm"]
_L2 = AXIS_INDEX["l2"]


@dataclass(frozen=True)
class KernelProfile:
    name: str
    demand: Dict[str, float]          # axis -> absolute work per execution
    duration: Optional[float] = None  # isolated wall-time; None => resource
                                      # bound (max of roofline terms). A
                                      # duration above every roofline term
                                      # models latency-/ILP-bound kernels
                                      # (paper: 24%-FP64-pipe kernel).
    cache_working_set: float = 0.0    # bytes in shared cache (L2/VMEM)
    cache_hit_fraction: float = 0.0   # fraction of hbm demand cacheable
    slots_needed: int = 0             # SMs/cores required (0 = flexible)
    duration_weight: float = 1.0      # relative time share inside workload

    def utilization(self, dev: DeviceModel,
                    cache_share: float = 1.0) -> Dict[str, float]:
        """Fraction of each axis consumed while running: u[r] =
        (d[r]/t)/C_r, with cache hits discounting HBM demand."""
        t = self.isolated_time(dev, cache_share)
        if t <= 0:
            return {r: 0.0 for r in RESOURCE_AXES}
        eff = self.effective_demand(dev, cache_share)
        return {r: (eff.get(r, 0.0) / t) / max(dev.capacity(r), 1e-9)
                for r in RESOURCE_AXES}

    def effective_demand(self, dev: DeviceModel,
                         cache_share: float = 1.0) -> Dict[str, float]:
        d = dict(self.demand)
        if self.cache_working_set > 0 and self.cache_hit_fraction > 0:
            resident = min(1.0, (dev.cache_capacity * cache_share)
                           / max(self.cache_working_set, 1.0))
            hit = self.cache_hit_fraction * resident
            d["hbm"] = d.get("hbm", 0.0) * (1.0 - hit)
            d["l2"] = max(d.get("l2", 0.0), self.demand.get("hbm", 0.0))
        return d

    def isolated_time(self, dev: DeviceModel,
                      cache_share: float = 1.0) -> float:
        eff = self.effective_demand(dev, cache_share)
        t = max((eff.get(r, 0.0) / max(dev.capacity(r), 1e-9))
                for r in RESOURCE_AXES)
        return max(t, self.duration or 0.0)

    def bottleneck(self, dev: DeviceModel) -> str:
        eff = self.effective_demand(dev)
        return max(RESOURCE_AXES,
                   key=lambda r: eff.get(r, 0.0) / max(dev.capacity(r), 1e-9))


@dataclass(frozen=True)
class WorkloadProfile:
    """A workload = weighted sequence of kernels/phases (per-kernel
    granularity is the paper's takeaway #1)."""
    name: str
    kernels: Tuple[KernelProfile, ...]
    slo_slowdown: float = 1.2          # max acceptable slowdown

    def total_time(self, dev: DeviceModel) -> float:
        return sum(k.isolated_time(dev) * k.duration_weight
                   for k in self.kernels)

    def mixed_utilization(self, dev: DeviceModel) -> Dict[str, float]:
        """Time-weighted average utilization vector."""
        tot = self.total_time(dev)
        u = {r: 0.0 for r in RESOURCE_AXES}
        for k in self.kernels:
            t = k.isolated_time(dev) * k.duration_weight
            ku = k.utilization(dev)
            for r in RESOURCE_AXES:
                u[r] += ku[r] * (t / max(tot, 1e-12))
        return u

    def representative_kernel(self, dev: DeviceModel) -> KernelProfile:
        """Time-weighted aggregate kernel, named after the workload: the
        steady-background stand-in the scheduler prices co-runners
        against (and the slot-fraction anchor — fraction dicts keyed by
        the workload name bind to this kernel)."""
        u = self.mixed_utilization(dev)
        t = self.total_time(dev)
        return KernelProfile(self.name, demand={
            r: u[r] * dev.capacity(r) * t for r in u})


# --------------------------------------------------------------------- #
#  ProfileMatrix — dense (kernels x axes) compilation of KernelProfiles  #
# --------------------------------------------------------------------- #
# The batch estimator's input format: every per-kernel scalar/dict of
# KernelProfile becomes one dense float64 array, so the cache model,
# roofline times, and utilizations of ANY number of kernels are single
# NumPy expressions. The three helpers below are the vectorized twins of
# KernelProfile.effective_demand / isolated_time / utilization and accept
# arbitrary leading batch shape (..., K) / (..., K, A).

def effective_demand_arrays(demand: np.ndarray, ws: np.ndarray,
                            hit: np.ndarray, cache_capacity: float,
                            cache_share) -> np.ndarray:
    """Vectorized KernelProfile.effective_demand: cache hits discount HBM
    traffic; the absorbed stream reappears as L2 bandwidth demand."""
    d = np.array(demand, np.float64, copy=True)
    cached = (ws > 0) & (hit > 0)
    resident = np.minimum(1.0, (cache_capacity * np.asarray(cache_share))
                          / np.maximum(ws, 1.0))
    hit_f = hit * resident
    d[..., _HBM] = np.where(cached, demand[..., _HBM] * (1.0 - hit_f),
                            demand[..., _HBM])
    d[..., _L2] = np.where(cached,
                           np.maximum(demand[..., _L2], demand[..., _HBM]),
                           demand[..., _L2])
    return d


def isolated_time_arrays(eff: np.ndarray, duration: np.ndarray,
                         cap_vec: np.ndarray) -> np.ndarray:
    """Vectorized KernelProfile.isolated_time: roofline max over axes,
    floored by the latency-bound duration."""
    return np.maximum((eff / cap_vec).max(-1), duration)


def utilization_arrays(eff: np.ndarray, t: np.ndarray,
                       cap_vec: np.ndarray) -> np.ndarray:
    """Vectorized KernelProfile.utilization: u = (d/t)/C, zero for t<=0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (eff / t[..., None]) / cap_vec
    return np.where(t[..., None] > 0, u, 0.0)


@dataclass(frozen=True)
class ProfileMatrix:
    """KernelProfiles compiled once into dense arrays (one row per kernel).

    demand is (K, A) in RESOURCE_AXES order; duration/ws/hit/slots are
    (K,). Rows are addressed by position; ``index`` maps names to rows.
    """
    names: Tuple[str, ...]
    demand: np.ndarray
    duration: np.ndarray
    cache_working_set: np.ndarray
    cache_hit_fraction: np.ndarray
    slots_needed: np.ndarray

    @classmethod
    def from_profiles(cls, profiles: Sequence[KernelProfile]) -> "ProfileMatrix":
        ks = list(profiles)
        demand = np.zeros((len(ks), len(RESOURCE_AXES)), np.float64)
        for i, k in enumerate(ks):
            for r, a in AXIS_INDEX.items():
                demand[i, a] = k.demand.get(r, 0.0)
        return cls(
            names=tuple(k.name for k in ks),
            demand=demand,
            duration=np.array([k.duration or 0.0 for k in ks], np.float64),
            cache_working_set=np.array([k.cache_working_set for k in ks],
                                       np.float64),
            cache_hit_fraction=np.array([k.cache_hit_fraction for k in ks],
                                        np.float64),
            slots_needed=np.array([k.slots_needed for k in ks], np.float64),
        )

    @classmethod
    def from_arrays(cls, names: Sequence[str], demand: np.ndarray,
                    duration=None, cache_working_set=None,
                    cache_hit_fraction=None, slots_needed=None
                    ) -> "ProfileMatrix":
        """Build directly from dense arrays (analytic consumers: the serve
        engine's chunk candidates, the sensitivity stressor grids)."""
        n = len(names)

        def _vec(x):
            if x is None:
                return np.zeros(n, np.float64)
            return np.broadcast_to(np.asarray(x, np.float64), (n,)).copy()

        return cls(tuple(names), np.asarray(demand, np.float64),
                   _vec(duration), _vec(cache_working_set),
                   _vec(cache_hit_fraction), _vec(slots_needed))

    def __len__(self) -> int:
        return len(self.names)

    @property
    def index(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.names)}

    def effective_demand(self, dev: DeviceModel, cache_share=1.0) -> np.ndarray:
        share = np.broadcast_to(np.asarray(cache_share, np.float64),
                                self.duration.shape)
        return effective_demand_arrays(self.demand, self.cache_working_set,
                                       self.cache_hit_fraction,
                                       dev.cache_capacity, share)

    def isolated_time(self, dev: DeviceModel, cache_share=1.0) -> np.ndarray:
        return isolated_time_arrays(self.effective_demand(dev, cache_share),
                                    self.duration, dev.capacity_vector())

    def utilization(self, dev: DeviceModel, cache_share=1.0) -> np.ndarray:
        eff = self.effective_demand(dev, cache_share)
        t = isolated_time_arrays(eff, self.duration, dev.capacity_vector())
        return utilization_arrays(eff, t, dev.capacity_vector())

    def profile(self, i: int) -> KernelProfile:
        """Row back to a KernelProfile (debugging / interop)."""
        return KernelProfile(
            self.names[i],
            demand={r: float(self.demand[i, a])
                    for r, a in AXIS_INDEX.items()},
            duration=float(self.duration[i]) or None,
            cache_working_set=float(self.cache_working_set[i]),
            cache_hit_fraction=float(self.cache_hit_fraction[i]),
            slots_needed=int(self.slots_needed[i]))


# --------------------------------------------------------------------- #
#  Analytic profiles                                                     #
# --------------------------------------------------------------------- #
def analytic_matmul(name: str, m: int, n: int, k: int, dtype_bytes: int = 2,
                    iters: int = 1) -> KernelProfile:
    flops = 2.0 * m * n * k * iters
    bytes_ = (m * k + k * n + m * n) * dtype_bytes
    return KernelProfile(name, demand={
        "mxu": flops, "vpu": 0.0, "issue": flops / 256.0,
        "hbm": bytes_, "l2": bytes_, "smem": flops / 50.0, "ici": 0.0})


def analytic_copy(name: str, nbytes: float, passes: int = 1,
                  hit_fraction: float = 0.0) -> KernelProfile:
    b = 2.0 * nbytes * passes
    return KernelProfile(name, demand={
        "mxu": 0.0, "vpu": nbytes / 4 * passes, "issue": nbytes / 16 * passes,
        "hbm": b, "l2": b, "smem": 0.0, "ici": 0.0},
        cache_working_set=2.0 * nbytes, cache_hit_fraction=hit_fraction)


def analytic_vpu(name: str, elems: float, iters: int, ilp: int = 1) -> KernelProfile:
    flops = 2.0 * elems * iters * ilp
    return KernelProfile(name, demand={
        "mxu": 0.0, "vpu": flops, "issue": flops / 2.0,
        "hbm": elems * 8, "l2": elems * 8, "smem": 0.0, "ici": 0.0})
