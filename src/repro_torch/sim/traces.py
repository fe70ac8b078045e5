"""Deterministic multi-tenant request-trace generation.

A trace is the simulator's *input tape*: tenant arrivals/departures
(fleet events), per-tenant request streams (serving events), and
optional injected faults — all as ``repro_torch.ft.inject.InjectEvent``s on a
virtual-time axis, so one sorted event list drives both the fleet event
loop and the request-serving loop.

Every stochastic choice flows through ONE explicit
``numpy.random.Generator`` in a fixed loop order — no module-level RNG
anywhere — so the same seed reproduces the same tenants, the same
request timestamps, and (through the deterministic fleet replay) the
same simulated metrics bit-for-bit.

Trace shape
  * **tenants** — ``n_tenants`` long-lived services, each an
    interference ``WorkloadProfile`` derived from a model config drawn
    from the family registry (``repro_torch.configs.registry``): the config's
    family picks the resource-axis mix (dense/moe decode is
    bandwidth-bound, ssm scan leans on vpu/smem, vision/speech encoders
    on mxu), the tenant's intensity scales it.  A ``slo_fraction`` of
    tenants are SLO class (tight ``slo_slowdown``, a per-token latency
    target); the rest are best-effort.
  * **arrivals** — a configurable fraction lands in a same-tick storm at
    t=0 (exercising the fleet's batched admission); the rest ramp in.
    Best-effort tenants churn: a ``churn_fraction`` departs mid-trace
    and is replaced by a fresh tenant.
  * **requests** — per-tenant non-homogeneous Poisson arrivals
    (thinning) with rate ``base_rate x day-curve x burst``: a sinusoidal
    diurnal curve (per-tenant phase) and fleet-wide burst-storm windows
    that multiply every tenant's rate.  Request sizes are
    exponential-tailed token counts.
  * **faults** — device kills / stragglers at scripted times, reusing
    the ``repro_torch.ft.inject`` event vocabulary verbatim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.registry import ASSIGNED, PAPER_WORKLOADS
from repro_torch.core.fleet import BEST_EFFORT, SLO
from repro_torch.core.profile import KernelProfile, WorkloadProfile
from repro_torch.core.resources import RESOURCE_AXES, TPU_V5E, DeviceModel
from repro_torch.ft.inject import InjectEvent, arrive, depart, kill, slow

# resource-axis mix per model family (fraction of the tenant's intensity
# landing on each axis): decode serving of dense/moe decoders is
# bandwidth-bound (weight + kv streaming), ssm scans lean on vector +
# scratch, vision/speech encoders are matmul-heavy — the paper's point
# that "GPU util" hides exactly these differences.
FAMILY_AXIS_MIX: Dict[str, Dict[str, float]] = {
    "dense":  dict(mxu=0.50, vpu=0.10, issue=0.12, smem=0.06,
                   hbm=1.00, l2=1.00),
    "moe":    dict(mxu=0.35, vpu=0.10, issue=0.10, smem=0.05,
                   hbm=1.00, l2=0.90),
    "ssm":    dict(mxu=0.25, vpu=0.90, issue=0.50, smem=0.30,
                   hbm=0.60, l2=0.60),
    "hybrid": dict(mxu=0.40, vpu=0.55, issue=0.30, smem=0.18,
                   hbm=0.85, l2=0.85),
    "vlm":    dict(mxu=1.00, vpu=0.15, issue=0.30, smem=0.30,
                   hbm=0.50, l2=0.50),
    "audio":  dict(mxu=0.85, vpu=0.40, issue=0.30, smem=0.20,
                   hbm=0.60, l2=0.60),
}


def request(t: float, tenant: str, req_id: int, n_tokens: int) -> InjectEvent:
    """One serving request: ``n_tokens`` of decode for ``tenant``.  The
    fleet event loop ignores these; the simulator serves them."""
    return InjectEvent(t, "request", {"tenant": tenant, "req_id": req_id,
                                      "n_tokens": int(n_tokens)})


def profile_shift(t: float, tenant: str, demand_scale: float) -> InjectEvent:
    """Mid-trace calibration drift: from ``t`` on, ``tenant``'s TRUE
    resource demand is its profile's scaled by ``demand_scale`` while
    the fleet keeps believing the original — the drift monitor's job
    (``repro_torch.calib.drift``) is to notice and trigger a re-fit."""
    return InjectEvent(t, "profile-shift",
                       {"tenant": tenant, "demand_scale": float(demand_scale)})


@dataclass(frozen=True)
class TraceConfig:
    """Knobs of one generated trace (all stochastic draws come from the
    explicit Generator passed to ``generate_trace``; ``seed`` only names
    the default one)."""
    seed: int = 0
    duration: float = 300.0          # virtual seconds of request traffic
    n_tenants: int = 32
    slo_fraction: float = 0.5        # fraction of tenants in the SLO class
    storm_fraction: float = 0.5      # tenants arriving in the t=0 storm
    arrival_ramp: float = 8.0        # the rest arrive over (0, ramp]
    base_rate: float = 0.30          # requests/s/tenant at day-curve mean
    diurnal_amplitude: float = 0.6   # day-curve swing (+-)
    diurnal_period: float = 120.0    # virtual seconds per "day"
    n_bursts: int = 3                # fleet-wide burst-storm windows
    burst_factor: float = 4.0        # rate multiplier inside a burst
    burst_duration: float = 6.0
    churn_fraction: float = 0.25     # of best-effort tenants depart+replace
    min_tokens: int = 8
    mean_tokens: float = 48.0
    max_tokens: int = 256
    time_scale: float = 0.002        # profile step-time -> virtual s/token
    slo_queue_margin: float = 2.0    # per-token SLO headroom over the
                                     # interference SLO
    queue_slack: float = 4.0         # additive first-token slack (s): the
                                     # TTFT half of the TTFT+TBT deadline,
                                     # covering scheduling/queueing delay
    kills: Tuple[Tuple[float, str], ...] = ()    # (t, device_id)
    slows: Tuple[Tuple[float, str], ...] = ()    # (t, device_id)
    # (t, tenant, demand_scale): the tenant's true demand shifts while
    # the fleet's belief stays — exercises the calib drift monitor
    profile_shifts: Tuple[Tuple[float, str, float], ...] = ()


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: its fleet-side interference profile plus the serving-
    side request-latency model derived from it."""
    name: str
    arch: str                        # registry config the tenant runs
    family: str
    priority: str                    # SLO | BEST_EFFORT
    profile: WorkloadProfile
    tbt_base: float                  # isolated virtual seconds per token
    tbt_slo: float                   # per-token deadline contribution
    arrival: float
    depart: Optional[float] = None   # churn departure (best-effort only)


@dataclass
class Trace:
    """A replayable trace: feed ``events`` to the simulator (or any
    ``FaultInjector``-style loop) as many times as you like."""
    config: TraceConfig
    tenants: Dict[str, TenantSpec]
    events: List[InjectEvent] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.config.duration

    @property
    def n_requests(self) -> int:
        return sum(1 for e in self.events if e.kind == "request")

    def requests_of(self, tenant: str) -> List[InjectEvent]:
        return [e for e in self.events
                if e.kind == "request" and e.payload["tenant"] == tenant]

    def tenants_of(self, priority: str) -> List[TenantSpec]:
        return [t for t in self.tenants.values() if t.priority == priority]

    def summary(self) -> Dict:
        kinds: Dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        return {
            "seed": self.config.seed,
            "duration": self.config.duration,
            "tenants": len(self.tenants),
            "slo_tenants": len(self.tenants_of(SLO)),
            "requests": self.n_requests,
            "events": kinds,
        }


# ------------------------------------------------------------------ #
#  Tenant profile synthesis                                            #
# ------------------------------------------------------------------ #
def tenant_profile(rng: np.random.Generator, name: str, arch,
                   dev: DeviceModel, priority: str) -> WorkloadProfile:
    """Interference profile of one tenant's resident serving instance.

    The config's family selects the axis mix; the tenant's intensity
    (peak utilization of its bottleneck axis) and SLO tightness are
    drawn from ``rng``.  Built like the bench mixes: demand is expressed
    as fraction-of-capacity x step duration with the duration as the
    latency floor, so per-axis utilization equals the mix fraction.
    """
    mix = FAMILY_AXIS_MIX[arch.family]
    if priority == SLO:
        u = float(rng.uniform(0.30, 0.55))
        slo = float(rng.uniform(1.2, 1.5))
    else:
        u = float(rng.uniform(0.12, 0.40))
        slo = float(rng.uniform(6.0, 14.0))
    # larger active-parameter counts -> longer per-token step
    step = 0.6 + 0.15 * math.log10(max(arch.n_active_params(), 1e6) / 1e6)
    demand = {r: mix.get(r, 0.0) * u * dev.capacity(r) * step
              for r in RESOURCE_AXES}
    kern = KernelProfile(f"{name}#step", demand=demand, duration=step)
    return WorkloadProfile(name, (kern,), slo_slowdown=slo)


def _make_tenant(rng: np.random.Generator, name: str, archs, cfg: TraceConfig,
                 dev: DeviceModel, priority: str, arrival: float,
                 departs: Optional[float] = None) -> TenantSpec:
    arch = archs[int(rng.integers(len(archs)))]
    prof = tenant_profile(rng, name, arch, dev, priority)
    tbt_base = prof.total_time(dev) * cfg.time_scale
    tbt_slo = tbt_base * prof.slo_slowdown * cfg.slo_queue_margin
    return TenantSpec(name, arch.name, arch.family, priority, prof,
                      tbt_base, tbt_slo, arrival, departs)


# ------------------------------------------------------------------ #
#  Request arrivals: non-homogeneous Poisson via thinning              #
# ------------------------------------------------------------------ #
def _burst_windows(rng: np.random.Generator, cfg: TraceConfig
                   ) -> List[Tuple[float, float]]:
    if cfg.n_bursts <= 0 or cfg.duration <= 0:
        return []
    starts = np.sort(rng.uniform(0.1 * cfg.duration, 0.9 * cfg.duration,
                                 size=cfg.n_bursts))
    return [(float(s), float(min(s + cfg.burst_duration, cfg.duration)))
            for s in starts]


def _rate(cfg: TraceConfig, t: float, phase: float,
          bursts: List[Tuple[float, float]]) -> float:
    day = 1.0 + cfg.diurnal_amplitude * math.sin(
        2.0 * math.pi * t / cfg.diurnal_period + phase)
    boost = cfg.burst_factor if any(a <= t < b for a, b in bursts) else 1.0
    return cfg.base_rate * max(day, 0.0) * boost


def _sample_requests(rng: np.random.Generator, cfg: TraceConfig,
                     tenant: TenantSpec, phase: float,
                     bursts: List[Tuple[float, float]],
                     next_id: int) -> List[InjectEvent]:
    lam_max = (cfg.base_rate * (1.0 + cfg.diurnal_amplitude)
               * cfg.burst_factor)
    t0 = tenant.arrival
    t1 = tenant.depart if tenant.depart is not None else cfg.duration
    out: List[InjectEvent] = []
    t = t0
    while True:
        t += float(rng.exponential(1.0 / max(lam_max, 1e-9)))
        if t >= t1:
            break
        if rng.random() < _rate(cfg, t, phase, bursts) / lam_max:
            n_tok = int(min(cfg.max_tokens, cfg.min_tokens
                            + rng.exponential(max(cfg.mean_tokens
                                                  - cfg.min_tokens, 1.0))))
            out.append(request(t, tenant.name, next_id + len(out), n_tok))
    return out


# ------------------------------------------------------------------ #
#  The generator                                                       #
# ------------------------------------------------------------------ #
def generate_trace(cfg: TraceConfig,
                   rng: Optional[np.random.Generator] = None,
                   dev: DeviceModel = TPU_V5E) -> Trace:
    """Generate one replayable trace.  All sampling goes through ``rng``
    (default: ``np.random.default_rng(cfg.seed)``) in a fixed loop
    order, so equal seeds give bit-identical traces."""
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    archs = list(ASSIGNED) + list(PAPER_WORKLOADS)

    n_slo = int(round(cfg.n_tenants * cfg.slo_fraction))
    classes = [SLO] * n_slo + [BEST_EFFORT] * (cfg.n_tenants - n_slo)
    classes = [classes[i] for i in rng.permutation(cfg.n_tenants)]
    n_storm = int(round(cfg.n_tenants * cfg.storm_fraction))

    tenants: Dict[str, TenantSpec] = {}
    events: List[InjectEvent] = []
    for i, prio in enumerate(classes):
        t_arr = (0.0 if i < n_storm
                 else float(rng.uniform(0.0, cfg.arrival_ramp)))
        spec = _make_tenant(rng, f"tenant{i:03d}", archs, cfg, dev,
                            prio, t_arr)
        tenants[spec.name] = spec
        events.append(arrive(spec.arrival, spec.profile,
                             priority=spec.priority))

    # churn: a fraction of best-effort tenants departs mid-trace and is
    # replaced by a fresh best-effort tenant shortly after
    be = [t for t in tenants.values() if t.priority == BEST_EFFORT]
    n_churn = int(round(len(be) * cfg.churn_fraction))
    churners = [be[i] for i in rng.permutation(len(be))[:n_churn]]
    for j, old in enumerate(churners):
        t_dep = float(rng.uniform(0.35, 0.70)) * cfg.duration
        tenants[old.name] = TenantSpec(
            old.name, old.arch, old.family, old.priority, old.profile,
            old.tbt_base, old.tbt_slo, old.arrival, depart=t_dep)
        events.append(depart(t_dep, old.name))
        t_new = min(t_dep + float(rng.uniform(2.0, 10.0)),
                    cfg.duration - 1.0)
        repl = _make_tenant(rng, f"tenant{cfg.n_tenants + j:03d}", archs,
                            cfg, dev, BEST_EFFORT, t_new)
        tenants[repl.name] = repl
        events.append(arrive(repl.arrival, repl.profile,
                             priority=repl.priority))

    bursts = _burst_windows(rng, cfg)
    next_id = 0
    for spec in tenants.values():
        phase = float(rng.uniform(0.0, 2.0 * math.pi))
        reqs = _sample_requests(rng, cfg, spec, phase, bursts, next_id)
        next_id += len(reqs)
        events.extend(reqs)

    for t, device in cfg.kills:
        events.append(kill(float(t), device))
    for t, device in cfg.slows:
        events.append(slow(float(t), device))
    for t, tenant, scale in cfg.profile_shifts:
        events.append(profile_shift(float(t), tenant, scale))
    return Trace(cfg, tenants, events)
