"""Virtual-clock closed-loop serving simulator over the FleetScheduler.

The missing piece between "cold plans match oracles" and "the system
holds SLOs in production": a trace (`repro_torch.sim.traces`) drives the
fleet's event loop AND a per-tenant request-serving loop on one shared
virtual clock (``repro_torch.ft.inject.FakeClock``), so sustained multi-tenant
load, arrival storms, churn, and mid-trace faults all exercise the
scheduler exactly as scripted — deterministically.

Each tick (reusing the ``FaultInjector`` event loop):
  1. due trace events apply — tenant arrivals admit through the fleet
     (same-tick storms through one batched ``submit_many`` replay),
     departures cancel outstanding requests and remove the tenant,
     requests enqueue, kills stop a device's heartbeats, stragglers
     feed its monitor;
  2. live devices heartbeat and ``fleet.tick()`` runs (failure
     detection, retries, replanning);
  3. the serving pass: every PLACED tenant drains its FIFO request
     queue at its interference-inflated rate — per-token time =
     ``tbt_base x predicted_slowdown``, where the slowdown is the fleet
     placement's estimator prediction (computed by ``solve_scenarios``
     through the fleet's group pricing).  Unplaced tenants (queued,
     displaced by a failure, degraded) serve nothing — their requests
     age toward their deadlines, which is exactly how scheduler
     decisions become SLO attainment.

The simulator never touches wall time or module-level RNG: a trace +
seed reproduces the same report bit-for-bit (the determinism gate of the
reference's ``benchmarks/bench_trace.py``, and of ``chip_smoke.py``'s
``fleet`` phase on the card).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.calib.drift import DriftConfig, DriftMonitor, scale_workload
from repro_torch.core.fleet import FleetConfig, FleetScheduler
from repro_torch.core.fracsearch import member_slowdowns
from repro_torch.core.profile import WorkloadProfile
from repro_torch.core.resources import DeviceModel
from repro_torch.core.scenario import group_victim_scenarios
from repro_torch.core.estimator import solve_scenarios
from repro_torch.ft.inject import FakeClock, FaultInjector, InjectEvent
from repro_torch.sim.metrics import RequestRecord, compute_report
from repro_torch.sim.traces import Trace


@dataclass(frozen=True)
class SimConfig:
    """Simulator knobs (fleet knobs live in ``FleetConfig``)."""
    tick_dt: float = 0.5             # virtual seconds per event-loop tick
    settle: float = 30.0             # drain time after the last event
    calibrate: bool = True           # attach a repro_torch.calib DriftMonitor
    refit: bool = True               # re-fit tenants the monitor flags
    drift: Optional[DriftConfig] = None   # monitor knobs (None = defaults)


def default_fleet_config() -> FleetConfig:
    """The simulator's default fleet posture: k=3 colocation, fast
    failure detection on the virtual clock, 1s retry backoff."""
    return FleetConfig(max_group_size=3, heartbeat_timeout=3.0,
                       backoff_base=1.0, queue_limit=64)


class _TraceInjector(FaultInjector):
    """FaultInjector that also understands serving-trace events:
    ``request`` enqueues into the simulator; ``depart`` cancels the
    tenant's outstanding requests before removing it from the fleet
    (and tolerates tenants the fleet rejected at admission)."""

    def __init__(self, sim: "Simulator"):
        super().__init__(sim.fleet, sim.clock, tick_dt=sim.scfg.tick_dt,
                         on_tick=sim._on_tick)
        self.sim = sim

    def _apply(self, ev: InjectEvent) -> None:
        if ev.kind == "request":
            self.sim._enqueue(ev)
            self.applied.append(ev)
        elif ev.kind == "depart":
            self.sim._depart(ev.payload["name"])
            self.applied.append(ev)
        elif ev.kind == "profile-shift":
            self.sim._shift(ev.payload["tenant"],
                            ev.payload["demand_scale"])
            self.applied.append(ev)
        else:
            super()._apply(ev)


class Simulator:
    """Run one trace against one fleet; ``run()`` returns the report.

    >>> trace = generate_trace(TraceConfig(seed=0, kills=((120, "dev2"),)))
    >>> sim = Simulator(trace, {f"dev{i}": TPU_V5E for i in range(12)})
    >>> report = sim.run()
    >>> report["slo"]["per_class"]["slo"]["attainment"]
    """

    def __init__(self, trace: Trace,
                 devices: Mapping[str, DeviceModel],
                 fleet_config: Optional[FleetConfig] = None,
                 sim_config: Optional[SimConfig] = None):
        self.trace = trace
        self.scfg = sim_config or SimConfig()
        self.clock = FakeClock()
        self.fleet = FleetScheduler(dict(devices),
                                    fleet_config or default_fleet_config(),
                                    clock=self.clock)
        self.records: List[RequestRecord] = []
        self.queues: Dict[str, Deque[RequestRecord]] = {}
        self.busy: Dict[str, float] = {}
        self.resident_time: Dict[str, float] = {}
        self.gain_samples: List[float] = []
        self.report: Optional[Dict] = None
        self._plan = None
        self._plan_rev = -1
        self._loc: Dict[str, Tuple[str, float]] = {}
        # calibration: the tenant's TRUE profile where it diverged from
        # the fleet's belief (profile-shift events), and the observed
        # serving slowdown each tick (== predicted while beliefs hold)
        self.true_profiles: Dict[str, WorkloadProfile] = {}
        self._obs_serve: Dict[str, float] = {}
        if self.scfg.calibrate:
            self.fleet.attach_calibration(
                DriftMonitor(self.scfg.drift or DriftConfig()))

    # ------------------------- event handlers --------------------- #
    def _enqueue(self, ev: InjectEvent) -> None:
        p = ev.payload
        spec = self.trace.tenants.get(p["tenant"])
        if spec is None:
            raise KeyError(f"request for unknown tenant {p['tenant']!r} "
                           "(broken trace)")
        rec = RequestRecord(
            tenant=spec.name, req_id=int(p["req_id"]), arrival=ev.t,
            n_tokens=int(p["n_tokens"]), priority=spec.priority,
            tbt_slo=spec.tbt_slo, slack=self.trace.config.queue_slack,
            remaining=float(p["n_tokens"]))
        self.records.append(rec)
        if spec.name in self.fleet:
            self.queues.setdefault(spec.name, deque()).append(rec)
        else:
            # tenant was rejected at admission (or already departed):
            # the request is canceled, not an SLO miss
            rec.canceled = True

    def _depart(self, name: str) -> None:
        for rec in self.queues.pop(name, ()):  # cancel outstanding work
            rec.canceled = True
        self.true_profiles.pop(name, None)
        self._obs_serve.pop(name, None)
        if name in self.fleet:
            self.fleet.remove(name)

    def _shift(self, name: str, scale: float) -> None:
        spec = self.trace.tenants.get(name)
        if spec is None:
            raise KeyError(f"profile-shift for unknown tenant {name!r} "
                           "(broken trace)")
        base = self.true_profiles.get(name, spec.profile)
        self.true_profiles[name] = scale_workload(base, float(scale))

    # --------------------------- serving -------------------------- #
    def _refresh_plan(self) -> None:
        rev = self.fleet.stats["replans"]
        if self._plan is not None and rev == self._plan_rev:
            return
        self._plan = self.fleet.plan()
        self._plan_rev = rev
        self._loc = {}
        for did, p in self._plan.placements.items():
            for n in p.workloads:
                self._loc[n] = (did, float(p.predicted_slowdown.get(n, 1.0)))

    # ------------------------- calibration ------------------------ #
    def _observe_drift(self) -> None:
        """Per-tick predicted-vs-observed pass over every placed tenant.

        Groups whose members all match the fleet's beliefs observe
        ``observed == predicted`` exactly (no solve — the plan and the
        fleet read the same group price), so a clean trace provably
        produces zero flags.  A group holding a shifted tenant is
        re-solved with TRUE profiles (same ``group_victim_scenarios`` /
        ``member_slowdowns`` fold the fleet prices with) and every
        member's observed slowdown is rebased to the fleet's believed
        baseline before it reaches the monitor.  Newly flagged tenants
        re-fit immediately (``SimConfig.refit``) — the resubmit replans,
        and the next tick serves from the corrected plan."""
        flagged: List[str] = []
        for did, p in self._plan.placements.items():
            if not any(n in self.true_profiles for n in p.workloads):
                for n in p.workloads:
                    pred = float(p.predicted_slowdown.get(n, 1.0))
                    self._obs_serve[n] = pred
                    if self.fleet.observe_slowdown(n, pred):
                        flagged.append(n)
                continue
            model = self.fleet.devices[did].model
            members = []
            for n in p.workloads:
                spec = self.trace.tenants.get(n)
                members.append(self.true_profiles.get(
                    n, spec.profile if spec is not None
                    else self.fleet.profile_of(n)))
            reps = {w.name: w.representative_kernel(model)
                    for w in members}
            frac = p.slot_fraction or None
            br = solve_scenarios(
                group_victim_scenarios(members, reps, frac), model)
            slows = member_slowdowns(members, model, br.slowdowns[:, 0])
            for n, true_w in zip(p.workloads, members):
                spec = self.trace.tenants.get(n)
                t_true = true_w.total_time(model)
                believed = self.fleet.profile_of(n)
                # the monitor compares against the fleet's predicted
                # slowdown, which is relative to the believed isolated
                # time; serving compares against the tenant's original
                # tbt_base — rebase to each baseline
                obs_fleet = slows[n] * t_true / max(
                    believed.total_time(model), 1e-12)
                t_spec = (spec.profile.total_time(model)
                          if spec is not None else t_true)
                self._obs_serve[n] = slows[n] * t_true / max(t_spec, 1e-12)
                if self.fleet.observe_slowdown(n, obs_fleet):
                    flagged.append(n)
        if self.scfg.refit:
            for n in flagged:
                self.fleet.refit_workload(n)

    def _on_tick(self, fleet: FleetScheduler, now: float) -> None:
        """One serving pass over [now, now + tick_dt): every placed
        tenant drains its queue at its interference-inflated rate."""
        self._refresh_plan()
        if self.fleet.calib is not None:
            self._observe_drift()
            self._refresh_plan()       # a refit replans mid-tick
        dt = self.scfg.tick_dt
        for did, p in self._plan.placements.items():
            self.resident_time[did] = (self.resident_time.get(did, 0.0)
                                       + dt * len(p.workloads))
        gains = [p.throughput_gain
                 for p in self._plan.placements.values() if p.workloads]
        if gains:
            self.gain_samples.append(float(np.mean(gains)))

        for tenant, q in self.queues.items():
            if not q:
                continue
            loc = self._loc.get(tenant)
            if loc is None:
                continue               # unplaced: requests age, unserved
            did, slowdown = loc
            spec = self.trace.tenants[tenant]
            # serve at the OBSERVED rate when calibrating (diverges from
            # predicted only for shifted tenants' groups)
            slowdown = self._obs_serve.get(tenant, slowdown)
            tbt_eff = spec.tbt_base * max(slowdown, 1.0)
            budget = dt
            while q and budget > 1e-12:
                rec = q[0]
                if rec.start is None:
                    rec.start = now + (dt - budget)
                take = min(rec.remaining * tbt_eff, budget)
                rec.remaining -= take / tbt_eff
                rec.service += take
                budget -= take
                if rec.remaining <= 1e-9:
                    rec.finish = now + (dt - budget)
                    q.popleft()
            self.busy[did] = self.busy.get(did, 0.0) + (dt - budget)

    # ----------------------------- run ----------------------------- #
    def run(self) -> Dict:
        """Replay the whole trace (plus settle time) and fold the
        records into the metrics report."""
        injector = _TraceInjector(self)
        injector.run(self.trace.events,
                     until=self.trace.duration + self.scfg.settle)
        self.report = compute_report(
            self.trace, self.records, self.fleet, self.clock(),
            self.busy, self.resident_time, self.gain_samples)
        return self.report
