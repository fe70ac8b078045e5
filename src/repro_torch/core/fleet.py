"""Fault-tolerant fleet scheduling over the colocation core.

The ``ColocationScheduler`` plans ONE device; production means a fleet:
admission control, priority classes, preemption, and — the part a happy
path never exercises — surviving device failure.  ``FleetScheduler``
owns a set of ``DeviceModel``-backed devices, each wrapping its own
``ColocationScheduler`` (the residency tracker with drain/snapshot
hooks), and keeps the whole system live through faults:

  * **Admission control** — arrivals are SLO or best-effort; every
    outcome (placed / queued / rejected / evicted / migrated / degraded)
    is an explicit ``AdmissionDecision`` in ``decisions``.  Unplaced
    workloads wait in bounded per-class queues; beyond
    ``FleetConfig.queue_limit`` an arrival is REJECTED with a record,
    never silently grown.
  * **Preemption** — placement replays SLO workloads before best-effort,
    so an SLO arrival that cannot otherwise fit displaces best-effort
    work (each eviction recorded); evicted workloads stay tracked and
    re-place the moment capacity returns.
  * **Failure handling** — the ``repro_torch.ft`` primitives are wired into
    the event loop: a device that misses its heartbeat
    (``HeartbeatTracker`` on an injectable monotonic clock) is declared
    dead, its ``ColocationScheduler`` drains, and its workloads re-place
    on the survivors; a straggling device (``StragglerMonitor`` EWMA)
    degrades — SLO work migrates off, best-effort may stay; training
    workloads that lose chips get a ``plan_rescale`` elastic-rescale
    plan attached to their record.  Placement retries back off
    exponentially; a workload the surviving fleet genuinely cannot hold
    lands in a final "degraded" state — tracked, reported, retried when
    capacity changes, never dropped and never a crash (``tick`` seals
    the event loop: internal failures become ``action="error"``
    decisions, not exceptions).

**Determinism / the repair contract.**  Every mutation computes a
``RepairScope`` (the workloads needing placement plus the devices it
touched) and hands it to the ``RepairPlanner`` (`repro_torch.core.repair`):
small/wide scopes take the historical deterministic full replay —
priority classes in order, arrival order within a class, each workload
on the max-gain feasible device (earliest device on ties) — while local
scopes at scale take a **scoped repair** that replays only the scope,
with an explicit bounded-divergence contract (total gain ≥ (1 − ε) ×
the cold replay, identical SLO placement set; see ``repro_torch.core.repair``
for the fallback rules).  Pricing is batched per replay step and
DEDUPLICATED across devices and events by a fleet-level price cache
keyed ``(device model, member uids)``.  On fleets small enough that
every scope is fleet-wide (the historical gate sizes) the full-replay
path always runs, so the online fleet state after any fault trace still
equals a cold ``FleetScheduler`` plan over the surviving devices and
workloads — the reference's ``benchmarks/bench_fleet.py`` enforces that
at 1e-9 and gates the divergence contract at scale, and ``chip_smoke.py``'s
``fleet`` phase holds this package to both on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

from repro_torch.core.backend import warmup_solver
from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.fracsearch import (FractionSearchConfig, group_metrics,
                                         member_slowdowns, search_group_fractions)
from repro_torch.core.profile import KernelProfile, WorkloadProfile
# lifecycle constants live in repro_torch.core.repair (shared with the
# planner); re-exported here for the historical import path
from repro_torch.core.repair import (BEST_EFFORT, D_DEAD, D_DEGRADED, D_HEALTHY,
                                     DEGRADED, PLACED, QUEUED, SLO, _PRIORITY_RANK,
                                     RepairPlanner, RepairRecord, RepairResult,
                                     RepairScope)
from repro_torch.core.resources import DeviceModel
from repro_torch.core.scenario import group_victim_scenarios
from repro_torch.core.scheduler import ColocationScheduler, Placement
from repro_torch.ft import (HeartbeatTracker, RescalePlan, StragglerMonitor,
                            plan_rescale)


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs (per-device colocation inherits the core's).

    max_group_size: colocation capacity of one device (workloads that
        must share it feasibly — the per-device ``ColocationScheduler``
        limit).
    queue_limit: bounded admission queue PER priority class; arrivals
        beyond it are rejected with a decision record.
    heartbeat_timeout: virtual seconds without a beat before a device is
        declared dead and drained.
    max_retries / backoff_base: placement retries for queued workloads
        back off as ``backoff_base * 2**retries``; after ``max_retries``
        failed due-retries the workload enters the final "degraded"
        state (still tracked, re-attempted on capacity changes).
    allow_partition / fraction_search: forwarded to group pricing — an
        SLO-violating candidate group falls back to the k-way
        slot-fraction search exactly like the single-device scheduler.
    straggler_factor / straggler_warmup: per-device ``StragglerMonitor``
        EWMA detection knobs.
    repair_mode: "scoped" (default) routes local mutations through the
        scoped repair path at scale; "full" forces the historical cold
        replay on every mutation (the 1e-9 online==cold behavior,
        unconditionally).
    repair_probe: how many of the emptiest live devices a scoped repair
        considers as placement candidates beyond the scope's own.
    full_replay_fraction: a scope touching more than this fraction of
        the live fleet falls back to the full replay (which also makes
        every fleet of ≲ repair_probe / fraction devices take the
        full-replay path always).
    divergence_epsilon: the bounded-divergence contract's ε — scoped
        total gain must stay ≥ (1 − ε) × the cold replay's (asserted by
        tests and the bench_fleet scale gate; advisory at runtime).
    warmup_solver: capture the torch solver's graphs of the common
        (bucket, K) shapes for every device model at construction (no-op
        on the numpy backend and on the CPU) so the first replans don't
        pay the captures.
    """
    max_group_size: int = 3
    queue_limit: int = 16
    heartbeat_timeout: float = 5.0
    max_retries: int = 3
    backoff_base: float = 1.0
    allow_partition: bool = True
    fraction_search: Optional[FractionSearchConfig] = None
    straggler_factor: float = 3.0
    straggler_warmup: int = 3
    repair_mode: str = "scoped"
    repair_probe: int = 8
    full_replay_fraction: float = 0.25
    divergence_epsilon: float = 0.05
    warmup_solver: bool = False


@dataclass(frozen=True)
class AdmissionDecision:
    """One audit-log entry: what the fleet decided, when, and why."""
    seq: int
    time: float
    action: str                 # placed|queued|rejected|evicted|displaced|
                                # migrated|retry-failed|degraded|removed|
                                # device-dead|device-degraded|
                                # device-recovered|rescale-planned|error
    workload: Optional[str] = None
    priority: Optional[str] = None
    device: Optional[str] = None
    reason: str = ""

    def __repr__(self):
        who = self.workload or self.device or "-"
        return (f"<#{self.seq} t={self.time:.2f} {self.action} {who}"
                f"{' @' + self.device if self.workload and self.device else ''}"
                f" ({self.reason})>")


@dataclass
class _Tracked:
    """Internal per-workload record (arrival order = dict order).

    ``uid`` bumps on every (re)submit — it versions the price cache;
    ``pos`` is the stable arrival position — it orders replay and
    canonical group membership, so a resubmitted workload keeps its
    place (and an online trace keeps matching the cold replay)."""
    profile: WorkloadProfile
    priority: str
    uid: int
    pos: int = 0
    state: str = QUEUED
    device: Optional[str] = None
    retries: int = 0
    next_retry: float = 0.0
    train_meta: Optional[dict] = None    # mesh_shape/global_batch/... for
    rescale: Optional[RescalePlan] = None  # plan_rescale on chip loss


@dataclass
class FleetDevice:
    """One device: a DeviceModel wrapping its own ColocationScheduler."""
    device_id: str
    model: DeviceModel
    sched: ColocationScheduler
    monitor: StragglerMonitor
    chips: int = 1
    state: str = D_HEALTHY
    resident_uids: Dict[str, int] = field(default_factory=dict)


@dataclass
class FleetPlan:
    """The fleet's current placement state (see ``FleetScheduler.plan``)."""
    placements: Dict[str, Placement]     # device_id -> its colocation group
    queued: List[str]                    # admitted, waiting for capacity
    degraded: List[str]                  # final state: capacity insufficient
    device_states: Dict[str, str]

    @property
    def placed(self) -> Dict[str, str]:
        """workload name -> device_id."""
        return {n: did for did, p in self.placements.items()
                for n in p.workloads}

    @property
    def total_gain(self) -> float:
        """Sum of packed throughput gains over occupied devices — the
        quantity the bounded-divergence contract compares between a
        scoped-repaired fleet and a cold replay."""
        return sum(p.throughput_gain for p in self.placements.values())

    def placement_rate(self, names: Iterable[str]) -> float:
        """Fraction of ``names`` currently placed (1.0 for an empty set)."""
        names = list(names)
        if not names:
            return 1.0
        placed = self.placed
        return sum(n in placed for n in names) / len(names)


# fleet price record: (gain, meets_slo, slowdowns by name, fractions by name)
_Price = Tuple[float, bool, Dict[str, float], Dict[str, float]]


class FleetScheduler:
    """Admission control + placement + fault recovery over many devices.

    >>> clock = FakeClock()                      # repro_torch.ft.inject
    >>> fleet = FleetScheduler({"dev0": TPU_V5E, "dev1": TPU_V5E},
    ...                        clock=clock)
    >>> fleet.submit(decode, priority=SLO)       # -> AdmissionDecision
    >>> fleet.heartbeat("dev0"); fleet.tick()    # the event loop
    >>> fleet.plan()                             # -> FleetPlan

    ``submit``/``remove`` raise on caller errors (unknown names, bad
    priority) exactly like ``ColocationScheduler``; the event-loop
    surface (``tick``, ``observe_step`` internals, replanning) never
    raises — failures become ``action="error"`` decisions.
    """

    def __init__(self, devices: Mapping[str, DeviceModel] | Iterable[Tuple[str, DeviceModel]],
                 config: Optional[FleetConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or FleetConfig()
        self.clock = clock
        self.search = (self.cfg.fraction_search
                       or FractionSearchConfig.default())
        self.devices: Dict[str, FleetDevice] = {}
        self.heartbeats = HeartbeatTracker(
            timeout_s=self.cfg.heartbeat_timeout, clock=clock)
        self._tracked: Dict[str, _Tracked] = {}      # arrival order
        self._next_uid = 0
        self._next_pos = 0
        self._seq = 0
        self.decisions: List[AdmissionDecision] = []
        self._price_cache: Dict[Tuple[str, Tuple[int, ...]], _Price] = {}
        self._reps: Dict[Tuple[int, str], KernelProfile] = {}
        # uid -> cache keys reverse indexes: departures drop exactly the
        # entries that mention the uid instead of scanning every key
        self._uid_price_keys: Dict[int, Set[Tuple[str, Tuple[int, ...]]]] = {}
        self._uid_rep_keys: Dict[int, Set[Tuple[int, str]]] = {}
        self._assignment: Dict[str, str] = {}        # name -> device_id
        self._groups: Dict[str, List[_Tracked]] = {}  # device_id -> members
        self._info: Dict[str, _Price] = {}           # device_id -> group price
        self.planner = RepairPlanner(self)
        self.repairs: List[RepairRecord] = []
        self.stats: Dict[str, int] = {
            "arrivals": 0, "departures": 0, "rejected": 0, "evicted": 0,
            "migrated": 0, "displaced": 0, "retries": 0, "device_deaths": 0,
            "replans": 0, "scoped_repairs": 0, "full_replays": 0,
            "repair_fallbacks": 0, "scenarios_solved": 0, "groups_priced": 0,
            "errors": 0,
            "calib_observations": 0, "calib_flags": 0, "calib_refits": 0,
        }
        self.calib = None                  # DriftMonitor, see repro_torch.calib
        items = devices.items() if isinstance(devices, Mapping) else devices
        for did, model in items:
            self.add_device(did, model)
        if self.cfg.warmup_solver:
            # the torch solver keys its graphs by (bucket, K, device
            # model), so each model of the fleet is warmed on its own
            models = {d.model.name: d.model for d in self.devices.values()}
            for model in models.values():
                warmup_solver(model,
                              ks=range(2, self.cfg.max_group_size + 1))

    # ----------------------------- devices ------------------------ #
    def add_device(self, device_id: str, model: DeviceModel,
                   chips: int = 1) -> None:
        """Register a device; its heartbeat clock starts NOW (a device
        that never beats is declared dead after the timeout)."""
        if device_id in self.devices:
            raise ValueError(f"duplicate device: {device_id!r}")
        self.devices[device_id] = FleetDevice(
            device_id, model,
            ColocationScheduler(model,
                                max_group_size=self.cfg.max_group_size,
                                allow_partition=self.cfg.allow_partition,
                                fraction_search=self.search),
            StragglerMonitor(factor=self.cfg.straggler_factor,
                             warmup=self.cfg.straggler_warmup,
                             clock=self.clock),
            chips=chips)
        self.heartbeats.beat(device_id)
        if self._tracked:
            # new capacity: queued/degraded workloads get another shot
            self._replan(RepairScope(
                "capacity", f"device {device_id} added",
                workloads=self._waiting(), devices=(device_id,)))

    def heartbeat(self, device_id: str, now: Optional[float] = None) -> None:
        """A device host reports in.  A beat from a dead device revives
        it (the host came back): healthy again, capacity replanned."""
        dev = self.devices.get(device_id)
        if dev is None:
            raise KeyError(f"unknown device: {device_id!r}")
        self.heartbeats.beat(device_id, now)
        if dev.state == D_DEAD:
            dev.state = D_HEALTHY
            self._decide("device-recovered", device=device_id,
                         reason="heartbeat resumed")
            self._replan(RepairScope(
                "capacity", f"device {device_id} recovered",
                workloads=self._waiting(), devices=(device_id,)))

    def revive_device(self, device_id: str) -> None:
        """Operator override: clear a device's degraded (straggler) state."""
        dev = self.devices[device_id]
        if dev.state == D_DEGRADED:
            dev.state = D_HEALTHY
            dev.monitor.ewma = None
            dev.monitor.n = 0
            self._decide("device-recovered", device=device_id,
                         reason="straggle cleared")
            self._replan(RepairScope(
                "capacity", f"device {device_id} revived",
                workloads=self._waiting(), devices=(device_id,)))

    def decommission(self, device_id: str) -> None:
        """Planned removal: drain the device and re-place its workloads
        (same migration path as a failure, minus the timeout wait)."""
        dev = self.devices.get(device_id)
        if dev is None:
            raise KeyError(f"unknown device: {device_id!r}")
        if dev.state == D_DEAD:
            return                      # documented no-op: already drained
        residents = self._residents(device_id)
        self._mark_dead(dev, reason="decommissioned")
        self._replan(RepairScope(
            "device-dead", f"device {device_id} decommissioned",
            workloads=residents))

    def observe_step(self, device_id: str, step: int, dt: float) -> bool:
        """Feed one step-time observation to the device's straggler
        monitor; EWMA detection degrades the device (SLO work migrates
        off at the next replan, best-effort may remain)."""
        dev = self.devices.get(device_id)
        if dev is None:
            raise KeyError(f"unknown device: {device_id!r}")
        try:
            straggling = dev.monitor.observe(step, dt)
            if straggling and dev.state == D_HEALTHY:
                dev.state = D_DEGRADED
                self._decide("device-degraded", device=device_id,
                             reason=f"straggling: dt={dt:.3g} vs "
                                    f"ewma={dev.monitor.ewma:.3g}")
                # SLO residents must migrate off; best-effort may stay
                slo_res = tuple(n for n in self._residents(device_id)
                                if self._tracked[n].priority == SLO)
                self._replan(RepairScope(
                    "device-degraded", f"device {device_id} degraded",
                    workloads=slo_res, devices=(device_id,)))
            return straggling
        except Exception as e:      # pragma: no cover - defensive seal
            self._error(f"observe_step({device_id}): {e!r}")
            return False

    # ----------------------------- workloads ----------------------- #
    def __len__(self) -> int:
        return len(self._tracked)

    def __contains__(self, name: str) -> bool:
        return name in self._tracked

    @property
    def workloads(self) -> List[Tuple[WorkloadProfile, str]]:
        """(profile, priority) pairs in arrival order — exactly what a
        cold fleet over the survivors must be fed to reproduce the
        online plan (the recovery gate's contract)."""
        return [(t.profile, t.priority) for t in self._tracked.values()]

    def workload_state(self, name: str) -> Dict:
        t = self._tracked[name]
        return {"state": t.state, "device": t.device, "priority": t.priority,
                "retries": t.retries, "next_retry": t.next_retry,
                "rescale": t.rescale}

    def profile_of(self, name: str) -> WorkloadProfile:
        """The fleet's current believed profile for a tracked workload."""
        return self._tracked[name].profile

    # ----------------------------- calibration --------------------- #
    def attach_calibration(self, monitor) -> None:
        """Wire a ``repro_torch.calib.DriftMonitor`` into the event loop:
        ``observe_slowdown`` feeds it predicted-vs-observed pairs and
        ``refit_workload`` re-fits flagged tenants from its samples.
        Counters surface in ``stats`` (calib_observations/flags/refits)."""
        self.calib = monitor

    def observe_slowdown(self, name: str, observed: float) -> bool:
        """Report a measured slowdown for a placed workload.  Builds the
        drift sample's colocation context (group-mate representative
        kernels, slot fractions, device model) from the live plan and
        forwards to the attached monitor.  Returns True iff this
        observation NEWLY flags the workload as drifted.  Event-loop
        surface: never raises."""
        try:
            if self.calib is None:
                return False
            t = self._tracked.get(name)
            if t is None or t.state != PLACED or t.device is None:
                return False
            info = self._info.get(t.device)
            if info is None:
                return False
            predicted = info[2].get(name)
            if predicted is None:
                return False
            model = self.devices[t.device].model
            bg = tuple(self._rep(o, model)
                       for o in self._groups.get(t.device, ())
                       if o.profile.name != name)
            frac = info[3] or None
            self.stats["calib_observations"] += 1
            newly = self.calib.observe(name, predicted, float(observed),
                                       bg, frac, model)
            if newly:
                self.stats["calib_flags"] += 1
                self._decide("calib-flagged", t, device=t.device,
                             reason=f"observed/predicted diverged "
                                    f"{self.calib.divergence(name):+.0%} "
                                    f"(EWMA)")
            return newly
        except Exception as e:
            self._error(f"observe_slowdown {name}: {e!r}")
            return False

    def refit_workload(self, name: str) -> bool:
        """Re-fit a drifted workload's profile from the monitor's stored
        observations and resubmit it (same priority — last-profile-wins,
        so the fleet replans around the corrected demand).  Returns True
        iff a refit happened.  Never raises."""
        try:
            if self.calib is None:
                return False
            t = self._tracked.get(name)
            if t is None or not self.calib.can_refit(name):
                return False
            refit = self.calib.refit(name, t.profile)
            if refit is None:
                return False
            self.stats["calib_refits"] += 1
            self._decide("calib-refit", t, device=t.device,
                         reason="profile re-fit from drift observations")
            self.submit(refit, priority=t.priority,
                        train_meta=t.train_meta)
            return True
        except Exception as e:
            self._error(f"refit_workload {name}: {e!r}")
            return False

    def submit(self, workload: WorkloadProfile, priority: str = SLO,
               train_meta: Optional[dict] = None) -> AdmissionDecision:
        """Admit a workload and decide its fate NOW: returns the
        decision record (placed / queued / rejected).  Re-submitting an
        existing name replaces its profile and priority but keeps its
        arrival position (the core scheduler's last-profile-wins rule);
        its cached prices are invalidated.

        ``train_meta`` (optional) marks an elastic training job:
        ``{"mesh_shape": {...}, "global_batch": int,
        "num_microbatches": int, "step": int}`` — if its device later
        dies, a ``plan_rescale`` recovery plan is attached to the
        workload record and surfaced as a "rescale-planned" decision.
        """
        if priority not in _PRIORITY_RANK:
            raise ValueError(f"priority must be {SLO!r} or {BEST_EFFORT!r},"
                             f" got {priority!r}")
        name = workload.name
        old = self._tracked.get(name)
        old_dev: Tuple[str, ...] = ()
        if old is not None:
            if old.device is not None:
                old_dev = (old.device,)
            self._drop_prices(old.uid)
            old.profile = workload
            old.priority = priority
            old.uid = self._next_uid
            old.train_meta = train_meta if train_meta else old.train_meta
            t = old
        else:
            t = self._tracked[name] = _Tracked(workload, priority,
                                               self._next_uid,
                                               pos=self._next_pos,
                                               train_meta=train_meta)
            self._next_pos += 1
        self._next_uid += 1
        self.stats["arrivals"] += 1
        n0 = len(self.decisions)
        self._replan(RepairScope("arrival", f"arrival {name}",
                                 workloads=(name,), devices=old_dev))
        if t.state == PLACED:
            for d in self.decisions[n0:]:
                if d.workload == name and d.action in ("placed", "migrated"):
                    return d
            return self._decide("placed", t, device=t.device,
                                reason=f"arrival {name} (placement unchanged)")
        # not placeable now: bounded queue or explicit rejection
        backlog = sum(1 for o in self._tracked.values()
                      if o.state in (QUEUED, DEGRADED)
                      and o.priority == priority)
        if backlog > self.cfg.queue_limit:
            del self._tracked[name]
            self._drop_prices(t.uid)
            self.stats["rejected"] += 1
            return self._decide(
                "rejected", t,
                reason=f"{priority} queue full "
                       f"({self.cfg.queue_limit} waiting)")
        t.next_retry = self.clock() + self.cfg.backoff_base
        return self._decide("queued", t,
                            reason=f"no feasible device; retry in "
                                   f"{self.cfg.backoff_base:.1f}s")

    def submit_many(self, arrivals: Sequence) -> List[AdmissionDecision]:
        """Admit a same-tick arrival storm in ONE deduplicated replay.

        ``arrivals`` holds ``(workload, priority)`` or ``(workload,
        priority, train_meta)`` tuples.  Semantically equivalent to
        calling ``submit`` per item — queued workloads never occupy a
        device, so registering every arrival first and replanning once
        yields the same final placements and the same bounded-queue
        admission outcomes — but it costs one replay (and one round of
        group pricing) instead of one per arrival.  Duplicate names in
        the batch collapse to the last profile (last-profile-wins, as
        with re-submission).  Returns one decision per distinct name in
        first-submission order.
        """
        items = []
        for entry in arrivals:
            workload, priority = entry[0], entry[1]
            train_meta = entry[2] if len(entry) > 2 else None
            if priority not in _PRIORITY_RANK:
                raise ValueError(f"priority must be {SLO!r} or "
                                 f"{BEST_EFFORT!r}, got {priority!r}")
            items.append((workload, priority, train_meta))
        if not items:
            return []
        order: List[str] = []
        old_devs: List[str] = []
        for workload, priority, train_meta in items:
            name = workload.name
            old = self._tracked.get(name)
            if old is not None:
                if old.device is not None and old.device not in old_devs:
                    old_devs.append(old.device)
                self._drop_prices(old.uid)
                old.profile = workload
                old.priority = priority
                old.uid = self._next_uid
                old.train_meta = train_meta if train_meta else old.train_meta
            else:
                self._tracked[name] = _Tracked(workload, priority,
                                               self._next_uid,
                                               pos=self._next_pos,
                                               train_meta=train_meta)
                self._next_pos += 1
            self._next_uid += 1
            self.stats["arrivals"] += 1
            if name not in order:
                order.append(name)
        n0 = len(self.decisions)
        self._replan(RepairScope(
            "storm", f"arrival storm ({len(order)} workloads)",
            workloads=tuple(order), devices=tuple(old_devs)))
        batch = set(order)
        placed_dec: Dict[str, AdmissionDecision] = {}
        for d in self.decisions[n0:]:
            if d.workload in batch and d.action in ("placed", "migrated"):
                placed_dec.setdefault(d.workload, d)
        out: List[AdmissionDecision] = []
        for name in order:
            t = self._tracked[name]
            if t.state == PLACED:
                d = placed_dec.get(name)
                out.append(d if d is not None else self._decide(
                    "placed", t, device=t.device,
                    reason=f"arrival {name} (placement unchanged)"))
                continue
            backlog = sum(1 for o in self._tracked.values()
                          if o.state in (QUEUED, DEGRADED)
                          and o.priority == t.priority)
            if backlog > self.cfg.queue_limit:
                del self._tracked[name]
                self._drop_prices(t.uid)
                self.stats["rejected"] += 1
                out.append(self._decide(
                    "rejected", t,
                    reason=f"{t.priority} queue full "
                           f"({self.cfg.queue_limit} waiting)"))
                continue
            t.next_retry = self.clock() + self.cfg.backoff_base
            out.append(self._decide(
                "queued", t,
                reason=f"no feasible device; retry in "
                       f"{self.cfg.backoff_base:.1f}s"))
        return out

    def remove(self, name: str) -> None:
        """A workload departs.  Unknown names raise ``KeyError`` before
        any state is touched (mirrors ``ColocationScheduler.remove``)."""
        t = self._tracked.get(name)
        if t is None:
            raise KeyError(f"unknown workload: {name!r}")
        del self._tracked[name]
        self._drop_prices(t.uid)
        self._assignment.pop(name, None)
        if self.calib is not None:
            self.calib.forget(name)
        self.stats["departures"] += 1
        self._decide("removed", t, device=t.device, reason="departure")
        # freed capacity: waiting workloads get another shot; the
        # departed workload's device re-prices its shrunken group
        self._replan(RepairScope(
            "departure", f"departure {name}", workloads=self._waiting(),
            devices=(t.device,) if t.device is not None else ()))

    # ----------------------------- event loop ---------------------- #
    def tick(self, now: Optional[float] = None) -> None:
        """One controller iteration: scan heartbeats (missed ->
        dead + drain), fire due placement retries.  NEVER raises —
        internal failures become ``action="error"`` decisions."""
        try:
            now = self.clock() if now is None else now
            dead = [w for w in self.heartbeats.dead_workers(now)
                    if w in self.devices
                    and self.devices[w].state != D_DEAD]
            displaced: List[str] = []
            for did in dead:
                displaced.extend(self._residents(did))
                self._mark_dead(self.devices[did],
                                reason=f"missed heartbeat for "
                                       f">{self.cfg.heartbeat_timeout:.1f}s")
            retry_due = frozenset(
                n for n, t in self._tracked.items()
                if t.state == QUEUED and t.next_retry <= now)
            scope = None
            if dead:
                scope = RepairScope("device-dead",
                                    "device failure: " + ", ".join(dead),
                                    workloads=tuple(displaced))
            if retry_due:
                retry = RepairScope("retry",
                                    "retry " + ", ".join(sorted(retry_due)),
                                    workloads=tuple(sorted(retry_due)))
                scope = retry if scope is None else scope.merge(retry)
            if scope is not None:
                self._replan(scope, retry_due=retry_due)
        except Exception as e:
            self._error(f"tick: {e!r}")

    @property
    def degraded(self) -> bool:
        """True when the fleet is running in degraded mode: a device is
        dead/straggling or a workload cannot be placed on the survivors."""
        return (any(d.state != D_HEALTHY for d in self.devices.values())
                or any(t.state == DEGRADED for t in self._tracked.values()))

    # ----------------------------- placement ----------------------- #
    def _live(self, priority: str) -> List[FleetDevice]:
        """Devices this priority class may use, in registry order: SLO
        only healthy; best-effort also degraded (slow) devices."""
        ok = (D_HEALTHY,) if priority == SLO else (D_HEALTHY, D_DEGRADED)
        return [d for d in self.devices.values() if d.state in ok]

    def _waiting(self) -> Tuple[str, ...]:
        """Names waiting for capacity (queued or final-degraded) — the
        workload scope of every capacity-increasing mutation."""
        return tuple(n for n, t in self._tracked.items()
                     if t.state in (QUEUED, DEGRADED))

    def _residents(self, device_id: str) -> Tuple[str, ...]:
        """Names currently assigned to a device (by the last replan)."""
        return tuple(t.profile.name
                     for t in self._groups.get(device_id, ())
                     if t.profile.name in self._tracked)

    def _price(self, items: List[Tuple[DeviceModel, List[_Tracked]]]
               ) -> List[_Price]:
        """Price candidate groups, deduplicated by ``(model, uids)``
        against the fleet cache and batched into one solve per phase.
        A group's price is its FINAL resolved value: full sharing when
        feasible, else the best k-way slot-fraction partition."""
        out: List[Optional[_Price]] = [None] * len(items)
        missing: Dict[Tuple[str, Tuple[int, ...]], List[int]] = {}
        for i, (model, g) in enumerate(items):
            key = (model.name, tuple(x.uid for x in g))
            hit = self._price_cache.get(key)
            if hit is not None:
                out[i] = hit
            else:
                missing.setdefault(key, []).append(i)
        if missing:
            by_model: Dict[str, List[Tuple[Tuple, List[_Tracked], DeviceModel]]] = {}
            for key, idxs in missing.items():
                model, g = items[idxs[0]]
                if len(g) == 1:
                    w = g[0].profile
                    price = (1.0, True, {w.name: 1.0}, {})
                    self._cache_price(key, price)
                    for i in idxs:
                        out[i] = price
                else:
                    by_model.setdefault(model.name, []).append(
                        (key, g, model))
            for entries in by_model.values():
                self._price_multi(entries)
            for key, idxs in missing.items():
                for i in idxs:
                    if out[i] is None:
                        out[i] = self._price_cache[key]
        return out  # type: ignore[return-value]

    def _price_multi(self, entries) -> None:
        """One batched full-share solve over every missing >=2-member
        group on one device model, then one batched fraction search over
        the SLO-failing ones (the green-context fallback)."""
        model = entries[0][2]
        reps: Dict[str, KernelProfile] = {}
        for _, g, _ in entries:
            for t in g:
                reps[t.profile.name] = self._rep(t, model)
        scenarios = []
        for _, g, _ in entries:
            scenarios.extend(group_victim_scenarios(
                [t.profile for t in g], reps))
        br = solve_scenarios(scenarios, model)
        self.stats["scenarios_solved"] += len(scenarios)
        self.stats["groups_priced"] += len(entries)
        row = 0
        failing = []
        for key, g, _ in entries:
            members = [t.profile for t in g]
            n_rows = sum(len(w.kernels) for w in members)
            slows = member_slowdowns(members, model,
                                     br.slowdowns[row:row + n_rows, 0])
            row += n_rows
            gain, meets = group_metrics(
                [w.total_time(model) for w in members],
                [slows[w.name] for w in members],
                [w.slo_slowdown for w in members])
            self._cache_price(key, (gain, meets,
                                    {n: float(s) for n, s in slows.items()},
                                    {}))
            if not meets and self.cfg.allow_partition:
                failing.append((key, members))
        if failing:
            found = search_group_fractions(
                [m for _, m in failing], model, self.search, reps=reps,
                stats=self.stats)
            for (key, members), res in zip(failing, found):
                if res.meets_slo:
                    names = [w.name for w in members]
                    self._cache_price(key, (
                        float(res.gain), True,
                        {n: float(s) for n, s in res.slowdowns.items()},
                        dict(zip(names, map(float, res.fractions)))))

    def _rep(self, t: _Tracked, model: DeviceModel) -> KernelProfile:
        key = (t.uid, model.name)
        rep = self._reps.get(key)
        if rep is None:
            rep = self._reps[key] = t.profile.representative_kernel(model)
            self._uid_rep_keys.setdefault(t.uid, set()).add(key)
        return rep

    def _cache_price(self, key: Tuple[str, Tuple[int, ...]],
                     price: _Price) -> None:
        """Insert into the price cache, maintaining the uid -> keys
        reverse index that makes departures O(keys touched)."""
        self._price_cache[key] = price
        for uid in key[1]:
            self._uid_price_keys.setdefault(uid, set()).add(key)

    def _drop_prices(self, uid: int) -> None:
        # .pop(key, None): a key may already be gone when a group-mate's
        # earlier departure dropped the shared entry
        for key in self._uid_price_keys.pop(uid, ()):
            self._price_cache.pop(key, None)
        for key in self._uid_rep_keys.pop(uid, ()):
            self._reps.pop(key, None)

    # ----------------------------- replanning ---------------------- #
    def _replan(self, scope: RepairScope,
                retry_due: frozenset = frozenset()) -> None:
        """Route one mutation's scope through the RepairPlanner, apply
        the result, and record the repair.  Guarded: never raises (the
        no-crash contract)."""
        self.stats["replans"] += 1
        t0 = time.perf_counter()
        try:
            res = self.planner.plan(scope, retry_due)
            self._apply(res, scope.reason, retry_due)
            self.repairs.append(RepairRecord(
                kind=scope.kind, reason=scope.reason, full=res.full,
                targets=len(res.targets),
                devices_touched=len(res.touched),
                latency_s=time.perf_counter() - t0))
        except Exception as e:
            self._error(f"replan ({scope.reason}): {e!r}")

    def _apply(self, res: RepairResult, reason: str, retry_due) -> None:
        """The thin apply layer: record every lifecycle transition the
        computed assignment implies, then merge it into fleet state —
        wholesale for a full replay, as a delta for a scoped repair."""
        now = self.clock()
        if res.full:
            scan = list(self._tracked.items())
        else:
            scan = [(n, self._tracked[n]) for n in res.targets
                    if n in self._tracked]
        unplaced_names = {t.profile.name for t in res.unplaced}
        for name, t in scan:
            old = self._assignment.get(name)
            new = res.placement.get(name)
            if new is not None:
                if old is None:
                    self._decide("placed", t, device=new, reason=reason)
                elif old != new:
                    self.stats["migrated"] += 1
                    self._decide("migrated", t, device=new,
                                 reason=f"{reason}; was on {old}")
                t.state, t.device = PLACED, new
                t.retries, t.next_retry = 0, 0.0
                if not res.full:
                    self._assignment[name] = new
            elif name in unplaced_names:
                if old is not None:
                    # displaced from a placement it held
                    action = ("evicted" if t.priority == BEST_EFFORT
                              else "displaced")
                    self.stats[action] += 1
                    t.state, t.device = QUEUED, None
                    t.retries = 0
                    t.next_retry = now + self.cfg.backoff_base
                    self._decide(action, t, device=old, reason=reason)
                    if not res.full:
                        self._assignment.pop(name, None)
                elif t.state == QUEUED and name in retry_due:
                    t.retries += 1
                    self.stats["retries"] += 1
                    if t.retries >= self.cfg.max_retries:
                        t.state = DEGRADED
                        self._decide(
                            "degraded", t,
                            reason=f"no capacity after {t.retries} retries "
                                   f"({reason})")
                    else:
                        t.next_retry = (now + self.cfg.backoff_base
                                        * 2 ** t.retries)
                        self._decide(
                            "retry-failed", t,
                            reason=f"{reason}; backoff "
                                   f"{t.next_retry - now:.1f}s")
        if res.full:
            self._assignment = dict(res.placement)
            self._groups = res.assign
            self._info = {did: p for did, p in res.info.items()
                          if p is not None}
            self._sync_devices(res.assign)
        else:
            for did, members in res.assign.items():
                self._groups[did] = members
                p = res.info.get(did)
                if members and p is not None:
                    self._info[did] = p
                else:
                    self._info.pop(did, None)
            # a scoped apply never rebuilds _groups wholesale, so dead
            # devices' stale entries must be pruned explicitly
            for did in [d for d in self._groups
                        if self.devices[d].state == D_DEAD]:
                self._groups.pop(did, None)
                self._info.pop(did, None)
            self._sync_devices(res.assign)

    def _sync_devices(self, assign: Dict[str, List[_Tracked]]) -> None:
        """Mirror the assignment into each device's ColocationScheduler
        (residency tracking only — pricing there stays lazy/unused)."""
        for did, members in assign.items():
            dev = self.devices[did]
            want = {t.profile.name: t for t in members}
            for name in [n for n in dev.resident_uids if n not in want]:
                dev.sched.remove(name)
                del dev.resident_uids[name]
            for name, t in want.items():
                if dev.resident_uids.get(name) != t.uid:
                    dev.sched.submit(t.profile)
                    dev.resident_uids[name] = t.uid

    def _mark_dead(self, dev: FleetDevice, reason: str) -> None:
        dev.state = D_DEAD
        self.heartbeats.forget(dev.device_id)
        drained = dev.sched.drain()          # the migration hook
        dev.resident_uids.clear()
        self.stats["device_deaths"] += 1
        self._decide("device-dead", device=dev.device_id,
                     reason=f"{reason}; drained {len(drained)} workloads")
        # plan_rescale wiring: displaced elastic-training workloads get
        # a concrete recovery plan (shrunk mesh, same global batch)
        for w in drained:
            t = self._tracked.get(w.name)
            if t is not None and t.train_meta:
                m = t.train_meta
                t.rescale = plan_rescale(
                    m["mesh_shape"], lost_chips=dev.chips,
                    global_batch=m.get("global_batch", 0),
                    num_microbatches=m.get("num_microbatches", 1),
                    current_step=m.get("step", 0))
                self._decide(
                    "rescale-planned", t,
                    reason=f"lost {dev.chips} chip(s) on {dev.device_id}: "
                           f"{m['mesh_shape']} -> {t.rescale.new_shape} "
                           f"({t.rescale.new_chip_count} chips), resume "
                           f"step {t.rescale.restart_step}")

    # ----------------------------- reporting ----------------------- #
    def plan(self) -> FleetPlan:
        """The current fleet state.  Pure read: placements come from the
        last replay (every mutation already replanned)."""
        placements = {}
        for did, members in self._groups.items():
            if not members:
                continue
            gain, _, slows, fracs = self._info[did]
            names = [t.profile.name for t in
                     sorted(members, key=lambda x: x.pos)]
            placements[did] = Placement(
                names, dict(fracs),
                {n: float(slows[n]) for n in names}, True, float(gain))
        return FleetPlan(
            placements=placements,
            queued=[n for n, t in self._tracked.items()
                    if t.state == QUEUED],
            degraded=[n for n, t in self._tracked.items()
                      if t.state == DEGRADED],
            device_states={did: d.state for did, d in self.devices.items()})

    def snapshot(self) -> Dict:
        """Full fleet telemetry: device snapshots (via the per-device
        scheduler hook), workload lifecycle states, queue depths, stats."""
        return {
            "devices": {did: {"state": d.state, "model": d.model.name,
                              "chips": d.chips,
                              "sched": d.sched.snapshot()}
                        for did, d in self.devices.items()},
            "workloads": {n: self.workload_state(n) for n in self._tracked},
            "queued": sum(t.state == QUEUED
                          for t in self._tracked.values()),
            "degraded_workloads": sum(t.state == DEGRADED
                                      for t in self._tracked.values()),
            "decisions": len(self.decisions),
            "stats": dict(self.stats),
        }

    # ----------------------------- internals ----------------------- #
    def _decide(self, action: str, t: Optional[_Tracked] = None,
                device: Optional[str] = None, reason: str = ""
                ) -> AdmissionDecision:
        d = AdmissionDecision(
            seq=self._seq, time=self.clock(), action=action,
            workload=t.profile.name if t is not None else None,
            priority=t.priority if t is not None else None,
            device=device, reason=reason)
        self._seq += 1
        self.decisions.append(d)
        return d

    def _error(self, reason: str) -> None:
        self.stats["errors"] += 1
        self._decide("error", reason=reason)
