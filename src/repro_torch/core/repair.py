"""Scoped repair: group-aware incremental placement for the fleet.

``FleetScheduler`` historically recomputed the WHOLE assignment on every
mutation — a cold priority-ordered replay over all tracked workloads and
all live devices.  Correct and bit-reproducible, but quadratic-ish at
the fleet sizes large deployments run: an arrival at 1000 devices
prices candidate groups on every device even though the placement it
lands on touches one.

This module is the scale path.  Every mutation now computes a
``RepairScope`` — the workloads that need (re)placement plus the devices
whose resident groups or queues the mutation touched — and the
``RepairPlanner`` replays placement ONLY within that scope:

  * the scoped greedy places each target workload (priority rank, then
    arrival order) on the max-gain feasible device among the scope's
    devices plus the ``repair_probe`` emptiest live devices, pricing
    through the same fleet-level deduplicated price cache the full
    replay uses;
  * devices that lost members (departure, death, migration away) are
    re-priced so the fleet's placement info stays exact;
  * the planner FALLS BACK to a full cold replay whenever the scope
    stops being local — the touched-device set exceeds
    ``full_replay_fraction`` of the live fleet — or whenever scoped
    repair cannot re-place an SLO workload (the cold greedy must get a
    chance to displace best-effort work before the workload queues).

**The bounded-divergence contract.**  A scoped repair keeps every
already-placed workload where it is, so the online assignment can
diverge from the cold replay — but only boundedly: the fleet's total
packed gain stays ≥ (1 − ε) × the cold replay's
(``FleetConfig.divergence_epsilon``), and the SET of placed SLO
workloads matches the cold replay exactly (guaranteed by the SLO
fallback rule).  The reference's ``benchmarks/bench_fleet.py`` gates both
at scale, and ``chip_smoke.py``'s ``fleet`` phase holds this package to
the same gates on the card; ``tests/test_torch_fleet.py`` property-tests
them over random mutation sequences.  With the default thresholds, fleets small enough that every
scope spans ≥ ``full_replay_fraction`` of the devices (≲ 32 with the
defaults) always take the full-replay path — the historical
``online == cold at 1e-9`` behavior is unchanged there.

The planner duck-types the fleet (``_tracked`` / ``_groups`` /
``_price`` / ``_live`` / ``devices`` / ``cfg``) so this module has no
import cycle with ``repro_torch.core.fleet``; the shared lifecycle constants
live here and ``fleet`` re-exports them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# priority classes (admission order: SLO replays before best-effort)
SLO = "slo"
BEST_EFFORT = "best_effort"
_PRIORITY_RANK = {SLO: 0, BEST_EFFORT: 1}

# workload lifecycle states
PLACED = "placed"
QUEUED = "queued"
DEGRADED = "degraded"          # final: capacity genuinely insufficient

# device lifecycle states
D_HEALTHY = "healthy"
D_DEGRADED = "degraded"        # straggling: best-effort only
D_DEAD = "dead"


@dataclass(frozen=True)
class RepairScope:
    """What one mutation touched: the workloads needing (re)placement and
    the devices whose resident groups it may have changed.

    ``kind`` routes accounting ("arrival", "storm", "departure",
    "capacity", "device-dead", "device-degraded", "retry", or "full"
    for an unconditional cold replay); ``workloads``/``devices`` are
    insertion-ordered and deduplicated by construction at the call
    sites (the planner deduplicates again defensively)."""
    kind: str
    reason: str
    workloads: Tuple[str, ...] = ()
    devices: Tuple[str, ...] = ()

    @classmethod
    def full(cls, reason: str) -> "RepairScope":
        """A scope that unconditionally takes the cold-replay path."""
        return cls("full", reason)

    def merge(self, other: "RepairScope") -> "RepairScope":
        """Union two same-tick scopes (e.g. device death + due retries)."""
        if self.kind == "full" or other.kind == "full":
            return RepairScope.full(f"{self.reason}; {other.reason}")
        kind = (self.kind if self.kind == other.kind
                else f"{self.kind}+{other.kind}")
        return RepairScope(
            kind, f"{self.reason}; {other.reason}",
            self.workloads + tuple(w for w in other.workloads
                                   if w not in self.workloads),
            self.devices + tuple(d for d in other.devices
                                 if d not in self.devices))


@dataclass(frozen=True)
class RepairRecord:
    """Telemetry for one replan: how wide it was and what it cost.
    ``latency_s`` is wall-clock (NEVER feed it into deterministic
    reports — the touched counts are the reproducible metrics)."""
    kind: str
    reason: str
    full: bool                  # took the cold-replay path
    targets: int                # workloads the repair tried to (re)place
    devices_touched: int        # devices priced or modified
    latency_s: float


@dataclass
class RepairResult:
    """One computed (not yet applied) assignment.

    Full replays carry the COMPLETE new state: ``assign`` maps every
    live device to its member list and ``placement`` every placed
    workload to its device.  Scoped repairs carry a DELTA: ``assign``
    holds only modified devices, ``placement``/``unplaced`` only the
    scope's target workloads — everything else is untouched by
    construction.
    """
    full: bool
    assign: Dict[str, list]                 # device_id -> members
    info: Dict[str, Optional[tuple]]        # device_id -> price (None=empty)
    placement: Dict[str, str]               # workload name -> device_id
    targets: List[str] = field(default_factory=list)
    unplaced: list = field(default_factory=list)
    touched: Tuple[str, ...] = ()


class RepairPlanner:
    """Scope-aware placement over a ``FleetScheduler``'s state.

    ``plan()`` is the single replan entry point: it attempts a scoped
    repair when the fleet's ``repair_mode`` allows and the scope is
    local enough, and otherwise (or on any scoped bail-out) runs the
    cold full replay — the exact deterministic greedy the fleet has
    always used.  The planner reads fleet state but never mutates it;
    applying a ``RepairResult`` is the fleet's thin ``_apply`` layer.
    """

    def __init__(self, fleet):
        self.fleet = fleet

    # ------------------------------------------------------------- #
    def plan(self, scope: RepairScope,
             retry_due: frozenset = frozenset()) -> RepairResult:
        f = self.fleet
        cfg = f.cfg
        # eligibility: the fleet must be large enough that even a
        # probe-wide scope is local (live * fraction >= probe) — below
        # that (<= 32 devices with the defaults) every mutation takes
        # the full replay and the legacy online == cold at 1e-9
        # behavior is bit-preserved
        live_n = sum(1 for d in f.devices.values() if d.state != D_DEAD)
        eligible = (cfg.repair_mode == "scoped" and scope.kind != "full"
                    and live_n * cfg.full_replay_fraction
                    >= cfg.repair_probe)
        if eligible:
            res = self.scoped_repair(scope)
            if res is not None:
                f.stats["scoped_repairs"] += 1
                return res
            f.stats["repair_fallbacks"] += 1
        f.stats["full_replays"] += 1
        return self.full_replay(scope)

    # ------------------------------------------------------------- #
    def full_replay(self, scope: RepairScope) -> RepairResult:
        """The deterministic cold assignment: priority classes in order,
        arrival order within a class, each workload placed on the
        max-gain feasible device (earliest on ties) or left unplaced.
        Pure function of (tracked pool, device states, prices)."""
        f = self.fleet
        assign: Dict[str, list] = {
            d.device_id: [] for d in f.devices.values()
            if d.state != D_DEAD}
        info: Dict[str, Optional[tuple]] = {}
        unplaced: list = []
        order = sorted(f._tracked.values(),
                       key=lambda t: _PRIORITY_RANK[t.priority])
        for t in order:
            cands = [d for d in f._live(t.priority)
                     if len(assign[d.device_id]) < f.cfg.max_group_size]
            groups = [sorted(assign[d.device_id] + [t],
                             key=lambda x: x.pos) for d in cands]
            prices = f._price([(d.model, g)
                               for d, g in zip(cands, groups)])
            best = None
            for di, (gain, meets, _, _) in enumerate(prices):
                if meets and (best is None or gain > best[0]):
                    best = (gain, di)
            if best is None:
                unplaced.append(t)
            else:
                d = cands[best[1]]
                assign[d.device_id].append(t)
                info[d.device_id] = prices[best[1]]
        placement = {t.profile.name: did
                     for did, members in assign.items() for t in members}
        return RepairResult(
            full=True, assign=assign, info=info, placement=placement,
            targets=[t.profile.name for t in order], unplaced=unplaced,
            touched=tuple(assign))

    # ------------------------------------------------------------- #
    def scoped_repair(self, scope: RepairScope) -> Optional[RepairResult]:
        """Place only the scope's workloads, against only the scope's
        devices plus a bounded probe of the emptiest live devices.
        Returns ``None`` to demand the full-replay fallback: scope too
        wide (> ``full_replay_fraction`` of the live fleet) or an SLO
        target the scoped candidates cannot hold."""
        f = self.fleet
        cfg = f.cfg
        tracked = f._tracked
        live = {d.device_id: d for d in f.devices.values()
                if d.state != D_DEAD}
        if not live:
            return None

        # targets: scoped workloads still tracked, deduplicated, in the
        # replay's canonical order (priority rank, then arrival position)
        seen = set()
        targets = []
        for n in scope.workloads:
            if n in tracked and n not in seen:
                seen.add(n)
                targets.append(tracked[n])
        targets.sort(key=lambda t: (_PRIORITY_RANK[t.priority], t.pos))
        target_names = {t.profile.name for t in targets}

        # working copy of resident groups, dropping stale members (gone
        # from tracking, superseded by a resubmit, or targets being
        # re-placed); a device that lost members is modified and will be
        # re-priced even if it gains nothing back
        groups: Dict[str, list] = {}
        modified = set()
        for did in live:
            old = f._groups.get(did, [])
            keep = [t for t in old
                    if t.profile.name in tracked
                    and tracked[t.profile.name] is t
                    and t.profile.name not in target_names]
            groups[did] = keep
            if len(keep) != len(old):
                modified.add(did)

        # candidate devices: the scope's, plus the emptiest live devices
        # as migration targets (registry order breaks ties — the same
        # tie-break the full replay's earliest-device rule uses)
        cands: List[str] = [did for did in dict.fromkeys(scope.devices)
                            if did in live]
        if targets:
            reg_idx = {did: i for i, did in enumerate(f.devices)}
            probe = sorted((did for did in live if did not in cands),
                           key=lambda d: (len(groups[d]), reg_idx[d]))
            cands.extend(probe[:cfg.repair_probe])

        touched = set(cands) | modified
        if len(touched) > cfg.full_replay_fraction * len(live):
            return None

        info: Dict[str, Optional[tuple]] = {}
        placement: Dict[str, str] = {}
        unplaced: list = []
        for t in targets:
            ok = ((D_HEALTHY,) if t.priority == SLO
                  else (D_HEALTHY, D_DEGRADED))
            usable = [did for did in cands
                      if live[did].state in ok
                      and len(groups[did]) < cfg.max_group_size]
            cand_groups = [sorted(groups[did] + [t], key=lambda x: x.pos)
                           for did in usable]
            prices = f._price([(live[did].model, g)
                               for did, g in zip(usable, cand_groups)])
            touched.update(usable)
            best = None
            for di, (gain, meets, _, _) in enumerate(prices):
                if meets and (best is None or gain > best[0]):
                    best = (gain, di)
            if best is None:
                if t.priority == SLO:
                    # the cold greedy may displace best-effort work to
                    # hold an SLO tenant — scoped repair never evicts,
                    # so it must not be the one to queue an SLO workload
                    return None
                unplaced.append(t)
            else:
                did = usable[best[1]]
                groups[did].append(t)
                modified.add(did)
                info[did] = prices[best[1]]
                placement[t.profile.name] = did

        # re-price modified devices whose final group was never the one
        # just priced (lost members with no new arrival) in one batch
        resid = sorted(did for did in modified if did not in info)
        nonempty = [did for did in resid if groups[did]]
        for did, p in zip(nonempty, f._price(
                [(live[did].model, sorted(groups[did], key=lambda x: x.pos))
                 for did in nonempty])):
            info[did] = p
        for did in resid:
            if not groups[did]:
                info[did] = None

        return RepairResult(
            full=False,
            assign={did: groups[did] for did in sorted(modified)},
            info=info, placement=placement,
            targets=[t.profile.name for t in targets],
            unplaced=unplaced, touched=tuple(sorted(touched)))
