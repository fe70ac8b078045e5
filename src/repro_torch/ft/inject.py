"""Deterministic fault injection for the fleet scheduler.

The harness makes failure handling a *gated, replayable* property instead
of a hope: a scripted trace of device kills, slow devices, arrival storms
and departures runs against a ``FleetScheduler`` on a virtual clock
(``FakeClock``), so every test and benchmark sees the exact same event
timeline — no sleeps, no wall-clock flake, bit-identical decision logs.

Pieces
  * ``FakeClock`` — a callable monotonic clock with ``advance(dt)``;
    drop-in for the ``clock=`` parameter of ``HeartbeatTracker``,
    ``StragglerMonitor``, and ``FleetScheduler``.
  * ``InjectEvent`` + constructors (``arrive``/``storm``/``depart``/``kill``/
    ``slow``) — the scripted trace vocabulary.
  * ``FaultInjector`` — the event loop: each virtual tick it
    applies due events, emits heartbeats for every live (non-killed)
    device, calls ``fleet.tick()``, and advances the clock.  A killed
    device simply STOPS BEATING — death is *detected* by the fleet's
    heartbeat timeout, exactly like a real lost host, not short-circuited
    through a private API.

The injector is duck-typed against the fleet (``submit`` / ``remove`` /
``heartbeat`` / ``observe_step`` / ``tick`` / ``devices``) so this module
has no import cycle with ``repro_torch.core.fleet``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


class FakeClock:
    """Deterministic virtual clock: ``clock()`` reads, ``advance`` steps.

    Monotonic by construction — ``advance`` rejects negative steps — so
    code written against ``time.monotonic`` behaves identically on it.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def __repr__(self):
        return f"<FakeClock t={self._t:.3f}>"


@dataclass(frozen=True)
class InjectEvent:
    """One scripted event: fires the first tick whose time reaches ``t``.

    kinds: "arrive" (workload, priority, train_meta), "depart" (name),
    "kill" (device), "revive" (device), "slow" (device, baseline,
    factor, steps).
    """
    t: float
    kind: str
    payload: dict = field(default_factory=dict)


def arrive(t: float, workload, priority: str = "slo",
           train_meta: Optional[dict] = None) -> InjectEvent:
    return InjectEvent(t, "arrive", {"workload": workload,
                                     "priority": priority,
                                     "train_meta": train_meta})


def storm(t: float, workloads: Sequence, priority: str = "best_effort"
          ) -> List[InjectEvent]:
    """An arrival storm: every workload lands on the SAME tick (admission
    control must bound the queue instead of growing without limit)."""
    return [arrive(t, w, priority) for w in workloads]


def depart(t: float, name: str) -> InjectEvent:
    return InjectEvent(t, "depart", {"name": name})


def kill(t: float, device: str) -> InjectEvent:
    """Device failure: the device stops heartbeating at ``t``; the fleet
    declares it dead once the heartbeat timeout elapses."""
    return InjectEvent(t, "kill", {"device": device})


def revive(t: float, device: str) -> InjectEvent:
    """The host comes back: the device resumes heartbeating at ``t``.
    If the fleet already declared it dead, the next beat revives it
    (a capacity-scoped replan re-places waiting workloads)."""
    return InjectEvent(t, "revive", {"device": device})


def slow(t: float, device: str, baseline: float = 1.0, factor: float = 8.0,
         steps: int = 6) -> InjectEvent:
    """Straggling device: feeds ``steps`` baseline step-times followed by
    two ``baseline * factor`` outliers into the device's
    ``StragglerMonitor`` (enough to pass warmup and trip detection)."""
    return InjectEvent(t, "slow", {"device": device, "baseline": baseline,
                                   "factor": factor, "steps": steps})


class FaultInjector:
    """Replay a scripted trace against a fleet on a virtual clock.

    >>> clock = FakeClock()
    >>> fleet = FleetScheduler(devices, config, clock=clock)
    >>> FaultInjector(fleet, clock).run(trace, until=30.0)

    Each tick (``tick_dt`` virtual seconds):
      1. apply every event with ``event.t <= now`` (script insertion
         order breaks ties — storms stay ordered);
      2. heartbeat every device that has not been killed;
      3. ``fleet.tick()`` (heartbeat scan, retries, replanning);
      4. optional ``on_tick(fleet, now)`` observation hook;
      5. advance the clock.

    The injector never raises out of ``run`` for *fleet*-side refusals
    (that is the fleet's own no-crash contract); script errors (unknown
    event kind, departing a never-arrived name) do raise — a broken
    script is a test bug, not a fault to tolerate.
    """

    def __init__(self, fleet, clock: FakeClock, tick_dt: float = 1.0,
                 on_tick: Optional[Callable] = None):
        self.fleet = fleet
        self.clock = clock
        self.tick_dt = float(tick_dt)
        self.on_tick = on_tick
        self.killed: set = set()
        self.applied: List[InjectEvent] = []
        self._step_no: Dict[str, int] = {}

    # ------------------------------------------------------------- #
    def _apply(self, ev: InjectEvent) -> None:
        p = ev.payload
        if ev.kind == "arrive":
            self.fleet.submit(p["workload"], priority=p["priority"],
                              train_meta=p.get("train_meta"))
        elif ev.kind == "depart":
            self.fleet.remove(p["name"])
        elif ev.kind == "kill":
            self.killed.add(p["device"])
        elif ev.kind == "revive":
            self.killed.discard(p["device"])
            self.fleet.heartbeat(p["device"])
        elif ev.kind == "slow":
            dev = p["device"]
            n0 = self._step_no.get(dev, 0)
            dts = [p["baseline"]] * p["steps"] + \
                  [p["baseline"] * p["factor"]] * 2
            for i, dt in enumerate(dts):
                self.fleet.observe_step(dev, n0 + i, dt)
            self._step_no[dev] = n0 + len(dts)
        else:
            raise ValueError(f"unknown inject event kind: {ev.kind!r}")
        self.applied.append(ev)

    def run(self, trace: Sequence[InjectEvent], until: Optional[float] = None):
        """Run the trace to completion (plus ``until`` extra settle time —
        recovery needs ticks after the last scripted event: heartbeat
        timeouts must elapse and retry backoffs must fire).

        A contiguous run of 2+ due "arrive" events (an arrival storm) is
        admitted through ``fleet.submit_many`` as ONE batched replay when
        the fleet provides it, instead of replanning per arrival.
        """
        pending = sorted(enumerate(trace), key=lambda it: (it[1].t, it[0]))
        pending = [ev for _, ev in pending]
        end = max([until or 0.0] + [ev.t for ev in pending])
        submit_many = getattr(self.fleet, "submit_many", None)
        head = 0
        while head < len(pending) or self.clock() <= end:
            now = self.clock()
            while head < len(pending) and pending[head].t <= now:
                ev = pending[head]
                j = head + 1
                if ev.kind == "arrive" and submit_many is not None:
                    while (j < len(pending) and pending[j].t <= now
                           and pending[j].kind == "arrive"):
                        j += 1
                if j - head > 1:        # storm: one deduplicated replay
                    batch = pending[head:j]
                    submit_many([(e.payload["workload"],
                                  e.payload["priority"],
                                  e.payload.get("train_meta"))
                                 for e in batch])
                    self.applied.extend(batch)
                else:
                    self._apply(ev)
                head = j
            for did in self.fleet.devices:
                if did not in self.killed:
                    self.fleet.heartbeat(did)
            self.fleet.tick()
            if self.on_tick is not None:
                self.on_tick(self.fleet, now)
            self.clock.advance(self.tick_dt)
        return self.fleet
