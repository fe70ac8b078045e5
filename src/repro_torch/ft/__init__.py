"""Fault-tolerance runtime pieces: straggler detection, failure-domain
heartbeats, and elastic-rescale planning. The twin of
``src/repro/ft/__init__.py``, pure Python, carried over as it is.

On a real multi-pod deployment these hook into the cluster manager; the
logic (detection thresholds, rescale math, checkpoint-driven recovery
protocol) is host-side Python and identical at any scale, so it is fully
implemented and tested here.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class StragglerMonitor:
    """EWMA step-time watchdog (synchronous-SPMD straggler mitigation:
    detect, log, and trigger a rebalance/replace hook).

    ``clock`` stamps detection events; it defaults to ``time.monotonic``
    (wall-clock ``time.time`` would let NTP jumps skew event timelines)
    and is injectable so tests and the fault-injection harness
    (repro_torch.ft.inject) run on a deterministic virtual clock.
    """

    def __init__(self, factor: float = 3.0, alpha: float = 0.2,
                 warmup: int = 3, on_straggle: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.on_straggle = on_straggle
        self.clock = clock
        self.ewma: Optional[float] = None
        self.n = 0
        self.events: List[Dict] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        straggling = (self.n > self.warmup and dt > self.factor * self.ewma)
        if straggling:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma,
                                "time": self.clock()})
            if self.on_straggle:
                self.on_straggle(step, dt, self.ewma)
        else:
            # only healthy steps update the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return straggling


@dataclass
class Heartbeat:
    worker: str
    last_seen: float


class HeartbeatTracker:
    """Failure detection across workers (hosts report; controller scans).

    Timeout math runs on ``clock`` — ``time.monotonic`` by default, so an
    NTP step on the controller can never mass-declare workers dead — and
    the clock is injectable (tests / repro_torch.ft.inject pass a virtual
    clock, so no test ever sleeps).  An explicit ``now`` always wins,
    including ``now=0.0`` (the old ``now or time.time()`` treated a zero
    timestamp as "unset").
    """

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.beats: Dict[str, Heartbeat] = {}

    def beat(self, worker: str, now: Optional[float] = None):
        self.beats[worker] = Heartbeat(
            worker, self.clock() if now is None else now)

    def forget(self, worker: str) -> None:
        """Stop tracking a worker (it was drained/decommissioned, not
        lost): it must no longer show up in ``dead_workers``."""
        self.beats.pop(worker, None)

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return [w for w, h in self.beats.items()
                if now - h.last_seen > self.timeout]


@dataclass
class RescalePlan:
    old_shape: Dict[str, int]
    new_shape: Dict[str, int]
    new_global_batch: int
    new_microbatches: int
    lr_scale: float
    restart_step: int

    @property
    def new_chip_count(self) -> int:
        return math.prod(self.new_shape.values())


def plan_rescale(old_shape: Dict[str, int], lost_chips: int,
                 global_batch: int, num_microbatches: int,
                 current_step: int) -> RescalePlan:
    """Elastic rescale after losing chips: shrink the data axis to the
    largest feasible size, keep global batch (more grad accum), resume
    from the last checkpoint. Checkpoints are mesh-free (repro_torch.checkpoint)
    so re-sharding is a placement at restore time."""
    old_chips = math.prod(old_shape.values())
    target = old_chips - lost_chips
    new_shape = dict(old_shape)
    # shed entire data-axis rows (model axis must stay intact for TP)
    while math.prod(new_shape.values()) > target and new_shape.get("data", 1) > 1:
        new_shape["data"] //= 2
    if "pod" in new_shape and math.prod(new_shape.values()) > target:
        new_shape["pod"] = max(1, new_shape["pod"] - 1)
    new_chips = math.prod(new_shape.values())
    scale = new_chips / old_chips
    new_mb = max(1, int(round(num_microbatches / scale)))
    return RescalePlan(old_shape, new_shape, global_batch, new_mb,
                       lr_scale=1.0, restart_step=current_step)
