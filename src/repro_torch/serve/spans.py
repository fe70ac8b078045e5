"""Spans of ``Engine.step``, and the intervals of their device work on the
host's clock.

While ``Engine.trace(True)`` holds, the engine appends one span record to
``Engine.events`` for each phase of a step: a ``StepEvent`` whose kind is
``SPAN`` + the phase's name, whose ``start`` and ``t`` are its host interval
on ``time.perf_counter`` (the clock of every other event), and whose
``detail`` holds ``parent`` (the index in ``events`` of the enclosing span;
None for a step's root), the request's ``seq`` where the phase serves one,
and the phase's counters. A span is appended when it opens, so a parent
comes before its children and the instant events of its phase.

Where a span launches device work, two CUDA timing events from a pool
bracket that work on the current stream: a captured step's replay
(``graphs.TAP``), or the argmax and the copy of the sampled ids. A
span keeps its first start event and its last end event. Its interval opens
when its work is enqueued: on an idle card that is before the first kernel
runs, so the interval holds the graph's launch. When the trace
starts, after a ``synchronize``, the host clock is read and an anchor event
recorded on the idle card; an event's host time is then ``anchor_host +
anchor.elapsed_time(event)``, good to the launch latency of one event. When
the trace stops, a second anchor taken the same way scales the elapsed
times to the host clock's rate. The elapsed times are read only at export
(``resolve``): the step never waits for an event. On the CPU no event is
made and the spans carry no device interval.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

SPAN = "span."          # the kind of a span record is SPAN + its name
POOL_EVENTS = 1 << 15   # events made when an engine's trace first starts


class EventPool:
    """Timing events made ahead of use and handed out in order: ``grow``
    makes ``n`` more and records each once, so that its CUDA event exists
    before a step takes it. A pool that runs out doubles."""

    def __init__(self, make: Callable, n: int = POOL_EVENTS):
        self.make = make
        self.events: list = []
        self.used = 0
        self.grow(n)

    def grow(self, n: int) -> None:
        new = [self.make() for _ in range(n)]
        for e in new:
            e.record()
        self.events += new

    def take(self):
        if self.used == len(self.events):
            self.grow(len(self.events))
        e = self.events[self.used]
        self.used += 1
        return e


class Recorder:
    """One trace of an engine: the spans open now, the spans whose device
    events wait to be read, and the anchors. ``pool`` is None on the CPU;
    ``sync`` waits for the card; events are recorded on ``stream`` (looking
    the current stream up costs more than the record)."""

    def __init__(self, events: list, pool: Optional[EventPool] = None,
                 sync: Callable = lambda: None, clock: Callable = time.perf_counter,
                 stream=None):
        from repro_torch.serve.engine import StepEvent
        self._event = StepEvent
        self.events, self.pool, self.sync, self.clock = events, pool, sync, clock
        self.stream = stream
        self.open_: List[tuple] = []        # (index in events, record), innermost last
        self.pending: list = []             # records whose device events are unread
        self.deferred: list = []            # (record, counters read from the device)
        self.anchor = self.closing = None
        if pool is not None:
            pool.used = 0
            self.anchor = self._stamp()

    def _stamp(self) -> tuple:
        """(host clock, event) on an idle card: the host clock just before
        the event is recorded."""
        self.sync()
        h = self.clock()
        e = self.pool.take()
        e.record(self.stream)
        return h, e

    # ------------------------------------------------------------ spans
    def root(self, name: str, **detail) -> None:
        """Open a step's root span (spans a failed step left open close)."""
        self.open_.clear()
        self.open(name, **detail)

    def open(self, name: str, **detail) -> None:
        t = self.clock()
        parent = self.open_[-1][0] if self.open_ else None
        rec = self._event(SPAN + name, t, dict(parent=parent, **detail), start=t)
        self.open_.append((len(self.events), rec))
        self.events.append(rec)

    def close(self, **detail) -> None:
        """Close the innermost open span, adding ``detail`` to it."""
        _, rec = self.open_.pop()
        rec.t = self.clock()
        rec.detail.update(detail)

    def since(self) -> int:
        """Events appended after the innermost open span."""
        return len(self.events) - self.open_[-1][0] - 1

    # ------------------------------------------------------------ device
    def before(self) -> None:
        """Device work of the innermost open span is about to be enqueued."""
        if self.pool is None or not self.open_:
            return
        rec = self.open_[-1][1]
        if "_pair" not in rec.detail:
            e = self.pool.take()
            e.record(self.stream)
            rec.detail["_pair"] = [e, None]
            self.pending.append(rec)

    def after(self) -> None:
        """It has been enqueued: (re-)record the span's end event."""
        if self.pool is None or not self.open_:
            return
        pair = self.open_[-1][1].detail.get("_pair")
        if pair is not None:
            if pair[1] is None:
                pair[1] = self.pool.take()
            pair[1].record(self.stream)

    def later(self, counters: Callable[[], dict]) -> None:
        """Counters of the innermost open span that read what the device
        computed: ``counters()`` returns them. On the CPU it runs now; on
        the card at ``resolve``, once the card has run the work (the step
        never waits for it)."""
        if not self.open_:
            return
        rec = self.open_[-1][1]
        if self.pool is None:
            rec.detail.update(counters())
        else:
            self.deferred.append((rec, counters))

    def stop(self) -> None:
        """The closing anchor (the trace stops; no span opens after it)."""
        if self.pool is not None:
            self.closing = self._stamp()

    def scale(self) -> float:
        """Host seconds a device second, from the two anchors (1 while the
        trace has not stopped). Waits for the card."""
        if self.closing is None:
            return 1.0
        self.sync()
        (h0, anchor), (h1, e1) = self.anchor, self.closing
        return (h1 - h0) / (anchor.elapsed_time(e1) / 1e3)

    def resolve(self) -> None:
        """Put each pending span's device interval, ``(start, end)`` on the
        host clock, into its ``detail["device"]``, and its deferred counters
        (``later``) into its detail. Waits for the card."""
        if self.deferred:
            self.sync()
            for rec, counters in self.deferred:
                rec.detail.update(counters())
            self.deferred = []
        if not self.pending:
            return
        scale = self.scale()
        self.sync()
        h0, anchor = self.anchor
        for rec in self.pending:
            start, end = rec.detail.pop("_pair")
            a = h0 + scale * anchor.elapsed_time(start) / 1e3
            b = a + (scale * start.elapsed_time(end) / 1e3 if end is not None else 0.0)
            rec.detail["device"] = (a, b)
        self.pending = []


def export(events: list) -> List[dict]:
    """The span records of ``events`` as dicts: ``name``, ``index`` (in
    ``events``), ``start``, ``end``, ``parent``, ``device`` (None where no
    interval was read) and the span's counters."""
    out = []
    for i, e in enumerate(events):
        if e.kind.startswith(SPAN):
            d = dict(e.detail)
            d.pop("_pair", None)
            out.append(dict(d, name=e.kind[len(SPAN):], index=i, start=e.start, end=e.t,
                            device=d.get("device")))
    return out
