"""Drives ``repro_torch``'s serving engine through one cell's window and
keeps what the metrics read: every request's due, submit, admission and
token times on the host clock, every ``Engine.step`` call, every chunk
price, and in a traced run the device trace of a slice of the window.

Two loops, as the mix says:

* ``open``: independent users. Requests are submitted when they are due
  (the generator's schedule, Poisson gaps stratified by ``traffic.py``),
  whether or not the engine keeps up; a lead-in of ``lead_s`` comes first,
  and after the window closes arrivals go on until every request due in it
  has its first token, or the mix's grace has passed (it then failed).
* ``backlog``: offline batches. The queue always holds twice the slots of
  requests; the window opens once the engine has made ``warm_lifetimes``
  mean outputs' worth of decode steps, so that the slots' ages have spread.

Times are seconds from the window's start. A token's time is the host
clock after the ``Engine.step`` that produced it.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gpubench import trace as tr
from gpubench.traffic import Generator, Request

clock = time.perf_counter


def settle() -> None:
    """Before a window: collect, then move every object made so far (the
    engine, the weights' tree, the requests drawn ahead) out of the
    collector's reach, so that its passes in the window walk only what the
    window makes."""
    gc.collect()
    gc.freeze()


@dataclass
class Tracked:
    req: Request
    seq: object = None
    submit: float = float("nan")
    times: List[float] = field(default_factory=list)


class Window:
    """One window of a cell over a built and warmed engine."""

    def __init__(self, eng, gen: Generator, seconds: float, trace_s: float = 0.0):
        self.eng, self.gen, self.seconds, self.trace_s = eng, gen, seconds, trace_s
        self.tracked: List[Tracked] = []
        self.live: List[Tracked] = []
        self.steps: List[tuple] = []            # (start, end) of each Engine.step
        self.picks: List[tuple] = []            # (start, ms, chunk) of each _pick_chunk
        self.host: List[tuple] = []             # (label, start, end) while tracing
        self.replays: List[Dict] = []           # traced replays, in order
        self.mark_host: List[float] = []        # host clock at each begin marker
        self.tracing = False
        self.prof = None
        self.trace_slice: Optional[tuple] = None
        self.t0 = 0.0                           # the window's start on the clock
        self._wrap()

    # ------------------------------------------------------------ hooks
    def now(self) -> float:
        return clock() - self.t0

    def _wrap(self) -> None:
        """Instance-level wrappers around the engine's calls: each records
        what it was asked and passes the call on unchanged."""
        eng, w = self.eng, self
        pick, decode, extend, sample = eng._pick_chunk, eng._decode, eng._extend, eng._sample
        last = {}

        def _pick_chunk(seq, n):
            a = clock()
            c = pick(seq, n)
            b = clock()
            w.picks.append((a - w.t0, (b - a) * 1e3, c))
            if w.tracing:
                w.host.append(("pick_chunk (chunk price, solve)", a - w.t0, b - w.t0))
            return c

        def _decode(tokens, pos):
            last["decode"] = {"pos": np.asarray(pos).reshape(-1).copy()}
            return decode(tokens, pos)

        def _extend(tokens, slot, pos0):
            last["extend"] = {"c": int(np.asarray(tokens).size), "pos0": int(pos0)}
            return extend(tokens, slot, pos0)

        def _sample(logits):
            if not w.tracing:
                return sample(logits)
            a = clock()
            out = sample(logits)
            w.host.append(("sample (argmax, ids to host)", a - w.t0, clock() - w.t0))
            return out

        self._steps = eng.steps
        eng._pick_chunk, eng._decode, eng._extend, eng._sample = (
            _pick_chunk, _decode, _extend, _sample)

        class Marked:
            def __init__(self, step, kind):
                self.step, self.kind = step, kind

            def __call__(self):
                if not w.tracing:
                    return self.step()
                w.mark_host.append(clock() - w.t0)
                tr.begin()
                out = self.step()
                tr.end()
                w.replays.append({"kind": self.kind, **last[self.kind]})
                return out

        eng.steps = {k: Marked(s, "decode" if k == "decode" else "extend")
                     for k, s in eng.steps.items()}

    def close(self) -> None:
        """Take the wrappers off the engine again."""
        for name in ("_pick_chunk", "_decode", "_extend", "_sample"):
            vars(self.eng).pop(name, None)
        self.eng.steps = self._steps

    # ------------------------------------------------------------ pieces
    def submit(self, req: Request) -> None:
        eng = self.eng
        eng.submit(req.prompt, max_new=req.max_new)
        t = Tracked(req, eng.waiting[-1], submit=self.now())
        self.tracked.append(t)
        self.live.append(t)

    def step(self) -> bool:
        a = clock()
        busy = self.eng.step()
        b = clock()
        self.steps.append((a - self.t0, b - self.t0))
        if self.tracing:
            self.host.append(("Engine.step, python", a - self.t0, b - self.t0))
        t = b - self.t0
        keep = []
        for tk in self.live:
            n = len(tk.seq.tokens) - tk.seq.prompt_len
            while len(tk.times) < n:
                tk.times.append(t)
            if not tk.seq.done:
                keep.append(tk)
        self.live = keep
        return busy

    def _trace_tick(self) -> None:
        """The traced slice is the window's last ``trace_s`` seconds: the
        trace starts there and its markers stop at the window's end. The
        profiler is stopped and read once the loop is over
        (``trace_record``), so that its seconds of reading fall outside."""
        if not self.trace_s:
            return
        now = self.now()
        if self.prof is None and now >= max(0.0, self.seconds - self.trace_s):
            import torch
            torch.cuda.synchronize()
            a = clock()
            self.epoch_shift_us = time.time_ns() / 1e3 - clock() * 1e6
            self.prof = tr.start()
            self.tracing = True
            self.trace_start_s = clock() - a
            self._slice_start = self.now()
        elif self.tracing and now >= self._slice_start + self.trace_s:
            import torch
            torch.cuda.synchronize()
            self.tracing = False
            self.trace_slice = (self._slice_start, self.now())

    # ------------------------------------------------------------ loops
    def run_open(self, lead_s: float, grace_s: float) -> None:
        """One block is the window's requests; the lead-in is the last
        ``lead_s`` seconds of the block before (so that a rotated cycle runs
        on into the window unbroken). The block after it is drawn ahead too,
        so that no drawing stalls the loop as the window closes."""
        lead = [r for r in self.gen.blocks(1, -self.seconds) if r.due >= -lead_s]
        pending = deque(lead + self.gen.blocks(2, 0.0))
        settle()
        self.t0 = clock() + lead_s
        in_window = []
        eng = self.eng
        while True:
            now = self.now()
            while pending and pending[0].due <= now:
                req = pending.popleft()
                self.submit(req)
                if 0.0 <= req.due < self.seconds:
                    in_window.append(self.tracked[-1])
                if not pending:
                    pending.extend(self.gen.blocks(1, req.due))
            self._trace_tick()
            if now >= self.seconds and not self.tracing:
                if all(t.times for t in in_window) or now >= self.seconds + grace_s:
                    break
            if eng.waiting or eng.alloc.active:
                self.step()
            else:
                wait = pending[0].due - self.now()
                if wait > 0:
                    a = self.now()
                    time.sleep(wait)
                    if self.tracing:
                        self.host.append(("harness: waiting for the next arrival", a, self.now()))

    def run_backlog(self, warm_steps: int) -> None:
        eng = self.eng
        ahead = 2 * eng.ecfg.max_slots
        decodes = 0
        self.t0 = clock()
        while decodes < warm_steps:              # the slots' ages spread
            while len(eng.waiting) < ahead:
                for req in self.gen.blocks(1, self.now()):
                    self.submit(req)
            n = len(eng.events)
            self.step()
            decodes += sum(e.kind == "decode" for e in eng.events[n:])
        settle()
        new = clock()
        self._shift(new - self.t0)
        self.t0 = new
        while True:
            while len(eng.waiting) < ahead:
                for req in self.gen.blocks(1, self.now()):
                    self.submit(req)
            self._trace_tick()
            if self.now() >= self.seconds and not self.tracing:
                break
            self.step()

    def _shift(self, by: float) -> None:
        """Re-express the warm-up's times against a window that starts
        ``by`` seconds later."""
        for t in self.tracked:
            t.submit -= by
            t.times = [x - by for x in t.times]
        self.steps = [(a - by, b - by) for a, b in self.steps]
        self.picks = [(a - by, ms, c) for a, ms, c in self.picks]

    # ------------------------------------------------------------ record
    def record(self) -> Dict:
        """What the readers read (``gpubench/metrics``)."""
        admits = {}
        for e in self.eng.events:
            if e.kind == "admit":
                admits[e.detail["seq"]] = e.t - self.t0
        chunks = [(e.t - self.t0, e.detail["chunk"]) for e in self.eng.events
                  if e.kind == "prefill_chunk"]
        reqs = []
        for t in self.tracked:
            reqs.append({"rid": t.req.rid, "due": t.req.due, "submit": t.submit,
                         "admit": admits.get(t.seq.seq_id, float("nan")),
                         "prompt_len": len(t.req.prompt), "max_new": t.req.max_new,
                         "times": t.times})
        return {"seconds": self.seconds, "requests": reqs, "steps": self.steps,
                "picks": self.picks, "chunks": chunks,
                "max_len": self.eng.ecfg.max_len, "max_slots": self.eng.ecfg.max_slots}

    def trace_record(self) -> Optional[Dict]:
        """The traced slice: each replay's device events (between its two
        markers; a replay that lost a marker is left out), every device
        event of the slice but the markers, the host spans, and the offset
        from the host clock to the device's."""
        if self.prof is None:
            return None
        self.prof.stop()
        events = tr.device_events(self.prof)
        self.prof = None
        complete, broken, kept = tr.split(events)
        host_us = [(h + self.t0) * 1e6 + self.epoch_shift_us for h in self.mark_host]
        found, delays = tr.assign(complete, broken, host_us,
                                  [r["kind"] for r in self.replays])
        if not complete:
            raise RuntimeError("no traced replay is whole in the trace")
        first = complete[0][0]
        last = max(e.start_us + e.dur_us for _, ev in complete for e in ev)
        inside = [e for e in events if first <= e.start_us <= last
                  and tr.MARKER not in e.name and tr.SPIN not in e.name]
        a, b = self.trace_slice
        return {"slice": (a, b), "offset_us": (self.t0 * 1e6 + self.epoch_shift_us
                                               + min(delays)),
                "prefix_kept": kept, "start_s": self.trace_start_s,
                "lost_replays": found.count(None), "median_delay_us": sorted(delays)[len(delays) // 2],
                "replays": [dict(r, events=ev) for r, ev in zip(self.replays, found)
                            if ev is not None],
                "events": inside, "host": self.host}
