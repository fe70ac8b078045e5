"""The engine's spans (``Engine.trace``, ``repro_torch.serve.spans``) on the
CPU: with tracing off the step records what it recorded before spans
existed; with tracing on it serves the same tokens, and its spans nest, one
root a step, with counters that agree with the instant events. The device
intervals' arithmetic (anchor + elapsed time, pooled event pairs) is held
against hand-computed times on fake events."""
import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import spans as sp
from repro_torch.serve.engine import StepEvent, chunk_bucket

CFG = tiny_config(get_config("qwen3-1.7b"))


@pytest.fixture(autouse=True)
def no_tap_left():
    yield
    graphs.TAP = None
INSTANTS = {"admit", "prefill_chunk", "decode", "finish", "degraded", "recovered"}


def serve(trace: bool, mode: str = "interference_aware", steps: list = None):
    """A tiny engine on the CPU: one request decoding when three more
    arrive (a long prompt among them, so its chunks are priced beside the
    decode batch). Tracing goes on, if at all, after the first request's
    first step. Returns the engine and its outputs."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=160, prefill_chunk=32,
                                        mode=mode, tbt_slo_ms=1e-6), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, CFG.vocab_size, size=n).tolist() for n in (9, 70, 41, 20)]
    eng.submit(prompts[0], max_new=10)
    eng.step()
    if trace:
        eng.trace(True)
    for p in prompts[1:]:
        eng.submit(p, max_new=5)
    n = 1
    while eng.step() or eng.waiting:
        n += 1
    if steps is not None:
        steps.append(n)
    if trace:
        eng.trace(False)
    return eng, {i: m["output"] for i, m in eng.metrics.items()}


def instants(eng):
    return [(e.kind, e.detail) for e in eng.events if not e.kind.startswith(sp.SPAN)]


@pytest.mark.parametrize("mode", ["interference_aware", "serial"])
def test_tracing_off_records_only_the_instant_events(mode):
    eng, _ = serve(False, mode)
    assert {e.kind for e in eng.events} <= INSTANTS
    assert all(e.start == e.t for e in eng.events)
    assert eng.spans() == []
    # events stay ordered in time, as before spans
    ts = [e.t for e in eng.events]
    assert ts == sorted(ts)


def test_no_cuda_event_is_made_without_trace(monkeypatch):
    made = []

    def fake_event(*a, **k):
        made.append(1)
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", fake_event)
    eng, _ = serve(False)
    assert made == [] and eng._pool is None
    eng, _ = serve(True)                      # on the CPU tracing makes none either
    assert made == [] and eng._pool is None
    assert all(s["device"] is None for s in eng.spans())


@pytest.mark.parametrize("mode", ["interference_aware", "fixed_chunk"])
def test_tracing_serves_the_same_tokens_and_instants(mode):
    off, out_off = serve(False, mode)
    on, out_on = serve(True, mode)
    assert out_on == out_off
    assert instants(on) == instants(off)


def test_spans_nest_one_root_a_step():
    steps = []
    eng, _ = serve(True, steps=steps)
    spans = eng.spans()
    by = {s["index"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert all(s["name"] == "step" for s in roots)
    # every step() after the trace started has its root
    assert len(roots) == steps[0]
    for s in spans:
        assert eng.events[s["index"]].kind == sp.SPAN + s["name"]
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = by[s["parent"]]
            assert p["index"] < s["index"]
            assert p["start"] <= s["start"] and s["end"] <= p["end"], (p, s)
    names = {s["name"] for s in spans}
    assert names == {"step", "admit", "pick_chunk", "solve", "extend", "first_token",
                     "decode", "sample", "bookkeep"}
    # the last step leaves nothing in the engine
    assert roots[-1]["left"] == 0 and all(r["left"] > 0 for r in roots[:-2])
    # a step's children come in the step's order
    order = ["admit", "pick_chunk", "extend", "first_token", "decode", "sample", "bookkeep"]
    for r in roots:
        kids = [s["name"] for s in spans if s["parent"] == r["index"]]
        assert kids == [k for k in order if k in kids] and kids[0] == "admit"


def test_counters_agree_with_the_instant_events():
    eng, _ = serve(True)
    spans = eng.spans()
    by = {s["index"]: s for s in spans}
    ext = [s for s in spans if s["name"] == "extend"]
    traced = eng.events[spans[0]["index"]:]
    chunks = [e.detail for e in traced if e.kind == "prefill_chunk"]
    assert [(s["seq"], s["c"]) for s in ext] == [(d["seq"], d["chunk"]) for d in chunks]
    assert all(s["rows"] == chunk_bucket(s["c"]) for s in ext)
    assert any(s["rows"] > s["c"] for s in ext)              # some chunk was padded
    dec = [s for s in spans if s["name"] == "decode"]
    assert [s["rows"] for s in dec] == [e.detail["batch"] for e in traced
                                        if e.kind == "decode"]
    assert all(s["slots"] == 2 for s in dec)
    admitted = sum(e.kind == "admit" for e in traced)
    assert sum(s["n"] for s in spans if s["name"] == "admit") == admitted == 3
    # pick_chunk holds solve: one solve a pick that priced beside decodes
    solves = [s for s in spans if s["name"] == "solve"]
    assert solves and all(by[s["parent"]]["name"] == "pick_chunk" for s in solves)
    picks = [s for s in spans if s["name"] == "pick_chunk"]
    assert len(picks) == len(ext)
    first = [s for s in spans if s["name"] == "first_token"]
    assert sorted(s["seq"] for s in first) == [1, 2, 3]


def test_trace_switches_and_exports_twice():
    eng, _ = serve(True)
    n = len(eng.spans())
    eng.trace(False)                          # already off: nothing happens
    eng.trace(True)
    eng.trace(True)
    eng.submit([1, 2, 3], max_new=2)
    eng.run_until_done()
    eng.trace(False)
    more = eng.spans()
    assert len(more) > n and more[:n] == eng.spans()[:n]


# ------------------------------------------------------------ device events
class Card:
    """A fake card's clock (ms) and its events: ``record`` stamps the
    card's time, ``elapsed_time`` is the difference in ms."""

    def __init__(self):
        self.now_ms = 0.0
        self.made = 0

    def event(self):
        card = self
        self.made += 1

        class Ev:
            t = None

            def record(self, stream=None):
                self.t = card.now_ms

            def elapsed_time(self, other):
                return other.t - self.t
        return Ev()


def test_intervals_are_anchor_plus_elapsed():
    card = Card()
    host = [100.0]                            # the host clock, s
    pool = sp.EventPool(card.event, 4)
    assert card.made == 4 and pool.used == 0
    events = []
    rec = sp.Recorder(events, pool, clock=lambda: host[0])
    # the anchor: host 100.0 s, card 0 ms
    host[0], card.now_ms = 100.010, 12.0
    rec.root("step")
    rec.open("decode")
    rec.before()                              # card 12 ms -> 100.012 s
    card.now_ms = 19.0
    rec.after()
    rec.before()                              # a second replay in the span
    card.now_ms = 21.5
    rec.after()                               # re-records the same end event
    host[0] = 100.020
    rec.close()
    rec.open("sample")
    card.now_ms = 30.0
    rec.before()
    card.now_ms = 30.25
    rec.after()
    rec.close()
    rec.close()
    assert pool.used == 5 and len(pool.events) == 8     # the pool doubled once
    host[0], card.now_ms = 101.0, 1000.0     # the closing anchor: the same rate
    rec.stop()
    rec.resolve()
    out = {s["name"]: s for s in sp.export(events)}
    assert out["decode"]["device"] == pytest.approx((100.012, 100.0215), abs=1e-12)
    assert out["sample"]["device"] == pytest.approx((100.030, 100.03025), abs=1e-12)
    assert out["step"]["device"] is None and out["decode"]["parent"] == 0
    assert "_pair" not in events[1].detail
    # a new trace reuses the pool from its start
    rec2 = sp.Recorder(events, pool, clock=lambda: host[0])
    assert pool.used == 1 and rec2.anchor[1] is pool.events[0]


def test_the_closing_anchor_scales_to_the_host_rate():
    card = Card()
    host = [0.0]
    events = []
    rec = sp.Recorder(events, sp.EventPool(card.event, 8), clock=lambda: host[0])
    rec.root("step")
    card.now_ms = 500.0
    rec.before()
    card.now_ms = 510.0
    rec.after()
    rec.close()
    host[0], card.now_ms = 2.0, 1000.0        # the card's clock runs at half the rate
    rec.stop()
    rec.resolve()
    (s,) = sp.export(events)
    assert s["device"] == pytest.approx((1.0, 1.02), abs=1e-12)


class Graph:
    """A captured step's stand-in on the CPU: a replay runs the body into
    the step's output and is logged."""

    def __init__(self, step, log):
        self.step, self.log = step, log

    def replay(self):
        self.log.append("replay")
        self.step.out = self.step.body()


def test_a_step_taps_its_replays(monkeypatch):
    calls = []

    class Tap:
        def before(self):
            calls.append("before")

        def after(self):
            calls.append("after")

    step = graphs.Step(lambda: "out", "x")
    step.graph = Graph(step, calls)
    assert step() == "out" and calls == ["replay"]
    monkeypatch.setattr(graphs, "TAP", Tap())
    assert step() == "out" and calls == ["replay", "before", "replay", "after"]
    assert step.calls == 2


def test_steps_captured_after_the_trace_started_are_tapped():
    """A step first captured while the trace is on (as a solver shape first
    met then would be) reports its replays to the trace."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=160, prefill_chunk=32),
                 device="cpu")
    eng.submit(list(range(1, 30)), max_new=4)
    eng.trace(True)
    log = []
    eng._rec.before = lambda: log.append("before")
    eng._rec.after = lambda: log.append("after")
    for k, old in list(eng.steps.items()):
        new = graphs.Step(old.body, old.name)
        new.graph = Graph(new, log)
        eng.steps[k] = new
    eng.run_until_done()
    assert graphs.TAP is eng._rec
    eng.trace(False)
    assert graphs.TAP is None
    replays = [i for i, x in enumerate(log) if x == "replay"]
    assert len(replays) == sum(s.calls for s in eng.steps.values()) > 0
    assert all(log[i - 1] == "before" and log[i + 1] == "after" for i in replays)


def test_each_engine_taps_its_own_steps():
    """Two engines tracing in one process: each step makes its own engine's
    trace the tap, and switching one engine's trace off leaves the other's."""
    a, b = (Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=160, prefill_chunk=32),
                   device="cpu") for _ in range(2))
    for eng in (a, b):
        eng.submit(list(range(1, 12)), max_new=3)
        eng.trace(True)
    a.step()
    assert graphs.TAP is a._rec
    b.step()
    assert graphs.TAP is b._rec
    a.trace(False)
    assert graphs.TAP is b._rec
    a.step()                                  # untraced: the tap is left as it is
    assert graphs.TAP is b._rec
    b.trace(False)
    assert graphs.TAP is None


def test_span_events_keep_the_step_event_type():
    e = StepEvent("admit", 1.5, {"seq": 0})
    assert e.start == 1.5
    e = StepEvent(sp.SPAN + "step", 2.0, {}, start=1.0)
    assert (e.start, e.t) == (1.0, 2.0)
