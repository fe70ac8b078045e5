"""The engine's one-step run-ahead (``Engine.step`` in greedy decoding): a
step enqueues its extend and decode before it reads the previous step's
ids, which reach the host one call later. On the CPU: a sequence's tokens
only grow and its ``done`` comes with its last token, ``step`` is idle only
with nothing in flight, a first token written beside a decode is kept, the
``ahead`` and ``beside`` counters, and tokens, chunks and events equal to
the in-order steps' (``_runs_ahead`` off, as at a temperature) across
modes and families. The tests marked ``card`` run on the card
(``python -m pytest -m card tests/test_torch_run_ahead.py`` there; they
skip without one): a solve replayed on its own stream beside decode
replays in flight, and the run-ahead with its pinned copies and events."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import spans as sp

QWEN3 = "qwen3-1.7b"
CFG = tiny_config(get_config(QWEN3))


@pytest.fixture(autouse=True)
def no_tap_left():
    yield
    graphs.TAP = None


def engine(cfg=CFG, device="cpu", params=None, **kw):
    ecfg = dict(max_slots=3, max_len=160, prefill_chunk=32, mode="interference_aware",
                tbt_slo_ms=1e-6)
    ecfg.update(kw)
    gen = None if params is not None else torch.Generator(device=device).manual_seed(0)
    return Engine(cfg, params=params, ecfg=EngineConfig(**ecfg), device=device, generator=gen)


def in_order(eng):
    """The engine's steps as they run at a temperature: each waits for its
    own ids (here with greedy sampling)."""
    eng._runs_ahead = lambda: False
    return eng


def prompts(cfg, lengths=(9, 70, 41, 20, 33), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lengths]


def serve(eng, cfg=CFG, lengths=(9, 70, 41, 20, 33), on_step=None):
    """One request decoding when the others arrive (more than the slots,
    a long prompt among them, with outputs of different lengths); ``on_step``
    is called after every step with what it returned. Returns the metrics."""
    ps = prompts(cfg, lengths)
    eng.submit(ps[0], max_new=10)
    for _ in range(3):
        busy = eng.step()
        if on_step:
            on_step(busy)
    for i, p in enumerate(ps[1:]):
        eng.submit(p, max_new=2 + 3 * i)
    while True:
        busy = eng.step()
        if on_step:
            on_step(busy)
        if not busy and not eng.waiting:
            return eng.metrics


def instants(eng):
    return [(e.kind, e.detail) for e in eng.events if not e.kind.startswith(sp.SPAN)]


def test_tokens_only_grow_and_done_comes_with_the_last_token():
    eng = engine()
    seqs = []
    submit = eng.submit

    def tracked(prompt, max_new=16):
        sid = submit(prompt, max_new)
        seqs.append(eng.waiting[-1])
        return sid

    eng.submit = tracked
    seen = {}
    released_before_done = []

    def check(_):
        for s in seqs:
            n0, done0 = seen.get(s.seq_id, (len(s.tokens), False))
            assert len(s.tokens) >= n0, s.seq_id
            if done0:
                assert s.done and len(s.tokens) == n0         # nothing after the last
            elif s.done:
                assert len(s.tokens) > n0                     # the last token came now
                assert eng.metrics[s.seq_id]["output"] == s.tokens[s.prompt_len:]
            else:
                assert s.seq_id not in eng.metrics
                if s.slot == -1 and s.pos > 0:
                    released_before_done.append(s.seq_id)
            seen[s.seq_id] = (len(s.tokens), s.done)

    metrics = serve(eng, on_step=check)
    assert all(s.done for s in seqs) and sorted(metrics) == [s.seq_id for s in seqs]
    # a slot goes back in the step that enqueues its last decode, one call
    # before the last token is read
    assert released_before_done


def test_step_is_idle_only_with_nothing_in_flight():
    eng = engine()
    calls = []

    def check(busy):
        calls.append(busy)
        if not busy or not (eng.alloc.active or eng.waiting):
            assert eng._flight is None

    metrics = serve(eng, on_step=check)
    assert calls[-1] is False and calls.count(False) == 1
    want = serve(in_order(engine()))
    assert sorted(metrics) == sorted(want)
    for i in want:
        for k in ("prompt_len", "new_tokens", "output"):
            assert metrics[i][k] == want[i][k], (i, k)
    # run_until_done as before: every request finished, nothing in flight
    eng = engine()
    ids = [eng.submit(p, max_new=4) for p in prompts(CFG)]
    got = eng.run_until_done()
    assert sorted(got) == ids and eng._flight is None
    assert all(got[i]["new_tokens"] == 4 for i in ids)
    ref = in_order(engine())
    for p in prompts(CFG):
        ref.submit(p, max_new=4)
    assert [got[i]["output"] for i in ids] == [m["output"] for m in ref.run_until_done().values()]


def test_a_first_token_beside_a_decode_is_kept():
    """A prompt whose only chunk runs in the step whose decode carries
    another slot: its first token goes into the slot's next input on the
    device, and that decode's idle row for the slot (fed the trash
    position) does not overwrite it."""
    def run(eng):
        ext, dec = [], []
        extend, decode = eng._extend, eng._decode

        def _extend(tokens, slot, pos0):
            out = extend(tokens, slot, pos0)
            ext.append((slot, out[0, -1].clone()))
            return out

        def _decode(tokens, pos):
            dec.append(np.asarray(pos).copy())
            return decode(tokens, pos)

        eng._extend, eng._decode = _extend, _decode
        a, b = prompts(CFG, (9, 14))       # b: one chunk at any price
        eng.submit(a, max_new=12)
        for _ in range(3):                    # the first request is decoding ...
            eng.step()
        sid = eng.submit(b, max_new=5)        # ... when a short prompt arrives
        n, d = len(eng.events), len(dec)
        eng.step()
        step = eng.events[n:]
        slot = next(e.detail["slot"] for e in step if e.kind == "admit")
        chunk = next(e.detail for e in step if e.kind == "prefill_chunk")
        assert chunk["seq"] == sid and chunk["chunk"] == len(b) and chunk["colocated_decodes"] == 1
        assert len(dec) == d + 1 and dec[-1][slot] == eng.ecfg.max_len   # idle in that decode
        want = int(ext[-1][1].argmax())
        return eng, sid, slot, want

    eng, sid, slot, want = run(engine())
    assert int(eng._next[slot]) == want
    metrics = eng.run_until_done()
    assert metrics[sid]["output"][0] == want
    ref, rsid, _, rwant = run(in_order(engine()))
    assert rwant == want
    assert ref.run_until_done()[rsid]["output"] == metrics[sid]["output"]


@pytest.mark.parametrize("temperature, want", [(0.0, 1), (0.7, 0)])
def test_ahead_and_beside_count_the_steps_enqueued_before_the_last_ids(temperature, want):
    eng = engine(temperature=temperature)
    eng.trace(True)
    serve(eng)
    eng.trace(False)
    spans = eng.spans()
    dec = [s for s in spans if s["name"] == "decode"]
    assert dec and all(s["ahead"] == want for s in dec)
    picks = [s for s in spans if s["name"] == "pick_chunk"]
    colocated = [e.detail["colocated_decodes"] for e in eng.events if e.kind == "prefill_chunk"]
    assert len(picks) == len(colocated) and any(colocated)
    # a chunk priced beside decodes is priced with the last step's ids in flight
    assert all(s["beside"] == want for s, c in zip(picks, colocated) if c)
    if not want:
        assert all(s["beside"] == 0 for s in picks)


ARCHS = {
    "qwen3": (QWEN3, None),
    # capacity factor 0.3 drops: a live row's output depends on what the
    # idle rows are fed, so they must be fed what the in-order steps feed
    "moonshot_drops": ("moonshot-v1-16b-a3b", 0.3),
    "gemma_2b": ("gemma-2b", None),
}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode", ["serial", "interference_aware", "fixed_chunk"])
def test_tokens_chunks_and_events_equal_the_in_order_steps(arch, mode):
    name, cf = ARCHS[arch]
    cfg = tiny_config(get_config(name)).with_overrides(param_dtype="float32")
    if cf is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    got = engine(cfg, mode=mode, max_slots=2)
    want = in_order(engine(cfg, mode=mode, max_slots=2, params=got.params))
    fed = {}
    for eng in (got, want):                   # every decode's input: ids, then positions
        step, fed[eng] = eng.steps["decode"], []
        eng.steps["decode"] = lambda eng=eng, step=step: (
            fed[eng].append(eng._decode_in.tensor.clone()), step())[1]
    mg, mw = serve(got, cfg), serve(want, cfg)
    assert len(fed[got]) == len(fed[want]) > 0
    assert all(torch.equal(a, b) for a, b in zip(fed[got], fed[want]))
    assert list(mg) == list(mw)
    for i in mw:
        assert mg[i]["output"] == mw[i]["output"], (mode, i)
        assert mg[i]["new_tokens"] == mw[i]["new_tokens"]
    assert instants(got) == instants(want)
    assert any(e.kind == "prefill_chunk" and e.detail["colocated_decodes"] for e in got.events)


# ----------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: streams, pinned copies and graphs run only there")
    return torch.device("cuda")


@pytest.mark.card
def test_a_solve_beside_decode_replays_changes_neither():
    """The chunk price's solve, replayed on the engine's own stream while
    decode replays are in flight on the steps' stream, gives the slowdowns
    it gives alone, bit for bit, and the decode the logits it gives alone:
    the two groups of graphs do not share a pool."""
    dev = _card()
    from repro_torch.core import Scenario, backend, solve_scenarios
    with backend.solver_backend("torch", device=dev):
        eng = engine(get_config(QWEN3), device=dev, max_slots=64, max_len=1024,
                     prefill_chunk=512)
        rng = np.random.default_rng(0)
        tok = rng.integers(1, eng.cfg.vocab_size, size=64)
        pos = rng.integers(200, 1000, size=64)
        decode = eng.steps["decode"]
        chunks = [eng._phase_profile(f"prefill{c}", c) for c in (512, 256, 128, 64, 32, 16)]
        scenarios = [Scenario((eng._phase_profile("decode", 64),), (ch,)) for ch in chunks]

        def solve():
            with eng._beside():
                return solve_scenarios(scenarios, eng.dev).slowdowns

        alone_logits = eng._decode(tok, pos).clone()
        torch.cuda.synchronize()
        alone = solve()
        for _ in range(16):                   # ~16 x 4 ms of replays queued
            decode()
        queued = torch.cuda.Event()
        queued.record()
        beside = solve()
        in_flight = not queued.query()
        torch.cuda.synchronize()
        assert in_flight, "the decode replays ended before the solve did"
        assert np.array_equal(alone, beside)
        assert torch.equal(decode.out, alone_logits)
        idx = torch.cuda.current_device()
        steps, solver = graphs._pools[idx, graphs.STEPS], graphs._pools[idx, graphs.SOLVER]
        assert steps[0] != solver[0] and decode.graph in steps[1]
        from repro_torch.core import estimator_torch
        assert all(s.graph in solver[1] for s in estimator_torch.captured_steps()
                   if s.graph is not None)


@pytest.mark.card
def test_run_ahead_serves_the_in_order_tokens_on_the_card():
    """qwen3-1.7b at full width on the card, its steps captured: the
    run-ahead, whose ids come back through pinned copies and events while
    the next step is queued, serves the in-order steps' tokens, chunks and
    events, and enqueues every decode with the last step's ids unread."""
    dev = _card()
    from repro_torch.core import backend
    cfg = get_config(QWEN3)
    with backend.solver_backend("torch", device=dev):
        kw = dict(device=dev, max_slots=16, max_len=1024, prefill_chunk=256, tbt_slo_ms=50.0)
        got = engine(cfg, **kw)
        want = in_order(engine(cfg, params=got.params, **kw))
        lengths = (40, 700, 300, 90, 500, 20, 260, 128, 64, 333) * 3
        got.trace(True)
        mg = serve(got, cfg, lengths)
        got.trace(False)
        mw = serve(want, cfg, lengths)
    assert list(mg) == list(mw)
    assert all(mg[i]["output"] == mw[i]["output"] for i in mw)
    assert instants(got) == instants(want)
    dec = [s for s in got.spans() if s["name"] == "decode"]
    assert dec and all(s["ahead"] == 1 for s in dec)
