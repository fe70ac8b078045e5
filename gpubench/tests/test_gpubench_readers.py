"""The end-to-end reductions and every per-layer reader on synthetic
records: tails over all samples, rates over the window, roofline counts
against hand counts at a tiny shape."""
import json

import numpy as np
import pytest

from gpubench import counts, reduce, spec
from gpubench.trace import DeviceEvent, assign, gaps, split, union_us

SHAPE = {"family": "dense", "n_layers": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256,
         "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "qk_norm": True,
         "rope_theta": 1e6, "norm_eps": 1e-6, "tie_embeddings": True}


def request(due, times, admit=None, prompt_len=10, max_new=5):
    return {"rid": 0, "due": due, "submit": due, "admit": due if admit is None else admit,
            "prompt_len": prompt_len, "max_new": max_new, "times": times}


def record(**kw):
    rec = {"seconds": 10.0, "requests": [], "steps": [], "picks": [], "chunks": [],
           "max_len": 64, "max_slots": 4, "shape": SHAPE, "trace": None}
    rec.update(kw)
    return rec


def ev(name, start, dur):
    return DeviceEvent(name, float(start), float(dur))


def test_tails_are_over_every_sample():
    reqs = [request(0.1 * i, [0.1 * i + 0.01 * (i + 1), 0.1 * i + 0.5]) for i in range(100)]
    reqs.append(request(-1.0, [0.0, 0.2]))               # due before the window: no TTFT
    reqs.append(request(9.9, [10.5]))                     # token after the window closed
    rec = record(requests=reqs)
    ttft = [10.0 * (i + 1) for i in range(100)] + [600.0]
    assert reduce.end_to_end(rec)["ttft_p95_ms"] == pytest.approx(np.percentile(ttft, 95))
    gaps_ms = [500.0 - 10.0 * (i + 1) for i in range(100) if 0.1 * i + 0.5 <= 10.0] + [200.0]
    assert len(gaps_ms) == 97
    assert reduce.end_to_end(rec)["tbt_p99_ms"] == pytest.approx(np.percentile(gaps_ms, 99))


def test_rate_is_over_the_window():
    reqs = [request(-5.0, [-0.5, 0.0, 3.0, 9.99, 10.0, 10.01])]
    assert reduce.end_to_end(record(requests=reqs))["tokens_per_s"] == pytest.approx(0.4)


def test_host_readers():
    reqs = [request(1.0, [2.0], admit=1.5), request(2.0, [3.0], admit=2.25),
            request(-1.0, [0.5], admit=-0.5)]
    rec = record(requests=reqs, chunks=[(-1.0, 512), (1.0, 100), (2.0, 300), (11.0, 7)],
                 picks=[(-0.1, 9.0), (1.0, 2.0), (5.0, 4.0)])
    rec["picks"] = [(t, ms, 16) for t, ms in rec["picks"]]
    read = {m: spec.load_reader(m)(rec) for m in ("queue_wait_p95_ms", "chunk_tokens_mean",
                                                   "pick_chunk_ms")}
    assert read["queue_wait_p95_ms"] == pytest.approx(np.percentile([500.0, 250.0], 95))
    assert read["chunk_tokens_mean"] == 200.0
    assert read["pick_chunk_ms"] == 3.0


def traced_record():
    """Two replays: a decode of slots at positions (3, 10, idle, idle) and an
    extend of 8 real rows from position 4, with hand-set kernel times."""
    dec = [ev("void decode_partial_kernel<128>(DecodeParams)", 10, 4),
           ev("void decode_merge_kernel<128>(DecodeParams)", 14, 1),
           ev("gemm", 15, 5)]
    ext = [ev("flash_attention_mma_kernel", 40, 2), ev("flash_attention_merge_kernel", 42, 1),
           ev("gemm", 43, 7)]
    replays = [{"kind": "decode", "pos": np.array([3, 10, 64, 64]), "events": dec},
               {"kind": "extend", "c": 8, "pos0": 4, "events": ext}]
    trace = {"slice": (1.0, 1.0001), "offset_us": 0.0, "prefix_kept": 1,
             "replays": replays, "events": dec + ext + [ev("memcpy", 30, 2)],
             "host": [("harness: waiting for the next arrival", 1.00000, 1.00002),
                      ("sample (argmax, ids to host)", 0.0, 1e-5)],
             "steps": []}
    return record(trace=trace)


def test_rooflines_against_hand_counts():
    rec = traced_record()
    L, KVH, D, H = 2, 2, 16, 4
    dec_bytes = L * 2 * ((2 * 4 * KVH * D + 2 * H * D) + (2 * 11 * KVH * D + 2 * H * D))
    want = dec_bytes / 3.35e12 / 5e-6 * 100
    assert spec.load_reader("flash_decode_roofline")(rec) == pytest.approx(want, rel=1e-12)
    assert spec.load_reader("flash_decode_roofline.chat")(rec) == pytest.approx(want, rel=1e-12)
    keys = 8 * 4 + 36                                  # sum over rows of (pos + 1)
    flops = 4 * L * H * D * keys
    nbytes = L * 2 * (2 * 12 * KVH * D + 2 * 8 * H * D)
    want = max(flops / 989e12, nbytes / 3.35e12) / 3e-6 * 100
    assert spec.load_reader("flash_attention_roofline")(rec) == pytest.approx(want, rel=1e-12)


def test_step_readers_and_mfu():
    rec = traced_record()
    assert spec.load_reader("decode_step_ms")(rec) == pytest.approx(10e-3)
    assert spec.load_reader("extend_ms_per_token")(rec) == pytest.approx(10e-3 / 8)
    per_layer = 64 * (4 + 4) * 16 + 64 * 64 + 3 * 64 * 128
    dec = (2 * (2 * per_layer + 64 * 256) + 4 * 2 * 4 * 16 * 4
           + 2 * (2 * per_layer + 64 * 256) + 4 * 2 * 4 * 16 * 11)
    assert counts.token_flops(SHAPE, 3, True) + counts.token_flops(SHAPE, 10, True) == dec
    ext = 2 * (8 * 2 * per_layer + 64 * 256) + 4 * 2 * 4 * 16 * 68
    assert counts.chunk_flops(SHAPE, 8, 4) == ext
    assert spec.load_reader("decode_mfu.chat")(rec) == pytest.approx(dec / 10e-6 / 989e12 * 100)
    assert spec.load_reader("prefill_mfu.chat")(rec) == pytest.approx(ext / 10e-6 / 989e12 * 100)
    serving = 1e-4 - 2e-5
    assert spec.load_reader("step_mfu")(rec) == pytest.approx((dec + ext) / serving / 989e12 * 100)
    busy = 10 + 10 + 2
    idle = 100 * (1 - busy * 1e-6 / serving)
    assert spec.load_reader("device_idle_share")(rec) == pytest.approx(idle)
    assert spec.load_reader("device_idle_share.chat")(rec) == pytest.approx(idle)


def test_breakdown_and_nothing_to_read():
    rec = traced_record()
    b = reduce.breakdown(rec)
    assert b["device_ops"][0] == ["gemm", pytest.approx(12e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx((10 + 8) * 1e-6)
    json.dumps(b)
    empty = record()
    for m in spec.load_cell("qwen3-1.7b.chat").per_layer + spec.load_cell(
            "qwen3-1.7b.backlog").per_layer:
        assert spec.load_reader(m.name)(empty) is None, m.name


def test_trace_helpers():
    fence = [ev("spin_kernel", 0, 1), ev("spin_kernel", 1, 1), ev("empty_kernel", 3, 1)]
    body = [ev("empty_kernel", 5, 1), ev("a", 6, 2), ev("spin_kernel", 9, 1),
            ev("empty_kernel", 20, 1), ev("b", 21, 1), ev("spin_kernel", 30, 1)]
    complete, broken, kept = split(fence + body)
    assert [(d, [e.name for e in evs]) for d, evs in complete] == [(5, ["a"]), (20, ["b"])]
    assert broken == 0 and kept == 2
    found, delays = assign(complete, broken, [4.0, 19.0], ["extend", "extend"])
    assert [[e.name for e in f] for f in found] == [["a"], ["b"]] and delays == [1.0, 1.0]
    with pytest.raises(RuntimeError):
        split(fence[2:] + body)                    # every opening launch lost
    # a replay that lost its end marker, one that lost its begin marker, and
    # one lost whole: the whole ones are placed by the host's launch times
    dec = ev("decode_partial_kernel", 51, 1)
    lossy = [ev("empty_kernel", 5, 1), ev("a", 6, 2), ev("empty_kernel", 20, 1),
             ev("b", 21, 1), ev("spin_kernel", 30, 1), ev("x", 31, 1), ev("spin_kernel", 35, 1),
             ev("empty_kernel", 50, 1), dec, ev("spin_kernel", 55, 1)]
    complete, broken, _ = split(fence + lossy)
    assert [d for d, _ in complete] == [20, 50] and broken == 2
    host = [4.0, 19.5, 30.5, 40.0, 49.0]
    kinds = ["extend", "extend", "extend", "decode", "decode"]
    found, delays = assign(complete, broken, host, kinds)
    assert [None if f is None else [e.name for e in f] for f in found] == [
        None, ["b"], None, None, ["decode_partial_kernel"]]
    assert delays == [0.5, 1.0]
    # the profiler's clock 3 ms off the host's: the same replays are found
    found2, _ = assign(complete, broken, [h - 3000.0 for h in host], kinds)
    assert [f is None for f in found2] == [f is None for f in found]
    assert union_us([ev("x", 0, 4), ev("y", 2, 4), ev("z", 10, 1)]) == 7
    assert gaps([ev("x", 0, 4), ev("y", 2, 4), ev("z", 10, 1)]) == [(6, 10)]
