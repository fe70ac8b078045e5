"""The readings of the engine's spans (``gpubench/spans.py``) on synthetic
records, against hand counts; and on a tiny engine's own spans on the CPU."""
import time

import numpy as np
import pytest

from gpubench import spans as gs
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.serve import Engine, EngineConfig

READINGS = (gs.device_idle_share, gs.step_turnaround_ms, gs.solve_ms, gs.replay_launch_ms,
            gs.extend_pad_share, gs.decode_idle_rows_share, gs.admit_us_per_request)


def span(index, name, start, end, parent=None, device=None, **kw):
    return dict(kw, index=index, name=name, start=start, end=end, parent=parent,
                device=device)


def three_steps():
    """A decode step that admits one request; a step that prices, extends
    (100 rows of 128) and decodes, then leaves the engine empty; after a
    wait, a decode step; and a step after the window's untraced part."""
    return [span(0, "step", 0.0, 1.0, left=2),
            span(1, "admit", 0.0, 0.1, 0, n=1),
            span(2, "decode", 0.1, 0.3, 0, (0.2, 0.6), rows=3, slots=4),
            span(3, "sample", 0.3, 0.7, 0, (0.6, 0.65)),
            span(4, "bookkeep", 0.7, 0.75, 0),
            span(5, "step", 1.0, 2.0, left=0),
            span(6, "admit", 1.0, 1.0, 5, n=0),
            span(7, "pick_chunk", 1.0, 1.3, 5),
            span(8, "solve", 1.05, 1.25, 7, (1.1, 1.2)),
            span(9, "extend", 1.3, 1.4, 5, (1.35, 1.6), c=100, rows=128),
            span(10, "decode", 1.4, 1.5, 5, (1.6, 1.9), rows=1, slots=4),
            span(11, "step", 3.0, 3.5, left=1),
            span(12, "admit", 3.0, 3.02, 11, n=1),
            span(13, "decode", 3.02, 3.2, 11, (3.1, 3.4), rows=1, slots=4),
            span(14, "step", 4.0, 4.5, left=1),
            span(15, "decode", 4.0, 4.2, 14, (4.1, 4.4), rows=4, slots=4)]


def record(spans, traced=True):
    """A record whose untraced part ends at 4.0 s (a profiler slice after
    it where ``traced``), or a 4.0 s window."""
    if traced:
        return {"seconds": 5.0, "trace": {"slice": (4.0, 5.0)}, "spans": spans}
    return {"seconds": 4.0, "spans": spans}


@pytest.mark.parametrize("traced", [True, False])
def test_readings_against_hand_counts(traced):
    rec = record(three_steps(), traced)
    assert [s["index"] for s in gs.window(rec)] == list(range(14))
    s = gs.window(rec)
    assert gs.merged(s) == [(0.2, 0.65), (1.1, 1.2), (1.35, 1.9), (3.1, 3.4)]
    assert gs.waits(s) == [(2.0, 3.0)]
    busy, served = 0.45 + 0.1 + 0.55 + 0.3, 4.0 - 1.0
    assert gs.device_idle_share(rec) == pytest.approx(100 * (1 - busy / served))
    table = gs.idle_by_phase(rec)
    assert table == pytest.approx({gs.WAITING: 1.2, "step": 0.45, "pick_chunk": 0.15})
    assert list(table) == [gs.WAITING, "step", "pick_chunk"]
    assert gs.step_turnaround_ms(rec) == pytest.approx(450.0)   # the wait is left out
    assert gs.solve_ms(rec) == pytest.approx(200.0)
    assert gs.replay_launch_ms(rec) == pytest.approx(1e3 * (0.1 + 0.05 + 0.1 + 0.08) / 4)
    assert gs.extend_pad_share(rec) == pytest.approx(100 * 28 / 128)
    assert gs.decode_idle_rows_share(rec) == pytest.approx(100 * (1 - 5 / 12))
    assert gs.admit_us_per_request(rec) == pytest.approx(1e6 * (0.1 + 0.0 + 0.02) / 2)


def test_nothing_to_read():
    rec = record([dict(x, device=None) for x in three_steps()])
    for f in (gs.device_idle_share, gs.step_turnaround_ms, gs.replay_launch_ms):
        assert f(rec) is None
    assert gs.idle_by_phase(rec) == {}
    assert gs.solve_ms(rec) == pytest.approx(200.0)    # the host's reading stays
    assert gs.extend_pad_share(rec) == pytest.approx(100 * 28 / 128)
    for f in READINGS:
        assert f(record(three_steps()[:1])) is None
        assert f({"seconds": 4.0}) is None             # a record without spans
    assert gs.idle_by_phase({"seconds": 4.0}) == {}


def test_shift():
    s = gs.shifted([span(0, "step", 101.0, 101.2, left=1),
                    span(1, "decode", 101.0, 101.1, 0, (101.00152, 101.00852)),
                    span(2, "bookkeep", 101.1, 101.2, 0)], 100.0)
    assert s[0]["start"] == pytest.approx(1.0) and s[2]["device"] is None
    assert s[1]["device"] == pytest.approx((1.00152, 1.00852))


def test_a_tiny_engines_spans():
    """The readings of a tiny engine's own trace on the CPU: the host's
    readings read, the device's are None (no interval off the card)."""
    cfg = tiny_config(get_config("qwen3-1.7b"))
    eng = Engine(cfg, ecfg=EngineConfig(max_slots=2, max_len=160, prefill_chunk=32,
                                        tbt_slo_ms=1e-6), device="cpu")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    eng.trace(True)
    for n in (9, 70, 41):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n).tolist(), max_new=5)
    eng.run_until_done()
    eng.trace(False)
    rec = {"seconds": time.perf_counter() - t0, "spans": gs.shifted(eng.spans(), t0)}
    assert len(gs.window(rec)) == len(rec["spans"]) > 0
    for f in (gs.device_idle_share, gs.step_turnaround_ms, gs.replay_launch_ms):
        assert f(rec) is None
    assert gs.solve_ms(rec) is not None
    assert 0.0 < gs.extend_pad_share(rec) < 100.0
    assert 0.0 <= gs.decode_idle_rows_share(rec) < 100.0
    assert gs.admit_us_per_request(rec) > 0.0
