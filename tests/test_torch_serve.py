"""The port's serving engine on the CPU: twins of every test in
tests/test_serve.py (output parity with naive full-forward generation, HOL
mitigation via chunked prefill, chunk pricing, slot allocation), and the
cross-package test: the JAX engine and the port's, on the same weights,
prompts and device model, give the same tokens and the same sequence of
prefill chunk sizes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.core import H100 as JAX_H100
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.core import H100, TPU_V5E, backend
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import Engine as _Engine
from repro_torch.serve import EngineConfig, SlotAllocator
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.kvcache import Sequence

QWEN3 = "qwen3-1.7b"
CFG = tiny_config(get_config(QWEN3))


def Engine(cfg, **kw):
    """The port's engine on the CPU (its default device is the GPU)."""
    return _Engine(cfg, device="cpu", **kw)


def greedy_reference(cfg, params, prompt, max_new, monkeypatch):
    """Ground truth: re-run the FULL forward for every generated token,
    with the oracle attention in the place of the kernel-backed one."""
    monkeypatch.setattr(attn, "run_attention",
                        lambda q, k, v, *, kind, window, softcap:
                        attn.reference_attention(q, k, v, kind, window))
    model = build_model(cfg, device="cpu")
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(max_new):
            logits = model.forward(params, {"tokens": torch.tensor([toks])})
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("mode", ["serial", "interference_aware"])
def test_engine_matches_full_forward(mode, monkeypatch):
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=96,
                                        prefill_chunk=16, mode=mode))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, CFG.vocab_size, size=n).tolist()
               for n in (9, 23)]
    ids = [eng.submit(p, max_new=4) for p in prompts]
    metrics = eng.run_until_done()
    for i, p in zip(ids, prompts):
        want = greedy_reference(CFG, eng.params, p, 4, monkeypatch)
        assert metrics[i]["output"] == want, (mode, i)

def test_engine_continuous_batching_over_subscription():
    """More requests than slots: all must finish via slot recycling."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=64,
                                        prefill_chunk=16))
    rng = np.random.default_rng(1)
    ids = [eng.submit(rng.integers(1, 50, size=8).tolist(), max_new=3)
           for _ in range(5)]
    m = eng.run_until_done()
    assert sorted(m) == sorted(ids)
    assert all(v["new_tokens"] == 3 for v in m.values())


def test_chunked_prefill_reduces_decode_gap():
    """Paper §4.2: a long prompt must not block the decode batch — the
    interference-aware mode splits it into chunks, so the number of
    decode steps interleaved during the long prefill is > 0."""
    def interleavings(mode):
        eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=320,
                                            prefill_chunk=32, mode=mode,
                                            tbt_slo_ms=1e-6))
        eng.submit([1, 2, 3, 4], max_new=40)     # decoder workload
        for _ in range(4):                        # let it start decoding
            eng.step()
        # 256 tokens inside the vocabulary (the reference's test feeds the id
        # 256 == vocab_size, which JAX's gather fills silently; here an id
        # out of range raises)
        eng.submit([1 + i % 255 for i in range(256)], max_new=2)  # long prompt arrives
        kinds = []
        for _ in range(40):
            n0 = len(eng.events)
            eng.step()
            kinds += [e.kind for e in eng.events[n0:]]
        # count decodes between first and last prefill chunk
        first = kinds.index("prefill_chunk") if "prefill_chunk" in kinds else 0
        last = len(kinds) - 1 - kinds[::-1].index("prefill_chunk") \
            if "prefill_chunk" in kinds else 0
        return kinds[first:last].count("decode"), kinds.count("prefill_chunk")

    serial_interleave, serial_chunks = interleavings("serial")
    aware_interleave, aware_chunks = interleavings("interference_aware")
    assert serial_chunks == 1                    # monolithic prefill
    assert aware_chunks > 1                      # chunked
    assert aware_interleave > serial_interleave  # decode kept flowing


def test_pick_chunk_prices_floor_chunk(monkeypatch):
    """The halving ladder must include the 16-token floor as a PRICED
    candidate (the old loop stopped above it), and the no-candidate-
    passes fallback must be estimator-backed: the priced candidate with
    the lowest predicted TBT, not an unpriced halving."""
    import repro_torch.serve.engine as engine_mod

    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=96,
                                        prefill_chunk=64,
                                        tbt_slo_ms=1e-9))   # nothing passes
    priced_chunks = []
    real_solve = engine_mod.solve_scenarios

    def spy(scenarios, dev=None):
        priced_chunks.append(
            [int(sc.background[0].name.removeprefix("prefill"))
             for sc in scenarios])
        return real_solve(scenarios, dev)

    monkeypatch.setattr(engine_mod, "solve_scenarios", spy)
    seq = Sequence(0, prompt_len=80, max_new=1)
    chunk = eng._pick_chunk(seq, n_active_decodes=1)
    assert priced_chunks and priced_chunks[-1] == [64, 32, 16]
    # the estimator-backed fallback: with TBT monotone in chunk size the
    # minimum predicted TBT is the floor chunk — and it was priced
    assert chunk == 16

    # with a sane SLO the largest passing candidate wins as before
    eng.ecfg.tbt_slo_ms = 1e9
    assert eng._pick_chunk(seq, n_active_decodes=1) == 64


def test_pick_chunk_short_remainder_still_priced(monkeypatch):
    """Prompts shorter than twice the floor used to skip pricing
    entirely (empty candidate ladder); now the floor chunk is priced."""
    import repro_torch.serve.engine as engine_mod

    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=96,
                                        prefill_chunk=64))
    priced = []
    real_solve = engine_mod.solve_scenarios

    def spy(scenarios, dev=None):
        priced.append(
            [int(sc.background[0].name.removeprefix("prefill"))
             for sc in scenarios])
        return real_solve(scenarios, dev)

    monkeypatch.setattr(engine_mod, "solve_scenarios", spy)
    seq = Sequence(0, prompt_len=20, max_new=1)
    chunk = eng._pick_chunk(seq, n_active_decodes=1)
    assert priced == [[20, 16]]  # the floor chunk was estimator-priced
    assert chunk in (20, 16)


def test_slot_allocator():
    a = SlotAllocator(n_slots=2, max_len=32)
    s1 = Sequence(1, prompt_len=8, max_new=4)
    s2 = Sequence(2, prompt_len=8, max_new=4)
    s3 = Sequence(3, prompt_len=8, max_new=4)
    huge = Sequence(4, prompt_len=40, max_new=4)
    assert a.can_admit(s1) and a.admit(s1) in (0, 1)
    assert a.can_admit(s2)
    a.admit(s2)
    assert not a.can_admit(s3)          # full
    assert not a.can_admit(huge)        # never fits
    a.release(1)
    assert a.can_admit(s3)


def test_slot_allocator_admit_when_full_raises():
    a = SlotAllocator(n_slots=1, max_len=32)
    a.admit(Sequence(1, prompt_len=8, max_new=4))
    with pytest.raises(RuntimeError):
        a.admit(Sequence(2, prompt_len=8, max_new=4))
    # the failed admit must not leak state
    assert a.utilization == 1.0 and list(a.active) == [1]


def test_slot_allocator_double_release_raises():
    a = SlotAllocator(n_slots=2, max_len=32)
    a.admit(Sequence(1, prompt_len=8, max_new=4))
    a.release(1)
    with pytest.raises(KeyError):
        a.release(1)
    with pytest.raises(KeyError):
        a.release(99)                       # never admitted
    # free list must not grow from failed releases
    assert len(a.free) == 2 and a.utilization == 0.0


def test_slot_allocator_can_admit_respects_max_len():
    a = SlotAllocator(n_slots=4, max_len=16)
    assert a.can_admit(Sequence(1, prompt_len=8, max_new=8))    # == max_len
    assert not a.can_admit(Sequence(2, prompt_len=8, max_new=9))  # one over
    with pytest.raises(RuntimeError):
        a.admit(Sequence(3, prompt_len=20, max_new=0))


def test_slot_allocator_utilization_round_trip():
    a = SlotAllocator(n_slots=4, max_len=32)
    seqs = [Sequence(i, prompt_len=4, max_new=4) for i in range(3)]
    slots = [a.admit(s) for s in seqs]
    assert len(set(slots)) == 3
    assert a.utilization == pytest.approx(0.75)
    assert a.active_slots().tolist() == sorted(slots)
    a.release(1)
    assert a.utilization == pytest.approx(0.5)
    assert a.active_slots().tolist() == sorted(s for i, s in
                                               zip(range(3), slots) if i != 1)
    a.release(0)
    a.release(2)
    assert a.utilization == 0.0 and a.active_slots().tolist() == []


def test_pick_chunk_degraded_mode_is_conservative():
    """Fleet hook: in degraded mode (device oversubscribed after a fleet
    failure) the scheduler must stop taking the largest passing chunk
    and always pick the minimum-predicted-TBT candidate; with TBT
    monotone in chunk size that is the floor chunk. The idle-batch 4x
    chunk boost is also disabled."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=96,
                                        prefill_chunk=64,
                                        tbt_slo_ms=1e9))   # everything passes
    seq = Sequence(0, prompt_len=80, max_new=1)
    assert eng._pick_chunk(seq, n_active_decodes=1) == 64
    assert eng._pick_chunk(seq, n_active_decodes=0) == 80

    eng.set_degraded(True, reason="fleet: dev oversubscribed")
    assert eng._pick_chunk(seq, n_active_decodes=1) == 16
    assert eng._pick_chunk(seq, n_active_decodes=0) == 64  # no 4x boost
    assert eng.events[-1].kind == "degraded"

    eng.set_degraded(False)
    eng.set_degraded(False)            # idempotent: no duplicate event
    assert eng._pick_chunk(seq, n_active_decodes=1) == 64
    assert [e.kind for e in eng.events[-2:]] == ["degraded", "recovered"]


# ------------------------- port-only behaviour ------------------------- #
def test_default_device_model_is_the_h100():
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=1, max_len=32))
    assert eng.dev is H100 and eng.dev.name == "h100_nvl"
    assert Engine(CFG, ecfg=EngineConfig(max_slots=1, max_len=32), dev=TPU_V5E).dev is TPU_V5E


def test_engine_needs_a_gpu_unless_told_otherwise():
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _Engine(CFG)


def test_idle_slots_write_to_the_trash_position():
    """The cache has max_len + 1 positions; a decode step leaves an idle
    slot's rows below max_len untouched and the cache object in place."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=3, max_len=40, prefill_chunk=16))
    assert eng.cache["k"].shape[2] == 41
    k_before = eng.cache["k"]
    eng.submit(list(range(1, 12)), max_new=5)
    eng.run_until_done()
    assert eng.cache["k"] is k_before                      # updated in place
    used = eng.cache["k"].abs().sum(dim=(0, 2, 3, 4)) > 0
    assert used.sum() == 3                                 # every slot decoded ...
    idle = [b for b in range(3) if eng.cache["k"][:, b, :40].abs().sum() == 0]
    assert len(idle) == 2                                  # ... idle ones only at 40


def test_temperature_sampling_keeps_the_reference_s_behaviour():
    """A fresh default_rng(seed) on every call: the same variate each time,
    so equal logits give equal tokens, as in the reference engine."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=1, max_len=32, temperature=0.7, seed=3))
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
    logits[2] = logits[0]
    got = eng._sample(logits)
    p = np.exp((logits[0].numpy() - logits[0].numpy().max()) / 0.7)
    p /= p.sum()
    assert got[0] == got[2] == int(np.random.default_rng(3).choice(256, p=p))
    eng.ecfg.temperature = 0.0
    assert eng._sample(logits) == logits.argmax(-1).tolist()


# ----------------------------- cross-package --------------------------- #
MOONSHOT = "moonshot-v1-16b-a3b"
GEMMA_2B = "gemma-2b"


@pytest.mark.parametrize("arch,cf,mode,chunk,lengths", [
    pytest.param(QWEN3, None, "serial", 32, (9, 70, 41, 120), id="serial"),
    pytest.param(QWEN3, None, "interference_aware", 32, (9, 70, 41, 120),
                 id="interference_aware"),
    pytest.param(QWEN3, None, "fixed_chunk", 32, (9, 70, 41, 120), id="fixed_chunk"),
    # the 150-token prompt's last chunk, 50 tokens at position 100, runs at
    # the 64-row bucket: past the cache's 161 rows
    pytest.param(QWEN3, None, "fixed_chunk", 100, (9, 150, 41, 120), id="capacity_crossing"),
    # the moe family: at capacity factor 0.3 experts drop tokens, and the
    # padded buckets must route only the chunks' real rows
    pytest.param(MOONSHOT, 8.0, "interference_aware", 32, (9, 70, 41, 120),
                 id="moonshot_interference_aware"),
    pytest.param(MOONSHOT, 0.3, "serial", 32, (9, 70, 41, 120), id="moonshot_serial_drops"),
    pytest.param(MOONSHOT, 0.3, "interference_aware", 32, (9, 70, 41, 120),
                 id="moonshot_interference_aware_drops"),
    # geglu, the embedding scale, tied embeddings and one KV head (MQA)
    pytest.param(GEMMA_2B, None, "interference_aware", 32, (9, 70, 41, 120),
                 id="gemma_2b_interference_aware"),
])
def test_both_engines_give_the_same_tokens_and_chunks(arch, cf, mode, chunk, lengths):
    """Same converted f32 weights, same prompts, same DeviceModel: the same
    output tokens and the same sequence of prefill_chunk sizes (the port
    pads every chunk to its bucket; the events carry the real sizes)."""
    jcfg = jax_tiny_config(jax_get_config(arch)).with_overrides(
        param_dtype="float32", attn_impl="reference")
    cfg = tiny_config(get_config(arch)).with_overrides(param_dtype="float32")
    if cf is not None:
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    kw = dict(max_slots=2, max_len=160, prefill_chunk=chunk, mode=mode, tbt_slo_ms=1e-6)
    jeng = JaxEngine(jcfg, ecfg=JaxEngineConfig(**kw), dev=JAX_H100,
                     key=jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), device="cpu")
    eng = Engine(cfg, params=params, ecfg=EngineConfig(**kw), dev=H100)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lengths]
    for e in (jeng, eng):
        e.submit(prompts[0], max_new=12)
        for _ in range(3):                    # the first request is decoding ...
            e.step()
        for p in prompts[1:]:                 # ... when the others arrive
            e.submit(p, max_new=6)
    jm, m = jeng.run_until_done(), eng.run_until_done()
    assert sorted(m) == sorted(jm) == list(range(len(lengths)))
    for i in m:
        assert m[i]["output"] == jm[i]["output"], (mode, i)
        assert m[i]["new_tokens"] == jm[i]["new_tokens"]

    def trace(e):
        return [(ev.kind, ev.detail.get("chunk"), ev.detail.get("colocated_decodes"),
                 ev.detail.get("batch")) for ev in e.events]

    assert trace(eng) == trace(jeng)
    chunks = [c for kind, c, _, _ in trace(eng) if kind == "prefill_chunk"]
    want = {"serial": 4, "interference_aware": 8}.get(
        mode, sum(-(-n // chunk) for n in lengths))
    assert len(chunks) >= want
    assert any(c & (c - 1) for c in chunks)          # some chunk was padded


def test_token_out_of_vocabulary_raises():
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=1, max_len=32))
    eng.submit([1, 2, CFG.vocab_size], max_new=1)
    with pytest.raises(IndexError):
        eng.run_until_done()


@pytest.mark.parametrize("argv, want", [
    ([], ("torch", "cpu")),
    (["--backend", "numpy"], ("numpy", None)),
])
def test_launch_serve_prices_on_its_backend_and_device(argv, want, monkeypatch, capsys):
    """ROADMAP C19: ``launch.serve.main`` runs the engine's chunk pricing on
    the torch solver on ``--device`` unless ``--backend numpy`` is given,
    and restores the process-wide backend afterwards."""
    seen = []

    def watched(*args, **kw):
        seen.append((backend.get_solver_backend(), backend.get_solver_device().type))
        return solve(*args, **kw)

    solve = engine_mod.solve_scenarios
    monkeypatch.setattr(engine_mod, "solve_scenarios", watched)
    before = (backend.get_solver_backend(), backend.get_solver_device())
    metrics = serve_mod.main(["--tiny", "--device", "cpu", "--requests", "2"] + argv)
    assert len(metrics) == 2 and seen
    assert all(b == want[0] for b, _ in seen), seen
    if want[1] is not None:
        assert all(d == want[1] for _, d in seen), seen
    assert (backend.get_solver_backend(), backend.get_solver_device()) == before
    assert "device=cpu" in capsys.readouterr().out
