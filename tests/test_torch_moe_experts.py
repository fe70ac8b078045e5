"""The expert products over each expert's kept rows (``kernels/moe_experts.py``)
and what rests on them: the dispatch that calls them, a capacity that drops
nothing, the moe counters of the engine's spans, and Phi-3.5-MoE at 16 of its
32 layers, dropless. No JAX: the port is held to its former code and to the
benchmark's plain reference (``gpubench/reference``).

The tests marked ``card`` hold the CUDA kernel against its plain version on
the card (``python -m pytest -m card tests/test_torch_moe_experts.py``
there); they decide inside the test whether there is a card and skip here.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_config
from repro_torch.kernels import moe_experts as me
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.serve.engine import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import weights as wt  # noqa: E402
from gpubench.reference import decoder  # noqa: E402

PHI = "phi3.5-moe-42b-a6.6b"
# Phi-3.5-MoE-instruct (https://huggingface.co/microsoft/Phi-3.5-MoE-instruct)
# at 16 of its 32 layers, one of two pipeline stages, with a capacity that
# drops nothing: the benchmark's configuration file
PHI_L16 = json.loads((ROOT / "gpubench" / "configs" / "phi3.5-moe-l16.json").read_text())


def tiny_phi(capacity_factor=8.0, n_layers=2, param_dtype="float32"):
    """Phi-3.5-MoE's block at a tiny width: 16 experts, top 2."""
    cfg = get_config(PHI)
    return cfg.with_overrides(
        n_layers=n_layers, d_model=64, d_ff=64, vocab_size=256, norm_eps=1e-5,
        param_dtype=param_dtype,
        attn=dataclasses.replace(cfg.attn, n_heads=4, n_kv_heads=2, head_dim=16),
        moe=dataclasses.replace(cfg.moe, d_ff_expert=64, capacity_factor=capacity_factor))


def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def former_dispatch(x_flat, gates, ids, wg, wu, wd, cap, act="silu", n_real=None,
                    cap_real=None):
    """``moe._dispatch_compute_combine`` as it was before the expert products
    had a wrapper: three ``torch.bmm`` over every row of the buffer."""
    T, d = x_flat.shape
    E, k = wg.shape[0], ids.shape[1]
    flat_ids = ids.reshape(-1)
    sort_key = flat_ids
    if n_real is not None:
        row = torch.arange(T * k) // k
        sort_key = torch.where(row < n_real, flat_ids, E)
    sorted_ids, order = torch.sort(sort_key, stable=True)
    starts = torch.searchsorted(sorted_ids, torch.arange(E + 1))
    pos = torch.arange(T * k) - starts[sorted_ids]
    keep = (sorted_ids < E) & (pos < (cap if cap_real is None else cap_real))
    slot = torch.where(keep, sorted_ids * cap + pos, E * cap)
    tok = order // k
    buf = x_flat.new_zeros((E * cap + 1, d))
    buf.index_copy_(0, slot, torch.where(keep[:, None], x_flat.index_select(0, tok), 0))
    h_in = buf[:-1].view(E, cap, d)
    g, u = torch.bmm(h_in, wg), torch.bmm(h_in, wu)
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    out_e = torch.bmm(h, wd).view(E * cap, d)
    contrib = out_e.index_select(0, torch.where(keep, slot, E * cap - 1))
    gate = gates.reshape(-1).index_select(0, order)[:, None].to(contrib.dtype)
    return moe._combine(torch.where(keep[:, None], contrib * gate, 0), order, ids)


def layer_inputs(cfg, T, seed=0):
    lp = {k: v[0] for k, v in f32(wt.draw(wt.shape(cfg), seed, "cpu"))["stack"]["moe"].items()}
    x = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1))
    return lp, x


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("cf,act,T,c", [(0.25, "silu", 48, None), (1.0, "gelu", 48, None),
                                        (8.0, "silu", 48, None), (0.5, "silu", 64, 37),
                                        (8.0, "silu", 64, 37)])
def test_the_dispatch_equals_the_former_bmm_path(cf, act, T, c):
    """Every token's output, so every kept row's, equals the former three-bmm
    code bit for bit, at capacities that drop and that do not, with padded
    rows (``n_real``) or none."""
    cfg = tiny_phi(cf)
    lp, x = layer_inputs(cfg, T)
    gates, ids, _ = moe._route(lp["router"], x, cfg)
    cap = moe.capacity(T, cfg)
    kw = {}
    if c is not None:
        kw = dict(n_real=torch.tensor([c]), cap_real=torch.tensor([moe.capacity(c, cfg)]))
    got = moe._dispatch_compute_combine(x, gates, ids, lp["w_gate"], lp["w_up"],
                                        lp["w_down"], cap, act, **kw)
    want = former_dispatch(x, gates, ids, lp["w_gate"], lp["w_up"], lp["w_down"], cap, act,
                           **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_the_plain_version_on_each_kept_row(act):
    """``moe_experts_plain`` row by row: each expert's first ``count`` rows
    are that row through the expert's own SwiGLU (or GeGLU)."""
    g = torch.Generator().manual_seed(5)
    E, cap, d, f = 4, 12, 16, 24
    x = torch.randn(E, cap, d, generator=g)
    wg, wu = torch.randn(E, d, f, generator=g), torch.randn(E, d, f, generator=g)
    wd = torch.randn(E, f, d, generator=g)
    count = torch.tensor([0, 3, 12, 7], dtype=torch.int32)
    out = me.moe_experts(x, count, wg, wu, wd, act)
    assert out.shape == (E, cap, d)
    for e in range(E):
        for r in range(int(count[e])):
            a = x[e, r] @ wg[e]
            a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
            torch.testing.assert_close(out[e, r], (a * (x[e, r] @ wu[e])) @ wd[e],
                                       rtol=1e-5, atol=1e-4)


def test_admit_refuses_what_the_kernel_does_not_take():
    E, cap, d, f = 2, 8, 16, 24
    bf = torch.bfloat16
    x, wg = torch.zeros(E, cap, d, dtype=bf), torch.zeros(E, d, f, dtype=bf)
    wd, count = torch.zeros(E, f, d, dtype=bf), torch.zeros(E, dtype=torch.int32)
    me.admit(x, count, wg, wg, wd)
    with pytest.raises(TypeError):
        me.admit(x.float(), count, wg, wg, wd)
    with pytest.raises(TypeError):
        me.admit(x, count.long(), wg, wg, wd)
    with pytest.raises(ValueError):
        me.admit(x, count, wg, wg, wd.transpose(1, 2))
    with pytest.raises(ValueError):
        me.admit(x[..., :12], count, wg[:, :12, :20], wg[:, :12, :20], wd[:, :20, :12])
    with pytest.raises(ValueError):
        me.admit(x, count, wg, wg, wd, act="relu")


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_a_live_row_is_its_own_under_a_capacity_that_drops_nothing(cf):
    """At capacity factor E / k = 8 a row's output does not move when every
    other row of the batch is replaced (idle decode slots included); at a
    factor that drops, some row's does."""
    cfg = tiny_phi(cf)
    T = 64
    lp, x = layer_inputs(cfg, T, seed=3)
    y = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(9))
    base, _ = moe.moe_ffn_local(lp, cfg, x[None])
    moved = []
    for i in range(0, T, 7):
        other = y.clone()
        other[i] = x[i]
        out, _ = moe.moe_ffn_local(lp, cfg, other[None])
        moved.append(float((out[0, i] - base[0, i]).abs().max()))
    if cf == 8.0:
        assert max(moved) <= 1e-6, moved
    else:
        assert max(moved) > 1e-3, moved


def test_rows_past_the_count_reach_no_gradient(monkeypatch):
    """On the card the expert products leave each expert's rows past its
    count unwritten, and a dropped assignment reads one of them. Made NaN
    here, those rows change nothing in a layer at a factor that drops: its
    output and every gradient, the router's included, are the plain
    products' bit for bit."""
    cfg = tiny_phi(0.25)
    plain = me.moe_experts

    def unwritten(x, count, *rest):
        past = torch.arange(x.shape[1])[None, :, None] >= count[:, None, None]
        return torch.where(past, float("nan"), plain(x, count, *rest))

    def run():
        lp, x = layer_inputs(cfg, 48, seed=9)
        # the last expert is not full: a dropped assignment reads a row past its count
        routed = torch.bincount(moe._route(lp["router"], x, cfg)[1].reshape(-1), minlength=16)
        assert routed[-1] < moe.capacity(48, cfg) < routed.max()
        lp = {k: v.clone().requires_grad_() for k, v in lp.items()}
        x.requires_grad_()
        out, _ = moe.moe_ffn_local(lp, cfg, x[None])
        probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
        return out, torch.autograd.grad((out * probe).sum(), [x, *lp.values()])

    want_out, want = run()
    monkeypatch.setattr(me, "moe_experts", unwritten)
    got_out, got = run()
    assert torch.equal(got_out, want_out)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def serve_logits(eng, prompts, max_new):
    """Serve ``prompts`` together; the logits each sequence's tokens were
    sampled from, by sequence, in order (the last chunk's, then each
    decode step's)."""
    got = {}
    decode, extend = eng._decode, eng._extend

    def _decode(tokens, pos):
        out = decode(tokens, pos)
        for s in eng.alloc.active.values():
            if pos[s.slot] < eng.ecfg.max_len:          # fed this step, not idle
                got.setdefault(s.seq_id, []).append(out[s.slot, 0].clone())
        return out

    def _extend(tokens, slot, pos0):
        out = extend(tokens, slot, pos0)
        seq = next(s for s in eng.alloc.active.values() if s.slot == slot)
        if pos0 + len(tokens) >= seq.prompt_len:
            got.setdefault(seq.seq_id, []).append(out[0, -1].clone())
        return out

    eng._decode, eng._extend = _decode, _extend
    ids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_done()
    return [(eng.metrics[i]["output"], torch.stack(got[i])) for i in ids]


def tiny_phi_served(monkeypatch, cache):
    """A tiny Phi-3.5-MoE (2 layers, d 64, 16 experts top 2, capacity factor
    8, f32) served by the engine on the CPU with its cache in ``cache``,
    three requests at once in four slots (one idle): per request, the
    served tokens, the logits each was sampled from (the prefill's last and
    each decode step's) and the benchmark's plain reference's at the same
    positions over the whole sequence."""
    monkeypatch.setattr(model_mod, "KV_DTYPE", cache)
    cfg = tiny_phi()
    shape = wt.shape(cfg)
    w = f32(wt.draw(shape, 2 ** 33 + 7, "cpu"))
    eng = Engine(cfg, params=w, ecfg=EngineConfig(max_slots=4, max_len=64, prefill_chunk=16),
                 device="cpu")
    assert eng.cache["k"].dtype == cache
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 23, 11)]
    out = []
    for prompt, (served, logits) in zip(prompts, serve_logits(eng, prompts, 6)):
        seq = torch.tensor(prompt + served[:-1])
        at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served))
        out.append((served, logits.float(), decoder.logits(w, shape, seq, at)))
    return out


def test_a_tiny_phi_engine_matches_the_plain_reference(monkeypatch):
    """With its cache in f32 the engine computes what the unpatched
    reference does: every logit within the tiny-moe reference test's 2e-4
    (f32 sums in another order), every served token the reference's
    argmax."""
    for served, logits, ref in tiny_phi_served(monkeypatch, torch.float32):
        torch.testing.assert_close(logits, ref, rtol=2e-4, atol=2e-4)
        assert served == ref.argmax(-1).tolist()


def test_a_tiny_phi_engine_over_its_bf16_cache_near_the_plain_reference(monkeypatch):
    """The engine as it serves keeps its cache in bf16 whatever the
    parameters, which rounds keys, values and the attention's weights and
    output: against the unpatched f32 reference its logits differ by up to
    3e-2, held at 8e-2."""
    for _, logits, ref in tiny_phi_served(monkeypatch, torch.bfloat16):
        torch.testing.assert_close(logits, ref, rtol=8e-2, atol=8e-2)


def test_the_configuration_has_the_published_widths():
    """``PHI_L16`` gives the registry's Phi-3.5-MoE with 16 layers, the
    published eps and a capacity that drops nothing; every other width as
    its ``published`` block states; 20.8 B layer parameters and 0.26 B of
    embedding and head, 42.1 GB in bf16."""
    conf = PHI_L16
    cfg = wt.model_config(conf)
    pub, a, m = conf["published"], cfg.attn, cfg.moe
    assert conf["reduced"] == ["num_hidden_layers"] and cfg.n_layers == 16
    entry = {c["name"]: c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]}
    assert entry[conf["name"]]["reduced"] == conf["reduced"]
    assert entry[conf["name"]]["source"] == conf["source"]
    assert pub["num_hidden_layers"] == 32
    assert (cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim) == (
        pub["hidden_size"], pub["num_attention_heads"], pub["num_key_value_heads"],
        pub["head_dim"])
    assert (m.n_experts, m.top_k, m.d_ff_expert) == (
        pub["num_local_experts"], pub["num_experts_per_tok"], pub["intermediate_size"])
    assert (cfg.vocab_size, cfg.tie_embeddings, a.rope_theta, cfg.norm_eps) == (
        pub["vocab_size"], pub["tie_word_embeddings"], pub["rope_theta"], pub["rms_norm_eps"])
    assert m.capacity_factor == m.n_experts / m.top_k
    assert moe.capacity(64, cfg) == 64 and moe.capacity(512, cfg) == 512
    s = wt.shape(cfg)
    layer = (cfg.d_model * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
             + a.n_heads * a.head_dim * cfg.d_model + 3 * m.n_experts * cfg.d_model * m.d_ff_expert
             + cfg.d_model * m.n_experts)
    assert 16 * layer == pytest.approx(20.8e9, rel=5e-3)
    assert 2 * s["vocab_size"] * s["d_model"] == pytest.approx(0.263e9, rel=2e-3)


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_the_spans_carry_the_moe_counters(cf):
    """While traced, a moe engine's ``extend`` and ``decode`` spans count
    the routed pairs of their rows (a chunk's tokens, a decode step's every
    slot), those dropped and the most rows an expert took: nothing dropped
    at factor 8, some at 0.25."""
    cfg = tiny_phi(cf)
    eng = Engine(cfg, params=f32(wt.draw(wt.shape(cfg), 11, "cpu")),
                 ecfg=EngineConfig(max_slots=4, max_len=64, prefill_chunk=16), device="cpu")
    rng = np.random.default_rng(2)
    eng.trace(True)
    for n in (20, 9, 14):
        eng.submit(rng.integers(0, 256, n).tolist(), max_new=5)
    eng.run_until_done()
    eng.trace(False)
    spans = [s for s in eng.spans() if s["name"] in ("extend", "decode")]
    L, k = cfg.n_layers, cfg.moe.top_k
    assert {s["name"] for s in spans} == {"extend", "decode"}
    for s in spans:
        rows = s["c"] if s["name"] == "extend" else s["slots"]
        assert s["moe_assigned"] == L * rows * k
        assert 1 <= s["moe_max_load"] <= rows
        assert 0 <= s["moe_dropped"] <= s["moe_assigned"]
    dropped = sum(s["moe_dropped"] for s in spans)
    assert dropped == 0 if cf == 8.0 else dropped > 0


@pytest.mark.parametrize("c", [None, 100])
def test_the_dispatch_leaves_its_loads(c):
    """Under ``moe.loads_kept`` the dispatch leaves, per expert, the rows
    routed to it and the first ``cap`` of them, which it keeps, counted here
    by hand from the routing: every row where no ``n_real`` is given (a
    decode step's idle slots take capacity), only the first ``n_real`` of a
    padded chunk."""
    cfg = tiny_phi(0.25)
    T, E = 128, cfg.moe.n_experts
    lp, x = layer_inputs(cfg, T, seed=6)
    gates, ids, _ = moe._route(lp["router"], x, cfg)
    cap = moe.capacity(T, cfg)
    kw, real = {}, T
    if c is not None:
        kw = dict(n_real=torch.tensor([c]), cap_real=torch.tensor([moe.capacity(c, cfg)]))
        real = c
    with moe.loads_kept() as loads:
        moe._dispatch_compute_combine(x, gates, ids, lp["w_gate"], lp["w_up"], lp["w_down"],
                                      cap, "silu", **kw)
    routed = torch.bincount(ids[:real].reshape(-1), minlength=E)
    keeps = moe.capacity(real, cfg)
    assert len(loads) == 1
    assert torch.equal(loads[0][0], routed)
    assert torch.equal(loads[0][1], routed.clamp(max=keeps))
    assert int((routed - routed.clamp(max=keeps)).sum()) > 0      # the factor drops
    assert moe.LOADS is None


def test_a_dense_engine_has_no_moe_counters():
    cfg = get_config("qwen3-1.7b")
    cfg = cfg.with_overrides(n_layers=1, d_model=32, d_ff=64, vocab_size=64,
                             param_dtype="float32",
                             attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv_heads=1,
                                                      head_dim=16))
    eng = Engine(cfg, ecfg=EngineConfig(max_slots=2, max_len=32, prefill_chunk=16),
                 device="cpu")
    eng.trace(True)
    eng.submit([1, 2, 3], max_new=3)
    eng.run_until_done()
    eng.trace(False)
    assert not any("moe_dropped" in s for s in eng.spans())


# ----------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


TOL = 2e-2          # chip_smoke's bf16 gate: |got - want| <= TOL + TOL |want|


def kernel_case(dev, E, cap, d, f, counts, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    x = rnd(E, cap, d)
    count = torch.tensor(counts, dtype=torch.int32, device=dev)
    rows = torch.arange(cap, device=dev)[None, :, None]
    x = torch.where(rows < count[:, None, None], x, 0)       # the dispatch's zeros
    return x, count, rnd(E, d, f, scale=d ** -0.5), rnd(E, d, f, scale=d ** -0.5), \
        rnd(E, f, d, scale=f ** -0.5)


def held(got, want, count):
    """The kept rows of ``got`` against ``want``: (largest difference, ok)."""
    keep = torch.arange(got.shape[1], device=got.device)[None, :] < count[:, None].long()
    g, w = got[keep].float(), want[keep].float()
    err = (g - w).abs()
    return float(err.max()) if err.numel() else 0.0, bool((err <= TOL + TOL * w.abs()).all()
                                                          and torch.isfinite(g).all())


# (label, E, cap, d, f, counts)
CARD_CASES = [
    ("phi decode", 16, 64, 4096, 6400, [8, 3, 0, 12, 9, 7, 64, 1, 5, 8, 10, 4, 2, 6, 11, 9]),
    ("phi chunk", 16, 512, 4096, 6400, [64, 71, 58, 80, 49, 66, 63, 70, 62, 55, 69, 75, 60,
                                        57, 68, 77]),
    ("row tiles past 128", 4, 300, 512, 1024, [300, 129, 128, 0]),
    ("moonshot", 64, 48, 2048, 1408, [(7 * e) % 49 for e in range(64)]),
    ("ragged widths", 3, 40, 200, 72, [40, 17, 1]),
]


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_kernel_matches_the_plain_version_on_the_card(case, act):
    """Each expert's kept rows against the plain version (three bmm) at the
    bf16 gate; the launch counted."""
    dev = _card()
    label, E, cap, d, f, counts = case
    args = kernel_case(dev, E, cap, d, f, counts)
    before = me.moe_experts.launches
    got = me.moe_experts(*args, act)
    want = me.moe_experts_plain(*args, act)
    torch.cuda.synchronize()
    err, ok = held(got, want, args[1])
    print(f"{label} {act}: max abs err {err:.3e}")
    assert ok, (label, err)
    assert me.moe_experts.launches == before + 1


@pytest.mark.card
def test_the_gradient_on_the_card_is_the_plain_versions():
    dev = _card()
    args = list(kernel_case(dev, 4, 32, 256, 512, [32, 5, 0, 17], seed=3))
    for i in (0, 2, 3, 4):
        args[i] = args[i].float().requires_grad_()
    leaves = [args[i] for i in (0, 2, 3, 4)]
    bf = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
    keep = (torch.arange(32, device=dev)[None, :] < args[1][:, None].long())[..., None]
    got = torch.autograd.grad((me.moe_experts(*bf).float() * keep).sum(), leaves)
    want = torch.autograd.grad((me.moe_experts_plain(*bf).float() * keep).sum(), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.card
def test_a_phi_layer_on_the_card_against_the_plain_products():
    """``moe_ffn_local`` at Phi's widths, a 64-row decode batch at factor 8,
    with the kernel and with the plain products: the same routing, outputs
    within the bf16 gate."""
    dev = _card()
    cfg = get_config(PHI).with_overrides(moe=dataclasses.replace(get_config(PHI).moe,
                                                                 capacity_factor=8.0))
    w = wt.draw(dict(wt.shape(cfg), n_layers=1), 21, dev)
    lp = {k: v[0] for k, v in w["stack"]["moe"].items()}
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    got, _ = moe.moe_ffn_local(lp, cfg, x)
    kernel = me.moe_experts
    me.moe_experts = me.moe_experts_plain
    try:
        want, _ = moe.moe_ffn_local(lp, cfg, x)
    finally:
        me.moe_experts = kernel
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert bool((err <= TOL + TOL * want.float().abs()).all()), float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("grads", ["router", "all"])
def test_a_dropping_phi_layer_trains_on_the_card(grads):
    """``moe_ffn_local`` at Phi's widths under autograd, 64 rows at factor
    0.25, where tokens drop, after the allocator's free blocks were filled
    with NaN, so that the rows the kernel leaves unwritten hold NaN: every
    gradient is finite, and the router's is the plain products' within 2e-2
    of its norm. ``router``: only the router wants a gradient (the kernel
    runs without one); ``all``: the input and the experts too (the kernel
    under ``_grad.KernelFunction``)."""
    dev = _card()
    cfg = get_config(PHI).with_overrides(moe=dataclasses.replace(get_config(PHI).moe,
                                                                 capacity_factor=0.25))
    w = wt.draw(dict(wt.shape(cfg), n_layers=1), 23, dev)
    x0 = torch.randn(1, 64, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(4),
                     device=dev).to(torch.bfloat16)
    probe = torch.randn(x0.shape, generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev)

    def run():
        junk = [torch.full((n,), float("nan"), dtype=torch.bfloat16, device=dev)
                for n in (1 << 19, 1 << 20, 1 << 21, 1 << 22)]
        del junk
        lp = {k: v[0].detach().clone().requires_grad_(grads == "all" or k == "router")
              for k, v in w["stack"]["moe"].items()}
        x = x0.clone().requires_grad_(grads == "all")
        out, _ = moe.moe_ffn_local(lp, cfg, x)
        leaves = [t for t in (x, *lp.values()) if t.requires_grad]
        return torch.autograd.grad((out.float() * probe).sum(), leaves)

    ids = moe._route(w["stack"]["moe"]["router"][0], x0[0], cfg)[1]
    assert int(torch.bincount(ids.reshape(-1)).max()) > moe.capacity(64, cfg)    # drops
    got = run()
    kernel = me.moe_experts
    me.moe_experts = me.moe_experts_plain
    try:
        want = run()
    finally:
        me.moe_experts = kernel
    torch.cuda.synchronize()
    for g in got:
        assert bool(torch.isfinite(g).all())
    router = 0 if grads == "router" else 1
    a, b = got[router].float(), want[router].float()
    assert float((a - b).norm() / b.norm()) <= 2e-2


@pytest.mark.card
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_the_spans_carry_the_moe_counters_on_the_card(cf):
    """A tiny bf16 Phi-3.5-MoE engine on the card, its steps captured, traced:
    the counters read from the graphs' buffers after the replays, as on the
    CPU: every routed pair counted, nothing dropped at factor 8, some at
    0.25."""
    dev = _card()
    cfg = tiny_phi(cf, param_dtype="bfloat16")
    eng = Engine(cfg, params=wt.draw(wt.shape(cfg), 11, dev),
                 ecfg=EngineConfig(max_slots=4, max_len=64, prefill_chunk=16), device=dev)
    assert all(step.graph is not None for step in eng.steps.values())
    rng = np.random.default_rng(2)
    eng.trace(True)
    for n in (20, 9, 14):
        eng.submit(rng.integers(0, 256, n).tolist(), max_new=5)
    eng.run_until_done()
    eng.trace(False)
    spans = [s for s in eng.spans() if s["name"] in ("extend", "decode")]
    L, k = cfg.n_layers, cfg.moe.top_k
    assert {s["name"] for s in spans} == {"extend", "decode"}
    for s in spans:
        rows = s["c"] if s["name"] == "extend" else s["slots"]
        assert s["moe_assigned"] == L * rows * k
        assert 1 <= s["moe_max_load"] <= rows
    dropped = sum(s["moe_dropped"] for s in spans)
    assert dropped == 0 if cf == 8.0 else dropped > 0
