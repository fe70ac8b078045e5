"""The attention prologue of the decode and extend steps (``rope_write``).

On the CPU the wrapper runs its plain version, which must be the chain the
decode and extend blocks ran eagerly before the kernel: qk-norm, RoPE and
the cache writes, bit for bit, through the wrapper and through the blocks;
``admit`` refuses what the kernel does not take; ``meta`` tensors take the
plain version and the dry run counts what it counted before.

The tests marked ``card`` hold the CUDA kernel against that plain version
on the card (``python -m pytest -m card tests/test_torch_rope_write.py``
there); they decide inside the test whether there is a card and skip
without one. This file imports no JAX.
"""
import dataclasses
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import AttentionConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.kernels import rope_write as rw
from repro_torch.launch import dryrun as dr
from repro_torch.models import attention
from repro_torch.models.layers import l2norm, linear, rope_tables, rotate

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------ the former composition
def former_project_qkv(p, a, x, positions):
    """``attention.project_qkv`` as the decode and extend blocks ran it
    before the kernel."""
    q = attention._heads(linear(x, p["wq"]), a.n_heads, a.head_dim)
    k = attention._heads(linear(x, p["wk"]), a.n_kv_heads, a.head_dim)
    v = attention._heads(linear(x, p["wv"]), a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = l2norm(q) * p["q_norm"].to(q.dtype)
        k = l2norm(k) * p["k_norm"].to(k.dtype)
    cos, sin = rope_tables(positions, a.head_dim, a.rope_theta)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def former_write_kv(cache, new, idx):
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx] = new[:, 0].to(cache.dtype)


def former_decode(p, a, x, cache_k, cache_v, pos, kind="causal"):
    """The decode block before the kernel, and its prologue's (q, kv_len)."""
    B = x.shape[0]
    smax = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    q, k, v = former_project_qkv(p, a, x, pos[:, None])
    slot = pos % smax if kind == "local" else pos
    former_write_kv(cache_k, k, slot)
    former_write_kv(cache_v, v, slot)
    kv_len = torch.clamp(pos + 1, max=smax)
    o = attention.decode_attention(q, cache_k, cache_v, kv_len)
    return linear(o.reshape(B, 1, -1), p["wo"]), q, kv_len


def former_extend(p, a, x, cache_k, cache_v, offsets, positions, rows):
    B, C = x.shape[:2]
    q, k, v = former_project_qkv(p, a, x, positions)
    KVH, D = cache_k.shape[-2:]
    cache_k.view(-1, KVH, D).index_copy_(0, rows, k[0].to(cache_k.dtype))
    cache_v.view(-1, KVH, D).index_copy_(0, rows, v[0].to(cache_v.dtype))
    o = attention.chunk_attention(q, cache_k, cache_v, offsets, softcap=a.softcap)
    return linear(o.reshape(B, C, -1), p["wo"]), q


# ------------------------------------------------------------- inputs
def block(qk_norm: bool, dtype: str, H=4, KVH=2, D=16, d=32, seed=0):
    """A self-attention block's parameters, the norms' scales drawn away
    from 1 so that the product with them is not the identity."""
    g = torch.Generator().manual_seed(seed)
    a = AttentionConfig(n_heads=H, n_kv_heads=KVH, head_dim=D, qk_norm=qk_norm,
                        rope_theta=10_000.0)
    p = attention.attn_init(g, a, d, dtype=TDT[dtype])
    if qk_norm:
        p["q_norm"] = 1 + 0.3 * torch.randn(D, generator=g)
        p["k_norm"] = 1 + 0.3 * torch.randn(D, generator=g)
    return a, p, g


def caches(g, slots, smax, a, dtype):
    shape = (slots, smax, a.n_kv_heads, a.head_dim)
    return (torch.randn(shape, generator=g).to(TDT[dtype]),
            torch.randn(shape, generator=g).to(TDT[dtype]))


def equal(*pairs):
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


# (kind, qk-norm, activations' dtype, cache's dtype)
DECODE_CASES = [("causal", True, "bfloat16", "bfloat16"),
                ("causal", False, "float32", "float32"),
                ("local", True, "bfloat16", "bfloat16"),
                ("causal", True, "float32", "bfloat16"),
                ("local", False, "float32", "float32")]
EXTEND_CASES = [(True, "bfloat16", "bfloat16"), (False, "float32", "float32"),
                (True, "float32", "bfloat16")]


@pytest.mark.parametrize("case", [("decode", *c) for c in DECODE_CASES]
                         + [("extend", None, *c) for c in EXTEND_CASES])
@pytest.mark.parametrize("through", ["wrapper", "block"])
def test_plain_version_is_the_former_composition(case, through):
    """The wrapper on CPU tensors, and the decode / extend block around it,
    give the former eager chain's q, cache and lengths bit for bit: with
    and without qk-norm, causal and in a ring (positions past the ring's
    rows), a chunk padded to the trash row, bf16 and f32, and a bf16 cache
    under f32 activations."""
    step, kind, qk_norm, dt, cdt = case
    a, p, g = block(qk_norm, dt)
    B, smax = 3, 12
    ck, cv = caches(g, B, smax, a, cdt)
    want_k, want_v = ck.clone(), cv.clone()
    if step == "decode":
        x = torch.randn((B, 1, 32), generator=g).to(TDT[dt])
        pos = torch.tensor([0, 7, 30 if kind == "local" else 11])
        out_w, q_w, len_w = former_decode(p, a, x, want_k, want_v, pos, kind)
        if through == "block":
            out = attention.decode_self_attention(p, a, x, ck, cv, pos, kind=kind)
            equal((out, out_w))
        else:
            q, kv_len = rw.rope_write(*attention._project(p, a, x), ck, cv,
                                      pos.expand(B)[:, None], theta=a.rope_theta,
                                      ring=kind == "local", **attention._qk_norms(p, a))
            equal((q, q_w), (kv_len, len_w))
    else:
        C, c = 8, 5                                  # a bucket of 8 rows, 5 of them real
        x = torch.randn((1, C, 32), generator=g).to(TDT[dt])
        offsets = torch.tensor([1, 4, c])
        positions, rows = attention.chunk_rows(offsets, C, smax)
        assert int(rows[-1]) == smax + smax - 1       # the padding's trash row
        out_w, q_w = former_extend(p, a, x, want_k, want_v, offsets, positions, rows)
        if through == "block":
            out = attention.extend_self_attention(p, a, x, ck, cv, offsets, positions, rows)
            equal((out, out_w))
        else:
            q, kv_len = rw.rope_write(*attention._project(p, a, x), ck, cv, positions, rows,
                                      theta=a.rope_theta, **attention._qk_norms(p, a))
            assert kv_len is None
            equal((q, q_w))
    equal((ck, want_k), (cv, want_v))


def _inputs(meta=False, B=2, S=1, H=4, KVH=2, D=16, slots=2, smax=8):
    kw = dict(device="meta") if meta else {}
    q = torch.zeros((B, S, H, D), dtype=torch.bfloat16, **kw)
    k = torch.zeros((B, S, KVH, D), dtype=torch.bfloat16, **kw)
    ck = torch.zeros((slots, smax, KVH, D), dtype=torch.bfloat16, **kw)
    return dict(q=q, k=k, v=k.clone(), cache_k=ck, cache_v=ck.clone(),
                positions=torch.zeros((B, S), dtype=torch.int64, **kw))


def _with(**change):
    def make():
        sizes = ("B", "S", "H", "KVH", "D", "slots")
        args = _inputs(**{k: v for k, v in change.items() if k in sizes})
        for k, v in change.items():
            if k not in sizes:
                args[k] = v(args) if callable(v) else v
        return args
    return make


REFUSALS = {
    "head_dim 48 not in HEAD_DIMS": _with(D=48),
    "6 heads over 4 KV heads": _with(H=6, KVH=4),
    "k and v of other shapes": _with(v=lambda a: torch.zeros(2, 1, 2, 32, dtype=torch.bfloat16)),
    "a cache of other rows": _with(cache_v=lambda a: torch.zeros(2, 8, 1, 16,
                                                                 dtype=torch.bfloat16)),
    "positions of another shape": _with(positions=torch.zeros(2, dtype=torch.int64)),
    "a decode of two rows a slot": _with(S=2),
    "float positions": _with(positions=torch.zeros(2, 1)),
    "one qk-norm scale": _with(q_norm=torch.ones(16)),
    "an f16 cache": _with(cache_k=lambda a: a["cache_k"].half(),
                          cache_v=lambda a: a["cache_v"].half()),
    "an f32 cache under bf16 activations": _with(cache_k=lambda a: a["cache_k"].float(),
                                                 cache_v=lambda a: a["cache_v"].float()),
    "a decode of fewer rows than slots": _with(slots=3),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_admit_refuses_what_the_kernel_does_not_take(what):
    args = REFUSALS[what]()
    q_norm = args.pop("q_norm", None)
    with pytest.raises((ValueError, TypeError), match="rope_write"):
        rw.admit(**args, q_norm=q_norm)


def test_admit_takes_the_kernels_shapes():
    for D in (16, 32, 64, 80, 128, 256):
        rw.admit(**_inputs(meta=True, D=D))
    rw.admit(**_inputs(meta=True, H=64, KVH=8))
    rw.admit(**_inputs(meta=True, B=1, S=512), rows=torch.zeros(512, dtype=torch.int64,
                                                                device="meta"))
    with pytest.raises(ValueError, match="int64 rows"):
        rw.admit(**_inputs(B=1, S=4), rows=torch.zeros(4, dtype=torch.int32))


def test_meta_tensors_take_the_plain_version():
    before = rw.rope_write.launches
    args = _inputs(meta=True)
    q, kv_len = rw.rope_write(**args, theta=1e4, q_norm=torch.ones(16, device="meta"),
                              k_norm=torch.ones(16, device="meta"))
    assert (q.device.type, q.shape, q.dtype) == ("meta", (2, 1, 4, 16), torch.bfloat16)
    assert kv_len.shape == (2,) and kv_len.dtype == torch.int64
    assert rw.rope_write.launches == before


def test_a_gradient_on_the_card_raises():
    """The kernel writes the caches in place and has no gradient: where one
    is wanted on a CUDA tensor (faked here, so that no card is needed) the
    wrapper raises before any launch, as ``flash_attention`` with offsets
    does; on the CPU autograd runs through the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = {k: torch.zeros(t.shape, dtype=t.dtype, device="cuda")
                for k, t in _inputs().items()}
        args["q"].requires_grad_()
        with pytest.raises(RuntimeError, match="rope_write .* has no gradient"):
            rw.rope_write(**args, theta=1e4)
    args = _inputs()
    args["q"] = torch.randn(args["q"].shape, requires_grad=True)
    args["k"], args["v"] = args["k"].float(), args["v"].float()
    args["cache_k"], args["cache_v"] = args["cache_k"].bfloat16(), args["cache_v"].bfloat16()
    before = rw.rope_write.launches
    q, _ = rw.rope_write(**args, theta=1e4)
    assert q.grad_fn is not None and rw.rope_write.launches == before


@pytest.mark.parametrize("step", ["decode", "ring decode", "chunk"])
def test_a_row_outside_the_cache_is_refused(step):
    """A decode past its cache's last row, or a chunk row past the cache,
    raises in the plain version (the index write's bounds check), where the
    kernel traps (``test_kernel_traps_on_a_row_outside_the_cache``); a
    ring's position past its rows wraps and is written."""
    args = _inputs(B=2, S=1, slots=2, smax=8)
    rows = None
    if step == "chunk":
        args = _inputs(B=1, S=3, slots=2, smax=8)
        rows = torch.tensor([13, 15, 16])
    else:
        args["positions"] = torch.tensor([[3], [8]])
    if step == "ring decode":
        rw.rope_write(**args, theta=1e4, ring=True)
        assert bool((args["cache_k"][1, 0] == 0).all())
        return
    with pytest.raises((IndexError, RuntimeError)):
        rw.rope_write(**args, rows=rows, theta=1e4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "llama3.1-8b"])
def test_dry_run_counts_the_decode_as_before(arch, monkeypatch):
    """The dry run's count of a decode step on ``meta``, which takes the
    plain version, equals its count with the former decode block."""
    cfg = tiny_config(get_config(arch))
    shape = ShapeConfig("tiny", 64, 2, "decode")
    now = dr.count_cell(cfg, shape, RunConfig())[0].stats

    def former(p, a, x, ck, cv, pos, *, kind="causal"):
        return former_decode(p, a, x, ck, cv, pos, kind)[0]
    monkeypatch.setattr(attention, "decode_self_attention", former)
    then = dr.count_cell(cfg, shape, RunConfig())[0].stats
    assert dataclasses.asdict(now) == dataclasses.asdict(then)
    assert now.mxu_flops > 0


# ----------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _bf16_ulps(got, want):
    """Distance in bf16 units in the last place (same sign: the bit
    patterns' difference)."""
    a = got.contiguous().view(torch.int16).int()
    b = want.contiguous().view(torch.int16).int()
    return (a - b).abs()


def close_to_plain(got, want, scale):
    """Elements that differ, and whether each is within one bf16 ulp of its
    head's largest value (bf16) or 1e-6 of it (f32): the kernel sums the
    norm's squares in another order than PyTorch's reduction, so an output
    of the norm may round the other way, and the rotation carries that
    ulp into both values of its pair."""
    diff = (got.float() - want.float()).abs()
    n = int((diff > 0).sum())
    room = scale * (2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-6)
    return n, bool((diff <= room).all())


# (label, rows, H, KVH, D, qk-norm, kind, activations' dtype, cache's dtype, step)
CARD_CASES = [
    ("qwen3 decode", 64, 16, 8, 128, True, "causal", "bfloat16", "bfloat16", "decode"),
    ("qwen3 extend", 512, 16, 8, 128, True, "causal", "bfloat16", "bfloat16", "extend"),
    ("llama3.1 decode", 64, 32, 8, 128, False, "causal", "bfloat16", "bfloat16", "decode"),
    ("gemma-2b decode", 64, 8, 1, 256, False, "causal", "bfloat16", "bfloat16", "decode"),
    ("gemma3 ring decode", 32, 4, 1, 256, True, "local", "bfloat16", "bfloat16", "decode"),
    ("qwen3 decode f32", 64, 16, 8, 128, True, "causal", "float32", "float32", "decode"),
    ("qwen3 extend f32 over bf16", 512, 16, 8, 128, True, "causal", "float32", "bfloat16",
     "extend"),
    ("head_dim 80 extend", 100, 16, 8, 80, True, "causal", "bfloat16", "bfloat16", "extend"),
]


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_the_plain_version_on_the_card(case):
    """q and the written cache rows equal the plain version's, or differ on
    under 0.1 % of elements by at most one bf16 ulp at their head's scale
    (the count is printed); in f32, where no bf16 rounding absorbs the
    norm's other sum order, a whole head may move, each element by at most
    1e-6 of its head's scale; every other cache row is left as it was; the
    decode's lengths are equal."""
    dev = _card()
    label, N, H, KVH, D, qk_norm, kind, dt, cdt, step = case
    g = torch.Generator(device=dev).manual_seed(7)
    smax, slots = (512, N) if step == "decode" else (2049, 4)
    if kind == "local":
        smax = 512
    ty = TDT[dt]
    B, S = (N, 1) if step == "decode" else (1, N)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(ty)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev).to(ty)
    v = torch.randn((B, S, KVH, D), generator=g, device=dev).to(ty)
    ck = torch.randn((slots, smax, KVH, D), generator=g, device=dev).to(TDT[cdt])
    cv = torch.randn((slots, smax, KVH, D), generator=g, device=dev).to(TDT[cdt])
    norms = {}
    if qk_norm:
        norms = {"q_norm": 1 + 0.3 * torch.randn(D, generator=g, device=dev),
                 "k_norm": 1 + 0.3 * torch.randn(D, generator=g, device=dev)}
    rows = None
    if step == "decode":
        top = 3 * smax if kind == "local" else smax - 1
        positions = torch.randint(0, top, (B, 1), generator=g, device=dev)
    else:
        c = N - 37                                 # padded to N rows
        positions, rows = attention.chunk_rows(torch.tensor([2, 900, c], device=dev), N, smax)
    ck_p, cv_p = ck.clone(), cv.clone()
    before = rw.rope_write.launches
    q_k, len_k = rw.rope_write(q, k, v, ck, cv, positions, rows, theta=1e6,
                               ring=kind == "local", **norms)
    q_p, len_p = rw.rope_write_plain(q, k, v, ck_p, cv_p, positions, rows, theta=1e6,
                                     ring=kind == "local", **norms)
    torch.cuda.synchronize()
    assert rw.rope_write.launches == before + 1
    if step == "decode":
        assert torch.equal(len_k, len_p)
    written = torch.zeros(ck.shape[:2], dtype=torch.bool, device=dev)
    if rows is None:
        at = positions[:, 0] % smax if kind == "local" else positions[:, 0]
        written[torch.arange(B, device=dev), at] = True
    else:
        written.view(-1)[rows] = True
    # the padding's rows all go to the trash row, in no set order: not compared
    trash = rows is not None and written.view(-1)[2 * smax + smax - 1]
    compare = written.clone()
    if trash:
        compare.view(-1)[2 * smax + smax - 1] = False
    assert torch.equal(ck[~written], ck_p[~written]) and torch.equal(cv[~written], cv_p[~written])
    assert torch.equal(cv[compare], cv_p[compare])
    counts = {}
    for name, got, want in (("q", q_k, q_p), ("cache_k", ck[compare], ck_p[compare])):
        scale = want.float().abs().amax(dim=-1, keepdim=True)
        n, within = close_to_plain(got, want, scale)
        counts[name] = (n, got.numel())
        assert within, f"{label}: {name} differs from the plain version by more than an ulp"
        if got.dtype == torch.bfloat16:
            assert n <= 1e-3 * got.numel(), f"{label}: {name} differs on {n} of {got.numel()}"
        if not qk_norm:
            assert n == 0, f"{label}: {name} differs without a norm"
    print(f"{label}: elements that differ from the plain version {counts}")


@pytest.mark.card
def test_engine_decode_and_extend_steps_launch_it_once_a_layer():
    """qwen3-1.7b's engine on the card: its captured decode step and every
    extend step hold ``rope_write`` once a layer (28)."""
    dev = _card()
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = get_config("qwen3-1.7b")
    eng = Engine(cfg, ecfg=EngineConfig(max_slots=8, max_len=256), device=dev)
    assert eng.steps["decode"].launches.get("rope_write") == cfg.n_layers == 28
    for name, step in eng.steps.items():
        assert step.launches.get("rope_write") == cfg.n_layers, name
    assert math.isfinite(float(eng._decode([1] * 8, [3] * 8).float().sum()))


# a decode row in its cache, then one past it (position Smax, causal), or a
# chunk row past the last slot: the second launch must stop the process
_TRAP_SCRIPT = """
import sys, torch
from repro_torch.kernels import rope_write as rw
dev = torch.device("cuda")
chunk = sys.argv[1] == "chunk"
S = 3 if chunk else 1
B = 1 if chunk else 2
q = torch.randn((B, S, 4, 64), device=dev).bfloat16()
k = torch.randn((B, S, 2, 64), device=dev).bfloat16()
ck = torch.zeros((2, 8, 2, 64), device=dev).bfloat16()
cv = ck.clone()
pos = torch.tensor([[3, 4, 5]] if chunk else [[3], [7]], device=dev)
rows = torch.tensor([3, 4, 5], device=dev) if chunk else None
rw.rope_write(q, k, k.clone(), ck, cv, pos, rows, theta=1e4)
torch.cuda.synchronize()
print("in range: written", flush=True)
if chunk:
    rows = torch.tensor([14, 15, 16], device=dev)
else:
    pos = torch.tensor([[3], [8]], device=dev)
rw.rope_write(q, k, k.clone(), ck, cv, pos, rows, theta=1e4)
torch.cuda.synchronize()
print("out of range: went on", flush=True)
"""


@pytest.mark.card
@pytest.mark.parametrize("step", ["decode", "chunk"])
def test_kernel_traps_on_a_row_outside_the_cache(step):
    """A row outside the cache stops the kernel with a device error, as the
    eager index write's bounds check stops the plain version: a decode past
    its cache would otherwise attend without its new row. The trap ends the
    process's CUDA context, so it runs in a process of its own."""
    _card()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    run = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, step], capture_output=True,
                         text=True, env=env, timeout=600)
    assert "in range: written" in run.stdout, run.stderr[-2000:]
    assert "out of range: went on" not in run.stdout
    assert run.returncode != 0
