"""The step bodies that the port captures into CUDA graphs, on the CPU.

On the card the engine replays its decode step and one extend step for
each chunk bucket, and the torch solver one step for each (bucket, K,
device model), from CUDA graphs over static buffers
(``repro_torch.graphs``); on the CPU the same bodies run directly. These
tests hold those bodies against the reference at the tiny config in f32:
the padded extend with slot, pos0 and the chunk's length read from a
device buffer against the JAX engine's jitted extend (f32 tolerance 2e-5
on the logits), the padding's cache writes, a chunk whose bucket reaches
past the cache, the plain attention with device offsets against its
integer-offset call, the bucket function, and the solver step fed from its
static buffer against the NumPy oracle at 1e-9.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))

import repro_torch.core as tc  # noqa: E402
from bench_planner import random_profile  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import tiny_config as jax_tiny_config  # noqa: E402
from repro.core import DEVICES as JAX_DEVICES  # noqa: E402
from repro.core import H100 as JAX_H100  # noqa: E402
from repro.core.profile import ProfileMatrix as JaxProfileMatrix  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.configs.registry import get_config, tiny_config  # noqa: E402
from repro_torch.core import H100  # noqa: E402
from repro_torch.core import estimator_torch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from repro_torch.serve.engine import chunk_bucket  # noqa: E402

CFG = tiny_config(get_config("qwen3-1.7b")).with_overrides(param_dtype="float32")
MAX_LEN = 160
PM_FIELDS = ("names", "demand", "duration", "cache_working_set",
             "cache_hit_fraction", "slots_needed")
F32_TOL = 2e-5


def both_engines(max_slots=3):
    """The JAX engine (reference attention) and the port's on the CPU, on
    the same converted f32 weights, each over an f32 cache: over the
    engines' bf16 cache a difference in the last bit of a key (a product
    of one row against one of sixteen, say) can round it to another bf16
    value, which the f32 tolerance cannot hold, so the steps are compared
    in f32 throughout, as tests/test_torch_model.py compares extend."""
    jcfg = jax_tiny_config(jax_get_config("qwen3-1.7b")).with_overrides(
        param_dtype="float32", attn_impl="reference")
    kw = dict(max_slots=max_slots, max_len=MAX_LEN, prefill_chunk=32)
    jeng = JaxEngine(jcfg, ecfg=JaxEngineConfig(**kw), dev=JAX_H100,
                     key=jax.random.PRNGKey(0))
    jeng.cache = jax.tree.map(lambda a: a.astype(jnp.float32), jeng.cache)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), device="cpu")
    eng = Engine(CFG, params=params, ecfg=EngineConfig(**kw), dev=H100, device="cpu")
    for name in ("k", "v"):            # the steps read the engine's cache dict
        eng.cache[name] = eng.cache[name].float()
    return jeng, eng


@pytest.mark.parametrize("c", [1, 17, 100])
def test_padded_extend_with_device_offsets_matches_the_jax_engine(c):
    """A prefix of 30 tokens in slot 2, then a chunk of c tokens at pos0 =
    30, padded to its bucket: the last real position's logits equal the
    JAX engine's extend of the same unpadded chunk, and so do the keys and
    values in the cache."""
    jeng, eng = both_engines()
    tokens = np.random.default_rng(c).integers(1, CFG.vocab_size, size=30 + c)
    slot, pos0 = 2, 30
    for start, n in ((0, pos0), (pos0, c)):
        chunk = tokens[start:start + n]
        want, jeng.cache = jeng._extend(jeng.params, jnp.asarray(chunk[None], jnp.int32),
                                        jeng.cache, slot, start)
        got = eng._extend(chunk, slot, start)
    assert chunk_bucket(c) > c or c == 16
    assert got.shape == (1, 1, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    for name in ("k", "v"):      # every row but the trash position
        np.testing.assert_allclose(eng.cache[name][:, slot, :MAX_LEN].numpy(),
                                   np.asarray(jeng.cache[name][:, slot, :MAX_LEN]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("pos0,c", [(40, 17), (100, 50)])
def test_padding_writes_only_the_trash_position(pos0, c):
    """The chunk writes rows pos0 .. pos0 + c - 1 of its slot; the padding
    up to the bucket goes to the slot's trash position (max_len), even where
    pos0 + bucket reaches past the cache's 161 rows (100 + 64); every other
    row of the slot and every other slot stay as they were."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=3, max_len=MAX_LEN), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        eng.cache[name].copy_(torch.randn(eng.cache[name].shape, generator=gen))
    before = {name: t.clone() for name, t in eng.cache.items()}
    slot = 1
    eng._extend(np.arange(1, c + 1), slot, pos0)
    for name, t in eng.cache.items():
        was = before[name]
        others = [b for b in range(3) if b != slot]
        assert torch.equal(t[:, others], was[:, others]), name
        assert torch.equal(t[:, slot, :pos0], was[:, slot, :pos0]), name
        assert not torch.equal(t[:, slot, pos0:pos0 + c], was[:, slot, pos0:pos0 + c]), name
        assert torch.equal(t[:, slot, pos0 + c:MAX_LEN], was[:, slot, pos0 + c:MAX_LEN]), name
        assert not torch.equal(t[:, slot, MAX_LEN], was[:, slot, MAX_LEN]), name


def test_a_last_chunk_whose_bucket_crosses_the_capacity_serves(monkeypatch):
    """fixed_chunk of 100 over a 150-token prompt: its last chunk, 50 tokens
    at position 100, runs at the 64-row bucket, 164 rows past a cache of
    161; the tokens are those of greedy full-forward generation."""
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=MAX_LEN, prefill_chunk=100,
                                        mode="fixed_chunk"), device="cpu")
    prompt = np.random.default_rng(3).integers(1, CFG.vocab_size, size=150).tolist()
    i = eng.submit(prompt, max_new=6)
    out = eng.run_until_done()[i]["output"]
    chunks = [e.detail["chunk"] for e in eng.events if e.kind == "prefill_chunk"]
    assert chunks == [100, 50] and 100 + chunk_bucket(50) > MAX_LEN + 1
    monkeypatch.setattr(attn, "run_attention",
                        lambda q, k, v, *, kind, window, softcap:
                        attn.reference_attention(q, k, v, kind, window))
    model = build_model(CFG, device="cpu")
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            logits = model.forward(eng.params, {"tokens": torch.tensor([toks])})
            toks.append(int(torch.argmax(logits[0, -1])))
    assert out == toks[len(prompt):]


@pytest.mark.parametrize("slot,pos0,c,rows,kv_dtype", [
    (0, 0, 16, 16, torch.float32),
    (1, 37, 23, 32, torch.float32),
    (2, 60, 1, 16, torch.float32),
    (1, 100, 50, 64, torch.bfloat16),     # the bucket reaches past the cache
])
def test_plain_attention_with_device_offsets_is_the_integer_offset_call(
        slot, pos0, c, rows, kv_dtype):
    """Rows slot.. of the whole cache, pos0 and c read from a tensor: the
    c real queries' outputs equal the integer-offset call over the slot's
    first pos0 + c keys; the padded queries' outputs are finite."""
    rng = np.random.default_rng(slot * 1000 + pos0)
    H, KVH, D, smax = 4, 2, 16, 161
    q = torch.from_numpy(rng.standard_normal((1, rows, H, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((3, smax, KVH, D), dtype=np.float32)).to(kv_dtype)
    v = torch.from_numpy(rng.standard_normal((3, smax, KVH, D), dtype=np.float32)).to(kv_dtype)
    got = flash_attention_plain(q, k, v, "causal", offsets=torch.tensor([slot, pos0, c]))
    want = flash_attention_plain(q[:, :c], k[slot:slot + 1, :pos0 + c],
                                 v[slot:slot + 1, :pos0 + c], "causal", q_offset=pos0)
    assert got.shape == q.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, :c].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_chunk_buckets_and_the_engine_s_steps():
    assert [chunk_bucket(c) for c in (1, 15, 16, 17, 100, 128, 129, 768, 1024)] == \
        [16, 16, 16, 32, 128, 128, 256, 1024, 1024]
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=1024), device="cpu")
    assert list(eng.steps) == ["decode", 16, 32, 64, 128, 256, 512, 1024]
    eng = Engine(CFG, ecfg=EngineConfig(max_slots=2, max_len=96), device="cpu")
    assert list(eng.steps) == ["decode", 16, 32, 64, 128]
    # on the CPU nothing is captured: every call runs the body
    assert all(s.graph is None for s in eng.steps.values())
    eng.submit([1, 2, 3], max_new=2)
    eng.run_until_done()
    assert eng.steps[16].calls == 1 and eng.steps["decode"].calls == 1


def test_capture_refuses_a_device_that_is_neither_cpu_nor_cuda():
    step = graphs.capture(lambda: 7, "cpu", "seven")
    assert step() == 7 and step() == 7 and step.calls == 2 and step.launches == {}
    with pytest.raises(ValueError, match="unsupported device"):
        graphs.capture(lambda: 7, "meta", "seven")


def test_solver_step_fed_from_its_static_buffer_equals_numpy():
    """Two batches of the same bucket, one after the other, through the one
    step of (128, 3, H100): each result equals the NumPy oracle at 1e-9
    (the second proves the static buffer was rewritten)."""
    rng = np.random.default_rng(42)
    jdev = JAX_DEVICES["h100_nvl"]
    pool = [random_profile(rng, f"k{i}", jdev, zero_axes=(i % 3 == 0),
                           smem_heavy=(i % 5 == 0), cache_heavy=(i % 4 == 0))
            for i in range(30)]
    jpm = JaxProfileMatrix.from_profiles(pool)
    pm = tc.ProfileMatrix(**{f: getattr(jpm, f) for f in PM_FIELDS})
    calls = None
    for S in (100, 77):
        idx = rng.integers(0, len(pool), (S, 3))
        with tc.solver_backend("numpy"):
            want = tc.solve_batch(pm, idx, H100)
        with tc.solver_backend("torch", device="cpu"):
            got = tc.solve_batch(pm, idx, H100)
        step = estimator_torch._step(128, 3, H100, torch.device("cpu"))[1]
        assert step.graph is None
        calls = step.calls if calls is None else (calls, step.calls)
        np.testing.assert_array_equal(got.bottleneck, want.bottleneck)
        np.testing.assert_array_equal(got.feasible_slots, want.feasible_slots)
        for field in ("speeds", "slowdowns", "axis_load"):
            a, b = getattr(want, field), getattr(got, field)
            fin = np.isfinite(a)
            np.testing.assert_array_equal(fin, np.isfinite(b))
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-9, atol=1e-9, err_msg=field)
    assert calls[1] == calls[0] + 1
