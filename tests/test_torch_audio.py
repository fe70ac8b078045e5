"""The port's audio family (hubert-xlarge: an encoder of bidirectional
layers over precomputed frame embeddings, no token lookup on the way in and
no cache) against the JAX package, on the CPU, and ``flash_attention``'s
plain version at head_dim 80, hubert's, against the Pallas kernel.

``tiny_config(hubert-xlarge)`` (2 layers, 4 / 4 heads of 16) and the same
at head_dim 80, with the JAX parameters carried across by
``from_jax_params``; the reference's attention runs as its own smoke tests
run it on the CPU (``attn_impl`` auto: flashref), its forward jitted once a
config. The Pallas kernel runs in interpret mode, as tests/test_kernels.py
runs it. Tolerances: f32 parameters at 1e-4 and bf16 at rtol 0.15 / atol
0.3 (tests/test_models_smoke.py); the kernel at 2e-5 in f32 and 2e-2 in
bf16 (tests/test_kernels.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params

ARCH = "hubert-xlarge"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def configs(param_dtype, head_dim=0):
    """The tiny config on both sides, with ``head_dim`` overridden where
    given."""
    out = []
    for c in (jax_tiny_config(jax_get_config(ARCH)), tiny_config(get_config(ARCH))):
        kw = dict(param_dtype=param_dtype)
        if head_dim:
            kw["attn"] = dataclasses.replace(c.attn, head_dim=head_dim)
        out.append(c.with_overrides(**kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def reference(param_dtype, head_dim=0):
    jm = jax_build_model(configs(param_dtype, head_dim)[0])
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, jax.jit(jm.forward)


def frames(cfg, B, S, seed):
    a = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return {"frames": jnp.asarray(a, jnp.float32)}, {"frames": torch.from_numpy(a)}


def test_tiny_config_is_a_bidirectional_encoder():
    jcfg, cfg = configs("float32")
    assert cfg.family == jcfg.family == "audio" and cfg.is_encoder and jcfg.is_encoder
    assert tfm._kind_for(cfg) == jtfm._kind_for(jcfg) == "bidirectional"
    assert (cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim) == (4, 4, 16)


@pytest.mark.parametrize("param_dtype,head_dim", [
    pytest.param(d, h, id=f"{d}-D{h or 16}") for d in ("float32", "bfloat16") for h in (0, 80)])
def test_forward_matches_the_reference(param_dtype, head_dim):
    """Frames in (cast to the parameters' type, no lookup), logits over the
    504 units out, at head_dim 16 and at hubert's 80."""
    jm, jp, jforward = reference(param_dtype, head_dim)
    m = build_model(configs(param_dtype, head_dim)[1], device="cpu")
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = frames(m.cfg, 2, 11, seed=1)
    want, _ = jforward(jp, jb)
    got = m.forward(p, tb)
    assert got.shape == (2, 11, m.cfg.vocab_size) and got.dtype == torch.float32
    close(got, want, **TOL[param_dtype])


@pytest.mark.parametrize("entry", ["prefill", "decode_step", "init_cache"])
def test_encoder_refuses_prefill_decode_and_cache(entry):
    """An encoder has no cache: the three entry points raise ValueError with
    the reference's words (its decode_step raises on the family)."""
    jm, jp, _ = reference("float32")
    m = build_model(configs("float32")[1], device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    jb, tb = frames(m.cfg, 2, 5, seed=2)
    calls = {"prefill": (lambda: jm.prefill(jp, jb, 8), lambda: m.prefill(p, tb, 8)),
             "decode_step": (lambda: jm.decode_step(jp, jnp.ones((2, 1), jnp.int32), {}, 5),
                             lambda: m.decode_step(p, torch.ones(2, 1, dtype=torch.long), {}, 5)),
             "init_cache": (lambda: jm.init_cache(2, 8), lambda: m.init_cache(2, 8))}[entry]
    words = {"prefill": "encoder-only model has no prefill/decode",
             "decode_step": "encoder-only model has no prefill/decode",
             "init_cache": r"audio has no decode cache \(encoder-only\?\)"}[entry]
    with pytest.raises(ValueError, match=None if entry == "decode_step" else words):
        calls[0]()
    with pytest.raises(ValueError, match=words):
        calls[1]()


def test_full_tree_counts_as_the_reference():
    """48 layers at full width: 945,132,800 parameters on both sides (the
    unused token embedding included, as the reference keeps it)."""
    jshapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init, jax.random.PRNGKey(0))
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    with FakeTensorMode():
        p = build_model(get_config(ARCH), device="cpu").init(torch.Generator().manual_seed(0))
        leaves = jax.tree.leaves(p)
        assert [tuple(t.shape) for t in leaves] == [a.shape for a in jax.tree.leaves(jshapes)]
        assert sum(t.numel() for t in leaves) == count == 945_132_800


@pytest.mark.parametrize("S,T,g,kind,dtype", [
    (128, 128, 1, "bidirectional", "float32"),
    (200, 200, 2, "causal", "float32"),          # non-multiple of the blocks
    (128, 384, 2, "bidirectional", "bfloat16"),
    (256, 256, 1, "causal", "bfloat16"),
])
def test_flash_attention_plain_at_head_dim_80_matches_pallas(S, T, g, kind, dtype):
    """The kernel's plain version at head_dim 80, one and two query heads a
    KV head, in the model layout (strided views of the kernel-test layout),
    against the Pallas kernel that is written for that size."""
    BKV, D = 2, 80
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((BKV * g, S, D), (BKV, T, D), (BKV, T, D)))
    want = flash_attention_bhsd(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), kind=kind,
                                block_q=128, block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    got = fa_mod.flash_attention(tq.view(BKV, g, S, D).permute(0, 2, 1, 3),
                                 tk[:, :, None], tv[:, :, None], kind)
    got = got.permute(0, 2, 1, 3).reshape(BKV * g, S, D)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    close(got, want, rtol=tol, atol=tol)


def test_head_dim_80_is_built_and_planned():
    """flash_attention is built for head_dim 80 in both bodies (f32 queries
    are refused only above 128). hubert's shape fills the card without a split of the keys; one
    sequence of it is split, and a forced split covers the keys."""
    assert 80 in fa_mod.HEAD_DIMS
    assert fa_mod.split_plan(4, 1024, 16, 1024, torch.bfloat16)["kv_splits"] == 1
    assert fa_mod.split_plan(1, 1024, 16, 1024, torch.bfloat16)["kv_splits"] > 1
    plan = fa_mod.split_plan(4, 1024, 16, 1024, torch.bfloat16, kv_splits=2)
    assert plan["kv_splits"] == 2 and plan["chunk"] == 512
    assert fa_mod.split_plan(2, 160, 4, 160, torch.float32)["body"] == "fma_f32"
