"""The port's vlm family (llama-3.2-vision's grouped stack: self layers and
one tanh-gated cross-attention layer over vision tokens a group) against
the JAX package, on the CPU: ``tiny_config(llama-3.2-vision-90b)`` (10
layers, every 5th a cross layer: 2 groups of 4 self layers and a cross
layer; 4 / 1 heads of 16; 16 vision tokens of width 32), with the JAX
parameters carried across by ``from_jax_params``. Each case runs once with
the cross layers' gates at the reference's init (zeros: tanh(0) hides the
cross attention from the logits) and once with them set to 0.5 in the JAX
tree before the conversion, so that the cross path shows. Covered: the
init tree and the cache, forward, prefill with every cache leaf (``k`` and
``v`` padded to ``max_len``, ``cross_k``, ``cross_v``), decode steps
against the reference's ``decode_step``, ``cross_attention_block`` and
``vlm_precompute_cross_kv`` alone, and the full tree counted without
allocating, at 100 layers and at the 30 that run on one card.

The reference's attention runs as its own smoke tests run it on the CPU
(``attn_impl`` auto: flashref); the port's on the kernels' plain versions.
The reference's init, forward, prefill and decode step are jitted once for
each parameter type.

Tolerances: f32 parameters at 1e-4, as tests/test_torch_model.py; bf16 at
the reference's tolerance for bf16 logits, rtol 0.15 / atol 0.3
(tests/test_models_smoke.py). Every JAX array is made with an explicit
dtype: another test file in the same worker may have turned on jax's x64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params

ARCH = "llama-3.2-vision-90b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def configs(param_dtype):
    return (jax_tiny_config(jax_get_config(ARCH)).with_overrides(param_dtype=param_dtype),
            tiny_config(get_config(ARCH)).with_overrides(param_dtype=param_dtype))


@functools.lru_cache(maxsize=None)
def reference(param_dtype):
    """The reference's model, its parameters, and its entry points jitted."""
    jm = jax_build_model(configs(param_dtype)[0])
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, {"forward": jax.jit(jm.forward),
                    "prefill": jax.jit(jm.prefill, static_argnums=2),
                    "decode_step": jax.jit(jm.decode_step)}


def with_gate(jp, gate: float):
    """The JAX tree with every cross layer's gate set to ``gate``."""
    xattn = dict(jp["stack"]["crosses"]["xattn"])
    xattn["gate"] = jnp.full_like(xattn["gate"], gate)
    crosses = {**jp["stack"]["crosses"], "xattn": xattn}
    return {**jp, "stack": {**jp["stack"], "crosses": crosses}}


def both_models(param_dtype, gate):
    jm, jp, jf = reference(param_dtype)
    jp = with_gate(jp, gate)
    return jm, jp, jf, build_model(configs(param_dtype)[1], device="cpu"), \
        from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def batch(cfg, B, S, seed):
    """Tokens and vision embeddings (f32: the model casts them to its
    parameters' type) as the JAX and the torch batch."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 256, size=(B, S))
    vis = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_vision), dtype=np.float32)
    return ({"tokens": jnp.asarray(t, jnp.int32), "vision": jnp.asarray(vis, jnp.float32)},
            {"tokens": torch.from_numpy(t), "vision": torch.from_numpy(vis)})


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}."))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


DTYPES = ("float32", "bfloat16")
CASES = [pytest.param(d, g, id=f"{d}-gate{g}") for d in DTYPES for g in (0.0, 0.5)]


def test_tiny_config_is_the_references():
    """10 layers, every 5th a cross layer (2 groups of 4 self layers), 16
    vision tokens of width 32, as the reference's tiny_config has them."""
    jcfg, cfg = configs("float32")
    for c in (jcfg, cfg):
        assert (c.n_layers, c.cross_attn_every, c.n_vision_tokens, c.d_vision) == (10, 5, 16, 32)
    assert tfm.vlm_split(cfg) == (2, 4)
    assert (cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim) == \
        (jcfg.attn.n_heads, jcfg.attn.n_kv_heads, jcfg.attn.head_dim) == (4, 1, 16)


@pytest.mark.parametrize("param_dtype", DTYPES)
def test_init_tree_and_cache_match_the_reference(param_dtype):
    """``selfs`` (g, n_self, ...), ``crosses`` (g, ...) with an f32 gate of
    zeros, and the cache's four leaves: the reference's shapes and types."""
    jm, jp, _ = reference(param_dtype)
    m = build_model(configs(param_dtype)[1], device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert shapes(p) == shapes(jp)
    gate = p["stack"]["crosses"]["xattn"]["gate"]
    assert gate.dtype == torch.float32 and gate.shape == (2,) and not gate.any()
    assert shapes(m.init_cache(3, 40)) == shapes(jm.init_cache(3, 40))


def run_both(jf, jp, m, p, tol, S, n_dec, max_len, seed):
    """Prefill S tokens of a prompt of S + n_dec beside the vision tokens,
    then decode the rest one token at a time; every logit and every cache
    leaf against the reference's (the bf16 caches at the bf16 tolerance),
    and each decode step's logits against the full forward at its
    position."""
    jb, tb = batch(m.cfg, 2, S + n_dec, seed)
    want_full, _ = jf["forward"](jp, jb)
    close(m.forward(p, tb), want_full, **tol)
    jl, jc = jf["prefill"](jp, {**jb, "tokens": jb["tokens"][:, :S]}, max_len)
    logits, cache = m.prefill(p, {**tb, "tokens": tb["tokens"][:, :S]}, max_len)
    close(logits, jl, **tol)
    assert shapes(cache) == shapes(jc)
    assert cache["k"].shape[3] == max_len

    def caches_close():
        for name in ("k", "v", "cross_k", "cross_v"):
            close(cache[name], jc[name], **tol)

    caches_close()
    for i in range(n_dec):
        pos = S + i
        jl, jc = jf["decode_step"](jp, jb["tokens"][:, pos:pos + 1], jc, jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(p, tb["tokens"][:, pos:pos + 1], cache, pos)
        close(logits, jl, **tol)
        close(logits[:, 0], want_full[:, pos], **TOL["bfloat16"])
    caches_close()


@pytest.mark.parametrize("param_dtype,gate", CASES)
def test_forward_prefill_decode_match_the_reference(param_dtype, gate):
    _, jp, jf, m, p = both_models(param_dtype, gate)
    run_both(jf, jp, m, p, TOL[param_dtype], S=9, n_dec=4, max_len=16, seed=1)


@pytest.mark.parametrize("param_dtype", DTYPES)
def test_cross_attention_block_matches_the_reference(param_dtype):
    """One cross layer's block alone: 7 text positions over the 16 vision
    tokens, no RoPE, bidirectional, the output scaled by tanh(gate): zero
    on both sides at the init's gate, the reference's at 0.5, and not zero
    there. Given the vision tokens' k and v projections already made (as
    the prefill passes them), the block gives the same values bit for bit."""
    jm, jp, _ = reference(param_dtype)
    cfg = configs(param_dtype)[1]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    vis = rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_vision), dtype=np.float32)
    jx, jv = jnp.asarray(x, JDT[param_dtype]), jnp.asarray(vis, JDT[param_dtype])
    tx, tv = (torch.from_numpy(a).to(getattr(torch, param_dtype)) for a in (x, vis))
    for gate in (0.0, 0.5):
        jxp = jax.tree.map(lambda u: u[1], with_gate(jp, gate)["stack"]["crosses"]["xattn"])
        txp = from_jax_params(jax.tree.map(np.asarray, jxp), device="cpu")
        want = jattn.cross_attention_block(jxp, jm.cfg.attn, jx, jv)
        got = attn.cross_attention_block(txp, cfg.attn, tx, tv)
        assert got.dtype == getattr(torch, param_dtype) and got.shape == (2, 7, cfg.d_model)
        close(got, want, **TOL[param_dtype])
        assert bool(got.any()) == (gate != 0.0)
        a = cfg.attn
        kv = tuple((tv @ txp[w]).reshape(2, cfg.n_vision_tokens, a.n_kv_heads, a.head_dim)
                   for w in ("wk", "wv"))
        assert torch.equal(attn.cross_attention_block(txp, a, tx, tv, kv), got)


@pytest.mark.parametrize("param_dtype", DTYPES)
def test_precompute_cross_kv_matches_the_reference(param_dtype):
    """The vision tokens through every cross layer's k and v once: (g, B,
    T, KVH, D), the reference's values."""
    jm, jp, _ = reference(param_dtype)
    cfg = configs(param_dtype)[1]
    jb, tb = batch(cfg, 3, 1, seed=4)
    want = jtfm.vlm_precompute_cross_kv(jp["stack"], jm.cfg, jb["vision"].astype(JDT[param_dtype]))
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    got = tfm.vlm_precompute_cross_kv(p["stack"], cfg, tb["vision"].to(getattr(torch, param_dtype)))
    for g, w in zip(got, want):
        assert g.shape == (2, 3, cfg.n_vision_tokens, cfg.attn.n_kv_heads, cfg.attn.head_dim)
        close(g, w, **TOL[param_dtype])


@pytest.mark.parametrize("n_layers,want", [(100, 87_383_678_996), (30, 27_686_051_846)])
def test_full_tree_counts_as_the_reference(n_layers, want):
    """The whole config (20 groups) and the 30 layers (6 groups) that run on
    one card: the tree and its parameter count as the reference's,
    reckoned from shapes without allocating."""
    cfg = get_config(ARCH).with_overrides(n_layers=n_layers)
    jcfg = jax_get_config(ARCH).with_overrides(n_layers=n_layers)
    assert tfm.vlm_split(cfg) == (n_layers // 5, 4)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    with FakeTensorMode():
        p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        assert shapes(p) == shapes(jshapes)
        assert sum(t.numel() for t in leaves(p)) == count == want
