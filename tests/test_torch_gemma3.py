"""The port's local:global stack (gemma3) against the JAX package, on the
CPU: ``tiny_config(gemma3-1b)`` (4 / 1 heads of 16) and
``tiny_config(gemma3-4b)`` (4 / 2) with window 8 and five local layers to a
global one, at 2 layers (no group: two local layers in the tail), 8 (one
group and a tail of 2) and 12 (two groups, no tail), with the JAX
parameters carried across by ``from_jax_params``: the init tree, forward,
prefill with every cache leaf (the local rings in their slot order) for
prompts shorter and longer than the window, and decode steps that run past
the window, so that the rings wrap. The full trees of both configs are
counted without allocating. The reference's attention runs as its own
smoke tests run it on the CPU (``attn_impl`` auto: flashref); the port's
on the kernels' plain versions. The reference's init, forward, prefill
and decode step are jitted, once for each config (its decode step compiles
once for every cache shape instead of at every call).

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
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
ARCHS = ("gemma3-1b", "gemma3-4b")
SPLITS = {2: (0, 2), 8: (1, 2), 12: (2, 0)}     # n_layers: (groups, tail)


def close(got: torch.Tensor, want, **tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def configs(arch, param_dtype, n_layers):
    kw = dict(param_dtype=param_dtype, n_layers=n_layers)
    return (jax_tiny_config(jax_get_config(arch)).with_overrides(**kw),
            tiny_config(get_config(arch)).with_overrides(**kw))


@functools.lru_cache(maxsize=None)
def reference(arch, param_dtype, n_layers):
    """The reference's model, its parameters, and its entry points jitted."""
    jm = jax_build_model(configs(arch, param_dtype, n_layers)[0])
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, {"forward": jax.jit(jm.forward),
                    "prefill": jax.jit(jm.prefill, static_argnums=2),
                    "decode_step": jax.jit(jm.decode_step)}


def both_models(arch, param_dtype, n_layers):
    jm, jp, jf = reference(arch, param_dtype, n_layers)
    return jm, jp, jf, build_model(configs(arch, param_dtype, n_layers)[1], device="cpu"), \
        from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def tokens(shape, seed=0):
    t = np.random.default_rng(seed).integers(1, 256, size=shape)
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}."))
        return out
    if tree is None:
        return {prefix: None}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif tree is not None:
        yield tree


CASES = [pytest.param(arch, d, n, id=f"{arch}-{d}-L{n}")
         for arch in ARCHS for d in ("float32", "bfloat16") for n in SPLITS]


@pytest.mark.parametrize("arch,param_dtype,n_layers", CASES)
def test_init_tree_and_caches_match_the_reference(arch, param_dtype, n_layers):
    """The parameter tree and both caches' shapes: the groups and tail of
    ``lg_split``, empty ``(0, ...)`` stacks where no group fits, a ``None``
    tail where the layers divide into groups, and the local rings of
    ``min(window, max_len)`` rows."""
    jm, jp, _, m, _ = both_models(arch, param_dtype, n_layers)
    assert tfm.lg_split(m.cfg) == jtfm.lg_split(jm.cfg) == SPLITS[n_layers]
    p = m.init(torch.Generator().manual_seed(0))
    assert shapes(p) == shapes(jp)
    assert (p["stack"]["tail"] is None) == (SPLITS[n_layers][1] == 0)
    assert sum(t.numel() for t in leaves(p)) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    for max_len in (40, 6):                 # past the window, and inside it
        assert shapes(m.init_cache(3, max_len)) == shapes(jm.init_cache(3, max_len))


def run_both(jf, jp, m, p, tol, S, n_dec, max_len, seed):
    """Prefill S tokens of a prompt of S + n_dec, then decode the rest one
    token at a time (positions S .. S + n_dec - 1); every logit and, for
    f32 parameters, every cache leaf against the reference's, and each
    decode step's logits against the full forward at its position."""
    jt, tt = tokens((2, S + n_dec), seed)
    want_full, _ = jf["forward"](jp, {"tokens": jt})
    close(m.forward(p, {"tokens": tt}), want_full, **tol)
    jl, jc = jf["prefill"](jp, {"tokens": jt[:, :S]}, max_len)
    logits, cache = m.prefill(p, {"tokens": tt[:, :S]}, max_len)
    close(logits, jl, **tol)
    assert shapes(cache) == shapes(jc)          # the keys keep their type

    def caches_close():
        if tol is TOL["float32"]:
            for name in jc:
                close(cache[name], jc[name], **tol)

    caches_close()
    for i in range(n_dec):
        pos = S + i
        jl, jc = jf["decode_step"](jp, jt[:, pos:pos + 1], jc, jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(p, tt[:, pos:pos + 1], cache, pos)
        close(logits, jl, **tol)
        close(logits[:, 0], want_full[:, pos], **TOL["bfloat16"])
    caches_close()


@pytest.mark.parametrize("arch,param_dtype,n_layers", CASES)
def test_forward_prefill_decode_match_the_reference(arch, param_dtype, n_layers):
    """A prompt longer than the window (13 > 8: the rings hold the last 8
    positions in slot order) and one shorter (5: zero rows past it), each
    decoded past the window so that the local rings wrap (twice, for the
    short one)."""
    _, jp, jf, m, p = both_models(arch, param_dtype, n_layers)
    tol = TOL[param_dtype]
    run_both(jf, jp, m, p, tol, S=13, n_dec=6, max_len=24, seed=1)
    run_both(jf, jp, m, p, tol, S=5, n_dec=14, max_len=24, seed=2)


def test_ring_slots_are_the_references():
    """``to_ring`` puts position p at slot p % W: the reference's ring
    placement in ``lg_stack_fwd``, for S past, at and below W."""
    W = 8
    for S in (13, 16, 8, 5):
        u = torch.arange(2 * S * 3, dtype=torch.float32).reshape(2, S, 1, 3)
        ring = tfm.to_ring(u, W)
        assert ring.shape == (2, W, 1, 3)
        for p in range(max(0, S - W), S):
            assert torch.equal(ring[:, p % W], u[:, p])
        if S < W:
            assert not ring[:, S:].any()


@pytest.mark.parametrize("arch,want", [("gemma3-1b", 999_812_736),
                                       ("gemma3-4b", 3_879_907_840)])
def test_full_config_splits_and_counts_as_the_reference(arch, want):
    """gemma3-1b: 4 groups of (5 local + 1 global) and a tail of 2;
    gemma3-4b: 5 groups and a tail of 4; the tree and its parameter count
    as the reference's, reckoned from shapes without allocating."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert tfm.lg_split(cfg) == jtfm.lg_split(jcfg) == {"gemma3-1b": (4, 2),
                                                        "gemma3-4b": (5, 4)}[arch]
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    with FakeTensorMode():
        p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        assert shapes(p) == shapes(jshapes)
        assert sum(t.numel() for t in leaves(p)) == count == want
