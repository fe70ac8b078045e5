"""The port's dense decoder against the JAX model, on the CPU, with the
JAX parameters carried across by ``from_jax_params``.

f32 parameters (``param_dtype="float32"``) are held to 1e-4: the two sides
differ by the order of f32 sums and by the bf16 rounding of the softmax
weights over the bf16 KV cache. bf16 parameters are held to the reference's
own loose tolerance for bf16 logits (rtol 0.15 / atol 0.3,
tests/test_models_smoke.py), because the two frameworks round to bf16 at
different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.moe import LOCAL_CTX
from repro_torch.configs.registry import get_config, list_archs, tiny_config
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}


def close(got: torch.Tensor, want, **tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def both_models(param_dtype):
    jcfg = jax_tiny_config(jax_get_config("qwen3-1.7b")).with_overrides(
        param_dtype=param_dtype, attn_impl="reference")
    cfg = tiny_config(get_config("qwen3-1.7b")).with_overrides(param_dtype=param_dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(cfg, device="cpu"), p


def tokens(shape, seed=0):
    t = np.random.default_rng(seed).integers(1, 256, size=shape)
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


# ----------------------------- the layers ----------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    a = np.random.default_rng(0).standard_normal((2, 7, 4, 16), dtype=np.float32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]])
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jlayers.apply_rope(jnp.asarray(a, jd), jnp.asarray(pos, jnp.int32), 1e6)
    got = layers.apply_rope(torch.from_numpy(a).to(td), torch.from_numpy(pos), 1e6)
    assert got.dtype == td
    # f32: cos/sin of the two libraries differ in the last bits; bf16: one ulp
    close(got, want, rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        close(got, want, rtol=2e-2, atol=2e-2)


def test_l2norm():
    a = np.random.default_rng(1).standard_normal((2, 5, 4, 16), dtype=np.float32)
    close(layers.l2norm(torch.from_numpy(a)), jlayers.l2norm(jnp.asarray(a, jnp.float32)),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    w = {"w_up": rng.standard_normal((32, 48), dtype=np.float32) / 6,
         "w_gate": rng.standard_normal((32, 48), dtype=np.float32) / 6,
         "w_down": rng.standard_normal((48, 32), dtype=np.float32) / 7}
    want = jlayers.mlp({k: jnp.asarray(v, jnp.float32) for k, v in w.items()},
                       jnp.asarray(x, jnp.float32), act)
    got = layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                     torch.from_numpy(x), act)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_gives_f32_logits(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32), dtype=np.float32)
    e = rng.standard_normal((50, 32), dtype=np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jlayers.unembed({"embedding": jnp.asarray(e, jd)}, jnp.asarray(x, jd))
    got = layers.unembed({"embedding": torch.from_numpy(e).to(td)},
                         torch.from_numpy(x).to(td))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # both sides accumulate exact products of the same operands in f32
    close(got, want, rtol=1e-5, atol=1e-5)


def test_embed_scales_by_dim():
    rng = np.random.default_rng(4)
    e = rng.standard_normal((20, 16), dtype=np.float32)
    tok = rng.integers(0, 20, size=(2, 5))
    want = jlayers.embed({"embedding": jnp.asarray(e, jnp.float32)},
                         jnp.asarray(tok, jnp.int32), scale_by_dim=True)
    got = layers.embed({"embedding": torch.from_numpy(e)}, torch.from_numpy(tok),
                       scale_by_dim=True)
    close(got, want, rtol=1e-6, atol=1e-6)


def test_embed_scale_is_a_host_number_rounded_as_the_reference_rounds_it():
    """ROADMAP C20: the scale is the reference's, rounded to the embedding's
    dtype (bf16 bit for bit at d_model 2,048, gemma-2b's), and no tensor is
    made on the embedding's device for it: a CUDA graph capture refuses the
    host copy that makes one (the engine's captured steps of gemma-2b). On
    ``meta``, the card's stand-in here, no op of ``embed`` reads a scalar
    tensor on that device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    rng = np.random.default_rng(5)
    e = rng.standard_normal((20, 2048), dtype=np.float32)
    tok = rng.integers(0, 20, size=(2, 5))
    want = jlayers.embed({"embedding": jnp.asarray(e, jnp.bfloat16)},
                         jnp.asarray(tok, jnp.int32), scale_by_dim=True)
    got = layers.embed({"embedding": torch.from_numpy(e).bfloat16()}, torch.from_numpy(tok),
                       scale_by_dim=True)
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    class Scalars(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.on_device = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.on_device += [str(func) for a in args if isinstance(a, torch.Tensor)
                               and a.device.type == "meta" and a.dim() == 0]
            return func(*args, **(kwargs or {}))

    emb = {"embedding": torch.empty((20, 2048), dtype=torch.bfloat16, device="meta")}
    with Scalars() as seen:
        out = layers.embed(emb, torch.zeros((2, 5), dtype=torch.int64, device="meta"),
                           scale_by_dim=True)
    assert out.shape == (2, 5, 2048) and seen.on_device == []


# ------------------------- weights carried across ---------------------- #
def test_from_jax_params_keeps_the_tree():
    jm, jp, m, p = both_models("bfloat16")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    seen = 0
    for path, leaf in flat_j:
        node = p
        for k in path:
            node = node[k.key]
        want = np.asarray(leaf)
        assert tuple(node.shape) == want.shape, path
        assert str(node.dtype).endswith(str(want.dtype)), path
        np.testing.assert_array_equal(node.float().numpy(), want.astype(np.float32))
        seen += 1
    assert seen == sum(1 for _ in _leaves(p))
    assert p["stack"]["attn"]["wq"].shape[0] == m.cfg.n_layers
    # the same bf16 leaves handed over as raw uint16 bits
    bits = jax.tree.map(lambda a: np.asarray(a).view(np.uint16)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), jp)
    p2 = from_jax_params(bits, device="cpu", bf16_as_uint16=True)
    for a, b in zip(_leaves(p), _leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_from_jax_params_carries_a_none_leaf():
    """The hybrid stack's ``tail`` is None when the layers divide into whole
    groups (tiny zamba2: 12 layers in groups of 6): it stays None, beside
    the converted leaves."""
    jcfg = jax_tiny_config(jax_get_config("zamba2-1.2b"))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert jp["stack"]["tail"] is None
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    assert p["stack"]["tail"] is None
    assert from_jax_params({"a": None, "b": np.ones(2, np.float32)}, device="cpu")["a"] is None
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(list(_leaves(p))) == len(flat_j) + 1          # + the None
    for path, leaf in flat_j:
        node = p
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.float().numpy(), np.asarray(leaf, np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_init_has_the_reference_tree_shape():
    jm, jp, m, _ = both_models("bfloat16")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p = m.init(gen)
    shapes_j = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(jp)}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + f"['{k}']")
            else:
                yield prefix + f"['{k}']", (tuple(v.shape), str(v.dtype).replace("torch.", ""))

    assert dict(walk(p)) == shapes_j
    # a second draw from the same seed gives the same weights
    gen.manual_seed(0)
    for a, b in zip(_leaves(p), _leaves(m.init(gen))):
        assert torch.equal(a, b)


# -------------------------- the slice as a whole ----------------------- #
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_the_reference(param_dtype):
    jm, jp, m, p = both_models(param_dtype)
    tol = TOL[param_dtype]
    jt, tt = tokens((2, 20))
    with torch.no_grad():
        close(m.forward(p, {"tokens": tt}), jm.forward(jp, {"tokens": jt})[0], **tol)
        jl, jc = jm.prefill(jp, {"tokens": jt[:, :12]}, 32)
        tl, tc = m.prefill(p, {"tokens": tt[:, :12]}, 32)
        close(tl, jl, **tol)
        assert tc["k"].shape == jc["k"].shape
        assert str(tc["k"].dtype) == f"torch.{jc['k'].dtype}"
        close(tc["k"], jc["k"], rtol=2e-2, atol=2e-2)      # bf16 cache: one ulp
        for i in range(12, 16):                             # a few decode steps
            pos = i if i % 2 else np.array([i, i])          # scalar and (B,) positions
            jl, jc = jm.decode_step(jp, jt[:, i:i + 1], jc, jnp.asarray(pos, jnp.int32))
            tl, tc = m.decode_step(p, tt[:, i:i + 1], tc, torch.as_tensor(pos))
            close(tl, jl, **tol)


def _extend_in_chunks(m, p, tt, cache, chunks):
    x = None
    for pos0, n in chunks:
        x = layers.embed(p["embed"], tt[:, pos0:pos0 + n])
        offsets = torch.tensor([0, pos0, n])            # slot, pos0, c
        x = tfm.uniform_stack_extend(p["stack"], m.cfg, x, cache["k"], cache["v"], offsets)
    return x


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_extend_in_two_chunks_equals_prefill(param_dtype):
    """uniform_stack_extend over two chunks fills the cache and gives the
    logits that one prefill gives (over a cache of the parameters' type, so
    that f32 is exact), and over the engine's bf16 cache it matches the
    reference's extend chunk by chunk."""
    jm, jp, m, p = both_models(param_dtype)
    cfg, tol = m.cfg, TOL[param_dtype]
    chunks = ((0, 12), (12, 8))
    jt, tt = tokens((1, 20), seed=1)
    with torch.no_grad():
        want, pc = m.prefill(p, {"tokens": tt}, 33)
        cache = {k: torch.zeros_like(v) for k, v in pc.items()}
        x = _extend_in_chunks(m, p, tt, cache, chunks)
        logits = layers.unembed(p["embed"], layers.rmsnorm(p["final_ln"], x[:, -1:],
                                                         cfg.norm_eps))
        close(logits, want, **tol)
        close(cache["k"][:, :, :20], pc["k"][:, :, :20], **tol)
        close(cache["v"][:, :, :20], pc["v"][:, :, :20], **tol)
        cache = m.init_cache(1, 33)
        x = _extend_in_chunks(m, p, tt, cache, chunks)
    jc = jm.init_cache(1, 33)
    jx = None
    for pos0, n in chunks:
        jx = jlayers.embed(jp["embed"], jt[:, pos0:pos0 + n])
        jx, jk, jv = jtfm.uniform_stack_extend(jp["stack"], jm.cfg, jx, jc["k"], jc["v"],
                                               pos0, ctx=LOCAL_CTX)
        jc = {"k": jk, "v": jv}
    close(x, jx, **tol)
    close(cache["k"], jc["k"], rtol=2e-2, atol=2e-2)       # bf16 cache: one ulp


def test_other_families_raise_naming_the_roadmap():
    """Every arch of the registry builds on the CPU, and none raises any
    more: dense and moe decoders (global attention and gemma3's
    local:global stack), the SSM and hybrid families, the vlm's grouped
    stack and the audio encoder (the last two raised while ROADMAP item A7
    was open). Each tiny config's parameters are drawn and its forward
    gives finite logits of the vocabulary's width. (The name dates from
    when the families not yet ported raised, naming their roadmap item.)"""
    built = set()
    for arch in list_archs():
        cfg = tiny_config(get_config(arch))
        m = build_model(cfg, device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        if cfg.family == "audio":
            batch = {"frames": torch.from_numpy(rng.standard_normal((1, 5, cfg.d_model),
                                                                    dtype=np.float32))}
        else:
            batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, 5)))}
        if cfg.family == "vlm":
            batch["vision"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_vision), dtype=np.float32))
        with torch.no_grad():
            logits = m.forward(p, batch)
        assert logits.shape == (1, 5, cfg.vocab_size) and torch.isfinite(logits).all()
        built.add((cfg.family, cfg.attn.pattern))
    assert {f for f, _ in built} == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    assert ("dense", "local_global") in built


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_config(get_config("qwen3-1.7b")))
