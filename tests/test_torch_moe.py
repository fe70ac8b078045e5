"""The port's MoE (``repro_torch.models.moe``, the local path) against the
JAX package's, on the CPU, with the same numpy-seeded inputs.

f32 throughout for the module (``param_dtype="float32"``), held to 2e-5:
the two sides differ by the order of f32 sums in the products and the
softmax. Routing ids and the dispatch's keep / drop decisions are discrete
and must agree exactly; several cases set a capacity factor low enough that
experts drop tokens, so the stable sort and the capacity test are
exercised, not only the no-drop case of ``tiny_config`` (capacity factor
8). The combine is held to the reference's scatter-add bit for bit in
bf16. The models are held as ``tests/test_torch_model.py`` holds the dense
one (f32 1e-4; bf16 at the reference's rtol 0.15 / atol 0.3). The two
engines on the tiny moonshot are cases of ``tests/test_torch_serve.py``'s
cross-package engine test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.moe import LOCAL_CTX
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.models import build_model, layers, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import chunk_bucket

F32_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
MOONSHOT, PHI = "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"


def close(got: torch.Tensor, want, **tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def configs(arch=MOONSHOT, param_dtype="float32", **moe_kw):
    """The tiny config of ``arch`` on both sides, its MoE fields overridden
    by ``moe_kw``."""
    jcfg = jax_tiny_config(jax_get_config(arch))
    cfg = tiny_config(get_config(arch))
    jcfg = jcfg.with_overrides(param_dtype=param_dtype, attn_impl="reference",
                               moe=dataclasses.replace(jcfg.moe, **moe_kw))
    cfg = cfg.with_overrides(param_dtype=param_dtype,
                             moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def moe_params(jcfg, seed=0):
    """The reference's MoE parameters of one layer (f32) and the port's copy."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def acts(T, d, seed):
    return np.random.default_rng(seed).standard_normal((T, d), dtype=np.float32)


def dropped(jcfg, ids, T) -> int:
    """Assignments the reference's capacity test drops for these ids."""
    load = np.bincount(np.asarray(ids).reshape(-1), minlength=jcfg.moe.n_experts)
    return int(np.maximum(load - jmoe.capacity(T, jcfg), 0).sum())


# ----------------------------- the module ------------------------------ #
@pytest.mark.parametrize("E,k", [(4, 2), (64, 6)])
def test_route_matches_the_reference(E, k):
    jcfg, cfg = configs(n_experts=E, top_k=k)
    jp, p = moe_params(jcfg)
    x = acts(100, jcfg.d_model, E)
    jg, jids, jaux = jmoe._route(jp["router"], jnp.asarray(x), jcfg)
    g, ids, aux = moe._route(p["router"], torch.from_numpy(x), cfg)
    assert g.dtype == torch.float32 and ids.shape == (100, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(g, jg, **F32_TOL)
    close(g.sum(-1), np.ones(100), **F32_TOL)
    close(aux, jaux, **F32_TOL)


@pytest.mark.parametrize("cf,act", [(0.3, "silu"), (0.6, "gelu"), (8.0, "silu")])
def test_dispatch_compute_combine_under_drops(cf, act):
    """The same gates and ids into both dispatches: at capacity factor 0.3
    and 0.6 experts drop assignments (the stable sort decides which), at 8
    none."""
    jcfg, cfg = configs(n_experts=8, top_k=2, capacity_factor=cf)
    jp, p = moe_params(jcfg, seed=1)
    T = 120
    x = acts(T, jcfg.d_model, 3)
    jg, jids, _ = jmoe._route(jp["router"], jnp.asarray(x), jcfg)
    cap = moe.capacity(T, cfg)
    assert cap == jmoe.capacity(T, jcfg)
    assert (dropped(jcfg, jids, T) > 0) == (cf < 1)
    want = jmoe._dispatch_compute_combine(jnp.asarray(x), jg, jids, jp["w_gate"], jp["w_up"],
                                          jp["w_down"], 0, 8, cap, act)
    got = moe._dispatch_compute_combine(
        torch.from_numpy(x), torch.from_numpy(np.asarray(jg)),
        torch.from_numpy(np.asarray(jids)).long(), p["w_gate"], p["w_up"], p["w_down"],
        cap, act)
    close(got, want, **F32_TOL)


@pytest.mark.parametrize("T,k,E", [(50, 6, 64), (33, 2, 4)])
def test_combine_is_the_reference_scatter_add_bit_for_bit(T, k, E):
    """bf16 contributions, some zero (dropped): the port's fixed-order
    combine equals the reference's ``zeros.at[tok].add`` over the stably
    sorted assignments, bit for bit."""
    rng = np.random.default_rng(T)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    order = np.argsort(ids.reshape(-1), kind="stable")
    scale = np.exp(rng.uniform(-4, 4, (T * k, 1)))
    contrib = (rng.standard_normal((T * k, 32)) * scale).astype(np.float32)
    contrib[rng.random(T * k) < 0.2] = 0.0
    jc = jnp.asarray(contrib, jnp.bfloat16)
    want = jnp.zeros((T, 32), jnp.bfloat16).at[jnp.asarray(order // k)].add(jc)
    got = moe._combine(torch.from_numpy(np.asarray(jc.astype(jnp.float32))).to(torch.bfloat16),
                       torch.from_numpy(order), torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", [MOONSHOT, PHI])
def test_capacity_matches_the_reference(arch):
    """Every token count up to 1,100 at the full config's and three other
    capacity factors."""
    for cf in (None, 0.3, 1.0, 8.0):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if cf is not None:
            jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
            cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        want = [jmoe.capacity(i, jcfg) for i in range(1, 1101)]
        assert [moe.capacity(i, cfg) for i in range(1, 1101)] == want
    assert moe.capacity(8, get_config(MOONSHOT)) == 8
    assert moe.capacity(4096, get_config(MOONSHOT)) == 480


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_local_matches_the_reference(shared):
    jcfg, cfg = configs(n_experts=8, top_k=2, n_shared_experts=shared, capacity_factor=0.5)
    jp, p = moe_params(jcfg, seed=2)
    assert ("shared" in p) == bool(shared)
    x = acts(2 * 45, jcfg.d_model, 4).reshape(2, 45, -1)
    want, jaux = jmoe.moe_ffn_local(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_ffn_local(p, cfg, torch.from_numpy(x))
    _, jids, _ = jmoe._route(jp["router"], jnp.asarray(x.reshape(90, -1)), jcfg)
    assert dropped(jcfg, jids, 90) > 0
    assert got.shape == x.shape
    close(got, want, **F32_TOL)
    close(aux, jaux, **F32_TOL)


@pytest.mark.parametrize("c,C", [(100, 128), (40, 64), (1, 16)])
def test_padded_rows_take_no_capacity(c, C):
    """c real tokens padded to C rows with n_real = c on the device: the
    real rows equal the reference's call on exactly c tokens, with the
    capacity of c (at 100 of 128 and 40 of 64 smaller than the bucket's,
    and tokens dropped), though the padding routes like any row."""
    jcfg, cfg = configs(n_experts=4, top_k=2, capacity_factor=0.3)
    jp, p = moe_params(jcfg, seed=3)
    x = acts(C, jcfg.d_model, c)
    want, _ = jmoe.moe_ffn_local(jp, jcfg, jnp.asarray(x[None, :c]))
    got, _ = moe.moe_ffn_local(p, cfg, torch.from_numpy(x[None]), torch.tensor([c]))
    if c > 1:
        assert moe.capacity(c, cfg) < moe.capacity(C, cfg)
        _, jids, _ = jmoe._route(jp["router"], jnp.asarray(x[:c]), jcfg)
        assert dropped(jcfg, jids, c) > 0
    close(got[:, :c], want, **F32_TOL)


# ------------------------------ the stack ------------------------------ #
def both_models(arch, param_dtype, **moe_kw):
    jcfg, cfg = configs(arch, param_dtype, **moe_kw)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(cfg, device="cpu"), p


def tokens(shape, seed=0):
    t = np.random.default_rng(seed).integers(1, 256, size=shape)
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("arch,param_dtype", [(MOONSHOT, "float32"), (PHI, "float32"),
                                              (MOONSHOT, "bfloat16")])
def test_forward_prefill_decode_match_the_reference(arch, param_dtype):
    """The tiny moonshot (shared experts) and phi3.5-moe (none) on weights
    from ``from_jax_params``; the aux loss summed over the layers too."""
    jm, jp, m, p = both_models(arch, param_dtype)
    assert p["stack"]["moe"]["router"].dtype == torch.float32
    assert ("shared" in p["stack"]["moe"]) == (arch == MOONSHOT)
    tol = TOL[param_dtype]
    jt, tt = tokens((2, 20))
    with torch.no_grad():
        jl, jaux = jm.forward(jp, {"tokens": jt})
        close(m.forward(p, {"tokens": tt}), jl, **tol)
        x = layers.embed(p["embed"], tt)
        _, aux, _ = tfm.uniform_stack_fwd(p["stack"], m.cfg, x)
        close(aux, jaux, **(F32_TOL if param_dtype == "float32" else dict(rtol=2e-2, atol=2e-2)))
        jl, jc = jm.prefill(jp, {"tokens": jt[:, :12]}, 32)
        tl, tc = m.prefill(p, {"tokens": tt[:, :12]}, 32)
        close(tl, jl, **tol)
        # the bf16 cache: one ulp in f32; in bf16 the second layer's keys
        # carry the first MoE's bf16 difference, held as the logits are
        close(tc["k"], jc["k"], **(dict(rtol=2e-2, atol=2e-2) if param_dtype == "float32"
                                   else tol))
        for i in range(12, 16):
            pos = i if i % 2 else np.array([i, i])
            jl, jc = jm.decode_step(jp, jt[:, i:i + 1], jc, jnp.asarray(pos, jnp.int32))
            tl, tc = m.decode_step(p, tt[:, i:i + 1], tc, torch.as_tensor(pos))
            close(tl, jl, **tol)


@pytest.mark.parametrize("pos0,c", [(0, 100), (30, 17), (40, 1)])
def test_padded_extend_matches_the_reference_extend_of_c_tokens(pos0, c):
    """uniform_stack_extend on a chunk of c tokens padded to its bucket
    (offsets [slot, pos0, c] on the device) against the reference's extend
    of exactly those c tokens, under drops (capacity factor 0.3), over f32
    caches: the real rows and the cache."""
    jm, jp, m, p = both_models(MOONSHOT, "float32", capacity_factor=0.3)
    jt, tt = tokens((1, pos0 + c), seed=c)
    smax = 161
    jc = {n: jnp.zeros((m.cfg.n_layers, 1, smax) + v.shape[3:], jnp.float32)
          for n, v in jm.init_cache(1, 1).items()}
    cache = {n: torch.zeros(v.shape) for n, v in jc.items()}
    for start, n in ((0, pos0), (pos0, c)):
        if not n:
            continue
        jx = jlayers.embed(jp["embed"], jt[:, start:start + n])
        jx, jk, jv = jtfm.uniform_stack_extend(jp["stack"], jm.cfg, jx, jc["k"], jc["v"],
                                               start, ctx=LOCAL_CTX)
        jc = {"k": jk, "v": jv}
        pad = torch.zeros((1, chunk_bucket(n)), dtype=torch.long)
        pad[0, :n] = tt[0, start:start + n]
        with torch.no_grad():
            x = tfm.uniform_stack_extend(p["stack"], m.cfg, layers.embed(p["embed"], pad),
                                         cache["k"], cache["v"], torch.tensor([0, start, n]))
    close(x[:, :c], jx, **F32_TOL)
    for name in ("k", "v"):
        close(cache[name][:, :, :smax - 1], jc[name][:, :, :smax - 1], **F32_TOL)


def test_full_moonshot_tree_and_count():
    """moonshot-v1-16b-a3b at full width and depth, built under
    FakeTensorMode (no memory): the reference's tree of shapes and types,
    and its 28,552,923,136 parameters: ``n_params()``'s 28,552,921,088 and
    the final norm's 2,048, which it does not count."""
    cfg, jcfg = get_config(MOONSHOT), jax_get_config(MOONSHOT)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))

    def spec(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    with FakeTensorMode():
        p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        assert spec(p) == spec(jshapes)
        n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == sum(a.size for a in jax.tree.leaves(jshapes)) == 28_552_923_136
    assert cfg.n_params() == 28_552_921_088 == n - cfg.d_model
    assert spec(p)["['stack']['moe']['w_gate']"] == ((48, 64, 2048, 1408), "bfloat16")
    assert spec(p)["['stack']['moe']['router']"] == ((48, 2048, 64), "float32")
