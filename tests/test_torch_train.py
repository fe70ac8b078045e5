"""The port's training path against the JAX package's, on the CPU: the
gradients through the kernels' Functions, the loss and every leaf's
gradient of every tiny arch, the remat policies, the optimizers, the train
step and the gradient quantiser.

Weights go from the reference's tree through ``from_jax_params``, batches
are drawn with NumPy from a seed and handed to both. f32 parameters
(``param_dtype="float32"``): the loss is held to 1e-5 relative and each
leaf's gradient to ``max|d| <= 1e-4 * max(1, max|g_ref|)``, since the two
sides differ by the order of f32 sums only; a ``None`` gradient (a leaf the
loss does not reach: hubert's embedding, gemma3's empty ``(0, ...)``
stacks) counts as the reference's zeros. In bf16 the two frameworks round
at different places, so there the port's gradients are held to what the
reference's own ``test_grads_flow`` asks: finite, and not all zero. A
train step is held to the reference's loss and parameters within 1e-5
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.parallel.collectives import compress_grads_int8 as jax_compress_grads_int8
from repro.train import optimizer as jopt
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, list_archs, tiny_config
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import ssm_scan as ssm_mod
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import _MmF32
from repro_torch.parallel.collectives import compress_grads_int8
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import leaves, unflatten

ARCHS = list_archs(assigned_only=True) + ["gemma3-1b", "llama3.1-8b"]


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores (300 optimizer
    steps on a (256, 256) tensor took minutes so, against seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_np(cfg, B=2, S=16, seed=0):
    """A training batch for ``cfg``'s family: tokens (or frames), labels, a
    loss mask that leaves about a fifth of the tokens out, vision tokens
    for the vlm."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)
    return b


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def configs(arch, param_dtype="float32", **over):
    jcfg = jax_tiny_config(jax_get_config(arch)).with_overrides(
        param_dtype=param_dtype, attn_impl="reference", **over)
    return jcfg, tiny_config(get_config(arch)).with_overrides(param_dtype=param_dtype, **over)


def grads_of(m, params, batch):
    """(loss, grads leaf by leaf of ``leaves(params)``, None where unused)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = m.loss_fn(unflatten(params, live), batch)
    return loss, torch.autograd.grad(loss, live, allow_unused=True)


def assert_leaf_close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rel * max(1.0, np.abs(want).max(initial=0.0)), (what, err)


# ----------------------- the kernels' Functions ------------------------ #
def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def through_function(out: torch.Tensor) -> bool:
    """Whether the graph behind ``out`` holds a kernel's Function."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "KernelFunctionBackward":
            return True
        todo += [f for f, _ in fn.next_functions]
    return False


def _vjp_torch(fn, inputs, ct, function: bool):
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*xs)
    assert through_function(out) == function
    return torch.autograd.grad(out, xs, torch.from_numpy(ct))


def _vjp_jax(fn, inputs, ct):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return vjp(jnp.asarray(ct))


KERNEL_CASES = ["rmsnorm", "flash_attention_causal", "flash_attention_local",
                "flash_attention_bidirectional", "flash_decode", "ssm_scan"]


def kernel_case(name):
    """(wrapper in the model's layout, its plain version, the reference's
    oracle in its own layout, inputs in the oracle's layout)."""
    rng = np.random.default_rng(3)
    if name == "rmsnorm":
        x = rng.standard_normal((6, 32)).astype(np.float32)
        s = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
        return (rms_mod.rmsnorm, rms_mod.rmsnorm_plain, jref.ref_rmsnorm, [x, s])
    if name.startswith("flash_attention"):
        kind = name.split("_")[-1]
        BKV, g, S, D = 2, 2, 24, 16
        q = rng.standard_normal((BKV * g, S, D)).astype(np.float32)
        k = rng.standard_normal((BKV, S, D)).astype(np.float32)
        v = rng.standard_normal((BKV, S, D)).astype(np.float32)

        def layout(fn):
            def call(q, k, v):      # the oracle's layout in, through the model's
                o = fn(q.view(BKV, g, S, D).permute(0, 2, 1, 3), k[:, :, None],
                       v[:, :, None], kind, 8)
                return o.permute(0, 2, 1, 3).reshape(BKV * g, S, D)
            return call
        return (layout(fa_mod.flash_attention), layout(fa_mod.flash_attention_plain),
                lambda q, k, v: jref.ref_flash_attention(q, k, v, kind, 8), [q, k, v])
    if name == "flash_decode":
        BKV, G, T, D = 2, 4, 20, 16
        q = rng.standard_normal((BKV, G, D)).astype(np.float32)
        k = rng.standard_normal((BKV, T, D)).astype(np.float32)
        v = rng.standard_normal((BKV, T, D)).astype(np.float32)
        lens = np.array([20, 7])

        def layout(fn):
            def call(q, k, v):
                o = fn(q[:, None], k[:, :, None], v[:, :, None], torch.from_numpy(lens))
                return o[:, 0]
            return call
        return (layout(dec_mod.flash_decode), layout(dec_mod.flash_decode_plain),
                lambda q, k, v: jref.ref_flash_decode(q, k, v, jnp.asarray(lens)), [q, k, v])
    Bb, S, di, N = 2, 9, 12, 4
    x = rng.standard_normal((Bb, S, di)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bb, S, di)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (di, N)).astype(np.float32)
    B = rng.standard_normal((Bb, S, N)).astype(np.float32)
    C = rng.standard_normal((Bb, S, N)).astype(np.float32)
    return (lambda *a: ssm_mod.ssm_scan(*a)[0], lambda *a: ssm_mod.ssm_scan_plain(*a)[0],
            jref.ref_ssm_scan, [x, dt, A, B, C])


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_functions_give_plain_autograd_and_the_reference_gradients(name):
    """Each wrapper, given inputs that require grad, returns an output whose
    graph holds its Function: its gradients equal the plain version's
    autograd exactly, and ``jax.vjp`` of the reference's oracle at f32
    tolerance. Under ``torch.no_grad()`` the wrapper takes its path as
    before: no graph."""
    fn, plain, oracle, inputs = kernel_case(name)
    out = fn(*[torch.from_numpy(a) for a in inputs])
    ct = _cotangent(tuple(out.shape), 5)
    got = _vjp_torch(fn, inputs, ct, function=True)
    want = _vjp_torch(plain, inputs, ct, function=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, _vjp_jax(oracle, inputs, ct)):
        assert_leaf_close(g, w, 1e-5, name)
    with torch.no_grad():
        assert fn(*[torch.from_numpy(a).requires_grad_() for a in inputs]).grad_fn is None


def test_ssm_scan_function_takes_h0_and_gives_the_final_state_its_gradient():
    rng = np.random.default_rng(4)
    Bb, S, di, N = 2, 5, 6, 3
    arrays = [rng.standard_normal((Bb, S, di)), rng.uniform(0.01, 0.2, (Bb, S, di)),
              -rng.uniform(0.5, 2.0, (di, N)), rng.standard_normal((Bb, S, N)),
              rng.standard_normal((Bb, S, N)), rng.standard_normal((Bb, di, N))]
    arrays = [a.astype(np.float32) for a in arrays]

    def vjp(fn):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
        y, h = fn(*xs)
        loss = (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum() + h.square().sum()
        return torch.autograd.grad(loss, xs)
    for g, w in zip(vjp(ssm_mod.ssm_scan), vjp(ssm_mod.ssm_scan_plain)):
        assert torch.equal(g, w)


def test_functions_refuse_the_in_place_paths_under_grad():
    """The engine's extend step (``offsets``) and the scan into
    ``out_state`` write in place and have no gradient: they raise where one
    is wanted, and run under ``torch.no_grad()``."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    cache = torch.randn(2, 8, 2, 16)
    offsets = torch.tensor([1, 2, 4])
    with pytest.raises(RuntimeError, match="offsets"):
        fa_mod.flash_attention(q, cache, cache, offsets=offsets)
    with torch.no_grad():
        assert fa_mod.flash_attention(q, cache, cache, offsets=offsets).shape == q.shape
    x = torch.randn(1, 3, 4, requires_grad=True)
    dt, A = torch.rand(1, 3, 4), -torch.rand(4, 2)
    B, C, h = torch.randn(1, 3, 2), torch.randn(1, 3, 2), torch.zeros(1, 4, 2)
    with pytest.raises(RuntimeError, match="out_state"):
        ssm_mod.ssm_scan(x, dt, A, B, C, h, out_state=h)
    with torch.no_grad():
        ssm_mod.ssm_scan(x, dt, A, B, C, h, out_state=h)


def test_mm_f32_function_has_the_transpose_rule():
    """The unembedding's bf16 product with f32 logits (``_MmF32``, which the
    card takes since its ``mm`` with ``out_dtype`` has no derivative): dx
    in x's type, dw in w's type, equal at the bf16 tolerance to autograd
    of the product taken in f32."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32) / 5).bfloat16()
    g = torch.from_numpy(rng.standard_normal((10, 40)).astype(np.float32))
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = _MmF32.apply(xs, ws)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    assert dx.dtype == dw.dtype == torch.bfloat16
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    want = torch.autograd.grad(xf @ wf, (xf, wf), g)
    for got, ref in zip((dx, dw), want):
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=2e-2, atol=5e-2)


# ------------------------ the loss and gradients ------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    """Twin of ``test_forward_and_loss`` and ``test_grads_flow``
    (tests/test_models_smoke.py), held to the reference's numbers: f32
    parameters converted from its init, one batch with a loss mask."""
    jcfg, cfg = configs(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    b = batch_np(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b)[0]))(
        jp, to_jax(b))
    m = build_model(cfg, device="cpu")
    loss, grads = grads_of(m, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"),
                           to_torch(b))
    assert abs(float(loss.detach()) / float(jloss) - 1) <= 1e-5
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert_leaf_close(g, w, 1e-4, f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_flow_in_bf16(arch):
    """bf16 parameters: a finite loss, every gradient finite, not all zero."""
    cfg = tiny_config(get_config(arch))
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    loss, grads = grads_of(m, params, to_torch(batch_np(cfg, B=1)))
    assert torch.isfinite(loss.detach())
    got = [g.float() for g in grads if g is not None]
    assert all(torch.isfinite(g).all() for g in got)
    assert any(g.norm() > 0 for g in got), f"{arch}: all-zero grads"


# -------------------------------- remat --------------------------------- #
REMAT_CASES = [("qwen3-1.7b", {}), ("qwen3-1.7b", {"layer_group": 2}),
               ("zamba2-1.2b", {}), ("moonshot-v1-16b-a3b", {}),
               ("llama-3.2-vision-90b", {}), ("gemma3-1b", {"n_layers": 8}),
               ("falcon-mamba-7b", {})]


@pytest.mark.parametrize("arch,over", REMAT_CASES)
def test_remat_policies_give_the_same_loss_and_gradients(arch, over, monkeypatch):
    """``none``, ``minimal`` and ``full`` give bit-equal loss and gradients.
    ``full`` and ``minimal`` run each remat region's forward again in the
    backward: the rmsnorm calls inside the stack are made once more (each
    is also recomputed once by its Function's backward, under every
    policy)."""
    calls = {"n": 0}
    plain = rms_mod.rmsnorm_plain

    def counted(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(rms_mod, "rmsnorm_plain", counted)
    out = {}
    for policy in ("none", "minimal", "full"):
        cfg = tiny_config(get_config(arch)).with_overrides(
            param_dtype="float32", remat_policy=policy, **over)
        m = build_model(cfg, device="cpu")
        calls["n"] = 0
        out[policy] = (*grads_of(m, m.init(torch.Generator().manual_seed(0)),
                                 to_torch(batch_np(cfg))), calls["n"])
    loss, grads, n_none = out["none"]
    for policy in ("minimal", "full"):
        got_loss, got_grads, n = out[policy]
        assert torch.equal(got_loss, loss)
        for g, w in zip(got_grads, grads):
            assert (g is None and w is None) or torch.equal(g, w)
        assert n > n_none, (policy, n, n_none)


# --------------------------- optimizers, step --------------------------- #
def test_warmup_cosine_and_global_norm_match_the_reference():
    want = jopt.warmup_cosine(3e-4, warmup=10, total=100)
    got = opt_mod.warmup_cosine(3e-4, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert abs(float(got(step)) - float(want(step))) <= 1e-6 * 3e-4
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    assert abs(float(opt_mod.global_norm(from_jax_params(tree, "cpu")))
               - float(jopt.global_norm(tree))) <= 1e-6


OPTIMIZERS = {
    "adamw": (lambda: jopt.adamw(1e-2), lambda: opt_mod.adamw(1e-2)),
    # factoring from 32 so that the tiny model's (64, 128) weights take
    # the factored second moment
    "adafactor": (lambda: jopt.adafactor(1e-2, min_dim_factored=32),
                  lambda: opt_mod.adafactor(1e-2, min_dim_factored=32)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_the_reference(name, k):
    """One step of ``make_train_step`` from the reference's parameters and
    optimizer state after its own first step (so that the moments are not
    zero), on a second batch: the same loss, the same updated parameters
    and state, within 1e-5 relative."""
    jcfg, cfg = configs("qwen3-1.7b")
    jm = jax_build_model(jcfg)
    jo, to = (f() for f in OPTIMIZERS[name])
    jstep = jax.jit(jax_make_train_step(jm, jo, JaxRunConfig(num_microbatches=k)))
    jp = jm.init(jax.random.PRNGKey(0))
    b1, b2 = batch_np(cfg, B=4, seed=1), batch_np(cfg, B=4, seed=2)
    jp1, js1, _ = jstep(jp, jo.init(jp), to_jax(b1))
    jp2, js2, jmet = jstep(jp1, js1, to_jax(b2))
    host = lambda t: from_jax_params(jax.tree.map(np.asarray, t), device="cpu")
    step = make_train_step(build_model(cfg, device="cpu"), to, RunConfig(num_microbatches=k))
    p2, s2, met = step(host(jp1), host(js1), to_torch(b2))
    assert abs(float(met["loss"]) / float(jmet["loss"]) - 1) <= 1e-5
    got, want = leaves((p2, s2)), jax.tree.leaves((jp2, js2))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_leaf_close(g, w, 1e-5, f"{name} k={k} leaf {i}")
    assert s2["count"].dtype == torch.int32 and int(s2["count"]) == 2


def test_compress_grads_int8_matches_the_reference():
    rng = np.random.default_rng(8)
    tree = {"big": rng.standard_normal((64, 96)).astype(np.float32),
            "small": rng.standard_normal((10, 10)).astype(np.float32),
            "scalar": np.float32(3.5),
            "bf16": rng.standard_normal((80, 64)).astype(np.float32),
            "tail": None}
    jtree = {k: (None if v is None else jnp.asarray(v, jnp.bfloat16 if k == "bf16"
                                                    else jnp.float32))
             for k, v in tree.items()}
    want = jax_compress_grads_int8(jtree)
    got = compress_grads_int8(from_jax_params(jax.tree.map(np.asarray, jtree), "cpu"))
    assert got["tail"] is None and got["bf16"].dtype == torch.bfloat16
    for k in ("big", "small", "scalar", "bf16"):
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))
