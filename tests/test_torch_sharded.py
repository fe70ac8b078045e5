"""The port's sharded forward (``ParallelContext`` through every stack,
DTensor parameters placed by ``parallel/sharding.py``) against the port's
own unsharded forward and the JAX package's sharded forward, on the CPU.

**The port's side.** Four forked ``gloo`` ranks (``_child`` / ``run_group``,
as in ``tests/test_torch_parallel.py``) build a (2, 2) ``("data",
"model")`` mesh. For five tiny families (dense qwen3, gemma3's
local:global stack, the moonshot moe with expert parallelism through
``moe_ffn``, falcon-mamba's Mamba-1, zamba2's hybrid) in f32 parameters,
each rank runs the unsharded model and, under each of the four recipes
(``dp_tp``, ``fsdp_tp``, ``tp_serve`` and ``tp2d_serve`` with
``feature_shard_decode``), the sharded one: forward logits, prefill logits
and cache (placed by ``cache_specs`` afterwards, as the reference's
out_shardings place it) and one decode step. Rank 0 hands back the
gathered outputs.

**The reference's side.** One subprocess, with the parent's whole
environment plus ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
places the same NumPy-made parameters (``jax.random`` in f32, converted
through ``from_jax_params`` for the port) on a (2, 2) mesh with the
reference's ``param_specs`` and runs its forward, prefill and decode step
jitted with the reference's ``ParallelContext``.

Every decode step, on each side, starts from the reference's sharded
prefill cache: a bf16 cache leaf (the SSM conv states are bf16 whatever
the parameters are, ROADMAP C15 / C16) may differ by one rounding between
two prefills, which a decode step would carry into its logits.

Tolerances: logits and f32 cache leaves at rtol = atol = 2e-5 (f32); bf16
cache leaves at one bf16 ulp (rtol 2^-7, atol the f32 2e-5); the bf16 case at the
reference's rtol 0.15 / atol 0.3. One ``fsdp_tp`` train step (AdamW, two
microbatches) equals the unsharded step's loss and updated parameters at
2e-5.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
import traceback
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.moe import ParallelContext
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_step

ARCHS = ("qwen3-1.7b", "gemma3-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-1.2b")
RECIPES = ("dp_tp", "fsdp_tp", "tp_serve", "tp2d_serve")
B, S, L = 4, 8, 16               # batch, prompt, cache length
F32 = dict(rtol=2e-5, atol=2e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=2e-5)
BF16 = dict(rtol=0.15, atol=0.3)
JOIN_S = 240

REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import get_config, tiny_config
    from repro.models import build_model
    from repro.models.moe import ParallelContext
    from repro.parallel import sharding as shd

    inputs = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    da = shd.data_axes_of(mesh)
    out = {}
    for arch, (params, tokens, nxt, S, L) in inputs.items():
        cfg = tiny_config(get_config(arch)).with_overrides(param_dtype="float32")
        model = build_model(cfg)
        for recipe in %r:
            ctx = ParallelContext(mesh, da, "model",
                                  feature_shard_decode=(recipe == "tp2d_serve"))
            p = jax.device_put(params, shd.named(mesh, shd.param_specs(cfg, recipe, mesh, params)))
            put = lambda x, spec: jax.device_put(x, shd.named(mesh, shd.sanitize(spec, x.shape, mesh)))
            t, n = put(tokens, P(da, None)), put(nxt, P(da, None))
            fwd = jax.jit(lambda p, t: model.forward(p, {"tokens": t}, ctx)[0])(p, t)
            logits, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, L, ctx))(p, t)
            cache = jax.device_put(cache, shd.named(mesh, shd.cache_specs(cfg, recipe, mesh, cache)))
            dec = jax.jit(lambda p, n, c: model.decode_step(p, n, c, S, ctx))(p, n, cache)
            get = lambda tree: jax.tree.map(lambda a: jax.device_get(a), tree)
            out[arch, recipe] = {"fwd": get(fwd), "prefill": get(logits), "cache": get(cache),
                                 "decode": get(dec[0])}
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("REFERENCE_DONE")
""" % (RECIPES,))


def _np(t):
    """A tensor as NumPy; bf16 as ml_dtypes' bfloat16, so its tolerance knows it."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _flat(tree, prefix=""):
    """{path: leaf} of a nest of dicts (None dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {} if tree is None else {prefix: tree}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's parameters as NumPy trees and inputs, a tree per
    arch; the reference's sharded outputs per (arch, recipe))."""
    tmp = tmp_path_factory.mktemp("sharded_ref")
    inputs = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_tiny_config(jax_get_config(arch)).with_overrides(param_dtype="float32")
        params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(i)))
        rng = np.random.default_rng(10 + i)
        inputs[arch] = (params, rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
                        rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32), S, L)
    src, dst = tmp / "inputs.pkl", tmp / "outputs.pkl"
    src.write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, ["src", env.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(src), str(dst)],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=Path(__file__).resolve().parents[1])
    assert "REFERENCE_DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return inputs, pickle.loads(dst.read_bytes())


# --------------------------- process groups --------------------------- #
def _child(fn, rank, world, store, out_dir, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    os._exit(0)


def run_group(tmp_path, world: int, fn, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` forked gloo ranks; returns
    their results in rank order. Fails if a rank fails or the group does
    not end within ``JOIN_S`` seconds."""
    ctx = mp.get_context("fork")
    out = tmp_path / f"group{world}_{fn.__name__}"
    out.mkdir()
    store = str(out / "store")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errs = {r: (out / f"rank{r}.err").read_text() for r in range(world)
            if (out / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} did not finish in {JOIN_S} s; errors: {errs}"
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _full(t):
    return t.full_tensor() if type(t).__name__ == "DTensor" else t


def _outputs(m, params, tokens, nxt, ref_cache, ctx=None, place=None):
    """forward logits, prefill logits and cache, and the decode step's
    logits from ``ref_cache``: each gathered to the whole tensor, as NumPy."""
    kw = {} if ctx is None else {"ctx": ctx}
    place = place or (lambda x, spec: x)
    with torch.no_grad():
        tok, nt = place(tokens, ("data", None)), place(nxt, ("data", None))
        out = {"fwd": m.forward(params, {"tokens": tok}, **kw)}
        out["prefill"], cache = m.prefill(params, {"tokens": tok}, L, **kw)
        out["cache"] = {k: _np(_full(v)) for k, v in _flat(
            place(cache, "cache") if ctx is not None else cache).items()}
        out["decode"] = m.decode_step(params, nt, place(ref_cache, "cache"), S, **kw)[0]
    return {k: v if k == "cache" else _np(_full(v)) for k, v in out.items()}


def _sharded_arch(rank, world, arch, inputs, ref):
    """The unsharded outputs, then each recipe's sharded ones (rank 0 keeps
    them); for qwen3 also the bf16 case and one fsdp_tp train step."""
    params_np, tokens, nxt, _, _ = inputs
    cfg = tiny_config(get_config(arch)).with_overrides(param_dtype="float32")
    m = build_model(cfg, device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    da = shd.data_axes_of(mesh)
    tok, nt = torch.from_numpy(tokens).long(), torch.from_numpy(nxt).long()
    params = from_jax_params(params_np, "cpu")
    res = {"plain": _outputs(m, params, tok, nt, from_jax_params(ref["dp_tp"]["cache"], "cpu"))}
    for recipe in RECIPES:
        ctx = ParallelContext(mesh, da, "model", feature_shard_decode=(recipe == "tp2d_serve"))

        def place(x, spec):
            if spec == "cache":
                return shd.distribute(x, mesh, shd.cache_specs(cfg, recipe, mesh, x))
            return shd.distribute(x, mesh, shd.sanitize((da, None), x.shape, mesh))
        ref_cache = from_jax_params(ref[recipe]["cache"], "cpu")
        placed = shd.distribute(params, mesh, shd.param_specs(cfg, recipe, mesh, params))
        res[recipe] = _outputs(m, placed, tok, nt, ref_cache, ctx, place)
    if arch == "qwen3-1.7b":
        res.update(_bf16_and_train(cfg, mesh, da, params, tok))
    return res if rank == 0 else None


def _bf16_and_train(cfg, mesh, da, params, tok):
    out = {}
    cfg16 = cfg.with_overrides(param_dtype="bfloat16")
    m16 = build_model(cfg16, device="cpu")
    p16 = m16.init(torch.Generator().manual_seed(3))
    ctx = ParallelContext(mesh, da, "model")
    placed = shd.distribute(p16, mesh, shd.param_specs(cfg16, "dp_tp", mesh, p16))
    t = shd.distribute(tok, mesh, shd.sanitize((da, None), tok.shape, mesh))
    with torch.no_grad():
        out["bf16"] = (_np(m16.forward(p16, {"tokens": tok})),
                       _np(_full(m16.forward(placed, {"tokens": t}, ctx))))
    m = build_model(cfg, device="cpu")
    opt = get_optimizer("adamw")
    run = RunConfig(num_microbatches=2)
    labels = torch.roll(tok, -1, 1)
    batch = {"tokens": tok, "labels": labels}
    ctx = ParallelContext(mesh, da, "model")
    specs = shd.param_specs(cfg, "fsdp_tp", mesh, params)
    sp = shd.distribute(params, mesh, specs)
    state = opt.init(params)
    ss = shd.distribute(state, mesh, shd.param_specs(cfg, "fsdp_tp", mesh, state))
    sb = {k: shd.distribute(v, mesh, shd.sanitize((da, None), v.shape, mesh))
          for k, v in batch.items()}
    plain = {k: v.clone() for k, v in _flat(params).items()}
    _, _, want = make_train_step(m, opt, run)(_unflat(plain), state, batch)
    new, _, got = make_train_step(m, opt, run, ctx)(sp, ss, sb)
    out["train"] = (float(want["loss"]), float(_full(got["loss"])),
                    {k: _np(v) for k, v in plain.items()},
                    {k: _np(_full(v)) for k, v in _flat(new).items()})
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def sharded(reference, tmp_path_factory):
    inputs, ref = reference
    out = {}
    for arch in ARCHS:
        tmp = tmp_path_factory.mktemp(arch.replace(".", "_"))
        out[arch] = run_group(tmp, 4, _sharded_arch, arch, inputs[arch],
                              {r: ref[arch, r] for r in RECIPES})[0]
    return out


def _close_cache(got, want, what):
    assert set(got) == set(want), what
    for k, a in want.items():
        a = np.asarray(a)
        tol = BF16_ULP if a.dtype.name == "bfloat16" else F32
        np.testing.assert_allclose(np.asarray(got[k], np.float32), a.astype(np.float32),
                                   err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_the_unsharded_port_and_the_reference(
        sharded, reference, arch, recipe):
    got, plain = sharded[arch][recipe], sharded[arch]["plain"]
    want = reference[1][arch, recipe]
    for k in ("fwd", "prefill"):
        np.testing.assert_allclose(got[k], plain[k], err_msg=k, **F32)
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), err_msg=k, **F32)
    _close_cache(got["cache"], {k: v for k, v in plain["cache"].items()}, "cache vs port")
    _close_cache(got["cache"], _flat(want["cache"]), "cache vs reference")
    np.testing.assert_allclose(got["decode"], np.asarray(want["decode"], np.float32), **F32)
    if recipe == "dp_tp":          # the unsharded decode read the dp_tp cache
        np.testing.assert_allclose(got["decode"], plain["decode"], **F32)


def test_bf16_sharded_forward_within_the_references_bf16_tolerance(sharded):
    want, got = sharded["qwen3-1.7b"]["bf16"]
    np.testing.assert_allclose(got, want, **BF16)


def test_fsdp_train_step_equals_the_unsharded_step(sharded):
    want_loss, got_loss, want, got = sharded["qwen3-1.7b"]["train"]
    assert got_loss == pytest.approx(want_loss, rel=2e-5, abs=2e-5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)


def test_sequence_parallel_decode_merge_equals_the_whole_cache():
    """A decode over a cache whose rows three ranks split: each rank's
    ``partials_plain`` over its block (rows of no key included), merged as
    ``flash_decode``'s sharded path merges them (the max, then the rescaled
    sums), equals ``flash_decode_plain`` over the whole cache."""
    from repro_torch.kernels import decode_attention as dec
    rng = np.random.default_rng(7)
    B, H, KVH, D, T = 5, 8, 2, 16, 48
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, 1, H, D), (B, T, KVH, D), (B, T, KVH, D)))
    lens = torch.tensor([48, 1, 16, 17, 33])
    blk = T // 3
    parts = [dec.partials_plain(q, k[:, c * blk:(c + 1) * blk], v[:, c * blk:(c + 1) * blk],
                                torch.clamp(lens - c * blk, 0, blk)) for c in range(3)]
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - top) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - top)[..., None] for m, _, a in parts)
    got = (acc / l[..., None]).reshape(B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), dec.flash_decode_plain(q, k, v, lens).numpy(), **F32)
    assert parts[2][1][1].abs().max() == 0 and parts[2][2][1].abs().max() == 0
