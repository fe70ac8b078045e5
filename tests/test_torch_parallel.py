"""The port's parallel layer (``repro_torch.parallel``, the expert-parallel
``models.moe.moe_ffn``) against the JAX package's, on the CPU.

The sharding recipes are pure functions: for every config of the registry,
each recipe and the reference's (16, 16) and (2, 16, 16) meshes (as
``tests/test_hlo_sharding.py`` builds them, without devices), the port's
specs of its ``meta`` parameter and cache trees equal the reference's of
``jax.eval_shape(model.init)`` and ``init_cache(..., abstract=True)``
leaf for leaf.

The collective paths run on ``gloo`` process groups of 2 and 4 CPU
processes (forked by ``torch.multiprocessing``, rendezvous through a
``FileStore`` under ``tmp_path``, so parallel test workers cannot
collide). Each rank writes its result to a file; the parent holds them
against the reference, computed in its own process. Every join has a
timeout and a group that does not finish fails the test. The card's
machine has one GPU, and NCCL puts no two ranks on one GPU: these paths are
verified on gloo only.
"""
import math
import os
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import list_archs as jax_list_archs
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jshd
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs, tiny_config
from repro_torch.core import hlo
from repro_torch.launch.dryrun import meta_params
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.convert import from_jax_params
from repro_torch.parallel import collectives, pipeline
from repro_torch.parallel import sharding as shd

RECIPES = ("fsdp_tp", "dp_tp", "tp_serve", "tp2d_serve")
JOIN_S = 90


class FakeMesh:
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = (FakeMesh({"data": 16, "model": 16}), FakeMesh({"pod": 2, "data": 16, "model": 16}))


def jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jshd._path_str(kp): leaf for kp, leaf in flat}


def paths(tree, prefix="") -> dict:
    """{path: leaf} of the port's dict trees (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {} if tree is None else {prefix: tree}


# ------------------------------ sharding ------------------------------ #
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_specs_equal_the_reference_leaf_for_leaf(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = meta_params(cfg)
    shapes = {p: tuple(t.shape) for p, t in paths(params).items()}
    assert shapes == {p: tuple(l.shape) for p, l in jax_paths(jparams).items()}
    caches = None
    if not cfg.is_encoder:
        B, S = 8, 1024
        jcache = jmodel.init_cache(B, S, abstract=True)
        cache = build_model(cfg, device="meta").init_cache(B, S)
        assert ({p: tuple(t.shape) for p, t in paths(cache).items()}
                == {p: tuple(l.shape) for p, l in jax_paths(jcache).items()})
        caches = (jcache, cache)
    for mesh in MESHES:
        for recipe in RECIPES:
            want = {p: tuple(s) for p, s in
                    jax_paths(jshd.param_specs(jcfg, recipe, mesh, jparams)).items()}
            got = paths(shd.param_specs(cfg, recipe, mesh, params))
            assert got == want, (recipe, mesh.shape)
            if caches:
                want = {p: tuple(s) for p, s in
                        jax_paths(jshd.cache_specs(jcfg, recipe, mesh, caches[0])).items()}
                got = paths(shd.cache_specs(cfg, recipe, mesh, caches[1]))
                assert got == want, (recipe, mesh.shape)


def test_pick_recipe_sanitize_and_batch_specs_as_the_reference():
    for arch in jax_list_archs():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in SHAPES:
            assert shd.pick_recipe(cfg, SHAPES[name]) == jshd.pick_recipe(jcfg, JAX_SHAPES[name])
        for mesh in MESHES:
            for kind in ("train", "prefill", "decode"):
                want = {k: tuple(v) for k, v in
                        jshd.batch_specs(jcfg, "fsdp_tp", mesh, kind).items()}
                assert shd.batch_specs(cfg, "fsdp_tp", mesh, kind) == want
    mesh = MESHES[1]
    for spec, shape in ((("data", "model"), (32, 48)), ((("pod", "data"), None), (64, 5)),
                        ((None, "model", "data"), (3, 504, 16)), ((("data", "model"),), (512,)),
                        (("pod",), (1,))):
        want = tuple(jshd.sanitize(jax.sharding.PartitionSpec(*spec), shape, mesh))
        assert shd.sanitize(spec, shape, mesh) == want


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
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _distribute(rank, world):
    cfg = tiny_config(get_config("qwen3-1.7b"))
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    specs = shd.param_specs(cfg, "fsdp_tp", mesh, params)
    dt = shd.distribute(params, mesh, specs)
    flat = paths(params)
    return {p: (tuple(t.to_local().shape), tuple(flat[p].shape), paths(specs)[p],
                torch.equal(t.full_tensor(), flat[p]))
            for p, t in paths(dt).items()}


def test_distribute_places_each_local_shard_by_its_spec(tmp_path):
    mesh = FakeMesh({"data": 2, "model": 2})
    for res in run_group(tmp_path, 4, _distribute):
        sharded = 0
        for path, (local, full, spec, whole) in res.items():
            want = list(full)
            for i, ax in enumerate(spec):
                if ax is not None:
                    want[i] //= shd._axis_size(mesh, ax)
                    sharded += 1
            assert local == tuple(want), (path, spec)
            assert whole, path
        assert sharded > 0


def _psum(rank, world, n):
    x = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(n)
                         .astype(np.float32) * (rank + 1))
    tree = {"a": x[: n // 2], "b": [x[n // 2:]], "c": None}
    with hlo.Counter() as counter:
        got = collectives.psum_int8(x)
    return {"x": x, "psum": got, "tree": collectives.ring_allreduce_int8()(tree),
            "coll": (counter.stats.coll_bytes_by_kind, counter.stats.coll_count_by_kind)}


def reference_psum_int8(xs) -> np.ndarray:
    """The reference's arithmetic over the ranks' inputs ``xs``, worked out
    with ``repro.parallel.collectives.quantize_int8``: the int8 payloads
    summed in int32, times the largest scale."""
    qs = [jcoll.quantize_int8(jnp.asarray(x)) for x in xs]
    total = sum(np.asarray(q, np.int32) for q, _ in qs)
    return total.astype(np.float32) * np.float32(max(float(s) for _, s in qs))


@pytest.mark.parametrize("world", [2, 4])
def test_psum_int8_is_the_references_formula(tmp_path, world):
    """Each rank quantises with its own scale, the int8 payloads add in
    int32, the sum is multiplied by the largest scale (not the dequantised
    sum): the reference's arithmetic, within one f32 ulp; the tree variant
    leaf by leaf."""
    n = 1000
    res = run_group(tmp_path, world, _psum, n)
    xs = [r["x"].numpy() for r in res]
    want = reference_psum_int8(xs)
    want_a = reference_psum_int8([x[: n // 2] for x in xs])
    want_b = reference_psum_int8([x[n // 2:] for x in xs])
    for r in res:
        np.testing.assert_array_max_ulp(r["psum"].numpy(), want, maxulp=1)
        np.testing.assert_array_max_ulp(r["tree"]["a"].numpy(), want_a, maxulp=1)
        np.testing.assert_array_max_ulp(r["tree"]["b"][0].numpy(), want_b, maxulp=1)
        assert r["tree"]["c"] is None
        # the counter's collective rules: two all-reduces (the int32 payload,
        # the scale), each 2 x its result's bytes
        assert r["coll"] == ({"all-reduce": 2.0 * (4 * n + 4)}, {"all-reduce": 2})
    s = [float(jcoll.quantize_int8(jnp.asarray(x))[1]) for x in xs]
    assert max(s) > min(s)                # the scales differ: the largest one matters


def moe_setup(seed=0):
    """The tiny moonshot's MoE in f32 (4 experts, top 2, one shared), the
    reference's init from ``seed``, and an input of 24 tokens."""
    jcfg = jax_tiny_config(jax_get_config("moonshot-v1-16b-a3b")).with_overrides(
        param_dtype="float32")
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree.map(np.asarray, jp), x


def _expert_parallel(rank, world, jp, x):
    """(No JAX in a forked rank: the reference's weights come as NumPy.)"""
    cfg = tiny_config(get_config("moonshot-v1-16b-a3b")).with_overrides(param_dtype="float32")
    p = from_jax_params(jp, "cpu")
    xt = torch.from_numpy(x)
    ep = moe.ParallelContext(make_host_mesh(world, "cpu"), ("data",), "model")
    assert ep.n_model_shards == world and ep.n_data_shards == 1
    out, aux = moe.moe_ffn(p, cfg, xt, ep)
    res = {"out": out, "aux": aux}
    # one model shard (the data axis takes every rank): the local path
    dp = make_host_mesh(1, "cpu")
    ctx = moe.ParallelContext(dp, ("data",), "model")
    assert ctx.n_model_shards == 1 and ctx.n_data_shards == world
    res["one_shard"] = moe.moe_ffn(p, cfg, xt, ctx)
    return res


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_moe_equals_the_references_shards(tmp_path, world):
    """Every rank of the model axis routes all tokens and runs its E/n
    local experts; the all-reduced sum equals the sum over shards of the
    reference's ``_dispatch_compute_combine`` (called per shard with its
    ``idx * n_local``) plus ``_shared_ffn``, within 2e-5; aux equal; one
    model shard is the local path bit for bit."""
    jcfg, jp, x = moe_setup()
    cfg = tiny_config(get_config("moonshot-v1-16b-a3b")).with_overrides(param_dtype="float32")
    E, d = jcfg.moe.n_experts, jcfg.d_model
    n_local = E // world
    xf = jnp.asarray(x.reshape(-1, d))
    gates, ids, jaux = jmoe._route(jnp.asarray(jp["router"]), xf, jcfg)
    cap = jmoe.capacity(xf.shape[0], jcfg)
    want = sum(jmoe._dispatch_compute_combine(
        xf, gates, ids, *(jnp.asarray(jp[k][i * n_local:(i + 1) * n_local])
                          for k in ("w_gate", "w_up", "w_down")),
        i * n_local, n_local, cap, jcfg.act) for i in range(world))
    want = np.asarray(want + jmoe._shared_ffn(jax.tree.map(jnp.asarray, jp), jcfg, xf))
    local_out, local_aux = moe.moe_ffn_local(from_jax_params(jp, "cpu"), cfg, torch.from_numpy(x))
    assert jcfg.moe.n_shared_experts
    for r in run_group(tmp_path, world, _expert_parallel, jp, x):
        np.testing.assert_allclose(r["out"].numpy().reshape(-1, d), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(r["aux"]), float(jaux), rtol=2e-5, atol=2e-5)
        assert torch.equal(r["one_shard"][0], local_out)
        assert torch.equal(r["one_shard"][1], local_aux)
    assert moe.moe_ffn(from_jax_params(jp, "cpu"), cfg, torch.from_numpy(x),
                       moe.LOCAL_CTX)[0].equal(local_out)


# ------------------------------ pipeline ------------------------------ #
L_LAYERS, D_MODEL, N_MICRO, MB = 8, 16, 6, 5


def gpipe_inputs():
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((L_LAYERS, D_MODEL, D_MODEL)) * 0.3).astype(np.float32)
    mbs = rng.standard_normal((N_MICRO, MB, D_MODEL)).astype(np.float32)
    return Ws, mbs


def layer_block(params, x):          # params: (L/4, D, D)
    for w in params:
        x = torch.tanh(x @ w)
    return x


def _gpipe(rank, world):
    Ws, mbs = gpipe_inputs()
    mesh = make_mesh((world,), ("pod",), "cpu")
    stage = pipeline.split_stages(torch.from_numpy(Ws), world).requires_grad_()
    out = pipeline.pipeline_apply(mesh, "pod", layer_block, stage, torch.from_numpy(mbs))
    (out ** 2).sum().backward()
    return {"out": out.detach(), "grad": stage.grad[rank]}


def test_gpipe_matches_the_serial_stack_and_the_reference(tmp_path):
    """4 gloo ranks, 8 layers of 16, 6 microbatches of 5, the reference
    test's ``layer_block``: the output within 2e-5 and each stage's
    gradients within 2e-4 of the serial stack, in torch and in JAX."""
    Ws, mbs = gpipe_inputs()
    w = torch.from_numpy(Ws).requires_grad_()
    serial = torch.stack([layer_block(w, m) for m in torch.from_numpy(mbs)])
    (serial ** 2).sum().backward()

    def jblock(params, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, x, params)[0]

    def jserial(w, m):
        return jax.vmap(lambda x: jblock(w, x))(m)

    jout = np.asarray(jserial(jnp.asarray(Ws), jnp.asarray(mbs)))
    jgrad = np.asarray(jax.grad(lambda w, m: jnp.sum(jserial(w, m) ** 2))(
        jnp.asarray(Ws), jnp.asarray(mbs)))
    res = run_group(tmp_path, 4, _gpipe)
    per = L_LAYERS // 4
    for rank, r in enumerate(res):
        for want in (serial.detach().numpy(), jout):
            np.testing.assert_allclose(r["out"].numpy(), want, rtol=2e-5, atol=2e-5)
        for want in (w.grad.numpy(), jgrad):
            np.testing.assert_allclose(r["grad"].numpy(), want[rank * per:(rank + 1) * per],
                                       rtol=2e-4, atol=2e-4)
    assert math.isclose(float(np.abs(res[0]["grad"].numpy()).sum()),
                        float(np.abs(w.grad.numpy()[:per]).sum()), rel_tol=1e-4)
