"""The port's sharded serving and training surfaces on the CPU:
``Engine(ctx=)``, ``Trainer(ctx=, mesh=, shardings=)`` and the
checkpoint's elastic re-shard (``restore(..., shardings=)``), against the
port's own unsharded runs and the JAX package's.

**The port's side.** Four forked ``gloo`` ranks (``run_group`` from
``tests/test_torch_sharded.py``) build a (2, 2) ``("data", "model")`` mesh
and run tiny configs in f32, their parameters made from a seed by the
reference's ``init`` and carried across through ``from_jax_params``.

**The reference's side.** One subprocess, with the parent's whole
environment plus ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
serves the same prompts on the reference's ``Engine``, unsharded and with a
``ParallelContext`` over a (2, 2) mesh of host devices (``axis_types``
``Auto``), its parameters placed by the reference's ``tp_serve`` specs. The
reference's sharded extend refuses the moe family there: its ``moe_ffn``
maps the chunk's batch of one over the data axis of two (ROADMAP C29), so
the moe engine is held against the reference's unsharded one.

The engines serve four requests into 4 slots of 161 cache rows, as
``tests/test_torch_serve.py``'s cross-package test serves them: the slots
split over the data axis and the odd sequence left whole. A cache that the
model axis splits (160 rows) has a test of its own: the chunks' logits at
2e-5, the bf16 cache within one rounding (the column-split projections
round their last f32 bits otherwise), and the decode step at the
reference's bf16 tolerance,
because the sequence-parallel decode over a bf16 cache rounds each rank's
unnormalised weights to bf16 where one device rounds the normalised ones
(ROADMAP C27).

Tolerances: f32 at rtol = atol = 2e-5; checkpoints bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.core import H100
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.moe import ParallelContext
from repro_torch.parallel import sharding as shd
from repro_torch.serve import Engine, EngineConfig
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded import _flat, _full, _unflat, run_group  # noqa: E402

QWEN3, MOONSHOT = "qwen3-1.7b", "moonshot-v1-16b-a3b"
CAPACITY = {QWEN3: None, MOONSHOT: 0.3}       # moonshot's experts drop tokens
LENGTHS = (9, 70, 41, 120)
ENGINE = dict(max_slots=4, max_len=160, prefill_chunk=32, mode="interference_aware",
              tbt_slo_ms=1e-6)
F32 = dict(rtol=2e-5, atol=2e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=2e-5)       # one rounding of a bf16 cache leaf
BF16 = dict(rtol=0.15, atol=0.3)

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp
    from repro.configs.registry import get_config, tiny_config
    from repro.core import H100
    from repro.models.moe import ParallelContext
    from repro.parallel import sharding as shd
    from repro.serve import Engine, EngineConfig

    def serve(eng, prompts):
        eng.submit(prompts[0], max_new=12)
        for _ in range(3):
            eng.step()
        for p in prompts[1:]:
            eng.submit(p, max_new=6)
        m = eng.run_until_done()
        return ({i: m[i]["output"] for i in m},
                [(e.kind, e.detail.get("chunk"), e.detail.get("colocated_decodes"),
                  e.detail.get("batch")) for e in eng.events])

    inputs = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ctx = ParallelContext(mesh, shd.data_axes_of(mesh), "model")
    out = {}
    for arch, (params, prompts, kw, cf) in inputs.items():
        cfg = tiny_config(get_config(arch)).with_overrides(param_dtype="float32",
                                                            attn_impl="reference")
        if cf is not None:
            cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        params = jax.tree.map(jnp.asarray, params)
        out[arch] = {"plain": serve(Engine(cfg, params=params, ecfg=EngineConfig(**kw),
                                           dev=H100), prompts)}
        placed = jax.device_put(params, shd.named(mesh, shd.param_specs(cfg, "tp_serve", mesh,
                                                                       params)))
        try:
            out[arch]["sharded"] = serve(Engine(cfg, params=placed, ecfg=EngineConfig(**kw),
                                                ctx=ctx, dev=H100), prompts)
        except ValueError as e:
            out[arch]["sharded"] = "refused: " + str(e)[:400]
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("REFERENCE_DONE")
""")


def _serve(eng, prompts):
    """The cross-package test's pattern: the first request is decoding when
    the others arrive. Returns (outputs by request, the event trace)."""
    eng.submit(prompts[0], max_new=12)
    for _ in range(3):
        eng.step()
    for p in prompts[1:]:
        eng.submit(p, max_new=6)
    m = eng.run_until_done()
    return ({i: m[i]["output"] for i in m},
            [(e.kind, e.detail.get("chunk"), e.detail.get("colocated_decodes"),
              e.detail.get("batch")) for e in eng.events])


def _cfg(arch):
    cfg = tiny_config(get_config(arch)).with_overrides(param_dtype="float32")
    cf = CAPACITY[arch]
    return cfg if cf is None else cfg.with_overrides(
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def inputs():
    """{arch: (the reference's f32 parameters as NumPy, prompts)}: the seeds
    of ``tests/test_torch_serve.py``'s cross-package engine test, which
    holds the two unsharded engines to the same tokens."""
    out = {}
    for arch in (QWEN3, MOONSHOT):
        jcfg = jax_tiny_config(jax_get_config(arch)).with_overrides(param_dtype="float32")
        params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(5)
        out[arch] = (params, [rng.integers(1, jcfg.vocab_size, size=n).tolist()
                              for n in LENGTHS])
    return out


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surfaces_ref")
    src, dst = tmp / "inputs.pkl", tmp / "outputs.pkl"
    src.write_bytes(pickle.dumps({a: (p, pr, ENGINE, CAPACITY[a])
                                  for a, (p, pr) in inputs.items()}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, ["src", env.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(src), str(dst)],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=Path(__file__).resolve().parents[1])
    assert "REFERENCE_DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return pickle.loads(dst.read_bytes())


# ------------------------------- engines ------------------------------- #
def _mesh_ctx(shape=(2, 2)):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    return mesh, ParallelContext(mesh, shd.data_axes_of(mesh), "model")


def _engines(rank, world, inputs):
    """Each arch served by the unsharded port engine and by ``Engine(ctx=)``
    on the (2, 2) mesh, with the sharded engine's placements; then qwen3's
    steps over a cache whose sequence the model axis splits."""
    mesh, ctx = _mesh_ctx()
    out = {}
    for arch, (params_np, prompts) in inputs.items():
        cfg = _cfg(arch)
        params = from_jax_params(params_np, "cpu")
        plain = Engine(cfg, params=params, ecfg=EngineConfig(**ENGINE), dev=H100, device="cpu")
        eng = Engine(cfg, params=params, ecfg=EngineConfig(**ENGINE), dev=H100, device="cpu",
                     ctx=ctx)
        want_cache = shd.named(mesh, shd.cache_specs(cfg, "tp_serve", mesh, eng.cache))
        want_params = shd.named(mesh, shd.param_specs(cfg, "tp_serve", mesh, params))
        out[arch] = {
            "plain": _serve(plain, prompts), "sharded": _serve(eng, prompts),
            "placed": (_placements(eng.cache) == _pl_leaves(want_cache)
                       and _placements(eng.params) == _pl_leaves(want_params)),
            "ctx": eng.ctx is ctx}
    out["split_sequence"] = _split_sequence(mesh, ctx, inputs[QWEN3][0])
    return out if rank == 0 else None


def _placements(tree) -> list:
    """The placements of a tree's DTensor leaves, in ``leaves`` order."""
    return [tuple(t.placements) for t in leaves(tree)]


def _pl_leaves(tree) -> list:
    """The placements of a tree ``shd.named`` gives, in ``leaves`` order (a
    leaf is a tuple of placements)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pl_leaves(tree[k])]
    if isinstance(tree, tuple) and all(type(p).__name__ in ("Shard", "Replicate") for p in tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _pl_leaves(v)]
    return []


def _split_sequence(mesh, ctx, params_np):
    """qwen3's extend and decode steps over 160 cache rows, which the model
    axis splits in two blocks of 80: chunks of slots in both data blocks,
    one across the blocks' boundary, a bucket padded past its chunk; each
    chunk's logits and the whole cache against the unsharded engine's, then
    one decode step of every slot."""
    cfg = _cfg(QWEN3)
    params = from_jax_params(params_np, "cpu")
    kw = dict(ENGINE, max_len=159)
    plain = Engine(cfg, params=params, ecfg=EngineConfig(**kw), device="cpu")
    eng = Engine(cfg, params=params, ecfg=EngineConfig(**kw), device="cpu", ctx=ctx)
    seq = [i for i, p in enumerate(eng.cache["k"].placements) if getattr(p, "dim", None) == 2]
    tok = np.random.default_rng(9).integers(1, cfg.vocab_size, size=160)
    got = {"sequence_split": [mesh.mesh_dim_names[i] for i in seq]}
    for slot, pos0, c in ((0, 0, 9), (3, 0, 64), (3, 64, 32), (1, 0, 7), (2, 40, 100)):
        a = plain._extend(tok[pos0:pos0 + c], slot, pos0).clone()
        got[f"extend {slot} {pos0} {c}"] = (a, eng._extend(tok[pos0:pos0 + c], slot, pos0).clone())
    rows = slice(0, kw["max_len"])                  # the trash position aside
    got["cache"] = {k: (plain.cache[k][:, :, rows].clone(), eng.cache[k].full_tensor()[:, :, rows])
                    for k in ("k", "v")}
    toks, pos = np.array([3, 5, 7, 9]), np.array([9, 7, 140, 96])
    got["decode"] = (plain._decode(toks, pos).clone(), eng._decode(toks, pos).clone())
    return got


@pytest.fixture(scope="module")
def engines(inputs, tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("engines"), 4, _engines, inputs)[0]


@pytest.mark.parametrize("arch", [QWEN3, MOONSHOT])
def test_sharded_engine_gives_the_unsharded_and_the_references_tokens_and_chunks(
        engines, reference, arch):
    got = engines[arch]
    assert got["ctx"] and got["placed"]
    outputs, trace = got["sharded"]
    assert sorted(outputs) == list(range(len(LENGTHS)))
    assert (outputs, trace) == got["plain"]
    chunks = [c for kind, c, _, _ in trace if kind == "prefill_chunk"]
    assert any(c & (c - 1) for c in chunks)          # a chunk was padded to its bucket
    ref = reference[arch]
    if arch == MOONSHOT:
        # ROADMAP C29: the reference's extend hands a batch of one to its
        # moe_ffn's shard_map over a data axis of two
        assert ref["sharded"].startswith("refused: ") and "evenly divisible" in ref["sharded"]
        want = ref["plain"]
    else:
        want = ref["sharded"]
        assert want == ref["plain"]
    assert outputs == want[0]
    assert trace == want[1]


def test_sharded_engine_over_a_split_sequence_writes_and_reads_the_cache(engines):
    got = dict(engines["split_sequence"])
    assert got.pop("sequence_split") == ["model"]
    want, dec = got.pop("decode")
    for name, (a, b) in got.pop("cache").items():
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), err_msg=name,
                                   **BF16_ULP)
    for name, (a, b) in got.items():
        np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=name, **F32)
    np.testing.assert_allclose(dec.numpy(), want.numpy(), **BF16)


# --------------------------- trainer, checkpoint --------------------------- #
def _shardings(cfg, recipe, mesh, params, state, batch=None):
    out = {"params": shd.named(mesh, shd.param_specs(cfg, recipe, mesh, params)),
           "opt": shd.named(mesh, shd.param_specs(cfg, recipe, mesh, state))}
    if batch is not None:
        da = shd.data_axes_of(mesh)
        specs = shd.batch_specs(cfg, recipe, mesh, "train")
        out["batch"] = shd.named(mesh, shd.sanitize_tree(
            {k: specs.get(k, (da, None)) for k in batch}, batch, mesh))
    return out


def _whole(tree, prefix: str = "") -> dict:
    """{path: the leaf's whole value, a plain copy} of a nest of dicts,
    tuples and lists."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for i, t in items
                for k, v in _whole(t, f"{prefix}/{i}" if prefix else str(i)).items()}
    return {prefix: _full(tree).detach().clone()}


def _train_and_restore(rank, world, params_np, ref_dir, ckpt_dir):
    """Two ``Trainer.fit`` steps unsharded and under ``fsdp_tp`` on (2, 2)
    with a checkpoint; the checkpoint restored by a second trainer, onto a
    (1, 4) mesh under ``tp_serve`` and onto one device; shardings that do
    not fit, refused; the reference's checkpoint restored through
    ``shardings``; and the KV projection of
    ROADMAP C21 on (1, 4), where each rank's query head reads one of the
    two KV heads."""
    cfg = _cfg(QWEN3)
    m = build_model(cfg, device="cpu")
    params = from_jax_params(params_np, "cpu")
    mesh, ctx = _mesh_ctx()
    run = RunConfig(num_microbatches=2)
    dcfg = DataConfig(seq_len=8, global_batch=4, vocab_size=cfg.vocab_size, seed=0)
    tcfg = TrainerConfig(total_steps=2, log_every=1, optimizer="adamw")
    plain = Trainer(m, run, tcfg)
    p_plain, _, h_plain = plain.fit(SyntheticLM(cfg, dcfg), params=from_jax_params(params_np, "cpu"),
                                    opt_state=plain.opt.init(params))
    state = plain.opt.init(params)
    shardings = _shardings(cfg, "fsdp_tp", mesh, params, state, SyntheticLM(cfg, dcfg).batch_at(0))
    tr = Trainer(m, run, dataclasses.replace(tcfg, checkpoint_dir=ckpt_dir), ctx=ctx, mesh=mesh,
                 shardings=shardings)
    p_shd, o_shd, h_shd = tr.fit(SyntheticLM(cfg, dcfg), params=from_jax_params(params_np, "cpu"),
                                 opt_state=tr.opt.init(params))
    out = {"train": (h_plain, h_shd, _whole(p_plain), _whole(p_shd)),
           "placed": _placements((p_shd, o_shd))
           == _pl_leaves((shardings["params"], shardings["opt"]))}
    saved = _whole((p_shd, o_shd))
    gen = torch.Generator().manual_seed(1)
    resumed = Trainer(m, run, dataclasses.replace(tcfg, checkpoint_dir=ckpt_dir), ctx=ctx,
                      mesh=mesh, shardings=shardings)
    start, rp, ro = resumed.restore_or_init(gen)
    out["resumed"] = (start, saved, _whole((rp, ro)))
    mesh14, _ = _mesh_ctx((1, 4))
    sh14 = _shardings(cfg, "tp_serve", mesh14, params, state)
    like = (shd.place(params, mesh14, sh14["params"]), shd.place(state, mesh14, sh14["opt"]))
    step, tree = CheckpointManager(ckpt_dir).restore_latest(
        like=like, shardings=(sh14["params"], sh14["opt"]))
    out["onto (1, 4) tp_serve"] = (step, saved, _whole(tree),
                                   _placements(tree) == _placements(like))
    step, tree = CheckpointManager(ckpt_dir).restore_latest(like=(params, state))
    out["onto one device"] = (step, saved, _whole(tree), not any(
        type(t).__name__ == "DTensor" for t in leaves(tree)))
    misplaced = []
    for bad_like, bad in (((params, state), (sh14["params"], sh14["opt"])),   # on no mesh
                          (like, sh14["params"])):                            # nested otherwise
        try:
            CheckpointManager(ckpt_dir).restore_latest(like=bad_like, shardings=bad)
        except (ValueError, KeyError) as e:
            misplaced.append(type(e).__name__)
        else:
            misplaced.append(None)
    out["misplaced"] = misplaced
    like = shd.place(params, mesh, shardings["params"])
    step, tree = CheckpointManager(ref_dir).restore_latest(like=like,
                                                           shardings=shardings["params"])
    out["the reference's onto (2, 2) fsdp_tp"] = (step, _whole(params), _whole(tree),
                                                  _placements(tree) == _placements(like))
    out["c21"] = _kv_projection_split(cfg, m, params, mesh14)
    return out if rank == 0 else None


def _kv_projection_split(cfg, m, params, mesh14):
    """The forward of a prefill-sized batch under ``tp_serve`` (each rank
    projects its quarter of the KV columns) and an ``fsdp_tp`` train step
    (the weights' gradients split), on (1, 4), against one device; and
    how often the split path ran."""
    calls = []
    orig = attn._columns

    def spy(t, dims, split):
        calls.append(split)
        return orig(t, dims, split)
    attn._columns = spy
    try:
        ctx = ParallelContext(mesh14, shd.data_axes_of(mesh14), "model")
        tok = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16)))
        with torch.no_grad():
            want = m.forward(params, {"tokens": tok})
            got = _full(m.forward(shd.place(params, mesh14, shd.named(mesh14, shd.param_specs(
                cfg, "tp_serve", mesh14, params))), {"tokens": tok}, ctx))
        n_fwd = len(calls)
        opt = get_optimizer("adamw")
        batch = {"tokens": tok[:, :8], "labels": tok[:, 1:9]}
        state = opt.init(params)
        sh = _shardings(cfg, "fsdp_tp", mesh14, params, state)
        plain = {k: v.clone() for k, v in _flat(params).items()}
        _, _, w = make_train_step(m, opt, RunConfig(num_microbatches=2))(
            _unflat(plain), opt.init(params), batch)
        da = shd.data_axes_of(mesh14)
        placed = {k: shd.distribute(v, mesh14, shd.sanitize((da, None), v.shape, mesh14))
                  for k, v in batch.items()}
        new, _, g = make_train_step(m, opt, RunConfig(num_microbatches=2), ctx)(
            shd.place(params, mesh14, sh["params"]), shd.place(state, mesh14, sh["opt"]), placed)
    finally:
        attn._columns = orig
    return {"forward": (want, got), "n_forward": n_fwd, "n_train": len(calls) - n_fwd,
            "loss": (float(w["loss"]), float(_full(g["loss"]))),
            "params": (plain, _whole(new))}


@pytest.fixture(scope="module")
def trained(inputs, tmp_path_factory):
    params_np = inputs[QWEN3][0]
    ref_dir = tmp_path_factory.mktemp("reference_ckpt")
    JaxCheckpointManager(str(ref_dir)).save(3, jax.tree.map(jax.numpy.asarray, params_np),
                                            block=True)
    ckpt = tmp_path_factory.mktemp("sharded_ckpt")
    return run_group(tmp_path_factory.mktemp("trainer"), 4, _train_and_restore, params_np,
                     str(ref_dir), str(ckpt))[0]


def test_sharded_trainer_fits_as_the_unsharded_one(trained):
    h_plain, h_shd, want, got = trained["train"]
    assert trained["placed"]
    assert [s for s, _, _ in h_shd] == [s for s, _, _ in h_plain] == [0, 1]
    np.testing.assert_allclose([l for _, l, _ in h_shd], [l for _, l, _ in h_plain], **F32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **F32)
    start, saved, restored = trained["resumed"]
    assert start == 2
    for k in saved:
        assert torch.equal(restored[k], saved[k]), k


@pytest.mark.parametrize("where", ["onto (1, 4) tp_serve", "onto one device",
                                   "the reference's onto (2, 2) fsdp_tp"])
def test_checkpoint_restores_onto_another_mesh_bit_for_bit(trained, where):
    step, want, got, placed = trained[where]
    assert step == (3 if "reference" in where else 1) and placed
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_shardings_that_do_not_fit_raise_instead_of_skipping_checkpoints(trained):
    """A ``like`` on no mesh, and shardings nested otherwise than ``like``,
    raise from ``restore_latest``: they are no unreadable checkpoint to
    fall back from (which would return None, and a trainer start over)."""
    assert trained["misplaced"] == ["ValueError", "KeyError"]


def test_kv_projection_split_where_ranks_read_a_subset_of_the_kv_heads(trained):
    got = trained["c21"]
    assert got["n_forward"] > 0 and got["n_train"] > 0
    want, out = got["forward"]
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32)
    assert got["loss"][1] == pytest.approx(got["loss"][0], rel=2e-5, abs=2e-5)
    plain, new = got["params"]
    for k in plain:
        np.testing.assert_allclose(new[k].numpy(), plain[k].numpy(), err_msg=k, **F32)
