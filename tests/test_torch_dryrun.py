"""The port's dry run (``repro_torch.core.hlo``'s counter,
``launch/dryrun.py``, ``launch/profile.py``, ``launch/inspect_cell.py``)
against the JAX package's, on the CPU.

**Where the reference's count comes from.** A subprocess, with the
parent's whole environment plus ``XLA_FLAGS=--xla_dump_to=<tmp_path>``,
jits each step in the reference's jnp code (``attn_impl="flashref"``) on
one device, lowers and compiles it on abstract inputs, and runs
``repro.core.hlo.analyze`` over the ``*before_optimizations.txt`` dump. On
one device XLA runs no SPMD pass, so there is no after-SPMD dump; the
before-optimisation module is the same pre-fusion module the reference's
dry run reads (``analyze(compiled.as_text())`` would read the fused model
instead). The test process never imports ``repro.launch.dryrun``: it sets
``XLA_FLAGS`` at import.

Held: ``mxu_flops`` within 1% (T a multiple of the attention chunk, which
``flashref_attention`` pads to), ``hbm_bytes`` within a factor of 2, no
collective on either side.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.core import profile as jprofile
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.core import TPU_V5E, hlo, roofline
from repro_torch.core import profile as tprofile
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import ssm_scan as ssm_mod
from repro_torch.launch import dryrun as dr
from repro_torch.launch import inspect_cell
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import profile as tlaunch_profile
from repro_torch.models.ssm import ssd_chunked
from repro_torch.parallel import sharding as shd

ARCHS = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b", "gemma3": "gemma3-1b",
         "ssm": "falcon-mamba-7b"}
# (batch, sequence, microbatches) a kind; 32 positions: one flashref chunk
SIZES = {"prefill": (2, 32, 1), "decode": (2, 32, 1), "train": (4, 32, 2)}

REFERENCE = textwrap.dedent("""
    import glob, json, os, sys
    import jax, jax.numpy as jnp
    from repro.configs.base import RunConfig
    from repro.configs.registry import get_config, tiny_config
    from repro.core import hlo
    from repro.models import build_model
    from repro.train.optimizer import get_optimizer
    from repro.train.trainer import make_train_step

    dump = sys.argv[2]
    out = {}
    for arch, kind, B, S, mb in json.loads(sys.argv[1]):
        cfg = tiny_config(get_config(arch)).with_overrides(attn_impl="flashref")
        model = build_model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        f = jax.ShapeDtypeStruct
        name = kind + "_" + arch.replace("-", "_").replace(".", "_")
        if kind == "prefill":
            def step(p, batch):
                return model.prefill(p, batch, S)
            args = (params, {"tokens": f((B, S), jnp.int32)})
        elif kind == "decode":
            def step(p, tokens, cache, pos):
                return model.decode_step(p, tokens, cache, pos)
            args = (params, f((B, 1), jnp.int32), model.init_cache(B, S, abstract=True),
                    f((), jnp.int32))
        else:
            opt = get_optimizer("adamw")
            step = make_train_step(model, opt, RunConfig(num_microbatches=mb))
            args = (params, jax.eval_shape(opt.init, params),
                    {"tokens": f((B, S), jnp.int32), "labels": f((B, S), jnp.int32)})
        step.__name__ = step.__qualname__ = name
        jax.jit(step).lower(*args).compile()
        files = glob.glob(f"{dump}/*jit_{name}.before_optimizations.txt")
        assert len(files) == 1, (name, files)
        st = hlo.analyze(open(files[0]).read())
        out[arch + "/" + kind] = {"mxu_flops": st.mxu_flops, "hbm_bytes": st.hbm_bytes,
                                  "coll": st.collective_bytes}
    print("REFERENCE_COUNTS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_counts(tmp_path_factory):
    dump = tmp_path_factory.mktemp("xla_dump")
    cases = [[arch, kind, *SIZES[kind]] for arch in ARCHS.values() for kind in SIZES]
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={dump}")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, ["src", env.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(cases), str(dump)],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=Path(__file__).resolve().parents[1])
    assert "REFERENCE_COUNTS " in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.split("REFERENCE_COUNTS ", 1)[1])


@pytest.mark.parametrize("kind", list(SIZES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_counts_match_the_references_hlo(reference_counts, family, kind):
    arch = ARCHS[family]
    B, S, mb = SIZES[kind]
    cfg = tiny_config(get_config(arch)).with_overrides(attn_impl="flashref")
    st = dr.count_cell(cfg, ShapeConfig("tiny", S, B, kind), RunConfig(num_microbatches=mb))[0].stats
    want = reference_counts[f"{arch}/{kind}"]
    assert st.mxu_flops == pytest.approx(want["mxu_flops"], rel=0.01)
    assert 0.5 <= st.hbm_bytes / want["hbm_bytes"] <= 2.0
    assert st.collective_bytes == want["coll"] == 0


# reference's record, dryrun.py:202-235, key for key
SCHEMA = {"arch", "shape", "kind", "mesh", "n_chips", "recipe", "multi_pod", "tag", "run",
          "n_params", "n_active_params", "lower_s", "compile_s", "memory", "cost",
          "hlo_exec", "collectives", "hlo_size_chars"}
SUB = {"run": {"num_microbatches", "optimizer", "remat", "recipe"},
       "memory": {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                  "generated_code_bytes"},
       "cost": {"flops", "bytes_accessed", "transcendentals"},
       "hlo_exec": {"mxu_flops", "vpu_flops", "transcendentals", "hbm_bytes",
                    "hbm_bytes_boundary", "source"},
       "collectives": {"bytes_by_kind", "count_by_kind", "total_bytes"}}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Full-size one-device records of three cells, written by ``run_cell``."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = [dr.run_cell(a, s, results=out) for a, s in
            (("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "prefill_32k"),
             ("gemma3-1b", "decode_32k"))]
    return out, recs


def test_record_has_the_reference_schema_and_feeds_its_readers(records):
    out, recs = records
    assert sorted(p.name for p in out.iterdir()) == [
        "gemma3-1b__decode_32k__dev1.json", "qwen3-1.7b__decode_32k__dev1.json",
        "qwen3-1.7b__prefill_32k__dev1.json"]
    for rec in recs:
        assert set(rec) == SCHEMA
        for k, keys in SUB.items():
            assert set(rec[k]) == keys, k
        assert rec["mesh"] == {"data": 1, "model": 1} and rec["n_chips"] == 1
        assert rec["collectives"]["total_bytes"] == 0
        assert json.loads((out / dr.cell_file(rec["arch"], rec["shape"])).read_text()) == rec
        want, got = jprofile.from_dryrun_json(rec), tprofile.from_dryrun_json(rec)
        assert got.name == want.name and got.demand == want.demand
        row = roofline.analyze_record(rec)
        assert row.hlo_flops == rec["hlo_exec"]["mxu_flops"] and row.compute_s > 0
    pod2 = dr.run_cell("qwen3-1.7b", "decode_32k", multi_pod=True, save=False)
    assert set(pod2) == SCHEMA and pod2["multi_pod"] and pod2["n_chips"] == 512
    assert pod2["mesh"] == {"pod": 2, "data": 16, "model": 16}


def test_from_hlo_stats_is_the_references_builder():
    st = hlo.ModuleStats(mxu_flops=3e12, vpu_elems=5e9, transcendentals=1e8, hbm_bytes=7e10,
                         coll_bytes_by_kind={"all-reduce": 2e9})
    got, want = tprofile.from_hlo_stats("p", st), jprofile.from_hlo_stats("p", st)
    assert got.demand == want.demand
    assert tprofile._issue_demand(3e12, 5e9) == jprofile._issue_demand(3e12, 5e9)


def test_decode_flops_are_the_hand_count():
    """One decode step's products: 2 B x (the products' weight elements,
    unembedding included) + 4 B H D T L for attention over the whole cache."""
    cfg = get_config("llama3.1-8b")
    rec = dr.run_cell(cfg.name, dr.ENGINE_DECODE, save=False)
    a, B, T = cfg.attn, dr.ENGINE_DECODE.global_batch, dr.ENGINE_DECODE.seq_len
    per_layer = cfg.d_model * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim \
        + a.n_heads * a.head_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    weights = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    want = 2 * B * weights + 4 * B * a.n_heads * a.head_dim * T * cfg.n_layers
    assert rec["hlo_exec"]["mxu_flops"] == pytest.approx(want, rel=1e-3)


def test_loop_multiplicity_counts_as_the_unrolled_loop():
    """At a small S the scan's and the SSD's loops counted from one
    iteration (``hlo.steps`` on meta) give the unrolled loop's counts (on
    the CPU), forward exactly; under autograd the backward's products too
    (the elementwise sums of the gradients over the steps differ)."""
    def scan(dev, grad):
        x = torch.zeros(2, 8, 16, device=dev, requires_grad=grad)
        A = torch.zeros(16, 4, device=dev)
        Bc = torch.zeros(2, 8, 4, device=dev)
        y, h = ssm_mod.ssm_scan_plain(x, x, A, Bc, Bc)
        if grad:
            y.sum().backward()
        return y

    def ssd(dev, grad):
        x = torch.zeros(2, 40, 4, 8, device=dev, requires_grad=grad)
        y, h = ssd_chunked(x, torch.zeros(2, 40, 4, device=dev), torch.zeros(4, device=dev),
                           torch.zeros(2, 40, 6, device=dev), torch.zeros(2, 40, 6, device=dev), 8)
        if grad:
            y.sum().backward()
        return y

    for fn in (scan, ssd):
        for grad in (False, True):
            counted = {}
            for dev in ("cpu", "meta"):
                with hlo.Counter() as c:
                    y = fn(dev, grad)
                counted[dev] = c.stats
                assert y.device.type == dev
            cpu, meta = counted["cpu"], counted["meta"]
            assert meta.mxu_flops == cpu.mxu_flops > 0
            if not grad:
                assert (meta.vpu_elems, meta.transcendentals, meta.hbm_bytes) == \
                    (cpu.vpu_elems, cpu.transcendentals, cpu.hbm_bytes)
    with hlo.Counter() as c:
        with c.loop(3):
            torch.zeros(4, 5, device="meta") @ torch.zeros(5, 6, device="meta")
    assert c.stats.mxu_flops == 3 * 2 * 4 * 5 * 6


def test_meta_tensors_take_the_plain_versions():
    """A ``meta`` tensor goes to each wrapper's plain version (shapes only),
    as a CPU tensor does; no kernel is launched."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    before = [m.launches for m in (rms_mod.rmsnorm, fa_mod.flash_attention,
                                   dec_mod.flash_decode, ssm_mod.ssm_scan)]
    y = ops.rmsnorm(torch.empty(3, 64, **meta), torch.empty(64, device="meta"))
    assert (y.device.type, y.shape, y.dtype) == ("meta", (3, 64), torch.bfloat16)
    q, kv = torch.empty(2, 8, 4, 16, **meta), torch.empty(2, 8, 2, 16, **meta)
    assert ops.flash_attention(q, kv, kv).shape == (2, 8, 4, 16)
    qd = torch.empty(2, 1, 4, 16, **meta)
    assert ops.flash_decode(qd, kv, kv, torch.empty(2, dtype=torch.int64, device="meta")
                            ).shape == (2, 1, 4, 16)
    x = torch.empty(1, 5, 8, **meta)
    f32 = dict(device="meta", dtype=torch.float32)
    assert ops.ssm_scan(x, torch.empty(1, 5, 8, **f32), torch.empty(8, 4, **f32),
                        torch.empty(1, 5, 4, **f32), torch.empty(1, 5, 4, **f32)).shape == (1, 5, 8)
    assert before == [m.launches for m in (rms_mod.rmsnorm, fa_mod.flash_attention,
                                           dec_mod.flash_decode, ssm_mod.ssm_scan)]


def test_launch_profile_prints_the_references_fingerprints_and_plan(records, tmp_path,
                                                                      monkeypatch, capsys):
    """The same records, priced on ``TPU_V5E`` on the NumPy backend: the
    reference's ``repro.launch.profile`` output, byte for byte."""
    from repro.launch import profile as jlaunch_profile
    out, recs = records
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for rec in recs:
        (ref_dir / f"{rec['arch']}__{rec['shape']}__pod1.json").write_text(json.dumps(rec))
    monkeypatch.setattr(jlaunch_profile, "RESULTS", ref_dir)
    jlaunch_profile.main(["--plan"])
    want = capsys.readouterr().out
    tlaunch_profile.main(["--plan", "--device", TPU_V5E.name, "--backend", "numpy",
                          "--results", str(out), "--mesh", "dev1"])
    got = capsys.readouterr().out
    assert got == want and "colocation plan" in got and len(got.splitlines()) > 5


def test_launch_profile_prices_on_the_card_by_default(records):
    """Without ``--backend`` the driver prices on the torch solver on the
    card: with no card it raises, and prices nothing on the host."""
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    out, _ = records
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch_profile.main(["--results", str(out), "--mesh", "dev1"])


def test_inspect_cell_top_flop_contributor_is_an_mlp_product(capsys):
    cfg = tiny_config(get_config("qwen3-1.7b"))
    top = inspect_cell.top_contributors(cfg, ShapeConfig("tiny", 32, 2, "prefill"))
    best = max(top["flops"], key=top["flops"].get)
    assert best.startswith("mm") and "layers.mlp" in best
    assert sum(top["flops"].values()) == top["stats"].mxu_flops
    inspect_cell.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--topk", "3"])
    printed = capsys.readouterr().out
    assert "device model h100_nvl" in printed and "top MXU flops" in printed


# ------------------------ one chip of a mesh ------------------------ #
# The reference's per-device count: the same tiny cells jitted on a (2, 2)
# ("data", "model") mesh of four host devices with its dry run's shardings
# (``src/repro/launch/dryrun.py:131-178``: parameters and optimiser state
# by ``param_specs``, the batch by ``batch_specs``, a decode cache by
# ``cache_specs`` and donated, a prefill's cache out by ``cache_specs``),
# the recipe ``pick_recipe``'s, the module read after SPMD partitioning.
REFERENCE_SHARDED = textwrap.dedent("""
    import glob, json, os, sys
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.configs.registry import get_config, tiny_config
    from repro.core import hlo
    from repro.models import build_model
    from repro.models.moe import ParallelContext
    from repro.parallel import sharding as shd
    from repro.train.optimizer import get_optimizer
    from repro.train.trainer import make_train_step

    dump = sys.argv[2]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    da = shd.data_axes_of(mesh)
    f = jax.ShapeDtypeStruct
    out = {}
    for arch, kind, B, S, mb in json.loads(sys.argv[1]):
        cfg = tiny_config(get_config(arch)).with_overrides(attn_impl="flashref")
        recipe = shd.pick_recipe(cfg, ShapeConfig("tiny", S, B, kind))
        ctx = ParallelContext(mesh, da, "model", feature_shard_decode=(recipe == "tp2d_serve"))
        model = build_model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        psh = shd.named(mesh, shd.param_specs(cfg, recipe, mesh, params))
        name = "mesh_" + kind + "_" + arch.replace("-", "_").replace(".", "_")
        if kind == "train":
            opt = get_optimizer("adamw")
            ostate = jax.eval_shape(opt.init, params)
            osh = shd.named(mesh, shd.param_specs(cfg, recipe, mesh, ostate))
            ins = {"tokens": f((B, S), jnp.int32), "labels": f((B, S), jnp.int32)}
            bsh = shd.named(mesh, shd.sanitize_tree({k: shd.batch_specs(
                cfg, recipe, mesh, "train").get(k, P(da, None)) for k in ins}, ins, mesh))
            step = make_train_step(model, opt, RunConfig(num_microbatches=mb), ctx)
            step.__name__ = step.__qualname__ = name
            jax.jit(step, in_shardings=(psh, osh, bsh),
                    out_shardings=(psh, osh, None)).lower(params, ostate, ins).compile()
        elif kind == "prefill":
            def step(p, batch):
                return model.prefill(p, batch, S, ctx)
            step.__name__ = step.__qualname__ = name
            ins = {"tokens": f((B, S), jnp.int32)}
            bsh = shd.named(mesh, shd.sanitize_tree(
                {k: v for k, v in shd.batch_specs(cfg, recipe, mesh, "prefill").items()
                 if k in ins}, ins, mesh))
            o = jax.eval_shape(step, params, ins)
            osh = (None, shd.named(mesh, shd.cache_specs(cfg, recipe, mesh, o[1])))
            jax.jit(step, in_shardings=(psh, bsh), out_shardings=osh).lower(params, ins).compile()
        else:
            def step(p, tokens, cache, pos):
                return model.decode_step(p, tokens, cache, pos, ctx)
            step.__name__ = step.__qualname__ = name
            tokens = f((B, 1), jnp.int32)
            cache = model.init_cache(B, S, abstract=True)
            csh = shd.named(mesh, shd.cache_specs(cfg, recipe, mesh, cache))
            tsh = shd.named(mesh, shd.sanitize(P(da), tokens.shape, mesh))
            jax.jit(step, in_shardings=(psh, tsh, csh, None), out_shardings=(None, csh),
                    donate_argnums=(2,)).lower(params, tokens, cache, f((), jnp.int32)).compile()
        files = glob.glob(f"{dump}/*jit_{name}.*after_spmd-partitioning*.txt")
        assert len(files) == 1, (name, files)
        st = hlo.analyze(open(files[0]).read())
        out[arch + "/" + kind] = {"mxu_flops": st.mxu_flops, "hbm_bytes": st.hbm_bytes,
                                  "coll": st.collective_bytes, "recipe": recipe,
                                  "coll_by_kind": dict(st.coll_bytes_by_kind)}
    print("REFERENCE_COUNTS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_sharded_counts(tmp_path_factory):
    dump = tmp_path_factory.mktemp("xla_dump_spmd")
    cases = [[arch, kind, *SIZES[kind]] for arch in ARCHS.values() for kind in SIZES]
    env = dict(os.environ, XLA_FLAGS=("--xla_force_host_platform_device_count=4 "
                                      f"--xla_dump_to={dump} "
                                      "--xla_dump_hlo_pass_re=spmd-partitioning"))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, ["src", env.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE_SHARDED, json.dumps(cases), str(dump)],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=Path(__file__).resolve().parents[1])
    assert "REFERENCE_COUNTS " in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.split("REFERENCE_COUNTS ", 1)[1])


# the one cell where the reference's collective bytes pass twice the port's
SEQUENCE_PARALLEL_PREFILL = {("dense", "prefill")}


def _count_on_2x2(cfg, kind, recipe):
    """One rank's count of a tiny cell on a (2, 2) mesh of a ``fake`` world."""
    B, S, mb = SIZES[kind]
    with mesh_mod.fake_world(4):
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
        return dr.count_cell(cfg, ShapeConfig("tiny", S, B, kind),
                             RunConfig(num_microbatches=mb), mesh=mesh, recipe=recipe)[0].stats


@pytest.mark.parametrize("kind", list(SIZES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_counts_match_the_references_after_spmd_hlo(reference_sharded_counts,
                                                            family, kind):
    arch = ARCHS[family]
    want = reference_sharded_counts[f"{arch}/{kind}"]
    cfg = tiny_config(get_config(arch)).with_overrides(attn_impl="flashref")
    B, S, _ = SIZES[kind]
    assert shd.pick_recipe(cfg, ShapeConfig("tiny", S, B, kind)) == want["recipe"]
    st = _count_on_2x2(cfg, kind, want["recipe"])
    assert st.mxu_flops == pytest.approx(want["mxu_flops"], rel=0.01)
    assert 0.5 <= st.hbm_bytes / want["hbm_bytes"] <= 2.0
    assert (st.collective_bytes == 0) == (want["coll"] == 0)
    ratio = st.collective_bytes / want["coll"]
    if (family, kind) in SEQUENCE_PARALLEL_PREFILL:
        # ROADMAP C22: the reference's compiler carries the cache's out_sharding
        # (sequence over model) back into the layers; the port runs them as
        # tensor parallelism (its all-reduces) and moves the cache once at the
        # end: k and v, each rank's quarter of (L, B, S, KVH, D) in bf16,
        # gathered and chunked (the CPU mesh's all-to-all, C25). The total is
        # not within 2x of the reference's: C22 tracks it.
        a = cfg.attn
        moved = 2 * cfg.n_layers * B * S * a.n_kv_heads * a.head_dim * 2 // 4
        kinds = {k: v for k, v in st.coll_bytes_by_kind.items() if v}
        all_reduce = kinds.pop("all-reduce") / want["coll_by_kind"]["all-reduce"]
        assert 0.5 <= all_reduce <= 2.0 and kinds == {"all-gather": moved} and ratio <= 1.0, (
            st.coll_bytes_by_kind, want["coll_by_kind"], moved)
    else:
        assert 0.5 <= ratio <= 2.0, (st.coll_bytes_by_kind, want["coll_by_kind"])


def test_a_replicated_tree_shows_a_different_per_device_count(reference_sharded_counts,
                                                              monkeypatch):
    """Planted: the parameters left whole on every rank where ``param_specs``
    splits them over the model axis: the products run whole on each rank,
    and the count must leave the reference's."""
    cfg = tiny_config(get_config(ARCHS["dense"])).with_overrides(attn_impl="flashref")
    want = reference_sharded_counts[f"{ARCHS['dense']}/prefill"]
    honest = _count_on_2x2(cfg, "prefill", want["recipe"])
    assert honest.mxu_flops == pytest.approx(want["mxu_flops"], rel=0.01)
    monkeypatch.setattr(shd, "param_specs", lambda cfg, recipe, mesh, tree: dr.shd._with_paths(
        lambda path, leaf: (), tree))
    planted = _count_on_2x2(cfg, "prefill", want["recipe"])
    assert planted.mxu_flops != pytest.approx(want["mxu_flops"], rel=0.01)


def test_production_meshes_give_pod_records_in_the_references_schema(tmp_path):
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_mod.make_production_mesh()
    got = {}
    for multi_pod in (False, True):
        rec = dr.run_cell("qwen3-1.7b", dr.ENGINE_DECODE, multi_pod=multi_pod, results=tmp_path)
        assert set(rec) == SCHEMA
        got[multi_pod] = rec
    one = dr.run_cell("qwen3-1.7b", dr.ENGINE_DECODE, save=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen3-1.7b__decode_engine__pod1.json", "qwen3-1.7b__decode_engine__pod2.json"]
    assert got[False]["mesh"] == {"data": 16, "model": 16} and got[False]["n_chips"] == 256
    assert got[True]["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert got[True]["n_chips"] == 512 and got[True]["multi_pod"] and not got[False]["multi_pod"]
    for rec in got.values():
        assert rec["recipe"] == one["recipe"] == "tp_serve"
        # 8 sequences over 16 data shards: sanitize leaves the batch whole, so
        # each chip decodes all 8 and splits only the heads and the cache
        assert one["hlo_exec"]["mxu_flops"] / 16 < rec["hlo_exec"]["mxu_flops"] \
            < one["hlo_exec"]["mxu_flops"]
        assert rec["collectives"]["total_bytes"] > 0
        assert tprofile.from_dryrun_json(rec).name == tprofile.from_dryrun_json(one).name


def test_inspect_cell_counts_one_chip_under_a_recipe(capsys):
    inspect_cell.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--recipe", "tp_serve",
                       "--topk", "3"])
    printed = capsys.readouterr().out
    assert "pod1 recipe=tp_serve" in printed and "top collective bytes" in printed
    coll = printed.split("top collective bytes (total ", 1)[1]
    assert float(coll.split()[0]) > 0


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_heads_that_do_not_divide_the_model_axis_count_on_one_chip(shape):
    """gemma-2b's 8 query heads of 256 over a model axis of 16: the
    projection's columns are gathered where their split would cut a head,
    and in training the heads' gradient comes back placed as the forward
    tensor was; each chip then runs the heads whole."""
    one = dr.run_cell("gemma-2b", shape, save=False)
    rec = dr.run_cell("gemma-2b", shape, multi_pod=False, save=False)
    assert rec["n_chips"] == 256 and rec["collectives"]["total_bytes"] > 0
    assert one["hlo_exec"]["mxu_flops"] / 256 < rec["hlo_exec"]["mxu_flops"] \
        < one["hlo_exec"]["mxu_flops"]


# The reference's dry run of full-size cells on its 16x16 mesh of host
# devices (``run_cell`` with a mesh whose axes are ``Auto``: the module's own
# ``make_production_mesh`` builds ``Explicit`` axes under this jax, which its
# sharding constraints refuse). The subprocess imports ``repro.launch.dryrun``,
# which sets its own ``XLA_FLAGS`` (512 host devices) at import.
REFERENCE_POD = textwrap.dedent("""
    import json, sys, tempfile
    from pathlib import Path
    import jax
    from repro.launch import dryrun as dr
    dr.RESULTS = Path(tempfile.mkdtemp())
    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for shape in json.loads(sys.argv[1]):
        r = dr.run_cell("qwen3-1.7b", shape, mesh=mesh, save=False)
        out[shape] = {"mxu_flops": r["hlo_exec"]["mxu_flops"], "hbm_bytes": r["hlo_exec"]["hbm_bytes"],
                      "coll": r["collectives"]["total_bytes"]}
    print("REFERENCE_POD " + json.dumps(out))
""")


def test_one_pod1_chip_of_qwen3_against_the_references_count():
    """qwen3-1.7b at full width on one chip of the 16x16 mesh, the port's
    count against the reference's: the decode step's products within 1%
    and its bytes and collective bytes within 2×; prefill_32k's and
    train_4k's products above the reference's and within 1.5× of them,
    because each chip projects all 8 KV heads where the reference's
    compiler splits the projection over the model axis (ROADMAP C21)."""
    shapes = ["decode_32k", "prefill_32k", "train_4k"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, ["src", env.get("PYTHONPATH")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE_POD, json.dumps(shapes)],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=Path(__file__).resolve().parents[1])
    assert "REFERENCE_POD " in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    want = json.loads(r.stdout.split("REFERENCE_POD ", 1)[1])
    got = {}
    for shape in shapes:
        rec = dr.run_cell("qwen3-1.7b", shape, multi_pod=False, save=False)
        got[shape] = {"mxu_flops": rec["hlo_exec"]["mxu_flops"],
                      "hbm_bytes": rec["hlo_exec"]["hbm_bytes"],
                      "coll": rec["collectives"]["total_bytes"]}
        print(shape, "port", got[shape], "reference", want[shape])
    d, w = got["decode_32k"], want["decode_32k"]
    assert d["mxu_flops"] == pytest.approx(w["mxu_flops"], rel=0.01)
    assert 0.5 <= d["hbm_bytes"] / w["hbm_bytes"] <= 2.0
    assert 0.5 <= d["coll"] / w["coll"] <= 2.0
    for shape in ("prefill_32k", "train_4k"):
        assert 1.0 < got[shape]["mxu_flops"] / want[shape]["mxu_flops"] < 1.5
