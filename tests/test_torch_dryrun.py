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
from repro_torch.launch import profile as tlaunch_profile
from repro_torch.models.ssm import ssd_chunked

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
    with pytest.raises(NotImplementedError, match="A10b"):
        dr.run_cell("qwen3-1.7b", "decode_32k", multi_pod=True, save=False)


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
                          "--results", str(out)])
    got = capsys.readouterr().out
    assert got == want and "colocation plan" in got and len(got.splitlines()) > 5


def test_launch_profile_prices_on_the_card_by_default(records):
    """Without ``--backend`` the driver prices on the torch solver on the
    card: with no card it raises, and prices nothing on the host."""
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    out, _ = records
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch_profile.main(["--results", str(out)])


def test_inspect_cell_top_flop_contributor_is_an_mlp_product(capsys):
    cfg = tiny_config(get_config("qwen3-1.7b"))
    top = inspect_cell.top_contributors(cfg, ShapeConfig("tiny", 32, 2, "prefill"))
    best = max(top["flops"], key=top["flops"].get)
    assert best.startswith("mm") and "layers.mlp" in best
    assert sum(top["flops"].values()) == top["stats"].mxu_flops
    inspect_cell.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--topk", "3"])
    printed = capsys.readouterr().out
    assert "device model h100_nvl" in printed and "top MXU flops" in printed
