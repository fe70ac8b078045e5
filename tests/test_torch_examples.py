"""The twins of the reference's examples (``repro_torch.examples``) against
the examples themselves, on the CPU.

Each reference example runs in this process (``runpy``, stdout captured)
and its twin's ``main`` with ``--device cpu --device-model tpu_v5e``, the
reference's device model. On the NumPy backend the twins of quickstart,
fleet_failover, trace_serving and calibrate_profiles print what the
reference prints, byte for byte. On the torch solver they print the same
words and decisions, every number within one unit of its last printed
digit (``printed_alike``), against the reference run with the fraction
search that the torch backend takes by default, ``DENSE_SEARCH``, as the
reference's own jax backend does (ROADMAP C10). serve_colocation's engine
gives the same chunks, interleaved decode steps and chunk prices;
profile_interference prints the reference's plan over the same dry-run
records; train_tiny_lm takes two steps at the example's own width.
"""
import contextlib
import importlib
import io
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.fracsearch as jfracsearch
from repro.configs.registry import get_config as jax_get_config
from repro.launch import profile as jlaunch_profile
from repro_torch.examples import printed_alike
from repro_torch.launch import dryrun as dr
from repro_torch.launch import profile as tlaunch_profile

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ON_THE_HOST = ["--device", "cpu", "--device-model", "tpu_v5e"]
PRICED = ("quickstart", "fleet_failover", "trace_serving", "calibrate_profiles")
ALL = PRICED + ("serve_colocation", "profile_interference", "train_tiny_lm")


def printout(fn) -> tuple:
    """(what ``fn()`` printed, what it returned)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = fn()
    return out.getvalue(), got


@pytest.fixture(scope="module")
def reference():
    """The reference example's printout by (name, dense): ``dense`` runs it
    with ``DENSE_SEARCH`` as the default fraction search. Each is run once
    for the module."""
    seen = {}

    def run(name, dense=False):
        if (name, dense) not in seen:
            with pytest.MonkeyPatch.context() as mp:
                if dense:
                    mp.setattr(jfracsearch.FractionSearchConfig, "default",
                               classmethod(lambda cls: jfracsearch.DENSE_SEARCH))
                seen[name, dense] = printout(lambda: runpy.run_path(
                    str(EXAMPLES / f"{name}.py"), run_name="__main__"))[0]
        return seen[name, dense]
    return run


def twin(name, *argv) -> tuple:
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    return printout(lambda: mod.main([*ON_THE_HOST, *argv]))


@pytest.mark.parametrize("name", PRICED)
def test_twin_prints_the_reference_byte_for_byte_on_numpy(name, reference):
    got, _ = twin(name, "--backend", "numpy")
    assert got == reference(name) and len(got.splitlines()) > 5


@pytest.mark.parametrize("name", PRICED)
def test_twin_on_the_torch_solver_prints_the_reference_within_its_last_digit(name, reference):
    got, _ = twin(name)
    want = reference(name, dense=True)
    assert printed_alike(got, want), (got, want)


def test_serve_colocation_gives_the_reference_chunks_and_prices(reference):
    got, (i_serial, i_aware, prices) = twin("serve_colocation")
    want = reference("serve_colocation")
    assert printed_alike(got, want), (got, want)
    assert i_serial == 0 and i_aware > i_serial
    assert len(prices) == 4 and np.isfinite(prices).all()


def test_profile_interference_without_records_says_so(tmp_path, monkeypatch, reference):
    monkeypatch.setattr(jlaunch_profile, "RESULTS", tmp_path)
    monkeypatch.setattr(tlaunch_profile, "RESULTS", tmp_path)
    want = reference("profile_interference")
    got, ret = twin("profile_interference", "--backend", "numpy")
    assert ret == (None, None)
    assert got == want.replace("repro.launch", "repro_torch.launch") != want


def test_profile_interference_plans_the_port_s_records(tmp_path, monkeypatch):
    """Over the port's dry-run records (``dev1``), handed to the reference
    as its own (``pod1``): the reference's fingerprints and plan, byte for
    byte on NumPy and alike on the torch solver."""
    ours, theirs = tmp_path / "dev1", tmp_path / "pod1"
    theirs.mkdir()
    for arch, shape in (("qwen3-1.7b", "decode_32k"), ("gemma3-1b", "decode_32k"),
                        ("qwen3-1.7b", dr.ENGINE_DECODE)):
        rec = dr.run_cell(arch, shape, results=ours)
        (theirs / f"{arch}__{rec['shape']}__pod1.json").write_text(json.dumps(rec))
    monkeypatch.setattr(jlaunch_profile, "RESULTS", theirs)
    monkeypatch.setattr(tlaunch_profile, "RESULTS", ours)
    want, _ = printout(lambda: runpy.run_path(str(EXAMPLES / "profile_interference.py"),
                                              run_name="__main__"))
    got, (fps, plan) = twin("profile_interference", "--backend", "numpy")
    assert got == want and len(fps) == 3 and "colocation plan" in got
    got_torch, _ = twin("profile_interference")
    assert printed_alike(got_torch, want), (got_torch, want)


def test_train_tiny_lm_takes_two_steps_at_the_example_s_width(tmp_path):
    got, history = twin("train_tiny_lm", "--steps", "2", "--ckpt", str(tmp_path / "ckpt"))
    ref = jax_get_config("qwen3-1.7b")
    ref = ref.with_overrides(n_layers=6, d_model=512, d_ff=1536, vocab_size=8192,
                             attn=ref.attn.__class__(n_heads=8, n_kv_heads=4, head_dim=64,
                                                     qk_norm=True), attn_impl="flashref")
    assert got.splitlines()[0] == f"params: {ref.n_params() / 1e6:.1f}M"
    assert [h[0] for h in history] == [0, 1] and np.isfinite([h[1] for h in history]).all()
    assert "loss " in got and any((tmp_path / "ckpt").iterdir())


@pytest.mark.parametrize("name", ALL)
def test_twin_runs_on_the_card_by_default(name, monkeypatch):
    """Without ``--device`` a twin runs on the card: with no card it raises
    before it prices or builds anything."""
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--backend", "numpy"])
