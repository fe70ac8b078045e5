"""The port's training substrate: twins of the twelve tests of
tests/test_substrate.py (data pipeline, checkpointing, fault-tolerance
logic, optimizers, trainer loop) run against ``repro_torch``, and held to
the JAX package where the two must agree exactly: the synthetic batches bit
for bit, and a checkpoint written by either package restored by the other
leaf for leaf.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.ft import HeartbeatTracker, StragglerMonitor, plan_rescale
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.train.optimizer import (adafactor, adamw, get_optimizer, global_norm,
                                         warmup_cosine)
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import leaves, map_leaves

CFG = tiny_config(get_config("qwen3-1.7b"))


@pytest.fixture(autouse=True)
def one_thread():
    """The tensors here are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores (300 optimizer
    steps on a (256, 256) tensor took minutes so, against seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ----------------------------- data ---------------------------------- #
def test_data_deterministic_and_seekable():
    d = DataConfig(seq_len=32, global_batch=4, vocab_size=CFG.vocab_size)
    a = SyntheticLM(CFG, d)
    b = SyntheticLM(CFG, d)
    b.seek(5)
    batches_a = [next(a) for _ in range(8)]
    np.testing.assert_array_equal(batches_a[5]["tokens"], next(b)["tokens"])
    assert batches_a[0]["tokens"].max() < CFG.vocab_size
    assert batches_a[0]["loss_mask"].shape == (4, 32)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama-3.2-vision-90b", "hubert-xlarge"])
def test_synthetic_batches_equal_the_reference(arch):
    """``batch_at`` of both packages, every field bit for bit: tokens and
    labels, the loss mask, and the vlm's vision tokens and the audio
    encoder's frames."""
    d = dict(seq_len=24, global_batch=4, vocab_size=256, seed=3, n_hosts=2, host_id=1)
    want = JaxSyntheticLM(jax_tiny_config(jax_get_config(arch)), JaxDataConfig(**d))
    got = SyntheticLM(tiny_config(get_config(arch)), DataConfig(**d))
    for step in (0, 7):
        w, g = want.batch_at(step), got.batch_at(step)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_data_host_sharding_partitions_batch():
    d0 = DataConfig(seq_len=16, global_batch=8, n_hosts=2, host_id=0)
    d1 = DataConfig(seq_len=16, global_batch=8, n_hosts=2, host_id=1)
    b0 = SyntheticLM(CFG, d0).batch_at(3)
    b1 = SyntheticLM(CFG, d1).batch_at(3)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_prefetcher_matches_source():
    d = DataConfig(seq_len=16, global_batch=2)
    pf = Prefetcher(SyntheticLM(CFG, d))
    ref = SyntheticLM(CFG, d)
    for _ in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"], next(ref)["tokens"])
    pf.close()


# --------------------------- checkpoint ------------------------------ #
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        mgr.save(step, map_leaves(lambda x: x * step, tree), block=True)
    assert mgr.all_steps() == [2, 3]          # keep-2 retention
    step, restored = mgr.restore_latest(like=tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) * 3)


def test_checkpoint_atomic_crash_safety(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(7, {"x": torch.ones(3)}, block=True)
    # simulate a crash mid-write: stray .tmp dir must be ignored
    bad = tmp_path / "step_00000009.tmp"
    bad.mkdir()
    (bad / "garbage").write_text("x")
    assert mgr.all_steps() == [7]
    step, _ = mgr.restore_latest(like={"x": torch.ones(3)})
    assert step == 7


@functools.lru_cache(maxsize=None)
def _both_states():
    """zamba2's tiny tree in bf16 (12 layers: its ``tail`` is None) with an
    AdamW state, in both packages, equal leaf for leaf (only read)."""
    jcfg = jax_tiny_config(jax_get_config("zamba2-1.2b"))
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    assert jp["stack"]["tail"] is None
    jo = jopt.adamw(1e-2)
    js = jo.init(jp)
    js = dict(js, m=jax.tree.map(lambda p: p.astype(np.float32) * 0.5, jp),
              count=js["count"] + 3)
    return (jp, js), tuple(from_jax_params(jax.tree.map(np.asarray, t), device="cpu")
                           for t in (jp, js))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """(params, opt_state) with bf16 leaves and a ``None`` tail, written by
    one package's ``CheckpointManager`` and restored by the other's into
    its own tree: the same leaves in the same order, bit for bit, in the
    same types."""
    jtree, ttree = _both_states()
    if writer == "reference":
        JaxCheckpointManager(tmp_path).save(5, jtree, block=True)
        step, got = CheckpointManager(tmp_path).restore_latest(like=ttree)
        got, want = leaves(got), [np.asarray(x) for x in jax.tree.leaves(jtree)]
        assert got[0].dtype == torch.bfloat16 and got[0].dtype == leaves(ttree)[0].dtype
        as_np = [from_jax_params(w, device="cpu") for w in want]
        pairs = zip(got, as_np)
    else:
        CheckpointManager(tmp_path).save(5, ttree, block=True)
        step, got = JaxCheckpointManager(tmp_path).restore_latest(like=jtree)
        assert got[0]["stack"]["tail"] is None
        got = [from_jax_params(np.asarray(x), device="cpu") for x in jax.tree.leaves(got)]
        pairs = zip(got, leaves(ttree))
    assert step == 5
    n = 0
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
        n += 1
    assert n == len(jax.tree.leaves(jtree))


def test_trainer_resume_after_restart(tmp_path):
    model = build_model(CFG, device="cpu")
    d = DataConfig(seq_len=16, global_batch=2, vocab_size=CFG.vocab_size)
    tcfg = TrainerConfig(total_steps=6, checkpoint_dir=str(tmp_path),
                         checkpoint_every=2, log_every=100)
    t1 = Trainer(model, RunConfig(), tcfg)
    t1.fit(SyntheticLM(CFG, d), gen(0))
    assert t1.ckpt_mgr.all_steps()
    # "crash" and restart: resume step must follow the last checkpoint
    t2 = Trainer(model, RunConfig(), tcfg)
    step, params, opt_state = t2.restore_or_init(gen(0))
    assert step == 6   # final checkpoint at step 5 -> resume at 6
    assert opt_state["count"] > 0


# ------------------------------- ft ----------------------------------- #
def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=3.0, warmup=2)
    flagged = [mon.observe(i, 0.1) for i in range(6)]
    assert not any(flagged)
    assert mon.observe(6, 1.0)        # 10x the EWMA
    assert mon.events and mon.events[0]["step"] == 6
    # healthy step after straggle does not poison the baseline
    assert not mon.observe(7, 0.1)


def test_heartbeat_tracker():
    hb = HeartbeatTracker(timeout_s=10)
    hb.beat("host0", now=100.0)
    hb.beat("host1", now=104.0)
    assert hb.dead_workers(now=112.0) == ["host0"]


def test_rescale_plan_preserves_model_axis():
    plan = plan_rescale({"pod": 2, "data": 16, "model": 16}, lost_chips=256,
                        global_batch=256, num_microbatches=4, current_step=77)
    assert plan.new_shape["model"] == 16          # TP must stay intact
    assert plan.new_chip_count <= 2 * 16 * 16 - 256
    assert plan.new_microbatches >= 4             # keep global batch
    assert plan.restart_step == 77


# ---------------------------- optimizer ------------------------------- #
@pytest.mark.parametrize("make", [lambda: adamw(1e-2), lambda: adafactor(1e-2)])
def test_optimizers_reduce_quadratic_loss(make):
    opt = make()
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.full((256, 256), 2.0)}
    state = opt.init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + (p["b"] ** 2).sum() / p["b"].numel()

    l0 = float(loss(params))
    for _ in range(300):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(loss(live), list(live.values()))))
        params, state = opt.update(grads, state, params)
    assert float(loss(params)) < 0.1 * l0


def test_grad_accumulation_matches_full_batch():
    model = build_model(CFG, device="cpu")
    params = model.init(gen(0))
    d = DataConfig(seq_len=16, global_batch=4, vocab_size=CFG.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(CFG, d).batch_at(0).items()}
    opt = get_optimizer("adamw")

    outs = {}
    for k in (1, 2, 4):
        p = map_leaves(torch.clone, params)
        step = make_train_step(model, opt, RunConfig(num_microbatches=k))
        p2, _, m = step(p, opt.init(p), batch)
        outs[k] = (float(m["loss"]), p2)
    assert abs(outs[1][0] - outs[4][0]) < 2e-2
    diff = global_norm(map_leaves(lambda a, b: a - b, outs[1][1], outs[4][1]))
    scale = global_norm(outs[1][1])
    assert float(diff) / float(scale) < 2e-2


def test_warmup_cosine_schedule():
    lr = warmup_cosine(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 0.11
    assert float(lr(100)) < float(lr(50)) < float(lr(11))


# --------------------------- entry points ------------------------------ #
def test_entry_points_default_to_cuda_and_do_not_fall_back():
    """``build_model``, ``Trainer`` and ``launch.train`` run on the card
    unless told otherwise, and raise where there is none."""
    if torch.cuda.is_available():      # decided inside the test, not at import
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(CFG)
    model = build_model(CFG, device="cpu")._replace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, RunConfig(), TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-1.7b", "--tiny", "--steps", "1"])
    losses = launch_train.main(["--arch", "qwen3-1.7b", "--tiny", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
