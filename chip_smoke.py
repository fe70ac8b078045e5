#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against
its plain PyTorch version on the card, times them at the shapes their paths
give them, and drives seventeen paths, counting the kernels' launches on each:

  * serving: qwen3-1.7b at full width and depth through the
    continuous-batching engine (rmsnorm, flash_attention, flash_decode),
    whose decode and extend steps replay CUDA graphs captured when the
    engine is built (``repro_torch.graphs``), against the same serve on the
    steps' bodies run uncaptured;
  * the dry run: ``launch/dryrun`` counts qwen3-1.7b and llama3.1-8b at
    full width and depth on ``meta`` tensors on the host (train_4k,
    prefill_32k, decode_32k and the engine's decode step; the card's
    memory must not move), llama3.1-8b (the paper's §4.2/§4.3 decode
    workload, 16.06 GB) is served as qwen3-1.7b is, each engine-shape
    record predicts its decode replay on the H100 model beside the
    measured one (its products held to the hand count), and
    ``launch/profile``'s entry point prices every record on the card (the
    torch solver, one cache_share launch a solve) and, with one explicit
    search, on NumPy and on the card, with the same plan;
  * one chip of the production meshes: the same two models' cells counted
    on one chip of the reference's 16x16 and 2x16x16 meshes by a child
    process (``--pod-counts``: no card, a ``fake`` world of 256 / 512 ranks
    of its own) that runs beside the train phase, whose host waits on the
    card, and is read after it: each chip's products beside the one-device
    count's split over the chips, and both meshes' records priced as the
    one-device ones;
  * the sharded forward: qwen3-1.7b at full width and depth over a (1, 1)
    CUDA mesh of an NCCL world of one rank, its parameters, prompt, ids and
    cache DTensors, on the three kernels through ``local_map``, against the
    unsharded facade (logits and launches), and the card's half of a
    decode over a cache split between two ranks (``flash_decode``'s
    per-split partials);
  * interference: the paper's §4 measure → fit → validate loop, the four
    stressor kernels on their own CUDA streams beside two full-width
    attention victims replayed from CUDA graphs
    (``repro_torch.launch.gpu_native.interference_sweep``), each colocated
    run bracketed by its background's events, after a reading of the
    registers and shared memory each stressor block leaves the victims;
  * the solver: the same qwen3-1.7b serve with every prefill chunk priced
    by the torch solver backend on the card (cache_share, the solve
    replayed from a CUDA graph), against the
    NumPy backend's chunks, and a batch of the interference phase's
    scenarios on both backends;
  * the fleet: the colocation scheduler, the fleet scheduler with its
    scoped repair and fault injector, the trace simulator and the drift
    monitor with every price on the torch solver on the card (one
    cache_share launch a solve), through the reference's gate trace on a
    v5e / v5p fleet and on 12 H100 models (equal to the NumPy backend's at
    1e-9 with the same decisions, and bit for bit the same twice) and
    through its fleet-recovery and 256-device scale traces;
  * the examples: the seven twins of the reference's examples
    (``repro_torch.examples``) as a user runs them, on the card with the
    H100 model and the torch solver, each launching its path's kernels,
    the four that only price again on NumPy with the same decisions;
  * falcon-mamba-7b at full width and depth through the model facade:
    prefill and greedy decode steps on the selective scan (ssm_scan,
    rmsnorm);
  * zamba2-1.2b at full width and depth through the model facade: Mamba-2
    layers (the SSD in f32 products, the gated norm on rmsnorm) and the one
    shared attention block at head_dim 64 (flash_attention in prefill,
    flash_decode in decode), with the three kernels checked and timed at
    the path's shapes;
  * gemma3-1b at full width and depth through the model facade: the
    local:global stack (4 groups of 5 sliding-window layers and a global
    one, a tail of 2 local layers; local decode over a ring of the window's
    rows) at head_dim 256 with 4 / 1 heads, with flash_attention and
    flash_decode checked and timed at its shapes;
  * gemma-2b at full width and depth served through the engine as
    llama3.1-8b is, its chunks priced on the torch solver on the card: 8
    query heads over one KV head of 256 (MQA) in flash_decode;
  * gemma3-4b at full width and depth through the model facade: a 4 x 2,048
    prompt, so that its 1,024-token window cuts, 8 / 4 heads of 256;
  * moonshot-v1-16b-a3b (the moe family: 64 experts, top 6, and 2 shared)
    at full width and depth, 57 GB of weights, served through the engine
    with its captured steps as qwen3-1.7b is, its logits held against the
    plain versions with the MoE's routing replayed, and a 4 x 1,024 prefill
    through the model facade, with the three kernels checked and timed at
    its shapes (16 / 16 heads of 128);
  * llama-3.2-vision-90b (the vlm family) at full width and 30 of its 100
    layers (6 of its 20 groups of four self layers and one tanh-gated
    cross-attention layer), 55.4 GB of weights, through the model facade:
    prefill of 4 x 1,024 text tokens beside 4,096 vision tokens, 32 greedy
    decode steps, self attention at 8 query heads a KV head and the cross
    attention (1,024 queries over 4,096 keys) on flash_attention, the cross
    decode on flash_decode over the vision cache, with the three kernels
    checked and timed at its shapes;
  * hubert-xlarge (the audio encoder) at full width and depth: a forward
    over 4 x 1,024 frames, bidirectional attention at head_dim 80 on
    flash_attention, checked and timed at its shapes (with the split of
    the keys forced, so that the merge runs at head_dim 80);
  * training: qwen3-1.7b at full width and depth through ``Trainer.fit``,
    4 AdamW steps of 8 x 4,096 tokens in 4 microbatches with full remat,
    rmsnorm and flash_attention on their kernels inside the Functions
    whose backward is the plain versions' VJP: the four kernels' gradients
    against the plain versions' autograd at the training shapes, step 0
    against the same step on the plain versions, a step's numbers and its
    profile.

Every phase prints JSON lines; any failure ends the run with a non-zero
exit code. Without a CUDA device the script fails: nothing runs on the CPU.

A captured step's kernels are counted by their wrappers at its capture;
the launches on the card are those counts times the step's replays.

The last three lines of its standard output are the ``kernels`` record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import graphs  # noqa: E402
from repro_torch.calib import FIT_LAMBDAS, StressorSpec, median_iqr_time  # noqa: E402
from repro_torch.calib.measure import _stressor_call  # noqa: E402
from repro_torch.calib import fit as fit_mod  # noqa: E402
from repro_torch.configs.base import TRAIN_4K, RunConfig  # noqa: E402
from repro_torch.configs.registry import get_config, tiny_config  # noqa: E402
from repro_torch.core import estimator as estimator_mod  # noqa: E402
from repro_torch.core import estimator_torch  # noqa: E402
from repro_torch.core import scheduler as scheduler_mod  # noqa: E402
from repro_torch.core.fleet import BEST_EFFORT, SLO, FleetConfig, FleetScheduler  # noqa: E402
from repro_torch.core.fracsearch import FractionSearchConfig  # noqa: E402
from repro_torch.core.profile import KernelProfile, WorkloadProfile, from_dryrun_json  # noqa: E402
from repro_torch.core.backend import get_solver_device, solver_backend, warmup_solver  # noqa: E402
from repro_torch.core.estimator import solve_scenarios  # noqa: E402
from repro_torch.core.resources import H100, RESOURCE_AXES, TPU_V5E, TPU_V5P  # noqa: E402
from repro_torch.ft.inject import FakeClock, FaultInjector, arrive, kill, storm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_share as cs_mod  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_mod  # noqa: E402
from repro_torch.kernels import stressors as st_mod  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import gpu_native  # noqa: E402
from repro_torch.launch import profile as profile_mod  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import ParallelContext  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.models.hybrid import hybrid_split  # noqa: E402
from repro_torch.models.transformer import lg_split, vlm_split  # noqa: E402
from repro_torch.core.scenario import Scenario  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.examples import printed_alike  # noqa: E402
from repro_torch.examples.fleet_failover import decode_heavy_mix  # noqa: E402
from repro_torch.train.optimizer import Optimizer, global_norm  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from repro_torch.serve.engine import chunk_bucket  # noqa: E402
from repro_torch.sim import Simulator, TraceConfig, generate_trace  # noqa: E402
from repro_torch.sim.simulator import default_fleet_config  # noqa: E402

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.float64: 34e12}      # f64 outside the tensor cores
# shared memory: one wavefront (32 banks of 4 bytes) a clock on each of
# 132 SMs, at the H100 SXM's highest SM clock (1,980 MHz, data sheet); the
# device phase prints the card's own clocks.max.sm beside it
N_SMS = 132
SM_CLOCK_HZ = 1.98e9
SMEM_BYTES_PER_S = N_SMS * 128 * SM_CLOCK_HZ
# exponentials: the multi-function unit of an SM returns 16 a clock (CUDA
# programming guide, throughput of arithmetic instructions, cc 9.0)
EXP_PER_S = 132 * 16 * SM_CLOCK_HZ
# the data sheet's rate of each stressor's axis
SHEET_RATE = {"mxu": 989e12, "vpu": 67e12, "hbm": HBM_BYTES_PER_S,
              "smem": SMEM_BYTES_PER_S}

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference's own
BF = torch.bfloat16
F32 = torch.float32
DEV = "cuda"


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def run_text(cmd) -> str:
    exe = shutil.which(cmd[0])
    if exe is None:
        return f"{cmd[0]}: not found"
    out = subprocess.run([exe, *cmd[1:]], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=60)
    return out.stdout.strip()


def ptxas_summary() -> dict:
    """What ``-Xptxas -v`` said of the build: kernels compiled, those that
    spill registers, with the bytes, and any warning that it serialised a
    kernel's wgmma instructions."""
    log = Path(f"{_build.library_path()}.log").read_text().splitlines()
    entry, n, spills, serialized = "", 0, {}, []
    for ln in log:
        if "Compiling entry function" in ln:
            entry, n = ln.split("'")[1], n + 1
        elif "bytes spill stores" in ln and " 0 bytes spill stores" not in ln:
            spills[entry] = ln.split("ptxas info")[-1].strip(" :")
        elif "wgmma" in ln and "serialized" in ln:
            serialized.append(ln.strip())
    return {"kernels_compiled": n, "kernels_with_spills": spills,
            "wgmma_serialized": serialized}


def sass_opcode_counts(kernel: str, opcode: str) -> dict:
    """Instructions whose text holds ``opcode`` (HMMA: ``mma.sync``; HGMMA:
    ``wgmma``) in the SASS of every function of the built library whose
    name holds ``kernel`` (``cuobjdump -sass``)."""
    exe = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(exe) if exe.exists() else "cuobjdump", "-sass",
                          str(_build.library_path())], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300).stdout
    found, name = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            if kernel in name:
                found[name] = 0
        elif name in found and opcode in ln:
            found[name] += 1
    return found


# every wrapper of the port: (module, name); the plain version is name + "_plain"
WRAPPERS = [(rms_mod, "rmsnorm"), (fa_mod, "flash_attention"),
            (dec_mod, "flash_decode"), (st_mod, "stress_mxu"),
            (st_mod, "stress_vpu"), (st_mod, "stress_hbm"), (st_mod, "stress_vmem"),
            (cs_mod, "cache_share"), (ssm_mod, "ssm_scan")]
SERVING = ("rmsnorm", "flash_attention", "flash_decode")
SCAN_TOL = 1e-4                                   # the reference's, tests/test_kernels.py
STRESSORS = ("stress_mxu", "stress_vpu", "stress_hbm", "stress_vmem")


@contextlib.contextmanager
def plain_versions():
    """Route the wrappers to their plain PyTorch versions: what the kernels
    are held against. Only this script does so."""
    saved = [getattr(mod, name) for mod, name in WRAPPERS]
    for mod, name in WRAPPERS:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(WRAPPERS, saved):
            setattr(mod, name, fn)


def reset_counts() -> None:
    for mod, name in WRAPPERS:
        getattr(mod, name).launches = 0


def counts(names=None) -> dict:
    return {name: getattr(mod, name).launches for mod, name in WRAPPERS
            if names is None or name in names}


@contextlib.contextmanager
def uncaptured():
    """Make every new step run its body on each call, as on the CPU: the
    uncaptured bodies, which the graphs are held against. Only this script
    does so."""
    saved = graphs.capture
    graphs.capture = lambda body, device, name: graphs.Step(body, name)
    try:
        yield
    finally:
        graphs.capture = saved


def replayed(steps, since=None) -> dict:
    """Kernel launches of captured steps on the card: each step's launches
    of one call, as its capture counted them, times its calls (since the
    ``since`` count of calls by step, where given)."""
    out = {}
    for step in steps:
        calls = step.calls - (since or {}).get(id(step), 0)
        for name, n in step.launches.items():
            out[name] = out.get(name, 0) + n * calls
    return out


def at_capture(steps) -> dict:
    """What the warm-ups and captures of ``steps`` launched, by wrapper."""
    out = {}
    for step in steps:
        for name, n in step.capture_launches.items():
            out[name] = out.get(name, 0) + n
    return out


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV).to(dtype)


def check_close(name, got, want, dtype, tol=None, atol=None) -> float:
    """Fail unless |got - want| <= atol + tol * |want| everywhere and all of
    ``got`` is finite; returns the largest absolute difference. ``dtype`` is
    the narrowest type on the way: over a bf16 cache the softmax weights are
    rounded to bf16 (by the kernel before, by the plain version after they
    are normalised), so f32 queries there are held to the bf16 tolerance.
    ``tol`` overrides the tolerance of ``dtype``; ``atol``, its absolute
    part (``tol`` by default), may be a tensor that broadcasts to ``want``."""
    torch.cuda.synchronize()
    tol = TOL[dtype] if tol is None else tol
    atol = tol if atol is None else atol
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                             "or values not finite")
    err = (g - w).abs()
    if not (err <= atol + tol * w.abs()).all():
        i = int(torch.argmax(err / (atol + tol * w.abs())))
        a = atol.flatten()[i // w.shape[-1]].item() if torch.is_tensor(atol) else atol
        raise AssertionError(f"{name}: err {err.flatten()[i].item():.3e} at a value of "
                             f"{w.flatten()[i].item():.3e}, beyond tolerance {tol} "
                             f"(absolute part {a:.3e})")
    return err.max().item()


def check_attention(name, got, want, dtype, dropped=()) -> float:
    """``check_close`` for an attention output (..., D), with the absolute
    part of the tolerance scaled, row by row, by the RMS of the row (at
    most 1). A row is a weighted average of v over its keys: over N(0, 1)
    values both its typical entry and the error that bf16 weights put in it
    scale as sqrt(sum of the squared weights), so at 4,096 keys a flat 2e-2
    would be as large as a typical entry, while a row over two keys can
    err by 1e-2. ``dropped``: plain versions over the same inputs with a
    tile or a split of the keys left out; each must fail the same gate, or
    the gate could not see a kernel that skipped one."""
    w = want.float()
    tol = TOL[dtype]
    atol = tol * w.pow(2).mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    for i, bad in enumerate(dropped):
        if ((bad.float() - w).abs() <= atol + tol * w.abs()).all():
            raise AssertionError(f"{name}: the gate passes planted fault {i}, keys left out")
    return check_close(name, got, want, dtype, atol=atol)


def without_keys(k, v, lo: int, n: int) -> tuple:
    """k and v (B, T, KVH, D) with keys lo .. lo + n - 1 left out."""
    return tuple(torch.cat((t[:, :lo], t[:, lo + n:]), 1) for t in (k, v))


def time_ms(fn, n_variants: int = 1, iters: int = 20, reps: int = 7) -> dict:
    """Time ``fn(i)`` two ways, each the median over ``reps`` of the mean of
    ``iters`` calls between CUDA events. ``ms``: the calls replayed from a
    CUDA graph, so the device runs them back to back and the time is the
    device's own. ``eager_ms``: the calls as the port makes them, from
    Python, where a small kernel waits for the host to enqueue it. ``fn`` is
    given a running index so that it can walk over ``n_variants`` copies of
    its inputs and find the L2 cache cold where the real caller would."""
    def run(k0):
        for k in range(k0, k0 + iters):
            fn(k % n_variants)

    def timed(launch):
        times = []
        for r in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(r * iters)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / iters)
        return statistics.median(times)

    run(0)                                           # warm up, build, allocate
    torch.cuda.synchronize()
    eager = timed(run)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(0)
    graph.replay()
    torch.cuda.synchronize()
    return {"ms": timed(lambda _: graph.replay()), "eager_ms": eager}


def bound(bytes_moved: float, operations: float, dtype, sm_share: float = 1.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    device memory's rate and the operations over the type's peak, of which
    a grid that covers ``sm_share`` of the SMs has that share."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / (PEAK_OPS_PER_S[dtype] * sm_share) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
#  phase 3: kernels                                                      #
# --------------------------------------------------------------------- #
def bhsd_views(rng, BKV, g, S, T, D, dtype):
    """The reference's kernel-test layout q (BKV*g, S, D), k/v (BKV, T, D),
    handed over as strided model-layout views with one KV head."""
    q = randn(rng, (BKV * g, S, D), dtype)
    k = randn(rng, (BKV, T, D), dtype)
    v = randn(rng, (BKV, T, D), dtype)
    return (q.view(BKV, g, S, D).permute(0, 2, 1, 3), k[:, :, None, :],
            v[:, :, None, :])


def check_rmsnorm(rng) -> float:
    worst = 0.0
    cases = [((64, 256), F32), ((100, 512), BF), ((1024, 128), F32),
             ((8, 1, 2048), BF), ((1, 128, 2048), BF), ((8, 1, 64), F32)]
    for shape, dtype in cases:
        x = randn(rng, shape, dtype)
        s = randn(rng, (shape[-1],), F32)
        worst = max(worst, check_close(f"rmsnorm{shape}", rms_mod.rmsnorm(x, s),
                                       rms_mod.rmsnorm_plain(x, s), dtype))
    # the last position of every sequence: a strided view, as in prefill
    x = randn(rng, (4, 96, 2048), BF)[:, -1:]
    s = randn(rng, (2048,), F32)
    worst = max(worst, check_close("rmsnorm strided", rms_mod.rmsnorm(x, s),
                                   rms_mod.rmsnorm_plain(x, s), BF))
    return worst


def path_cache(rng, L, B, T, KVH, D, dtype):
    return randn(rng, (L, B, T, KVH, D), dtype), randn(rng, (L, B, T, KVH, D), dtype)


def check_flash_decode(rng) -> float:
    worst = 0.0
    for T, G, D in [(512, 4, 64), (384, 1, 128), (1024, 8, 64)]:
        q = randn(rng, (3, 1, G, D), F32)
        k, v = randn(rng, (3, T, 1, D), F32), randn(rng, (3, T, 1, D), F32)
        lens = torch.tensor([T, T // 2, 7], device=DEV)
        worst = max(worst, check_attention(
            f"flash_decode T{T} G{G} D{D}", dec_mod.flash_decode(q, k, v, lens),
            dec_mod.flash_decode_plain(q, k, v, lens), F32))
    cases = [  # B, H, KVH, D, T, kv_len, q dtype, cache dtype
        (2, 8, 2, 64, 256, [200, 64], F32, F32),
        (8, 16, 8, 128, 1025, [1025, 1, 64, 65, 333, 800, 1024, 1025], BF, BF),
        (2, 4, 2, 16, 97, [97, 5], F32, BF),
        (2, 4, 2, 16, 97, [33, 96], BF, BF),
    ]
    for B, H, KVH, D, T, lens, qd, kd in cases:
        q = randn(rng, (B, 1, H, D), qd)
        ck, cv = path_cache(rng, 2, B, T, KVH, D, kd)
        lens = torch.tensor(lens, device=DEV)
        worst = max(worst, check_attention(
            f"flash_decode B{B} H{H} D{D} T{T}",
            dec_mod.flash_decode(q, ck[1], cv[1], lens),
            dec_mod.flash_decode_plain(q, ck[1], cv[1], lens), kd))
    # the lengths as the model has them (int64) and as int32: one result,
    # each the plain version's, G = 16 (the widest group) beside the path's
    for B, H, KVH, lens in [(8, 16, 8, [1025, 1, 64, 65, 333, 800, 1024, 1025]),
                            (2, 32, 2, [700, 129])]:
        q = randn(rng, (B, 1, H, 128), BF)
        ck, cv = path_cache(rng, 2, B, 1025, KVH, 128, BF)
        l64 = torch.tensor(lens, dtype=torch.int64, device=DEV)
        got64 = dec_mod.flash_decode(q, ck[0], cv[0], l64)
        got32 = dec_mod.flash_decode(q, ck[0], cv[0], l64.to(torch.int32))
        check_exact(f"flash_decode int64 vs int32 lengths H{H}", got64, got32)
        worst = max(worst, check_attention(f"flash_decode int64 lengths H{H}", got64,
                                       dec_mod.flash_decode_plain(q, ck[0], cv[0], l64), BF))
    return worst


def check_flash_attention(rng) -> float:
    worst = 0.0
    grid = [(128, 128, 64, 1, "causal", F32), (256, 256, 128, 4, "causal", BF),
            (128, 384, 64, 2, "bidirectional", F32), (200, 200, 64, 2, "causal", F32),
            (256, 256, 64, 1, "local", F32),
            # the tensor-core body on each kind, ragged S, every head dim
            (256, 256, 64, 4, "local", BF), (128, 384, 64, 4, "bidirectional", BF),
            (37, 37, 64, 4, "causal", BF), (200, 200, 64, 4, "causal", BF),
            (200, 200, 32, 2, "local", BF), (37, 300, 16, 1, "bidirectional", BF)]
    for S, T, D, g, kind, dtype in grid:
        q, k, v = bhsd_views(rng, 2, g, S, T, D, dtype)
        worst = max(worst, check_attention(
            f"flash_attention {kind} S{S} T{T} D{D} g{g}",
            fa_mod.flash_attention(q, k, v, kind, 64),
            fa_mod.flash_attention_plain(q, k, v, kind, 64), dtype))
    # the split of the keys, forced: 1 to 4 pieces on the path's chunk, and a
    # local window that leaves a split with no key of a query tile
    for S, T, D, g, kind, pieces in [(128, 640, 128, 2, "causal", (1, 2, 3, 4)),
                                     (128, 640, 64, 2, "local", (2, 4)),
                                     (200, 520, 128, 1, "bidirectional", (3,))]:
        q, k, v = bhsd_views(rng, 1, g, S, T, D, BF)
        want = fa_mod.flash_attention_plain(q, k, v, kind, 64)
        for n in pieces:
            worst = max(worst, check_attention(
                f"flash_attention {kind} S{S} T{T} D{D} kv_splits={n}",
                fa_mod.flash_attention(q, k, v, kind, 64, 0, n), want, BF))
    cases = [  # B, S, H, KVH, D, pos0, q dtype, cache dtype
        (2, 128, 8, 2, 64, 0, F32, F32),
        (1, 128, 16, 8, 128, 0, BF, BF),        # the path's chunk, pos0 = 0
        (1, 128, 16, 8, 128, 512, BF, BF),      # ... and deep in a prompt
        (1, 37, 16, 8, 128, 211, BF, BF),       # a ragged last chunk
        (1, 768, 16, 8, 128, 0, BF, BF),        # a whole prompt (serial mode)
        (1, 23, 4, 2, 16, 9, F32, BF),          # the small model, f32 over a bf16 cache
        (2, 40, 4, 2, 16, 0, F32, F32),
    ]
    for B, S, H, KVH, D, pos0, qd, kd in cases:
        q = randn(rng, (B, S, H, D), qd)
        ck, cv = path_cache(rng, 2, B + 1, pos0 + S + 5, KVH, D, kd)
        k, v = ck[1, 1:B + 1, :pos0 + S], cv[1, 1:B + 1, :pos0 + S]   # cache views
        worst = max(worst, check_attention(
            f"flash_attention S{S} H{H} D{D} pos0={pos0}",
            fa_mod.flash_attention(q, k, v, "causal", 0, pos0),
            fa_mod.flash_attention_plain(q, k, v, "causal", 0, pos0), kd))
    # slot, pos0 and c read from device memory, over the whole cache (8
    # slots x 1,025 positions), as a captured extend step passes them: the
    # path's chunk at pos0 0 and 512, a last chunk of 100 padded to 128
    # whose bucket reaches past the cache, one token at 16, and the small
    # model's f32 queries over a bf16 cache. Against the plain version with
    # the same offsets, and the real rows against the integer-offset call.
    for S, c, pos0, slot, H, KVH, D, qd in [
            (128, 128, 0, 3, 16, 8, 128, BF), (128, 128, 512, 3, 16, 8, 128, BF),
            (128, 100, 900, 5, 16, 8, 128, BF), (16, 1, 40, 0, 16, 8, 128, BF),
            (32, 23, 9, 1, 4, 2, 16, F32)]:
        q = randn(rng, (1, S, H, D), qd)
        ck, cv = path_cache(rng, 1, 8, 1025, KVH, D, BF)
        off = torch.tensor([slot, pos0, c], device=DEV)
        got = fa_mod.flash_attention(q, ck[0], cv[0], "causal", offsets=off)
        name = f"flash_attention offsets slot {slot} pos0 {pos0} c {c} S {S} {qd}"
        worst = max(worst, check_attention(
            name, got, fa_mod.flash_attention_plain(q, ck[0], cv[0], "causal", offsets=off), BF))
        view = (ck[0, slot:slot + 1, :pos0 + c], cv[0, slot:slot + 1, :pos0 + c])
        worst = max(worst, check_attention(
            name + " vs integer offset", got[:, :c],
            fa_mod.flash_attention(q[:, :c], *view, "causal", 0, pos0), BF))
    return worst


def time_rmsnorm(rng, shape, copies: int = 1) -> dict:
    """``copies`` > 1 walks over that many inputs, so that a shape whose
    bytes fit in the L2 cache (50 MB) is read cold, as its bound counts."""
    xs = [randn(rng, shape, BF) for _ in range(copies)]
    s = randn(rng, (shape[-1],), F32)
    sb = s.to(BF)
    n = xs[0].numel()
    b_ms, by = bound(2 * n * 2 + s.numel() * 4, 4 * n, F32)
    return {"shape": list(shape), "dtype": "bfloat16", "copies": copies,
            **time_ms(lambda i: rms_mod.rmsnorm(xs[i], s), copies),
            "plain_ms": time_ms(lambda i: rms_mod.rmsnorm_plain(xs[i], s), copies)["ms"],
            "library_ms": time_ms(lambda i: F.rms_norm(xs[i], (shape[-1],), sb, 1e-6),
                                  copies)["ms"],
            "bound_ms": b_ms, "bound_by": by}


def time_flash_decode(rng, kv_len, label, B=8, H=16, KVH=8, D=128, T=1025) -> dict:
    """One decode step's attention over ``L`` layers' caches (qwen3-1.7b's
    serve by default: 200 MB, so the L2 cache is cold)."""
    L = 6
    ck, cv = path_cache(rng, L, B, T, KVH, D, BF)
    q = randn(rng, (B, 1, H, D), BF)
    lens = torch.tensor(kv_len, device=DEV)
    valid = (torch.arange(T, device=DEV)[None] < lens[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)                             # (B, H, 1, D)

    def library(i):
        return F.scaled_dot_product_attention(
            qt, ck[i].transpose(1, 2), cv[i].transpose(1, 2), attn_mask=valid,
            enable_gqa=True)

    n_keys = int(sum(kv_len))
    b_ms, by = bound(2 * n_keys * KVH * D * 2 + 2 * q.numel() * 2 + B * 4,
                     4 * n_keys * H * D, BF)
    chunk, n_splits = dec_mod.split_plan(T, B * KVH)
    return {"shape": label, "dtype": "bfloat16", "kv_len": list(kv_len),
            "kv_len_dtype": str(lens.dtype), "body": "cp_async_lanes", "chunk": chunk,
            "kv_splits": n_splits,
            **time_ms(lambda i: dec_mod.flash_decode(q, ck[i], cv[i], lens), L),
            "plain_ms": time_ms(lambda i: dec_mod.flash_decode_plain(q, ck[i], cv[i], lens), L)["ms"],
            "library_ms": time_ms(library, L)["ms"],
            "bound_ms": b_ms, "bound_by": by}


def time_flash_attention(rng, S, pos0, KVH=8, H=16, D=128) -> dict:
    """S queries at pos0 over slot 3 of L caches (8 x 1,025 positions; H
    query heads of D over ``KVH``), qwen3-1.7b's by default."""
    B, L = 1, 4
    ck, cv = path_cache(rng, L, 8, 1025, KVH, D, BF)
    q = randn(rng, (B, S, H, D), BF)
    T = pos0 + S
    views = [(ck[i, 3:4, :T], cv[i, 3:4, :T]) for i in range(L)]
    mask = (torch.arange(T, device=DEV)[None, :]
            <= torch.arange(S, device=DEV)[:, None] + pos0)
    qt = q.transpose(1, 2)

    def library(i):
        k, v = views[i]
        return F.scaled_dot_product_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True)

    pairs = sum(min(T, s + pos0 + 1) for s in range(S))      # unmasked (q, k) pairs
    b_ms, by = bound((2 * q.numel() + 2 * B * T * KVH * D) * 2, 4 * pairs * B * H * D, BF)
    plan = fa_mod.split_plan(B, S, H, T, BF, torch.cuda.get_device_properties(0).multi_processor_count)
    # (a) the keys split over 2-4 blocks, merged by a second kernel; (b) no split
    fills = {f"kv_splits={n}": time_ms(
        lambda i, n=n: fa_mod.flash_attention(q, *views[i], "causal", 0, pos0, n), L)["ms"]
        for n in (1, 2, 3, 4)}
    return {"shape": f"S={S} T={T} pos0={pos0} H={H} KVH={KVH} D={D}", "dtype": "bfloat16",
            **plan, "ms_by_kv_splits": fills,
            **time_ms(lambda i: fa_mod.flash_attention(q, *views[i], "causal", 0, pos0), L),
            "plain_ms": time_ms(lambda i: fa_mod.flash_attention_plain(q, *views[i], "causal", 0, pos0), L)["ms"],
            "library_ms": time_ms(library, L)["ms"],
            "bound_ms": b_ms, "bound_by": by}


def time_flash_attention_offsets(rng, pos0, KVH=8, H=16, D=128) -> dict:
    """Row 2 on the captured extend step's path: 128 queries at pos0 with
    slot, pos0 and c read from device memory over the whole cache (8 slots
    x 1,025 positions, the splits planned for 1,025 keys), beside the
    integer-offset call over the slot's view, in the same run."""
    S, L, slot = 128, 4, 3
    ck, cv = path_cache(rng, L, 8, 1025, KVH, D, BF)
    q = randn(rng, (1, S, H, D), BF)
    off = torch.tensor([slot, pos0, S], device=DEV)
    T = pos0 + S
    pairs = sum(min(T, s + pos0 + 1) for s in range(S))
    b_ms, by = bound((2 * q.numel() + 2 * T * KVH * D) * 2, 4 * pairs * H * D, BF)
    return {"shape": f"S={S} c={S} pos0={pos0} H={H} over a (8, 1025, {KVH}, {D}) cache, "
                     "device offsets",
            "dtype": "bfloat16",
            **time_ms(lambda i: fa_mod.flash_attention(q, ck[i], cv[i], "causal", offsets=off), L),
            "integer_offset_ms": time_ms(lambda i: fa_mod.flash_attention(
                q, ck[i, slot:slot + 1, :T], cv[i, slot:slot + 1, :T], "causal", 0, pos0), L)["ms"],
            "plain_ms": time_ms(lambda i: fa_mod.flash_attention_plain(
                q, ck[i], cv[i], "causal", offsets=off), L)["ms"],
            "bound_ms": b_ms, "bound_by": by}


def launch_floor_ms() -> float:
    """The empty kernel ``rt_empty`` through ``time_ms``: what one launch
    costs in a CUDA-graph replay, whatever the kernel does."""
    lib = _build.load()

    def launch(i):
        _build.check_launch(lib.rt_empty(_build.stream_ptr()), "rt_empty")
    return time_ms(launch)["ms"]


def cache_share_cases(rng) -> list:
    """(ws, present, cap) as NumPy arrays: the reference's 37 x 3 case with a
    row whose working sets add up to the capacity exactly
    (tests/test_estimator_jax.py), the engine's padded batch (8 x 2), and K =
    2..6 at up to 4,096 rows, each with a row at the cliff and one a byte
    over it."""
    r9 = np.random.default_rng(9)
    cap = TPU_V5E.cache_capacity
    ws = r9.random((37, 3)) * 2.0 * cap
    ws[r9.random((37, 3)) < 0.3] = 0.0
    ws[0] = [cap / 2, cap / 2, 0.0]
    present = r9.random((37, 3)) < 0.9
    cases = [(np.where(present, ws, 0.0), present, cap)]
    cap = H100.cache_capacity
    for S, K in [(8, 2), (4096, 2), (4096, 3), (1000, 4), (2048, 5), (4096, 6)]:
        ws = rng.random((S, K)) * rng.choice([0.3, 1.0, 2.0], size=(S, 1)) * cap
        ws[rng.random((S, K)) < 0.3] = 0.0
        ws[:2] = 0.0
        ws[0, :2] = cap / 2
        ws[1, :2] = [cap / 2, cap / 2 + 1.0]
        present = rng.random((S, K)) < 0.85
        present[:2] = True
        cases.append((np.where(present, ws, 0.0), present, cap))
    return cases


def check_cache_share(rng) -> float:
    """The kernel equals its plain version bit for bit (f64, the same sum
    order, IEEE division)."""
    for ws, present, cap in cache_share_cases(rng):
        w, p = torch.from_numpy(ws).to(DEV), torch.from_numpy(present).to(DEV)
        check_exact(f"cache_share {ws.shape}", cs_mod.cache_share(w, p, cap),
                    cs_mod.cache_share_plain(w, p, cap))
    return 0.0


def scan_inputs(rng, Bb, S, di, N, x_dtype=F32):
    """The reference kernel test's distributions (tests/test_kernels.py)."""
    x = randn(rng, (Bb, S, di), F32) * 0.5
    dt = F.softplus(randn(rng, (Bb, S, di), F32) - 2)
    A = -torch.exp(randn(rng, (di, N), F32) * 0.3)
    return (x.to(x_dtype), dt, A, randn(rng, (Bb, S, N), F32) * 0.5,
            randn(rng, (Bb, S, N), F32) * 0.5)


def falcon_scan_inputs(rng, Bb, S, di, N, x_dtype=F32):
    """falcon-mamba's own A, -(1..N) in every channel (``models/ssm.py``'s
    A_log = log(1..N)), and dt = softplus(u), u uniform in [-4, 3]: the
    steepest decays the model's initialisation gives, up to exp(-16 *
    softplus(3)) = exp(-48.8) a step. The same draw as
    ``tests/test_torch_ssm.py:falcon_scan_inputs``."""
    x = randn(rng, (Bb, S, di), F32) * 0.5
    u = torch.from_numpy(rng.uniform(-4.0, 3.0, (Bb, S, di)).astype(np.float32)).to(DEV)
    A = -torch.arange(1, N + 1, dtype=F32, device=DEV).expand(di, N).contiguous()
    return (x.to(x_dtype), F.softplus(u), A, randn(rng, (Bb, S, N), F32) * 0.5,
            randn(rng, (Bb, S, N), F32) * 0.5)


def check_ssm_scan(rng) -> float:
    """y and the final state against the plain version at 1e-4: the
    reference's grid (Bb 2), ragged sizes, falcon-mamba's A and dt range at
    ragged d_inner (200, 130) and N (16, 3) and at full width from a state,
    and falcon-mamba's prefill (from a state) and decode step (S = 1, the
    state written in place)."""
    worst = 0.0
    grid = [(2, 128, 64, 8, F32, scan_inputs), (2, 64, 128, 16, F32, scan_inputs),
            (2, 96, 32, 4, F32, scan_inputs), (3, 37, 200, 16, BF, scan_inputs),
            (2, 5, 130, 3, F32, scan_inputs),
            (2, 77, 200, 16, BF, falcon_scan_inputs), (2, 45, 200, 3, F32, falcon_scan_inputs),
            (3, 70, 130, 16, F32, falcon_scan_inputs), (2, 33, 130, 3, BF, falcon_scan_inputs),
            (2, 1, 200, 16, BF, falcon_scan_inputs)]
    for Bb, S, di, N, xd, draw in grid:
        args = draw(rng, Bb, S, di, N, xd)
        (y, h), (wy, wh) = ssm_mod.ssm_scan(*args), ssm_mod.ssm_scan_plain(*args)
        name = f"ssm_scan {draw.__name__} Bb{Bb} S{S} di{di} N{N} {xd}"
        worst = max(worst, check_close(name, y, wy, F32, SCAN_TOL),
                    check_close(name + " hT", h, wh, F32, SCAN_TOL))
    args = falcon_scan_inputs(rng, 4, 256, 8192, 16, BF)
    h0 = randn(rng, (4, 8192, 16), F32) * 0.5
    (y, h), (wy, wh) = ssm_mod.ssm_scan(*args, h0), ssm_mod.ssm_scan_plain(*args, h0)
    worst = max(worst, check_close("ssm_scan falcon A full width", y, wy, F32, SCAN_TOL),
                check_close("ssm_scan falcon A full width hT", h, wh, F32, SCAN_TOL))
    Bb, di, N = 4, 8192, 16
    args = scan_inputs(rng, Bb, 1024, di, N, BF)
    h0 = randn(rng, (Bb, di, N), F32) * 0.5
    (y, h), (wy, wh) = ssm_mod.ssm_scan(*args, h0), ssm_mod.ssm_scan_plain(*args, h0)
    worst = max(worst, check_close("ssm_scan prefill", y, wy, F32, SCAN_TOL),
                check_close("ssm_scan prefill hT", h, wh, F32, SCAN_TOL))
    args = scan_inputs(rng, Bb, 1, di, N, BF)
    state = h0.clone()
    y, h = ssm_mod.ssm_scan(*args, state, out_state=state)
    wy, wh = ssm_mod.ssm_scan_plain(*args, h0)
    if h.data_ptr() != state.data_ptr():
        raise AssertionError("ssm_scan decode: the state was not written in place")
    return max(worst, check_close("ssm_scan decode", y, wy, F32, SCAN_TOL),
               check_close("ssm_scan decode hT", state, wh, F32, SCAN_TOL))


def time_cache_share(rng, S, K) -> dict:
    cap = H100.cache_capacity
    ws = torch.from_numpy(rng.random((S, K)) * cap).to(DEV)
    present = torch.from_numpy(rng.random((S, K)) < 0.9).to(DEV)
    n = S * K
    b_ms, by = bound(n * (8 + 1 + 8), 5.0 * n, torch.float64)
    return {"shape": f"({S}, {K}) f64", "dtype": "float64",
            **time_ms(lambda i: cs_mod.cache_share(ws, present, cap)),
            "plain_ms": time_ms(lambda i: cs_mod.cache_share_plain(ws, present, cap))["ms"],
            "library_ms": None, "bound_ms": b_ms, "bound_by": by}


def time_ssm_scan(rng, Bb, S, with_state) -> dict:
    """The scan at falcon-mamba's widths (d_inner 8192, N 16), x in bf16.
    Bound: the larger of its bytes (x, dt, y once, A, B, C, the states),
    its f32 operations (7 per state and step, one per channel and step)
    and its exps over the multi-function units' rate."""
    di, N = 8192, 16
    x, dt, A, B, C = scan_inputs(rng, Bb, S, di, N, BF)
    h0 = randn(rng, (Bb, di, N), F32) * 0.1 if with_state else None
    n = Bb * S * di
    bytes_moved = (n * (2 + 4 + 4) + A.numel() * 4 + 2 * B.numel() * 4
                   + (2 if with_state else 1) * Bb * di * N * 4)
    b_ms, by = bound(bytes_moved, n * (7.0 * N + 1), F32)
    t_exp = n * N / EXP_PER_S * 1e3
    reps = 3 if S > 1 else 7
    plain = time_ms(lambda i: ssm_mod.ssm_scan_plain(x, dt, A, B, C, h0),
                    iters=1, reps=reps)["ms"]
    return {"shape": f"x ({Bb}, {S}, {di}) bf16, N {N}" + (", from h0" if with_state else ""),
            "dtype": "bfloat16", **time_ms(lambda i: ssm_mod.ssm_scan(x, dt, A, B, C, h0)),
            "plain_ms": plain, "library_ms": None, "bound_ms": max(b_ms, t_exp),
            "bound_by": "operations" if t_exp > b_ms else by,
            "bound_term": "exp on the multi-function units" if t_exp > b_ms else (
                "device-memory bytes" if by == "bytes" else "f32 operations"),
            "bytes_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "exp_ms": t_exp}


# a decode batch's valid lengths over the engine's cache (8 x 1,025): two
# idle slots read it all
MIXED_LENS = [1025, 1025, 64, 200, 333, 512, 800, 1000]


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    errs = {"rmsnorm": check_rmsnorm(rng), "flash_decode": check_flash_decode(rng),
            "flash_attention": check_flash_attention(rng),
            "cache_share": check_cache_share(rng), "ssm_scan": check_ssm_scan(rng)}
    emit(phase="kernels_checked", max_abs_err=errs,
         tolerance={"float32": TOL[F32], "bfloat16": TOL[BF], "cache_share": "bit-exact",
                    "ssm_scan": SCAN_TOL})
    times = {
        "rmsnorm": [time_rmsnorm(rng, (1, 128, 2048)), time_rmsnorm(rng, (8, 1, 2048))],
        "flash_decode": [time_flash_decode(rng, MIXED_LENS, "B=8 H=16 KVH=8 D=128 T=1025 mixed"),
                         time_flash_decode(rng, [1025] * 8, "B=8 H=16 KVH=8 D=128 T=1025 full")],
        "flash_attention": [time_flash_attention(rng, 128, 512),
                            time_flash_attention(rng, 128, 0),
                            time_flash_attention(rng, 768, 0)],
        "flash_attention_device_offsets": [time_flash_attention_offsets(rng, 0),
                                           time_flash_attention_offsets(rng, 512)],
        "cache_share": [time_cache_share(rng, 8, 2), time_cache_share(rng, 4096, 6)],
        "ssm_scan": [time_ssm_scan(rng, 4, 1024, False), time_ssm_scan(rng, 4, 1, True)],
    }
    emit(phase="kernel_times", times=times)
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:27"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/decode_attention.py:67"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:90"),
               "cache_share": ("src/repro_torch/csrc/cache_share.cu",
                               "src/repro/kernels/cache_share.py:59"),
               "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:66")}
    records = {}
    for name, (source, replaces) in sources.items():
        first = times[name][0]                 # the main path's first shape
        records[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": errs[name], "shape": first["shape"],
                         **{k: first[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
                         **{k: first[k] for k in ("body", "bm", "kv_splits", "chunk")
                            if k in first}}
    return records


# --------------------------------------------------------------------- #
#  phase 3b: the four stressors                                          #
# --------------------------------------------------------------------- #
# the reference's tolerances (tests/test_kernels.py), bf16 mxu at 2e-2
STRESS_TOL = {"stress_mxu": {F32: 1e-4, BF: 2e-2}, "stress_vpu": 1e-5,
              "stress_vmem": 1e-5}                 # stress_hbm: bit-exact
STRESS_SOURCES = {"stress_mxu": "src/repro/kernels/stressors.py:46",
                  "stress_vpu": "src/repro/kernels/stressors.py:80",
                  "stress_hbm": "src/repro/kernels/stressors.py:102",
                  "stress_vmem": "src/repro/kernels/stressors.py:132"}


def check_exact(name, got, want) -> float:
    """Fail unless ``got`` equals ``want`` byte for byte."""
    torch.cuda.synchronize()
    same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(
        got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))
    if not same:
        raise AssertionError(f"{name}: not a bit-exact copy")
    return 0.0


def check_stressor_call(call, name) -> float:
    """One dispatch of ``call`` on the kernel against the same on the plain
    version, on the same inputs."""
    got = call()
    with plain_versions():
        want = call()
    if call.kernel == "stress_hbm":
        return check_exact(name, got, want)
    tol = STRESS_TOL[call.kernel]
    dtype = call.args[0].dtype
    return check_close(name, got, want, dtype,
                       tol[dtype] if isinstance(tol, dict) else tol)


def check_stressors(rng) -> dict:
    """The four stressors against their plain versions, at the reference's
    shapes and tolerances, and at the card sizes that ``_stressor_call``
    gives the interference phase (λ = 0.9; the copy also with a
    cache-probe working set, where it loops several passes)."""
    worst = {name: 0.0 for name in STRESSORS}

    def note(name, err):
        worst[name] = max(worst[name], err)

    a, b = randn(rng, (2, 128, 128), F32), randn(rng, (128, 128), F32) * 0.1
    for dtype in (F32, BF):
        ad, bd = a.to(dtype), b.to(dtype)
        note("stress_mxu", check_close(
            f"stress_mxu {dtype}", st_mod.stress_mxu(ad, bd, 4),
            st_mod.stress_mxu_plain(ad, bd, 4), dtype, STRESS_TOL["stress_mxu"][dtype]))
    # the bf16 body's loop runs two iterations a turn: every remainder, and none
    ad, bd = a.to(BF), b.to(BF)
    for iters in (0, 1, 2, 3, 5):
        note("stress_mxu", check_close(
            f"stress_mxu bf16 iters {iters}", st_mod.stress_mxu(ad, bd, iters),
            st_mod.stress_mxu_plain(ad, bd, iters), BF, STRESS_TOL["stress_mxu"][BF]))
    x = randn(rng, (256, 128), F32)
    for ilp in (1, 2, 4):
        note("stress_vpu", check_close(
            f"stress_vpu ilp{ilp}", st_mod.stress_vpu(x, 16, ilp),
            st_mod.stress_vpu_plain(x, 16, ilp), F32, STRESS_TOL["stress_vpu"]))
    xb = randn(rng, (2048, 128), BF)
    note("stress_hbm", check_exact("stress_hbm bf16", st_mod.stress_hbm(xb), xb))
    x = randn(rng, (512, 128), F32)
    for stride in (1, 8, 32):
        note("stress_vmem", check_close(
            f"stress_vmem stride{stride}", st_mod.stress_vmem(x, 8, stride),
            st_mod.stress_vmem_plain(x, 8, stride), F32, STRESS_TOL["stress_vmem"]))
    # the card sizes: stress_mxu at 119 tiles and the sized iteration count
    specs = [StressorSpec(axis, 0.9) for axis in gpu_native.AXES]
    specs.append(StressorSpec("hbm", 0.5, working_set=0.25 * H100.cache_capacity))
    for spec in specs:
        call = _stressor_call(spec, DEV)
        if call.kernel == "stress_mxu" and call.blocks != 119:
            raise AssertionError(f"stress_mxu at λ 0.9: {call.blocks} tiles, not 119")
        note(call.kernel, check_stressor_call(
            call, f"{call.kernel} card size {spec} {call.kwargs}"))
    return worst


def time_stressor(call, name, bytes_moved, operations, dtype, smem_wavefronts=0.0,
                  library=None) -> dict:
    """``time_ms`` of one dispatch of ``call`` (five per graph: each is a
    millisecond or so), its plain version's time, and its bound: the larger
    of device-memory bytes over the card's rate, shared-memory wavefronts
    at one a clock on each SM the grid covers, and operations over the
    type's peak on the SMs the grid covers (a stressor's block holds its
    SM: 119 blocks have 119 / 132 of the tensor cores or FP32 pipes, but
    device memory is not divided by SM, so its rate stays the card's)."""
    sms = min(call.blocks, N_SMS)
    b_ms, by = bound(bytes_moved, operations, dtype, sms / N_SMS)
    t_smem = smem_wavefronts / (sms * SM_CLOCK_HZ) * 1e3
    term = "shared-memory wavefronts" if t_smem > b_ms else (
        "device-memory bytes" if by == "bytes" else "operations")
    with plain_versions():
        plain = time_ms(lambda i: call(), iters=1, reps=3)["ms"]
    return {"shape": name, "dtype": str(dtype).replace("torch.", ""),
            "blocks": call.blocks, "sms_covered": sms, **call.kwargs,
            **time_ms(lambda i: call(), iters=5, reps=5),
            "plain_ms": plain,
            "library_ms": time_ms(library, iters=5, reps=5)["ms"] if library else None,
            "bound_ms": max(b_ms, t_smem),
            "bound_by": "bytes" if t_smem > b_ms else by, "bound_term": term}


def time_stressors() -> dict:
    """Each stressor at the card size of λ = 0.9 (119 of 132 SMs)."""
    out = {}
    call = _stressor_call(StressorSpec("mxu", 0.9), DEV)
    n, T, it = call.blocks, st_mod.MXU_TILE, call.kwargs["iters"]
    out["stress_mxu"] = time_stressor(call, f"a ({n}, {T}, {T}) bf16, iters {it}",
                                      (2 * n + 1) * T * T * 2, n * it * 2.0 * T ** 3, BF)
    call = _stressor_call(StressorSpec("vpu", 0.9), DEV)
    x, it, ilp = call.args[0], call.kwargs["iters"], call.kwargs["ilp"]
    out["stress_vpu"] = time_stressor(call, f"x {tuple(x.shape)} f32, iters {it}, ilp {ilp}",
                                      2 * x.numel() * 4, x.numel() * it * ilp * 2.0, F32)
    # the copy once (passes = 1), so that it is the library's function too
    call = _stressor_call(StressorSpec("hbm", 0.9), DEV)
    call.kwargs["passes"] = 1
    x = call.args[0]
    y = torch.empty_like(x)
    out["stress_hbm"] = time_stressor(call, f"x {tuple(x.shape)} f32 ({x.numel() * 4} B), one pass",
                                      2 * x.numel() * 4, 0.0, F32,
                                      library=lambda i: y.copy_(x))
    # two reads and a write of every element an iteration, a warp's 32
    # accesses in as many wavefronts as the stride's bank conflicts make
    call = _stressor_call(StressorSpec("smem", 0.9), DEV)
    x, it, stride = call.args[0], call.kwargs["iters"], call.kwargs["stride"]
    degree = st_mod.vmem_conflict_degree(stride, min(512, x.shape[0]))
    out["stress_vmem"] = time_stressor(call, f"x {tuple(x.shape)} f32, iters {it}, stride {stride}",
                                       2 * x.numel() * 4, 0.0, F32,
                                       smem_wavefronts=it * 3 * x.numel() / 32 * degree)
    out["stress_vmem"]["conflict_degree"] = degree
    return out


def ilp_and_stride_times() -> dict:
    """``stress_vpu`` at ilp 1, 2, 4, 8 and ``stress_vmem`` at stride 1, 8,
    32, each at one block per SM and the same iterations: the chains are
    separate if the time stays while ilp grows, and the bank conflicts
    follow the stride if the time grows with it."""
    call = _stressor_call(StressorSpec("vpu", 1.0), DEV)
    x, it = call.args[0], call.kwargs["iters"]
    ilp = {k: time_ms(lambda i, k=k: st_mod.stress_vpu(x, it, k), iters=5, reps=5)["ms"]
           for k in (1, 2, 4, 8)}
    vcall = _stressor_call(StressorSpec("smem", 1.0), DEV)
    xv, vit = vcall.args[0], vcall.kwargs["iters"]
    stride = {s: time_ms(lambda i, s=s: st_mod.stress_vmem(xv, vit, s), iters=5, reps=5)["ms"]
              for s in (1, 8, 32)}
    return {"vpu": {"x": list(x.shape), "iters": it, "ms_by_ilp": ilp},
            "vmem": {"x": list(xv.shape), "iters": vit, "ms_by_stride": stride}}


def stressor_shares() -> list:
    """For each axis and λ of the fit grid: the rate the stressor reaches
    alone (its work over its median device time on a stream) as a share
    of the H100 model's capacity and of the data sheet's rate."""
    stream = torch.cuda.Stream()
    rows = []
    for axis in gpu_native.AXES:
        for lam in FIT_LAMBDAS:
            call = _stressor_call(StressorSpec(axis, lam), DEV)
            torch.cuda.synchronize()
            t, iqr = median_iqr_time(call, repeats=5, warmup=1, stream=stream)
            rate = call.work / t
            rows.append({"axis": axis, "lambda": lam, "blocks": call.blocks,
                         "kernel": call.kernel, "ms": t * 1e3, "iqr_ms": iqr * 1e3,
                         "rate": rate, "share_of_model": rate / H100.capacity(axis),
                         "share_of_sheet": rate / SHEET_RATE[axis]})
    return rows


def phase_stressors(records: dict) -> None:
    rng = np.random.default_rng(1)
    errs = check_stressors(rng)
    emit(phase="stressors_checked", max_abs_err=errs,
         tolerance={"stress_mxu": {"float32": 1e-4, "bfloat16": 2e-2},
                    "stress_vpu": 1e-5, "stress_hbm": "bit-exact",
                    "stress_vmem": 1e-5})
    times = time_stressors()
    emit(phase="stressor_times", times=times)
    emit(phase="stressor_ilp_stride", **ilp_and_stride_times())
    emit(phase="stressor_shares", sm_clock_hz=SM_CLOCK_HZ,
         model=H100.name, rows=stressor_shares())
    for name, t in times.items():
        records[name] = {"name": name, "route": "cuda",
                         "source": "src/repro_torch/csrc/stressors.cu",
                         "replaces": STRESS_SOURCES[name], "launches": 0,
                         "max_abs_err": errs[name], "shape": t["shape"],
                         **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}}


# --------------------------------------------------------------------- #
#  phase 4: serve, small and exact                                       #
# --------------------------------------------------------------------- #
def phase_serve_small() -> None:
    """tiny_config(qwen3-1.7b) itself (head_dim 16, d_model 64) in f32: the
    engine on the kernels, its steps replayed from CUDA graphs, gives the
    tokens of greedy full-forward generation on the plain versions."""
    cfg = tiny_config(get_config("qwen3-1.7b")).with_overrides(param_dtype="float32")
    reset_counts()
    eng = Engine(cfg, ecfg=EngineConfig(max_slots=2, max_len=96, prefill_chunk=16,
                                        mode="interference_aware"), device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (9, 23, 40)]
    ids = [eng.submit(p, max_new=6) for p in prompts]
    metrics = eng.run_until_done()
    steps = list(eng.steps.values())
    captured = at_capture(steps)
    if (not all(step.graph is not None for step in steps)
            or counts(SERVING) != {name: captured.get(name, 0) for name in SERVING}):
        raise AssertionError(f"small serve: a step ran uncaptured: {counts(SERVING)}")
    used = {name: replayed(steps).get(name, 0) for name in SERVING}
    if not all(used.values()):
        raise AssertionError(f"small serve skipped a kernel: {used}")
    with plain_versions(), torch.no_grad():
        for i, prompt in zip(ids, prompts):
            toks = list(prompt)
            for _ in range(6):
                logits = eng.model.forward(
                    eng.params, {"tokens": torch.tensor([toks], device=DEV)})
                toks.append(int(torch.argmax(logits[0, -1])))
            if metrics[i]["output"] != toks[len(prompt):]:
                raise AssertionError(f"small serve: request {i} gave "
                                     f"{metrics[i]['output']}, plain greedy "
                                     f"{toks[len(prompt):]}")
    emit(phase="serve_small", config=cfg.name, dtype="float32", head_dim=cfg.attn.head_dim,
         requests=len(prompts), tokens_equal=True, launches=used)


# --------------------------------------------------------------------- #
#  phase 5: serve, full width                                            #
# --------------------------------------------------------------------- #
def serve_stats(eng, metrics, seconds, max_new) -> dict:
    if len(metrics) != 8 or any(m["new_tokens"] != max_new for m in metrics.values()):
        raise AssertionError(f"serve: not every request finished with {max_new} tokens")
    for m in metrics.values():
        if not all(0 <= t < eng.cfg.vocab_size for t in m["output"]):
            raise AssertionError("serve: token id out of range")
    decode_t = [e.t for e in eng.events if e.kind == "decode"]
    gaps = np.diff(decode_t) * 1e3
    chunks = [e.detail["chunk"] for e in eng.events if e.kind == "prefill_chunk"]
    new = sum(m["new_tokens"] for m in metrics.values())
    return {"mode": eng.ecfg.mode, "seconds": seconds, "new_tokens": new,
            "tokens_per_s": new / seconds,
            "prompt_tokens": sum(m["prompt_len"] for m in metrics.values()),
            "decode_steps": len(decode_t), "prefill_chunks": len(chunks),
            "chunk_sizes": chunks,
            "worst_decode_gap_ms": float(gaps.max()) if len(gaps) else 0.0,
            "median_decode_gap_ms": float(np.median(gaps)) if len(gaps) else 0.0,
            "mean_ttft_s": float(np.mean([m["ttft_s"] for m in metrics.values()]))}


def logits_close(name, got, want) -> float:
    """The reference's tolerance for bf16 logits (rtol 0.15, atol 0.3)."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: logits not finite")
    err = (got - want).abs()
    if not (err <= 0.3 + 0.15 * want.abs()).all():
        raise AssertionError(f"{name}: logits differ by {err.max().item():.3f}")
    return err.max().item()


def serve_prompts(cfg, rng) -> list:
    """The fixed seeded request mix (``rng`` seeded 0): 8 prompts of 64 to
    768 tokens."""
    return [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(64, 769, size=8)]


def serve_graphed(cfg, ecfg, prompts, max_new, params) -> tuple:
    """``serve`` on the captured steps (counts of this serve only), with
    the gates of the replay: every step of the engine is a CUDA graph and
    the wrappers launched nothing besides the warm-ups and captures, so no
    step ran eagerly. Returns (engine, metrics, seconds, the launches on
    the card: each step's captured launches times its replays)."""
    reset_counts()
    eng, metrics, seconds = serve(cfg, ecfg, prompts, max_new, device=DEV, params=params)
    steps = list(eng.steps.values())
    if not all(step.graph is not None for step in steps):
        raise AssertionError("serve: a step of the engine was not captured")
    raw, captured = counts(SERVING), at_capture(steps)
    if raw != {name: captured.get(name, 0) for name in SERVING}:
        raise AssertionError(f"serve: the wrappers launched {raw}, the captures {captured}")
    used = replayed(steps)
    return eng, metrics, seconds, {name: used.get(name, 0) for name in SERVING}


def padding(eng) -> dict:
    """The extend steps' rows: the chunks' tokens and the padding up to
    their buckets."""
    chunks = [e.detail["chunk"] for e in eng.events if e.kind == "prefill_chunk"]
    real, rows = sum(chunks), sum(chunk_bucket(c) for c in chunks)
    return {"prefill_tokens": real, "prefill_rows_padded": rows - real,
            "padding_share_of_rows": (rows - real) / rows if rows else 0.0}


def phase_serve_full(records: dict) -> tuple:
    """Returns the model's parameters, which the solver phase serves again,
    and the profiles of its decode and extend replays."""
    cfg = get_config("qwen3-1.7b")
    L, max_new = cfg.n_layers, 32
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg, device=DEV).init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    emit(phase="weights", config=cfg.name, n_params=n_params, dtype=cfg.param_dtype,
         seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(0)
    prompts = serve_prompts(cfg, rng)
    # one short unmeasured serve first: the kernels' first launches and the
    # library's first products of each shape load code, which is set-up
    serve(cfg, EngineConfig(max_slots=8, max_len=1024, prefill_chunk=128),
          [p[:200] for p in prompts[:3]], 4, device=DEV, params=params)
    for mode in ("interference_aware", "serial"):
        ecfg = EngineConfig(max_slots=8, max_len=1024, prefill_chunk=128, mode=mode)
        stats = serve_checked(cfg, ecfg, prompts, max_new, params)
        emit(phase="serve_full", config=cfg.name, **stats)
        if mode == "interference_aware":
            for name, n in stats["launches"].items():
                records[name]["launches"] = n
            records["rmsnorm"]["launches_per_step"] = 2 * L + 1
            records["flash_attention"]["launches_per_prefill_chunk"] = L
            records["flash_decode"]["launches_per_decode_step"] = L
    eng = Engine(cfg, params=params, ecfg=EngineConfig(max_slots=8, max_len=1024),
                 device=DEV)
    errs, profiles, _ = step_logits_and_profiles(eng, rng)
    emit(phase="serve_full_logits", max_abs_err=errs,
         tolerance={"rtol": 0.15, "atol": 0.3})
    emit(phase="step_profile", **profiles)
    return params, profiles


def serve_checked(cfg, ecfg, prompts, max_new, params) -> dict:
    """One serve on the captured steps and its gates: every request's
    tokens in range, the launches those of the steps run (``2 L + 1``
    ``rmsnorm`` a step, ``L`` ``flash_attention`` a chunk and ``L``
    ``flash_decode`` a decode step, from captures x replays), and the same
    serve on the steps' bodies run uncaptured giving the same tokens and
    chunks with the same launches from Python. Returns the serve's record,
    its peak memory that of the captured serve."""
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    eng, metrics, seconds, used = serve_graphed(cfg, ecfg, prompts, max_new, params)
    stats = serve_stats(eng, metrics, seconds, max_new)
    stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    stats["launches"] = used
    stats["capture_s"] = sum(step.capture_s for step in eng.steps.values())
    stats.update(padding(eng))
    del eng
    n_dec, n_ext = stats["decode_steps"], stats["prefill_chunks"]
    want = {"rmsnorm": (2 * L + 1) * (n_dec + n_ext),
            "flash_attention": L * n_ext, "flash_decode": L * n_dec}
    mode = f"{cfg.name} {ecfg.mode}"
    if used != want or not all(used.values()):
        raise AssertionError(f"serve {mode}: launches {used}, the steps imply {want}")
    # the same serve on the steps' bodies, uncaptured: the same tokens
    # and chunks, each kernel launched from Python once a call
    reset_counts()
    with uncaptured():
        eng_u, metrics_u, seconds_u = serve(cfg, ecfg, prompts, max_new, device=DEV,
                                            params=params)
    if counts(SERVING) != want:
        raise AssertionError(f"serve {mode} uncaptured: launches {counts(SERVING)}, "
                             f"the steps imply {want}")
    plain = serve_stats(eng_u, metrics_u, seconds_u, max_new)
    del eng_u
    if ({i: m["output"] for i, m in metrics_u.items()}
            != {i: m["output"] for i, m in metrics.items()}
            or plain["chunk_sizes"] != stats["chunk_sizes"]):
        raise AssertionError(f"serve {mode}: the uncaptured steps gave other tokens or chunks")
    stats["uncaptured"] = {k: plain[k] for k in ("seconds", "tokens_per_s", "decode_steps",
                                                  "worst_decode_gap_ms",
                                                  "median_decode_gap_ms", "mean_ttft_s")}
    stats["uncaptured"]["tokens_and_chunks_equal"] = True
    return stats


def step_logits_and_profiles(eng, rng) -> tuple:
    """One extend (three chunks of slot 3: the path's 128 at pos0 0 and
    128, and 100 tokens padded to 128) and one decode step (slot 3 at
    position 356, the other slots idle), each replayed against its body run
    uncaptured on the plain versions, on the same static input, at the
    reference's bf16 tolerance, and for a dense model the last extend and
    the decode step against the forward over the slot's 357 tokens; then the profiles of a decode replay and of
    a 128-token extend replay. For the moe family the body also runs
    uncaptured on the kernels, recording each layer's routing, and must
    equal the replay bit for bit; the plain run replays that routing
    (``routing``): the kernels are held, not the discrete routing. Returns
    (errors, profiles, agreement): ``agreement`` (None for a dense model)
    is ``routing_agreement``'s tally of the plain run's own routing against
    the kernels'."""
    moe = eng.cfg.family == "moe"
    tok = rng.integers(1, eng.cfg.vocab_size, size=512)
    dtok = rng.integers(1, eng.cfg.vocab_size, size=8)
    pos = np.full(8, 1024)
    pos[3] = 356
    errs, tally = {}, np.zeros((eng.cfg.n_layers, 2), np.int64)

    def check(name, got, step, rows, tokens):
        """``rows``: the logits compared; ``tokens``: the MoE's real rows."""
        if not moe:
            with plain_versions():
                want = step.body()
            errs[name] = logits_close(name, got[rows], want[rows])
            return
        kern, plain = [], []
        with routing(record=kern):
            ran = step.body()
        with plain_versions(), routing(record=plain, replay=kern):
            want = step.body()
        errs[name] = logits_close(name, ran[rows], want[rows])
        diff = (got - ran).abs().max().item()
        if diff != 0.0:
            raise AssertionError(f"{name}: the replay is {diff} from its body run uncaptured")
        errs[name + "_graph_vs_uncaptured"] = diff
        tally[:] += agreement(kern, plain, tokens, eng.cfg.n_layers)

    for pos0, c in ((0, 128), (128, 128), (256, 100)):
        extended = eng._extend(tok[pos0:pos0 + c], 3, pos0).clone()
        check(f"extend_pos0_{pos0}_c{c}", extended, eng.steps[chunk_bucket(c)], slice(None),
              slice(0, c))
    got = eng._decode(dtok, pos).clone()
    check("decode", got, eng.steps["decode"], slice(3, 4), slice(3, 4))
    if not moe:     # the moe forward's capacity would drop other tokens than the steps'
        with torch.no_grad():
            full = eng.model.forward(eng.params, {"tokens": torch.from_numpy(
                np.r_[tok[:356], dtok[3]])[None].to(DEV)})
        errs["extend_vs_forward"] = logits_close("extend vs forward", extended[0, 0], full[0, 355])
        errs["decode_vs_forward"] = logits_close("decode vs forward", got[3, 0], full[0, 356])
        del full
    n = 2 if moe else 4             # a moe replay launches about 5,600 kernels
    profiles = {"decode": profile_step(lambda: eng._decode(dtok, pos).argmax(-1).tolist(),
                                       eng.steps["decode"], n),
                "extend_128": profile_step(
                    lambda: eng._extend(tok[128:256], 3, 128).argmax(-1).tolist(), eng.steps[128],
                    n)}
    return errs, profiles, routing_agreement(tally, "steps") if moe else None


@contextlib.contextmanager
def routing(record=None, replay=None):
    """Within the block every call of the MoE router (``moe._route``)
    appends its (gates, ids) to ``record``; with ``replay``, the record of
    an earlier run of the same calls, each call returns that run's (gates,
    ids) in place of its own (and its own aux). Only this script does so:
    the kernels are held against their plain versions on one routing,
    since one expert chosen otherwise moves a token's logits past any
    tolerance."""
    real = moe_mod._route
    queue = iter(replay or ())

    def wrapped(router, x_flat, cfg):
        gates, ids, aux = real(router, x_flat, cfg)
        if record is not None:
            record.append((gates, ids))
        if replay is not None:
            gates, ids = next(queue)
        return gates, ids, aux

    moe_mod._route = wrapped
    try:
        yield
    finally:
        moe_mod._route = real


def agreement(a, b, rows, L: int) -> np.ndarray:
    """Two records of the same router calls, runs of an L-layer stack (L
    calls a run, in layer order): for each layer, the rows in ``rows``
    whose expert sets agree, and the rows compared, an (L, 2) array."""
    out = np.zeros((L, 2), np.int64)
    for i, ((_, ia), (_, ib)) in enumerate(zip(a, b, strict=True)):
        same = (ia[rows].sort(dim=1).values == ib[rows].sort(dim=1).values).all(dim=1)
        out[i % L] += (int(same.sum()), same.numel())
    return out


# the least share of the first layer's tokens whose experts the plain run's
# router chooses as the kernels' run's did (the routing replayed): the first
# router reads one attention and two norms, so a fault of a kernel there
# moves it before anything has built up. moonshot's seeded run reads 0.978
# in the steps and 0.976 in the prefill (PERF.md), 2.6 points above
FIRST_LAYER_AGREEMENT = 0.95


def routing_agreement(tally: np.ndarray, what: str) -> dict:
    """``agreement``'s tally as shares: in all, by layer, and the first
    layer's, which must be at least ``FIRST_LAYER_AGREEMENT``. With the
    routing replayed, a layer's share counts the flips that the kernels'
    numerical differences, built up to that layer, cause there; a flip does
    not move the later layers' routing."""
    share = tally[:, 0] / tally[:, 1]
    out = {"pairs": int(tally[:, 1].sum()), "share": float(tally[:, 0].sum() / tally[:, 1].sum()),
           "first_layer": float(share[0]), "first_layer_pairs": int(tally[0, 1]),
           "by_layer": [round(float(x), 4) for x in share]}
    if out["first_layer"] < FIRST_LAYER_AGREEMENT:
        raise AssertionError(f"{what}: the first layer's routing agrees on {out['first_layer']} "
                             f"of {out['first_layer_pairs']} tokens, under "
                             f"{FIRST_LAYER_AGREEMENT}")
    return out


# the first kernel each serving wrapper launches, by the name the trace gives it
KERNEL_SYMBOLS = {"rmsnorm": "rmsnorm_kernel", "flash_attention": "flash_attention_mma_kernel",
                  "flash_decode": "decode_partial_kernel"}


# empty launches that open every profile, for the trace to drop in place of
# the steps' kernels
PROFILE_PREFIX = 8192


def profile_step(step_fn, step=None, n: int = 4) -> dict:
    """Where one engine step's time goes: its wall time (host clock, ending
    when the sampled ids are on the host, no profiler attached) beside the
    time the device was busy in it (kernel times summed from a
    torch.profiler trace of the same steps), and the kernels that took most.

    The trace holds the ``n`` steps between ``n + 1`` launches of the empty
    kernel ``rt_empty`` and counts them one by one; a marker the trace
    lacks fails. For a captured ``step``, each replay's kernels of each
    serving wrapper must number what the capture counted; a trace that
    shows none of them does not resolve the graph, and then nothing is
    reported as measured on the device.

    A trace drops its first few device events, more of them the more
    traces the process has taken (``lost_at_start``). So every trace opens
    with ``PROFILE_PREFIX`` one-thread ``torch.cuda._sleep(0)`` launches,
    and fails if it lost all of them."""
    step_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    prof = start_trace()
    for _ in range(n):
        mark()
        step_fn()
    mark()
    torch.cuda.synchronize()
    prof.stop()
    return read_trace(prof, wall_ms, step, n)


def mark() -> None:
    """One launch of the empty kernel: a marker between traced steps."""
    _build.check_launch(_build.load().rt_empty(_build.stream_ptr()), "rt_empty")


def start_trace():
    """A started torch.profiler trace of the host and the device, opened
    with ``PROFILE_PREFIX`` launches of ``torch.cuda._sleep(0)`` (see
    ``profile_step``); the caller marks each step, synchronises and stops
    it."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(PROFILE_PREFIX):
        torch.cuda._sleep(0)
    return prof


class DeviceEvent(NamedTuple):
    name: str
    start_us: float            # from the trace's first device event
    device_time: float         # µs


def device_events(prof) -> list:
    """The device events of a stopped trace, in order of their start, read
    from the profiler's own results: far quicker than building its tree of
    host and device events (``prof.events()``), which took 18 s for a
    training step's 35,000 kernels on an H100."""
    raw = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    t0 = min((start for _, start, _ in raw), default=0)
    return sorted((DeviceEvent(name, (start - t0) / 1e3, dur / 1e3) for name, start, dur in raw),
                  key=lambda ev: ev.start_us)


def read_trace(prof, wall_ms: float, step=None, n: int = 4) -> dict:
    """``profile_step``'s reading of a trace of ``n`` marked steps, each of
    ``wall_ms`` on the host clock when not traced."""
    device = device_events(prof)
    out = {"wall_ms": wall_ms}
    if not device:
        out["device_busy_ms"] = "not measured"
        return out
    what = step.name if step is not None else "profile"

    def serving(name):
        return {w: int(sym in name) for w, sym in KERNEL_SYMBOLS.items()}

    if step is not None and not any(any(serving(ev.name).values()) for ev in device):
        out["replay_kernels"] = {w: 0 for w in KERNEL_SYMBOLS}
        out["captured_launches"] = step.launches
        out["device_busy_ms"] = "not measured: the trace does not resolve the graph's kernels"
        return out
    marks = [i for i, ev in enumerate(device) if ev.name.startswith("empty_kernel")]
    prefix = sum("spin_kernel" in ev.name for ev in device[:marks[0] if marks else None])
    if not prefix:
        raise AssertionError(f"{what}: the trace lost every one of its {PROFILE_PREFIX} "
                             "opening launches")
    out["lost_at_start"] = PROFILE_PREFIX - prefix
    if len(marks) != n + 1:
        at = [round(device[i].start_us / 1e3, 3) for i in marks]
        raise AssertionError(f"{what}: the trace holds {len(marks)} of the {n + 1} markers, "
                             f"at {at} ms of its window")
    stray = [ev.name for ev in device[:marks[0]] + device[marks[-1] + 1:]
             if any(serving(ev.name).values())]
    if stray:
        raise AssertionError(f"{what}: serving kernels outside the traced steps: {stray[:4]}")
    kernels, per_step = {}, []
    for a, b in zip(marks, marks[1:]):
        c = dict.fromkeys(KERNEL_SYMBOLS, 0)
        for ev in device[a + 1:b]:
            t, k = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (t + ev.device_time, k + 1)
            for w, hit in serving(ev.name).items():
                c[w] += hit
        per_step.append(c)
    if step is not None:
        out["replay_kernels"] = {w: sum(c[w] for c in per_step) / n for w in KERNEL_SYMBOLS}
        out["captured_launches"] = step.launches
        want = {w: step.launches.get(w, 0) for w in KERNEL_SYMBOLS}
        if any(c != want for c in per_step):
            raise AssertionError(f"{what}: the traced replays ran {per_step}, the capture "
                                 f"counted {step.launches}")
    busy_ms = sum(t for t, _ in kernels.values()) / 1e3 / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {**out, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernels_per_step": sum(c for _, c in kernels.values()) / n,
            "top_kernels_ms_per_step": {name[:60]: round(t / 1e3 / n, 4) for name, (t, _) in top}}


# --------------------------------------------------------------------- #
#  the dry run: counts on the host, llama3.1-8b served, the plan priced  #
# --------------------------------------------------------------------- #
DRYRUN_MODELS = ("qwen3-1.7b", "llama3.1-8b")
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", dryrun_mod.ENGINE_DECODE)
DRYRUN_DIR = Path(__file__).resolve().parent / "results" / "dryrun_torch_smoke"
FLOP_GATE = 1e-3                   # the engine-shape record against the hand count
PRICE_TOL = 1e-9                   # the torch solver against NumPy


def hand_decode_flops(cfg, B: int, T: int) -> float:
    """One decode step's products by hand: 2 B x (the products' weight
    elements: q, k, v, o, the gated MLP's three, and the unembedding) +
    4 B H D T L for attention over the whole cache of T rows."""
    a = cfg.attn
    per_layer = (cfg.d_model * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                 + a.n_heads * a.head_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    weights = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    return 2.0 * B * weights + 4.0 * B * a.n_heads * a.head_dim * T * cfg.n_layers


def count_cells() -> dict:
    """Every cell of ``DRYRUN_SHAPES`` of both models counted on ``meta``
    by ``launch/dryrun.run_cell`` into ``DRYRUN_DIR``: its host seconds, and
    the gate that the card's allocated memory does not move while it
    counts. Returns {(arch, shape): record}."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    recs = {}
    for arch in DRYRUN_MODELS:
        for shape in DRYRUN_SHAPES:
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rec = dryrun_mod.run_cell(arch, shape, results=DRYRUN_DIR)
            host_s = time.perf_counter() - t0
            moved = torch.cuda.memory_allocated() - before
            name = rec["shape"]
            if moved:
                raise AssertionError(f"dryrun {arch} {name}: the card's allocated memory "
                                     f"moved by {moved} bytes while counting on meta")
            emit(phase="dryrun_cell", arch=arch, shape=name, host_s=host_s,
                 count_s=rec["compile_s"], aten_calls=rec["hlo_size_chars"],
                 hlo_exec=rec["hlo_exec"], memory=rec["memory"], run=rec["run"],
                 cuda_allocated_moved_bytes=moved)
            recs[(arch, name)] = rec
    return recs


def check_served_kernels(rng, cfg) -> dict:
    """The three kernels of a serve through the engine (llama3.1-8b's,
    gemma-2b's) against their plain versions at its shapes: the norms of a
    chunk and a decode step, ``flash_attention`` with device offsets over
    the engine's cache (8 slots x 1,025 positions) at the path's chunks,
    and ``flash_decode`` over that cache at a decode batch's mixed
    lengths, at the config's heads."""
    a, name = cfg.attn, cfg.name
    H, KVH, D = a.n_heads, a.n_kv_heads, a.head_dim
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for shape in ((128, cfg.d_model), (8, cfg.d_model)):     # a chunk, a decode step
        x, s = randn(rng, shape, BF), randn(rng, (shape[-1],), F32)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"rmsnorm{shape} {name}", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s), BF))
    ck, cv = path_cache(rng, 1, 8, 1025, KVH, D, BF)
    for S, c, pos0 in ((128, 128, 0), (128, 128, 512), (128, 100, 900), (16, 1, 40)):
        q = randn(rng, (1, S, H, D), BF)
        off = torch.tensor([3, pos0, c], device=DEV)
        errs["flash_attention"] = max(errs["flash_attention"], check_attention(
            f"flash_attention {name} offsets pos0 {pos0} c {c}",
            fa_mod.flash_attention(q, ck[0], cv[0], "causal", offsets=off),
            fa_mod.flash_attention_plain(q, ck[0], cv[0], "causal", offsets=off), BF))
    q = randn(rng, (8, 1, H, D), BF)
    lens = torch.tensor(MIXED_LENS, device=DEV)
    errs["flash_decode"] = check_attention(
        f"flash_decode {name} G {H // KVH}", dec_mod.flash_decode(q, ck[0], cv[0], lens),
        dec_mod.flash_decode_plain(q, ck[0], cv[0], lens), BF)
    return errs


def serve_at_full_size(cfg, key: str, label: str, records: dict, backend: str) -> dict:
    """A dense decoder at full width and depth (seeded random bf16 weights)
    served through the engine with the qwen3 mix, its chunks priced on the
    solver ``backend`` (torch: on the card, one ``cache_share`` launch a
    solve, ``fleet_run``'s gates): first its three kernels against their
    plain versions at its shapes, before any graph captures them; then the
    serve under ``serve_checked``'s gates, its steps' logits against the
    plain versions, the profiles of a decode and an extend replay; then the
    kernels timed, each shape with the serve's launches at it. ``key``
    names its entries in the ``kernels`` rows, ``label`` its phases.
    Returns the step profiles."""
    a, L = cfg.attn, cfg.n_layers
    rng = np.random.default_rng(4)
    kerr = check_served_kernels(rng, cfg)
    m, params, weights = facade_weights(cfg)
    emit(phase=f"{label}_weights", n_params_by_config=cfg.n_params(), **weights)
    prompts = serve_prompts(cfg, np.random.default_rng(0))
    ecfg = EngineConfig(max_slots=8, max_len=1024, prefill_chunk=128)
    stats, solver = fleet_run(f"{label}_serve", backend,
                              lambda: serve_checked(cfg, ecfg, prompts, 32, params))
    emit(phase=f"{label}_serve", config=cfg.name, solver=solver, **stats)
    for name in SERVING:
        records[name][f"launches_{key}"] = stats["launches"][name]
    records["rmsnorm"][f"launches_{key}_per_step"] = 2 * L + 1
    if backend == "torch":
        records["cache_share"][f"launches_{key}"] = solver["cache_share_launches"]
    eng = Engine(cfg, params=params, ecfg=EngineConfig(max_slots=8, max_len=1024), device=DEV)
    kv_bytes = sum(t.numel() * t.element_size() for t in leaves(eng.cache))
    errs, profiles, _ = step_logits_and_profiles(eng, np.random.default_rng(0))
    del eng, m, params
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase=f"{label}_serve_logits", max_abs_err=errs, tolerance={"rtol": 0.15, "atol": 0.3})
    emit(phase=f"{label}_step_profile", kv_cache_bytes=kv_bytes, **profiles)
    kvh, H, D = a.n_kv_heads, a.n_heads, a.head_dim
    times = {
        "rmsnorm": [time_rmsnorm(rng, (1, 128, cfg.d_model)), time_rmsnorm(rng, (8, 1, cfg.d_model))],
        "flash_attention": [time_flash_attention(rng, 128, 512, KVH=kvh, H=H, D=D),
                            time_flash_attention_offsets(rng, 512, KVH=kvh, H=H, D=D)],
        "flash_decode": [time_flash_decode(rng, MIXED_LENS,
                                           f"B=8 H={H} KVH={kvh} D={D} G={H // kvh} "
                                           "T=1025 mixed", H=H, KVH=kvh, D=D)],
    }
    # the serve's launches at each timed shape (serve_checked's ``want``):
    # the norms of the extend chunks and of the decode steps, attention
    # in the extend step's device-offset form, decode attention
    n_dec, n_ext = stats["decode_steps"], stats["prefill_chunks"]
    for t, n in zip(times["rmsnorm"] + times["flash_attention"] + times["flash_decode"],
                    ((2 * L + 1) * n_ext, (2 * L + 1) * n_dec, 0, L * n_ext, L * n_dec)):
        t["launches"] = n
    emit(phase=f"{label}_kernels", max_abs_err=kerr, tolerance={"bfloat16": TOL[BF]}, times=times)
    for name in SERVING:
        records[name][f"max_abs_err_{key}"] = kerr[name]
        records[name][key] = times[name]
    return profiles


def predictions(recs: dict, measured: dict) -> dict:
    """Each model's engine-shape decode record as a profile
    (``from_dryrun_json``), its ``isolated_time`` on the ``H100`` model
    beside the measured replay's device time; the record's products
    against the hand count (the gate, ``FLOP_GATE``)."""
    out = {}
    shape = dryrun_mod.ENGINE_DECODE
    for arch in DRYRUN_MODELS:
        rec = recs[(arch, shape.name)]
        want = hand_decode_flops(get_config(arch), shape.global_batch, shape.seq_len)
        got = rec["hlo_exec"]["mxu_flops"]
        if abs(got - want) > FLOP_GATE * want:
            raise AssertionError(f"dryrun {arch}: the decode record's mxu_flops {got:.6g} "
                                 f"against the hand count {want:.6g}")
        prof = from_dryrun_json(rec)
        predicted_ms = prof.isolated_time(H100) * 1e3
        busy = measured[arch].get("device_busy_ms")
        out[arch] = {"mxu_flops": got, "hand_count": want, "rel_err": got / want - 1,
                     "hbm_bytes": rec["hlo_exec"]["hbm_bytes"],
                     "bottleneck_on_h100_model": prof.bottleneck(H100),
                     "predicted_ms_h100_model": predicted_ms,
                     "measured_replay_device_ms": busy, "measured_replay_wall_ms":
                     measured[arch].get("wall_ms"),
                     "measured_over_predicted": (busy / predicted_ms
                                                 if isinstance(busy, float) else "not measured")}
    return out


def price_records(results: Path = DRYRUN_DIR, mesh: str = "dev1") -> dict:
    """``launch/profile``'s entry point over the phase's records. First as a
    user runs it, ``main(["--plan"])``: the torch solver on the card with
    its default search, every solve a replay with one ``cache_share``
    launch (``fleet_run``'s gate). Then with one explicit fraction search
    (the NumPy backend's default), ``--backend numpy`` and the default
    torch: the same bottlenecks, rankings and placements, scores and the
    plan's numbers within ``PRICE_TOL``."""
    profs = profile_mod.load_profiles(mesh_tag=mesh, results=results)
    argv = ["--plan", "--results", str(results), "--mesh", mesh]
    printed = {}

    def run(name, extra=(), search=None):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            fps, plan = profile_mod.main(argv + list(extra), search=search)
        printed[name] = text.getvalue()
        return ([[phase, neck, {a: float(v) for a, v in scores.items()}, list(ranked)]
                 for phase, neck, scores, ranked in fps],
                [[list(p.workloads), {k: float(v) for k, v in p.slot_fraction.items()},
                  {k: float(v) for k, v in p.predicted_slowdown.items()}, bool(p.meets_slo),
                  float(p.throughput_gain)] for p in plan.placements], list(plan.solo))

    search = FractionSearchConfig()
    (_, rec_main) = fleet_run(f"dryrun_profile_{mesh}_main", "torch", lambda: run("main"))
    (want, rec_np) = fleet_run(f"dryrun_profile_{mesh}_numpy", "numpy",
                               lambda: run("numpy", ("--backend", "numpy"), search))
    (got, rec_t) = fleet_run(f"dryrun_profile_{mesh}_torch", "torch",
                             lambda: run("torch", (), search))
    values_close(got, want, PRICE_TOL, f"dryrun profile {mesh}")
    fps, placements, solo = got
    return {"profiles": len(profs), "fingerprints": [
                {"phase": n, "bottleneck": b, "top4": r[:4],
                 "scores": {a: s[a] for a in r[:4]}} for n, b, s, r in fps],
            "placements": [{"workloads": w, "predicted_slowdown": sl, "meets_slo": ok,
                            "gain": g} for w, _, sl, ok, g in placements], "solo": solo,
            "main": rec_main, "main_printed": printed["main"].splitlines(),
            "numpy": rec_np, "torch": rec_t, "equal_at": PRICE_TOL}


def phase_dryrun(records: dict, qwen3_profiles: dict) -> dict:
    """The parallel and launch layers' card path. (a) ``launch/dryrun``
    counts qwen3-1.7b and llama3.1-8b at full width and depth on ``meta``,
    on the host, in each of their cells and at the engine's decode shape;
    (b) llama3.1-8b is served on the card, its decode replay profiled; (c)
    each engine-shape record, as a profile, predicts its decode step's
    time on the ``H100`` model beside the measured replay; (d)
    ``launch/profile`` prices every record on the torch solver and on
    NumPy."""
    recs = count_cells()
    measured = {"qwen3-1.7b": qwen3_profiles["decode"],
                "llama3.1-8b": serve_at_full_size(get_config("llama3.1-8b"), "llama31_8b",
                                                  "llama", records, "numpy")["decode"]}
    emit(phase="dryrun_prediction", device_model=H100.name, **predictions(recs, measured))
    priced = price_records()
    records["cache_share"]["launches_dryrun_profile"] = priced["main"]["cache_share_launches"]
    emit(phase="dryrun_profile", **priced)
    return recs


# ----------------------------- pod counts ----------------------------- #
POD_DIR = Path(__file__).resolve().parent / "results" / "dryrun_torch_pods"
POD_LOG = POD_DIR.parent / "dryrun_torch_pods.log"
POD_WAIT_S = 900
# a chip's products lie between the whole step's over the chips (a perfect
# split) and the whole step's (nothing split); float sums, so this much slack
SPLIT_SLACK = 1e-9


def pod_counts() -> int:
    """The child process's work (``--pod-counts``): every cell of
    ``DRYRUN_SHAPES`` of both models on one chip of the reference's 16x16
    mesh and of its 2x16x16 mesh, each counted by ``launch/dryrun.run_cell``
    in a ``fake`` world of 256 or 512 ranks of its own, into ``POD_DIR``,
    with a JSON line a cell. Its process has no card (``CUDA_VISIBLE_DEVICES``
    empty) and its own default process group, apart from the NCCL world of
    one card that ``phase_sharded_forward`` makes in the parent."""
    torch.set_num_threads(1)         # shapes on meta: nothing to compute
    shutil.rmtree(POD_DIR, ignore_errors=True)
    POD_DIR.mkdir(parents=True)
    for arch in DRYRUN_MODELS:
        for shape in DRYRUN_SHAPES:
            for multi_pod in (False, True):
                t0 = time.perf_counter()
                rec = dryrun_mod.run_cell(arch, shape, multi_pod=multi_pod, results=POD_DIR)
                emit(phase="pod_count", arch=arch, shape=rec["shape"],
                     mesh=dryrun_mod.mesh_tag(multi_pod), host_s=time.perf_counter() - t0,
                     count_s=rec["compile_s"])
    return 0


def start_pod_counts() -> subprocess.Popen:
    """``pod_counts`` in a child process, started just before the train
    phase: its host work runs beside a phase whose host waits on the card,
    and no phase that times the host runs beside it. ``phase_dryrun_mesh``,
    after the train phase, waits for it."""
    POD_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(POD_LOG, "w") as log:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--pod-counts"],
                                stdout=log, stderr=subprocess.STDOUT,
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def phase_dryrun_mesh(records: dict, dev1: dict, proc: subprocess.Popen) -> None:
    """One chip of the production meshes. The child's counts of qwen3-1.7b
    and llama3.1-8b in ``count_cells``' cells under ``pod1`` and ``pod2``:
    each chip's products, bytes and collective bytes by kind, the host
    seconds of its count, and its products over the ``dev1`` record's
    split over the chips (1 for a perfect split; more where ``sanitize``
    left an axis whole: the replication it leaves). Gates: every count
    finished, its products between the perfect split and the whole step,
    a collective in every cell. Then ``launch/profile`` prices the records
    of each mesh as ``price_records`` prices the one-device ones: on the
    torch solver on the card, one ``cache_share`` launch a solve, and with
    one explicit search on NumPy and on the card, the same plan."""
    t0 = time.perf_counter()
    code = proc.wait(timeout=POD_WAIT_S)
    waited = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in POD_LOG.read_text().splitlines() if ln.startswith("{")]
    if code != 0:
        raise AssertionError(f"pod counts exited {code}: {POD_LOG.read_text()[-3000:]}")
    host = {(ln["arch"], ln["shape"], ln["mesh"]): ln for ln in lines
            if ln.get("phase") == "pod_count"}
    for arch in DRYRUN_MODELS:
        for shape in DRYRUN_SHAPES:
            name = shape if isinstance(shape, str) else shape.name
            one = dev1[(arch, name)]["hlo_exec"]["mxu_flops"]
            for multi_pod in (False, True):
                tag = dryrun_mod.mesh_tag(multi_pod)
                rec = json.loads((POD_DIR / dryrun_mod.cell_file(
                    arch, name, multi_pod=multi_pod)).read_text())
                got = rec["hlo_exec"]["mxu_flops"]
                replication = got / (one / rec["n_chips"])
                coll = rec["collectives"]
                if not (1 - SPLIT_SLACK <= replication
                        and got <= one * (1 + SPLIT_SLACK) and coll["total_bytes"] > 0):
                    raise AssertionError(f"dryrun {arch} {name} {tag}: a chip's products {got:.6g} "
                                         f"against dev1's {one:.6g} over {rec['n_chips']}, "
                                         f"collectives {coll}")
                emit(phase="dryrun_mesh_cell", arch=arch, shape=name, mesh=tag,
                     mesh_shape=rec["mesh"], n_chips=rec["n_chips"], recipe=rec["recipe"],
                     mxu_flops=got, hbm_bytes=rec["hlo_exec"]["hbm_bytes"],
                     collective_bytes_by_kind=coll["bytes_by_kind"],
                     collective_count_by_kind=coll["count_by_kind"],
                     collective_bytes=coll["total_bytes"],
                     host_s=host[(arch, name, tag)]["host_s"],
                     count_s=host[(arch, name, tag)]["count_s"],
                     dev1_mxu_flops=one, mxu_over_dev1_per_chip=replication)
    launches = 0
    for tag in ("pod1", "pod2"):
        priced = price_records(POD_DIR, tag)
        launches += priced["main"]["cache_share_launches"]
        emit(phase="dryrun_mesh_profile", mesh=tag, **priced)
    records["cache_share"]["launches_dryrun_mesh_profile"] = launches
    emit(phase="dryrun_mesh", waited_for_counts_s=waited,
         counts_host_s=sum(ln["host_s"] for ln in host.values()), cells=len(host))


# ---------------------------- sharded forward ---------------------------- #
SHARDED_RECIPE = "tp_serve"


def _whole(t):
    return t.full_tensor() if type(t).__name__ == "DTensor" else t


def facade_steps(m, params, prompt, n_dec: int, feed=None, ctx=None, place=None) -> dict:
    """A prefill of ``prompt`` and ``n_dec`` decode steps through the facade,
    under ``ctx`` (its tensors placed by ``place``) or on one device: the
    prefill's and each step's logits (f32, on the host), the ids each step
    was fed (``feed``: those ids; else its own greedy ones), the launches
    of the run (after one short unmeasured run) and each step's host
    seconds until its ids are on the host."""
    kw = {} if ctx is None else {"ctx": ctx}
    place = place or (lambda x, what: x)
    B, S = prompt.shape
    with torch.no_grad():
        lg, cache = m.prefill(params, {"tokens": place(prompt[:, :64], "tokens")}, S, **kw)
        m.decode_step(params, place(_whole(lg).argmax(-1), "tokens"), place(cache, "cache"), 64,
                      **kw)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        lg, cache = m.prefill(params, {"tokens": place(prompt, "tokens")}, S + n_dec, **kw)
        cache = place(cache, "cache")
        logits = [_whole(lg).float().cpu()]
        ids = [feed[:, :1] if feed is not None else logits[0].argmax(-1)]
        prefill_s = time.perf_counter() - t0
        steps = []
        for i in range(n_dec):
            t1 = time.perf_counter()
            lg, cache = m.decode_step(params, place(ids[-1].to(DEV), "tokens"), cache, S + i, **kw)
            logits.append(_whole(lg).float().cpu())
            ids.append(feed[:, i + 1:i + 2] if feed is not None else logits[-1].argmax(-1))
            steps.append(time.perf_counter() - t1)
        used = counts(("rmsnorm", "flash_attention", "flash_decode"))
    return {"logits": torch.cat(logits, 1), "ids": torch.cat(ids, 1), "launches": used,
            "prefill_ms": prefill_s * 1e3, "step_ms": [t * 1e3 for t in steps],
            "cache": cache}


def facade_steps_plain(m, params, prompt, run: dict) -> dict:
    """The kernels of a ``facade_steps`` run held against their plain
    versions at its shapes, at the reference's bf16 tolerance: its prefill
    of the whole prompt (``flash_attention`` over every row, ``rmsnorm``
    over B * S rows), its first decode step (``flash_decode`` over S + 1
    valid rows of the cache) fed its ids over the plain prefill's cache,
    and its last step (every row valid) over the run's own cache."""
    B, S = prompt.shape
    n_dec = run["logits"].shape[1] - 1
    got, ids, name = run["logits"], run["ids"].to(DEV), m.cfg.name
    with torch.no_grad(), plain_versions():
        lg, cache = m.prefill(params, {"tokens": prompt}, S + n_dec)
        err = {"prefill": logits_close(f"{name} prefill", got[:, :1], lg.float().cpu())}
        lg, _ = m.decode_step(params, ids[:, :1], cache, S)
        err["first_step"] = logits_close(f"{name} first step", got[:, 1:2], lg.float().cpu())
        lg, _ = m.decode_step(params, ids[:, -2:-1], run["cache"], S + n_dec - 1)
        err["last_step"] = logits_close(f"{name} last step", got[:, -1:], lg.float().cpu())
    return err


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def merge_ranks(parts) -> tuple:
    """The sequence-parallel decode's merge of each rank's (m, l, acc),
    as ``kernels/decode_attention.py`` makes it across ranks: the max, then
    the rescaled sums."""
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - top) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - top)[..., None] for m, _, a in parts)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def check_sequence_parallel_decode(rng) -> dict:
    """The card's half of a decode over a cache whose sequence two ranks
    split (the serving recipes' cache): ``flash_decode``'s kernels over each
    rank's block of rows, their per-split partials merged
    (``decode_attention.partials``, a row of length 0 included) against
    the plain partials, and the two ranks' merge against
    ``flash_decode_plain`` over the whole cache, at qwen3's decode shapes
    (16 / 8 heads of 128, 8 sequences, 1,056 rows)."""
    B, H, KVH, D, T = 8, 16, 8, 128, 1056
    q = randn(rng, (B, 1, H, D), BF)
    k, v = (randn(rng, (B, T, KVH, D), BF) for _ in "kv")
    lens = torch.tensor([1040, 300, 528, 529, 1, 1056, 700, 64], device=DEV)
    half = T // 2
    before = counts(("flash_decode",))["flash_decode"]
    parts, plain, err = [], [], {}
    for c in range(2):
        local = torch.clamp(lens - c * half, 0, half)
        ks, vs = k[:, c * half:(c + 1) * half], v[:, c * half:(c + 1) * half]
        parts.append(dec_mod.partials(q, ks, vs, local))
        plain.append(dec_mod.partials_plain(q, ks, vs, local))
        ok = local > 0
        (m, l, a), (m0, l0, a0) = parts[-1], plain[-1]
        err[f"rank{c}_m"] = check_close(f"partials m, rank {c}", m[ok], m0[ok], F32, tol=1e-3)
        err[f"rank{c}_o"] = check_attention(f"partials o, rank {c}", (a / l[..., None])[ok],
                                            (a0 / l0[..., None])[ok], BF)
        if (l[~ok] != 0).any() or (a[~ok] != 0).any():
            raise AssertionError("partials: a row of no key kept a weight")
    got = merge_ranks(parts).reshape(B, 1, H, D)
    want = dec_mod.flash_decode_plain(q, k, v, lens)
    err["merged"] = check_attention("sequence-parallel decode", got, want, BF)
    launches = counts(("flash_decode",))["flash_decode"] - before
    if launches != 2:
        raise AssertionError(f"partials: {launches} flash_decode launches for two ranks' blocks")
    return {"max_abs_err": err, "launches": launches, "shape": [B, H, KVH, D, T],
            "lengths": lens.tolist()}


def phase_sharded_forward(records: dict) -> None:
    """The sharded forward on the card: qwen3-1.7b at full width and depth
    (random bf16 weights from seed 0) over a (1, 1) ``("data", "model")``
    CUDA mesh of an NCCL world of one rank (``tcp://localhost``), its
    parameters placed by ``param_specs`` under ``tp_serve``, the prompt and
    the ids over the data axis, the cache by ``cache_specs``: a prefill of 4
    x 1,024 tokens and 32 decode steps through the facade's ``ctx``, fed the
    ids the unsharded facade chose. Gates: the unsharded run's kernels
    against their plain versions at these shapes (``facade_steps_plain``),
    the launches of ``rmsnorm``, ``flash_attention`` and ``flash_decode``
    equal the unsharded run's, and the logits equal its logits within the
    reference's bf16 tolerance (bit for bit is reported). Beside them each
    decode step's wall time and device-idle share, sharded and not
    (``profile_step``)."""
    cfg = get_config("qwen3-1.7b")
    B, S, n_dec = 4, 1024, 32
    m, params, weights = facade_weights(cfg)
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S))).to(DEV)
    plain = facade_steps(m, params, prompt, n_dec)
    err_plain = facade_steps_plain(m, params, prompt, plain)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        da = shd.data_axes_of(mesh)
        ctx = ParallelContext(mesh, da, "model")
        placed = shd.distribute(params, mesh, shd.param_specs(cfg, SHARDED_RECIPE, mesh, params))

        def place(x, what):
            if what == "cache":
                return shd.distribute(x, mesh, shd.cache_specs(cfg, SHARDED_RECIPE, mesh, x))
            return shd.distribute(x, mesh, shd.sanitize((da, None), x.shape, mesh))
        sharded = facade_steps(m, placed, prompt, n_dec, feed=plain["ids"], ctx=ctx, place=place)
        if sharded["launches"] != plain["launches"]:
            raise AssertionError(f"sharded forward: launches {sharded['launches']}, the "
                                 f"unsharded run's {plain['launches']}")
        bit = bool(torch.equal(sharded["logits"], plain["logits"]))
        err = logits_close("qwen3 sharded forward", sharded["logits"], plain["logits"])
        # the last step again, over the cache's last row
        tok = place(plain["ids"][:, -2:-1].to(DEV), "tokens")
        prof_s = profile_step(lambda: _whole(m.decode_step(
            placed, tok, sharded["cache"], S + n_dec - 1, ctx=ctx)[0]).argmax(-1).tolist())
    finally:
        dist.destroy_process_group()
    tok = plain["ids"][:, -2:-1].to(DEV)
    prof_p = profile_step(lambda: m.decode_step(params, tok, plain["cache"], S + n_dec - 1)[0]
                          .argmax(-1).tolist())
    for name in ("rmsnorm", "flash_attention", "flash_decode"):
        records[name]["launches_sharded_forward"] = sharded["launches"][name]
    emit(phase="sequence_parallel_decode",
         **check_sequence_parallel_decode(np.random.default_rng(12)))
    emit(phase="sharded_forward", config=cfg.name, mesh={"data": 1, "model": 1},
         recipe=SHARDED_RECIPE, batch=B, prompt_tokens=S, decode_steps=n_dec,
         n_params=weights["n_params"], launches=sharded["launches"],
         launches_unsharded=plain["launches"], logits_bit_equal=bit, max_abs_err=err,
         max_abs_err_against_plain=err_plain,
         tolerance={"rtol": 0.15, "atol": 0.3},
         prefill_ms={"sharded": sharded["prefill_ms"], "unsharded": plain["prefill_ms"]},
         decode_step_ms_median={"sharded": statistics.median(sharded["step_ms"]),
                                "unsharded": statistics.median(plain["step_ms"])},
         decode_step_profile={"sharded": prof_s, "unsharded": prof_p})



# what the resident blocks of one H100 SM share (CUDA C programming guide,
# compute capability 9.0); each block also reserves 1 KB of shared memory
SM_LIMITS = {"registers": 65536, "threads": 2048, "blocks": 32, "smem_bytes": 233472}


def block_use(k: dict) -> dict:
    """What one block of a kernel holds on its SM: registers in units of
    256 a warp, threads in whole warps, shared memory in 128-byte units
    with the block's reserved 1 KB."""
    warps = -(-k["threads"] // 32)
    return {"registers": warps * -(-k["registers"] * 32 // 256) * 256,
            "threads": 32 * warps, "blocks": 1,
            "smem_bytes": -(-(k["smem_bytes"] + 1024) // 128) * 128}


def phase_residency() -> None:
    """Registers a thread, shared memory a block and threads a block of the
    stressor and victim kernels of the interference phase, as the CUDA
    profiler (CUPTI) recorded their launches, and how many blocks of each
    victim kernel fit on an SM that holds one stressor block: 0 means the
    stressor withholds its SMs from that kernel. Fails if a ``stress_mxu``
    block leaves a victim kernel no room, so that the mxu axis measures
    tensor cores shared, not SMs withheld."""
    from torch.profiler import ProfilerActivity, profile
    victims = gpu_native.attention_victims(DEV, n_layers=1)
    calls = [v.fn for v in victims.values()]
    calls += [_stressor_call(StressorSpec(axis, 0.1), DEV) for axis in gpu_native.AXES]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    trace = _build.library_path().parent / "residency_trace.json"
    prof.export_chrome_trace(str(trace))
    seen = {}
    for ev in json.loads(trace.read_text()).get("traceEvents", []):
        a = ev.get("args", {})
        if ev.get("cat") == "kernel" and "registers per thread" in a:
            seen[ev["name"].replace("void ", "").split("(")[0]] = {
                "registers": a["registers per thread"], "smem_bytes": a["shared memory"],
                "threads": int(np.prod(a["block"]))}
    held = {n: k for n, k in seen.items() if n.startswith("stress_")}
    victim = {n: k for n, k in seen.items() if not n.startswith("stress_")}
    if not held or not victim:
        emit(phase="residency", kernels="not measured: the trace holds no kernel resources")
        return
    use = {n: block_use(k) for n, k in seen.items()}
    beside = {s: {v: min((SM_LIMITS[r] - use[s][r]) // use[v][r] for r in SM_LIMITS)
                  for v in victim} for s in held}
    emit(phase="residency", kernels=seen, victim_blocks_alone={
        v: min(SM_LIMITS[r] // use[v][r] for r in SM_LIMITS) for v in victim},
        victim_blocks_beside=beside)
    shut = [(s, v) for s, row in beside.items() if "stress_mxu" in s
            for v, n in row.items() if n < 1]
    if shut:
        raise AssertionError(f"a stress_mxu block leaves no room for a victim block: {shut}")


# --------------------------------------------------------------------- #
#  phase 6: interference, the §4 loop on CUDA streams                    #
# --------------------------------------------------------------------- #
def phase_interference(records: dict) -> list:
    """``gpu_native.interference_sweep``: the sweep, the fit and the
    validation for both full-width victims. Fails unless every colocated
    run was bracketed by its background, every planned run is there with
    a finite slowdown, and each stressor was launched on this path.
    Returns the largest batch of scenarios the fit priced, for the solver
    phase."""
    largest = []

    def recording(scenarios, dev=None):
        scenarios = list(scenarios)
        if len(scenarios) > len(largest):
            largest[:] = scenarios
        return solve_scenarios(scenarios, dev)

    reset_counts()                          # counts of this path only
    fit_mod.solve_scenarios = recording
    try:
        out = gpu_native.interference_sweep(DEV)
    finally:
        fit_mod.solve_scenarios = solve_scenarios
    used = counts(STRESSORS)
    cols = out["colocations"]
    n_axes = len(gpu_native.AXES)
    per_victim = n_axes * (len(FIT_LAMBDAS) + 2 + 4) + 4 + n_axes * 3
    want = 2 * per_victim
    for rec in cols:
        emit(phase="interference", **rec)
    for name, prof in out["profiles"].items():
        emit(phase="interference_profile", victim=name, **prof)
        emit(phase="interference_validation", victim=name, **out["validation"][name])
    emit(phase="interference_brackets", **out["brackets"], launches=used)
    if len(cols) != want:
        raise AssertionError(f"interference: {len(cols)} colocated runs, planned {want}")
    if not out["brackets"]["all_bracketed"]:
        raise AssertionError("interference: a colocated run was not bracketed")
    vals = [r[k] for r in cols for k in ("measured", "predicted_analytic", "predicted_fitted")]
    if not all(np.isfinite(vals)) or min(r["measured"] for r in cols) < 1.0:
        raise AssertionError("interference: a slowdown is not finite or below 1")
    if not all(used.values()):
        raise AssertionError(f"interference: a stressor was never launched: {used}")
    for name, n in used.items():
        records[name]["launches"] = n
    return largest


# --------------------------------------------------------------------- #
#  phase 7: the torch solver backend on the card                         #
# --------------------------------------------------------------------- #
def results_equal(name, want, got, tol=1e-9) -> float:
    """Two BatchResults agree at rtol = atol = ``tol``, the discrete
    ``bottleneck`` and ``feasible_slots`` exactly; returns the largest
    relative difference of the nonzero finite slowdowns."""
    if not (np.array_equal(got.bottleneck, want.bottleneck)
            and np.array_equal(got.feasible_slots, want.feasible_slots)):
        raise AssertionError(f"{name}: bottleneck or feasible_slots differ")
    worst = 0.0
    for field in ("speeds", "slowdowns", "axis_load"):
        a, b = getattr(want, field), getattr(got, field)
        fin = np.isfinite(a)
        if not np.array_equal(fin, np.isfinite(b)):
            raise AssertionError(f"{name}: {field} finite in other places")
        if not np.allclose(b[fin], a[fin], rtol=tol, atol=tol):
            raise AssertionError(f"{name}: {field} differ beyond {tol}")
        nz = fin & (a != 0)
        if field == "slowdowns" and nz.any():
            worst = float(np.max(np.abs(b[nz] - a[nz]) / np.abs(a[nz])))
    return worst


def solve_ms(scenarios, n: int = 20) -> float:
    """Median host time of one solve (it returns NumPy: the device is done)."""
    solve_scenarios(scenarios, H100)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        solve_scenarios(scenarios, H100)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_solver(params, scenarios, records: dict) -> None:
    """The full-width qwen3-1.7b interference-aware serve on the NumPy
    backend, then on the torch backend on the card: the same prefill chunks
    and tokens, every solve a replay of a captured step with one
    ``cache_share`` launch, and no launch outside the captures. Then one
    batch of the interference phase's scenarios through both backends, at
    rtol = atol = 1e-9 with the same bottlenecks, and the time of a solve
    on each, the torch one replayed and with its body run uncaptured."""
    cfg = get_config("qwen3-1.7b")
    prompts = serve_prompts(cfg, np.random.default_rng(0))
    ecfg = EngineConfig(max_slots=8, max_len=1024, prefill_chunk=128)
    runs = {}
    solves = [0]

    def counting(*args):
        solves[0] += 1
        return solve_gathered(*args)

    solve_gathered = estimator_torch.solve_gathered
    for backend in ("numpy", "torch"):
        with solver_backend(backend, device=DEV):
            before = {id(step): step.calls for step in estimator_torch.captured_steps()}
            reset_counts()                 # counts of this path only
            estimator_torch.solve_gathered = counting
            try:
                eng, metrics, seconds = serve(cfg, ecfg, prompts, 32, device=DEV,
                                              params=params)
            finally:
                estimator_torch.solve_gathered = solve_gathered
            used = counts()
            steps = estimator_torch.captured_steps()
        stats = serve_stats(eng, metrics, seconds, 32)
        new = [step for step in steps if id(step) not in before]
        ran = [step for step in steps if step.calls > before.get(id(step), 0)]
        solver = {"replayed_cache_share": replayed(steps, before).get("cache_share", 0),
                  "cache_share_at_capture": at_capture(new).get("cache_share", 0),
                  "graphs_replayed": sorted(step.name for step in ran),
                  "all_replayed_from_graphs": all(step.graph is not None for step in ran),
                  "replays": sum(step.calls - before.get(id(step), 0) for step in ran)}
        runs[backend] = {**stats, "outputs": [m["output"] for m in metrics.values()],
                         "launches": used, **solver}
        emit(phase="solver_serve", backend=backend, solves=solves[0] if backend == "torch" else 0,
             **{k: v for k, v in stats.items() if k != "chunk_sizes"},
             chunk_sizes=stats["chunk_sizes"], launches=used, **solver)
    np_run, t_run = runs["numpy"], runs["torch"]
    if t_run["chunk_sizes"] != np_run["chunk_sizes"] or t_run["outputs"] != np_run["outputs"]:
        raise AssertionError("solver: the torch backend picked other chunks or tokens")
    n_cs = t_run["replayed_cache_share"]
    if (np_run["launches"]["cache_share"] or np_run["replays"] or not solves[0]
            or n_cs != solves[0] or t_run["replays"] != solves[0]
            or not t_run["all_replayed_from_graphs"]):
        raise AssertionError(f"solver: {n_cs} cache_share launches in {t_run['replays']} "
                             f"replays for {solves[0]} solves")
    if t_run["launches"]["cache_share"] != t_run["cache_share_at_capture"]:
        raise AssertionError(f"solver: {t_run['launches']['cache_share']} cache_share launches "
                             f"besides the captures' {t_run['cache_share_at_capture']}")
    records["cache_share"]["launches"] = n_cs
    records["cache_share"]["launches_per_solve"] = 1

    eng = Engine(cfg, params=params, ecfg=ecfg, device=DEV)
    decode = eng._phase_profile("decode", 8)
    engine_batch = [Scenario((decode,), (eng._phase_profile(f"prefill{c}", c),))
                    for c in (128, 64, 32, 16)]
    batches = {"interference_fit": scenarios, "engine_chunk": engine_batch}
    out = {}
    for name, batch in batches.items():
        with solver_backend("numpy"):
            want, np_ms = solve_scenarios(batch, H100), solve_ms(batch)
        with solver_backend("torch", device=DEV):
            got, t_ms = solve_scenarios(batch, H100), solve_ms(batch)
            # the same solves with the step's body run uncaptured
            K = int(want.mask.shape[1])
            _, step = estimator_torch._step(estimator_torch._bucket(len(batch)), K, H100,
                                            get_solver_device())
            graph, step.graph = step.graph, None
            try:
                body_ms = solve_ms(batch, n=5)
            finally:
                step.graph = graph
        out[name] = {"scenarios": len(batch), "width": K,
                     "max_rel_err_slowdowns": results_equal(name, want, got),
                     "numpy_ms": np_ms, "torch_ms": t_ms, "graph": step.name,
                     "captured": step.graph is not None, "torch_uncaptured_ms": body_ms}
    emit(phase="solver_parity", tolerance={"rtol": 1e-9, "atol": 1e-9}, **out)


# --------------------------------------------------------------------- #
#  phase 7b: the fleet, every price on the torch solver                  #
# --------------------------------------------------------------------- #
# The reference's trace gate (benchmarks/bench_trace.py:45-48): 36 tenants,
# 240 virtual seconds, dev3 killed at t = 120, on 12 devices alternating
# v5e and v5p; SLO-class attainment at least 0.95.
GATE_TRACE = dict(seed=2026, duration=240.0, n_tenants=36, kills=((120.0, "dev3"),))
GATE_DEVICES = 12
ATTAINMENT_TARGET = 0.95
# The reference's scale gate (benchmarks/bench_fleet.py:221-227): 256
# devices alternating v5e and v5p, 192 tenants in waves of 16, 64 churn
# mutations; p95 devices touched a scoped repair at most 16. Its 10x replan
# speed-up over a forced full replay is a wall-clock ratio: printed beside
# the ratio measured here, not held.
SCALE_DEVICES, SCALE_INIT, SCALE_WAVE, SCALE_CHURN = 256, 192, 16, 64
SCALE_TOUCHED_P95 = 16.0
SCALE_SPEEDUP = 10.0
SCALE_FULL_MUTATIONS = 3
FLEET_TOL = 1e-9


@contextlib.contextmanager
def counted_solves(log: dict):
    """Count and time every solve of a run: each ``solve_batch`` with
    members (the scheduler's pair pricing calls it directly, everything else
    through ``solve_scenarios``), by padded bucket, width and device model,
    and the torch solves among them (``estimator_torch.solve_gathered``).
    Only this script patches them."""
    solve_batch, gathered = estimator_mod.solve_batch, estimator_torch.solve_gathered

    def timed(pm, members, dev, *args, **kw):
        t0 = time.perf_counter()
        br = solve_batch(pm, members, dev, *args, **kw)
        S, K = br.mask.shape
        if K:
            log["solves"] += 1
            log["scenarios"] += S
            log["solve_s"] += time.perf_counter() - t0
            key = (estimator_torch._bucket(S), K, dev.name)
            log["shapes"][key] = log["shapes"].get(key, 0) + 1
        return br

    def counting(*args):
        log["torch_solves"] += 1
        return gathered(*args)

    estimator_mod.solve_batch = scheduler_mod.solve_batch = timed
    estimator_torch.solve_gathered = counting
    try:
        yield log
    finally:
        estimator_mod.solve_batch = scheduler_mod.solve_batch = solve_batch
        estimator_torch.solve_gathered = gathered


def fleet_run(name: str, backend: str, fn):
    """Run ``fn()`` on ``backend`` (torch on the card) with the counts at 0
    just before and read just after; returns (fn's result, the run's solver
    record). On the torch backend every solve must be a replay of a
    captured step with one ``cache_share`` launch, and no launch may come
    from outside the captures."""
    log = {"solves": 0, "torch_solves": 0, "scenarios": 0, "solve_s": 0.0, "shapes": {}}
    with solver_backend(backend, device=DEV):
        before = {id(step): step.calls for step in estimator_torch.captured_steps()}
        reset_counts()
        t0 = time.perf_counter()
        with counted_solves(log):
            out = fn()
        wall = time.perf_counter() - t0
        used = counts(("cache_share",))["cache_share"]
        steps = estimator_torch.captured_steps()
    new = [step for step in steps if id(step) not in before]
    ran = [step for step in steps if step.calls > before.get(id(step), 0)]
    rec = {"run": name, "backend": backend, "solves": log["solves"],
           "torch_solves": log["torch_solves"], "scenarios": log["scenarios"],
           "shapes": [{"bucket": b, "K": k, "model": m, "solves": n}
                      for (b, k, m), n in sorted(log["shapes"].items())],
           "graphs_captured": sum(step.graph is not None for step in new),
           "capture_s": sum(step.capture_s for step in new),
           "graphs_replayed": len(ran),
           "replays": sum(step.calls - before.get(id(step), 0) for step in ran),
           "cache_share_launches": replayed(steps, before).get("cache_share", 0),
           "cache_share_at_capture": at_capture(new).get("cache_share", 0),
           "cache_share_outside_replays": used,
           "solve_s": log["solve_s"], "ms_per_solve": log["solve_s"] / max(log["solves"], 1) * 1e3,
           "wall_s": wall}
    if backend == "numpy":
        if log["torch_solves"] or rec["replays"] or used:
            raise AssertionError(f"fleet {name}: the NumPy run reached the torch solver: {rec}")
    elif not (log["solves"] and log["torch_solves"] == log["solves"] == rec["replays"]
              == rec["cache_share_launches"]
              and all(step.graph is not None for step in ran)
              and used == rec["cache_share_at_capture"]):
        raise AssertionError(f"fleet {name}: {rec['cache_share_launches']} cache_share launches "
                             f"in {rec['replays']} replays for {log['solves']} solves "
                             f"({log['torch_solves']} on the torch solver)")
    return out, rec


def values_close(a, b, tol, path="") -> None:
    """``a`` equals ``b`` in structure, every float at rtol = atol = ``tol``
    (0: exactly; NaN equals NaN), everything else exactly."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            values_close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            values_close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if not (a == b or (a != a and b != b)
                or abs(a - b) <= max(tol * max(abs(a), abs(b)), tol)):
            raise AssertionError(f"{path}: {a!r} against {b!r}")
    elif type(a) is not type(b) or a != b:
        raise AssertionError(f"{path}: {a!r} against {b!r}")


def fleet_state(fleet) -> dict:
    """What a fleet decided and where everything is: the decision log, the
    placements with their fractions, slowdowns and gains, the unplaced
    sets and the device states (``RepairRecord.latency_s``, a wall-clock
    reading, stays out)."""
    plan = fleet.plan()
    return {"decisions": [dataclasses.astuple(d) for d in fleet.decisions],
            "placements": {did: [list(p.workloads), p.slot_fraction, p.predicted_slowdown,
                                 p.meets_slo, p.throughput_gain]
                           for did, p in sorted(plan.placements.items())},
            "queued": sorted(plan.queued), "degraded": sorted(plan.degraded),
            "device_states": plan.device_states,
            "repairs": [(r.kind, r.reason, r.full, r.targets, r.devices_touched)
                        for r in fleet.repairs]}


def simulate_trace(dev_model, models: dict, search):
    """One generate -> simulate -> report pass of the gate trace, its tenants
    drawn for ``dev_model``, on a fleet of ``models``; ``search`` None takes
    the backend's default fraction search."""
    cfg = dataclasses.replace(default_fleet_config(), fraction_search=search)
    sim = Simulator(generate_trace(TraceConfig(**GATE_TRACE), dev=dev_model), models, cfg)
    return sim.run(), fleet_state(sim.fleet)


def trace_gates(label: str, dev_model, models: dict, runs: list, gate_attainment: bool) -> dict:
    """The gate trace four times: on NumPy and on torch with one explicit
    search (the NumPy backend's default), equal at 1e-9 with the same
    decisions and placements; then twice on torch with its own default
    search, bit for bit the same. Returns the summary of the last run."""
    explicit = FractionSearchConfig()
    (want, want_state), rec = fleet_run(f"{label}_numpy", "numpy",
                                        lambda: simulate_trace(dev_model, models, explicit))
    runs.append(rec)
    (got, got_state), rec = fleet_run(f"{label}_torch", "torch",
                                      lambda: simulate_trace(dev_model, models, explicit))
    runs.append(rec)
    values_close(got, want, FLEET_TOL, f"{label} report")
    values_close(got_state, want_state, FLEET_TOL, f"{label} fleet")
    twins = []
    for i in range(2):
        out, rec = fleet_run(f"{label}_torch_default_{i}", "torch",
                             lambda: simulate_trace(dev_model, models, None))
        runs.append(rec)
        twins.append(out)
    (a, a_state), (b, b_state) = twins
    values_close(a, b, 0.0, f"{label} twin report")
    values_close(a_state, b_state, 0.0, f"{label} twin fleet")
    slo = a["slo"]["per_class"].get("slo", {"attainment": 0.0})
    summary = {"trace": label, "requests": a["requests"]["total"],
               "tenants": a["trace"]["tenants"], "device_deaths": a["fleet"]["device_deaths"],
               "event_loop_errors": a["fleet"]["event_loop_errors"],
               "slo_attainment": slo["attainment"], "slo_missed": slo.get("missed"),
               "best_effort_attainment": a["slo"]["per_class"].get(
                   "best_effort", {}).get("attainment"),
               "attainment_explicit_search": got["slo"]["per_class"]["slo"]["attainment"],
               "replans": a["fleet"]["replans"], "migrations": a["fleet"]["migrations"],
               "evictions": a["fleet"]["evictions"],
               "scenarios_solved": a["fleet"]["scenarios_solved"],
               "equal_to_numpy_at": FLEET_TOL, "twins_bit_identical": True}
    if a["fleet"]["event_loop_errors"] or got["fleet"]["event_loop_errors"]:
        raise AssertionError(f"{label}: event-loop errors {summary}")
    if gate_attainment:
        floor = (a["requests"]["total"] >= 1000 and a["trace"]["tenants"] >= 32
                 and a["fleet"]["device_deaths"] >= 1)
        if not floor or slo["attainment"] < ATTAINMENT_TARGET:
            raise AssertionError(f"{label}: bench_trace's gates fail: {summary}")
    return summary


def fleet_plans_equal(got, want, tol=FLEET_TOL) -> bool:
    """bench_fleet.fleet_plans_equal: the same placements, fractions,
    slowdowns and gains at ``tol``, the same unplaced set."""
    if set(got.placements) != set(want.placements):
        return False
    for did, a in got.placements.items():
        b = want.placements[did]
        if a.workloads != b.workloads or set(a.slot_fraction) != set(b.slot_fraction):
            return False
        if (any(abs(a.slot_fraction[n] - b.slot_fraction[n]) > tol for n in a.slot_fraction)
                or any(abs(a.predicted_slowdown[n] - b.predicted_slowdown[n]) > tol
                       for n in a.workloads)
                or abs(a.throughput_gain - b.throughput_gain) > tol):
            return False
    return sorted(got.queued + got.degraded) == sorted(want.queued + want.degraded)


def fleet_recovery() -> dict:
    """bench_fleet.bench_recovery (gate 1): 4 v5e devices, 4 SLO decodes and
    6 best-effort bursts, dev1 killed at t = 8; every SLO workload re-placed,
    the evictions recorded, and the online plan equal to a cold fleet's over
    the survivors at 1e-9."""
    cfg = FleetConfig(max_group_size=3, heartbeat_timeout=3.0, backoff_base=1.0,
                      max_retries=3)
    works = decode_heavy_mix(TPU_V5E, 4, 6)
    decodes, auxes = works[:4], works[4:]
    clock = FakeClock()
    models = {f"dev{i}": TPU_V5E for i in range(4)}
    fleet = FleetScheduler(models, cfg, clock=clock)
    kill_t = 8.0
    FaultInjector(fleet, clock).run(
        [arrive(float(i), d, priority=SLO) for i, d in enumerate(decodes)]
        + storm(4.0, auxes, priority=BEST_EFFORT) + [kill(kill_t, "dev1")],
        until=30.0)
    plan = fleet.plan()
    slo_rate = plan.placement_rate([w.name for w in decodes])
    pre_kill = {d.workload for d in fleet.decisions
                if d.time <= kill_t and d.action == "placed"}
    evicted = {d.workload for d in fleet.decisions if d.action == "evicted"}
    recorded = all(w.name in evicted for w in auxes
                   if w.name in pre_kill and w.name not in plan.placed)
    cold = FleetScheduler({did: m for did, m in models.items() if did != "dev1"}, cfg)
    for prof, prio in fleet.workloads:
        cold.submit(prof, priority=prio)
    res = {"slo_replacement_rate": slo_rate, "evictions": len(evicted),
           "evictions_recorded": recorded, "event_loop_errors": fleet.stats["errors"],
           "online_equals_cold": fleet_plans_equal(plan, cold.plan()),
           "replans": fleet.stats["replans"], "scenarios_solved": fleet.stats["scenarios_solved"]}
    if not (slo_rate == 1.0 and recorded and evicted and not fleet.stats["errors"]
            and res["online_equals_cold"]):
        raise AssertionError(f"fleet recovery: bench_fleet's gate 1 fails: {res}")
    return res


def loose_mix(n: int, prefix: str) -> list:
    """bench_fleet.loose_mix: loose-SLO (1.5x) workloads, alternating compute-
    and bandwidth-leaning, demands sized off v5e capacities."""
    out = []
    for i in range(n):
        u = ({"mxu": 0.40, "vpu": 0.05, "issue": 0.06, "hbm": 0.18, "l2": 0.18} if i % 2 == 0
             else {"mxu": 0.12, "vpu": 0.04, "issue": 0.05, "hbm": 0.38, "l2": 0.38})
        d = {r: u.get(r, 0.0) * TPU_V5E.capacity(r) for r in RESOURCE_AXES}
        out.append(WorkloadProfile(f"{prefix}{i}", (KernelProfile(
            f"{prefix}{i}#step", demand=d, duration=1.0),), slo_slowdown=1.5))
    return out


def scale_models() -> dict:
    return {f"dev{i:03d}": (TPU_V5E if i % 2 == 0 else TPU_V5P) for i in range(SCALE_DEVICES)}


def fleet_scale() -> dict:
    """bench_fleet.bench_scale (gate 4): the 256-device fleet under its fixed
    churn (per 8 mutations: 3 arrivals, 3 departures, a drain and a revive);
    p95 devices touched a scoped repair, the gain against a cold replay of
    the same pool, the same placed SLO set, no errors; and the replan
    latency against a forced-full twin's."""
    cfg = FleetConfig(max_group_size=3, queue_limit=64, heartbeat_timeout=1e9)
    clock = FakeClock()
    fleet = FleetScheduler(scale_models(), cfg, clock=clock)
    init = loose_mix(SCALE_INIT, "s")
    prios = [SLO if i % 2 == 0 else BEST_EFFORT for i in range(SCALE_INIT)]
    for w0 in range(0, SCALE_INIT, SCALE_WAVE):
        fleet.submit_many(list(zip(init[w0:w0 + SCALE_WAVE], prios[w0:w0 + SCALE_WAVE])))
        clock.advance(1.0)
    n_init = len(fleet.repairs)
    churn, drained, ci, si = loose_mix(SCALE_CHURN, "c"), [], 0, 0
    for m in range(SCALE_CHURN):
        step = m % 8
        if step in (0, 2, 4):
            fleet.submit(churn[ci], priority=(SLO, BEST_EFFORT)[ci % 2])
            ci += 1
        elif step in (1, 3, 5):
            name = init[si].name
            si += 1
            if name in fleet:
                fleet.remove(name)
        elif step == 6:
            drained.append(f"dev{(m * 5) % SCALE_DEVICES:03d}")
            fleet.decommission(drained[-1])
        else:
            fleet.heartbeat(drained.pop(0))
        clock.advance(1.0)
    recs = fleet.repairs[n_init:]
    scoped = [r for r in recs if not r.full]
    touched_p95 = float(np.percentile([r.devices_touched for r in scoped], 95)) if scoped \
        else float("inf")
    scoped_lat = float(np.mean([r.latency_s for r in recs]))
    plan = fleet.plan()
    slo_names = [p.name for p, prio in fleet.workloads if prio == SLO]
    full_cfg = dataclasses.replace(cfg, repair_mode="full")
    cold = FleetScheduler({did: d.model for did, d in fleet.devices.items()
                           if d.state != "dead"}, full_cfg)
    cold.submit_many([(p, prio) for p, prio in fleet.workloads])
    cold_plan = cold.plan()
    gain_ratio = plan.total_gain / cold_plan.total_gain if cold_plan.total_gain > 0 else 1.0
    twin = FleetScheduler(scale_models(), full_cfg, clock=FakeClock())
    twin.submit_many(list(zip(init, prios)))
    n_twin = len(twin.repairs)
    twin.submit(loose_mix(1, "t")[0], priority=BEST_EFFORT)
    twin.remove(init[0].name)
    twin.decommission("dev030")
    full_lat = float(np.mean([r.latency_s
                              for r in twin.repairs[n_twin:][:SCALE_FULL_MUTATIONS]]))
    speedup = full_lat / max(scoped_lat, 1e-12)
    res = {"devices": SCALE_DEVICES, "workloads_final": len(fleet),
           "scoped_repairs": fleet.stats["scoped_repairs"],
           "full_replays": fleet.stats["full_replays"],
           "repair_fallbacks": fleet.stats["repair_fallbacks"],
           "touched_p95": touched_p95, "touched_p95_gate": SCALE_TOUCHED_P95,
           "gain_ratio_vs_cold": gain_ratio, "divergence_epsilon": cfg.divergence_epsilon,
           "slo_replacement_rate": plan.placement_rate(slo_names),
           "slo_sets_match": ({n for n in slo_names if n in plan.placed}
                              == {n for n in slo_names if n in cold_plan.placed}),
           "event_loop_errors": fleet.stats["errors"],
           "scoped_mean_latency_ms": scoped_lat * 1e3, "full_mean_latency_ms": full_lat * 1e3,
           "replan_speedup": speedup, "reference_speedup_gate": SCALE_SPEEDUP,
           "speedup_gate_held": speedup >= SCALE_SPEEDUP}
    if not (touched_p95 <= SCALE_TOUCHED_P95 and gain_ratio >= 1.0 - cfg.divergence_epsilon
            and res["slo_replacement_rate"] == 1.0 and res["slo_sets_match"]
            and not fleet.stats["errors"]):
        raise AssertionError(f"fleet scale: bench_fleet's gate 4 fails: {res}")
    return res


def check_cache_share_at(shapes, rng) -> list:
    """``cache_share`` against its plain version, bit for bit, and timed at
    each (bucket, K) that the fleet's solves hit, with a row at the cliff."""
    out = []
    for S, K in shapes:
        ws = rng.random((S, K)) * rng.choice([0.3, 1.0, 2.0], size=(S, 1)) * H100.cache_capacity
        ws[0, :2] = H100.cache_capacity / 2
        present = rng.random((S, K)) < 0.85
        present[0] = True
        w, p = torch.from_numpy(np.where(present, ws, 0.0)).to(DEV), torch.from_numpy(present).to(DEV)
        check_exact(f"cache_share ({S}, {K}) fleet", cs_mod.cache_share(w, p, H100.cache_capacity),
                    cs_mod.cache_share_plain(w, p, H100.cache_capacity))
        out.append(time_cache_share(rng, S, K))
    return out


def phase_fleet(records: dict) -> None:
    """The colocation scheduler, the fleet, the trace simulator and the drift
    monitor with every price on the torch solver on the card: (a) the
    reference's gate trace on its v5e / v5p fleet, (b) the same trace with
    its tenants and its 12 devices on the H100 model, (c) bench_fleet's
    recovery and scale traces. Every torch solve is a replay of a captured
    step with one ``cache_share`` launch."""
    runs = []
    hetero = {f"dev{i}": (TPU_V5E if i % 2 == 0 else TPU_V5P) for i in range(GATE_DEVICES)}
    traces = [trace_gates("gate_trace", TPU_V5E, hetero, runs, gate_attainment=True),
              trace_gates("h100_trace", H100, {f"dev{i}": H100 for i in range(GATE_DEVICES)},
                          runs, gate_attainment=False)]
    recovery, rec = fleet_run("recovery", "torch", fleet_recovery)
    runs.append(rec)
    scale, rec = fleet_run("scale", "torch", fleet_scale)
    runs.append(rec)
    for r in runs:
        emit(phase="fleet_run", **r)
    # the solver's steps are keyed by (bucket, K, device model): bounded by
    # the models of the fleets times the buckets and widths they hit
    keys = {(b, k, m) for r in runs for b, k, m in
            ((s["bucket"], s["K"], s["model"]) for s in r["shapes"])}
    models = {m for _, _, m in keys}
    if not models <= {TPU_V5E.name, TPU_V5P.name, H100.name} or any(k > 3 for _, k, _ in keys):
        raise AssertionError(f"fleet: solves outside the fleets' models and widths: {keys}")
    torch_runs = [r for r in runs if r["backend"] == "torch"]
    launches = sum(r["cache_share_launches"] for r in torch_runs)
    by_shape = {}
    for r in torch_runs:
        for s in r["shapes"]:
            key = f"({s['bucket']}, {s['K']}) {s['model']}"
            by_shape[key] = by_shape.get(key, 0) + s["solves"]
    shapes = sorted({(b, k) for b, k, _ in keys})
    def totals(field):
        return {b: sum(r[field] for r in runs if r["backend"] == b) for b in ("numpy", "torch")}

    records["cache_share"]["launches_fleet"] = launches
    records["cache_share"]["launches_fleet_by_shape"] = by_shape
    records["cache_share"]["fleet"] = check_cache_share_at(shapes, np.random.default_rng(7))
    records["cache_share"]["max_abs_err_fleet"] = 0.0
    emit(phase="fleet", traces=traces, recovery=recovery, scale=scale,
         solves=totals("solves"), scenarios=totals("scenarios"),
         ms_per_solve={b: totals("solve_s")[b] / max(totals("solves")[b], 1) * 1e3
                       for b in ("numpy", "torch")},
         wall_s={r["run"]: r["wall_s"] for r in runs}, wall_s_total=totals("wall_s"),
         graph_keys=len(keys),
         solver_graphs=sum(s.graph is not None for s in estimator_torch.captured_steps()),
         cache_share_launches=launches, cache_share_launches_by_shape=by_shape)


# --------------------------------------------------------------------- #
#  phase 7c: the examples' twins on the card                             #
# --------------------------------------------------------------------- #
# each twin of the reference's examples and the kernels its run launches
EXAMPLES = {"quickstart": ("cache_share",), "fleet_failover": ("cache_share",),
            "trace_serving": ("cache_share",), "calibrate_profiles": ("cache_share",),
            "serve_colocation": SERVING + ("cache_share",),
            "profile_interference": ("cache_share",),
            "train_tiny_lm": ("rmsnorm", "flash_attention")}
TRAIN_TWIN_STEPS = 60          # of the example's 300
TRAIN_TWIN_CKPT = Path(__file__).resolve().parent / "results" / "tiny_lm_torch_smoke"
FIT_TOL = 1e-6                 # twin 4's fitted utilizations, torch against NumPy


@contextlib.contextmanager
def recorded_steps(steps: list):
    """Append every step captured in the body (``graphs.capture``) to
    ``steps``, so that its replays can be counted. Only this script does
    so."""
    saved = graphs.capture

    def capture(body, device, name):
        steps.append(saved(body, device, name))
        return steps[-1]
    graphs.capture = capture
    try:
        yield steps
    finally:
        graphs.capture = saved


def run_twin(name: str, argv: list) -> dict:
    """``repro_torch.examples.<name>.main(argv)`` as a user runs it, with the
    counts at 0 just before: its printout, its result, its seconds, and the
    launches on the card by kernel: the wrappers' counts (eager launches,
    the warm-ups and captures of new steps) plus the replays of every
    captured step, the solver's older ones included."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    old = list(estimator_torch.captured_steps())
    solver, new = {id(step): step.calls for step in old}, []
    reset_counts()
    t0 = time.perf_counter()
    with recorded_steps(new), contextlib.redirect_stdout(io.StringIO()) as out:
        ret = mod.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    for steps, since in ((old, solver), (new, None)):
        for k, n in replayed(steps, since).items():
            launches[k] += n
    return {"printed": out.getvalue(), "result": ret, "seconds": seconds, "launches": launches,
            "graphs_captured": len(new)}


def decisions(name: str, ret):
    """What a twin decided, for the comparison across backends: twin 1's
    placements (members in order) and solo lists, twin 2's final
    placement, twin 3's SLO attainment by class, twin 4's fitted
    utilizations."""
    if name == "quickstart":
        return [[[list(p.workloads) for p in plan.placements], list(plan.solo)] for plan in ret]
    if name == "fleet_failover":
        fleet = ret[0]
        return {did: list(p.workloads) for did, p in sorted(fleet.plan().placements.items())}
    if name == "trace_serving":
        report, _ = ret
        return {cls: att["attainment"] for cls, att in report["slo"]["per_class"].items()}
    return {n: {k: v for k, v in params.items() if k.startswith("u:")} for n, params in ret.items()}


def check_serve_twin_shapes(rng) -> float:
    """The serve twin's engine (``tiny_config(qwen3-1.7b)`` in its own bf16,
    4 slots x 769 positions, head_dim 16) at the shapes no other phase
    launches: serial mode's whole 512-token prompt in one extend step, and
    a 64-token chunk deep in it, against the plain version with the same
    device offsets."""
    cfg = tiny_config(get_config("qwen3-1.7b"))
    a = cfg.attn
    ck, cv = path_cache(rng, 1, 4, 769, a.n_kv_heads, a.head_dim, BF)
    worst = 0.0
    for S, c, pos0 in ((512, 512, 0), (64, 64, 448)):
        q = randn(rng, (1, S, a.n_heads, a.head_dim), BF)
        off = torch.tensor([3, pos0, c], device=DEV)
        worst = max(worst, check_attention(
            f"flash_attention serve twin S {S} pos0 {pos0} D {a.head_dim}",
            fa_mod.flash_attention(q, ck[0], cv[0], "causal", offsets=off),
            fa_mod.flash_attention_plain(q, ck[0], cv[0], "causal", offsets=off), BF))
    return worst


def phase_examples(records: dict) -> None:
    """The seven twins of the reference's examples (``repro_torch.examples``)
    run on the card as a user runs them, with their defaults: ``cuda``, the
    ``H100`` device model and the torch solver (train_tiny_lm at
    ``TRAIN_TWIN_STEPS`` steps; profile_interference over the ``dryrun``
    phase's records). Each must launch the kernels of its path
    (``EXAMPLES``). The four twins that only price run again with
    ``--backend numpy``: the same decisions (``decisions``), twins 2-4's
    printouts alike to the last printed digit (``printed_alike``), twin 3's
    report equal to its own twin run, twin 4's fits within ``FIT_TOL``."""
    serve_err = check_serve_twin_shapes(np.random.default_rng(6))
    out = {}
    shutil.rmtree(TRAIN_TWIN_CKPT, ignore_errors=True)
    argv = {"train_tiny_lm": ["--steps", str(TRAIN_TWIN_STEPS), "--ckpt", str(TRAIN_TWIN_CKPT)]}
    saved = profile_mod.RESULTS
    profile_mod.RESULTS = DRYRUN_DIR
    try:
        for name, kernels in EXAMPLES.items():
            run = run_twin(name, argv.get(name, []))
            missing = [k for k in kernels if not run["launches"][k]]
            if missing:
                raise AssertionError(f"example {name}: no launch of {missing}: {run['launches']}")
            rec = {"seconds": run["seconds"], "launches": run["launches"],
                   "graphs_captured": run["graphs_captured"],
                   "printed_tail": run["printed"].splitlines()[-3:]}
            if name in ("quickstart", "fleet_failover", "trace_serving", "calibrate_profiles"):
                host = run_twin(name, ["--backend", "numpy"])
                if any(host["launches"].values()):
                    raise AssertionError(f"example {name}: the NumPy run launched {host['launches']}")
                got, want = decisions(name, run["result"]), decisions(name, host["result"])
                if name == "calibrate_profiles":
                    values_close(got, want, FIT_TOL, f"example {name}")
                elif got != want:
                    raise AssertionError(f"example {name}: torch decided {got}, NumPy {want}")
                alike = printed_alike(run["printed"], host["printed"])
                if name != "quickstart" and not alike:
                    raise AssertionError(f"example {name}: the printouts differ:\n"
                                         f"{run['printed']}\n{host['printed']}")
                rec.update(numpy_seconds=host["seconds"], decisions_equal=True,
                           printouts_alike=alike)
            if name == "fleet_failover" and "cold plan over survivors: True" not in run["printed"]:
                raise AssertionError("example fleet_failover: online plan != cold plan")
            if name == "trace_serving":
                report, twin = run["result"]
                if report != twin:
                    raise AssertionError("example trace_serving: same seed, another report")
                rec["slo_attainment"] = decisions(name, run["result"])
            if name == "serve_colocation":
                i_serial, i_aware, prices = run["result"]
                rec.update(interleaved_serial=i_serial, interleaved_aware=i_aware,
                           chunk_prices=[float(x) for x in prices],
                           max_abs_err_new_shapes=serve_err)
            if name == "profile_interference":
                fps, plan = run["result"]
                if fps is None or len(fps) != len(DRYRUN_MODELS) * len(DRYRUN_SHAPES):
                    raise AssertionError(f"example profile_interference: priced {fps}")
                rec["solo"] = list(plan.solo)
            if name == "train_tiny_lm":
                losses = [h[1] for h in run["result"]]
                if len(losses) < 2 or not np.isfinite(losses).all():
                    raise AssertionError(f"example train_tiny_lm: losses {losses}")
                rec.update(steps=TRAIN_TWIN_STEPS, losses=losses,
                           verdict=run["printed"].split("(")[-1].split(")")[0])
            emit(phase="example", name=name, **rec)
            out[name] = rec
    finally:
        profile_mod.RESULTS = saved
    for name in SERVING + ("cache_share",):
        records[name]["launches_examples"] = sum(r["launches"][name] for r in out.values())
    emit(phase="examples", seconds={n: r["seconds"] for n, r in out.items()},
         numpy_seconds={n: r["numpy_seconds"] for n, r in out.items() if "numpy_seconds" in r},
         train_verdict=out["train_tiny_lm"]["verdict"])


# --------------------------------------------------------------------- #
#  phases 8 and 9: the model facade at full width (falcon-mamba, zamba2) #
# --------------------------------------------------------------------- #
def facade_weights(cfg):
    """The model at full width and depth on the card, bf16 weights drawn
    from seed 0. Returns (model, params, the weights' record)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    m = build_model(cfg, device=DEV)
    params = m.init(gen)
    torch.cuda.synchronize()
    return m, params, {
        "config": cfg.name, "n_params": sum(t.numel() for t in leaves(params)),
        "dtype": cfg.param_dtype,
        "bytes": sum(t.numel() * t.element_size() for t in leaves(params)),
        "seconds": time.perf_counter() - t0}


def facade_generate(m, params, B: int, S: int, n_dec: int, extra=None) -> tuple:
    """A prefill of B seeded prompts of S tokens and ``n_dec`` greedy decode
    steps (positions S .. S + n_dec - 1, a cache of S + n_dec), each step
    timed by the host clock until its ids are on the host, the kernels'
    launches counted over the run (after one short unmeasured run: the
    first launches load code). ``extra``: more entries of the prefill's
    batch (the vlm's vision tokens). Returns (the run's record, the
    launches, the prompt, the last ids, the cache)."""
    cfg, extra = m.cfg, extra or {}
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S))).to(DEV)
    with torch.no_grad():
        logits, cache = m.prefill(params, {**extra, "tokens": prompt[:, :64]}, S)
        m.decode_step(params, logits.argmax(-1), cache, 64)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                     # counts of this path only
        t0 = time.perf_counter()
        logits, cache = m.prefill(params, {**extra, "tokens": prompt}, S + n_dec)
        tok = logits.argmax(-1)
        ids = [tok.cpu()]
        prefill_s = time.perf_counter() - t0
        steps = []
        for i in range(n_dec):
            t1 = time.perf_counter()
            logits, cache = m.decode_step(params, tok, cache, S + i)
            tok = logits.argmax(-1)
            ids.append(tok.cpu())
            steps.append(time.perf_counter() - t1)
        used = counts()
    ids = torch.cat(ids, 1)
    if not torch.isfinite(logits).all() or not ((ids >= 0) & (ids < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: logits not finite or an id out of range")
    run = {"config": cfg.name, "batch": B, "prompt_tokens": S, "decode_steps": n_dec,
           "prefill_ms": prefill_s * 1e3, "prefill_tokens_per_s": B * S / prefill_s,
           "decode_step_ms_median": statistics.median(steps) * 1e3,
           "decode_step_ms_max": max(steps) * 1e3,
           "decode_tokens_per_s": B * n_dec / sum(steps),
           "tokens_per_s": B * (1 + n_dec) / (prefill_s + sum(steps)),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": used,
           "ids_of_request_0": ids[0].tolist()}
    return run, used, prompt, tok, cache


def facade_logits(m, params, prompt, extra=None, n: int = 128) -> dict:
    """The kernels against the plain versions through the facade, at the
    reference's bf16 tolerance: an ``n``-token prefill and one decode step;
    then prefill and decode against forward at their positions. ``extra``
    as ``facade_generate``'s."""
    name, short, errs, extra = m.cfg.name, prompt[:, :n], {}, extra or {}
    with torch.no_grad():
        got, got_cache = m.prefill(params, {**extra, "tokens": short}, n + 1)
        with plain_versions():
            plain, plain_cache = m.prefill(params, {**extra, "tokens": short}, n + 1)
        errs[f"prefill_{n}"] = logits_close(f"{name} prefill", got, plain)
        nxt = got.argmax(-1)
        got_d, _ = m.decode_step(params, nxt, got_cache, n)
        with plain_versions():
            plain_d, _ = m.decode_step(params, nxt, plain_cache, n)
        errs["decode"] = logits_close(f"{name} decode", got_d, plain_d)
        full = m.forward(params, {**extra, "tokens": torch.cat([short, nxt], 1)})
        errs["prefill_vs_forward"] = logits_close(f"{name} prefill vs forward",
                                                  got[:, 0], full[:, n - 1])
        errs["decode_vs_forward"] = logits_close(f"{name} decode vs forward",
                                                 got_d[:, 0], full[:, n])
    return errs


def phase_falcon_mamba(records: dict) -> None:
    """falcon-mamba-7b (64 layers, d_model 4096, d_inner 8192, N 16, vocab
    65024, bf16, seeded random weights) through the model facade: a
    prefill of 4 prompts of 1,024 tokens and 32 greedy decode steps; the
    launches of the run; a decode step's profile; and the logits against
    the plain versions and decode against forward (``facade_logits``)."""
    cfg = get_config("falcon-mamba-7b")
    L, B, S, n_dec = cfg.n_layers, 4, 1024, 32
    m, params, weights = facade_weights(cfg)
    emit(phase="falcon_weights", **weights)
    run, used, prompt, tok, cache = facade_generate(m, params, B, S, n_dec)
    want = {name: 0 for name in used}
    want.update(ssm_scan=L * (1 + n_dec), rmsnorm=(L + 1) * (1 + n_dec))
    if used != want:
        raise AssertionError(f"falcon-mamba: launches {used}, the steps imply {want}")
    emit(phase="falcon_mamba", **run)
    records["ssm_scan"]["launches"] = used["ssm_scan"]
    records["ssm_scan"]["launches_per_step"] = L
    records["rmsnorm"]["launches_falcon_mamba"] = used["rmsnorm"]
    emit(phase="falcon_step_profile",
         decode=profile_step(lambda: m.decode_step(params, tok, cache, S + n_dec)[0]
                             .argmax(-1).tolist()))
    del cache
    emit(phase="falcon_mamba_logits", max_abs_err=facade_logits(m, params, prompt),
         tolerance={"rtol": 0.15, "atol": 0.3})


def time_flash_attention_prefill(rng, B, S, H, KVH, D, kind="causal", window=0,
                                 splits=(), T=None) -> dict:
    """Causal (or local, over a window) attention over a whole prompt, S =
    T, or bidirectional attention of S queries over T keys (the vlm's
    cross attention, the audio encoder), with fresh k and v as the
    projections give them (``L`` copies, so the L2 cache is cold). The
    bound counts the (query, key) pairs the mask lets through; SDPA takes
    the local band as a boolean mask. ``splits``: the key splits to time
    beside the plan's (``ms_by_kv_splits``)."""
    L, T = 4, T or S
    qkv = [(randn(rng, (B, S, H, D), BF), randn(rng, (B, T, KVH, D), BF),
            randn(rng, (B, T, KVH, D), BF)) for _ in range(L)]
    pos = torch.arange(S, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

    def library(i):
        q, k, v = (t.transpose(1, 2) for t in qkv[i])
        if kind == "local":
            return F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=kind == "causal",
                                              enable_gqa=True)

    pairs = {"local": sum(min(s + 1, window) for s in range(S)), "causal": S * (S + 1) // 2,
             "bidirectional": S * T}[kind]
    b_ms, by = bound((2 * B * S * H * D + 2 * B * T * KVH * D) * 2, 4 * pairs * B * H * D, BF)
    plan = fa_mod.split_plan(B, S, H, T, BF, torch.cuda.get_device_properties(0).multi_processor_count)
    label = (f"B={B} S=T={S}" if T == S else f"B={B} S={S} T={T}") + \
        f" H={H} KVH={KVH} D={D} {kind}" + (f" window {window}" if window else "")
    fills = {f"kv_splits={n}": time_ms(
        lambda i, n=n: fa_mod.flash_attention(*qkv[i], kind, window, 0, n), L)["ms"] for n in splits}
    return {"shape": label, "dtype": "bfloat16", **plan, **({"ms_by_kv_splits": fills} if splits else {}),
            **time_ms(lambda i: fa_mod.flash_attention(*qkv[i], kind, window), L),
            "plain_ms": time_ms(lambda i: fa_mod.flash_attention_plain(*qkv[i], kind, window), L)["ms"],
            "library_ms": time_ms(library, L)["ms"], "bound_ms": b_ms, "bound_by": by}


ZAMBA2_NORMS = [(4096, 4096), (4, 4096), (4096, 2048), (4, 2048)]   # gated, per-layer


def check_zamba2_kernels(rng, B, S, n_dec, H, KVH, D) -> dict:
    """The three kernels of the zamba2 path against their plain versions at
    its shapes: the norms of a 4 x 1,024 prefill and of a decode step, the
    shared block's prefill attention, and its decode over the cache of S +
    n_dec positions at the first, a middle and the last step's lengths
    (kv_len S + i), and at four lengths in one batch."""
    errs = {"rmsnorm": 0.0, "flash_decode": 0.0}
    for shape in ZAMBA2_NORMS:
        x, s = randn(rng, shape, BF), randn(rng, (shape[-1],), F32)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"rmsnorm{shape} zamba2", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s), BF))
    q, k, v = (randn(rng, (B, S, h, D), BF) for h in (H, KVH, KVH))
    errs["flash_attention"] = check_attention(
        "flash_attention zamba2 prefill", fa_mod.flash_attention(q, k, v, "causal"),
        fa_mod.flash_attention_plain(q, k, v, "causal"), BF)
    T = S + n_dec
    ck, cv = path_cache(rng, 1, B, T, KVH, D, BF)
    q = randn(rng, (B, 1, H, D), BF)
    for lens in ([S + 1] * B, [S + n_dec // 2] * B, [T] * B, [S + 1, S + 9, S + 20, T]):
        lens = torch.tensor(lens, device=DEV)
        errs["flash_decode"] = max(errs["flash_decode"], check_attention(
            f"flash_decode zamba2 kv_len {lens.tolist()}", dec_mod.flash_decode(q, ck[0], cv[0], lens),
            dec_mod.flash_decode_plain(q, ck[0], cv[0], lens), BF))
    return errs


def phase_zamba2(records: dict) -> None:
    """zamba2-1.2b (38 layers: 6 groups of 6 Mamba-2 layers, each followed
    by the one shared attention block, and a tail of 2; d_model 2048,
    d_inner 4096, 64 SSD heads of 64, N 64; 32 / 32 heads of 64; vocab
    32000; bf16, seeded random weights) through the model facade, as
    falcon-mamba: prefill of 4 x 1,024 tokens, 32 greedy decode steps (not
    captured: the reference jits no step of its model facade), the launch
    gate, a decode step's profile, the logits against the plain versions;
    then the path's three kernels against their plain versions at its
    shapes, timed beside their bounds and the library's call."""
    cfg = get_config("zamba2-1.2b")
    g, tail = hybrid_split(cfg)
    a, B, S, n_dec = cfg.attn, 4, 1024, 32
    m, params, weights = facade_weights(cfg)
    emit(phase="zamba2_weights", groups=g, tail=tail, **weights)
    run, used, prompt, tok, cache = facade_generate(m, params, B, S, n_dec)
    norms = 2 * cfg.n_layers + 2 * g + 1          # ln and gated norm, ln1 and ln2, final
    want = {name: 0 for name in used}
    want.update(rmsnorm=norms * (1 + n_dec), flash_attention=g, flash_decode=g * n_dec)
    if used != want:
        raise AssertionError(f"zamba2: launches {used}, the steps imply {want}")
    emit(phase="zamba2", **run)
    for name in SERVING:
        records[name]["launches_zamba2"] = used[name]
    records["rmsnorm"]["launches_zamba2_per_pass"] = used["rmsnorm"] // (1 + n_dec)
    emit(phase="zamba2_step_profile",
         decode=profile_step(lambda: m.decode_step(params, tok, cache, S + n_dec - 1)[0]
                             .argmax(-1).tolist()),
         prefill=profile_step(lambda: m.prefill(params, {"tokens": prompt}, S + n_dec)[0]
                              .argmax(-1).tolist(), n=2))
    del cache
    emit(phase="zamba2_logits", max_abs_err=facade_logits(m, params, prompt),
         tolerance={"rtol": 0.15, "atol": 0.3})
    del m, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    errs = check_zamba2_kernels(rng, B, S, n_dec, a.n_heads, a.n_kv_heads, a.head_dim)
    T = S + n_dec
    times = {
        "rmsnorm": [time_rmsnorm(rng, shape, 4 if shape[0] > 4 else 1)
                    for shape in ZAMBA2_NORMS],
        "flash_attention": [time_flash_attention_prefill(rng, B, S, a.n_heads, a.n_kv_heads,
                                                         a.head_dim)],
        "flash_decode": [time_flash_decode(
            rng, [S + n_dec // 2] * B,
            f"B={B} H={a.n_heads} KVH={a.n_kv_heads} D={a.head_dim} T={T} kv_len {S + n_dec // 2}",
            B=B, H=a.n_heads, KVH=a.n_kv_heads, D=a.head_dim, T=T)],
    }
    emit(phase="zamba2_kernels", max_abs_err=errs, tolerance={"bfloat16": TOL[BF]}, times=times)
    for name in SERVING:
        records[name]["max_abs_err_zamba2"] = errs[name]
        records[name]["zamba2"] = times[name]


# --------------------------------------------------------------------- #
#  phase 10: gemma3-1b, the local:global stack at head_dim 256           #
# --------------------------------------------------------------------- #
def expect_refusal(what: str, call) -> str:
    """``call`` must raise ValueError: a case the kernels are not built for
    is refused, never computed some other way."""
    try:
        call()
    except ValueError as exc:
        return f"{what}: {exc}"
    raise AssertionError(f"{what}: not refused")


def check_gemma3_kernels(rng, B, S, n_dec, a, d_model) -> tuple:
    """The kernels of the gemma3 path against their plain versions at head
    dim 256: rmsnorm at d_model of a prefill and of a step; flash_attention
    over the whole prompt, causal and local, then at the body's other cases
    there (ragged, bidirectional, groups 2 and 8, the keys split over
    blocks, device offsets over an engine's cache); flash_decode over the
    global cache at the first, a middle and the last step's lengths and at
    four lengths in one batch, over a local ring (every row valid), with 8
    (gemma-2b) and 2 (gemma3-4b) query heads a KV head, over an f32 cache
    (a ring of two stages) and under f32 queries over a bf16 cache. Then
    the two cases the kernels are not built for must be refused: f32
    queries in flash_attention, 16 query heads a KV head in flash_decode.
    Returns (the largest errors by kernel, the refusals' messages)."""
    H, KVH, D, W = a.n_heads, a.n_kv_heads, a.head_dim, a.local_window
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0, "flash_decode": 0.0}

    def hold(key, name, got, want, dtype=BF):
        check = check_close if key == "rmsnorm" else check_attention
        errs[key] = max(errs[key], check(name, got, want, dtype))

    for shape in ((B * S, d_model), (B, d_model)):
        x, s = randn(rng, shape, BF), randn(rng, (d_model,), F32)
        hold("rmsnorm", f"rmsnorm{shape} gemma3", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s))
    q, k, v = (randn(rng, (B, S, h, D), BF) for h in (H, KVH, KVH))
    for kind in ("causal", "local"):
        hold("flash_attention", f"flash_attention gemma3 prefill {kind}",
             fa_mod.flash_attention(q, k, v, kind, W), fa_mod.flash_attention_plain(q, k, v, kind, W))
    for S2, T2, g, kind in [(200, 200, 4, "causal"), (37, 300, 2, "bidirectional"),
                            (130, 130, 8, "local")]:
        q2, k2, v2 = bhsd_views(rng, 2, g, S2, T2, D, BF)
        hold("flash_attention", f"flash_attention D{D} {kind} S{S2} T{T2} g{g}",
             fa_mod.flash_attention(q2, k2, v2, kind, 64), fa_mod.flash_attention_plain(q2, k2, v2, kind, 64))
    q2, k2, v2 = bhsd_views(rng, 1, 4, 128, 640, D, BF)
    want = fa_mod.flash_attention_plain(q2, k2, v2, "causal", 0, 512)
    for n in (2, 4):
        hold("flash_attention", f"flash_attention D{D} pos0 512 kv_splits={n}",
             fa_mod.flash_attention(q2, k2, v2, "causal", 0, 512, n), want)
    ck, cv = path_cache(rng, 1, 8, 1025, 1, D, BF)
    q2, off = randn(rng, (1, 128, 8, D), BF), torch.tensor([5, 900, 100], device=DEV)
    hold("flash_attention", f"flash_attention D{D} offsets slot 5 pos0 900 c 100",
         fa_mod.flash_attention(q2, ck[0], cv[0], "causal", offsets=off),
         fa_mod.flash_attention_plain(q2, ck[0], cv[0], "causal", offsets=off))
    T = S + n_dec
    ck, cv = path_cache(rng, 1, B, T, KVH, D, BF)
    q1 = randn(rng, (B, 1, H, D), BF)
    for lens in ([S + 1] * B, [S + n_dec // 2] * B, [T] * B, [S + 1, S + 9, S + 20, T]):
        lens = torch.tensor(lens, device=DEV)
        hold("flash_decode", f"flash_decode gemma3 global kv_len {lens.tolist()}",
             dec_mod.flash_decode(q1, ck[0], cv[0], lens), dec_mod.flash_decode_plain(q1, ck[0], cv[0], lens))
    rk, rv = path_cache(rng, 1, B, W, KVH, D, BF)
    lens = torch.full((B,), W, device=DEV)
    hold("flash_decode", "flash_decode gemma3 local ring", dec_mod.flash_decode(q1, rk[0], rv[0], lens),
         dec_mod.flash_decode_plain(q1, rk[0], rv[0], lens))
    lens = torch.tensor([T, 3, 500, 1000], device=DEV)
    for H2, KVH2 in ((8, 1), (8, 4)):
        q2 = randn(rng, (B, 1, H2, D), BF)
        k2, v2 = path_cache(rng, 1, B, T, KVH2, D, BF)
        hold("flash_decode", f"flash_decode D{D} G{H2 // KVH2}",
             dec_mod.flash_decode(q2, k2[0], v2[0], lens), dec_mod.flash_decode_plain(q2, k2[0], v2[0], lens))
    lens = torch.tensor([300, 17], device=DEV)
    for qd, kd in ((F32, F32), (F32, BF)):
        q2 = randn(rng, (2, 1, 8, D), qd)
        k2, v2 = path_cache(rng, 1, 2, 300, 2, D, kd)
        hold("flash_decode", f"flash_decode D{D} {qd} queries over a {kd} cache",
             dec_mod.flash_decode(q2, k2[0], v2[0], lens), dec_mod.flash_decode_plain(q2, k2[0], v2[0], lens),
             kd)
    refused = [expect_refusal("flash_attention, f32 queries at head_dim 256", lambda: fa_mod.flash_attention(
                   q[:1, :64].float(), k[:1, :64], v[:1, :64], "causal")),
               expect_refusal("flash_decode, 16 query heads a KV head at head_dim 256",
                              lambda: dec_mod.flash_decode(randn(rng, (B, 1, 16 * KVH, D), BF), ck[0],
                                                           cv[0], torch.full((B,), T, device=DEV)))]
    return errs, refused


def phase_gemma3(records: dict) -> None:
    """gemma3-1b as the repo configures it (26 layers: 4 groups of 5 local
    layers, window 512, and a global one, then a tail of 2 local layers;
    d_model 1,152, 4 / 1 heads of 256, d_ff 6,912 geglu, vocab 262,144 tied,
    the embedding scaled; one RoPE theta, no qk-norm, no softcap; bf16,
    seeded random weights) through the model facade, as zamba2: prefill of
    4 x 1,024 tokens (past the window: the local rings wrap), 32 greedy
    decode steps at positions 1,024 .. 1,055 (the rings wrap again), the
    launch gate, the profiles of a decode step and a prefill, the logits
    against the plain versions (a 128-token prefill: shorter than the
    window); then the two attention kernels against their plain versions
    at head_dim 256, timed beside their bounds and SDPA's."""
    cfg = get_config("gemma3-1b")
    g, tail = lg_split(cfg)
    a, L, B, S, n_dec = cfg.attn, cfg.n_layers, 4, 1024, 32
    m, params, weights = facade_weights(cfg)
    emit(phase="gemma3_weights", groups=g, tail=tail, local_layers=g * a.local_ratio + tail,
         n_params_by_config=cfg.n_params(), **weights)
    run, used, prompt, tok, cache = facade_generate(m, params, B, S, n_dec)
    norms = 2 * L + 1                              # ln1 and ln2 of every layer, final
    want = {name: 0 for name in used}
    want.update(rmsnorm=norms * (1 + n_dec), flash_attention=L, flash_decode=L * n_dec)
    if used != want:
        raise AssertionError(f"gemma3: launches {used}, the stack implies {want}")
    emit(phase="gemma3", ring_rows=a.local_window,
         cache_bytes=sum(t.numel() * t.element_size() for t in cache.values()), **run)
    for name in SERVING:
        records[name]["launches_gemma3"] = used[name]
    records["rmsnorm"]["launches_gemma3_per_pass"] = used["rmsnorm"] // (1 + n_dec)
    emit(phase="gemma3_step_profile",
         decode=profile_step(lambda: m.decode_step(params, tok, cache, S + n_dec - 1)[0]
                             .argmax(-1).tolist()),
         prefill=profile_step(lambda: m.prefill(params, {"tokens": prompt}, S + n_dec)[0]
                              .argmax(-1).tolist(), n=2))
    del cache
    emit(phase="gemma3_logits", max_abs_err=facade_logits(m, params, prompt),
         tolerance={"rtol": 0.15, "atol": 0.3})
    del m, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(4)
    errs, refused = check_gemma3_kernels(rng, B, S, n_dec, a, cfg.d_model)
    T, mid = S + n_dec, S + n_dec // 2
    times = {
        "rmsnorm": [time_rmsnorm(rng, (B * S, cfg.d_model), 8), time_rmsnorm(rng, (B, cfg.d_model))],
        "flash_attention": [time_flash_attention_prefill(rng, B, S, a.n_heads, a.n_kv_heads, a.head_dim,
                                                         splits=(1, 4)),
                            time_flash_attention_prefill(rng, B, S, a.n_heads, a.n_kv_heads, a.head_dim,
                                                         "local", a.local_window, splits=(1, 4))],
        "flash_decode": [time_flash_decode(
            rng, [mid] * B, f"B={B} H={a.n_heads} KVH={a.n_kv_heads} D={a.head_dim} T={T} kv_len {mid}",
            B=B, H=a.n_heads, KVH=a.n_kv_heads, D=a.head_dim, T=T),
                         time_flash_decode(
            rng, [a.local_window] * B, f"B={B} H={a.n_heads} KVH={a.n_kv_heads} D={a.head_dim} "
            f"local ring T={a.local_window}, all valid",
            B=B, H=a.n_heads, KVH=a.n_kv_heads, D=a.head_dim, T=a.local_window)],
    }
    emit(phase="gemma3_kernels", max_abs_err=errs, tolerance={"bfloat16": TOL[BF], "float32": TOL[F32]},
         refused=refused, times=times)
    for name in SERVING:
        records[name]["max_abs_err_gemma3"] = errs[name]
        records[name]["gemma3"] = times[name]


# --------------------------------------------------------------------- #
#  phase 10b: gemma-2b through the engine, gemma3-4b through the facade  #
# --------------------------------------------------------------------- #
def phase_gemma_2b(records: dict) -> None:
    """gemma-2b as the repo configures it (18 layers, d_model 2,048, 8 query
    heads over one KV head of 256 (MQA: G 8), d_ff 16,384 geglu, vocab
    256,000 tied, the embedding scaled; bf16, seeded random weights) served
    through the engine at full width and depth as llama3.1-8b is
    (``serve_at_full_size``: 8 slots x 1,024 positions, steps captured,
    interference_aware), every chunk priced on the torch solver on the
    card; ``flash_decode`` at B 8, 8 / 1 heads of 256 and ``flash_attention``
    at the engine's chunk held against their plain versions before the
    engine's graphs capture them."""
    with solver_backend("torch", device=DEV):
        warmup_solver(H100, ks=(2,), buckets=(8,))      # captured outside the counted serve
    serve_at_full_size(get_config("gemma-2b"), "gemma_2b", "gemma_2b", records, "torch")


GEMMA3_4B_PROMPT = 2048    # twice the local window, so that it cuts on the local layers
GEMMA3_4B_LOGITS = 1280    # the logits' prompt: past the window too


def phase_gemma3_4b(records: dict) -> None:
    """gemma3-4b as the repo configures it (34 layers: 5 groups of 5 local
    layers, window 1,024, and a global one, then a tail of 4 local layers;
    d_model 2,560, 8 / 4 heads of 256 (G 2), d_ff 10,240 geglu, vocab
    262,144 tied; bf16, seeded random weights, 3,879,907,840 parameters)
    through the model facade as gemma3-1b is: first both attention kernels
    against their plain versions at its shapes (``check_gemma3_kernels``:
    the causal global layers and the windowed local ones over the whole
    prompt, the global cache and the local ring in decode); then a prefill
    of 4 x 2,048 tokens, so that the window cuts, and 32 greedy decode
    steps, the launch gate, the profiles of a step and a prefill, the
    logits of a 1,280-token prefill against the plain versions and against
    forward; then the kernels timed beside their bounds and SDPA's."""
    cfg = get_config("gemma3-4b")
    g, tail = lg_split(cfg)
    a, L, B, S, n_dec = cfg.attn, cfg.n_layers, 4, GEMMA3_4B_PROMPT, 32
    rng = np.random.default_rng(5)
    errs, refused = check_gemma3_kernels(rng, B, S, n_dec, a, cfg.d_model)
    m, params, weights = facade_weights(cfg)
    emit(phase="gemma3_4b_weights", groups=g, tail=tail, local_layers=g * a.local_ratio + tail,
         n_params_by_config=cfg.n_params(), **weights)
    run, used, prompt, tok, cache = facade_generate(m, params, B, S, n_dec)
    want = {name: 0 for name in used}
    want.update(rmsnorm=(2 * L + 1) * (1 + n_dec), flash_attention=L, flash_decode=L * n_dec)
    if used != want:
        raise AssertionError(f"gemma3-4b: launches {used}, the stack implies {want}")
    emit(phase="gemma3_4b", ring_rows=a.local_window,
         cache_bytes=sum(t.numel() * t.element_size() for t in cache.values()), **run)
    for name in SERVING:
        records[name]["launches_gemma3_4b"] = used[name]
    emit(phase="gemma3_4b_step_profile",
         decode=profile_step(lambda: m.decode_step(params, tok, cache, S + n_dec - 1)[0]
                             .argmax(-1).tolist()),
         prefill=profile_step(lambda: m.prefill(params, {"tokens": prompt}, S + n_dec)[0]
                              .argmax(-1).tolist(), n=2))
    del cache
    emit(phase="gemma3_4b_logits", max_abs_err=facade_logits(m, params, prompt, n=GEMMA3_4B_LOGITS),
         tolerance={"rtol": 0.15, "atol": 0.3})
    del m, params
    torch.cuda.empty_cache()
    T, mid = S + n_dec, S + n_dec // 2
    H, KVH, D = a.n_heads, a.n_kv_heads, a.head_dim
    times = {
        "rmsnorm": [time_rmsnorm(rng, (B * S, cfg.d_model), 4), time_rmsnorm(rng, (B, cfg.d_model))],
        "flash_attention": [time_flash_attention_prefill(rng, B, S, H, KVH, D),
                            time_flash_attention_prefill(rng, B, S, H, KVH, D, "local",
                                                         a.local_window)],
        "flash_decode": [time_flash_decode(rng, [mid] * B, f"B={B} H={H} KVH={KVH} D={D} T={T} "
                                           f"kv_len {mid}", B=B, H=H, KVH=KVH, D=D, T=T),
                         time_flash_decode(rng, [a.local_window] * B, f"B={B} H={H} KVH={KVH} "
                                           f"D={D} local ring T={a.local_window}, all valid",
                                           B=B, H=H, KVH=KVH, D=D, T=a.local_window)],
    }
    # the run's launches at each timed shape: the prefill's and the steps'
    # norms; the global and the local layers' prompt attention; decode
    # over the global caches and over the local rings
    local = g * a.local_ratio + tail
    for t, n in zip(times["rmsnorm"] + times["flash_attention"] + times["flash_decode"],
                    (2 * L + 1, (2 * L + 1) * n_dec, L - local, local, (L - local) * n_dec,
                     local * n_dec)):
        t["launches"] = n
    emit(phase="gemma3_4b_kernels", max_abs_err=errs,
         tolerance={"bfloat16": TOL[BF], "float32": TOL[F32]}, refused=refused, times=times)
    for name in SERVING:
        records[name]["max_abs_err_gemma3_4b"] = errs[name]
        records[name]["gemma3_4b"] = times[name]


# --------------------------------------------------------------------- #
#  phase 11: moonshot-v1-16b-a3b, the moe family, served at full size    #
# --------------------------------------------------------------------- #
MOONSHOT_NORMS = [(128, 2048), (8, 2048), (4096, 2048)]   # a chunk, a decode step, prefill


def check_moonshot_kernels(rng, H, KVH, D) -> dict:
    """The three kernels of the moonshot path against their plain versions
    at its shapes: the norms of a chunk, a decode step and the facade's
    prefill; ``flash_attention`` with device offsets over the engine's
    cache (8 slots x 1,025 positions) at the path's chunks (a last chunk of
    100 whose bucket reaches past the cache, one token), and over the
    facade's whole prompt (4 x 1,024); ``flash_decode`` over the engine's
    cache at a decode batch's mixed lengths."""
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for shape in MOONSHOT_NORMS:
        x, s = randn(rng, shape, BF), randn(rng, (shape[-1],), F32)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"rmsnorm{shape} moonshot", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s), BF))
    ck, cv = path_cache(rng, 1, 8, 1025, KVH, D, BF)
    for S, c, pos0 in ((128, 128, 0), (128, 128, 512), (128, 100, 900), (16, 1, 40)):
        q = randn(rng, (1, S, H, D), BF)
        off = torch.tensor([3, pos0, c], device=DEV)
        errs["flash_attention"] = max(errs["flash_attention"], check_attention(
            f"flash_attention moonshot offsets pos0 {pos0} c {c}",
            fa_mod.flash_attention(q, ck[0], cv[0], "causal", offsets=off),
            fa_mod.flash_attention_plain(q, ck[0], cv[0], "causal", offsets=off), BF))
    q, k, v = (randn(rng, (4, 1024, h, D), BF) for h in (H, KVH, KVH))
    errs["flash_attention"] = max(errs["flash_attention"], check_attention(
        "flash_attention moonshot prefill", fa_mod.flash_attention(q, k, v, "causal"),
        fa_mod.flash_attention_plain(q, k, v, "causal"), BF))
    q = randn(rng, (8, 1, H, D), BF)
    lens = torch.tensor(MIXED_LENS, device=DEV)
    errs["flash_decode"] = check_attention(
        "flash_decode moonshot", dec_mod.flash_decode(q, ck[0], cv[0], lens),
        dec_mod.flash_decode_plain(q, ck[0], cv[0], lens), BF)
    return errs


def moonshot_facade_prefill(m, params, B: int, S: int) -> dict:
    """A prefill of B seeded prompts of S tokens through the model facade:
    its time (host clock to the ids on the host, after one short unmeasured
    prefill), its launches (``2 L + 1`` ``rmsnorm``, ``L``
    ``flash_attention``), peak memory, profile, and its logits against the
    plain versions with the routing replayed (``routing``), with the
    routing's agreement (``routing_agreement``)."""
    cfg, L = m.cfg, m.cfg.n_layers
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S))).to(DEV)
    batch = {"tokens": prompt}
    with torch.no_grad():
        m.prefill(params, {"tokens": prompt[:, :64]}, 64)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                     # counts of this prefill only
        t0 = time.perf_counter()
        logits, cache = m.prefill(params, batch, S)
        logits.argmax(-1).tolist()
        prefill_s = time.perf_counter() - t0
        used, peak = counts(SERVING), torch.cuda.max_memory_allocated()
        del cache
        want = {"rmsnorm": 2 * L + 1, "flash_attention": L, "flash_decode": 0}
        if used != want:
            raise AssertionError(f"moonshot prefill: launches {used}, the stack implies {want}")
        kern, plain = [], []
        with routing(record=kern):
            got = m.prefill(params, batch, S)[0]
        with plain_versions(), routing(record=plain, replay=kern):
            want_logits = m.prefill(params, batch, S)[0]
        err = logits_close("moonshot facade prefill", got, want_logits)
        agree = routing_agreement(agreement(kern, plain, slice(None), L), "moonshot prefill")
        del kern, plain
        profile = profile_step(lambda: m.prefill(params, batch, S)[0].argmax(-1).tolist(), n=2)
    return {"batch": B, "prompt_tokens": S, "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": B * S / prefill_s, "peak_memory_bytes": peak,
            "capacity_per_expert": moe_mod.capacity(B * S, cfg), "launches": used,
            "max_abs_err_logits": err, "tolerance": {"rtol": 0.15, "atol": 0.3},
            "routing_agreement": agree, "profile": profile}


def phase_moonshot(records: dict) -> None:
    """moonshot-v1-16b-a3b as the repo configures it (48 layers, d_model
    2048, 16 / 16 heads of 128, 64 experts of width 1,408, top 6, and 2
    shared; vocab 163,840; bf16, seeded random weights: 57.1 GB; not the
    published Moonlight-16B-A3B, which has 27 layers and latent attention),
    at full width and depth. Served through the engine with its captured
    steps (the qwen3 serve's request mix, interference_aware) under
    ``serve_checked``'s gates; the extend and decode steps' logits against
    the plain versions with the routing replayed, and their profiles; a
    prefill of 4 x 1,024 tokens through the model facade; then the path's
    three kernels against their plain versions at its shapes, timed
    beside their bounds and the library's call."""
    cfg = get_config("moonshot-v1-16b-a3b")
    a, L = cfg.attn, cfg.n_layers
    emit(phase="moonshot_memory_before", allocated_bytes=torch.cuda.memory_allocated(),
         reserved_bytes=torch.cuda.memory_reserved())
    m, params, weights = facade_weights(cfg)
    emit(phase="moonshot_weights", n_params_by_config=cfg.n_params(),
         n_active_params_by_config=cfg.n_active_params(), **weights)
    prompts = serve_prompts(cfg, np.random.default_rng(0))
    stats = serve_checked(cfg, EngineConfig(max_slots=8, max_len=1024, prefill_chunk=128),
                          prompts, 32, params)
    stats["capacity_decode"] = moe_mod.capacity(8, cfg)
    emit(phase="moonshot_serve", config=cfg.name, **stats)
    for name in SERVING:
        records[name]["launches_moonshot"] = stats["launches"][name]
    records["rmsnorm"]["launches_moonshot_per_step"] = 2 * L + 1
    eng = Engine(cfg, params=params, ecfg=EngineConfig(max_slots=8, max_len=1024), device=DEV)
    decode, chunk = eng._phase_profile("decode", 8), eng._phase_profile("prefill128", 128)
    emit(phase="moonshot_price", device_model=eng.dev.name,
         priced_params=cfg.n_active_params(), priced_decode_bytes=decode.demand["hbm"],
         priced_decode_ms=decode.isolated_time(eng.dev) * 1e3,
         priced_extend_128_ms=chunk.isolated_time(eng.dev) * 1e3,
         weight_bytes=weights["bytes"])
    errs, profiles, agree = step_logits_and_profiles(eng, np.random.default_rng(0))
    del eng
    emit(phase="moonshot_routing_agreement", steps=agree)
    emit(phase="moonshot_serve_logits", max_abs_err=errs, tolerance={"rtol": 0.15, "atol": 0.3},
         routing="the kernels' run's, replayed in the plain run")
    emit(phase="moonshot_step_profile", **profiles)
    emit(phase="moonshot_facade", **moonshot_facade_prefill(m, params, 4, 1024))
    del m, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(3)
    errs = check_moonshot_kernels(rng, a.n_heads, a.n_kv_heads, a.head_dim)
    kvh = a.n_kv_heads
    times = {
        "rmsnorm": [time_rmsnorm(rng, (1, 128, 2048)), time_rmsnorm(rng, (8, 1, 2048)),
                    time_rmsnorm(rng, (4, 1024, 2048), 4)],
        "flash_attention": [time_flash_attention(rng, 128, 512, KVH=kvh),
                            time_flash_attention_offsets(rng, 512, KVH=kvh),
                            time_flash_attention_prefill(rng, 4, 1024, a.n_heads, kvh,
                                                         a.head_dim)],
        "flash_decode": [time_flash_decode(rng, MIXED_LENS,
                                           f"B=8 H={a.n_heads} KVH={kvh} D={a.head_dim} "
                                           "T=1025 mixed", KVH=kvh)],
    }
    emit(phase="moonshot_kernels", max_abs_err=errs, tolerance={"bfloat16": TOL[BF]}, times=times)
    for name in SERVING:
        records[name]["max_abs_err_moonshot"] = errs[name]
        records[name]["moonshot"] = times[name]


# --------------------------------------------------------------------- #
#  phase 12: llama-3.2-vision-90b, the vlm family, at full width         #
# --------------------------------------------------------------------- #
VLM_LAYERS = 30            # 6 of the config's 20 groups: 55.4 GB of the 174.8 on one card


def check_vlm_kernels(rng, B, S, n_dec, a, d_model, n_vision) -> dict:
    """The three kernels of the vlm path against their plain versions at
    its shapes: rmsnorm at d_model of a prefill and of a step;
    flash_attention over the causal prompt at 8 query heads a KV head, and
    the cross attention, S queries over the ``n_vision`` vision keys,
    bidirectional; flash_decode over the self layers' cache at mixed
    lengths and over the vision cache, every key valid. The gate of each
    long one must fail the plain version with a 64-key tile (prefill) or
    one split (decode) of its keys left out."""
    H, KVH, D = a.n_heads, a.n_kv_heads, a.head_dim
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0, "flash_decode": 0.0}

    def hold(key, name, got, want, dropped=()):
        check = check_close if key == "rmsnorm" else partial(check_attention, dropped=dropped)
        errs[key] = max(errs[key], check(name, got, want, BF))

    for shape in ((B * S, d_model), (B, d_model)):
        x, s = randn(rng, shape, BF), randn(rng, (d_model,), F32)
        hold("rmsnorm", f"rmsnorm{shape} vlm", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s))
    q = randn(rng, (B, S, H, D), BF)
    for name, T, kind in (("self, causal", S, "causal"), ("cross", n_vision, "bidirectional")):
        k, v = randn(rng, (B, T, KVH, D), BF), randn(rng, (B, T, KVH, D), BF)
        dropped = ([fa_mod.flash_attention_plain(q, *without_keys(k, v, T // 2, 64), kind)]
                   if kind == "bidirectional" else [])
        hold("flash_attention", f"flash_attention vlm {name} S{S} T{T} G{H // KVH}",
             fa_mod.flash_attention(q, k, v, kind), fa_mod.flash_attention_plain(q, k, v, kind), dropped)
        del k, v, dropped
    q1 = randn(rng, (B, 1, H, D), BF)
    T = S + n_dec
    for T2, lens in ((T, [S + 1, S + 9, S + 20, T]), (T, [S + n_dec // 2] * B),
                     (n_vision, [n_vision] * B)):
        ck, cv = path_cache(rng, 1, B, T2, KVH, D, BF)
        lens = torch.tensor(lens, device=DEV)
        dropped = []
        if T2 == n_vision:                 # every key valid: leave out the second split
            chunk = dec_mod.split_plan(T2, B * KVH)[0]
            dropped = [dec_mod.flash_decode_plain(q1, *without_keys(ck[0], cv[0], chunk, chunk),
                                                  lens - chunk)]
        hold("flash_decode", f"flash_decode vlm T{T2} kv_len {lens.tolist()}",
             dec_mod.flash_decode(q1, ck[0], cv[0], lens), dec_mod.flash_decode_plain(q1, ck[0], cv[0], lens),
             dropped)
    return errs


def phase_llama_vision(records: dict) -> None:
    """llama-3.2-vision-90b as the repo configures it (d_model 8,192, 64 / 8
    heads of 128, d_ff 28,672 silu, vocab 128,256 untied; every 5th layer
    a tanh-gated cross-attention layer over 4,096 vision tokens of width
    1,280; bf16, seeded random weights) at full width and 30 of its 100
    layers (6 groups: 24 self and 6 cross layers, 55.4 GB; the whole model
    is 174.8 GB), through the model facade: every cross layer's gate set
    to 0.5 (the reference's init leaves it at 0, and tanh(0) would hide the
    cross attention from the logits), vision embeddings (4, 4,096, 1,280)
    from the seed, prefill of 4 x 1,024 text tokens, 32 greedy decode
    steps (not captured: the reference jits no step of its facade), the
    launch gate, the profiles of a step and a prefill, the logits against
    the plain versions; then the three kernels against their plain
    versions at its shapes, timed beside their bounds and the library's
    call."""
    cfg = get_config("llama-3.2-vision-90b").with_overrides(n_layers=VLM_LAYERS)
    g, n_self = vlm_split(cfg)
    a, L, B, S, n_dec = cfg.attn, cfg.n_layers, 4, 1024, 32
    emit(phase="llama_vision_memory_before", allocated_bytes=torch.cuda.memory_allocated(),
         reserved_bytes=torch.cuda.memory_reserved())
    m, params, weights = facade_weights(cfg)
    params["stack"]["crosses"]["xattn"]["gate"].fill_(0.5)
    emit(phase="llama_vision_weights", groups=g, self_layers=g * n_self, cross_layers=g,
         reduced={"n_layers": [get_config("llama-3.2-vision-90b").n_layers, L]},
         n_params_by_config=cfg.n_params(), cross_gate=0.5, **weights)
    vision = randn(np.random.default_rng(5), (B, cfg.n_vision_tokens, cfg.d_vision), BF)
    extra = {"vision": vision}
    run, used, prompt, tok, cache = facade_generate(m, params, B, S, n_dec, extra)
    norms = 2 * L + 1                              # ln1 / ln2, ln / ln2 of every layer, final
    want = {name: 0 for name in used}
    want.update(rmsnorm=norms * (1 + n_dec), flash_attention=L, flash_decode=L * n_dec)
    if used != want:
        raise AssertionError(f"llama_vision: launches {used}, the stack implies {want}")
    emit(phase="llama_vision", vision_tokens=cfg.n_vision_tokens,
         cache_bytes=sum(t.numel() * t.element_size() for t in cache.values()), **run)
    for name in SERVING:
        records[name]["launches_llama_vision"] = used[name]
    records["rmsnorm"]["launches_llama_vision_per_pass"] = used["rmsnorm"] // (1 + n_dec)
    emit(phase="llama_vision_step_profile",
         decode=profile_step(lambda: m.decode_step(params, tok, cache, S + n_dec - 1)[0]
                             .argmax(-1).tolist()),
         prefill=profile_step(lambda: m.prefill(params, {**extra, "tokens": prompt}, S + n_dec)[0]
                              .argmax(-1).tolist(), n=2))
    del cache
    emit(phase="llama_vision_logits", max_abs_err=facade_logits(m, params, prompt, extra),
         tolerance={"rtol": 0.15, "atol": 0.3})
    del m, params, vision, extra
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(6)
    errs = check_vlm_kernels(rng, B, S, n_dec, a, cfg.d_model, cfg.n_vision_tokens)
    T, mid, H, KVH, D = S + n_dec, S + n_dec // 2, a.n_heads, a.n_kv_heads, a.head_dim
    times = {
        "rmsnorm": [time_rmsnorm(rng, (B * S, cfg.d_model), 4), time_rmsnorm(rng, (B, cfg.d_model))],
        "flash_attention": [time_flash_attention_prefill(rng, B, S, H, KVH, D),
                            time_flash_attention_prefill(rng, B, S, H, KVH, D, "bidirectional",
                                                         T=cfg.n_vision_tokens)],
        "flash_decode": [time_flash_decode(rng, [mid] * B, f"B={B} H={H} KVH={KVH} D={D} T={T} kv_len {mid}",
                                           B=B, H=H, KVH=KVH, D=D, T=T),
                         time_flash_decode(rng, [cfg.n_vision_tokens] * B,
                                           f"B={B} H={H} KVH={KVH} D={D} cross, T={cfg.n_vision_tokens}"
                                           ", all valid", B=B, H=H, KVH=KVH, D=D, T=cfg.n_vision_tokens)],
    }
    emit(phase="llama_vision_kernels", max_abs_err=errs, tolerance={"bfloat16": TOL[BF]}, times=times)
    for name in SERVING:
        records[name]["max_abs_err_llama_vision"] = errs[name]
        records[name]["llama_vision"] = times[name]


# --------------------------------------------------------------------- #
#  phase 13: hubert-xlarge, the audio encoder, head_dim 80               #
# --------------------------------------------------------------------- #
def check_hubert_kernels(rng, B, S, a, d_model) -> dict:
    """flash_attention at head_dim 80 against its plain version: hubert's
    bidirectional attention (B, S = T, 16 / 16 heads) and the same
    causal; the keys split over two blocks at B 1 (one sequence's blocks
    leave SMs empty, and hubert's own shape takes no split), so that the
    merge runs at 20 threads a row; ragged query and key counts at groups 1
    and 2; f32 queries, the FMA body, over an f32 and a bf16 cache. The
    bidirectional gate must fail the plain version with a 64-key tile left
    out. Then rmsnorm at d_model of the forward."""
    H, KVH, D = a.n_heads, a.n_kv_heads, a.head_dim
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}

    def hold(key, name, got, want, dtype=BF, dropped=()):
        check = check_close if key == "rmsnorm" else partial(check_attention, dropped=dropped)
        errs[key] = max(errs[key], check(name, got, want, dtype))

    q, k, v = (randn(rng, (B, S, h, D), BF) for h in (H, KVH, KVH))
    for kind in ("bidirectional", "causal"):
        dropped = ([fa_mod.flash_attention_plain(q, *without_keys(k, v, S // 2, 64), kind)]
                   if kind == "bidirectional" else [])
        hold("flash_attention", f"flash_attention hubert {kind} D{D}",
             fa_mod.flash_attention(q, k, v, kind), fa_mod.flash_attention_plain(q, k, v, kind),
             dropped=dropped)
        want = fa_mod.flash_attention_plain(q[:1], k[:1], v[:1], kind)
        for n in (2, 4):
            hold("flash_attention", f"flash_attention D{D} {kind} B1 kv_splits={n}",
                 fa_mod.flash_attention(q[:1], k[:1], v[:1], kind, 0, 0, n), want)
    for S2, T2, g, kind in [(200, 200, 1, "causal"), (37, 300, 2, "bidirectional"),
                            (130, 130, 2, "local")]:
        q2, k2, v2 = bhsd_views(rng, 2, g, S2, T2, D, BF)
        hold("flash_attention", f"flash_attention D{D} {kind} S{S2} T{T2} g{g}",
             fa_mod.flash_attention(q2, k2, v2, kind, 64), fa_mod.flash_attention_plain(q2, k2, v2, kind, 64))
    for kd in (F32, BF):
        q2, k2, v2 = randn(rng, (2, 160, 4, D), F32), randn(rng, (2, 160, 2, D), kd), randn(rng, (2, 160, 2, D), kd)
        hold("flash_attention", f"flash_attention D{D} f32 queries over a {kd} cache",
             fa_mod.flash_attention(q2, k2, v2, "bidirectional"),
             fa_mod.flash_attention_plain(q2, k2, v2, "bidirectional"), kd)
    x, s = randn(rng, (B * S, d_model), BF), randn(rng, (d_model,), F32)
    hold("rmsnorm", f"rmsnorm{(B * S, d_model)} hubert", rms_mod.rmsnorm(x, s), rms_mod.rmsnorm_plain(x, s))
    return errs


def phase_hubert(records: dict) -> None:
    """hubert-xlarge as the repo configures it (48 encoder layers, d_model
    1,280, 16 / 16 heads of 80, d_ff 5,120 gelu, 504 units; the waveform
    frontend a stub: frame embeddings in; bf16, seeded random weights) at
    full width and depth through the model facade: a forward over frames of
    (4, 1,024, 1,280) from the seed, about 20 s of audio at 20 ms a frame;
    the launch gate, the logits against the plain versions, prefill,
    decode_step and init_cache refused (an encoder), the forward's
    profile; then flash_attention at head_dim 80 and rmsnorm against their
    plain versions, timed beside their bounds and the library's call."""
    cfg = get_config("hubert-xlarge")
    a, L, B, S = cfg.attn, cfg.n_layers, 4, 1024
    m, params, weights = facade_weights(cfg)
    emit(phase="hubert_weights", n_params_by_config=cfg.n_params(), **weights)
    frames = randn(np.random.default_rng(7), (B, S, cfg.d_model), BF)
    batch = {"frames": frames}
    with torch.no_grad():
        m.forward(params, {"frames": frames[:, :64]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                     # counts of this forward only
        t0 = time.perf_counter()
        logits = m.forward(params, batch)
        ids = logits.argmax(-1).cpu()
        forward_s = time.perf_counter() - t0
        used, peak = counts(), torch.cuda.max_memory_allocated()
        want = {name: 0 for name in used}
        want.update(rmsnorm=2 * L + 1, flash_attention=L)
        if used != want:
            raise AssertionError(f"hubert: launches {used}, the stack implies {want}")
        if logits.shape != (B, S, cfg.vocab_size) or not ((ids >= 0) & (ids < cfg.vocab_size)).all():
            raise AssertionError(f"hubert: logits of shape {tuple(logits.shape)}")
        with plain_versions():
            plain = m.forward(params, batch)
        err = logits_close("hubert forward", logits, plain)
        del plain
        refused = [expect_refusal("hubert prefill", lambda: m.prefill(params, batch, S)),
                   expect_refusal("hubert decode_step", lambda: m.decode_step(
                       params, ids[:, :1].to(DEV), {}, S)),
                   expect_refusal("hubert init_cache", lambda: m.init_cache(B, S))]
        profile = profile_step(lambda: m.forward(params, batch).argmax(-1).tolist(), n=2)
    emit(phase="hubert", config=cfg.name, batch=B, frames=S, forward_ms=forward_s * 1e3,
         frames_per_s=B * S / forward_s, peak_memory_bytes=peak, launches=used,
         max_abs_err_logits=err, tolerance={"rtol": 0.15, "atol": 0.3}, refused=refused,
         profile=profile)
    records["flash_attention"]["launches_hubert"] = used["flash_attention"]
    records["rmsnorm"]["launches_hubert"] = used["rmsnorm"]
    del m, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(8)
    errs = check_hubert_kernels(rng, B, S, a, cfg.d_model)
    times = {"rmsnorm": [time_rmsnorm(rng, (B * S, cfg.d_model), 8)],
             "flash_attention": [time_flash_attention_prefill(
                 rng, B, S, a.n_heads, a.n_kv_heads, a.head_dim, "bidirectional", splits=(1, 2))]}
    emit(phase="hubert_kernels", max_abs_err=errs, tolerance={"bfloat16": TOL[BF], "float32": TOL[F32]},
         times=times)
    for name in ("rmsnorm", "flash_attention"):
        records[name]["max_abs_err_hubert"] = errs[name]
        records[name]["hubert"] = times[name]


# --------------------------------------------------------------------- #
#  phase 14: training qwen3-1.7b at full width and depth                 #
# --------------------------------------------------------------------- #
TRAIN_MICROBATCHES = 4        # global batch 8 in 4 microbatches of 2
TRAIN_STEPS = 4


def event_ms(fn, iters: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` eager calls between CUDA
    events, after one call to warm up (for calls too large to capture)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel_grads(rng, S, H, KVH, D, d_model) -> dict:
    """Gate 1 of the train phase (ROADMAP C17): a backward through each of
    the four wrappers on the card, given inputs that require grad, runs the
    kernel forward inside its Function (one launch) and gives every input
    a gradient equal, at the bf16 gate, to the plain version's autograd on
    the same inputs; the forward is held to the plain version's too.
    Shapes: qwen3-1.7b's training microbatch (rmsnorm over 2 x 4,096 rows
    of 2,048, causal attention over 2 x 4,096 tokens), its serve's decode
    step, and falcon-mamba's prefill for the scan."""
    errs = {}

    def hold(name, call, plain, inputs, check, fwd_check=None):
        leaves_in = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        before = counts([name])[name]
        out = call(*leaves_in)
        if counts([name])[name] != before + 1:
            raise AssertionError(f"{name}: the Function ran "
                                 f"{counts([name])[name] - before} launches, not one")
        first = out[0] if isinstance(out, tuple) else out
        ref_in = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        ref = plain(*ref_in)
        ref_first = ref[0] if isinstance(ref, tuple) else ref
        err = (fwd_check or check)(f"{name} forward", first, ref_first, BF)
        ct = randn(rng, tuple(first.shape), F32).to(first.dtype)
        want_in = [t for t in ref_in if t.requires_grad]
        got_in = [t for t in leaves_in if t.requires_grad]
        got = torch.autograd.grad(first, got_in, ct)
        want = torch.autograd.grad(ref_first, want_in, ct)
        for i, (g, w) in enumerate(zip(got, want)):
            if g is None:
                raise AssertionError(f"{name}: input {i} has no gradient")
            err = max(err, check(f"{name} grad {i}", g, w, BF))
        errs[name] = err

    x, s = randn(rng, (2 * S, d_model), BF), randn(rng, (d_model,), F32)
    hold("rmsnorm", rms_mod.rmsnorm, rms_mod.rmsnorm_plain, [x, s], check_close)
    q, k, v = (randn(rng, (2, S, h, D), BF) for h in (H, KVH, KVH))
    hold("flash_attention", fa_mod.flash_attention, fa_mod.flash_attention_plain,
         [q, k, v], check_attention)
    lens = torch.tensor(MIXED_LENS, device=DEV)
    ck, cv = (randn(rng, (8, 1025, KVH, D), BF) for _ in "kv")
    hold("flash_decode", lambda q, k, v: dec_mod.flash_decode(q, k, v, lens),
         lambda q, k, v: dec_mod.flash_decode_plain(q, k, v, lens),
         [randn(rng, (8, 1, H, D), BF), ck, cv], check_attention)
    cfg = get_config("falcon-mamba-7b")
    scan_in = falcon_scan_inputs(rng, 4, 1024, cfg.d_inner, cfg.ssm.d_state, BF)
    hold("ssm_scan", ssm_mod.ssm_scan, ssm_mod.ssm_scan_plain, list(scan_in), check_close,
         fwd_check=lambda name, g, w, dt: check_close(name, g, w, F32, SCAN_TOL))
    return errs


def probe_step(m, params, batch, run) -> tuple:
    """Step 0's loss and the gradients' global norm as the train step makes
    them (microbatches, f32 accumulation), through ``make_train_step``
    with an optimizer that reads the gradients and leaves the parameters
    as they are."""
    seen = {}

    def update(grads, state, p):
        seen["grad_norm"] = float(global_norm(grads))
        return p, state
    step = make_train_step(m, Optimizer(lambda p: {}, update, "read_grads"), run)
    _, _, metrics = step(params, {}, batch)
    return float(metrics["loss"]), seen["grad_norm"]


class StepWatch:
    """The train phase's data source for ``Trainer.fit``: SyntheticLM's
    batches, and at each draw (a step's start, after the last step's loss
    was read on the host, which waits for its update) the device's peak
    memory over the step before; at the second draw, the parameter leaves
    that step 0 left as they were, against a host copy taken before it. At
    the draw for step ``trace_step`` it starts a trace (``start_trace``)
    and marks the step's start; ``stop`` marks its end and stops it."""

    def __init__(self, source, params, trace_step: int):
        self.source, self.params, self.calls = source, params, 0
        self.trace_step, self.prof = trace_step, None
        self.before = [t.detach().to("cpu", copy=True) for t in leaves(params)]
        self.peaks, self.unchanged = [], None
        torch.cuda.reset_peak_memory_stats()

    def __iter__(self):
        return self

    def __next__(self):
        if self.calls:
            self.peaks.append(torch.cuda.max_memory_allocated())
        if self.calls == 1:
            self.unchanged = [i for i, (a, b) in enumerate(zip(self.before, leaves(self.params)))
                              if torch.equal(a, b.cpu())]
            self.before = None
        torch.cuda.reset_peak_memory_stats()
        if self.calls == self.trace_step:
            self.prof = start_trace()
            mark()
        self.calls += 1
        return next(self.source)

    def stop(self):
        """After the last step: its peak, and the trace's end."""
        self.peaks.append(torch.cuda.max_memory_allocated())
        mark()
        torch.cuda.synchronize()
        self.prof.stop()


def phase_train(records: dict) -> None:
    """qwen3-1.7b as the repo configures it (28 layers, 16 / 8 heads of 128,
    vocab 151,936, bf16, seeded random weights) trained at full width and
    depth through ``Trainer.fit``: SyntheticLM batches at train_4k's
    sequence of 4,096 (``configs/base.py``), a global batch of 8 in 4
    microbatches of 2, AdamW, ``remat_policy="full"``, 4 steps, no
    checkpoint written. The forward runs rmsnorm and flash_attention on
    their kernels inside their Functions, whose backward is the plain
    versions' VJP. Gates: (1) each of the four kernels' gradients at the
    training shapes against the plain versions' autograd; (2) step 0's loss
    and gradient norm against the same step under the plain versions,
    within 2e-2 relative; (3) finite losses, and every parameter leaf moved
    by step 0; (4) the launches a step: per microbatch 2L + 1 rmsnorm and L
    flash_attention in the forward, and the layers' again in the remat
    recompute. The last step is traced (its wall time carries the
    profiler's cost: ``traced``), against the untraced steps before it:
    the device's idle share, the plain attention backward's share of the
    device time; then rmsnorm and flash_attention timed at the training
    shapes."""
    cfg = get_config("qwen3-1.7b").with_overrides(remat_policy="full")
    a, L = cfg.attn, cfg.n_layers
    S, K, GB = TRAIN_4K.seq_len, TRAIN_MICROBATCHES, 8
    rng = np.random.default_rng(14)
    t_phase = time.perf_counter()
    grad_errs = check_kernel_grads(rng, S, a.n_heads, a.n_kv_heads, a.head_dim, cfg.d_model)
    emit(phase="train_kernel_grads", seconds=time.perf_counter() - t_phase,
         max_abs_err=grad_errs, tolerance={"bfloat16": TOL[BF], "ssm_scan forward": SCAN_TOL},
         how="forward through each wrapper's Function on the card (one kernel launch), "
             "gradients of every input against the plain version's autograd")
    gc.collect()
    torch.cuda.empty_cache()

    m, params, weights = facade_weights(cfg)
    run = RunConfig(num_microbatches=K)
    trainer = Trainer(m, run, TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                            optimizer="adamw"))
    data = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=GB,
                                       vocab_size=cfg.vocab_size, seed=0))
    batch0 = trainer.to_device(data.batch_at(0))
    loss0, gnorm0 = probe_step(m, params, batch0, run)
    with plain_versions():
        loss0_p, gnorm0_p = probe_step(m, params, batch0, run)
    rel = {"loss": abs(loss0 / loss0_p - 1), "grad_norm": abs(gnorm0 / gnorm0_p - 1)}
    emit(phase="train_step0", seconds=time.perf_counter() - t_phase, loss=loss0,
         loss_plain=loss0_p, grad_norm=gnorm0, grad_norm_plain=gnorm0_p, rel_diff=rel,
         tolerance=2e-2)
    if not all(r <= 2e-2 for r in rel.values()):
        raise AssertionError(f"train: step 0 with the kernels differs from the plain "
                             f"versions' by {rel}")

    opt_state = trainer.opt.init(params)
    watch = StepWatch(data, params, trace_step=TRAIN_STEPS - 1)
    reset_counts()                          # counts of the four steps only
    params, opt_state, history = trainer.fit(watch, params=params, opt_state=opt_state)
    watch.stop()
    used = counts()
    want = {name: 0 for name in used}
    want.update(rmsnorm=TRAIN_STEPS * K * (4 * L + 1), flash_attention=TRAIN_STEPS * K * 2 * L)
    if used != want:
        raise AssertionError(f"train: launches {used}, the steps imply {want}")
    losses = [h[1] for h in history]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if watch.unchanged:
        raise AssertionError(f"train: step 0 left parameter leaves {watch.unchanged} as they were")
    tokens = GB * S
    n = weights["n_params"]
    flop = tokens * (6 * n + 6 * L * a.n_heads * a.head_dim * S)
    steps = [{"step": st, "loss": lo, "wall_ms": dt * 1e3, "tokens_per_s": tokens / dt,
              "peak_gb": pk / 1e9, "train_mfu": flop / (dt * PEAK_OPS_PER_S[BF]),
              "traced": st == watch.trace_step}
             for (st, lo, dt), pk in zip(history, watch.peaks)]
    emit(phase="train", seconds=time.perf_counter() - t_phase, config=cfg.name, n_params=n,
         seq=S, global_batch=GB, microbatches=K, optimizer="adamw",
         remat_policy=cfg.remat_policy, steps=steps,
         launches_per_step={k: v // TRAIN_STEPS for k, v in used.items() if v},
         flop_per_step=flop, straggler_events=trainer.straggler.events)
    records["rmsnorm"]["launches_train"] = used["rmsnorm"] // TRAIN_STEPS
    records["flash_attention"]["launches_train"] = used["flash_attention"] // TRAIN_STEPS

    t0 = time.perf_counter()
    # the traced step against the steps before it, which ran untraced
    profile = read_trace(watch.prof, statistics.median(h[2] for h in history[1:-1]) * 1e3,
                         n=1)
    profile["read_seconds"] = time.perf_counter() - t0
    del watch
    q, k, v = (randn(rng, (2, S, h, a.head_dim), BF).requires_grad_()
               for h in (a.n_heads, a.n_kv_heads, a.n_kv_heads))
    out = fa_mod.flash_attention(q, k, v)
    ct = randn(rng, tuple(out.shape), BF)
    bwd_ms = event_ms(lambda: torch.autograd.grad(out, (q, k, v), ct, retain_graph=True))
    del q, k, v, out
    busy = profile.get("device_busy_ms")
    share = (K * L * bwd_ms / busy) if isinstance(busy, float) else "not measured"
    emit(phase="train_profile", profile=profile, attention_backward_ms_per_call=bwd_ms,
         attention_backward_calls_per_step=K * L, attention_backward_share_of_device_time=share)
    del m, params, opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    times = {"rmsnorm": [time_rmsnorm(rng, (2 * S, cfg.d_model), 4)],
             "flash_attention": [time_flash_attention_prefill(
                 rng, 2, S, a.n_heads, a.n_kv_heads, a.head_dim)]}
    emit(phase="train_kernels", seconds=time.perf_counter() - t_phase, times=times)
    for name in ("rmsnorm", "flash_attention"):
        records[name]["train"] = times[name]
    for name, err in grad_errs.items():
        records[name]["max_abs_err_train_grads"] = err


# --------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the GPU path "
              "and does not run on the CPU", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    pods = []                         # the pod counts' child, once started
    try:
        return run_phases(t_all, pods)
    finally:
        for proc in pods:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(t_all: float, pods: list) -> int:
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    clocks = run_text(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                       "--format=csv,noheader"])
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    nvcc = run_text([_build._nvcc(), "--version"]).splitlines()[-2:]
    emit(phase="device", nvidia_smi=smi, clocks_sm_and_max=clocks,
         torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.load()
    built = ptxas_summary()
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=[s.name for s in _build.sources()], **built)
    spilled = [k for k in built["kernels_with_spills"]
               if any(n in k for n in ("flash_attention", "decode_", "stress_mxu", "ssm_scan"))]
    if spilled:
        raise AssertionError(f"attention, stress_mxu or ssm_scan kernels spill registers: {spilled}")
    if any("stress_mxu" in ln for ln in built["wgmma_serialized"]):
        raise AssertionError(f"ptxas serialised stress_mxu's wgmma: {built['wgmma_serialized']}")
    hmma = sass_opcode_counts("flash_attention_mma_kernel", "HMMA")
    hgmma = sass_opcode_counts("stress_mxu_bf16_kernel", "HGMMA")
    emit(phase="sass", hmma_in_flash_attention_mma_kernel=hmma,
         hgmma_in_stress_mxu_bf16_kernel=hgmma)
    if not hmma or not all(hmma.values()):
        raise AssertionError(f"the bf16 attention body has no HMMA in its SASS: {hmma}")
    if not hgmma or not all(hgmma.values()):
        raise AssertionError(f"the bf16 stress_mxu body has no HGMMA in its SASS: {hgmma}")

    t0 = time.perf_counter()
    records = phase_kernels()
    floor_us = launch_floor_ms() * 1e3
    emit(phase="launch_floor", floor_us=floor_us,
         how="rt_empty (one block of one thread) through time_ms: 20 a CUDA graph")
    emit(phase="kernels", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_stressors(records)
    t_stress = time.perf_counter() - t0
    emit(phase="stressors", seconds=t_stress)

    t0 = time.perf_counter()
    phase_serve_small()
    emit(phase="serve_small_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    params, qwen3_profiles = phase_serve_full(records)
    emit(phase="serve_full_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    dev1 = phase_dryrun(records, qwen3_profiles)
    emit(phase="dryrun_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_sharded_forward(records)
    emit(phase="sharded_forward_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_residency()
    emit(phase="residency_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    scenarios = phase_interference(records)
    emit(phase="interference_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_solver(params, scenarios, records)
    emit(phase="solver_done", seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_fleet(records)
    emit(phase="fleet_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_examples(records)
    emit(phase="examples_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_falcon_mamba(records)
    emit(phase="falcon_mamba_done", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_zamba2(records)
    emit(phase="zamba2_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_gemma3(records)
    emit(phase="gemma3_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_gemma_2b(records)
    emit(phase="gemma_2b_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_gemma3_4b(records)
    emit(phase="gemma3_4b_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_moonshot(records)
    emit(phase="moonshot_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_llama_vision(records)
    emit(phase="llama_vision_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_hubert(records)
    emit(phase="hubert_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    pods.append(start_pod_counts())   # host work beside the train phase
    t0 = time.perf_counter()
    phase_train(records)
    emit(phase="train_done", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_dryrun_mesh(records, dev1, pods[0])
    emit(phase="dryrun_mesh_done", seconds=time.perf_counter() - t0)

    emit(phase="total", seconds=time.perf_counter() - t_all)
    for rec in records.values():
        # rule 2's ranking: what a kernel's launches lose to the larger of
        # its bound and the launch floor
        rec["floor_us"] = floor_us
        rec["launches_x_gap_ms"] = rec["launches"] * max(
            0.0, rec["ms"] - max(rec["bound_ms"], floor_us / 1e3))
        for key in ("llama31_8b", "gemma_2b", "gemma3_4b"):
            if key in rec:          # a path's run, each timed shape by its launches
                rec[f"launches_x_gap_ms_{key}"] = sum(
                    t["launches"] * max(0.0, t["ms"] - max(t["bound_ms"], floor_us / 1e3))
                    for t in rec[key])
    emit(kernels=list(records.values()))
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--pod-counts"]:     # the child started by start_pod_counts
        sys.exit(pod_counts())
    try:
        code = main()
    except Exception as exc:          # the boundary: report, then fail
        import traceback
        traceback.print_exc()
        emit(ok=False, error=f"{type(exc).__name__}: {exc}"[:2000])
        code = 1
    sys.exit(code)
