"""Steps captured into CUDA graphs: the port's counterpart of ``jax.jit``.

The reference compiles each step of its serving path into one program: the
engine's decode and extend steps (``src/repro/serve/engine.py:117-118``) and
the batched solver (``src/repro/core/estimator_jax.py:215``). Here a step is
a body over static buffers. On a CUDA device ``capture`` runs it once on a
side stream (the warm-up: kernels built, library code loaded, scratch
allocated), captures it into a ``torch.cuda.CUDAGraph`` in a memory pool
that the device's live graphs of its group share, and every call replays
the graph: the host enqueues one graph where it enqueued a launch for
every kernel. On the CPU the same body runs directly on every call, so the
CPU tests run what the card replays. A capture that fails raises; nothing falls back to
running the body eagerly on the card.

A step writes its outputs into the same buffers on every replay, and graphs
that share a pool may reuse each other's scratch memory: read a step's
outputs (on the host, or by work enqueued after it on its stream) before
the next call of any step of its pool. Graphs that may replay at the same
time on two streams belong to two pools: the serving steps to ``STEPS``,
the solver's to ``SOLVER`` (the engine prices a chunk beside a decode
replay in flight).

The kernels' wrappers count their launches when they are called: for a
captured step, at the warm-up and at the capture, never at a replay. A
``Step`` keeps the launches of one call (``launches``, counted at the
capture) and its number of calls, so a step's kernel launches on the card
are ``launches`` x ``calls``.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict

import numpy as np
import torch

WARMUPS = 1          # runs of a body on a side stream before its capture
STEPS, SOLVER = "steps", "solver"     # the groups of graphs that share a pool

# (CUDA device index, group) -> (the graph pool its graphs share, those graphs)
_pools: Dict[tuple, tuple] = {}


def _shared_pool(idx: int, group: str = STEPS) -> tuple:
    """The pool that new graphs of ``group`` on device ``idx`` share, and
    the set of the graphs in it. PyTorch releases a pool with the last
    graph captured into it, and a released pool takes no further capture
    (the caching allocator asserts), so once every graph of the pool has
    been dropped (an engine freed before the next is built) a new pool
    takes its place;
    the old one's memory goes back to the card at the allocator's next
    release of cached blocks."""
    pool, graphs = _pools.get((idx, group), (None, None))
    if not graphs:
        pool, graphs = torch.cuda.graph_pool_handle(), weakref.WeakSet()
        _pools[idx, group] = (pool, graphs)
    return pool, graphs


def launch_counts() -> Dict[str, int]:
    """The launch counters of the kernels' wrappers, by wrapper name."""
    from repro_torch.kernels import cache_share, decode_attention, flash_attention
    from repro_torch.kernels import moe_experts, rmsnorm, rope_write, ssm_scan, stressors
    wrappers = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "flash_decode": decode_attention, "rope_write": rope_write,
                "moe_experts": moe_experts,
                "cache_share": cache_share, "ssm_scan": ssm_scan, "stress_mxu": stressors,
                "stress_vpu": stressors, "stress_hbm": stressors, "stress_vmem": stressors}
    return {name: getattr(getattr(mod, name), "launches", 0)
            for name, mod in wrappers.items()}


TAP = None
"""Told ``before()`` and ``after()`` every captured step's replay is
enqueued, where set: the trace of the engine that is stepping
(``repro_torch.serve.spans.Recorder``, set by ``Engine.step``)."""


class Step:
    """A step body over static buffers, run by calling the step: a graph
    replay when it was captured, the body itself when not. ``launches``:
    the kernels one call launches, by wrapper, as the capture counted them;
    ``capture_launches``: what the warm-up and the capture launched;
    ``capture_s``: the seconds both took. Where ``TAP`` is set, it is told
    ``before()`` and ``after()`` each replay is enqueued."""

    def __init__(self, body: Callable, name: str):
        self.body = body
        self.name = name
        self.graph = None
        self.out = None
        self.calls = 0
        self.launches: Dict[str, int] = {}
        self.capture_launches: Dict[str, int] = {}
        self.capture_s = 0.0

    def __call__(self):
        self.calls += 1
        if self.graph is None:
            return self.body()
        tap = TAP
        if tap is None:
            self.graph.replay()
        else:
            tap.before()
            self.graph.replay()
            tap.after()
        return self.out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def capture(body: Callable, device, name: str, group: str = STEPS) -> Step:
    """``body`` as a step on ``device``: captured into a CUDA graph in the
    pool of ``group`` on a CUDA device (after ``WARMUPS`` runs on a side
    stream), run directly on the CPU. The body must read its inputs from
    static buffers and do no host synchronisation; whatever it returns is
    the step's output."""
    device = torch.device(device)
    step = Step(body, name)
    if device.type == "cpu":
        return step
    if device.type != "cuda":
        raise ValueError(f"capture: unsupported device {device}")
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        before = launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUPS):
                body()
        torch.cuda.current_stream().wait_stream(side)
        warm = launch_counts()
        pool, pooled = _shared_pool(torch.cuda.current_device(), group)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = body()
        pooled.add(graph)
        after = launch_counts()
    step.graph, step.out = graph, out
    step.launches = _delta(after, warm)
    step.capture_launches = _delta(after, before)
    step.capture_s = time.perf_counter() - t0
    return step


class StaticInput:
    """A device buffer that a step reads, written from the host before each
    call. On the card the values go through one of two pinned staging
    tensors, in turn, and an asynchronous copy; a staging tensor is
    rewritten only once the copy out of it two writes back has run, so a
    host that runs ahead of the card never changes what a queued copy reads
    and seldom waits. On the CPU the buffer is written directly."""

    def __init__(self, n: int, dtype: torch.dtype, device):
        device = torch.device(device)
        self.tensor = torch.zeros(n, dtype=dtype, device=device)
        self._host, self._copied, self._turn = [], [], 0
        if device.type == "cuda":
            self._host = [torch.zeros(n, dtype=dtype, pin_memory=True) for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]

    def write(self, values: np.ndarray, at: int = 0) -> None:
        """Elements ``at`` to ``at + values.size`` of the buffer become ``values``."""
        values = np.asarray(values).reshape(-1)
        end = at + values.size
        if not self._host:
            self.tensor[at:end].copy_(torch.from_numpy(values))
            return
        host, copied = self._host[self._turn], self._copied[self._turn]
        self._turn ^= 1
        copied.synchronize()
        host[at:end].numpy()[...] = values
        self.tensor[at:end].copy_(host[at:end], non_blocking=True)
        copied.record()
