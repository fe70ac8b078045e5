"""Steps captured into CUDA graphs: the port's counterpart of ``jax.jit``.

The reference compiles each step of its serving path into one program: the
engine's decode and extend steps (``src/repro/serve/engine.py:117-118``) and
the batched solver (``src/repro/core/estimator_jax.py:215``). Here a step is
a body over static buffers. On a CUDA device ``capture`` runs it once on a
side stream (the warm-up: kernels built, library code loaded, scratch
allocated), captures it into a ``torch.cuda.CUDAGraph`` in a memory pool
that the device's live graphs share, and every call replays the graph:
the host enqueues one graph where it enqueued a launch for every kernel. On
the CPU the same body runs directly on every call, so the CPU tests run
what the card replays. A capture that fails raises; nothing falls back to
running the body eagerly on the card.

A step writes its outputs into the same buffers on every replay, and graphs
that share the pool may reuse each other's scratch memory: read a step's
outputs before the next call of any step.

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

# CUDA device index -> (the graph pool its graphs share, those graphs)
_pools: Dict[int, tuple] = {}


def _shared_pool(idx: int) -> tuple:
    """The pool that new graphs on device ``idx`` share, and the set of
    the graphs in it. PyTorch releases a pool with the last graph captured
    into it, and a released pool takes no further capture (the caching
    allocator asserts), so once every graph of the pool has been dropped
    (an engine freed before the next is built) a new pool takes its place;
    the old one's memory goes back to the card at the allocator's next
    release of cached blocks."""
    pool, graphs = _pools.get(idx, (None, None))
    if not graphs:
        pool, graphs = torch.cuda.graph_pool_handle(), weakref.WeakSet()
        _pools[idx] = (pool, graphs)
    return pool, graphs


def launch_counts() -> Dict[str, int]:
    """The launch counters of the kernels' wrappers, by wrapper name."""
    from repro_torch.kernels import cache_share, decode_attention, flash_attention
    from repro_torch.kernels import rmsnorm, ssm_scan, stressors
    wrappers = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "flash_decode": decode_attention, "cache_share": cache_share,
                "ssm_scan": ssm_scan, "stress_mxu": stressors, "stress_vpu": stressors,
                "stress_hbm": stressors, "stress_vmem": stressors}
    return {name: getattr(getattr(mod, name), "launches", 0)
            for name, mod in wrappers.items()}


class Step:
    """A step body over static buffers, run by calling the step: a graph
    replay when it was captured, the body itself when not. ``launches``:
    the kernels one call launches, by wrapper, as the capture counted them;
    ``capture_launches``: what the warm-up and the capture launched;
    ``capture_s``: the seconds both took."""

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
        self.graph.replay()
        return self.out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def capture(body: Callable, device, name: str) -> Step:
    """``body`` as a step on ``device``: captured into a CUDA graph on a
    CUDA device (after ``WARMUPS`` runs on a side stream), run directly on
    the CPU. The body must read its inputs from static buffers and do no
    host synchronisation; whatever it returns is the step's output."""
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
        pool, pooled = _shared_pool(torch.cuda.current_device())
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
    call. On the card the values go through a pinned staging tensor and an
    asynchronous copy; the staging tensor is rewritten only once the last
    copy out of it has run, so a host that runs ahead of the card never
    changes what a queued copy reads. On the CPU the buffer is written
    directly."""

    def __init__(self, n: int, dtype: torch.dtype, device):
        device = torch.device(device)
        self.tensor = torch.zeros(n, dtype=dtype, device=device)
        self._host = self._copied = None
        if device.type == "cuda":
            self._host = torch.zeros(n, dtype=dtype, pin_memory=True)
            self._copied = torch.cuda.Event()

    def write(self, values: np.ndarray) -> None:
        """The first ``values.size`` elements of the buffer become ``values``."""
        values = np.asarray(values).reshape(-1)
        n = values.size
        if self._host is None:
            self.tensor[:n].copy_(torch.from_numpy(values))
            return
        self._copied.synchronize()
        self._host[:n].numpy()[...] = values
        self.tensor[:n].copy_(self._host[:n], non_blocking=True)
        self._copied.record()
