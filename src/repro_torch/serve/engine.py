"""Continuous-batching serving engine with interference-aware scheduling.

The paper's findings drive the scheduler:
  * takeaway §4.2 (HOL blocking): a monolithic prefill blocks the decode
    batch for its whole duration — the engine CHUNKS prefills and
    interleaves chunks between decode steps at per-kernel granularity;
  * §5.1 (estimator-driven decisions): each step the engine predicts the
    decode batch's TBT inflation from colocating one more prefill chunk
    (analytic resource profiles through repro_torch.core.estimator) and
    sizes the chunk to keep predicted TBT within the SLO.

Supported families: dense and moe decoders with global attention, as in the
reference. The two steps (decode, extend) update the KV cache in place and
run, on a CUDA device, on the RMSNorm, flash-decode and flash-attention
kernels. The extend step routes only the chunk's real rows through the
MoE, with the capacity of the chunk's length (``moe.moe_ffn_local``); the
decode step routes every slot of its static batch, idle ones too, with the
capacity of ``max_slots`` tokens, as the reference's does. Under a capacity
that drops tokens, idle rows then take capacity that live rows would have
had, so a live row's output can depend on the others. Under one that drops
nothing (``capacity_factor`` >= n_experts / top_k: every expert may keep all
``max_slots`` rows) no row is dropped, and each live row's output is its own
whatever the other rows, idle ones included, hold. As the reference
jits them, the port captures them (``repro_torch.graphs``): on a CUDA
device the decode step and one extend step for each chunk bucket are CUDA
graphs over static buffers, captured when the engine is built and replayed
on every step; on the CPU the same bodies run directly.

Under a ``ParallelContext`` with a mesh (the reference's ``ctx``) the
parameters are DTensors placed by the ``tp_serve`` recipe (those that are
not placed already) and the cache by ``cache_specs``; every rank runs the
same host schedule on the same host inputs. The static buffers stay plain
tensors: inside a body the ids become DTensors through
``DTensor.from_local`` (no device work), and the logits are made whole
there, so a step's output is a plain tensor that greedy sampling reads
whole. The steps are captured as the unsharded ones are.

Greedy decoding runs one step ahead of the host (``Engine.step``): the
argmax of a step stays on the device and is the next decode's input, so a
step enqueues its extend and decode before it waits for the previous
step's ids, and the host's own work lies under the replay in flight. The
chunk's price is solved on a CUDA stream of the engine's own, beside that
replay.
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (H100, DeviceModel, KernelProfile, Scenario,
                              get_solver_backend, get_solver_device, solve_scenarios,
                              warmup_solver)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.kernels import _mesh
from repro_torch.models import build_model, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import _shard, _sharded, unshard_data
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.models.model import mesh_scope
from repro_torch.models.moe import LOCAL_CTX, ParallelContext
from repro_torch.parallel import sharding as shd
from repro_torch.serve import spans
from repro_torch.serve.kvcache import Sequence, SlotAllocator
from repro_torch.tree import map_leaves


_MIN_CHUNK = 16      # smallest prefill chunk the scheduler will schedule
SERVE_RECIPE = "tp_serve"   # the recipe that places an engine's parameters and cache


def chunk_bucket(c: int) -> int:
    """The rows a prefill chunk of c tokens is padded to: the next power of
    two, at least ``_MIN_CHUNK``. One extend step serves each bucket."""
    b = _MIN_CHUNK
    while b < c:
        b <<= 1
    return b


def _ids(tokens: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    """A step's ids (B, 1) from its static buffer: as they are on one
    device; under a mesh a DTensor over the data axes (``from_local`` whole,
    then each rank's block: a slice, no device work)."""
    if not _sharded(ctx):
        return tokens
    return _shard(_mesh.replicated(tokens, ctx.mesh), ctx, ctx.data_axes, None)


# The two step bodies take what they use, not the engine: a step that held
# the engine would make a cycle, and a dropped engine would keep its cache
# and graphs on the card until the garbage collector ran.
@torch.no_grad()
def decode_body(model, params, cache, inp: torch.Tensor,
                ctx: ParallelContext = LOCAL_CTX) -> torch.Tensor:
    """inp (2B,): the slots' tokens, then their positions -> logits
    (B,1,V) f32, a plain tensor. One token for every slot; the cache is
    updated in place."""
    B = inp.shape[0] // 2
    logits, _ = model.decode_step(params, _ids(inp[:B, None], ctx), cache, inp[B:], ctx)
    return _mesh.whole(logits)


@torch.no_grad()
def extend_body(cfg: ModelConfig, params, cache, bucket: int,
                inp: torch.Tensor, ctx: ParallelContext = LOCAL_CTX) -> torch.Tensor:
    """inp: ``[slot, pos0, c]`` and the chunk's tokens, padded to
    ``bucket`` -> logits of the chunk's last real position (1,1,V) f32, a
    plain tensor. The chunk's keys and values go into the slot's rows of
    the cache in place, the padding's to the trash position."""
    offsets = inp[:3]
    with mesh_scope(ctx):
        x = embed(unshard_data(params["embed"], ctx), inp[3:3 + bucket][None],
                  scale_by_dim=cfg.embed_scale)
        x = tfm.uniform_stack_extend(params["stack"], cfg, x, cache["k"], cache["v"], offsets,
                                     ctx)
        x = _mesh.whole(x)                  # the chunk's rows, whole on every rank
        x = rmsnorm(params["final_ln"], x.index_select(1, offsets[2:] - 1), cfg.norm_eps)
        return _mesh.whole(unembed(unshard_data(params["embed"], ctx), x))


def _listed(ids) -> List[int]:
    """Sampled ids as host integers (``Engine._sample`` leaves greedy ones
    on the device)."""
    return ids.tolist() if isinstance(ids, torch.Tensor) else ids


def _keep_loads(loads: dict, key, body):
    """``body`` that leaves its moe layers' routed and kept rows per expert
    in ``loads[key]`` (``moe.loads_kept``): on the card, the captured
    graph's buffers, which every replay rewrites."""
    def run():
        with moe.loads_kept() as kept:
            out = body()
        loads[key] = kept
        return out
    return run


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    prefill_chunk: int = 128          # max chunk; scheduler may shrink it
    tbt_slo_ms: float = 50.0
    mode: str = "interference_aware"  # | "serial" | "fixed_chunk"
    temperature: float = 0.0
    seed: int = 0


@dataclass(init=False)
class StepEvent:
    kind: str                  # "decode" | "prefill_chunk" | "admit" |
                               # "finish" | "degraded" | "recovered", or
                               # a span's, ``spans.SPAN`` + its name
    t: float                   # the end; an instant's only time
    detail: dict
    start: float               # a span's start; an instant's is t

    def __init__(self, kind: str, t: float, detail: Optional[dict] = None,
                 start: Optional[float] = None):
        self.kind, self.t = kind, t
        self.detail = {} if detail is None else detail
        self.start = t if start is None else start


@dataclass
class _Flight:
    """A step's ids on their way to the host: the copy of the slots' next
    input ids (``host``; ``sent`` has passed once it is there, None on the
    CPU), and whose tokens they are."""
    host: torch.Tensor
    sent: Optional[object]
    first: List[tuple]          # (sequence, slot): its first token, from the extend
    decoded: List[tuple]        # (sequence, slot): its next token, from the decode
    last: List[Sequence]        # those of ``decoded`` whose last token it is


class Engine:
    def __init__(self, cfg: ModelConfig, params=None, ecfg: EngineConfig = None,
                 dev: DeviceModel = H100, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 ctx: ParallelContext = LOCAL_CTX):
        """``dev`` is the analytic device model the chunk scheduler prices
        against; ``device`` is where the tensors live. Without ``params``
        the weights are drawn from ``generator`` (default: a generator on
        ``device`` seeded with ``ecfg.seed``). Under ``ctx`` with a mesh
        the plain leaves of the parameters are placed by ``tp_serve``
        (``distribute``: every rank must hold the same values) and the
        cache by ``cache_specs``."""
        if cfg.family not in ("dense", "moe") or cfg.attn.pattern != "global":
            raise NotImplementedError(
                "engine supports dense and moe decoders with global attention")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.ctx = ctx
        self.dev = dev
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(self.ecfg.seed)
            params = self.model.init(generator)
        self.alloc = SlotAllocator(self.ecfg.max_slots, self.ecfg.max_len)
        # +1 trash position: idle slots in the static decode batch write
        # their (ignored) k/v there instead of corrupting position 0
        cache = self.model.init_cache(self.ecfg.max_slots, self.ecfg.max_len + 1)
        if _sharded(ctx):
            mesh = ctx.mesh
            specs = shd.param_specs(cfg, SERVE_RECIPE, mesh, params)
            params = map_leaves(lambda t, spec: t if _mesh.is_dtensor(t)
                                else shd.distribute(t, mesh, spec), params, specs)
            cache = shd.distribute(cache, mesh, shd.cache_specs(cfg, SERVE_RECIPE, mesh, cache))
        self.params, self.cache = params, cache
        self.waiting: List[Sequence] = []
        self.events: List[StepEvent] = []
        self.metrics: Dict[int, dict] = {}
        self._next_id = 0
        self.degraded = False
        self._rec: Optional[spans.Recorder] = None     # the trace, while it is on
        self._last_rec: Optional[spans.Recorder] = None
        self._pool: Optional[spans.EventPool] = None
        self._flight: Optional[_Flight] = None          # the last step's ids, unread
        self._solve_streams: Dict[int, object] = {}     # device index -> the solve's stream
        self._build_steps()
        # the chunk pricing's solve (one scenario per candidate, 2 members)
        # is captured ahead of time where the solver runs on the card
        warmup_solver(self.dev, ks=(2,), buckets=(8,))

    def set_degraded(self, flag: bool, reason: str = "") -> None:
        """Fleet hook: the engine's device is oversubscribed (straggling,
        or absorbing migrated work after a fleet failure).  In degraded
        mode the chunk scheduler stops spending headroom on large prefill
        chunks and always takes the minimum-predicted-TBT candidate —
        prefills slow down, decode TBT is protected."""
        if flag != self.degraded:
            self.degraded = flag
            self.events.append(StepEvent(
                "degraded" if flag else "recovered",
                time.perf_counter(), {"reason": reason}))

    # -------------------------- the two steps --------------------- #
    def _build_steps(self) -> None:
        """The twins of the reference's ``_build_steps``: the decode step,
        and the extend step once for every chunk bucket from ``_MIN_CHUNK``
        up to the cache's length, over two static inputs. On a CUDA device
        each is captured here, before any request is admitted; the warm-up
        before each capture writes only the trash position."""
        B, n = self.ecfg.max_slots, self.ecfg.max_len
        # a moe step keeps its dispatches' loads (``moe.loads_kept``): the
        # trace's counters read them after a replay
        self._loads: Dict[object, list] = {}
        keep = (functools.partial(_keep_loads, self._loads) if self.cfg.family == "moe"
                else lambda key, body: body)
        self._decode_in = graphs.StaticInput(2 * B, torch.int64, self.device)
        self._decode_in.write(np.r_[np.zeros(B, np.int64), np.full(B, n, np.int64)])
        # a greedy step leaves each slot's next input id on the device
        # (``_next``); two host copies of them take turns on their way back
        self._fed_ids, self._fed_pos = self._decode_in.tensor[:B], self._decode_in.tensor[B:]
        self._next = torch.zeros(B, dtype=torch.int64, device=self.device)
        card = self.device.type == "cuda"
        self._ids_host = [torch.zeros(B, dtype=torch.int64, pin_memory=card) for _ in range(2)]
        self._ids_sent = [torch.cuda.Event() if card else None for _ in range(2)]
        self._sends = 0
        self.steps = {"decode": graphs.capture(keep("decode", functools.partial(
            decode_body, self.model, self.params, self.cache, self._decode_in.tensor,
            self.ctx)), self.device, "decode")}
        buckets = [chunk_bucket(n)]
        while buckets[0] > _MIN_CHUNK:
            buckets.insert(0, buckets[0] // 2)
        self._extend_in = graphs.StaticInput(3 + buckets[-1], torch.int64, self.device)
        self._extend_in.write([0, n, 1])             # one token at the trash position
        for b in buckets:
            self.steps[b] = graphs.capture(keep(b, functools.partial(
                extend_body, self.cfg, self.params, self.cache, b, self._extend_in.tensor,
                self.ctx)), self.device, f"extend_{b}")

    # ------------------------------------------------------------ tracing
    def trace(self, on: bool) -> None:
        """Switch the step's spans on or off (``repro_torch.serve.spans``).
        While off, ``step`` records only its instant events. Switching on
        waits for the card and anchors the device's clock to the host's;
        the engine's first trace makes its pool of timing events. While on,
        each step makes the trace ``graphs.TAP``, so that every captured
        step it replays, the solver's too, records device events on the
        stream current when the trace started (the one the steps run on)
        into the innermost open span."""
        if on == (self._rec is not None):
            return
        if not on:
            if graphs.TAP is self._rec:
                graphs.TAP = None
            self._rec.stop()
            self._rec, self._last_rec = None, self._rec
            return
        pool, sync, stream = None, lambda: None, None
        if self.device.type == "cuda":
            if self._last_rec is not None:
                self._last_rec.resolve()        # its events go back to the pool
            if self._pool is None:
                self._pool = spans.EventPool(lambda: torch.cuda.Event(enable_timing=True))
            pool, sync, stream = self._pool, torch.cuda.synchronize, torch.cuda.current_stream()
        self._rec = spans.Recorder(self.events, pool, sync, stream=stream)

    def spans(self) -> List[dict]:
        """Every span in ``events`` (``spans.export``), the device intervals
        of the last two traces read first: this waits for the card, so call
        it outside any timed part."""
        for rec in (self._last_rec, self._rec):
            if rec is not None:
                rec.resolve()
        return spans.export(self.events)

    def _decode(self, tokens, pos) -> torch.Tensor:
        """tokens (B,) or (B,1) and positions (B,), host integers -> logits
        (B,1,V) f32 on the device: the decode step's output buffer, which
        the next step overwrites (``step`` samples from it first). With
        ``tokens`` None only the positions are written, and a live slot is
        fed the id the device holds for it (``_next``: its last greedy
        argmax, or the first token an extend put there), an idle one (at
        the trash position) 0, as the host would feed it."""
        pos = np.asarray(pos, np.int64).reshape(-1)
        if tokens is None:
            self._decode_in.write(pos, at=self.ecfg.max_slots)
            self._fed_ids.copy_(torch.where(self._fed_pos < self.ecfg.max_len, self._next, 0))
        else:
            self._decode_in.write(np.r_[np.asarray(tokens, np.int64).reshape(-1), pos])
        return self.steps["decode"]()

    def _extend(self, tokens, slot: int, pos0: int) -> torch.Tensor:
        """One prefill chunk of c tokens (host integers) of one slot, from
        position pos0, run by the step of its bucket -> logits of its last
        position (1,1,V) f32 on the device, in the step's output buffer."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        c = tokens.size
        if c < 1 or pos0 < 0 or pos0 + c > self.ecfg.max_len:
            raise ValueError(f"extend: {c} tokens at {pos0} do not fit "
                             f"max_len {self.ecfg.max_len}")
        b = chunk_bucket(c)
        inp = np.zeros(3 + b, np.int64)
        inp[:3] = slot, pos0, c
        inp[3:3 + c] = tokens
        self._extend_in.write(inp)
        return self.steps[b]()

    # ------------------------------------------------------------- #
    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        seq = Sequence(self._next_id, len(prompt), max_new,
                       tokens=list(prompt), arrival=time.perf_counter())
        self._next_id += 1
        self.waiting.append(seq)
        return seq.seq_id

    # --------------------- interference model --------------------- #
    def _phase_profile(self, name: str, n_tokens: float) -> KernelProfile:
        """Analytic per-call resource vector for one engine phase: weight
        reads dominate decode; matmul FLOPs dominate prefill chunks. Priced
        from the active parameters, as the reference prices it, though a
        moe step's batched expert products read every expert's weights."""
        n_active = self.cfg.n_active_params()
        flops = 2.0 * n_active * n_tokens
        bytes_ = 2.0 * n_active + 2e5 * n_tokens   # weights + kv traffic
        demand = {r: 0.0 for r in RESOURCE_AXES}
        demand.update(mxu=flops, vpu=flops / 50, issue=flops / 256,
                      hbm=bytes_, l2=bytes_)
        return KernelProfile(name, demand=demand)

    def _pick_chunk(self, seq: Sequence, n_active_decodes: int) -> int:
        """Largest chunk whose colocation keeps predicted decode TBT within
        the SLO (paper §5.1 estimator-in-the-loop). Every halving candidate
        down to and INCLUDING the floor chunk is one `Scenario` (victim =
        the decode batch, background = the chunk), priced in a single
        batched solve: predicted TBT = the decode step inflated by the
        chunk's interference, plus the chunk itself serialized on the core
        it is interleaved with.  When no candidate passes, the fallback is
        estimator-backed too: the priced candidate with the lowest
        predicted TBT.

        Degraded mode (``set_degraded``, driven by the fleet layer when
        this device is oversubscribed): skip the largest-passing search
        and always take the minimum-predicted-TBT candidate — the
        interference budget belongs to the migrated/SLO work, not to
        prefill throughput."""
        remaining = seq.prompt_len - seq.pos
        if self.ecfg.mode == "serial":
            return remaining
        if self.ecfg.mode == "fixed_chunk":
            return min(self.ecfg.prefill_chunk, remaining)
        if n_active_decodes == 0:
            boost = 1 if self.degraded else 4
            return min(self.ecfg.prefill_chunk * boost, remaining)
        chunk = min(self.ecfg.prefill_chunk, remaining)
        cands = []
        while chunk > _MIN_CHUNK:
            cands.append(chunk)
            chunk //= 2
        cands.append(max(chunk, _MIN_CHUNK))   # the floor chunk is priced too
        decode = self._phase_profile("decode", max(n_active_decodes, 1))
        chunks = [self._phase_profile(f"prefill{c}", c) for c in cands]
        rec = self._rec
        if rec:
            rec.open("solve")
        with self._beside():
            br = solve_scenarios([Scenario((decode,), (ch,)) for ch in chunks],
                                 self.dev)
        if rec:
            rec.close()
        tbt_iso = decode.isolated_time(self.dev)
        t_chunk = np.asarray([ch.isolated_time(self.dev) for ch in chunks])
        tbt_pred = tbt_iso * br.slowdowns[:, 0] + t_chunk
        if self.degraded:
            return cands[int(np.argmin(tbt_pred))]
        ok = tbt_pred <= max(self.ecfg.tbt_slo_ms / 1e3, tbt_iso * 1.5)
        passing = np.flatnonzero(ok)
        if passing.size:
            return cands[passing[0]]
        # nothing keeps TBT within SLO: degrade to the estimator-backed
        # minimum — the priced candidate with the lowest predicted TBT
        # (the old fallback returned an unpriced cands[-1] // 2)
        return cands[int(np.argmin(tbt_pred))]

    @contextlib.contextmanager
    def _beside(self):
        """Where the solver runs on a CUDA device: on a stream of the
        engine's own (its graphs in a pool of their own, ``graphs.SOLVER``),
        so that the host waits for the solve alone while the steps' stream
        holds a replay in flight; the trace's events follow the solve there.
        Elsewhere, as it is."""
        dev = get_solver_device()
        if get_solver_backend() != "torch" or dev.type != "cuda":
            yield
            return
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        stream = self._solve_streams.get(idx)
        if stream is None:
            stream = self._solve_streams[idx] = torch.cuda.Stream(idx, priority=-1)
        rec = self._rec
        was = rec.stream if rec else None
        with torch.cuda.stream(stream):
            if rec:
                rec.stream = stream
            try:
                yield
            finally:
                if rec:
                    rec.stream = was

    # ----------------------------- loop --------------------------- #
    def _runs_ahead(self) -> bool:
        """Whether ``step`` runs one step ahead of the host: in greedy
        decoding, whose next inputs are argmaxes the device already holds.
        With a temperature the logits go to the host, and each step waits
        for its own ids."""
        return self.ecfg.temperature <= 0

    def step(self) -> bool:
        """One scheduler iteration. Returns False when idle, with no ids in
        flight.

        Greedy decoding (``_runs_ahead``) runs one step ahead: a step
        admits, prices and enqueues its extend and decode, whose argmaxes
        stay on the device as the next decode's inputs, and only then waits
        for the previous step's ids and appends them to their sequences; a
        step after which no sequence is left, active or waiting, reads its
        own too. The schedule is the in-order one's: positions advance, and
        a sequence's slot is freed, in the step that enqueues its last
        decode; its ``done`` is set, with its last token, in the step that
        reads it. With a temperature each step waits for its own ids.

        While tracing is on (``trace``), each phase is also a span: ``step``
        (counter ``left``, the requests still in the engine), ``admit``
        (``n``), ``pick_chunk`` (``beside``: 1 where the price ran with a
        step's ids in flight) with ``solve``, ``extend`` (``c`` tokens in
        ``rows``), ``first_token``, ``decode`` (``rows`` active of
        ``slots``; ``ahead``: 1 where it was enqueued with the previous
        step's ids unread), ``sample`` (the ids' copy to the host and the
        wait for them) and ``bookkeep``. A moe engine's ``extend`` and
        ``decode`` also carry ``moe_assigned``, ``moe_dropped`` and
        ``moe_max_load`` (``_moe_counters``), read from the card when the
        trace resolves."""
        now = time.perf_counter
        rec = self._rec
        ahead = self._runs_ahead()
        if rec:
            graphs.TAP = rec
            rec.root("step")
            rec.open("admit")
        # 1) admit waiting sequences into free slots
        while self.waiting and self.alloc.can_admit(self.waiting[0]):
            seq = self.waiting.pop(0)
            self.alloc.admit(seq)
            self.events.append(StepEvent("admit", now(),
                                         {"seq": seq.seq_id, "slot": seq.slot}))
        if rec:
            rec.close(n=rec.since())
        active = list(self.alloc.active.values())
        prefilling = [s for s in active if s.pos < s.prompt_len]
        decoding = [s for s in active if s.pos >= s.prompt_len and not s.done]
        if not (active and ahead):
            self._land()
        if not active:
            if rec:
                rec.close(left=len(self.waiting))
            return False
        first, decoded, last = [], [], []

        # 2) one prefill chunk for the oldest prefilling sequence
        if prefilling:
            seq = prefilling[0]
            if rec:
                rec.open("pick_chunk", seq=seq.seq_id, beside=int(self._flight is not None))
            chunk = self._pick_chunk(seq, len(decoding))
            tok = seq.tokens[seq.pos:seq.pos + chunk]
            if rec:
                rec.close()
                rec.open("extend", seq=seq.seq_id, c=len(tok), rows=chunk_bucket(len(tok)))
            logits = self._extend(tok, seq.slot, seq.pos)
            if rec:
                self._moe_counters(rec, chunk_bucket(len(tok)))
                rec.close()
            last_chunk = seq.pos + len(tok) >= seq.prompt_len
            # the first generated token, after the prompt's last chunk: in
            # order the host waits for it; ahead it goes into the slot's
            # next input id on the device (the slot is idle in this step's decode)
            nxt = None
            if last_chunk:
                if rec:
                    rec.open("first_token", seq=seq.seq_id)
                    rec.before()
                ids = self._sample(logits[:, -1])
                if ahead:
                    self._next.index_copy_(0, self._extend_in.tensor[:1], ids)
                    first.append((seq, seq.slot))
                else:
                    nxt = _listed(ids)[0]
                if rec:
                    rec.after()
                    rec.close()
            self.events.append(StepEvent(
                "prefill_chunk", now(),
                {"seq": seq.seq_id, "chunk": len(tok),
                 "colocated_decodes": len(decoding)}))
            seq.pos += len(tok)
            if last_chunk:
                if not ahead:
                    seq.tokens.append(nxt)
                    seq.first_token_time = now()
                seq.pos += 1

        # 3) one decode step for the whole decode batch
        if decoding:
            B = self.ecfg.max_slots
            if rec:
                rec.open("decode", rows=len(decoding), slots=B,
                         ahead=int(self._flight is not None))
            tokens = None if ahead else np.zeros((B, 1), np.int64)
            pos = np.full((B,), self.ecfg.max_len, np.int64)   # trash slot
            for s in decoding:
                if not ahead:
                    tokens[s.slot, 0] = s.tokens[-1]
                pos[s.slot] = s.pos - 1   # position of the token being fed
            logits = self._decode(tokens, pos)
            if ahead:
                # a live row's argmax is its next input; an idle row's slot
                # (fed the trash position) keeps its id, which an extend may
                # have written in this step
                ids = self._sample(logits[:, 0])
                self._next.copy_(torch.where(self._fed_pos < self.ecfg.max_len, ids, self._next))
            if rec:
                rec.after()
                self._moe_counters(rec, "decode")
                rec.close()
            if not ahead:
                if rec:
                    rec.open("sample")
                    rec.before()
                # the sampled ids reach the host before the event is
                # stamped, so the gap between decode events measures the
                # device's work and not the enqueueing of its launches
                sampled = _listed(self._sample(logits[:, 0]))
                if rec:
                    rec.after()
                    rec.close()
            self.events.append(StepEvent("decode", now(), {"batch": len(decoding)}))
            if rec and not ahead:
                rec.open("bookkeep")
            for s in decoding:
                if ahead:
                    decoded.append((s, s.slot))
                else:
                    s.tokens.append(sampled[s.slot])
                s.pos += 1
                if s.pos - s.prompt_len >= s.max_new:
                    if ahead:
                        last.append(s)          # done when its last token lands
                    else:
                        s.done = True
                        self._finish(s)
                    self._release(s)
            if rec and not ahead:
                rec.close()

        # 4) ahead: this step's ids start for the host, the last step's are
        # read; where nothing follows, this step's too
        if ahead:
            if rec:
                rec.open("sample")
                rec.before()
            landing = [self._flight]
            self._flight = self._send(first, decoded, last)
            if rec:
                rec.after()
            if not (self.alloc.active or self.waiting):
                landing.append(self._flight)
                self._flight = None
            landing = [(f, self._wait(f)) for f in landing if f is not None]
            if rec:
                rec.close()
                rec.open("bookkeep")
            for f, ids in landing:
                self._publish(f, ids)
            if rec:
                rec.close()
        if rec:
            rec.close(left=len(self.alloc.active) + len(self.waiting))
        return True

    def _send(self, first, decoded, last) -> Optional[_Flight]:
        """Start the copy of the slots' next input ids, where this step's
        tokens now are, to the host (None if the step made no token)."""
        if not (first or decoded):
            return None
        turn = self._sends % 2
        self._sends += 1
        host, sent = self._ids_host[turn], self._ids_sent[turn]
        host.copy_(self._next, non_blocking=sent is not None)
        if sent is not None:
            sent.record()
        return _Flight(host, sent, first, decoded, last)

    @staticmethod
    def _wait(flight: _Flight) -> List[int]:
        if flight.sent is not None:
            flight.sent.synchronize()
        return flight.host.tolist()

    def _publish(self, flight: _Flight, ids: List[int]) -> None:
        """A landed step's tokens into their sequences; those that made
        their last token are done."""
        t = time.perf_counter()
        for seq, slot in flight.first:
            seq.tokens.append(ids[slot])
            seq.first_token_time = t
        for seq, slot in flight.decoded:
            seq.tokens.append(ids[slot])
        for seq in flight.last:
            seq.done = True
            self._finish(seq)

    def _land(self) -> None:
        """Read the last step's ids, if any are in flight."""
        flight, self._flight = self._flight, None
        if flight is not None:
            self._publish(flight, self._wait(flight))

    def _moe_counters(self, rec, key) -> None:
        """The moe counters of the step ``key`` just run, on the open span,
        summed over its layers' dispatches (``moe.loads_kept``):
        ``moe_assigned``, the (row, expert) pairs routed, of the chunk's
        tokens in an extend and of every slot in a decode step, idle ones
        included, since they take capacity; ``moe_dropped``, those past an
        expert's capacity; ``moe_max_load``, the most rows an expert was
        routed in a layer. The loads are copied on the device before the
        next replay rewrites them, and read when the trace resolves."""
        loads = self._loads.get(key)
        if not loads:
            return
        held = torch.stack([torch.stack(pair) for pair in loads])     # (L, 2, E)

        def counters():
            routed, kept = held.cpu().unbind(1)
            assigned = int(routed.sum())
            return {"moe_assigned": assigned, "moe_dropped": assigned - int(kept.sum()),
                    "moe_max_load": int(routed.max())}
        rec.later(counters)

    def _sample(self, logits: torch.Tensor):
        """logits (n, V) f32 on the device -> n token ids. Greedy sampling
        takes the argmax on the device and leaves the ids there, an (n,)
        int64 tensor, with nothing waiting for the card (``_listed`` moves
        them; the same function as an argmax on the host over n x V
        floats). With a temperature the logits go to the host and every row
        is drawn from a fresh ``default_rng(seed)``, as the reference
        engine does (so every draw uses the same variate): a list of host
        integers."""
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        out = []
        for row in logits.cpu().numpy():
            p = np.exp((row - row.max()) / self.ecfg.temperature)
            p /= p.sum()
            out.append(int(np.random.default_rng(self.ecfg.seed)
                           .choice(len(p), p=p)))
        return out

    def _finish(self, seq: Sequence):
        """The metrics of a sequence whose last token is in."""
        self.metrics[seq.seq_id] = {
            "prompt_len": seq.prompt_len,
            "new_tokens": len(seq.tokens) - seq.prompt_len,
            "ttft_s": (seq.first_token_time or 0) - seq.arrival,
            "output": seq.tokens[seq.prompt_len:],
        }

    def _release(self, seq: Sequence):
        """The slot of a sequence whose last decode is enqueued goes back
        to the allocator: its ``finish`` event."""
        self.alloc.release(seq.seq_id)
        self.events.append(StepEvent("finish", time.perf_counter(),
                                     {"seq": seq.seq_id}))

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, dict]:
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                break
        return self.metrics
