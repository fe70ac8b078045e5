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
capacity of ``max_slots`` tokens, as the reference's does. As the reference
jits them, the port captures them (``repro_torch.graphs``): on a CUDA
device the decode step and one extend step for each chunk bucket are CUDA
graphs over static buffers, captured when the engine is built and replayed
on every step; on the CPU the same bodies run directly.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (H100, DeviceModel, KernelProfile, Scenario,
                              solve_scenarios, warmup_solver)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.serve.kvcache import Sequence, SlotAllocator


_MIN_CHUNK = 16      # smallest prefill chunk the scheduler will schedule


def chunk_bucket(c: int) -> int:
    """The rows a prefill chunk of c tokens is padded to: the next power of
    two, at least ``_MIN_CHUNK``. One extend step serves each bucket."""
    b = _MIN_CHUNK
    while b < c:
        b <<= 1
    return b


# The two step bodies take what they use, not the engine: a step that held
# the engine would make a cycle, and a dropped engine would keep its cache
# and graphs on the card until the garbage collector ran.
@torch.no_grad()
def decode_body(model, params, cache, inp: torch.Tensor) -> torch.Tensor:
    """inp (2B,): the slots' tokens, then their positions -> logits
    (B,1,V) f32. One token for every slot; the cache is updated in place."""
    B = inp.shape[0] // 2
    logits, _ = model.decode_step(params, inp[:B, None], cache, inp[B:])
    return logits


@torch.no_grad()
def extend_body(cfg: ModelConfig, params, cache, bucket: int,
                inp: torch.Tensor) -> torch.Tensor:
    """inp: ``[slot, pos0, c]`` and the chunk's tokens, padded to
    ``bucket`` -> logits of the chunk's last real position (1,1,V) f32.
    The chunk's keys and values go into the slot's rows of the cache in
    place, the padding's to the trash position."""
    offsets = inp[:3]
    x = embed(params["embed"], inp[3:3 + bucket][None], scale_by_dim=cfg.embed_scale)
    x = tfm.uniform_stack_extend(params["stack"], cfg, x, cache["k"], cache["v"], offsets)
    x = rmsnorm(params["final_ln"], x.index_select(1, offsets[2:] - 1), cfg.norm_eps)
    return unembed(params["embed"], x)


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    prefill_chunk: int = 128          # max chunk; scheduler may shrink it
    tbt_slo_ms: float = 50.0
    mode: str = "interference_aware"  # | "serial" | "fixed_chunk"
    temperature: float = 0.0
    seed: int = 0


@dataclass
class StepEvent:
    kind: str                  # "decode" | "prefill_chunk" | "admit" |
                               # "finish" | "degraded" | "recovered"
    t: float
    detail: dict = field(default_factory=dict)


class Engine:
    def __init__(self, cfg: ModelConfig, params=None, ecfg: EngineConfig = None,
                 dev: DeviceModel = H100, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """``dev`` is the analytic device model the chunk scheduler prices
        against; ``device`` is where the tensors live. Without ``params``
        the weights are drawn from ``generator`` (default: a generator on
        ``device`` seeded with ``ecfg.seed``)."""
        if cfg.family not in ("dense", "moe") or cfg.attn.pattern != "global":
            raise NotImplementedError(
                "engine supports dense and moe decoders with global attention")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.dev = dev
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(self.ecfg.seed)
            params = self.model.init(generator)
        self.params = params
        self.alloc = SlotAllocator(self.ecfg.max_slots, self.ecfg.max_len)
        # +1 trash position: idle slots in the static decode batch write
        # their (ignored) k/v there instead of corrupting position 0
        self.cache = self.model.init_cache(self.ecfg.max_slots,
                                           self.ecfg.max_len + 1)
        self.waiting: List[Sequence] = []
        self.events: List[StepEvent] = []
        self.metrics: Dict[int, dict] = {}
        self._next_id = 0
        self.degraded = False
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
        self._decode_in = graphs.StaticInput(2 * B, torch.int64, self.device)
        self._decode_in.write(np.r_[np.zeros(B, np.int64), np.full(B, n, np.int64)])
        self.steps = {"decode": graphs.capture(
            functools.partial(decode_body, self.model, self.params, self.cache,
                              self._decode_in.tensor), self.device, "decode")}
        buckets = [chunk_bucket(n)]
        while buckets[0] > _MIN_CHUNK:
            buckets.insert(0, buckets[0] // 2)
        self._extend_in = graphs.StaticInput(3 + buckets[-1], torch.int64, self.device)
        self._extend_in.write([0, n, 1])             # one token at the trash position
        for b in buckets:
            self.steps[b] = graphs.capture(
                functools.partial(extend_body, self.cfg, self.params, self.cache, b,
                                  self._extend_in.tensor), self.device, f"extend_{b}")

    def _decode(self, tokens, pos) -> torch.Tensor:
        """tokens (B,) or (B,1) and positions (B,), host integers -> logits
        (B,1,V) f32 on the device: the decode step's output buffer, which
        the next step overwrites (``step`` samples from it first)."""
        self._decode_in.write(np.r_[np.asarray(tokens, np.int64).reshape(-1),
                                    np.asarray(pos, np.int64).reshape(-1)])
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
        br = solve_scenarios([Scenario((decode,), (ch,)) for ch in chunks],
                             self.dev)
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

    # ----------------------------- loop --------------------------- #
    def step(self) -> bool:
        """One scheduler iteration. Returns False when idle."""
        now = time.perf_counter
        # 1) admit waiting sequences into free slots
        while self.waiting and self.alloc.can_admit(self.waiting[0]):
            seq = self.waiting.pop(0)
            self.alloc.admit(seq)
            self.events.append(StepEvent("admit", now(),
                                         {"seq": seq.seq_id, "slot": seq.slot}))
        active = list(self.alloc.active.values())
        prefilling = [s for s in active if s.pos < s.prompt_len]
        decoding = [s for s in active if s.pos >= s.prompt_len and not s.done]
        if not active:
            return False

        # 2) one prefill chunk for the oldest prefilling sequence
        if prefilling:
            seq = prefilling[0]
            chunk = self._pick_chunk(seq, len(decoding))
            tok = seq.tokens[seq.pos:seq.pos + chunk]
            logits = self._extend(tok, seq.slot, seq.pos)
            last_chunk = seq.pos + len(tok) >= seq.prompt_len
            # the host waits for the device only where it needs a value:
            # the first generated token, after the prompt's last chunk
            nxt = self._sample(logits[:, -1])[0] if last_chunk else None
            self.events.append(StepEvent(
                "prefill_chunk", now(),
                {"seq": seq.seq_id, "chunk": len(tok),
                 "colocated_decodes": len(decoding)}))
            seq.pos += len(tok)
            if last_chunk:
                seq.tokens.append(nxt)
                seq.first_token_time = now()
                seq.pos += 1

        # 3) one decode step for the whole decode batch
        if decoding:
            B = self.ecfg.max_slots
            tokens = np.zeros((B, 1), np.int64)
            pos = np.full((B,), self.ecfg.max_len, np.int64)   # trash slot
            for s in decoding:
                tokens[s.slot, 0] = s.tokens[-1]
                pos[s.slot] = s.pos - 1   # position of the token being fed
            logits = self._decode(tokens, pos)
            # the sampled ids reach the host before the event is stamped, so
            # the gap between decode events measures the device's work and
            # not the enqueueing of its launches
            sampled = self._sample(logits[:, 0])
            self.events.append(StepEvent("decode", now(),
                                         {"batch": len(decoding)}))
            for s in decoding:
                s.tokens.append(sampled[s.slot])
                s.pos += 1
                if s.pos - s.prompt_len >= s.max_new:
                    s.done = True
                    self._finish(s)
        return True

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """logits (n, V) f32 on the device -> n token ids on the host.
        Greedy sampling takes the argmax on the device and moves n
        integers, the same function as an argmax on the host over n x V
        floats. With a temperature the logits go to the host and every row
        is drawn from a fresh ``default_rng(seed)``, as the reference
        engine does (so every draw uses the same variate)."""
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).tolist()
        out = []
        for row in logits.cpu().numpy():
            p = np.exp((row - row.max()) / self.ecfg.temperature)
            p /= p.sum()
            out.append(int(np.random.default_rng(self.ecfg.seed)
                           .choice(len(p), p=p)))
        return out

    def _finish(self, seq: Sequence):
        self.metrics[seq.seq_id] = {
            "prompt_len": seq.prompt_len,
            "new_tokens": len(seq.tokens) - seq.prompt_len,
            "ttft_s": (seq.first_token_time or 0) - seq.arrival,
            "output": seq.tokens[seq.prompt_len:],
        }
        self.alloc.release(seq.seq_id)
        self.events.append(StepEvent("finish", time.perf_counter(),
                                     {"seq": seq.seq_id}))

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, dict]:
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                break
        return self.metrics
