"""Fixed-slot KV-cache manager for continuous batching.

Host-side slot allocator over a fixed device cache of shape
(L, B_slots, S_max, KVH, D). Sequences claim a slot row; the allocator
tracks admission and release. The device-side cache layout matches
repro_torch.models.model.init_cache, so the same decode_step runs in the
engine and on its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Sequence:
    seq_id: int
    prompt_len: int
    max_new: int
    slot: int = -1
    pos: int = 0                 # next position to write
    done: bool = False
    tokens: List[int] = field(default_factory=list)
    arrival: float = 0.0
    first_token_time: Optional[float] = None


class SlotAllocator:
    """Fixed-slot KV cache rows + admission control."""

    def __init__(self, n_slots: int, max_len: int):
        self.n_slots = n_slots
        self.max_len = max_len
        self.free: List[int] = list(range(n_slots))
        self.active: Dict[int, Sequence] = {}

    def can_admit(self, seq: Sequence) -> bool:
        return bool(self.free) and seq.prompt_len + seq.max_new <= self.max_len

    def admit(self, seq: Sequence) -> int:
        if not self.can_admit(seq):
            raise RuntimeError(
                f"cannot admit seq {seq.seq_id}: "
                f"{len(self.free)} free slots, needs "
                f"{seq.prompt_len + seq.max_new} <= max_len={self.max_len}")
        seq.slot = self.free.pop()
        seq.pos = 0
        self.active[seq.seq_id] = seq
        return seq.slot

    def release(self, seq_id: int):
        seq = self.active.pop(seq_id, None)
        if seq is None:
            raise KeyError(f"release of unknown/already-released seq "
                           f"{seq_id}")
        self.free.append(seq.slot)
        seq.slot = -1

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_slots

    def active_slots(self) -> np.ndarray:
        return np.array(sorted(s.slot for s in self.active.values()),
                        dtype=np.int32)
