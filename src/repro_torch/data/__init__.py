"""Deterministic, seekable synthetic data pipeline: the twin of
``src/repro/data/__init__.py``, pure NumPy, carried over as it is (its
batches equal the reference's bit for bit).

Production properties required at 1000-node scale:
  * per-host sharding: each host materializes only its batch shard;
  * exactly seekable by step (restart/elastic-rescale resume is exact);
  * background prefetch (double buffering) so input never blocks the device;
  * sequence packing for variable-length documents.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    mean_doc_len: int = 192     # for packing


class SyntheticLM:
    """Zipf-distributed token stream with Markov structure, packed into
    fixed-length rows. ``seek(step)`` is O(1): the RNG is keyed by
    (seed, step, host) so any step can be regenerated exactly."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.d = dcfg
        assert dcfg.global_batch % dcfg.n_hosts == 0
        self.host_batch = dcfg.global_batch // dcfg.n_hosts
        self._step = 0

    def seek(self, step: int):
        self._step = step

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.d.seed, step, self.d.host_id]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.host_batch, self.d.seq_len, self.d.vocab_size
        # packed documents: boundaries reset the "Markov" state
        zipf = np.minimum(rng.zipf(1.3, size=(B, S + 1)), V - 1).astype(np.int32)
        drift = np.cumsum(rng.integers(0, 3, size=(B, S + 1)), axis=1)
        tokens = ((zipf + drift) % V).astype(np.int32)
        doc_len = max(8, self.d.mean_doc_len)
        boundaries = (np.arange(S + 1)[None, :] % doc_len) == 0
        loss_mask = np.broadcast_to(~boundaries[:, 1:], (B, S)
                                    ).astype(np.float32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                 "loss_mask": loss_mask}
        if self.cfg.family == "vlm":
            batch["vision"] = rng.standard_normal(
                (B, self.cfg.n_vision_tokens, self.cfg.d_vision)
            ).astype(np.float32)
        if self.cfg.family == "audio":
            batch.pop("tokens")
            batch["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            batch["labels"] = rng.integers(
                0, self.cfg.vocab_size, size=(B, S)).astype(np.int32)
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b


class Prefetcher:
    """Background-thread double buffering around any seekable source."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def seek(self, step: int):
        # drain + reposition (used on restart)
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self.source.seek(step)
        self._stop = threading.Event()
        self.q = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
