"""The one generator of traffic: requests from a mix's parameters and a seed.

Every seed gets the same work in another order. Requests come in blocks;
each block holds the same lengths (the clipped lognormal's quantiles at
``(i + 0.5) / n``) and, in an open loop, the same gaps between arrivals
(the exponential's quantiles, scaled so that a block lasts exactly
``n / rate`` seconds: a Poisson process's gaps, stratified). The prompts'
token ids are drawn from the seed uniformly over the vocabulary.

How the seed orders a block is the mix's ``order``:

* ``shuffle``: the seed permutes each block's prompt lengths, output
  lengths and gaps independently;
* ``rotate``: one arrangement of the block (prompt, output and gap
  permuted together by the mix's fixed ``base_seed``) repeats block after
  block, and the seed rotates it: every seed sends the same sequence of
  requests, starting at another point of the cycle. Where a tail such as
  the time to first token follows how long prompts happen to cluster, a
  shuffle changes that clustering, and so the work, from seed to seed.

So any run of whole blocks offers the same tokens at the same rate
whatever the seed, and two seeds differ in order alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclass
class Request:
    rid: int
    due: float            # seconds from the window's start; negative in the lead-in
    prompt: List[int]
    max_new: int


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """n stratified draws of a length distribution, as whole numbers."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = np.array([NormalDist().inv_cdf(v) for v in u])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def gaps(n: int, rate: float) -> np.ndarray:
    """n stratified exponential gaps that sum to exactly n / rate."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g * (n / rate) / g.sum()


class Generator:
    """Requests of a mix for one seed. ``block`` requests a block; in an
    open loop at ``rate`` requests/s, a block lasts ``block / rate`` s."""

    def __init__(self, mix: Dict, vocab: int, seed: int, block: int, rate: float = 0.0):
        self.mix, self.vocab, self.block, self.rate = mix, vocab, block, rate
        self.rng = np.random.default_rng(seed)
        self.prompt_q = quantiles(mix["prompt"], block)
        self.output_q = quantiles(mix["output"], block)
        self.gap_q = gaps(block, rate) if rate > 0 else np.zeros(block)
        self.order = mix.get("order", "shuffle")
        if self.order == "rotate":
            base = np.random.default_rng(mix["base_seed"]).permutation(block)
            shift = int(self.rng.integers(block))
            idx = np.roll(base, -shift)
            self.prompt_q, self.output_q = self.prompt_q[idx], self.output_q[idx]
            self.gap_q = self.gap_q[idx]
        elif self.order != "shuffle":
            raise ValueError(f"unknown order {self.order!r}")
        self._next = 0

    def _arranged(self):
        if self.order == "rotate":
            return self.prompt_q, self.output_q, self.gap_q
        return (self.rng.permutation(self.prompt_q), self.rng.permutation(self.output_q),
                self.rng.permutation(self.gap_q))

    def blocks(self, n_blocks: int, t0: float = 0.0) -> List[Request]:
        """The next ``n_blocks`` blocks, the first request due at ``t0`` plus
        its gap (in a backlog every request is due at ``t0``)."""
        out, t = [], t0
        for _ in range(n_blocks):
            p, o, g = self._arranged()
            for i in range(self.block):
                t += g[i]
                prompt = self.rng.integers(0, self.vocab, size=int(p[i])).tolist()
                out.append(Request(self._next, t, prompt, int(o[i])))
                self._next += 1
        return out
