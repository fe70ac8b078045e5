"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample drawn from the seed of the requests
that the engine finished (the longest of them first, then others until
``min_tokens`` served tokens) is run through the reference once each, over
its prompt and its served tokens. At every served token the reference's
best logit less the served token's logit is a gap; the number compared is
the widest gap of the sample. The program's greedy tokens read small gaps
(rounding in bf16); the control, the reference's own products in float8,
reads the gaps of the tokens it puts first, which are wider. A request due
in the window that never got its first token fails the run as well.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gpubench.reference import decoder


def sample(finished: List[Dict], seed: int, min_tokens: int, max_requests: int) -> List[Dict]:
    """finished: dicts with ``prompt`` and ``served``. The longest request
    first, then others in an order drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i]["prompt"]) + len(finished[i]["served"])))
    rest = np.random.default_rng([seed, 7]).permutation(order[1:]).tolist()
    out, n = [], 0
    for i in [order[0]] + rest:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(finished[i])
        n += len(finished[i]["served"])
    return out


def gaps(weights: Dict, shape: Dict, prompt: List[int], served: List[int],
         control: bool = False) -> Dict[str, np.ndarray]:
    """The reference's gaps at each served token; with ``control`` also
    those of the tokens that the float8 control puts first."""
    dev = weights["embed"]["embedding"].device
    seq = torch.tensor(prompt + served[:-1], device=dev)
    at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served), device=dev)
    ref = decoder.logits(weights, shape, seq, at)
    best = ref.max(dim=-1).values
    rows = torch.arange(len(served), device=dev)
    out = {"program": (best - ref[rows, torch.tensor(served, device=dev)]).cpu().numpy()}
    if control:
        top = decoder.logits(weights, shape, seq, at, precision="fp8").argmax(dim=-1)
        out["control"] = (best - ref[rows, top]).cpu().numpy()
    return out


def readings(weights: Dict, shape: Dict, picked: List[Dict], control: bool = False) -> Dict:
    """The widest gap over the sample, of the program and of the control."""
    out = {"program": 0.0, "tokens": 0, "requests": len(picked)}
    if control:
        out["control"] = 0.0
    for r in picked:
        g = gaps(weights, shape, r["prompt"], r["served"], control)
        out["tokens"] += len(r["served"])
        for k in ("program", "control"):
            if k in g:
                out[k] = max(out[k], float(g[k].max()))
    return out
