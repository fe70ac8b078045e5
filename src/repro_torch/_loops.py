"""The loop hook of the executed-work counter (``core/hlo.py``), in a leaf
module that imports nothing of this package, so that the plain versions of
the kernels and the models' loops can use it without importing ``core``.

``_ACTIVE`` is the stack of counters counting now (``hlo.Counter`` pushes
itself on entry), and ``steps(n, device)`` is the range of a Python loop of
``n`` identical steps that, under an active counter on ``meta`` tensors,
runs two of them, the second under the counter's multiplicity of n - 1.
"""
from __future__ import annotations

from typing import List, Optional

import torch

_ACTIVE: List[object] = []


def active() -> Optional[object]:
    """The innermost counter counting now, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class steps:
    """The iterations of a Python loop of ``n`` steps, each doing the same
    work: ``for t in steps(n, device): ...``. Under an active counter on
    ``meta`` tensors (no values to get right) it runs two of them, the
    first counted once and the second ``n - 1`` times: the second sees a
    carried state as every later step does (the first may see zeros that
    need no gradient). ``stack(items, dim)`` stacks the per-step results
    into the n steps' shape (the second standing for the other n - 1)."""

    def __init__(self, n: int, device):
        self.n = n
        self.counter = active()
        self.collapsed = (self.counter is not None and n > 2
                          and torch.device(device).type == "meta")

    def __iter__(self):
        if not self.collapsed:
            yield from range(self.n)
            return
        yield 0
        with self.counter.loop(self.n - 1):
            yield 1

    def stack(self, items, dim: int) -> torch.Tensor:
        if not self.collapsed:
            return torch.stack(items, dim)
        rest = items[1].unsqueeze(dim)
        shape = list(rest.shape)
        shape[dim] = self.n - 1
        return torch.cat([items[0].unsqueeze(dim), rest.expand(shape)], dim)
