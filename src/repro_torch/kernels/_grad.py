"""Gradients through the kernels: a ``torch.autograd.Function`` whose
forward is a wrapper's own path (the kernel on a CUDA tensor, the plain
version on a CPU tensor) and whose backward is the vector-Jacobian product
of the kernel's plain PyTorch version, recomputed from the saved inputs.

This is the counterpart of the reference's training, which differentiates
jnp code with XLA's autodiff: no Pallas kernel of the JAX package has a
backward kernel, so none of the port's has one either. A wrapper applies
the Function only where a gradient is wanted (``needs_grad``); everywhere
else it takes its path unchanged, so serving, the captured steps and their
launch counts do not see it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def needs_grad(*inputs: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and some input requires grad, on the CPU or the
    card. On ``meta`` (the dry run's count) there is no kernel: the wrapper
    runs its plain version and autograd differentiates it as it stands,
    as the reference's autodiff runs over its jnp code (no recompute)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad and t.device.type != "meta" for t in inputs)


class KernelFunction(torch.autograd.Function):
    """``apply(forward, plain, *inputs)``: ``forward(*inputs)`` computes the
    result (one tensor or a tuple); the backward is that of
    ``plain(*inputs)``, which computes the same function in PyTorch. A
    ``None`` input gets no gradient."""

    @staticmethod
    def forward(ctx, forward: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        want = [i for i, t in enumerate(inputs)
                if t is not None and ctx.needs_input_grad[2 + i]]
        out = [None] * len(inputs)
        if not want or all(g is None for g in grads):
            return (None, None, *out)
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(i in want)
                  for i, t in enumerate(inputs)]
            ys = ctx.plain(*xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        pairs = [(y, g) for y, g in zip(ys, grads) if g is not None]
        got = torch.autograd.grad([y for y, _ in pairs], [xs[i] for i in want],
                                  [g for _, g in pairs], allow_unused=True)
        for i, g in zip(want, got):
            out[i] = g
        return (None, None, *out)
