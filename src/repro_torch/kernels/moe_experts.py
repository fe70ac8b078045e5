"""The expert products of a MoE layer over its capacity buffer: the wrapper of
the CUDA kernel ``csrc/moe_experts.cu`` and its plain PyTorch version.

Replaces no TPU kernel: the reference leaves the three batched products over
the ``(E, cap, d)`` buffer to XLA, and the plain version is the port's
former code, three ``torch.bmm`` over every row of the buffer. The kernel
computes each expert's first ``count[e]`` rows only, ``count`` (E,) int32
lying on the device (the dispatch's kept rows), so a capacity that drops
nothing costs the rows the tokens were routed to and not E x cap; every hit
expert's weights are read once a 128-row tile (see the source). Rows past
``count[e]`` of the result are not written: the dispatch reads only kept
rows. On the CPU and on ``meta`` (the dry run's count) the wrapper takes the
plain version; where a gradient is wanted on the card the kernel runs
inside ``_grad.KernelFunction`` and the backward is the plain version's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _grad

ACTS = {"silu": 0, "gelu": 1}          # act of rt_moe_experts; "gelu" is the tanh form


def moe_experts_plain(x: torch.Tensor, count: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor, act: str = "silu"
                      ) -> torch.Tensor:
    """x (E, cap, d); w_gate / w_up (E, d, f); w_down (E, f, d) ->
    ``act(x w_gate) * (x w_up)`` through ``w_down``, (E, cap, d), every row
    of the buffer (``count`` is not read: the rows past it are the
    dispatch's zeros)."""
    g = torch.bmm(x, w_gate)
    u = torch.bmm(x, w_up)
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    return torch.bmm(h, w_down)


def moe_experts(x: torch.Tensor, count: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``moe_experts_plain``'s function on each expert's first ``count[e]``
    rows; the other rows of the result are left unwritten on the card. A
    tensor on the CPU or on ``meta`` takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type in ("cpu", "meta"):
        return moe_experts_plain(x, count, w_gate, w_up, w_down, act)
    if _grad.needs_grad(x, w_gate, w_up, w_down):
        return _grad.KernelFunction.apply(
            lambda *t: _forward(*t, act), lambda *t: moe_experts_plain(*t, act),
            x, count, w_gate, w_up, w_down)
    return _forward(x, count, w_gate, w_up, w_down, act)


def admit(x, count, w_gate, w_up, w_down, act: str = "silu") -> None:
    """The shapes and types the kernel takes, as the wrapper checks them
    before any launch: raises ValueError or TypeError naming the wrapper."""
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"moe_experts: x {tuple(x.shape)} and w_gate {tuple(w_gate.shape)} "
                         "must be (E, cap, d) and (E, d, f)")
    E, cap, d = x.shape
    f = w_gate.shape[2]
    if (w_gate.shape != (E, d, f) or w_up.shape != w_gate.shape
            or w_down.shape != (E, f, d) or count.shape != (E,)):
        raise ValueError(f"moe_experts: shapes x {tuple(x.shape)} w_gate {tuple(w_gate.shape)} "
                         f"w_up {tuple(w_up.shape)} w_down {tuple(w_down.shape)} "
                         f"count {tuple(count.shape)} do not fit")
    if d % 8 or f % 8:
        raise ValueError(f"moe_experts: d {d} and f {f} must be multiples of 8")
    if act not in ACTS:
        raise ValueError(f"moe_experts: act {act!r} not in {tuple(ACTS)}")
    if any(t.dtype != torch.bfloat16 for t in (x, w_gate, w_up, w_down)):
        raise TypeError(f"moe_experts: takes bf16, got x {x.dtype} w_gate {w_gate.dtype} "
                        f"w_up {w_up.dtype} w_down {w_down.dtype}")
    if count.dtype != torch.int32:
        raise TypeError(f"moe_experts: count must be int32, got {count.dtype}")
    if any(t.device != x.device for t in (count, w_gate, w_up, w_down)):
        raise ValueError("moe_experts: all tensors must be on one device")
    if w_up.stride() != w_gate.stride():
        raise ValueError("moe_experts: w_gate and w_up must share their strides")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        _build.check_rows_aligned(f"moe_experts: {name}", t, t.stride(0), t.stride(1))


def _forward(x, count, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {x.device}")
    admit(x, count, w_gate, w_up, w_down, act)
    E, cap, d = x.shape
    f = w_gate.shape[2]
    h = torch.empty((E, cap, f), dtype=x.dtype, device=x.device)
    out = torch.empty((E, cap, d), dtype=x.dtype, device=x.device)
    rc = _build.load().rt_moe_experts(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
        out.data_ptr(), count.data_ptr(), E, cap, d, f, x.stride(0), x.stride(1),
        w_gate.stride(0), w_gate.stride(1), w_down.stride(0), w_down.stride(1),
        h.stride(0), h.stride(1), out.stride(0), out.stride(1), ACTS[act],
        _build.stream_ptr())
    _build.check_launch(rc, f"moe_experts x{tuple(x.shape)} f {f}")
    moe_experts.launches += 1
    return out


moe_experts.launches = 0     # calls that launched the CUDA kernels (two launches a call)
