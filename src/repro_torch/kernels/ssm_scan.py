"""The Mamba-1 selective scan: the wrapper of the CUDA kernel
``csrc/ssm_scan.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan.py``
(``ssm_scan_pallas``). Per batch row and channel d,
``h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * x_t) * B_t`` and
``y_t = <h_t, C_t>`` over the N states, with h in f32. On the card the state
stays in registers (four lanes share two channels of a batch row, each lane
a quarter of their states) and the time loop runs inside the kernel; bound
by its exps (one per (b, t, d, n), ``ex2.approx`` on the multi-function
units) at falcon-mamba's prefill. Beyond the Pallas kernel it takes an initial state and returns the
final one, as the model's scan does, and returns y in f32 (the model's
scan's type; ``kernels/ops.py:ssm_scan`` casts to ``x.dtype`` as the Pallas
kernel does). Where a gradient is wanted the wrapper runs the kernel inside
``_grad.KernelFunction``: the backward is the plain version's. Over
DTensors (``_mesh``) each rank scans its own batch rows and channels (the
reference's constraint: batch over the data axes, channels over the model
axis); the time axis and the states may not be split.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._loops import steps
from repro_torch.kernels import _build, _grad, _mesh

MAX_STATE = 16        # most states per channel the kernel is built for


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential loop of the reference's oracle
    (``repro/kernels/ref.py:ref_ssm_scan``), from state ``h0`` (zeros when
    None). x, dt (Bb, S, di); A (di, N); B, C (Bb, S, N). Returns
    (y (Bb, S, di) f32, hT (Bb, di, N) f32); hT is written into
    ``out_state`` when it is given (it may be ``h0``)."""
    Bb, S, di = x.shape
    N = A.shape[1]
    dt, A, B, C, xf = dt.float(), A.float(), B.float(), C.float(), x.float()
    h = (torch.zeros((Bb, di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys, loop = [], steps(S, x.device)      # two steps for all S when counted
    for t in loop:
        dA = torch.exp(dt[:, t, :, None] * A)
        dBx = (dt[:, t] * xf[:, t])[..., None] * B[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = loop.stack(ys, 1)
    if out_state is not None:
        out_state.copy_(h)
        h = out_state
    return y, h


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             out_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (Bb, S, di) bf16 or f32; dt (Bb, S, di), A (di, N), B and C
    (Bb, S, N) f32; h0 (Bb, di, N) f32 or None. Returns (y f32, hT); hT is
    written into ``out_state`` (a contiguous f32 (Bb, di, N) tensor, which
    may be ``h0``) when it is given. A tensor on the CPU takes the plain
    version, and so does one on ``meta`` (shapes only: the dry run's
    count); a CUDA tensor launches the kernel or raises. Where an input
    requires grad (and grad mode is on), x, dt, A, B, C and h0 get the
    plain version's gradients; ``out_state``, written in place by the
    decode and prefill-state paths, then raises."""
    inputs = (x, dt, A, B, C, h0)
    if _mesh.any_dtensor(*inputs, out_state):
        return _sharded(*inputs, out_state)
    if _grad.needs_grad(*inputs):
        if out_state is not None:
            raise RuntimeError("ssm_scan into out_state (written in place) has no "
                               "gradient: call it under torch.no_grad()")
        return _grad.KernelFunction.apply(_forward, ssm_scan_plain, *inputs)
    return _forward(*inputs, out_state)


def _sharded(x, dt, A, B, C, h0, out_state):
    name = "ssm_scan"
    mesh = _mesh.mesh_of(x, dt, A, B, C, h0, out_state)
    xp = _mesh.check(name, "x", x, mesh, (0, 2))
    Shard, R = _mesh._types()[1], _mesh._types()[2]()
    # what each input's placements must be, given x's: (batch, channel) maps
    want = {"dt": (dt, {0: Shard(0), 2: Shard(2)}), "A": (A, {0: R, 2: Shard(0)}),
            "B": (B, {0: Shard(0), 2: R}), "C": (C, {0: Shard(0), 2: R}),
            "h0": (h0, {0: Shard(0), 2: Shard(1)}),
            "out_state": (out_state, {0: Shard(0), 2: Shard(1)})}
    for what, (t, rule) in want.items():
        if t is None:
            continue
        need = tuple(R if _mesh.shard_dim(p, 3) is None else rule[_mesh.shard_dim(p, 3)]
                     for p in xp)
        if _mesh.placements(t, mesh) != need:
            _mesh.refuse(name, what, _mesh.placements(t, mesh), f"x is placed {xp}")
    hp = [R if _mesh.shard_dim(p, 3) is None else want["h0"][1][_mesh.shard_dim(p, 3)]
          for p in xp]
    args = (x, dt, A, B, C, h0, out_state)
    return _mesh.local(ssm_scan, mesh, args, (list(xp), hp))


def _forward(x, dt, A, B, C, h0=None, out_state=None):
    if x.device.type in ("cpu", "meta"):
        return ssm_scan_plain(x, dt, A, B, C, h0, out_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssm_scan: unsupported x dtype {x.dtype}")
    Bb, S, di = x.shape
    N = A.shape[-1]
    f32 = torch.float32
    want = {"dt": (dt, (Bb, S, di)), "A": (A, (di, N)), "B": (B, (Bb, S, N)),
            "C": (C, (Bb, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (Bb, di, N))
    if out_state is not None:
        want["out_state"] = (out_state, (Bb, di, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != f32 or t.device != x.device:
            raise ValueError(f"ssm_scan: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} float32 on {x.device}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: d_state {N} is not in 1..{MAX_STATE}")
    if out_state is not None and not out_state.is_contiguous():
        raise ValueError("ssm_scan: out_state must be contiguous")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=f32, device=x.device)
    hT = (torch.empty((Bb, di, N), dtype=f32, device=x.device)
          if out_state is None else out_state)
    rc = _build.load().rt_ssm_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        Bb, S, di, N, _build.DTYPE_CODES[x.dtype], _build.stream_ptr())
    _build.check_launch(rc, f"ssm_scan{tuple(x.shape)} N={N}")
    ssm_scan.launches += 1
    return y, hT


ssm_scan.launches = 0     # launches of the CUDA kernel by this wrapper
