"""RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm_pallas``).
Bound by bytes on the card (x read once, y written once): one block per row
keeps the row in registers between the sum of squares and the scaling, and
moves it with 16-byte loads and stores. Where a gradient is wanted the
wrapper runs the kernel inside ``_grad.KernelFunction``: the backward is the
plain version's. Over DTensors it normalises each rank's rows
(``_mesh``): the rows may be split across ranks, the last dim may not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _grad, _mesh


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Per row ``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast to
    ``x.dtype``. x: (..., d); scale: (d,)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., d) bf16 or f32; scale: (d,). A tensor on the CPU takes the
    plain version, and so does one on ``meta`` (shapes only: the dry run's
    count); a CUDA tensor launches the kernel or raises. Where x or
    scale requires grad (and grad mode is on), both get gradients, those of
    the plain version."""
    if _mesh.any_dtensor(x, scale):
        mesh = _mesh.mesh_of(x, scale)
        pl = _mesh.check("rmsnorm", "x", x, mesh, range(x.ndim - 1))
        _mesh.check("rmsnorm", "scale", scale, mesh, ())
        return _mesh.local(lambda x, s: rmsnorm(x, s, eps), mesh, (x, scale), list(pl))
    if _grad.needs_grad(x, scale):
        return _grad.KernelFunction.apply(
            lambda x, s: _forward(x, s, eps), lambda x, s: rmsnorm_plain(x, s, eps),
            x, scale)
    return _forward(x, scale, eps)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type in ("cpu", "meta"):
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on {scale.device} "
                         f"does not fit x {tuple(x.shape)} on {x.device}")
    scale = scale.float().contiguous()
    x2 = x.reshape(-1, d)
    y = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return y.view(x.shape)
    _build.check_rows_aligned("rmsnorm: x", x2, x2.stride(0))
    _build.check_rows_aligned("rmsnorm: scale", scale)
    rc = _build.load().rt_rmsnorm(
        x2.data_ptr(), scale.data_ptr(), y.data_ptr(), x2.shape[0], d,
        x2.stride(0), y.stride(0), float(eps), _build.DTYPE_CODES[x.dtype],
        _build.stream_ptr())
    _build.check_launch(rc, f"rmsnorm{tuple(x.shape)}")
    rmsnorm.launches += 1
    return y.view(x.shape)


rmsnorm.launches = 0     # launches of the CUDA kernel by this wrapper
