"""RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm_pallas``).
Bound by bytes on the card (x read once, y written once): one block per row
keeps the row in registers between the sum of squares and the scaling, and
moves it with 16-byte loads and stores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
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
