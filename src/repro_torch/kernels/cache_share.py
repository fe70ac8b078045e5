"""The estimator's cache-share / thrash-cliff stage: the wrapper of the CUDA
kernel ``csrc/cache_share.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/cache_share.py``
(``cache_share_pallas``). Every scenario member gets a shared-cache
residency share (paper Fig. 3): a member colocated with any other cache
user keeps its hits only while the combined working set fits (share 0 or
1), a lone cache user keeps min(1, C / ws), a member without a working set
keeps 1. Bound by its launch on the card: the torch solver
(``core/estimator_torch.py``) calls it once per solve on a few to a few
thousand rows of 2-6 members, in f64, one thread per row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def cache_share_plain(ws: torch.Tensor, present: torch.Tensor,
                      cache_cap: float) -> torch.Tensor:
    """ws (S, K) f64, already zero for absent members; present (S, K) bool.
    The row total is summed left to right over K, as the kernel does."""
    total = ws[:, 0].clone()
    for k in range(1, ws.shape[1]):
        total = total + ws[:, k]
    resident_col = torch.where(total > cache_cap, 0.0, 1.0).to(ws.dtype)
    nk = present.sum(-1)
    has_ws = ws > 0
    # a tensor over a tensor: ``float / tensor`` would multiply by the
    # reciprocal, which rounds twice
    cap = torch.full_like(ws, cache_cap)
    lone = torch.clamp(cap / torch.clamp(ws, min=1.0), max=1.0)
    return torch.where(has_ws & (nk > 1)[:, None], resident_col[:, None],
                       torch.where(has_ws, lone, torch.ones_like(ws)))


def cache_share(ws: torch.Tensor, present: torch.Tensor,
                cache_cap: float) -> torch.Tensor:
    """ws (S, K) f64; present (S, K) bool -> (S, K) f64. A tensor on the CPU
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if ws.device.type == "cpu":
        return cache_share_plain(ws, present, cache_cap)
    if ws.device.type != "cuda" or present.device != ws.device:
        raise ValueError(f"cache_share: ws on {ws.device}, present on "
                         f"{present.device}")
    if ws.dtype != torch.float64 or present.dtype != torch.bool:
        raise TypeError(f"cache_share: ws must be float64 and present bool, "
                        f"got {ws.dtype} and {present.dtype}")
    if ws.dim() != 2 or present.shape != ws.shape or ws.shape[1] == 0:
        raise ValueError(f"cache_share: ws {tuple(ws.shape)} and present "
                         f"{tuple(present.shape)} must be one (S, K) shape, K >= 1")
    ws, present = ws.contiguous(), present.contiguous()
    out = torch.empty_like(ws)
    S, K = ws.shape
    if S == 0:
        return out
    rc = _build.load().rt_cache_share(
        ws.data_ptr(), present.data_ptr(), float(cache_cap), out.data_ptr(),
        S, K, _build.stream_ptr())
    _build.check_launch(rc, f"cache_share{tuple(ws.shape)}")
    cache_share.launches += 1
    return out


cache_share.launches = 0     # launches of the CUDA kernel by this wrapper
