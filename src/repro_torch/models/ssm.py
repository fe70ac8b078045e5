"""State-space model blocks: Mamba-1 (the selective scan).

The twin of the Mamba-1 half of ``src/repro/models/ssm.py``, with the same
parameter tree and shapes. The scan runs on the ``ssm_scan`` kernel for a
CUDA tensor (its plain version on the CPU), in prefill and in decode: a
decode step is the scan with one time step, started from the layer's state.
States are updated in place, as the dense family's KV cache is. Mamba-2
(SSD) is not ported yet (ROADMAP A6b).

Shapes: u (B, S, d_model); state ``conv`` (B, d_conv - 1, d_inner) bf16 and
``h`` (B, d_inner, d_state) f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssm_scan as _scan
from repro_torch.models.layers import Params, dense_init

CONV_DTYPE = torch.bfloat16        # the conv state's type, whatever the parameters are


def _dt_rank(d_model: int) -> int:
    return max(1, math.ceil(d_model / 16))


# ===================================================================== #
#  Causal depthwise conv1d (kernel k, shift-and-add form)                #
# ===================================================================== #
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, K); b: (C,). Causal depthwise conv + silu."""
    K, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + S, :] * w[:, i] for i in range(K))
    return F.silu(y + b)


def conv1d_step(conv_state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_state: (B, K-1, C); x_new: (B, C). Returns (new_state (B, K-1, C)
    in ``x_new``'s type, y (B, C))."""
    window = torch.cat([conv_state.to(x_new.dtype), x_new[:, None, :]], dim=1)
    y = torch.einsum("bkc,ck->bc", window, w)
    return window[:, 1:, :], F.silu(y + b)


# ===================================================================== #
#  Mamba-1                                                               #
# ===================================================================== #
def mamba1_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The reference's tree: x and z projections are separate parameters."""
    d, s = cfg.d_model, cfg.ssm
    di, r, dev = s.expand * d, _dt_rank(d), gen.device
    f32 = torch.float32
    u = torch.rand((di,), generator=gen, device=dev, dtype=f32)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "in_x": dense_init(gen, d, di, dtype),
        "in_z": dense_init(gen, d, di, dtype),
        "conv_w": torch.randn((di, s.d_conv), generator=gen, device=dev, dtype=f32)
        * (1.0 / math.sqrt(s.d_conv)),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "x_proj": dense_init(gen, di, r + 2 * s.d_state, dtype),
        "dt_proj": dense_init(gen, r, di, f32),
        # softplus^-1 of dt in [1e-3, 1e-1]
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "A_log": torch.log(torch.arange(1, s.d_state + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _mamba1_inputs(p: Params, cfg: ModelConfig, u: torch.Tensor):
    s = cfg.ssm
    r = _dt_rank(cfg.d_model)
    x = u @ p["in_x"]
    z = u @ p["in_z"]
    x = causal_conv1d(x, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    dt_in, B, C = torch.split(x @ p["x_proj"], [r, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt_in.float() @ p["dt_proj"] + p["dt_bias"])   # (B,S,di) f32
    A = -torch.exp(p["A_log"].float())                              # (di, N) f32
    return x, z, dt, A, B.float(), C.float()


def mamba1_scan(x, dt, A, B, C, h0: Optional[torch.Tensor] = None,
                out_state: Optional[torch.Tensor] = None):
    """Selective scan on the kernel. x (B,S,di); dt (B,S,di) f32; A (di,N);
    B, C (B,S,N). Returns (y (B,S,di) f32, h_final (B,di,N) f32), the final
    state written into ``out_state`` when it is given."""
    return _scan.ssm_scan(x, dt.float(), A.float(), B.float(), C.float(),
                          h0, out_state)


def _mamba1_out(p: Params, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                out_dtype) -> torch.Tensor:
    y = y + p["D"] * x.float()
    y = (y * F.silu(z.float())).to(out_dtype)
    return y @ p["out_proj"]


def mamba1_forward(p: Params, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    x, z, dt, A, B, C = _mamba1_inputs(p, cfg, u)
    y, _ = mamba1_scan(x, dt, A, B, C)
    return _mamba1_out(p, y, x, z, u.dtype)


def mamba1_init_state(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"conv": torch.zeros((batch, s.d_conv - 1, di), dtype=CONV_DTYPE, device=device),
            "h": torch.zeros((batch, di, s.d_state), dtype=torch.float32, device=device)}


def mamba1_step(p: Params, cfg: ModelConfig, u: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """u: (B, 1, d). Returns (out (B,1,d), state); the state's ``conv`` and
    ``h`` are updated in place. The state update is the scan with one time
    step from h (the same arithmetic as the reference's step)."""
    s = cfg.ssm
    r = _dt_rank(cfg.d_model)
    x = (u @ p["in_x"])[:, 0]
    z = (u @ p["in_z"])[:, 0]
    conv, x = conv1d_step(state["conv"], x, p["conv_w"].to(x.dtype),
                          p["conv_b"].to(x.dtype))
    state["conv"].copy_(conv)
    dt_in, B, C = torch.split(x @ p["x_proj"], [r, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt_in.float() @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = mamba1_scan(x[:, None], dt[:, None], A, B.float()[:, None],
                       C.float()[:, None], h0=state["h"], out_state=state["h"])
    out = _mamba1_out(p, y[:, 0], x, z, u.dtype)
    return out[:, None, :], state
