"""State-space model blocks: Mamba-1 (the selective scan) and Mamba-2 (SSD).

The twin of ``src/repro/models/ssm.py``, with the same parameter trees and
shapes. Mamba-1's scan runs on the ``ssm_scan`` kernel for a CUDA tensor
(its plain version on the CPU), in prefill and in decode: a decode step is
the scan with one time step, started from the layer's state. Mamba-2's
chunked SSD reaches no kernel in the reference, which leaves its products
to XLA: here they are f32 ``torch.matmul`` products, and its gated norm
runs on the ``rmsnorm`` kernel. States are updated in place, as the dense
family's KV cache is; the conv states stay bf16 (ROADMAP C15, C16).

Shapes: u (B, S, d_model). Mamba-1 state ``conv`` (B, d_conv - 1, d_inner)
bf16 and ``h`` (B, d_inner, d_state) f32; Mamba-2 state ``conv_x`` (B,
d_conv - 1, d_inner) and ``conv_bc`` (B, d_conv - 1, 2 * d_state) bf16 and
``h`` (B, n_heads, head_p, d_state) f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssm_scan as _scan
from repro_torch.models.layers import Params, dense_init, rmsnorm, rmsnorm_init

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


# ===================================================================== #
#  Mamba-2 (SSD, scalar A per head, n_groups = 1)                        #
# ===================================================================== #
def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The reference's tree: the z / x / bc / dt projections are separate
    parameters."""
    d, s = cfg.d_model, cfg.ssm
    di, H, N, dev = s.expand * d, s.n_heads, s.d_state, gen.device
    f32 = torch.float32
    u = torch.rand((H,), generator=gen, device=dev, dtype=f32)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    a = 1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev, dtype=f32)
    return {
        "in_z": dense_init(gen, d, di, dtype),
        "in_x": dense_init(gen, d, di, dtype),
        "in_bc": dense_init(gen, d, 2 * N, dtype),
        "in_dt": dense_init(gen, d, H, dtype),
        "conv_x_w": torch.randn((di, s.d_conv), generator=gen, device=dev, dtype=f32)
        * (1.0 / math.sqrt(s.d_conv)),
        "conv_x_b": torch.zeros((di,), dtype=f32, device=dev),
        "conv_bc_w": torch.randn((2 * N, s.d_conv), generator=gen, device=dev, dtype=f32)
        * (1.0 / math.sqrt(s.d_conv)),
        "conv_bc_b": torch.zeros((2 * N,), dtype=f32, device=dev),
        # softplus^-1 of dt in [1e-3, 1e-1]; A = -exp(A_log) in [-16, -1]
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "A_log": torch.log(a),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "norm": rmsnorm_init(di, dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L). Returns (..., L, L) with out[i, j] = sum_{j<k<=i} x[k],
    -inf above the diagonal (which ``exp`` takes to 0). Keep x in f32."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    below = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~below, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Mamba-2 SSD in f32. x (b,s,h,p); dt (b,s,h); A (h,); B, C (b,s,n).
    Returns y (b,s,h,p) f32 and the final state (b,h,p,n) f32.

    The reference's three-operand einsums are taken pairwise, so that no
    intermediate is larger than one (b, c, h, l, l) f32 tensor (c chunks
    of l steps); the recurrence across chunks is a loop over the chunks."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    dtc = dt.reshape(b, nc, chunk, H).float()
    xdt = x.reshape(b, nc, chunk, H, P).float() * dtc[..., None]     # (b,c,l,h,p)
    Bc = B.reshape(b, nc, chunk, N).float()
    Cc = C.reshape(b, nc, chunk, N).float()
    dA = dtc * A.float()                                             # (b,c,l,h)
    dA_cum = torch.cumsum(dA, dim=2)
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                               # (b,c,h,l,p)
    # 1) intra-chunk: bclm,bchlm,bcmhp->bclhp as (scores * L) @ xdt
    w = torch.exp(_segsum(dA.transpose(2, 3)))                       # (b,c,h,l,m)
    w.mul_((Cc @ Bc.transpose(2, 3))[:, :, None])                    # scores (b,c,l,m)
    y = w @ xdt_h                                                    # (b,c,h,l,p)
    del w
    # 2) chunk states: bcln,bclh,bclhp->bchpn as (decay * xdt)^T @ B
    decay_states = torch.exp(dA_cum[:, :, -1:] - dA_cum)             # (b,c,l,h)
    states = (xdt_h * decay_states.transpose(2, 3)[..., None]).transpose(3, 4) \
        @ Bc[:, :, None]                                             # (b,c,h,p,n)
    # 3) inter-chunk recurrence, sequential over chunks
    chunk_decay = torch.exp(dA_cum[:, :, -1])                        # (b,c,h)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    h_in = torch.empty_like(states)
    for c in range(nc):
        h_in[:, c] = h
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    # 4) state -> output within the chunk: bcln,bchpn,bclh->bclhp as
    #    (C @ h^T) * exp(dA_cum)
    y_off = Cc[:, :, None] @ h_in.transpose(3, 4)                    # (b,c,h,l,p)
    y += y_off * torch.exp(dA_cum).transpose(2, 3)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(b, S + pad, H, P)[:, :S]
    return y, h


def _mamba2_project(p: Params, cfg: ModelConfig, u: torch.Tensor):
    """z, x (after the conv), B, C (after the conv) and dt (f32)."""
    z = u @ p["in_z"]
    x = u @ p["in_x"]
    bc = u @ p["in_bc"]
    dt_in = u @ p["in_dt"]
    x = causal_conv1d(x, p["conv_x_w"].to(x.dtype), p["conv_x_b"].to(x.dtype))
    bc = causal_conv1d(bc, p["conv_bc_w"].to(bc.dtype), p["conv_bc_b"].to(bc.dtype))
    B, C = bc.chunk(2, dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])
    return z, x, B, C, dt


def _mamba2_out(p: Params, cfg: ModelConfig, y: torch.Tensor, x: torch.Tensor,
                z: torch.Tensor, out_dtype) -> torch.Tensor:
    """y (B, S, H, P) f32 from the SSD; x, z (B, S, d_inner). The skip, the
    gated norm (on the rmsnorm kernel) and the output projection."""
    Bsz, S, H, P = y.shape
    y = (y + p["D"][:, None] * x.reshape(Bsz, S, H, P).float()).reshape(Bsz, S, H * P)
    y = rmsnorm(p["norm"], (y * F.silu(z.float())).to(out_dtype), cfg.norm_eps)
    return y @ p["out_proj"]


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.ssm.n_heads
    return H, cfg.d_inner // H


def mamba2_forward(p: Params, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    return mamba2_forward_with_state(p, cfg, u)[0]


def mamba2_forward_with_state(p: Params, cfg: ModelConfig, u: torch.Tensor):
    """Returns (out (B, S, d), the final SSM state (B, H, P, N) f32)."""
    H, P = _heads(cfg)
    z, x, B, C, dt = _mamba2_project(p, cfg, u)
    Bsz, S = u.shape[:2]
    y, hT = ssd_chunked(x.reshape(Bsz, S, H, P), dt, -torch.exp(p["A_log"].float()),
                        B, C, cfg.ssm.chunk_size)
    return _mamba2_out(p, cfg, y, x, z, u.dtype), hT


def mamba2_init_state(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    H, P = _heads(cfg)
    K = s.d_conv - 1
    return {"conv_x": torch.zeros((batch, K, cfg.d_inner), dtype=CONV_DTYPE, device=device),
            "conv_bc": torch.zeros((batch, K, 2 * s.d_state), dtype=CONV_DTYPE, device=device),
            "h": torch.zeros((batch, H, P, s.d_state), dtype=torch.float32, device=device)}


def mamba2_step(p: Params, cfg: ModelConfig, u: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """u: (B, 1, d). Returns (out (B,1,d), state); ``conv_x``, ``conv_bc``
    (bf16) and ``h`` (f32) are updated in place, by the reference's
    arithmetic."""
    H, P = _heads(cfg)
    z = u @ p["in_z"]
    x = (u @ p["in_x"])[:, 0]
    bc = (u @ p["in_bc"])[:, 0]
    dt_in = (u @ p["in_dt"])[:, 0]
    conv_x, x = conv1d_step(state["conv_x"], x, p["conv_x_w"].to(x.dtype),
                            p["conv_x_b"].to(x.dtype))
    conv_bc, bc = conv1d_step(state["conv_bc"], bc, p["conv_bc_w"].to(bc.dtype),
                              p["conv_bc_b"].to(bc.dtype))
    state["conv_x"].copy_(conv_x)
    state["conv_bc"].copy_(conv_bc)
    B, C = bc.float().chunk(2, dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])                    # (b,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"].float()))
    xh = x.reshape(-1, H, P).float()
    h = state["h"]                                                   # (b,H,P,N)
    h.mul_(dA[..., None, None]).add_((dt[..., None] * xh)[..., None] * B[:, None, None, :])
    y = (h @ C[:, None, :, None])[..., 0]                            # (b,H,P)
    return _mamba2_out(p, cfg, y[:, None], x[:, None], z, u.dtype), state
