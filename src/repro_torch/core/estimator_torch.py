"""PyTorch port of the batched water-filling interference solver.

The f64 twin of the JAX package's jitted solver: the effective-demand /
cache-share precompute, the freeze-round water-filling fixed point (the
smem equal-throttle branch and the sorted-cumsum theta), and the
queueing-inflation epilogue, written over the whole padded batch at once.
The reference writes one scenario and ``vmap``s a ``while_loop`` over it;
under ``vmap`` that loop runs the body for every scenario until the last
one is done and keeps a finished scenario's carry unchanged. Here the body
runs for the fixed ``K + N_AXES`` rounds over the batch with the
per-scenario ``done`` mask: a finished scenario's updates are empty, so
its state does not move, and the loop needs no host sync.

Numerical contract: float64 everywhere, every floor / tolerance constant
imported from `repro_torch.core.estimator` (never retyped here), results
equal to the NumPy oracle at 1e-9. The tensors live on the device that
`repro_torch.core.backend` carries; on a CUDA device the cache-share stage
runs on the ``cache_share`` kernel (`repro_torch.kernels.cache_share`),
on the CPU on its plain version. Batch sizes are bucketed up to powers of
two, as in the reference, so a caller sees the same padded shapes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.backend import get_solver_device
from repro_torch.core.estimator import (CAP_REMAIN_FLOOR, DEMAND_EPS,
                                        FRACTION_FLOOR, OVERSUB_RTOL,
                                        RATIO_FLOOR, SPEED_FLOOR, TIME_EPS,
                                        _INFLATION, _INFLATION_MAJORITY,
                                        _INFLATION_MIN_UTIL, _N_AXES, _SMEM,
                                        PER_SLOT_AXES)
from repro_torch.core.resources import AXIS_INDEX, RESOURCE_AXES, DeviceModel
from repro_torch.kernels import cache_share as _cs

_HBM = AXIS_INDEX["hbm"]
_L2 = AXIS_INDEX["l2"]
_PER_SLOT_MASK = np.array([r in PER_SLOT_AXES for r in RESOURCE_AXES])

# batch-size bucket floor: tiny scheduler batches all share one shape
_MIN_BUCKET = 8

F64 = torch.float64


def _bucket(s: int) -> int:
    """Next power of two >= s (floored at _MIN_BUCKET): the padded batch
    size a solve of s scenarios runs at."""
    b = _MIN_BUCKET
    while b < s:
        b <<= 1
    return b


def _effective_demand(demand, ws, hit, cache_cap, share):
    """Twin of profile.effective_demand_arrays (cache hits discount HBM
    traffic; the absorbed stream reappears as L2 demand). demand (S, K, A);
    the rest (S, K)."""
    cached = (ws > 0) & (hit > 0)
    resident = torch.clamp((cache_cap * share) / torch.clamp(ws, min=1.0), max=1.0)
    hit_f = hit * resident
    d_hbm = torch.where(cached, demand[..., _HBM] * (1.0 - hit_f), demand[..., _HBM])
    d_l2 = torch.where(cached, torch.maximum(demand[..., _L2], demand[..., _HBM]),
                       demand[..., _L2])
    d = demand.clone()
    d[..., _HBM] = d_hbm
    d[..., _L2] = d_l2
    return d


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[s, idx[s]] for t (S, X) and idx (S,)."""
    return t.gather(1, idx[:, None])[:, 0]


def _solve(demand, duration, ws, hit, slots, frac, mask, cap_vec, cache_cap,
           n_slots):
    """The whole batch solve: exclusion zeroing, the cache-share stage, the
    freeze rounds and the epilogue. demand (S, K, A); the rest (S, K);
    cap_vec (A,). Returns (speeds, slowdowns, frozen, axis_load, feasible)
    as tensors."""
    S, K = mask.shape
    dev = mask.device
    excluded = mask & (frac <= FRACTION_FLOOR)
    present = mask & ~excluded
    zero = torch.zeros((), dtype=F64, device=dev)
    demand = torch.where(present[:, :, None], demand, zero)
    duration = torch.where(present, duration, zero)
    ws = torch.where(present, ws, zero)
    hit = torch.where(present, hit, zero)
    slots = torch.where(present, slots, zero)
    share = _cs.cache_share(ws, present, cache_cap)

    eff_col = _effective_demand(demand, ws, hit, cache_cap, share)
    t_col = torch.maximum((eff_col / cap_vec).amax(-1), duration)
    eff_iso = _effective_demand(demand, ws, hit, cache_cap, torch.ones_like(share))
    t_iso = torch.maximum((eff_iso / cap_vec).amax(-1), duration)
    u = torch.where(t_col[..., None] > 0, (eff_col / t_col[..., None]) / cap_vec, zero)
    slot_scale = torch.where(frac < 1.0, torch.clamp(frac, min=FRACTION_FLOOR),
                             torch.ones_like(frac))
    per_slot = torch.from_numpy(_PER_SLOT_MASK).to(dev)
    u = torch.where(per_slot, u / slot_scale[..., None], u)
    axis_load = u.sum(1)

    # freeze rounds: while an axis is oversubscribed, freeze its users over
    # the fair share (equal throttle on smem, max-min theta elsewhere)
    speeds = torch.ones((S, K), dtype=F64, device=dev)
    active = present.clone()
    frozen = torch.full((S, K), -1, dtype=torch.int64, device=dev)
    used = torch.zeros((S, _N_AXES), dtype=F64, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    pos = torch.arange(K, device=dev)
    inf = torch.full((), float("inf"), dtype=F64, device=dev)
    for _ in range(K + _N_AXES):
        dem = (u * (speeds * active)[:, :, None]).sum(1)
        cap_rem = torch.clamp(1.0 - used, min=CAP_REMAIN_FLOOR)
        ratio = dem / cap_rem
        worst = ratio.argmax(-1)
        worst_ratio = _pick(ratio, worst)
        done = done | (worst_ratio <= 1.0 + OVERSUB_RTOL)
        live = ~done
        d = speeds * u.gather(2, worst[:, None, None].expand(S, K, 1))[..., 0]

        # smem: bank-conflict serialisation throttles EVERY user equally
        is_smem = live & (worst == _SMEM)
        users = active & (d > DEMAND_EPS) & is_smem[:, None]
        s_eq = 1.0 / torch.clamp(worst_ratio, min=RATIO_FLOOR)
        speeds = torch.where(users, speeds * s_eq[:, None], speeds)
        used = used + (u * (speeds * users)[:, :, None]).sum(1)
        frozen = torch.where(users, _SMEM, frozen)
        active = active & ~users

        # max-min rate cap theta on worst: sum min(d_n, theta) = cap
        is_mm = live & (worst != _SMEM)
        elig = active & (d > DEMAND_EPS) & is_mm[:, None]
        cap_w = _pick(cap_rem, worst)
        order = torch.sort(torch.where(elig, d, inf), dim=-1).values
        finite = torch.isfinite(order)
        vals = torch.where(finite, order, zero)
        csum = torch.cumsum(vals, dim=-1)
        m = elig.sum(-1)
        even = (cap_w[:, None] - (csum - vals)) / torch.clamp(m[:, None] - pos, min=1)
        breach = finite & (order > even) & (pos < m[:, None])
        has_theta = breach.any(-1) & is_mm
        theta = _pick(even, breach.to(torch.int32).argmax(-1))
        # no breach -> every user fits under the fair share: done
        done = done | (is_mm & ~has_theta)
        throttled = elig & has_theta[:, None] & (d > theta[:, None])
        speeds = torch.where(throttled,
                             speeds * (theta[:, None] / torch.where(d > 0, d, 1.0)),
                             speeds)
        used = used + (u * (speeds * throttled)[:, :, None]).sum(1)
        frozen = torch.where(throttled, worst[:, None], frozen)
        active = active & ~throttled

    # queueing inflation on near-saturated latency-sensitive axes
    base = (t_col / torch.clamp(t_iso, min=TIME_EPS)) / torch.clamp(speeds, min=SPEED_FLOOR)
    infl = torch.ones((S, K), dtype=F64, device=dev)
    for axis, (gamma, p) in _INFLATION.items():
        ai = AXIS_INDEX[axis]
        u_ax = u[..., ai]
        rho = torch.clamp((speeds * u_ax).sum(-1), max=1.0)
        skip = ((frozen == ai) | (u_ax <= _INFLATION_MIN_UTIL)
                | (u_ax >= _INFLATION_MAJORITY * torch.clamp(rho, min=SPEED_FLOOR)[:, None]))
        infl = infl + torch.where(~skip & present, gamma * rho[:, None] ** p, zero)
    slowdowns = base * infl
    speeds = torch.where(excluded, zero, speeds)
    slowdowns = torch.where(excluded, inf, slowdowns)

    tot_slots = (slots * torch.clamp(frac, max=1.0)).sum(-1)
    feasible = (tot_slots <= n_slots) | (tot_slots == 0)
    return speeds, slowdowns, frozen, axis_load, feasible


def solve_gathered(mask, frac, demand, duration, ws, hit, slots,
                   dev: DeviceModel) -> Tuple[np.ndarray, ...]:
    """Entry point for `estimator.solve_batch`'s torch dispatch: takes the
    NumPy-gathered padded arrays, pads the batch up to its size bucket
    (masked rows solve to no-ops), solves on the backend's device and
    returns NumPy (speeds, slowdowns, bottleneck, axis_load,
    feasible_slots)."""
    S, K = mask.shape
    pad = _bucket(S) - S
    if pad:
        z = ((0, pad), (0, 0))
        mask = np.pad(mask, z)
        frac = np.pad(frac, z, constant_values=1.0)
        demand = np.pad(demand, z + ((0, 0),))
        duration = np.pad(duration, z)
        ws = np.pad(ws, z)
        hit = np.pad(hit, z)
        slots = np.pad(slots, z)
    device = get_solver_device()

    def t(a, dtype=F64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    out = _solve(t(demand), t(duration), t(ws), t(hit), t(slots), t(frac),
                 t(mask, torch.bool), t(dev.capacity_vector()),
                 float(dev.cache_capacity), float(dev.n_slots))
    return tuple(o.cpu().numpy()[:S] for o in out)
