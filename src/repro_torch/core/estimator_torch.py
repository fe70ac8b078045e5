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

The reference jits the whole solve (``estimator_jax.py:_solve_padded``);
here one solve of each (bucket, K, DeviceModel) is a step
(``repro_torch.graphs``): its seven inputs packed into one static f64
buffer, its five outputs into one, the device model's capacities baked in.
On a CUDA device the step is captured into a CUDA graph at its first use
(or by ``warmup``) and replayed; on the CPU the same body runs directly.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import graphs
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
           n_slots, per_slot):
    """The whole batch solve: exclusion zeroing, the cache-share stage, the
    freeze rounds and the epilogue. demand (S, K, A); the rest (S, K);
    cap_vec (A,) f64 and per_slot (A,) bool (the axes that scale with the
    slot fraction) on the device. Returns (speeds, slowdowns, frozen,
    axis_load, feasible) as tensors."""
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


# the packed input: demand (S, K, A), then these (S, K) fields, the mask as 0 / 1
_FIELDS = ("duration", "ws", "hit", "slots", "frac", "mask")


def pack(mask, frac, demand, duration, ws, hit, slots) -> np.ndarray:
    """The seven padded NumPy inputs of a solve as one flat f64 array, in
    the order ``solve_packed`` reads them."""
    return np.concatenate([demand.ravel(), duration.ravel(), ws.ravel(), hit.ravel(),
                           slots.ravel(), frac.ravel(), mask.ravel()]).astype(np.float64)


def solve_packed(buf, S, K, cap_vec, cache_cap, n_slots, per_slot) -> torch.Tensor:
    """The solve's step body: ``buf`` as ``pack`` lays it out -> (S, 3K + A +
    1) f64, the columns speeds, slowdowns, frozen axis, axis_load and
    feasible (frozen and feasible exact as f64)."""
    n = S * K
    demand = buf[:n * _N_AXES].view(S, K, _N_AXES)
    duration, ws, hit, slots, frac, mask = buf[n * _N_AXES:].view(len(_FIELDS), S, K).unbind(0)
    speeds, slowdowns, frozen, axis_load, feasible = _solve(
        demand, duration, ws, hit, slots, frac, mask != 0, cap_vec, cache_cap,
        n_slots, per_slot)
    return torch.cat([speeds, slowdowns, frozen.to(F64), axis_load,
                      feasible.to(F64)[:, None]], 1)


def unpack(out: np.ndarray, S: int, K: int) -> Tuple[np.ndarray, ...]:
    """The first S rows of ``solve_packed``'s output as (speeds, slowdowns,
    bottleneck, axis_load, feasible_slots), in the types the NumPy solver
    returns."""
    out = out[:S]
    return (out[:, :K].copy(), out[:, K:2 * K].copy(),
            out[:, 2 * K:3 * K].astype(np.int64), out[:, 3 * K:3 * K + _N_AXES].copy(),
            out[:, -1] != 0)


_steps: Dict[tuple, tuple] = {}    # (bucket, K, DeviceModel, device) -> (input, step)


def _step(S: int, K: int, dev: DeviceModel, device: torch.device) -> tuple:
    """The static input and the step of one (bucket, K, device model) on
    ``device``, captured on a CUDA device at the first call (its seconds in
    the step's ``capture_s``; nothing is printed: a program's standard
    output is its own)."""
    key = (S, K, dev, device)
    if key not in _steps:
        inp = graphs.StaticInput(S * K * (_N_AXES + len(_FIELDS)), F64, device)
        body = functools.partial(
            solve_packed, inp.tensor, S, K,
            torch.from_numpy(dev.capacity_vector()).to(device),
            float(dev.cache_capacity), float(dev.n_slots),
            torch.from_numpy(_PER_SLOT_MASK).to(device))
        _steps[key] = (inp, graphs.capture(body, device, f"solve_{S}x{K}_{dev.name}"))
    return _steps[key]


def captured_steps() -> list:
    """Every solver step made so far in this process."""
    return [step for _, step in _steps.values()]


def warmup(dev: DeviceModel, ks=(2, 3), buckets=(_MIN_BUCKET,)) -> int:
    """Make the steps of the (bucket, K) shapes a scheduler will hit ahead
    of time, on the backend's device; returns the number of new graphs
    captured (0 on the CPU, where nothing is captured)."""
    device = get_solver_device()
    new = 0
    for K in ks:
        for S in buckets:
            key = (_bucket(int(S)), int(K), dev, device)
            if key not in _steps:
                new += _step(*key)[1].graph is not None
    return new


def solve_gathered(mask, frac, demand, duration, ws, hit, slots,
                   dev: DeviceModel) -> Tuple[np.ndarray, ...]:
    """Entry point for `estimator.solve_batch`'s torch dispatch: takes the
    NumPy-gathered padded arrays, pads the batch up to its size bucket
    (masked rows solve to no-ops), runs the bucket's step on the backend's
    device and returns NumPy (speeds, slowdowns, bottleneck, axis_load,
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
    inp, step = _step(S + pad, K, dev, get_solver_device())
    inp.write(pack(mask, frac, demand, duration, ws, hit, slots))
    return unpack(step().cpu().numpy(), S, K)
