"""Kernel-level interference estimator (paper §5.1's proposed foundation).

Model: concurrent kernels are fluid flows over a vector of shared
resources. Kernel k running at speed s_k <= 1 consumes s_k * u_k[r] of
axis r, where u_k[r] is its full-speed utilization (from KernelProfile).
Speeds are the max-min fair fixed point computed by water-filling:

  repeat:
    find the most oversubscribed axis r* among unfrozen kernels;
    if no axis oversubscribed -> all remaining kernels run at s=1;
    else freeze every unfrozen kernel using r* at the fair speed
         s = available_capacity(r*) / sum(u_k[r*]).

This generalizes all the paper's findings in one mechanism:
  * pitfall 1/2: a kernel with u[issue] ~ 1 (IPC 3.99/4) slows every
    co-runner regardless of its occupancy or arithmetic intensity;
  * §4.3: disjoint-SM kernels still contend on hbm/l2 axes;
  * §4.4.1: smem-axis saturation by a bank-conflicted kernel;
  * §4.4.3: a compute pipeline (mxu/vpu) can saturate before issue does;
  * Fig.3: cache pollution enters through KernelProfile's working-set ->
    hit-fraction discount (cache shared proportionally to working sets).

Capacity scaling: `slot_fraction` models SM partitioning (green contexts /
CUDA_MPS_ACTIVE_THREAD_PERCENTAGE): per-slot axes (mxu/vpu/issue/smem)
scale with the slot share; device-wide axes (hbm/l2/ici) do NOT — exactly
the distinction the paper draws in §4.3.  A fraction at or below
`FRACTION_FLOOR` excludes the member entirely (no demand, no slots,
slowdown +inf), and slot feasibility scales each member's slot need by
its fraction.

Batch execution: the solver is written over dense (scenarios x kernels x
axes) NumPy arrays, so `estimate_batch` solves thousands of colocation
scenarios in one vectorized pass — cheap enough for the scheduling hot
path (the planner's full pairwise matrix, sensitivity sweeps). The scalar
`estimate` is a batch of one, so both paths are numerically identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backend import get_solver_backend
from repro_torch.core.profile import (KernelProfile, ProfileMatrix,
                                WorkloadProfile, effective_demand_arrays,
                                isolated_time_arrays, utilization_arrays)
from repro_torch.core.resources import AXIS_INDEX, RESOURCE_AXES, DeviceModel
from repro_torch.core.scenario import Scenario, compile_scenarios, scenario_device

PER_SLOT_AXES = ("mxu", "vpu", "issue", "smem")
DEVICE_AXES = ("hbm", "l2", "ici")

# ---- solver floor/tolerance constants (named, so that a second solver
# backend can share them instead of inlining the literals) ---- #
CAP_REMAIN_FLOOR = 1e-9     # floor on a freeze-round's remaining capacity
OVERSUB_RTOL = 1e-9         # an axis is oversubscribed iff load > 1 + this
DEMAND_EPS = 1e-12          # min worst-axis demand to count as an axis user
RATIO_FLOOR = 1e-30         # smem equal-throttle divisor floor (keeps the
                            # vector-wide division defined for done rows)
TIME_EPS = 1e-12            # isolated-time floor in the slowdown ratio
SPEED_FLOOR = 1e-9          # water-filled speed floor in 1/s terms

# f -> 0 semantics: a slot fraction at or below this floor means the
# member is ABSENT (a green context with no slots): it contributes no
# demand, occupies no slots, and its own slowdown is +inf — it makes no
# progress.  Live members keep the documented capacity-scaling behavior;
# the matching 1e-6 clamp inside the solver merely keeps the vectorized
# division defined and can never bite a live member.  (Before this floor
# was defined, a fraction of exactly 0 got ~1e6x inflated demand instead
# of being treated as absent — the k-way fraction search relies on the
# exclusion semantics.)
FRACTION_FLOOR = 1e-6

_N_AXES = len(RESOURCE_AXES)
_PER_SLOT_IDX = np.array([AXIS_INDEX[r] for r in PER_SLOT_AXES])
_SMEM = AXIS_INDEX["smem"]


@dataclass
class ColocationResult:
    speeds: Dict[str, float]            # kernel name -> speed (<=1)
    slowdowns: Dict[str, float]         # kernel name -> 1/speed
    bottleneck: Dict[str, str]          # kernel name -> axis that froze it
    axis_load: Dict[str, float]         # total demanded load per axis
    feasible_slots: bool = True

    def slowdown(self, name: str) -> float:
        return self.slowdowns[name]


@dataclass
class BatchResult:
    """Struct-of-arrays result of one batched solve (padded to the widest
    scenario; `mask` marks real members). Hot-path consumers (planner,
    sensitivity sweeps) read the arrays directly; `result(i)` materializes
    the dict-based ColocationResult view of scenario i."""
    names: Optional[List[List[str]]]    # member names (None when solved
                                        # on the array-only hot path)
    mask: np.ndarray                    # (S, K) bool
    speeds: np.ndarray                  # (S, K)
    slowdowns: np.ndarray               # (S, K)
    bottleneck: np.ndarray              # (S, K) axis index, -1 = none
    axis_load: np.ndarray               # (S, A)
    feasible_slots: np.ndarray          # (S,) bool

    def __len__(self) -> int:
        return len(self.mask)

    def result(self, i: int) -> ColocationResult:
        assert self.names is not None, \
            "solved without names: read the arrays directly"
        ns = self.names[i]
        return ColocationResult(
            speeds={n: float(self.speeds[i, j]) for j, n in enumerate(ns)},
            slowdowns={n: float(self.slowdowns[i, j])
                       for j, n in enumerate(ns)},
            bottleneck={n: (RESOURCE_AXES[b] if (b := int(
                self.bottleneck[i, j])) >= 0 else "none")
                for j, n in enumerate(ns)},
            axis_load={r: float(self.axis_load[i, a])
                       for r, a in AXIS_INDEX.items()},
            feasible_slots=bool(self.feasible_slots[i]),
        )

    def results(self) -> List[ColocationResult]:
        return [self.result(i) for i in range(len(self))]


# queueing inflation: near-saturated ISSUE slots delay every co-runner's
# instructions even when its own demand fits in the leftover (paper Table 2
# knee; calibrated there, validated out-of-sample on pitfall 2). Mild HBM
# latency inflation mirrors Table 1's sub-saturation slowdowns.
_INFLATION = {"issue": (1.05, 4), "hbm": (0.10, 4)}
_INFLATION_MIN_UTIL = 0.01   # below: too small a user to queue behind others
_INFLATION_MAJORITY = 0.5    # at/above this share of the axis load the
                             # kernel is the fluid-limited majority owner


def _gather(pm: ProfileMatrix, members, fractions, mask=None):
    """Pad scenarios to (S, K[, A]) dense arrays; padded rows are zeroed
    so masked sums/maxes are no-ops. An ndarray `members` means padded
    dense width — no padding loop (the planner's hot path); `mask` marks
    the real members (None = every entry real, the uniform-width case)."""
    if isinstance(members, np.ndarray):
        idx = members
        mask = (np.ones(idx.shape, bool) if mask is None
                else np.asarray(mask, bool))
        frac = (np.asarray(fractions, np.float64) if fractions is not None
                else np.ones(idx.shape, np.float64))
        # padded entries carry frac 1.0 so the slot-scale division is a
        # no-op on them (compile_scenarios pads this way already; guard
        # direct callers handing their own mask + fraction arrays)
        if not mask.all():
            frac = np.where(mask, frac, 1.0)
    else:
        S = len(members)
        K = max(len(m) for m in members)
        idx = np.zeros((S, K), np.int64)
        mask = np.zeros((S, K), bool)
        frac = np.ones((S, K), np.float64)
        for s, (m, f) in enumerate(zip(members, fractions)):
            idx[s, :len(m)] = m
            mask[s, :len(m)] = True
            frac[s, :len(m)] = f
    demand = pm.demand[idx] * mask[:, :, None]
    duration = pm.duration[idx] * mask
    ws = pm.cache_working_set[idx] * mask
    hit = pm.cache_hit_fraction[idx] * mask
    slots = pm.slots_needed[idx] * mask
    return idx, mask, frac, demand, duration, ws, hit, slots


def solve_batch(pm: ProfileMatrix, members, dev: DeviceModel,
                fractions=None, names: Optional[List[List[str]]] = None,
                *, mask=None) -> BatchResult:
    """Vectorized core: solve S colocation scenarios, each a list of row
    indices into `pm` (or a padded dense (S, K) ndarray with an optional
    bool `mask` marking real members — no mask means every entry is
    real), with optional per-member slot fractions. `names` feeds the
    dict-view `result(i)`; array-only consumers may omit it.

    Executes on the active solver backend (`repro_torch.core.backend`):
    the NumPy oracle below, or the f64 PyTorch port
    (`repro_torch.core.estimator_torch`) on the backend's device —
    identical results at 1e-9."""
    if len(members) == 0:
        z2 = np.zeros((0, 0))
        return BatchResult(names if names is not None else [],
                           np.zeros((0, 0), bool), z2, z2,
                           np.zeros((0, 0), np.int64),
                           np.zeros((0, _N_AXES)), np.zeros(0, bool))
    if fractions is None and not isinstance(members, np.ndarray):
        fractions = [[1.0] * len(m) for m in members]
    if names is None and not isinstance(members, np.ndarray):
        names = [[pm.names[i] for i in m] for m in members]
    _, mask, frac, demand, duration, ws, hit, slots = _gather(
        pm, members, fractions, mask)
    S, K = mask.shape
    if K > 0 and get_solver_backend() == "torch":
        from repro_torch.core import estimator_torch
        speeds, slowdowns, frozen, axis_load, feasible = \
            estimator_torch.solve_gathered(mask, frac, demand, duration, ws,
                                           hit, slots, dev)
        return BatchResult(names, mask, speeds, slowdowns, frozen,
                           axis_load, feasible)
    # members at or below the exclusion floor are absent (see
    # FRACTION_FLOOR): zero their inputs so they neither contend nor
    # occupy slots; their own slowdown is patched to +inf at the end
    excluded = mask & (frac <= FRACTION_FLOOR)
    present = mask & ~excluded
    if excluded.any():
        demand = np.where(present[:, :, None], demand, 0.0)
        duration = np.where(present, duration, 0.0)
        ws = np.where(present, ws, 0.0)
        hit = np.where(present, hit, 0.0)
        slots = np.where(present, slots, 0.0)
    if K == 0:                    # every scenario empty: nothing contends
        z = np.zeros((S, 0))
        return BatchResult(names, mask, z, z, np.zeros((S, 0), np.int64),
                           np.zeros((S, _N_AXES)), np.ones(S, bool))
    cap_vec = dev.capacity_vector()

    # cache model: isolated residency is proportional (min(1, C/ws));
    # colocated STREAMING residency has a thrash cliff — once the combined
    # working set exceeds capacity, interleaved streams evict each other
    # before reuse (paper Fig. 3's 16MB peak), so hits collapse.
    cache_cap = dev.cache_capacity
    total_ws = ws.sum(1)
    resident_col = np.where(total_ws > cache_cap, 0.0, 1.0)
    nk = present.sum(1)
    has_ws = ws > 0
    share = np.where(
        has_ws & (nk[:, None] > 1), resident_col[:, None],
        np.where(has_ws, np.minimum(1.0, cache_cap / np.maximum(ws, 1.0)),
                 1.0))

    eff_col = effective_demand_arrays(demand, ws, hit, cache_cap, share)
    t_col = isolated_time_arrays(eff_col, duration, cap_vec)
    eff_iso = effective_demand_arrays(demand, ws, hit, cache_cap,
                                      np.ones_like(share))
    t_iso = isolated_time_arrays(eff_iso, duration, cap_vec)
    u = utilization_arrays(eff_col, t_col, cap_vec)
    # restricting a kernel to a slot fraction: per-slot axes capacity
    # seen by that kernel shrinks -> its relative demand grows.  Live
    # fractions are > FRACTION_FLOOR (smaller ones were excluded above),
    # so the clamp only keeps the division defined for excluded rows.
    slot_scale = np.where(frac < 1.0, np.maximum(frac, FRACTION_FLOOR), 1.0)
    u[:, :, _PER_SLOT_IDX] = u[:, :, _PER_SLOT_IDX] / slot_scale[:, :, None]

    axis_load = u.sum(1)

    # per-axis max-min water-filling: on each oversubscribed axis, only
    # kernels demanding MORE than the fair rate are throttled (a 0.14-IPC
    # copy keeps its slots next to a 3.99-IPC hog; both hogs split evenly).
    # All scenarios advance one freeze-round per iteration; finished ones
    # are masked out by `done`.
    speeds = np.ones((S, K))
    active = present.copy()
    frozen = np.full((S, K), -1, np.int64)
    used = np.zeros((S, _N_AXES))
    done = np.zeros(S, bool)
    rows = np.arange(S)
    for _ in range(K + _N_AXES):
        dem = (u * (speeds * active)[:, :, None]).sum(1)
        cap_rem = np.maximum(1.0 - used, CAP_REMAIN_FLOOR)
        ratio = dem / cap_rem
        worst = ratio.argmax(1)
        worst_ratio = ratio[rows, worst]
        done |= worst_ratio <= 1.0 + OVERSUB_RTOL
        if done.all():
            break
        live = ~done
        u_w = np.take_along_axis(u, worst[:, None, None], axis=2)[:, :, 0]
        d = speeds * u_w

        # smem: bank-conflict serialization throttles EVERY user equally
        # (paper Fig. 4: even low-smem-util GEMMs slow down)
        is_smem = live & (worst == _SMEM)
        if is_smem.any():
            users = active & (d > DEMAND_EPS) & is_smem[:, None]
            # only consumed where is_smem (worst_ratio > 1); the floor just
            # keeps the vector-wide division defined for finished scenarios
            s_eq = 1.0 / np.maximum(worst_ratio, RATIO_FLOOR)
            speeds = np.where(users, speeds * s_eq[:, None], speeds)
            used += (u * (speeds * users)[:, :, None]).sum(1)
            frozen = np.where(users, _SMEM, frozen)
            active &= ~users

        # max-min rate cap theta on worst_axis: sum min(d_n, theta) = cap.
        # Sort eligible demands ascending; theta is the first even share
        # breached after granting all smaller demands in full.
        is_mm = live & (worst != _SMEM)
        if is_mm.any():
            elig = active & (d > DEMAND_EPS) & is_mm[:, None]
            cap_w = cap_rem[rows, worst]
            ds = np.where(elig, d, np.inf)
            order = np.sort(ds, axis=1)
            finite = np.isfinite(order)
            vals = np.where(finite, order, 0.0)
            csum = np.cumsum(vals, axis=1)
            m = elig.sum(1)
            pos = np.arange(K)[None, :]
            even = (cap_w[:, None] - (csum - vals)) / np.maximum(
                m[:, None] - pos, 1)
            breach = finite & (order > even) & (pos < m[:, None])
            has_theta = breach.any(1) & is_mm
            theta = even[rows, breach.argmax(1)]
            # no breach -> every user fits under the fair share: nothing
            # left to throttle in this scenario
            done |= is_mm & ~has_theta
            throttled = elig & has_theta[:, None] & (d > theta[:, None])
            speeds = np.where(throttled,
                              speeds * (theta[:, None]
                                        / np.where(d > 0, d, 1.0)),
                              speeds)
            used += (u * (speeds * throttled)[:, :, None]).sum(1)
            frozen = np.where(throttled, worst[:, None], frozen)
            active &= ~throttled

    # queueing inflation on near-saturated latency-sensitive axes: applies
    # to MINORITY users of the axis (the majority owner is fluid-limited)
    base = (t_col / np.maximum(t_iso, TIME_EPS)) / np.maximum(speeds,
                                                              SPEED_FLOOR)
    infl = np.ones((S, K))
    for axis, (gamma, p) in _INFLATION.items():
        ai = AXIS_INDEX[axis]
        u_ax = u[:, :, ai]
        rho = np.minimum(1.0, (speeds * u_ax).sum(1))
        skip = ((frozen == ai) | (u_ax <= _INFLATION_MIN_UTIL)
                | (u_ax >= _INFLATION_MAJORITY
                   * np.maximum(rho, SPEED_FLOOR)[:, None]))
        infl += np.where(~skip & present, gamma * rho[:, None] ** p, 0.0)
    slowdowns = base * infl
    if excluded.any():
        speeds = np.where(excluded, 0.0, speeds)
        slowdowns = np.where(excluded, np.inf, slowdowns)

    # slot feasibility is fraction-aware: a partitioned member occupies
    # only its slice of the SM partition, so its slot need scales with
    # its fraction (excluded members were already zeroed above)
    tot_slots = (slots * np.minimum(frac, 1.0)).sum(1)
    return BatchResult(
        names=names,
        mask=mask,
        speeds=speeds,
        slowdowns=slowdowns,
        bottleneck=frozen,
        axis_load=axis_load,
        feasible_slots=(tot_slots <= dev.n_slots) | (tot_slots == 0),
    )


def solve_scenarios(scenarios: Sequence[Scenario],
                    dev: Optional[DeviceModel] = None) -> BatchResult:
    """Solve a batch of `Scenario` objects (the shared query currency —
    see repro_torch.core.scenario) in one vectorized pass.

    Members are ordered victims-first, so scenario ``s``'s victim
    slowdowns are ``result.slowdowns[s, :scenarios[s].n_victims]``.
    Results are positional, so duplicate kernel names (or the same
    profile colocated with itself) are fine — unlike the name-keyed
    `estimate_batch`.
    """
    scenarios = list(scenarios)
    if not scenarios:
        # dev is irrelevant for an empty batch; solve_batch returns the
        # canonical empty BatchResult before ever touching it
        return solve_batch(ProfileMatrix.from_profiles([]), [], dev)
    dev = scenario_device(scenarios, dev)
    comp = compile_scenarios(scenarios)
    return solve_batch(comp.pm, comp.members, dev, comp.fractions,
                       mask=comp.mask)


def _compile_scenarios(scenarios: Sequence[Sequence[KernelProfile]],
                       slot_fractions: Optional[
                           Sequence[Optional[Dict[str, float]]]]):
    """Dedup profiles by identity into one ProfileMatrix + index lists."""
    row_of: Dict[int, int] = {}
    profiles: List[KernelProfile] = []
    members: List[List[int]] = []
    fractions: List[List[float]] = []
    names: List[List[str]] = []
    if slot_fractions is None:
        slot_fractions = [None] * len(scenarios)
    for sc, sf in zip(scenarios, slot_fractions):
        sf = sf or {}
        m, f, ns = [], [], []
        for k in sc:
            r = row_of.get(id(k))
            if r is None:
                r = row_of[id(k)] = len(profiles)
                profiles.append(k)
            m.append(r)
            f.append(sf.get(k.name, 1.0))
            ns.append(k.name)
        if len(set(ns)) != len(ns):
            # name-keyed results cannot represent duplicate members (the
            # seed silently collapsed them into one kernel); the
            # positional solve_batch API handles same-profile colocation
            raise ValueError(f"duplicate kernel names in scenario: {ns}")
        members.append(m)
        fractions.append(f)
        names.append(ns)
    return ProfileMatrix.from_profiles(profiles), members, fractions, names


def estimate_batch(scenarios: Sequence[Sequence[KernelProfile]],
                   dev: DeviceModel,
                   slot_fractions: Optional[
                       Sequence[Optional[Dict[str, float]]]] = None
                   ) -> List[ColocationResult]:
    """Solve many colocation scenarios in one vectorized pass.

    scenarios[i] is the kernel set of scenario i; slot_fractions[i] is its
    optional per-kernel-name slot-fraction dict (see `estimate`). Returns
    one ColocationResult per scenario, identical to calling `estimate` on
    each scenario individually.

    Kernel names must be unique within a scenario (results are keyed by
    name). To colocate several instances of the same profile, use
    `solve_batch` with repeated row indices — one row per instance.
    """
    if not len(scenarios):
        return []
    if slot_fractions is not None and len(slot_fractions) != len(scenarios):
        raise ValueError(
            f"slot_fractions has {len(slot_fractions)} entries for "
            f"{len(scenarios)} scenarios")
    pm, members, fractions, names = _compile_scenarios(
        scenarios, slot_fractions)
    return solve_batch(pm, members, dev, fractions, names).results()


def estimate(kernels: Sequence[KernelProfile], dev: DeviceModel,
             slot_fraction: Optional[Dict[str, float]] = None
             ) -> ColocationResult:
    """Steady-state speeds + total slowdowns for concurrent kernels.

    slowdown_k = (t_col_k / t_iso_k) / s_k x inflation, where t_col uses
    the COLOCATED cache share (pollution grows demand), s_k is the
    water-filled speed, and inflation is the near-saturation queueing term.

    Thin wrapper over `estimate_batch` with a single scenario — the batch
    path is the only solver, so scalar and batched results are identical.
    """
    return estimate_batch([list(kernels)], dev, [slot_fraction])[0]


def pairwise_slowdown(a: KernelProfile, b: KernelProfile, dev: DeviceModel,
                      slot_fraction: Optional[Dict[str, float]] = None
                      ) -> Tuple[float, float]:
    r = estimate([a, b], dev, slot_fraction)
    return r.slowdown(a.name), r.slowdown(b.name)


def colocation_speedup(a: KernelProfile, b: KernelProfile,
                       dev: DeviceModel) -> float:
    """Paper Table 3 metric: sequential time / colocated makespan."""
    ta, tb = a.isolated_time(dev), b.isolated_time(dev)
    r = estimate([a, b], dev)
    # fluid makespan: run colocated until the shorter finishes, remainder solo
    ra = ta / max(r.speeds[a.name], 1e-9)
    rb = tb / max(r.speeds[b.name], 1e-9)
    first = min(ra, rb)
    if ra <= rb:
        done_frac = first * r.speeds[b.name] / tb
        makespan = first + (1 - done_frac) * tb
    else:
        done_frac = first * r.speeds[a.name] / ta
        makespan = first + (1 - done_frac) * ta
    return (ta + tb) / makespan


def workload_slowdown(w: WorkloadProfile, others: Sequence[KernelProfile],
                      dev: DeviceModel,
                      slot_fraction: Optional[Dict[str, float]] = None
                      ) -> float:
    """Average slowdown of workload `w` when each of its kernels runs
    against the (steady) background kernels — per-kernel granularity.
    One `Scenario` per kernel of `w` (victim = the kernel, background =
    the steady co-runners), solved positionally in one batch so a kernel
    sharing a background kernel's name still contends physically instead
    of tripping the name-keyed API's duplicate check."""
    others = tuple(others)
    if not w.kernels:
        return 0.0      # seed semantics: 0-time workload -> 0/1e-12
    br = solve_scenarios([Scenario((k,), others, slot_fraction)
                          for k in w.kernels], dev)
    tot_iso = tot_col = 0.0
    for k, slow in zip(w.kernels, br.slowdowns[:, 0]):
        t = k.isolated_time(dev) * k.duration_weight
        tot_iso += t
        tot_col += t * float(slow)
    return tot_col / max(tot_iso, 1e-12)
