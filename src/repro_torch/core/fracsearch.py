"""k-way slot-fraction search (paper §5.3: green-context provisioning).

The paper argues that slot partitioning is the lever that turns
SLO-violating colocations into feasible ones — but *which* fractions to
grant each member is a search problem, not a lookup: iGniter-style
interference-aware provisioning needs the whole fraction vector, and a
fixed first-member grid (the legacy ``_PARTITION_FRACTIONS`` sweep)
explores a single ray of the simplex.

This module is that search:

  * ``simplex_candidates(k, steps)`` enumerates the coarse grid — every
    fraction vector ``(a_1/m, ..., a_k/m)`` with positive integer parts
    summing to ``m``, in lexicographic order.  For ``k=2, steps=4`` this
    is exactly the legacy pair grid ``f ∈ {0.25, 0.5, 0.75}`` (first
    member ascending), so a coarse-only search reproduces the seed
    planner bit-for-bit.
  * ``refinement_candidates`` is the sensitivity-guided local step:
    around the best coarse point, move a half-grid-step of slot share
    toward the member that dominates the group — the makespan owner
    (``time x slowdown`` argmax) when the point is feasible, the most
    SLO-violating member when it is not.  One candidate per donor.
  * ``search_group_fractions`` prices MANY groups at once: every
    (group × fraction-vector × member-kernel) probe is compiled into one
    deduplicated ``solve_scenarios`` pass per search phase (coarse, then
    one pass per refinement level), so the scheduler can fraction-search
    a whole arrival row of SLO-failing pairs in two or three batched
    solves.

Selection rule (shared with ``evaluate_group_partitioned`` and the
scheduler's pair pricing, and pinned bit-identical by tests): among
feasible candidates the max gain wins, earliest candidate on ties; with
no feasible candidate the least-violating one (min over candidates of
``max_i slowdown_i / slo_i``) anchors the next refinement level and is
returned with ``meets_slo=False``.  ANY feasible partition beats an
infeasible full-share placement — the legacy ``gain > 0`` comparison
discarded feasible partitions with non-positive gain.

Fraction semantics follow the estimator contract: fractions bind to
kernels BY NAME (a member kernel is restricted only when its name equals
the workload's name; the representative background kernels always are),
members at or below ``FRACTION_FLOOR`` are absent, and a group's
fractions always sum to exactly 1 (coarse vectors by construction,
refinement moves preserve the sum).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.estimator import FRACTION_FLOOR, solve_scenarios
from repro_torch.core.profile import KernelProfile, WorkloadProfile
from repro_torch.core.resources import DeviceModel
from repro_torch.core.scenario import group_victim_scenarios


@dataclass(frozen=True)
class FractionSearchConfig:
    """Knobs of the k-way fraction search.

    coarse_steps: resolution 1/m of the coarse simplex grid for pairs;
        larger groups automatically refine to ``max(m, k + 2)`` steps so
        the grid has more than the uniform point.  The default (8) is a
        strict superset of the legacy pair grid (4 -> f in {.25,.5,.75})
        and flips real SLO-violating pairs to feasible that the fixed
        grid misses (pinned by tests).
    refine_levels: sensitivity-guided local passes around the best
        coarse point; level r moves slot share in steps of 1/(m 2^r).
        0 = coarse grid only (the legacy fixed-grid behavior at k=2).
    grow_partitioned: let the scheduler grow partitioned pairs into
        partitioned k-way groups (re-searching fractions per candidate).
    """
    coarse_steps: int = 8
    refine_levels: int = 1
    grow_partitioned: bool = True

    def __post_init__(self):
        if self.coarse_steps < 2:
            raise ValueError("coarse_steps must be >= 2")
        if self.refine_levels < 0:
            raise ValueError("refine_levels must be >= 0")

    def steps_for(self, k: int) -> int:
        return max(self.coarse_steps, k + 2)

    @classmethod
    def default(cls) -> "FractionSearchConfig":
        """The search config for the ACTIVE solver backend: the standard
        8-step grid on numpy, `DENSE_SEARCH` on torch — as the reference
        widens the grid for its jitted solver at unchanged latency budgets.
        Resolved at call time, so switch the backend before constructing
        schedulers."""
        from repro_torch.core.backend import get_solver_backend
        return DENSE_SEARCH if get_solver_backend() == "torch" else cls()


# coarse-only, no partitioned growth: bit-for-bit the legacy fixed
# first-member grid at k=2
LEGACY_SEARCH = FractionSearchConfig(coarse_steps=4, refine_levels=0,
                                     grow_partitioned=False)

# a fast solver's default: 16ths keep the 8-step grid AND its level-1
# refinement points (which land on 16ths) as a strict subset, so the
# dense search's selected gain can never regress the standard config's;
# the extra refine level then explores 64ths around the winner.
DENSE_SEARCH = FractionSearchConfig(coarse_steps=16, refine_levels=2)


@dataclass
class GroupFractions:
    """Best fraction assignment found for one group."""
    fractions: Tuple[float, ...]        # per member, in group order; sum == 1
    gain: float                         # packed gain at these fractions
    meets_slo: bool
    slowdowns: Dict[str, float]         # member name -> workload slowdown


def group_metrics(times: Sequence[float], slows: Sequence[float],
                  slos: Sequence[float]) -> Tuple[float, bool]:
    """THE definition of a placement's packed gain (serial time /
    colocated makespan) and SLO feasibility, for any group size.
    `evaluate_group`, the scheduler's batched group pricing, and the
    fraction search all call it; the scheduler's `_pair_metrics` is its
    vectorized two-member twin — keep them in lockstep."""
    serial = sum(times)
    makespan = max((t * r for t, r in zip(times, slows)), default=0.0)
    gain = serial / max(makespan, 1e-12)
    meets = all(r <= s for r, s in zip(slows, slos))
    return float(gain), bool(meets)


def member_slowdowns(members: Sequence[WorkloadProfile], dev: DeviceModel,
                     victim_slowdowns: np.ndarray) -> Dict[str, float]:
    """Fold per-kernel victim slowdowns (in ``group_victim_scenarios``
    order) into per-member workload slowdowns: duration-weighted mean
    over the member's kernels (0-time members -> 0.0, seed semantics)."""
    slows: Dict[str, float] = {}
    row = 0
    for w in members:
        tot_iso = tot_col = 0.0
        for k in w.kernels:
            t = k.isolated_time(dev) * k.duration_weight
            tot_iso += t
            tot_col += t * float(victim_slowdowns[row])
            row += 1
        slows[w.name] = tot_col / max(tot_iso, 1e-12)
    return slows


def simplex_candidates(k: int, steps: int) -> List[Tuple[float, ...]]:
    """All fraction vectors (a_1/steps, ..., a_k/steps) with integer
    a_i >= 1 summing to `steps`, lexicographically ascending.  C(steps-1,
    k-1) vectors; for k=2, steps=4 exactly the legacy pair grid."""
    if k < 1:
        raise ValueError("group size must be >= 1")
    if steps < k:
        raise ValueError(f"steps={steps} cannot split into {k} positive parts")
    out: List[Tuple[float, ...]] = []

    def rec(prefix: List[int], remaining: int, slots: int):
        if slots == 1:
            out.append(tuple((a / steps) for a in prefix + [remaining]))
            return
        for a in range(1, remaining - (slots - 1) + 1):
            rec(prefix + [a], remaining - a, slots - 1)

    rec([], steps, k)
    return out


def refinement_candidates(best: Sequence[float], times: Sequence[float],
                          slows: Sequence[float], slos: Sequence[float],
                          meets: bool, delta: float
                          ) -> List[Tuple[float, ...]]:
    """Sensitivity-guided neighbors of `best`: transfer `delta` of slot
    share toward the group's binding member — the makespan owner
    (argmax time x slowdown) when feasible, the worst SLO violator
    (argmax slowdown/slo) when not — from each other member in turn.
    Moves that would push a donor to (or below) the exclusion floor are
    skipped, so every candidate keeps all members present and the
    fractions summing to exactly 1."""
    k = len(best)
    if k < 2:
        return []
    load = [t * r for t, r in zip(times, slows)]
    viol = [r / max(s, 1e-12) for r, s in zip(slows, slos)]
    recv = int(np.argmax(load)) if meets else int(np.argmax(viol))
    cands: List[Tuple[float, ...]] = []
    for donor in range(k):
        if donor == recv or best[donor] - delta <= FRACTION_FLOOR:
            continue
        vec = list(best)
        vec[donor] -= delta
        vec[recv] += delta
        cands.append(tuple(vec))
    return cands


# selection state per group: (feasible?, gain, max violation, result)
_Best = Tuple[bool, float, float, GroupFractions]


def _better(cand: _Best, cur: Optional[_Best]) -> bool:
    """Strict improvement: feasible beats infeasible; among feasible,
    strictly higher gain; among infeasible, strictly lower violation.
    Strictness keeps the EARLIEST candidate on ties (the legacy grid's
    first-max rule, and what makes the search order-deterministic)."""
    if cur is None:
        return True
    if cand[0] != cur[0]:
        return cand[0]
    return (cand[1] > cur[1]) if cand[0] else (cand[2] < cur[2])


def _price_candidates(groups: Sequence[Sequence[WorkloadProfile]],
                      cands_per_group: Sequence[Sequence[Tuple[float, ...]]],
                      dev: DeviceModel,
                      reps: Mapping[str, KernelProfile],
                      stats: Optional[Dict[str, int]]
                      ) -> List[List[_Best]]:
    """One deduplicated solve over every (group x fraction-vector x
    member-kernel) probe; returns per-group, per-candidate metrics."""
    scenarios = []
    spans: List[Tuple[int, int]] = []       # (group index, candidate index)
    for gi, (group, cands) in enumerate(zip(groups, cands_per_group)):
        names = [w.name for w in group]
        for ci, vec in enumerate(cands):
            sf = dict(zip(names, vec))
            scenarios.extend(group_victim_scenarios(group, reps, sf))
            spans.append((gi, ci))
    if stats is not None:
        stats["scenarios_solved"] = (stats.get("scenarios_solved", 0)
                                     + len(scenarios))
    br = solve_scenarios(scenarios, dev)
    out: List[List[_Best]] = [[] for _ in groups]
    row = 0
    for gi, ci in spans:
        group = groups[gi]
        n_rows = sum(len(w.kernels) for w in group)
        slows = member_slowdowns(group, dev,
                                 br.slowdowns[row:row + n_rows, 0])
        row += n_rows
        times = [w.total_time(dev) for w in group]
        slos = [w.slo_slowdown for w in group]
        svec = [slows[w.name] for w in group]
        gain, meets = group_metrics(times, svec, slos)
        viol = max((r / max(s, 1e-12) for r, s in zip(svec, slos)),
                   default=0.0)
        out[gi].append((meets, gain, viol, GroupFractions(
            cands_per_group[gi][ci], gain, meets, slows)))
    return out


def search_group_fractions(groups: Sequence[Sequence[WorkloadProfile]],
                           dev: DeviceModel,
                           config: Optional[FractionSearchConfig] = None,
                           reps: Optional[Mapping[str, KernelProfile]] = None,
                           candidates: Optional[
                               Sequence[Sequence[Tuple[float, ...]]]] = None,
                           stats: Optional[Dict[str, int]] = None
                           ) -> List[GroupFractions]:
    """Best slot-fraction vector for every group, batched.

    groups: workload groups (size >= 2) to search independently.
    reps: shared name -> representative-kernel cache (recomputed when
        omitted — callers holding memoized reps pass them in).
    candidates: explicit per-group fraction vectors; when given, only
        those are priced and NO refinement runs (the legacy first-member
        grid path of ``evaluate_group_partitioned(fractions=...)``).
    stats: optional counter dict; "scenarios_solved" is incremented by
        every estimator scenario the search prices (the scheduler's
        O(n)-per-arrival accounting).

    Returns one GroupFractions per group: the feasible max-gain
    assignment, or (``meets_slo=False``) the least-SLO-violating one.
    """
    cfg = config or FractionSearchConfig.default()
    groups = [list(g) for g in groups]
    for g in groups:
        if len(g) < 2:
            raise ValueError("fraction search needs groups of >= 2 members")
    if reps is None:
        reps = {w.name: w.representative_kernel(dev)
                for g in groups for w in g}

    if candidates is not None:
        cands = [list(c) for c in candidates]
        refine = 0
    else:
        grids: Dict[int, List[Tuple[float, ...]]] = {}
        cands = []
        for g in groups:
            k = len(g)
            if k not in grids:
                grids[k] = simplex_candidates(k, cfg.steps_for(k))
            cands.append(grids[k])
        refine = cfg.refine_levels

    best: List[Optional[_Best]] = [None] * len(groups)
    priced = _price_candidates(groups, cands, dev, reps, stats)
    for gi, results in enumerate(priced):
        for cand in results:
            if _better(cand, best[gi]):
                best[gi] = cand
    for gi in range(len(groups)):
        if best[gi] is None:        # empty candidate list: nothing priced
            best[gi] = (False, float("-inf"), float("inf"),
                        GroupFractions((), float("-inf"), False, {}))

    for level in range(1, refine + 1):
        refine_cands: List[List[Tuple[float, ...]]] = []
        for gi, g in enumerate(groups):
            meets, _, _, res = best[gi]
            if not res.fractions:
                refine_cands.append([])
                continue
            delta = 1.0 / (cfg.steps_for(len(g)) * (2 ** level))
            refine_cands.append(refinement_candidates(
                res.fractions, [w.total_time(dev) for w in g],
                [res.slowdowns[w.name] for w in g],
                [w.slo_slowdown for w in g], meets, delta))
        if not any(refine_cands):
            break
        priced = _price_candidates(groups, refine_cands, dev, reps, stats)
        for gi, results in enumerate(priced):
            for cand in results:
                if _better(cand, best[gi]):
                    best[gi] = cand

    return [b[3] for b in best]
