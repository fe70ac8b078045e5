"""Interference-aware colocation scheduling (paper §5.1), online.

The public API is the stateful ``ColocationScheduler``: workloads
``submit()`` and ``remove()`` as they arrive and leave, and ``plan()``
returns the current SLO-feasible placement set.  The scheduler is
*incremental* — it keeps the pairwise price matrix (and k-way group
prices) cached across events, so

  * an arrival prices only the NEW workload's row — O(n) estimator
    scenarios, not a full O(n^2) re-price;
  * a departure never re-prices a pair: its rows are dropped and its
    group's survivors fall back into the pool with their cached prices
    (with ``max_group_size > 2`` the replay may price never-seen group
    combinations — cached from then on; at k=2 a departure solves
    exactly zero estimator scenarios);
  * ``plan()`` replays the greedy selection over the cached matrix —
    pure array/heap work, no estimator solves for already-priced pairs —
    so an online trace always lands on exactly the placements a cold
    scheduler over the surviving set would produce.

Placements are **k-way** (``max_group_size``): the greedy rounds still
seed groups from the best feasible pair (gain desc, index-order
tie-break — the seed pairing order, bit-for-bit), then grow each group
one member at a time while the packed gain improves and every member
stays within its SLO; group candidates are priced by the batched
multi-kernel solver through the shared `Scenario` currency.

Slot partitioning (the green-context analogue, paper §5.3) runs the
k-way slot-fraction search (`repro_torch.core.fracsearch`) for SLO-violating
groups: coarse simplex fraction vectors plus a sensitivity-guided
refinement step, every (group x fraction-vector) candidate priced in one
deduplicated batched solve.  Partitioned pairs grow into partitioned
k-way groups the same way full-share pairs do (each candidate group
re-searches its fractions), with the best fractions cached in ``_group``
alongside the gains.  ``FractionSearchConfig`` tunes the search;
``LEGACY_SEARCH`` (coarse-only, no partitioned growth) reproduces the
seed planner's fixed first-member grid bit-for-bit.

``plan_colocation`` / ``evaluate_pair`` / ``evaluate_pair_partitioned``
remain as deprecated thin wrappers (a cold scheduler with
``max_group_size=2`` and ``LEGACY_SEARCH`` reproduces their output
exactly; pinned by tests).
"""
from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backend import warmup_solver
from repro_torch.core.estimator import FRACTION_FLOOR, solve_batch, solve_scenarios
from repro_torch.core.fracsearch import (LEGACY_SEARCH, FractionSearchConfig,
                                         group_metrics, member_slowdowns,
                                         search_group_fractions,
                                         simplex_candidates)
from repro_torch.core.profile import KernelProfile, ProfileMatrix, WorkloadProfile
from repro_torch.core.resources import DeviceModel
from repro_torch.core.scenario import Scenario, group_victim_scenarios

# the legacy pair grid — identical to the k=2 coarse simplex at 4 steps
# (kept as the deprecated `evaluate_pair_partitioned` shim's default)
_PARTITION_FRACTIONS = (0.25, 0.5, 0.75)
_PAIR_BLOCK = 16384          # pairs per batched solve: bounds peak memory


@dataclass
class Placement:
    workloads: List[str]
    slot_fraction: Dict[str, float]
    predicted_slowdown: Dict[str, float]
    meets_slo: bool
    throughput_gain: float       # vs running members serially

    def __repr__(self):
        mems = " + ".join(self.workloads)
        slow = ", ".join(f"{k}:{v:.2f}x" for k, v in self.predicted_slowdown.items())
        return (f"<Placement [{mems}] slow=({slow}) "
                f"gain={self.throughput_gain:.2f} slo_ok={self.meets_slo}>")


def _rep_kernel(w: WorkloadProfile, dev: DeviceModel) -> KernelProfile:
    """Time-weighted aggregate kernel used for quick pair screening."""
    return w.representative_kernel(dev)


def _pair_metrics(ta, tb, ra, rb, slo_a, slo_b):
    """Vectorized two-member `fracsearch.group_metrics` (array-of-pairs
    form) for _PairEvaluator's hot path — same floor, same comparisons."""
    gain = (ta + tb) / np.maximum(np.maximum(ta * ra, tb * rb), 1e-12)
    meets = (ra <= slo_a) & (rb <= slo_b)
    return gain, meets


# ------------------------------------------------------------------ #
#  Group evaluation (k >= 2): the scalar twin of the scheduler's       #
#  batched group pricing — shared member-slowdown/gain definitions     #
# ------------------------------------------------------------------ #
def evaluate_group(workloads: Sequence[WorkloadProfile], dev: DeviceModel,
                   slot_fraction: Optional[Dict[str, float]] = None
                   ) -> Placement:
    """Price one candidate group: every member's workload-level slowdown
    against the other members' representative kernels (one batched solve
    over the shared `group_victim_scenarios` probe set), packed gain =
    serial time / colocated makespan, SLO feasibility of all members.
    For two members this is exactly the legacy ``evaluate_pair``."""
    works = list(workloads)
    reps = {w.name: w.representative_kernel(dev) for w in works}
    scenarios = group_victim_scenarios(works, reps, slot_fraction)
    if scenarios:
        victim_slows = solve_scenarios(scenarios, dev).slowdowns[:, 0]
    else:
        victim_slows = np.zeros(0)
    slows = member_slowdowns(works, dev, victim_slows)
    gain, meets = group_metrics([w.total_time(dev) for w in works],
                                [slows[w.name] for w in works],
                                [w.slo_slowdown for w in works])
    return Placement([w.name for w in works], dict(slot_fraction or {}),
                     {n: float(s) for n, s in slows.items()}, meets, gain)


def evaluate_group_partitioned(workloads: Sequence[WorkloadProfile],
                               dev: DeviceModel,
                               fractions: Optional[Sequence[float]] = None,
                               *, search: Optional[FractionSearchConfig] = None
                               ) -> Placement:
    """Full sharing first, then slot partitions (green contexts) via the
    k-way slot-fraction search: coarse simplex fraction vectors plus a
    sensitivity-guided refinement step, all candidates priced in one
    deduplicated batched solve (`repro_torch.core.fracsearch`).

    ANY SLO-meeting partition beats an infeasible full-share placement,
    regardless of its gain (the legacy ``gain > 0`` comparison discarded
    feasible non-positive-gain partitions).

    ``fractions`` is the DEPRECATED legacy grid: explicit first-member
    fractions, the other members splitting the complement evenly, priced
    without refinement (what the ``evaluate_pair_partitioned`` shim
    forwards — bit-identical to the seed).  Tune the full search with
    ``search=FractionSearchConfig(...)`` instead.
    """
    works = list(workloads)
    best = evaluate_group(works, dev)
    if best.meets_slo:
        return best
    names = [w.name for w in works]
    if fractions is not None:
        rest = max(len(works) - 1, 1)
        cands = [[(f,) + ((1.0 - f) / rest,) * rest for f in fractions]]
        res = search_group_fractions([works], dev, LEGACY_SEARCH,
                                     candidates=cands)[0]
    else:
        res = search_group_fractions([works], dev, search)[0]
    if res.meets_slo:
        return Placement(names, dict(zip(names, map(float, res.fractions))),
                         {n: float(s) for n, s in res.slowdowns.items()},
                         True, float(res.gain))
    return best


# ------------------------------------------------------------------ #
#  Deprecated one-shot API (thin wrappers; see ColocationScheduler)    #
# ------------------------------------------------------------------ #
def evaluate_pair(a: WorkloadProfile, b: WorkloadProfile, dev: DeviceModel,
                  slot_fraction: Optional[Dict[str, float]] = None
                  ) -> Placement:
    """Deprecated: use ``evaluate_group([a, b], dev, slot_fraction)``."""
    warnings.warn("evaluate_pair is deprecated; use evaluate_group",
                  DeprecationWarning, stacklevel=2)
    return evaluate_group((a, b), dev, slot_fraction)


def evaluate_pair_partitioned(a: WorkloadProfile, b: WorkloadProfile,
                              dev: DeviceModel,
                              fractions: Sequence[float] = _PARTITION_FRACTIONS
                              ) -> Placement:
    """Deprecated: use ``evaluate_group_partitioned([a, b], dev)``."""
    warnings.warn("evaluate_pair_partitioned is deprecated; use "
                  "evaluate_group_partitioned", DeprecationWarning,
                  stacklevel=2)
    return evaluate_group_partitioned((a, b), dev, fractions)


class _PairEvaluator:
    """Batched pair evaluation over a fixed workload set — the dense
    array fast path of the `Scenario` currency (same victims-first
    member convention, no per-scenario Python objects on the O(n^2)
    pricing path).

    Compiles every workload kernel + representative background kernel into
    one ProfileMatrix and flat per-kernel arrays, so evaluating a block of
    pairs is pure array arithmetic: scenario (kernel_row, rep_row) index
    pairs come from a ragged gather over kernel counts, one `solve_batch`
    call prices them all, and workload-level slowdowns aggregate back with
    a segmented sum. No per-pair Python estimator work remains."""

    def __init__(self, works: Sequence[WorkloadProfile], dev: DeviceModel,
                 reps: Optional[Sequence[KernelProfile]] = None):
        self.works = list(works)
        self.dev = dev
        self.scenarios_solved = 0
        n = len(self.works)
        profiles: List[KernelProfile] = []
        counts, weights = [], []
        for w in self.works:
            counts.append(len(w.kernels))
            for k in w.kernels:
                profiles.append(k)
                weights.append(k.isolated_time(dev) * k.duration_weight)
        self.counts = np.asarray(counts, np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(self.counts[:-1])))
        self.kernel_weight = np.asarray(weights, np.float64)
        self.rep_rows = np.arange(n, dtype=np.int64) + len(profiles)
        # callers holding memoized representative kernels (the scheduler's
        # per-workload cache) pass them in; recomputing gives identical
        # profiles, just redundantly
        if reps is None:
            reps = [_rep_kernel(w, dev) for w in self.works]
        profiles.extend(reps)
        self.pm = ProfileMatrix.from_profiles(profiles)
        self.totals = np.asarray([w.total_time(dev) for w in self.works])
        self.slos = np.asarray([w.slo_slowdown for w in self.works])
        # slot-fraction dicts are keyed by KERNEL name (estimate()'s
        # contract): a member kernel only picks up a workload's fraction
        # if its name coincides with that workload's name — matching the
        # seed's evaluate_pair semantics exactly
        name_to_w = {w.name: wi for wi, w in enumerate(self.works)}
        self.kernel_name_w = np.asarray(
            [name_to_w.get(k.name, -1)
             for w in self.works for k in w.kernels], np.int64)

    def evaluate(self, ia: np.ndarray, ib: np.ndarray, frac=None):
        """Slowdowns/gain/SLO arrays for pairs (ia[p], ib[p]); `frac`
        gives workload ia a slot fraction and ib its own: a scalar f
        means (f, 1-f) — evaluate_pair's legacy convention — and a
        (fa, fb) pair of scalars or per-pair arrays prices an arbitrary
        fraction vector per pair (None = full sharing)."""
        P = len(ia)
        if frac is not None:
            fa, fb = (frac, 1.0 - frac) if np.isscalar(frac) else frac
            fa = np.broadcast_to(np.asarray(fa, np.float64), (P,))
            fb = np.broadcast_to(np.asarray(fb, np.float64), (P,))
            frac = (fa, fb)
        ra = np.empty(P)
        rb = np.empty(P)
        for lo in range(0, P, _PAIR_BLOCK):
            hi = min(lo + _PAIR_BLOCK, P)
            blk = None if frac is None else (frac[0][lo:hi], frac[1][lo:hi])
            ra[lo:hi], rb[lo:hi] = self._block(ia[lo:hi], ib[lo:hi], blk)
        gain, meets = _pair_metrics(self.totals[ia], self.totals[ib], ra, rb,
                                    self.slos[ia], self.slos[ib])
        return ra, rb, gain, meets

    def _probe_side(self, probed, other, frac_probed, frac_other):
        """Scenarios probing `probed`'s kernels against `other`'s rep.
        `frac_probed`/`frac_other` are per-pair arrays (or None)."""
        cnt = self.counts[probed]
        owner = np.repeat(np.arange(len(probed)), cnt)
        start = np.repeat(np.cumsum(cnt) - cnt, cnt)
        krow = np.repeat(self.offsets[probed], cnt) \
            + np.arange(cnt.sum()) - start
        members = np.stack([krow, np.repeat(self.rep_rows[other], cnt)], 1)
        if frac_probed is None:
            fr = None
        else:
            # the probed kernel matches the sf dict only by name identity
            kw = self.kernel_name_w[krow]
            fp = np.repeat(frac_probed, cnt)
            fo = np.repeat(frac_other, cnt)
            f0 = np.where(kw == np.repeat(probed, cnt), fp,
                          np.where(kw == np.repeat(other, cnt), fo, 1.0))
            fr = np.stack([f0, fo], 1)
        return members, fr, owner, self.kernel_weight[krow]

    def _block(self, ia, ib, frac):
        m_a, f_a, own_a, w_a = self._probe_side(
            ia, ib, *((None, None) if frac is None else frac))
        m_b, f_b, own_b, w_b = self._probe_side(
            ib, ia, *((None, None) if frac is None else (frac[1], frac[0])))
        members = np.concatenate([m_a, m_b])
        fractions = None if frac is None else np.concatenate([f_a, f_b])
        self.scenarios_solved += len(members)
        br = solve_batch(self.pm, members, self.dev, fractions)
        slow = br.slowdowns[:, 0] * np.concatenate([w_a, w_b])
        P = len(ia)
        na, nb = len(m_a), len(m_b)
        ra = np.bincount(own_a, slow[:na], minlength=P) \
            / np.maximum(self.totals[ia], 1e-12)
        rb = np.bincount(own_b, slow[na:na + nb], minlength=P) \
            / np.maximum(self.totals[ib], 1e-12)
        return ra, rb


@dataclass
class Plan:
    placements: List[Placement]
    solo: List[str]

    @property
    def total_gain(self) -> float:
        """Mean packed-throughput gain per occupied device: each placement
        contributes its members' predicted gain (serial time / colocated
        makespan), each solo workload contributes 1.0."""
        devices = len(self.placements) + len(self.solo)
        if devices == 0:
            return 1.0
        gains = sum(p.throughput_gain for p in self.placements)
        return (gains + len(self.solo)) / devices


# price tuples, ordered by the members' (stable) arrival positions:
# pair -> (slow_lo, slow_hi, gain, meets, frac_lo, frac_hi) with NaN
# fractions meaning full sharing; group -> (gain, meets, slows,
# fractions) with an empty fraction dict for full-share groups
_PairPrice = Tuple[float, float, float, bool, float, float]
_GroupPrice = Tuple[float, bool, Dict[str, float], Dict[str, float]]


class ColocationScheduler:
    """Online k-way interference-aware colocation scheduler.

    >>> sched = ColocationScheduler(dev, max_group_size=3)
    >>> sched.submit(decode); sched.submit(prefill)
    >>> plan = sched.plan()          # prices the new pairs, places
    >>> sched.remove("decode")       # zero estimator work
    >>> plan = sched.plan()          # replays greedy over cached prices

    SLO-violating pairs fall back to slot partitioning via the k-way
    fraction search (``fraction_search`` tunes it; see
    ``FractionSearchConfig``), and partitioned pairs grow into
    partitioned k-way groups exactly like full-share pairs do — each
    candidate group re-searches its fraction vector, cached in
    ``_group`` alongside the gain.

    Pricing is lazy: ``submit``/``remove`` are O(1) bookkeeping, and the
    next ``plan()`` prices exactly the pairs that have never been priced
    (one batched solve). ``stats["scenarios_solved"]`` counts estimator
    scenarios, the unit the O(n)-per-arrival guarantee is stated in
    (tracked by the churn benchmark).
    """

    def __init__(self, dev: DeviceModel, max_group_size: int = 2,
                 allow_partition: bool = True,
                 fraction_search: Optional[FractionSearchConfig] = None,
                 warmup: bool = False):
        if max_group_size < 2:
            raise ValueError("max_group_size must be >= 2")
        self.dev = dev
        self.max_group_size = int(max_group_size)
        self.allow_partition = allow_partition
        # default: backend-resolved (coarse simplex + 1 refinement level
        # on numpy; the denser DENSE_SEARCH grid on the torch backend);
        # LEGACY_SEARCH reproduces the seed's fixed grid
        self.search = fraction_search or FractionSearchConfig.default()
        if warmup:
            # opt-in capture of the torch solver's graphs for the common
            # shapes (K up to the group width this scheduler prices; no-op
            # on numpy and on the CPU)
            warmup_solver(dev, ks=range(2, self.max_group_size + 1))
        self._works: Dict[str, WorkloadProfile] = {}   # insertion-ordered
        self._uid: Dict[str, int] = {}
        self._next_uid = 0
        self._pair: Dict[Tuple[int, int], _PairPrice] = {}
        # keyed by (sorted member uids, "full" | "part"): the same uid
        # set can hold both a full-share and a partitioned price
        self._group: Dict[Tuple[Tuple[int, ...], str], _GroupPrice] = {}
        self._reps: Dict[int, KernelProfile] = {}
        self.stats: Dict[str, int] = {
            "scenarios_solved": 0, "pairs_priced": 0, "groups_priced": 0,
            "arrivals": 0, "departures": 0,
        }

    # ----------------------------- events ------------------------- #
    def __len__(self) -> int:
        return len(self._works)

    def __contains__(self, name: str) -> bool:
        return name in self._works

    @property
    def workloads(self) -> List[WorkloadProfile]:
        """Current pool in arrival order."""
        return list(self._works.values())

    def submit(self, workload: WorkloadProfile) -> None:
        """Admit (or update) a workload. Re-submitting an existing name
        replaces its profile but keeps its arrival position (the legacy
        planner's last-profile-wins dedup); its cached prices are
        invalidated. O(1) — pricing happens lazily at the next plan()."""
        old_uid = self._uid.get(workload.name)
        if old_uid is not None:
            self._drop_prices(old_uid)
        self._works[workload.name] = workload
        self._uid[workload.name] = self._next_uid
        self._next_uid += 1
        self.stats["arrivals"] += 1

    def remove(self, name: str) -> None:
        """Retire a workload. Its pair/group prices are dropped; every
        other price stays valid (a pair's slowdown is independent of the
        rest of the pool), so the survivors of its group re-enter the
        pool with zero pairwise re-pricing (k>2 replays may price fresh
        group combinations on the next plan).

        Removing an unknown name raises ``KeyError`` BEFORE any state is
        touched — the pool, the pricing cache, and the next ``plan()``
        are exactly what they were (pinned online==cold by tests)."""
        if name not in self._works:
            raise KeyError(f"unknown workload: {name!r}")
        uid = self._uid.pop(name)
        del self._works[name]
        self._drop_prices(uid)
        self.stats["departures"] += 1

    def drain(self) -> List[WorkloadProfile]:
        """Retire EVERY workload at once and return them in arrival
        order — the fleet-migration hook: when a device dies or is
        decommissioned, its scheduler drains and the returned pool is
        re-placed on the survivors (repro_torch.core.fleet).  All cached
        prices are dropped; the scheduler is reusable afterwards (a
        later submit starts a fresh pool)."""
        pool = list(self._works.values())
        self._works.clear()
        self._uid.clear()
        self._pair.clear()
        self._group.clear()
        self._reps.clear()
        self.stats["departures"] += len(pool)
        return pool

    def snapshot(self) -> Dict:
        """Read-only state summary (fleet telemetry / debugging): the
        resident pool in arrival order, cache occupancy, and a copy of
        the stats counters.  Never triggers pricing."""
        return {
            "workloads": [w.name for w in self._works.values()],
            "cached_pairs": len(self._pair),
            "cached_groups": len(self._group),
            "max_group_size": self.max_group_size,
            "stats": dict(self.stats),
        }

    def _drop_prices(self, uid: int) -> None:
        self._reps.pop(uid, None)
        for key in [k for k in self._pair if uid in k]:
            del self._pair[key]
        for key in [k for k in self._group if uid in k[0]]:
            del self._group[key]

    def _rep(self, name: str) -> KernelProfile:
        uid = self._uid[name]
        rep = self._reps.get(uid)
        if rep is None:
            rep = self._reps[uid] = self._works[name].representative_kernel(
                self.dev)
        return rep

    # ----------------------------- pricing ------------------------ #
    def _price_missing_pairs(self, works: List[WorkloadProfile],
                             uids: List[int]) -> None:
        """One batched solve over every never-priced pair (an arrival's
        new row; the full triangle on a cold start)."""
        n = len(works)
        missing = [(i, j) for j in range(n) for i in range(j)
                   if (uids[i], uids[j]) not in self._pair]
        if not missing:
            return
        ev = _PairEvaluator(works, self.dev,
                            reps=[self._rep(w.name) for w in works])
        ia = np.fromiter((i for i, _ in missing), np.int64, len(missing))
        ib = np.fromiter((j for _, j in missing), np.int64, len(missing))
        ra, rb, gain, meets = ev.evaluate(ia, ib)       # full-sharing pass
        fa = np.full(len(ia), np.nan)                   # nan = full sharing
        fb = np.full(len(ia), np.nan)

        if self.allow_partition:
            failing = np.flatnonzero(~meets)
            if failing.size:
                bra, brb, bgain, bmeets, bfa, bfb = self._search_pair_fractions(
                    ev, ia[failing], ib[failing])
                sel = failing[bmeets]
                ra[sel], rb[sel] = bra[bmeets], brb[bmeets]
                gain[sel] = bgain[bmeets]
                meets[sel] = True
                fa[sel], fb[sel] = bfa[bmeets], bfb[bmeets]

        for p, (i, j) in enumerate(missing):
            self._pair[(uids[i], uids[j])] = (
                float(ra[p]), float(rb[p]), float(gain[p]), bool(meets[p]),
                float(fa[p]), float(fb[p]))
        self.stats["scenarios_solved"] += ev.scenarios_solved
        self.stats["pairs_priced"] += len(missing)

    def _search_pair_fractions(self, ev: _PairEvaluator, fia: np.ndarray,
                               fib: np.ndarray):
        """The k=2 slot-fraction search on the DENSE pair-evaluator path:
        the green-context fallback for SLO-violating pairs, array-
        vectorized across all failing pairs per candidate vector (no
        per-probe Python objects on the O(n^2) pricing hot path).

        Selection and refinement mirror `fracsearch` exactly — feasible
        max-gain (earliest candidate on ties; ANY feasible partition
        beats the infeasible full share), least-violating anchor
        otherwise, refinement moving delta toward the binding member —
        and tests pin this path against `search_group_fractions` and the
        scalar oracle at 1e-9.  Keep the two in lockstep."""
        F = len(fia)
        slo_a, slo_b = ev.slos[fia], ev.slos[fib]
        ta, tb = ev.totals[fia], ev.totals[fib]
        bmeets = np.zeros(F, bool)
        bgain = np.full(F, -np.inf)
        bviol = np.full(F, np.inf)
        bra = np.empty(F)
        brb = np.empty(F)
        bfa = np.empty(F)
        bfb = np.empty(F)

        def consider(valid, f1, f2):
            cra, crb, cgain, cmeets = ev.evaluate(fia, fib, frac=(f1, f2))
            viol = np.maximum(cra / np.maximum(slo_a, 1e-12),
                              crb / np.maximum(slo_b, 1e-12))
            take = valid & ((cmeets & ~bmeets)
                            | (cmeets & bmeets & (cgain > bgain))
                            | (~cmeets & ~bmeets & (viol < bviol)))
            for dst, src in ((bmeets, cmeets), (bgain, cgain),
                             (bviol, viol), (bra, cra), (brb, crb),
                             (bfa, f1), (bfb, f2)):
                dst[take] = np.broadcast_to(src, (F,))[take]

        steps = self.search.steps_for(2)
        every = np.ones(F, bool)
        for f1, f2 in simplex_candidates(2, steps):
            consider(every, np.full(F, f1), np.full(F, f2))
        for level in range(1, self.search.refine_levels + 1):
            delta = 1.0 / (steps * 2 ** level)
            # sensitivity guidance, the two-member specialization: move
            # delta toward the makespan owner (feasible) or the worse
            # SLO violator; argmax ties resolve to the first member
            recv_a = np.where(bmeets, ta * bra >= tb * brb,
                              bra / np.maximum(slo_a, 1e-12)
                              >= brb / np.maximum(slo_b, 1e-12))
            f1 = np.where(recv_a, bfa + delta, bfa - delta)
            f2 = np.where(recv_a, bfb - delta, bfb + delta)
            donor_left = np.where(recv_a, bfb, bfa) - delta
            consider(donor_left > FRACTION_FLOOR, f1, f2)
        return bra, brb, bgain, bmeets, bfa, bfb

    def _price_groups(self, works: List[WorkloadProfile], uids: List[int],
                      group: List[int], cands: List[int],
                      partitioned: bool = False) -> List[_GroupPrice]:
        """Price group+{c} for every candidate c in ONE batched pass via
        the Scenario currency: each member kernel is a victim against the
        other members' representative kernels (the same probe the
        pairwise matrix uses, widened to k members).  Partitioned groups
        run the k-way slot-fraction search instead of a full-share solve
        and cache their best fractions alongside the gain.  Members are
        priced in canonical works-index order, so a cached price never
        depends on the greedy path that first produced it."""
        mode = "part" if partitioned else "full"

        def key(c: int) -> Tuple[Tuple[int, ...], str]:
            return tuple(sorted(uids[m] for m in group + [c])), mode

        missing = [c for c in cands if key(c) not in self._group]
        if missing:
            member_sets = [sorted(group + [c]) for c in missing]
            reps = {works[m].name: self._rep(works[m].name)
                    for g in member_sets for m in g}
            if partitioned:
                found = search_group_fractions(
                    [[works[m] for m in g] for g in member_sets],
                    self.dev, self.search, reps=reps, stats=self.stats)
                for g, r in zip(member_sets, found):
                    names = [works[m].name for m in g]
                    self._group[(tuple(sorted(uids[m] for m in g)), mode)] = (
                        float(r.gain), bool(r.meets_slo),
                        {n: float(s) for n, s in r.slowdowns.items()},
                        dict(zip(names, map(float, r.fractions)))
                        if r.meets_slo else {})
            else:
                scenarios: List[Scenario] = []
                for g in member_sets:
                    scenarios.extend(group_victim_scenarios(
                        [works[m] for m in g], reps, device=self.dev))
                br = solve_scenarios(scenarios)
                self.stats["scenarios_solved"] += len(scenarios)
                row = 0
                for g in member_sets:
                    members = [works[m] for m in g]
                    n_rows = sum(len(w.kernels) for w in members)
                    slows = member_slowdowns(
                        members, self.dev, br.slowdowns[row:row + n_rows, 0])
                    row += n_rows
                    gain, meets = group_metrics(
                        [w.total_time(self.dev) for w in members],
                        [slows[w.name] for w in members],
                        [w.slo_slowdown for w in members])
                    self._group[(tuple(sorted(uids[m] for m in g)), mode)] = (
                        gain, meets, slows, {})
            self.stats["groups_priced"] += len(missing)
        return [self._group[key(c)] for c in cands]

    # ----------------------------- planning ----------------------- #
    def plan(self) -> Plan:
        """Current placements: greedy max-gain SLO-feasible grouping over
        the cached price matrix (prices any never-seen pairs first)."""
        works = list(self._works.values())
        names = [w.name for w in works]
        n = len(works)
        if n < 2:
            return Plan([], sorted(names))
        uids = [self._uid[nm] for nm in names]
        self._price_missing_pairs(works, uids)

        iu, ju = np.triu_indices(n, k=1)            # pairs in (i, j) lex order
        prices = [self._pair[(uids[i], uids[j])] for i, j in zip(iu, ju)]
        gain = np.fromiter((p[2] for p in prices), np.float64, len(prices))
        meets = np.fromiter((p[3] for p in prices), bool, len(prices))

        # greedy rounds over the cached matrix: max-heap keyed by
        # (gain desc, pair index asc) replays the seed's exact pick order;
        # placements invalidate their members' rows lazily (skip on pop)
        feas = np.flatnonzero(meets)
        heap = list(zip(-gain[feas], iu[feas], ju[feas], feas))
        heapq.heapify(heap)
        placed = np.zeros(n, bool)
        placements: List[Placement] = []
        while heap:
            neg_gain, i, j, p = heapq.heappop(heap)
            if placed[i] or placed[j]:
                continue
            if -neg_gain <= 1.0:
                break
            i, j = int(i), int(j)
            ra, rb, g, _, f_lo, f_hi = prices[int(p)]
            group = [i, j]
            slows = {names[i]: ra, names[j]: rb}
            if np.isnan(f_lo):
                sf: Dict[str, float] = {}
            else:
                sf = {names[i]: f_lo, names[j]: f_hi}
            if self.max_group_size > 2 and (
                    np.isnan(f_lo) or self.search.grow_partitioned):
                group, slows, g, sf = self._grow(
                    works, uids, placed, group, slows, g,
                    None if np.isnan(f_lo) else sf)
            placements.append(Placement(
                [names[m] for m in group], sf,
                {nm: float(s) for nm, s in slows.items()}, True, float(g)))
            placed[group] = True
        solo = sorted(names[i] for i in np.flatnonzero(~placed))
        return Plan(placements, solo)

    def place_candidates(self, workload: WorkloadProfile) -> List[Placement]:
        """Price ``workload`` against this device's CURRENT placement —
        without mutating any scheduler state — and return one candidate
        ``Placement`` per way it could land here: each current group
        with an open slot, each solo resident, plus running alone on the
        device (gain 1.0, always last among equals).  Candidates are
        sorted by gain descending (stable: current-plan order on ties);
        infeasible joins are included with ``meets_slo=False`` so a
        caller can see WHY a device was rejected.

        This is the per-device incremental entry point fleet-level
        repair planning needs: "what would adding this workload to this
        device cost?" answered from the resident groups the cached plan
        already holds, with one batched solve over the probe scenarios
        (and one batched fraction search over SLO-failing joins when
        ``allow_partition``).  The probe workload is NOT admitted and
        nothing is cached under its name — ``submit()`` it to accept a
        candidate.  Raises ``ValueError`` if the name is already
        resident (re-pricing a resident is a resubmit, not a probe)."""
        if workload.name in self._works:
            raise ValueError(f"already resident: {workload.name!r}")
        plan = self.plan()      # prices any never-seen pairs, from cache
        host_groups: List[List[WorkloadProfile]] = []
        for p in plan.placements:
            if len(p.workloads) < self.max_group_size:
                host_groups.append([self._works[n] for n in p.workloads])
        for n in plan.solo:
            host_groups.append([self._works[n]])
        reps = {n: self._rep(n) for g in host_groups for w in g
                for n in (w.name,)}
        reps[workload.name] = workload.representative_kernel(self.dev)
        cand = [g + [workload] for g in host_groups]
        scenarios: List[Scenario] = []
        for g in cand:
            scenarios.extend(group_victim_scenarios(g, reps,
                                                    device=self.dev))
        out: List[Placement] = []
        failing: List[int] = []
        if scenarios:
            br = solve_scenarios(scenarios, self.dev)
            self.stats["scenarios_solved"] += len(scenarios)
            row = 0
            for g in cand:
                n_rows = sum(len(w.kernels) for w in g)
                slows = member_slowdowns(g, self.dev,
                                         br.slowdowns[row:row + n_rows, 0])
                row += n_rows
                gain, meets = group_metrics(
                    [w.total_time(self.dev) for w in g],
                    [slows[w.name] for w in g],
                    [w.slo_slowdown for w in g])
                out.append(Placement(
                    [w.name for w in g], {},
                    {n: float(s) for n, s in slows.items()},
                    bool(meets), float(gain)))
                if not meets:
                    failing.append(len(out) - 1)
        if failing and self.allow_partition:
            found = search_group_fractions([cand[i] for i in failing],
                                           self.dev, self.search, reps=reps,
                                           stats=self.stats)
            for i, r in zip(failing, found):
                if r.meets_slo:
                    names = [w.name for w in cand[i]]
                    out[i] = Placement(
                        names, dict(zip(names, map(float, r.fractions))),
                        {n: float(s) for n, s in r.slowdowns.items()},
                        True, float(r.gain))
        out.append(Placement([workload.name], {}, {workload.name: 1.0},
                             True, 1.0))
        out.sort(key=lambda p: -p.throughput_gain)
        return out

    def _grow(self, works, uids, placed, group, slows, gain, fractions):
        """Greedy group growth: add the unplaced workload that most
        improves the packed gain while keeping every member (old and new)
        within SLO; stop at max_group_size or when no candidate helps.
        ``fractions`` None grows at full sharing; a fraction dict grows a
        PARTITIONED group — every candidate group re-runs the slot-
        fraction search, and the accepted candidate's best fractions
        replace the group's."""
        partitioned = fractions is not None
        while len(group) < self.max_group_size:
            cands = [c for c in range(len(works))
                     if not placed[c] and c not in group]
            if not cands:
                break
            priced = self._price_groups(works, uids, group, cands,
                                        partitioned)
            best = None
            for c, (cg, cmeets, cslows, cfracs) in zip(cands, priced):
                if cmeets and cg > gain and (best is None or cg > best[1]):
                    best = (c, cg, cslows, cfracs)
            if best is None:
                break
            group.append(best[0])
            gain, slows = best[1], best[2]
            if partitioned:
                fractions = best[3]
        return group, slows, gain, dict(fractions or {})


def plan_colocation(workloads: Sequence[WorkloadProfile], dev: DeviceModel,
                    allow_partition: bool = True) -> Plan:
    """Deprecated one-shot pairing: a cold ``ColocationScheduler`` with
    ``max_group_size=2`` and the legacy fixed-grid fraction search
    (identical plans, pinned by tests)."""
    warnings.warn("plan_colocation is deprecated; use ColocationScheduler "
                  "(submit/remove/plan)", DeprecationWarning, stacklevel=2)
    sched = ColocationScheduler(dev, max_group_size=2,
                                allow_partition=allow_partition,
                                fraction_search=LEGACY_SEARCH)
    for w in workloads:
        sched.submit(w)          # dedup: last profile wins, first position
    return sched.plan()
