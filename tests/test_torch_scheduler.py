"""The port's colocation scheduler (`repro_torch.core.scheduler`) against the
JAX package's, on the CPU.

The twins of tests/test_scheduler.py, of the scheduler cases of
tests/test_fracsearch.py and of the planner cases of
tests/test_batch_estimator.py, run on the port. Where the reference's test
compares with the seed planner kept in benchmarks/, the twin compares with
``repro.core.scheduler`` itself, which the reference's own tests hold to the
seed: on the NumPy backend the two packages' plans are equal bit for bit,
and on the port's torch backend (``device="cpu"``) at 1e-9 with the same
placements.

The workloads are drawn by the reference's generators
(benchmarks/bench_planner.py), restated here over either package's
profile classes, so that both packages see the same numbers;
``decode_heavy_mix`` is the port's, in ``repro_torch.examples.fleet_failover``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import (FRACTION_FLOOR, LEGACY_SEARCH, TPU_V5E,
                              ColocationScheduler, FractionSearchConfig,
                              KernelProfile, WorkloadProfile, estimate,
                              evaluate_group, evaluate_group_partitioned,
                              evaluate_pair, evaluate_pair_partitioned,
                              plan_colocation, search_group_fractions)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.core.scheduler import _PARTITION_FRACTIONS, Placement, Plan
from repro_torch.examples.fleet_failover import decode_heavy_mix

TOL = 1e-9


# ------------------------------------------------------------------ #
#  The reference's generators, over either package                    #
# ------------------------------------------------------------------ #
def random_profile(rng, name, dev, core=tc):
    """bench_planner.random_profile's default draw."""
    d = {r: float(rng.uniform(0.02, 1.1)) * dev.capacity(r)
         for r in RESOURCE_AXES}
    ws, hit = 0.0, 0.0
    if rng.random() < 0.3:
        ws = float(rng.uniform(0.1, 1.5)) * dev.cache_capacity
        hit = float(rng.uniform(0.1, 1.0))
    return core.KernelProfile(
        name, demand=d,
        duration=float(rng.uniform(0.5, 2.0)) if rng.random() < 0.5 else None,
        cache_working_set=ws, cache_hit_fraction=hit)


def random_workloads(rng, n, dev, core=tc):
    """bench_planner.random_workloads."""
    return [core.WorkloadProfile(
        f"w{i}",
        tuple(random_profile(rng, f"w{i}p{j}", dev, core)
              for j in range(int(rng.integers(1, 3)))),
        slo_slowdown=float(rng.uniform(1.1, 1.6)))
        for i in range(n)]


def to_ref(w):
    """The reference package's twin of a port WorkloadProfile."""
    return jc.WorkloadProfile(
        w.name, tuple(jc.KernelProfile(**dataclasses.asdict(k)) for k in w.kernels),
        w.slo_slowdown)


def ref_search(search):
    return None if search is None else jc.FractionSearchConfig(**dataclasses.asdict(search))


def cold(works, dev=TPU_V5E, k=2, allow_partition=True, search=None):
    s = ColocationScheduler(dev, max_group_size=k,
                            allow_partition=allow_partition,
                            fraction_search=search)
    for w in works:
        s.submit(w)
    return s


def ref_cold(works, dev=TPU_V5E, k=2, allow_partition=True, search=None):
    """The same cold scheduler in the JAX package, on its NumPy backend."""
    s = jc.ColocationScheduler(jc.DEVICES[dev.name], max_group_size=k,
                               allow_partition=allow_partition,
                               fraction_search=ref_search(search))
    for w in works:
        s.submit(to_ref(w))
    return s


def assert_plans_equal(got, want, tol=TOL):
    """bench_planner.assert_plans_equal, at ``tol`` (0 for bit for bit)."""
    assert [p.workloads for p in got.placements] == \
        [p.workloads for p in want.placements], "placement order differs"
    assert got.solo == want.solo, "solo set differs"
    for g, w in zip(got.placements, want.placements):
        assert g.slot_fraction == w.slot_fraction
        assert g.meets_slo == w.meets_slo
        assert abs(g.throughput_gain - w.throughput_gain) <= tol
        for k in w.predicted_slowdown:
            assert abs(g.predicted_slowdown[k]
                       - w.predicted_slowdown[k]) <= tol


# ------------------------------------------------------------------ #
#  k=2 + LEGACY_SEARCH reproduces the reference planner exactly       #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("allow_partition", [True, False])
def test_k2_cold_scheduler_matches_reference_planner(allow_partition):
    rng = np.random.default_rng(3)
    works = random_workloads(rng, 12, TPU_V5E)
    got = cold(works, allow_partition=allow_partition,
               search=LEGACY_SEARCH).plan()
    want = ref_cold(works, allow_partition=allow_partition,
                    search=LEGACY_SEARCH).plan()
    assert_plans_equal(got, want, tol=0.0)


def test_default_search_never_places_worse_than_legacy_grid():
    """The default (finer + refined) fraction search dominates the legacy
    fixed grid of the reference planner: every placement feasible, total
    gain >= the legacy plan's on the same pool."""
    rng = np.random.default_rng(3)
    works = random_workloads(rng, 12, TPU_V5E)
    got = cold(works).plan()
    want = ref_cold(works, search=LEGACY_SEARCH).plan()
    assert all(p.meets_slo for p in got.placements)
    legacy_gain = (sum(p.throughput_gain for p in want.placements)
                   + len(want.solo)) / max(
        len(want.placements) + len(want.solo), 1)
    assert got.total_gain >= legacy_gain - TOL


def test_plan_colocation_shim_warns_and_forwards():
    rng = np.random.default_rng(4)
    works = random_workloads(rng, 10, TPU_V5E)
    with pytest.warns(DeprecationWarning, match="plan_colocation"):
        got = plan_colocation(works, TPU_V5E)
    assert_plans_equal(got, cold(works, search=LEGACY_SEARCH).plan())
    with pytest.warns(DeprecationWarning, match="plan_colocation"):
        want = jc.plan_colocation([to_ref(w) for w in works], jc.TPU_V5E)
    assert_plans_equal(got, want, tol=0.0)


def test_evaluate_pair_shims_warn_and_forward():
    rng = np.random.default_rng(5)
    a, b = random_workloads(rng, 2, TPU_V5E)
    with pytest.warns(DeprecationWarning, match="evaluate_pair"):
        got = evaluate_pair(a, b, TPU_V5E)
    want = evaluate_group((a, b), TPU_V5E)
    with pytest.warns(DeprecationWarning, match="evaluate_pair"):
        ref = jc.evaluate_pair(to_ref(a), to_ref(b), jc.TPU_V5E)
    for other in (want, ref):
        assert got.workloads == other.workloads
        assert got.meets_slo == other.meets_slo
        assert got.throughput_gain == pytest.approx(other.throughput_gain,
                                                    rel=TOL, abs=TOL)
        for n in other.predicted_slowdown:
            assert got.predicted_slowdown[n] == pytest.approx(
                other.predicted_slowdown[n], rel=TOL, abs=TOL)

    with pytest.warns(DeprecationWarning, match="evaluate_pair_partitioned"):
        gp = evaluate_pair_partitioned(a, b, TPU_V5E)
    # the shim forwards the legacy first-member grid: bit-equal to the
    # explicit-fractions path and to the reference's shim
    wp = evaluate_group_partitioned((a, b), TPU_V5E, _PARTITION_FRACTIONS)
    with pytest.warns(DeprecationWarning, match="evaluate_pair_partitioned"):
        rp = jc.evaluate_pair_partitioned(to_ref(a), to_ref(b), jc.TPU_V5E)
    for other in (wp, rp):
        assert gp.slot_fraction == other.slot_fraction
        assert gp.throughput_gain == pytest.approx(other.throughput_gain,
                                                   rel=TOL, abs=TOL)


# ------------------------------------------------------------------ #
#  Incremental replanning == cold plan on the surviving set           #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("k", [2, 3])
def test_incremental_trace_matches_cold(k):
    rng = np.random.default_rng(11)
    pool = random_workloads(rng, 40, TPU_V5E)
    sched = ColocationScheduler(TPU_V5E, max_group_size=k)
    resident = []
    fresh = list(pool)
    for event in range(24):
        if resident and rng.random() < 0.4:
            victim = resident.pop(int(rng.integers(len(resident))))
            sched.remove(victim.name)
        else:
            w = fresh.pop()
            resident.append(w)
            sched.submit(w)
        got = sched.plan()
        want = cold(resident, k=k).plan()
        assert_plans_equal(got, want)


def test_arrival_prices_one_row_departure_prices_nothing():
    rng = np.random.default_rng(12)
    works = random_workloads(rng, 24, TPU_V5E)
    sched = cold(works[:-1])
    sched.plan()
    cold_scen = sched.stats["scenarios_solved"]
    n = len(works) - 1

    sched.submit(works[-1])
    sched.plan()
    arrival_scen = sched.stats["scenarios_solved"] - cold_scen
    # the new row: per pair, the arrival's kernels probe the resident's rep
    # and vice versa, plus the fraction search's coarse grid and refinement
    # levels for every SLO-failing pair: linear in n, far below the cold
    # O(n^2) price. The constant follows the ACTIVE search config.
    per_pair = 5 * (sched.search.steps_for(2) - 1 + sched.search.refine_levels)
    assert 0 < arrival_scen <= per_pair * (n + 1)
    assert arrival_scen < cold_scen / 4

    before = sched.stats["scenarios_solved"]
    sched.remove(works[0].name)
    sched.plan()
    assert sched.stats["scenarios_solved"] == before


def test_departure_releases_group_survivors():
    mk = lambda name: WorkloadProfile(
        name, (KernelProfile(name + ":k", demand={
            **{r: 0.0 for r in RESOURCE_AXES},
            "hbm": 0.3 * TPU_V5E.capacity("hbm")}, duration=1.0),),
        slo_slowdown=2.0)
    works = [mk(f"w{i}") for i in range(4)]
    sched = cold(works)
    plan = sched.plan()
    assert len(plan.placements) == 2
    partner = next(p for p in plan.placements if "w0" in p.workloads)
    survivor = next(n for n in partner.workloads if n != "w0")
    sched.remove("w0")
    replan = sched.plan()
    placed = {n for p in replan.placements for n in p.workloads}
    # the widowed survivor is back in the pool: re-paired or solo
    assert survivor in placed | set(replan.solo)
    assert "w0" not in placed | set(replan.solo)


def test_remove_unknown_raises_and_leaves_state_intact():
    """Removing a name never submitted (or already removed) raises a clear
    KeyError BEFORE any mutation."""
    rng = np.random.default_rng(21)
    works = random_workloads(rng, 8, TPU_V5E)
    sched = cold(works)
    sched.plan()
    cache_before = (len(sched._pair), len(sched._group))
    stats_before = dict(sched.stats)
    with pytest.raises(KeyError):
        sched.remove("never-submitted")
    sched.remove(works[0].name)
    with pytest.raises(KeyError):
        sched.remove(works[0].name)          # double-remove: same error
    assert len(sched._pair) <= cache_before[0]
    assert len(sched._group) <= cache_before[1]
    assert sched.stats["departures"] == stats_before["departures"] + 1
    assert_plans_equal(sched.plan(), cold(works[1:]).plan())


def test_double_submit_identical_profile_keeps_online_equal_cold():
    rng = np.random.default_rng(22)
    works = random_workloads(rng, 8, TPU_V5E)
    sched = cold(works)
    sched.plan()
    sched.submit(works[3])                   # exact duplicate
    sched.submit(works[3])                   # and again
    assert len(sched) == len(works)
    assert_plans_equal(sched.plan(), cold(works).plan())


def test_error_paths_then_churn_keep_online_equal_cold():
    rng = np.random.default_rng(23)
    works = random_workloads(rng, 10, TPU_V5E)
    sched = cold(works[:8])
    with pytest.raises(KeyError):
        sched.remove(works[9].name)          # not yet submitted
    sched.submit(works[5])                   # duplicate
    sched.remove(works[2].name)
    with pytest.raises(KeyError):
        sched.remove(works[2].name)          # double remove
    sched.submit(works[8])
    sched.submit(works[9])
    pool = [w for w in works if w.name != works[2].name]
    assert_plans_equal(sched.plan(), cold(pool).plan())


def test_resubmit_updates_profile_in_place():
    rng = np.random.default_rng(13)
    works = random_workloads(rng, 8, TPU_V5E)
    sched = cold(works)
    sched.plan()
    updated = random_workloads(np.random.default_rng(99), 8, TPU_V5E)[3]
    updated = WorkloadProfile(works[3].name, updated.kernels,
                              updated.slo_slowdown)
    sched.submit(updated)
    new_pool = [updated if w.name == updated.name else w for w in works]
    assert_plans_equal(sched.plan(), cold(new_pool).plan())


# ------------------------------------------------------------------ #
#  k-way placements                                                   #
# ------------------------------------------------------------------ #
def _decode_like(name, hbm=0.28, slo=2.0):
    d = {r: 0.0 for r in RESOURCE_AXES}
    d["hbm"] = hbm * TPU_V5E.capacity("hbm")
    d["issue"] = 0.05 * TPU_V5E.capacity("issue")
    return WorkloadProfile(name, (KernelProfile(name + ":k", demand=d,
                                                duration=1.0),),
                           slo_slowdown=slo)


def test_k3_oracle_against_direct_estimate():
    """A 3-way group's numbers equal first-principles estimate() calls:
    each member's kernel against the other members' rep kernels."""
    works = [_decode_like(f"dec{i}") for i in range(3)]
    plan = cold(works, k=3).plan()
    assert len(plan.placements) == 1
    pl = plan.placements[0]
    assert sorted(pl.workloads) == [w.name for w in works]

    reps = {w.name: w.representative_kernel(TPU_V5E) for w in works}
    times = {w.name: w.total_time(TPU_V5E) for w in works}
    expected = {}
    for w in works:
        others = [reps[o.name] for o in works if o.name != w.name]
        r = estimate([w.kernels[0]] + others, TPU_V5E)
        expected[w.name] = r.slowdowns[w.kernels[0].name]
    for n, want in expected.items():
        assert pl.predicted_slowdown[n] == pytest.approx(want, rel=TOL,
                                                         abs=TOL)
    want_gain = sum(times.values()) / max(times[n] * expected[n]
                                          for n in expected)
    assert pl.throughput_gain == pytest.approx(want_gain, rel=TOL, abs=TOL)
    oracle = evaluate_group(works, TPU_V5E)
    assert pl.throughput_gain == pytest.approx(oracle.throughput_gain,
                                               rel=TOL, abs=TOL)


def test_k3_beats_k2_on_decode_heavy_mix():
    mix = [_decode_like(f"dec{i}") for i in range(6)]
    gain2 = cold(mix, k=2).plan().total_gain
    gain3 = cold(mix, k=3).plan().total_gain
    assert gain3 > gain2 > 1.0


def test_k3_respects_slo():
    mix = [_decode_like(f"dec{i}", hbm=0.45, slo=1.25) for i in range(4)]
    plan = cold(mix, k=4).plan()
    for pl in plan.placements:
        assert pl.meets_slo
        assert max(pl.predicted_slowdown.values()) <= 1.25 + TOL


def test_max_group_size_validation():
    with pytest.raises(ValueError, match="max_group_size"):
        ColocationScheduler(TPU_V5E, max_group_size=1)
    with pytest.raises(KeyError):
        ColocationScheduler(TPU_V5E).remove("ghost")


# ------------------------------------------------------------------ #
#  place_candidates: the non-mutating per-device probe               #
# ------------------------------------------------------------------ #
def test_place_candidates_matches_evaluate_group_oracle():
    rng = np.random.default_rng(11)
    works = random_workloads(rng, 5, TPU_V5E)
    probe = random_workloads(rng, 7, TPU_V5E)[6]
    s = cold(works, k=3)
    by_name = {w.name: w for w in works}
    by_name[probe.name] = probe
    for p in s.place_candidates(probe):
        if len(p.workloads) == 1 or p.slot_fraction:
            continue            # solo sentinel / partition-rescued join
        want = evaluate_group([by_name[n] for n in p.workloads], TPU_V5E)
        assert abs(p.throughput_gain - want.throughput_gain) <= 1e-9
        assert p.meets_slo == want.meets_slo
        for n in p.workloads:
            assert abs(p.predicted_slowdown[n]
                       - want.predicted_slowdown[n]) <= 1e-9


def test_place_candidates_is_pure_probe():
    rng = np.random.default_rng(12)
    works = random_workloads(rng, 4, TPU_V5E)
    probe = random_workloads(rng, 6, TPU_V5E)[5]
    s = cold(works, k=3)
    before_plan = s.plan()
    before = s.snapshot()
    cands = s.place_candidates(probe)
    after = s.snapshot()
    assert probe.name not in s
    assert after["workloads"] == before["workloads"]
    assert after["cached_pairs"] == before["cached_pairs"]
    assert after["cached_groups"] == before["cached_groups"]
    assert_plans_equal(s.plan(), before_plan)
    gains = [p.throughput_gain for p in cands]
    assert gains == sorted(gains, reverse=True)
    solo = [p for p in cands if list(p.workloads) == [probe.name]]
    assert len(solo) == 1 and solo[0].meets_slo
    assert solo[0].throughput_gain == 1.0


def test_place_candidates_partition_rescues_failing_join():
    d0, d1 = decode_heavy_mix(TPU_V5E, n_decode=2, n_aux=0)
    full = evaluate_group([d0, d1], TPU_V5E)
    assert not full.meets_slo          # the gate mix: pair fails shared
    s = cold([d0], k=2, allow_partition=True)
    join = [p for p in s.place_candidates(d1)
            if set(p.workloads) == {d0.name, d1.name}]
    assert len(join) == 1
    assert join[0].meets_slo and join[0].slot_fraction
    s2 = cold([d0], k=2, allow_partition=False)
    join2 = [p for p in s2.place_candidates(d1)
             if set(p.workloads) == {d0.name, d1.name}]
    assert len(join2) == 1 and not join2[0].meets_slo


def test_place_candidates_resident_name_raises():
    rng = np.random.default_rng(13)
    works = random_workloads(rng, 3, TPU_V5E)
    s = cold(works, k=3)
    with pytest.raises(ValueError):
        s.place_candidates(works[0])


# ------------------------------------------------------------------ #
#  The scheduler cases of tests/test_fracsearch.py                    #
# ------------------------------------------------------------------ #
def test_scheduler_dense_pair_search_matches_generic():
    """The dense pair fast path (`_search_pair_fractions`) produces what
    the generic `search_group_fractions` does for the same pairs:
    fractions bit-identical, slowdowns and gains at 1e-9."""
    rng = np.random.default_rng(31)
    works = random_workloads(rng, 14, TPU_V5E)
    sched = cold(works)
    sched.plan()
    checked = 0
    for (ui, uj), price in sched._pair.items():
        i = next(k for k, w in enumerate(works) if sched._uid[w.name] == ui)
        j = next(k for k, w in enumerate(works) if sched._uid[w.name] == uj)
        full = evaluate_group([works[i], works[j]], TPU_V5E)
        if full.meets_slo:
            continue                      # partition search never ran
        checked += 1
        res = search_group_fractions([[works[i], works[j]]], TPU_V5E,
                                     sched.search)[0]
        slow_i, slow_j, gain, meets, f_i, f_j = price
        assert meets == res.meets_slo
        if not meets:
            continue
        assert (f_i, f_j) == res.fractions
        assert gain == pytest.approx(res.gain, rel=TOL, abs=TOL)
        assert slow_i == pytest.approx(res.slowdowns[works[i].name],
                                       rel=TOL, abs=TOL)
        assert slow_j == pytest.approx(res.slowdowns[works[j].name],
                                       rel=TOL, abs=TOL)
    assert checked >= 10, "draw exercised too few failing pairs"


def _negative_gain_pair(dev=TPU_V5E):
    """tests/test_fracsearch.py's pair whose only feasible partition has a
    negative gain (a negative-weight ghost kernel)."""
    d = {r: 0.0 for r in RESOURCE_AXES}
    d.update({"mxu": 0.4 * dev.capacity("mxu"),
              "hbm": 0.7 * dev.capacity("hbm"),
              "l2": 0.7 * dev.capacity("l2")})
    victim_kernel = KernelProfile("victim#step", demand=d, duration=1.0)
    ghost = KernelProfile("victim#ghost", demand={r: 0.0 for r in
                                                  RESOURCE_AXES},
                          duration=1.1, duration_weight=-1.0)
    victim = WorkloadProfile("victim", (victim_kernel, ghost),
                             slo_slowdown=1.2)
    da = {r: 0.0 for r in RESOURCE_AXES}
    da.update({"mxu": 0.9 * dev.capacity("mxu"),
               "vpu": 0.2 * dev.capacity("vpu"),
               "hbm": 0.6 * dev.capacity("hbm"),
               "l2": 0.6 * dev.capacity("l2")})
    aggressor = WorkloadProfile(
        "aggressor", (KernelProfile("aggressor#step", demand=da,
                                    duration=0.4, duration_weight=0.05),),
        slo_slowdown=50.0)
    return victim, aggressor


def test_negative_gain_partition_is_kept():
    victim, aggressor = _negative_gain_pair()
    full = evaluate_group([victim, aggressor], TPU_V5E)
    assert not full.meets_slo
    part = evaluate_group_partitioned([victim, aggressor], TPU_V5E)
    assert part.meets_slo, "feasible partition was discarded"
    assert part.slot_fraction
    assert part.throughput_gain <= 0.0


def test_negative_gain_partition_scheduler_pair_cache_bit_identical():
    victim, aggressor = _negative_gain_pair()
    part = evaluate_group_partitioned([victim, aggressor], TPU_V5E)
    sched = cold([victim, aggressor])
    sched.plan()
    (price,) = sched._pair.values()
    slow_v, slow_a, gain, meets, f_v, f_a = price
    assert meets, "pair cached as infeasible despite feasible partition"
    assert f_v == part.slot_fraction["victim"]
    assert f_a == part.slot_fraction["aggressor"]
    assert gain == pytest.approx(part.throughput_gain, rel=TOL, abs=TOL)
    assert slow_v == pytest.approx(part.predicted_slowdown["victim"],
                                   rel=TOL, abs=TOL)
    assert slow_a == pytest.approx(part.predicted_slowdown["aggressor"],
                                   rel=TOL, abs=TOL)


def _assert_plans_match(got, want):
    assert [p.workloads for p in got.placements] == \
        [p.workloads for p in want.placements]
    assert got.solo == want.solo
    for g, w in zip(got.placements, want.placements):
        assert g.slot_fraction == w.slot_fraction
        assert abs(g.throughput_gain - w.throughput_gain) <= TOL


def test_partitioned_group_fractions_sum_to_at_most_one():
    mix = decode_heavy_mix(TPU_V5E)
    for k in (2, 3, 4):
        plan = cold(mix, k=k).plan()
        for p in plan.placements:
            if not p.slot_fraction:
                continue
            total = sum(p.slot_fraction.values())
            assert total <= 1.0 + 1e-12, (k, p)
            assert all(f > FRACTION_FLOOR for f in p.slot_fraction.values())
            assert set(p.slot_fraction) == set(p.workloads)


def test_kway_partitioned_groups_beat_fixed_grid_pairs():
    """The partition-search gate: on the SLO-tight decode-heavy mix the
    k-way scheduler strictly beats the legacy fixed-grid pair baseline,
    with partitioned groups of size > 2."""
    mix = decode_heavy_mix(TPU_V5E)
    baseline = cold(mix, k=2, search=LEGACY_SEARCH).plan()
    kway = cold(mix, k=3).plan()
    assert kway.total_gain > baseline.total_gain + 1e-6
    grown = [p for p in kway.placements
             if len(p.workloads) > 2 and p.slot_fraction]
    assert grown, "no partitioned k-way group was placed"
    for p in kway.placements:
        assert p.meets_slo


def test_partition_cache_roundtrips_through_remove_submit():
    mix = decode_heavy_mix(TPU_V5E)
    sched = cold(mix, k=3)
    before = sched.plan()
    target = next(p for p in before.placements
                  if len(p.workloads) > 2 and p.slot_fraction)
    member = target.workloads[0]
    profile = next(w for w in mix if w.name == member)
    sched.remove(member)
    mid = sched.plan()
    assert member not in {n for p in mid.placements for n in p.workloads}
    sched.submit(profile)          # re-arrives at the END of the order
    after = sched.plan()
    reordered = [w for w in mix if w.name != member] + [profile]
    _assert_plans_match(after, cold(reordered, k=3).plan())
    regrown = next(p for p in after.placements if member in p.workloads)
    assert len(regrown.workloads) > 2 and regrown.slot_fraction
    assert regrown.throughput_gain == pytest.approx(
        target.throughput_gain, rel=TOL, abs=TOL)
    assert sorted(regrown.slot_fraction.values()) == pytest.approx(
        sorted(target.slot_fraction.values()), rel=TOL, abs=TOL)


def test_online_plan_with_partitioned_groups_matches_cold():
    rng = np.random.default_rng(41)
    pool = decode_heavy_mix(TPU_V5E) + random_workloads(rng, 6, TPU_V5E)
    rng.shuffle(pool)
    sched = ColocationScheduler(TPU_V5E, max_group_size=3)
    resident = []
    fresh = list(pool)
    for _ in range(14):
        if resident and rng.random() < 0.4:
            victim = resident.pop(int(rng.integers(len(resident))))
            sched.remove(victim.name)
        else:
            if not fresh:
                break
            w = fresh.pop()
            resident.append(w)
            sched.submit(w)
        _assert_plans_match(sched.plan(), cold(resident, k=3).plan())


# ------------------------------------------------------------------ #
#  The planner cases of tests/test_batch_estimator.py                 #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("allow_partition", [True, False])
def test_planner_matches_reference(allow_partition):
    rng = np.random.default_rng(3)
    works = random_workloads(rng, 12, TPU_V5E)
    with pytest.warns(DeprecationWarning):
        got = plan_colocation(works, TPU_V5E, allow_partition)
    with pytest.warns(DeprecationWarning):
        want = jc.plan_colocation([to_ref(w) for w in works], jc.TPU_V5E,
                                  allow_partition)
    assert_plans_equal(got, want, tol=0.0)


def test_pair_evaluation_matches_reference():
    rng = np.random.default_rng(4)
    works = random_workloads(rng, 6, TPU_V5E)
    refs = [to_ref(w) for w in works]
    with pytest.warns(DeprecationWarning):
        for i in range(len(works)):
            for j in range(i + 1, len(works)):
                for fn_new, fn_ref in ((evaluate_pair, jc.evaluate_pair),
                                       (evaluate_pair_partitioned,
                                        jc.evaluate_pair_partitioned)):
                    g = fn_new(works[i], works[j], TPU_V5E)
                    w = fn_ref(refs[i], refs[j], jc.TPU_V5E)
                    assert g.workloads == w.workloads
                    assert g.meets_slo == w.meets_slo
                    assert g.slot_fraction == w.slot_fraction
                    assert g.throughput_gain == w.throughput_gain


def test_plan_total_gain_uses_member_gains():
    p1 = Placement(["a", "b"], {}, {"a": 1.1, "b": 1.2}, True, 1.8)
    p2 = Placement(["c", "d"], {}, {"c": 1.0, "d": 1.0}, True, 1.4)
    plan = Plan([p1, p2], ["e"])
    assert plan.total_gain == pytest.approx((1.8 + 1.4 + 1.0) / 3)
    assert Plan([], []).total_gain == 1.0


# ------------------------------------------------------------------ #
#  The two packages' Plans, placement for placement                   #
# ------------------------------------------------------------------ #
SEARCHES = {"default": FractionSearchConfig(), "dense": tc.DENSE_SEARCH,
            "legacy": LEGACY_SEARCH}


def _pool(seed):
    rng = np.random.default_rng(seed)
    pool = decode_heavy_mix(TPU_V5E) + random_workloads(rng, 10, TPU_V5E)
    rng.shuffle(pool)
    return pool


@pytest.mark.parametrize("search", sorted(SEARCHES))
@pytest.mark.parametrize("k", [2, 3])
def test_plans_equal_across_packages_on_numpy(k, search):
    """Cold and online plans of the same pool: bit for bit on the NumPy
    backend of both packages."""
    pool = _pool(51)
    cfg = SEARCHES[search]
    assert_plans_equal(cold(pool, k=k, search=cfg).plan(),
                       ref_cold(pool, k=k, search=cfg).plan(), tol=0.0)
    sched = cold(pool, k=k, search=cfg)
    ref = ref_cold(pool, k=k, search=cfg)
    for w in pool[::3]:
        sched.remove(w.name)
        ref.remove(w.name)
        assert_plans_equal(sched.plan(), ref.plan(), tol=0.0)
    assert sched.stats == ref.stats


@pytest.mark.parametrize("k", [2, 3])
def test_plans_on_the_torch_backend_match_the_reference(k):
    """The port's torch solver on the CPU prices the same plans as the
    reference's NumPy oracle: the same placements and fractions, numbers
    at 1e-9."""
    pool = _pool(52)
    with tc.solver_backend("torch", device="cpu"):
        got = cold(pool, k=k, search=tc.DENSE_SEARCH).plan()
    assert_plans_equal(got, ref_cold(pool, k=k, search=tc.DENSE_SEARCH).plan())
