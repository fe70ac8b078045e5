"""The port's fleet scheduler, scoped repair and fault injector
(`repro_torch.core.fleet`, `repro_torch.core.repair`,
`repro_torch.ft.inject`) against the JAX package's, on the CPU.

The twins of tests/test_fleet.py, tests/test_repair.py and
tests/test_ft.py's fake-clock case, run on the port; the helpers that the
reference's tests take from benchmarks/bench_fleet.py (``cold_fleet``,
``fleet_plans_equal``) are restated here, and bench_planner.py's
``decode_heavy_mix`` is the port's, in ``repro_torch.examples.fleet_failover``. Then the same scripted kill, storm and straggler go through
both packages' ``FaultInjector`` into both packages' fleets: the decision
logs and the placements are equal, bit for bit on the NumPy backend and
at 1e-9 on the port's torch backend (``device="cpu"``).
"""
import dataclasses
from dataclasses import replace

import numpy as np
import pytest

import repro.core as jc
import repro.ft.inject as jinject
from repro_torch.core import (BEST_EFFORT, SLO, TPU_V5E, TPU_V5P,
                              FleetConfig, FleetScheduler, KernelProfile,
                              RepairScope, WorkloadProfile, solver_backend)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.examples.fleet_failover import decode_heavy_mix
from repro_torch.ft.inject import (FakeClock, FaultInjector, arrive,
                                   depart, kill, slow, storm)

TOL = 1e-9


def fleet_plans_equal(got, want, tol=TOL):
    """bench_fleet.fleet_plans_equal: the same placements (members in
    order), slot fractions, predicted slowdowns and gains at ``tol``, and
    the same unplaced set (queued and degraded pooled)."""
    if set(got.placements) != set(want.placements):
        return False
    for did, a in got.placements.items():
        b = want.placements[did]
        if a.workloads != b.workloads or set(a.slot_fraction) != set(b.slot_fraction):
            return False
        if any(abs(a.slot_fraction[n] - b.slot_fraction[n]) > tol
               for n in a.slot_fraction):
            return False
        if any(abs(a.predicted_slowdown[n] - b.predicted_slowdown[n]) > tol
               for n in a.workloads):
            return False
        if abs(a.throughput_gain - b.throughput_gain) > tol:
            return False
    return (sorted(got.queued + got.degraded)
            == sorted(want.queued + want.degraded))


def cold_fleet(online, dev_models, config):
    """bench_fleet.cold_fleet: a cold fleet over the given devices, fed the
    online fleet's tracked pool in arrival order."""
    fleet = FleetScheduler(dev_models, config)
    for prof, prio in online.workloads:
        fleet.submit(prof, priority=prio)
    return fleet


def mix(n_decode=2, n_aux=2):
    works = decode_heavy_mix(TPU_V5E, n_decode=n_decode, n_aux=n_aux)
    return works[:n_decode], works[n_decode:]


def make_fleet(n_devices=2, clock=None, **cfg_kw):
    cfg_kw.setdefault("max_group_size", 3)
    cfg_kw.setdefault("heartbeat_timeout", 3.0)
    cfg = FleetConfig(**cfg_kw)
    return FleetScheduler({f"dev{i}": TPU_V5E for i in range(n_devices)},
                          cfg, clock=clock or FakeClock()), cfg


# ------------------------------------------------------------------ #
#  admission control                                                  #
# ------------------------------------------------------------------ #
def test_submit_places_and_records_decision():
    decodes, _ = mix()
    fleet, _ = make_fleet()
    d = fleet.submit(decodes[0], priority=SLO)
    assert d.action == "placed" and d.workload == decodes[0].name
    assert d.device in fleet.devices
    assert fleet.plan().placed == {decodes[0].name: d.device}


def test_submit_rejects_bad_priority():
    decodes, _ = mix()
    fleet, _ = make_fleet()
    with pytest.raises(ValueError):
        fleet.submit(decodes[0], priority="urgent")
    assert len(fleet) == 0


def test_remove_unknown_raises_before_mutation():
    fleet, _ = make_fleet()
    with pytest.raises(KeyError):
        fleet.remove("ghost")
    assert fleet.stats["departures"] == 0 and len(fleet.decisions) == 0


def test_storm_bounded_queue_rejects_with_records():
    decodes, auxes = mix(n_decode=1, n_aux=8)
    clock = FakeClock()
    fleet, cfg = make_fleet(n_devices=1, clock=clock, max_group_size=2,
                            queue_limit=2)
    fleet.submit(decodes[0], priority=SLO)
    results = [fleet.submit(a, priority=BEST_EFFORT) for a in auxes]
    actions = [r.action for r in results]
    rejected = [r for r in results if r.action == "rejected"]
    assert rejected, "overflow must be rejected, not grown"
    assert len(fleet) <= 1 + cfg.max_group_size + cfg.queue_limit + 1
    for r in rejected:
        assert r.workload not in fleet
        assert "queue full" in r.reason
    assert all(a in ("placed", "queued", "rejected") for a in actions)


# ------------------------------------------------------------------ #
#  priority eviction                                                  #
# ------------------------------------------------------------------ #
def test_slo_arrival_evicts_best_effort():
    decodes, auxes = mix(n_decode=1, n_aux=2)
    fleet, _ = make_fleet(n_devices=1, max_group_size=2)
    for a in auxes:
        assert fleet.submit(a, priority=BEST_EFFORT).action == "placed"
    d = fleet.submit(decodes[0], priority=SLO)
    assert d.action == "placed"
    plan = fleet.plan()
    assert plan.placed[decodes[0].name] == "dev0"
    evicted = [x for x in fleet.decisions if x.action == "evicted"]
    assert len(evicted) == 1
    assert evicted[0].workload in {a.name for a in auxes}
    assert evicted[0].priority == BEST_EFFORT
    assert evicted[0].workload in fleet
    assert fleet.workload_state(evicted[0].workload)["state"] == "queued"


def test_evicted_work_returns_when_capacity_does():
    decodes, auxes = mix(n_decode=1, n_aux=2)
    fleet, _ = make_fleet(n_devices=1, max_group_size=2)
    for a in auxes:
        fleet.submit(a, priority=BEST_EFFORT)
    fleet.submit(decodes[0], priority=SLO)
    evicted = next(x.workload for x in fleet.decisions
                   if x.action == "evicted")
    fleet.remove(decodes[0].name)            # SLO departs
    assert fleet.plan().placed.get(evicted) == "dev0"


# ------------------------------------------------------------------ #
#  device failure / recovery                                          #
# ------------------------------------------------------------------ #
def _run_kill_trace(n_devices=3, n_decode=3, n_aux=2, until=25.0):
    decodes, auxes = mix(n_decode=n_decode, n_aux=n_aux)
    clock = FakeClock()
    fleet, cfg = make_fleet(n_devices=n_devices, clock=clock)
    trace = ([arrive(float(i), d, priority=SLO)
              for i, d in enumerate(decodes)]
             + storm(3.0, auxes, priority=BEST_EFFORT)
             + [kill(6.0, "dev1")])
    FaultInjector(fleet, clock).run(trace, until=until)
    return fleet, cfg, decodes, auxes


def test_device_kill_replaces_all_slo_work():
    fleet, _, decodes, _ = _run_kill_trace()
    plan = fleet.plan()
    assert plan.device_states["dev1"] == "dead"
    assert plan.placement_rate([d.name for d in decodes]) == 1.0
    assert all(did != "dev1" for did in plan.placed.values())
    assert fleet.stats["errors"] == 0
    assert any(d.action == "device-dead" for d in fleet.decisions)


def test_dead_device_scheduler_is_drained():
    fleet, _, _, _ = _run_kill_trace()
    dev = fleet.devices["dev1"]
    assert len(dev.sched) == 0 and dev.resident_uids == {}
    snap = dev.sched.snapshot()
    assert snap["workloads"] == [] and snap["cached_pairs"] == 0


def test_online_after_kill_equals_cold_over_survivors():
    fleet, cfg, _, _ = _run_kill_trace()
    survivors = {did: d.model for did, d in fleet.devices.items()
                 if did != "dev1"}
    cold = cold_fleet(fleet, survivors, cfg)
    assert fleet_plans_equal(fleet.plan(), cold.plan(), tol=TOL)


def test_heartbeat_revives_dead_device():
    fleet, _, decodes, auxes = _run_kill_trace()
    fleet.heartbeat("dev1")
    plan = fleet.plan()
    assert plan.device_states["dev1"] == "healthy"
    assert any(d.action == "device-recovered" for d in fleet.decisions)
    assert plan.placement_rate(
        [w.name for w in decodes + auxes if w.name in fleet]) == 1.0


def test_retry_backoff_ends_in_degraded_not_crash():
    decodes, _ = mix(n_decode=3, n_aux=0)
    clock = FakeClock()
    fleet, cfg = make_fleet(n_devices=1, clock=clock, max_group_size=2,
                            backoff_base=1.0, max_retries=2)
    trace = [arrive(0.0, d, priority=SLO) for d in decodes]
    FaultInjector(fleet, clock).run(trace, until=20.0)
    plan = fleet.plan()
    assert len(plan.degraded) >= 1
    for name in plan.degraded:
        assert fleet.workload_state(name)["retries"] >= cfg.max_retries
    retries = [d for d in fleet.decisions if d.action == "retry-failed"]
    assert any("backoff 2.0s" in d.reason for d in retries)
    assert fleet.stats["errors"] == 0
    assert fleet.degraded


def test_degraded_workload_recovers_on_capacity_change():
    decodes, _ = mix(n_decode=3, n_aux=0)
    clock = FakeClock()
    fleet, _ = make_fleet(n_devices=1, clock=clock, max_group_size=2,
                          backoff_base=1.0, max_retries=2)
    FaultInjector(fleet, clock).run(
        [arrive(0.0, d, priority=SLO) for d in decodes], until=20.0)
    stuck = fleet.plan().degraded
    assert stuck
    fleet.add_device("dev1", TPU_V5E)
    fleet.tick()
    assert fleet.plan().degraded == []
    assert fleet.plan().placement_rate(stuck) == 1.0


def test_straggling_device_degrades_and_sheds_slo_work():
    decodes, auxes = mix(n_decode=2, n_aux=2)
    clock = FakeClock()
    fleet, _ = make_fleet(n_devices=2, clock=clock)
    trace = ([arrive(float(i), d, priority=SLO)
              for i, d in enumerate(decodes)]
             + [arrive(2.0, a, priority=BEST_EFFORT) for a in auxes]
             + [slow(4.0, "dev1")])
    FaultInjector(fleet, clock).run(trace, until=10.0)
    plan = fleet.plan()
    assert plan.device_states["dev1"] == "degraded"
    placed = plan.placed
    for d in decodes:                        # SLO left the slow device
        assert placed[d.name] == "dev0"
    assert any(d.action == "device-degraded" for d in fleet.decisions)
    fleet.revive_device("dev1")
    assert fleet.plan().device_states["dev1"] == "healthy"


def test_decommission_migrates_like_a_failure():
    decodes, _ = mix(n_decode=2, n_aux=0)
    fleet, cfg = make_fleet(n_devices=2)
    for d in decodes:
        fleet.submit(d, priority=SLO)
    fleet.decommission("dev0")
    plan = fleet.plan()
    assert plan.device_states["dev0"] == "dead"
    assert plan.placement_rate([d.name for d in decodes]) == 1.0
    fleet.decommission("dev0")               # documented no-op
    survivors = {"dev1": TPU_V5E}
    assert fleet_plans_equal(fleet.plan(),
                             cold_fleet(fleet, survivors, cfg).plan())


def test_rescale_plan_attached_on_chip_loss():
    decodes, _ = mix(n_decode=1, n_aux=0)
    clock = FakeClock()
    fleet, _ = make_fleet(n_devices=2, clock=clock)
    meta = {"mesh_shape": {"data": 4, "model": 2}, "global_batch": 256,
            "num_microbatches": 4, "step": 77}
    d = fleet.submit(decodes[0], priority=SLO, train_meta=meta)
    fleet.decommission(d.device)
    state = fleet.workload_state(decodes[0].name)
    assert state["rescale"] is not None
    assert state["rescale"].restart_step == 77
    assert state["rescale"].new_chip_count < 8
    assert any(x.action == "rescale-planned" for x in fleet.decisions)


# ------------------------------------------------------------------ #
#  determinism + the no-crash contract                                #
# ------------------------------------------------------------------ #
def test_full_trace_online_equals_cold_and_decisions_deterministic():
    def run():
        decodes, auxes = mix(n_decode=3, n_aux=3)
        clock = FakeClock()
        fleet, cfg = make_fleet(n_devices=3, clock=clock)
        trace = ([arrive(float(i), d, priority=SLO)
                  for i, d in enumerate(decodes)]
                 + storm(3.0, auxes, priority=BEST_EFFORT)
                 + [depart(5.0, auxes[0].name), kill(7.0, "dev2")])
        FaultInjector(fleet, clock).run(trace, until=30.0)
        return fleet, cfg

    fleet, cfg = run()
    survivors = {did: d.model for did, d in fleet.devices.items()
                 if d.state != "dead"}
    assert fleet_plans_equal(fleet.plan(),
                             cold_fleet(fleet, survivors, cfg).plan(),
                             tol=TOL)
    fleet2, _ = run()
    assert [repr(d) for d in fleet.decisions] \
        == [repr(d) for d in fleet2.decisions]
    assert fleet.stats == fleet2.stats


def test_event_loop_never_raises():
    decodes, _ = mix(n_decode=1, n_aux=0)
    fleet, _ = make_fleet(n_devices=1)
    fleet.submit(decodes[0], priority=SLO)

    def boom(scope, retry_due=frozenset()):
        raise RuntimeError("injected bug")

    fleet.planner.plan = boom
    fleet.tick(now=1e9)                      # forces a dead-device replan
    errors = [d for d in fleet.decisions if d.action == "error"]
    assert errors and fleet.stats["errors"] >= 1
    assert "injected bug" in errors[-1].reason


def test_snapshot_reports_fleet_telemetry():
    decodes, auxes = mix()
    fleet, _ = make_fleet(n_devices=2)
    fleet.submit(decodes[0], priority=SLO)
    fleet.submit(auxes[0], priority=BEST_EFFORT)
    snap = fleet.snapshot()
    assert set(snap["devices"]) == {"dev0", "dev1"}
    for d in snap["devices"].values():
        assert {"state", "model", "chips", "sched"} <= set(d)
    assert set(snap["workloads"]) == {decodes[0].name, auxes[0].name}
    assert snap["stats"]["arrivals"] == 2


# ------------------------------------------------------------------ #
#  batched storm admission (submit_many)                              #
# ------------------------------------------------------------------ #
def test_submit_many_matches_sequential_with_one_replan():
    decodes, auxes = mix(n_decode=3, n_aux=5)
    works = decodes + auxes
    prios = [SLO] * 3 + [BEST_EFFORT] * 5
    seq, _ = make_fleet(n_devices=3)
    for w, p in zip(works, prios):
        seq.submit(w, priority=p)
    bat, _ = make_fleet(n_devices=3)
    decisions = bat.submit_many(list(zip(works, prios)))
    assert fleet_plans_equal(bat.plan(), seq.plan())
    assert bat.stats["replans"] == 1
    assert seq.stats["replans"] == len(works)
    assert [d.workload for d in decisions] == [w.name for w in works]
    assert bat.stats["arrivals"] == len(works)


def test_submit_many_bounded_queue_and_dedup():
    decodes, auxes = mix(n_decode=1, n_aux=8)
    fleet, cfg = make_fleet(n_devices=1, max_group_size=2, queue_limit=2)
    fleet.submit(decodes[0], priority=SLO)
    decisions = fleet.submit_many(
        [(a, BEST_EFFORT) for a in auxes]
        + [(auxes[0], BEST_EFFORT)])         # duplicate name in the batch
    assert [d.workload for d in decisions] == [a.name for a in auxes]
    rejected = [d for d in decisions if d.action == "rejected"]
    assert rejected, "overflow must be rejected, not grown"
    for r in rejected:
        assert r.workload not in fleet
        assert "queue full" in r.reason
    assert len(fleet) <= 1 + cfg.max_group_size + cfg.queue_limit + 1


def test_submit_many_empty_and_bad_priority():
    fleet, _ = make_fleet()
    assert fleet.submit_many([]) == []
    decodes, _ = mix()
    with pytest.raises(ValueError):
        fleet.submit_many([(decodes[0], "urgent")])
    assert len(fleet) == 0 and fleet.stats["arrivals"] == 0


def test_injector_batches_same_tick_storm():
    decodes, auxes = mix(n_decode=1, n_aux=4)
    clock = FakeClock()
    fleet, _ = make_fleet(n_devices=2, clock=clock)
    replans_at = {}
    trace = ([arrive(0.0, decodes[0], priority=SLO)]
             + storm(1.0, auxes, priority=BEST_EFFORT))
    FaultInjector(
        fleet, clock,
        on_tick=lambda f, now: replans_at.setdefault(now, f.stats["replans"])
    ).run(trace, until=3.0)
    assert replans_at[1.0] - replans_at[0.0] == 1


# ------------------------------------------------------------------ #
#  price-cache reverse index                                          #
# ------------------------------------------------------------------ #
def test_drop_prices_clears_caches_via_reverse_index():
    decodes, auxes = mix(n_decode=2, n_aux=2)
    fleet, _ = make_fleet(n_devices=2)
    for d in decodes:
        fleet.submit(d, priority=SLO)
    for a in auxes:
        fleet.submit(a, priority=BEST_EFFORT)
    victim = decodes[0].name
    uid = fleet._tracked[victim].uid
    assert uid in fleet._uid_price_keys
    assert any(uid in key[1] for key in fleet._price_cache)
    fleet.remove(victim)
    assert uid not in fleet._uid_price_keys
    assert uid not in fleet._uid_rep_keys
    assert not any(uid in key[1] for key in fleet._price_cache)
    assert not any(key[0] == uid for key in fleet._reps)
    live_uids = {t.uid for t in fleet._tracked.values()}
    assert any(set(key[1]) <= live_uids for key in fleet._price_cache)


def test_drop_prices_shared_key_double_drop():
    decodes, _ = mix(n_decode=2, n_aux=0)
    fleet, _ = make_fleet(n_devices=1)
    for d in decodes:
        fleet.submit(d, priority=SLO)
    fleet.remove(decodes[0].name)
    fleet.remove(decodes[1].name)       # must not KeyError
    assert len(fleet) == 0
    assert fleet._uid_price_keys == {} and fleet._uid_rep_keys == {}


# ------------------------------------------------------------------ #
#  scoped repair: the bounded-divergence contract (tests/test_repair) #
# ------------------------------------------------------------------ #
N_DEV = 24
SCOPED_CFG = FleetConfig(max_group_size=3, queue_limit=64,
                         heartbeat_timeout=1e9,
                         full_replay_fraction=1.0, repair_probe=4)


def hetero_models(n=N_DEV):
    return {f"dev{i:02d}": (TPU_V5E if i % 2 == 0 else TPU_V5P)
            for i in range(n)}


def rand_workload(rng, name, slo=1.5):
    """Moderate demand, heavier on one random axis, a loose 1.5x SLO."""
    lean = ("mxu", "hbm")[int(rng.integers(2))]
    u = {"mxu": 0.10, "vpu": 0.04, "issue": 0.05, "hbm": 0.10, "l2": 0.10}
    u[lean] = float(rng.uniform(0.25, 0.45))
    if lean == "hbm":
        u["l2"] = u["hbm"]
    d = {r: u.get(r, 0.0) * TPU_V5E.capacity(r) for r in RESOURCE_AXES}
    return WorkloadProfile(
        name, (KernelProfile(f"{name}#step", demand=d, duration=1.0),),
        slo_slowdown=slo)


def cold_of(fleet, cfg):
    """A cold FULL replay over the online fleet's pool and surviving
    devices (one batched storm through a repair_mode="full" twin)."""
    survivors = {did: d.model for did, d in fleet.devices.items()
                 if d.state != "dead"}
    cold = FleetScheduler(survivors, replace(cfg, repair_mode="full"))
    cold.submit_many([(p, prio) for p, prio in fleet.workloads])
    return cold


def run_mutations(seed, steps=40):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    fleet = FleetScheduler(hetero_models(), SCOPED_CFG, clock=clock)
    pool = []
    next_id = 0
    for _ in range(steps):
        op = float(rng.random())
        if op < 0.55 or not pool:
            w = rand_workload(rng, f"w{next_id}")
            next_id += 1
            fleet.submit(w, priority=SLO if rng.random() < 0.5
                         else BEST_EFFORT)
            pool.append(w.name)
        elif op < 0.82:
            name = pool.pop(int(rng.integers(len(pool))))
            if name in fleet:
                fleet.remove(name)
        elif op < 0.92:
            live = [did for did, d in fleet.devices.items()
                    if d.state == "healthy"]
            if len(live) > N_DEV // 2:
                fleet.decommission(live[int(rng.integers(len(live)))])
        else:
            dead = [did for did, d in fleet.devices.items()
                    if d.state == "dead"]
            if dead:
                fleet.heartbeat(dead[int(rng.integers(len(dead)))])
        clock.advance(1.0)
    return fleet


@pytest.mark.parametrize("seed", range(6))
def test_random_mutations_bounded_divergence(seed):
    fleet = run_mutations(seed)
    assert fleet.stats["errors"] == 0
    assert fleet.stats["scoped_repairs"] > 0
    plan = fleet.plan()
    cplan = cold_of(fleet, SCOPED_CFG).plan()
    eps = SCOPED_CFG.divergence_epsilon
    assert plan.total_gain >= (1.0 - eps) * cplan.total_gain - 1e-9
    slo_names = {p.name for p, prio in fleet.workloads if prio == SLO}
    assert ({n for n in slo_names if n in plan.placed}
            == {n for n in slo_names if n in cplan.placed})


@pytest.mark.parametrize("seed", range(3))
def test_scoped_repairs_touch_few_devices(seed):
    fleet = run_mutations(seed)
    scoped = [r for r in fleet.repairs if not r.full]
    assert scoped
    assert max(r.devices_touched for r in scoped) < N_DEV


def test_small_fleet_defaults_bit_preserve_full_replay():
    cfg = FleetConfig(max_group_size=3, heartbeat_timeout=1e9)
    models = {f"dev{i}": TPU_V5E for i in range(4)}
    fleet = FleetScheduler(models, cfg, clock=FakeClock())
    rng = np.random.default_rng(7)
    for i in range(8):
        fleet.submit(rand_workload(rng, f"w{i}"),
                     priority=SLO if i % 2 == 0 else BEST_EFFORT)
    fleet.remove("w2")
    assert fleet.stats["replans"] == fleet.stats["full_replays"]
    assert fleet.stats["scoped_repairs"] == 0
    cold = cold_fleet(fleet, models, cfg)
    assert fleet_plans_equal(fleet.plan(), cold.plan())


def test_forced_full_mode_never_scopes():
    fleet = FleetScheduler(hetero_models(8),
                           replace(SCOPED_CFG, repair_mode="full"),
                           clock=FakeClock())
    rng = np.random.default_rng(3)
    for i in range(4):
        fleet.submit(rand_workload(rng, f"w{i}"))
    assert fleet.stats["scoped_repairs"] == 0
    assert fleet.stats["replans"] == fleet.stats["full_replays"]


def test_scope_merge_unions_and_full_wins():
    a = RepairScope("device-dead", "dev down", workloads=("a", "b"),
                    devices=("d0",))
    b = RepairScope("retry", "retry c", workloads=("b", "c"),
                    devices=("d1",))
    m = a.merge(b)
    assert m.workloads == ("a", "b", "c") and m.devices == ("d0", "d1")
    assert m.kind == "device-dead+retry"
    assert a.merge(RepairScope.full("oops")).kind == "full"


def test_fake_clock_is_monotonic():
    clock = FakeClock(start=1.5)
    assert clock() == 1.5
    assert clock.advance(0.5) == 2.0
    assert clock() == 2.0
    with pytest.raises(ValueError):
        clock.advance(-0.1)
    assert clock() == 2.0


# ------------------------------------------------------------------ #
#  The same fault script through both packages                        #
# ------------------------------------------------------------------ #
def _scripted(core, inject, clock_cls, scoped):
    """A kill, a storm, a departure and a straggler on a 6-device fleet of
    two models, driven by ``inject``'s FaultInjector into ``core``'s fleet;
    with ``scoped`` every repair is local (the 24-device regime's knobs)."""
    v5e, v5p = core.DEVICES["tpu_v5e"], core.DEVICES["tpu_v5p"]
    works = decode_heavy_mix(v5e, n_decode=4, n_aux=6, core=core)
    decodes, auxes = works[:4], works[4:]
    # the search given explicitly: the port's default on its torch backend
    # is the denser grid
    kw = dict(max_group_size=3, heartbeat_timeout=3.0, backoff_base=1.0,
              max_retries=3, fraction_search=core.FractionSearchConfig())
    if scoped:
        kw.update(full_replay_fraction=1.0, repair_probe=2)
    clock = clock_cls()
    fleet = core.FleetScheduler(
        {f"dev{i}": (v5e if i % 2 == 0 else v5p) for i in range(6)},
        core.FleetConfig(**kw), clock=clock)
    trace = ([inject.arrive(float(i), d, priority=core.SLO)
              for i, d in enumerate(decodes)]
             + inject.storm(4.0, auxes, priority=core.BEST_EFFORT)
             + [inject.kill(8.0, "dev1"), inject.depart(10.0, auxes[1].name),
                inject.slow(12.0, "dev4")])
    inject.FaultInjector(fleet, clock).run(trace, until=30.0)
    return fleet


def _fields(decision):
    return dataclasses.astuple(decision)


@pytest.mark.parametrize("scoped", [False, True], ids=["full", "scoped"])
def test_fault_script_gives_the_reference_decisions_and_placements(scoped):
    import repro_torch.ft.inject as tinject
    import repro_torch.core as tcore
    ref = _scripted(jc, jinject, jinject.FakeClock, scoped)
    got = _scripted(tcore, tinject, FakeClock, scoped)
    assert ref.stats["device_deaths"] == 1 and ref.stats["errors"] == 0
    assert any(d.action == "device-degraded" for d in ref.decisions)
    assert [_fields(d) for d in got.decisions] == [_fields(d) for d in ref.decisions]
    assert fleet_plans_equal(got.plan(), ref.plan(), tol=0.0)
    assert got.stats == ref.stats
    with solver_backend("torch", device="cpu"):
        on_torch = _scripted(tcore, tinject, FakeClock, scoped)
    assert [_fields(d) for d in on_torch.decisions] == [_fields(d) for d in ref.decisions]
    assert fleet_plans_equal(on_torch.plan(), ref.plan(), tol=TOL)
