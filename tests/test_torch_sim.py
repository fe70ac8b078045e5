"""The port's trace simulator, drift monitor and roofline reader
(`repro_torch.sim`, `repro_torch.calib.drift`, `repro_torch.core.roofline`)
against the JAX package's, on the CPU.

The twins of tests/test_sim.py and of tests/test_calib.py's drift cases
(``test_monitor_*``, ``test_scale_workload_*``, ``test_sim_*``; the drift
trace and its helpers from benchmarks/bench_calib.py restated here), run on
the port. Then the reference's gate trace (benchmarks/bench_trace.py:
seed 2026, 36 tenants, 240 virtual seconds, dev3 killed at t = 120, on 12
devices alternating v5e and v5p) through both packages on the NumPy
backend, whose reports are equal field for field, and a shorter trace on
the port's torch backend (``device="cpu"``) against the reference's jax
backend, both on ``DENSE_SEARCH``: the same decisions, numbers at 1e-9.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

import repro.core as jc
import repro.core.roofline as jroof
import repro.sim as jsim
import repro_torch.core as tc
import repro_torch.core.roofline as troof
import repro_torch.sim as tsim
from repro_torch.calib import DriftConfig, DriftMonitor, scale_workload
from repro_torch.core import BEST_EFFORT, SLO, TPU_V5E, TPU_V5P
from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.profile import KernelProfile, WorkloadProfile
from repro_torch.core.scenario import Scenario
from repro_torch.core.sensitivity import stressor
from repro_torch.sim import (RequestRecord, SimConfig, Simulator, Trace,
                             TraceConfig, generate_trace)
from repro_torch.sim.simulator import default_fleet_config

SMALL = TraceConfig(seed=3, duration=60.0, n_tenants=8, n_bursts=1)


def small_devices(n=6):
    return {f"dev{i}": TPU_V5E for i in range(n)}


def close(a, b, tol, path="report"):
    """``a`` equals ``b``, floats at rtol = atol = ``tol`` (0: exactly)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) and tol:
        assert isinstance(b, float), path
        assert a == b or math.isclose(a, b, rel_tol=tol, abs_tol=tol), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def decisions(fleet):
    return [dataclasses.astuple(d) for d in fleet.decisions]


# ------------------------------------------------------------------ #
#  trace generation determinism                                       #
# ------------------------------------------------------------------ #
def events_key(trace):
    return [(e.t, e.kind, {k: v for k, v in e.payload.items()
                           if k != "workload"})
            for e in trace.events]


def test_same_seed_same_trace_bit_for_bit():
    a, b = generate_trace(SMALL), generate_trace(SMALL)
    assert events_key(a) == events_key(b)
    assert set(a.tenants) == set(b.tenants)
    for name in a.tenants:
        ta, tb = a.tenants[name], b.tenants[name]
        assert (ta.arch, ta.priority, ta.tbt_base, ta.tbt_slo,
                ta.arrival, ta.depart) == \
               (tb.arch, tb.priority, tb.tbt_base, tb.tbt_slo,
                tb.arrival, tb.depart)


def test_explicit_generator_is_the_single_rng_source():
    a = generate_trace(SMALL)
    b = generate_trace(SMALL, rng=np.random.default_rng(SMALL.seed))
    assert events_key(a) == events_key(b)


def test_different_seed_different_trace():
    a = generate_trace(SMALL)
    b = generate_trace(TraceConfig(**{**SMALL.__dict__, "seed": 4}))
    assert events_key(a) != events_key(b)


def test_trace_shape():
    tr = generate_trace(SMALL)
    assert isinstance(tr, Trace)
    n_storm = sum(1 for t in tr.tenants.values() if t.arrival == 0.0)
    assert n_storm >= int(SMALL.n_tenants * SMALL.storm_fraction)
    assert tr.n_requests > 0
    assert all(e.t <= tr.duration for e in tr.events)
    assert tr.tenants_of(SLO) and tr.tenants_of(BEST_EFFORT)
    for e in tr.events:
        if e.kind != "request":
            continue
        spec = tr.tenants[e.payload["tenant"]]
        assert spec.arrival <= e.t
        assert spec.depart is None or e.t < spec.depart
        assert SMALL.min_tokens <= e.payload["n_tokens"] <= SMALL.max_tokens


def test_churn_departs_and_replaces_best_effort():
    cfg = TraceConfig(seed=1, duration=80.0, n_tenants=12,
                      slo_fraction=0.5, churn_fraction=0.5)
    tr = generate_trace(cfg)
    departs = [e for e in tr.events if e.kind == "depart"]
    assert departs
    for e in departs:
        assert tr.tenants[e.payload["name"]].priority == BEST_EFFORT
    assert len(tr.tenants) == cfg.n_tenants + len(departs)


# ------------------------------------------------------------------ #
#  simulator closed loop                                              #
# ------------------------------------------------------------------ #
def test_same_seed_same_report_bit_for_bit():
    r1 = Simulator(generate_trace(SMALL), small_devices()).run()
    r2 = Simulator(generate_trace(SMALL), small_devices()).run()
    assert r1 == r2


def test_simulator_serves_and_reports():
    rep = Simulator(generate_trace(SMALL), small_devices()).run()
    assert rep["fleet"]["event_loop_errors"] == 0
    assert rep["requests"]["total"] == generate_trace(SMALL).n_requests
    assert rep["requests"]["completed"] > 0
    assert rep["goodput"]["tokens_per_s"] > 0
    assert 0.0 <= rep["slo"]["overall"]["attainment"] <= 1.0
    assert set(rep["devices"]["utilization"]) == set(small_devices())


def test_kill_mid_trace_detected_and_survived():
    cfg = TraceConfig(**{**SMALL.__dict__, "kills": ((30.0, "dev2"),)})
    rep = Simulator(generate_trace(cfg), small_devices()).run()
    assert rep["fleet"]["device_deaths"] == 1
    assert rep["devices"]["states"]["dev2"] == "dead"
    assert rep["fleet"]["event_loop_errors"] == 0
    assert rep["requests"]["completed"] > 0


def test_depart_cancels_outstanding_requests():
    cfg = TraceConfig(seed=9, duration=80.0, n_tenants=10,
                      churn_fraction=1.0, slo_fraction=0.2)
    tr = generate_trace(cfg)
    assert any(e.kind == "depart" for e in tr.events)
    rep = Simulator(tr, small_devices()).run()
    res = rep["slo"]["overall"]
    assert res["resolved"] + rep["requests"]["canceled"] <= \
        rep["requests"]["total"]
    assert rep["fleet"]["event_loop_errors"] == 0


def test_storm_admitted_in_one_replay():
    tr = generate_trace(SMALL)
    n_storm = sum(1 for t in tr.tenants.values() if t.arrival == 0.0)
    assert n_storm > 1
    sim = Simulator(tr, small_devices())
    sim.run()
    storm_decisions = [d for d in sim.fleet.decisions
                       if "arrival storm" in d.reason]
    assert storm_decisions, "t=0 storm must go through submit_many"


def test_unplaced_tenants_age_not_served():
    rep = Simulator(generate_trace(SMALL), small_devices(1)).run()
    assert rep["fleet"]["event_loop_errors"] == 0
    assert rep["slo"]["overall"]["missed"] > 0


# ------------------------------------------------------------------ #
#  metrics                                                            #
# ------------------------------------------------------------------ #
def test_request_record_deadline_and_slo():
    r = RequestRecord(tenant="t", req_id=0, arrival=10.0, n_tokens=100,
                      priority=SLO, tbt_slo=0.01, slack=2.0)
    assert r.deadline == pytest.approx(13.0)
    assert r.met_slo(now=12.0) is None          # censored
    assert r.met_slo(now=14.0) is False         # deadline passed, unfinished
    r.finish = 12.5
    assert r.met_slo(now=14.0) is True
    assert r.latency == pytest.approx(2.5)
    assert r.observed_tbt == pytest.approx(0.025)
    r.canceled = True
    assert r.met_slo(now=99.0) is None          # canceled never resolves


def test_sim_config_defaults():
    s = SimConfig()
    assert s.tick_dt > 0 and s.settle >= 0


# ------------------------------------------------------------------ #
#  drift monitor (tests/test_calib.py's drift cases)                  #
# ------------------------------------------------------------------ #
def test_monitor_flags_after_warmup_only():
    mon = DriftMonitor(DriftConfig(warmup=4, threshold=0.15))
    newly = [mon.observe("w", 1.0, 1.5) for _ in range(6)]
    assert newly.index(True) == 3            # obs #4 = first eligible
    assert sum(newly) == 1                   # flag fires once
    assert mon.is_flagged("w") and mon.flags == 1
    assert mon.divergence("w") > 0.15


def test_monitor_silent_on_agreement_and_small_noise():
    mon = DriftMonitor(DriftConfig(warmup=3, threshold=0.15))
    rng = np.random.default_rng(0)
    for _ in range(50):
        assert not mon.observe("w", 2.0, 2.0)
        assert not mon.observe("v", 1.5,
                               1.5 * math.exp(0.01 * rng.standard_normal()))
    assert mon.flagged == [] and mon.flags == 0


def test_monitor_forget_drops_state():
    mon = DriftMonitor(DriftConfig(warmup=1))
    mon.observe("w", 1.0, 2.0)
    assert mon.is_flagged("w")
    mon.forget("w")
    assert not mon.is_flagged("w") and mon.flagged == []
    assert mon.flags == 1                    # history of flag events stays


def _drift_pair(scale=1.7):
    """Believed vs true (scaled) single-kernel roofline-bound workload plus
    a contending background."""
    dev = TPU_V5P
    k = KernelProfile("k", demand={"hbm": 0.5 * dev.capacity("hbm")},
                      duration=0.5)
    believed = WorkloadProfile("w", kernels=(k,))
    true = scale_workload(believed, scale)
    background = (stressor("hbm", 0.9, dev),)
    return dev, believed, true, background


def _fold(w, background, believed, dev):
    s = solve_scenarios([Scenario((w.kernels[0],), background)],
                        dev).slowdowns[0, 0]
    return float(s) * w.total_time(dev) / believed.total_time(dev)


def test_monitor_refit_recovers_demand_scale():
    dev, believed, true, bg = _drift_pair(scale=1.7)
    mon = DriftMonitor(DriftConfig(warmup=3))
    pred = _fold(believed, bg, believed, dev)
    obs = _fold(true, bg, believed, dev)
    assert obs > pred
    flagged = [mon.observe("w", pred, obs, bg, None, dev)
               for _ in range(5)]
    assert any(flagged)
    refit = mon.refit("w", believed)
    got = (refit.kernels[0].demand["hbm"]
           / believed.kernels[0].demand["hbm"])
    assert got == pytest.approx(1.7, rel=0.1)
    assert not mon.is_flagged("w")
    assert mon.refits == 1
    assert _fold(refit, bg, believed, dev) == pytest.approx(obs, rel=0.05)


def test_monitor_refit_budget_and_empty_cases():
    dev, believed, true, bg = _drift_pair()
    mon = DriftMonitor(DriftConfig(warmup=1, max_refits=1))
    assert not mon.can_refit("unseen")
    assert mon.refit("unseen", believed) is None
    mon.observe("w", 1.0, 2.0)               # no device -> no samples
    assert not mon.can_refit("w")
    obs = _fold(true, bg, believed, dev)
    mon.observe("w", 1.0, obs, bg, None, dev)
    assert mon.can_refit("w")
    assert mon.refit("w", believed) is not None
    mon.observe("w", 1.0, obs, bg, None, dev)
    assert not mon.can_refit("w")            # budget spent
    assert mon.refit("w", believed) is None


def test_scale_workload_scales_demands_only():
    _, believed, _, _ = _drift_pair()
    s = scale_workload(believed, 2.0)
    assert s.kernels[0].demand["hbm"] == pytest.approx(
        2.0 * believed.kernels[0].demand["hbm"])
    assert s.kernels[0].duration == believed.kernels[0].duration
    assert s.name == believed.name


# the drift trace of benchmarks/bench_calib.py
SHIFT_T = 30.0
DRIFT_TRACE = dict(seed=11, duration=90.0, n_tenants=14, n_bursts=1,
                   churn_fraction=0.0)


def drift_devices(core=tc):
    return {f"dev{i}": (core.TPU_V5E if i % 2 else core.TPU_V5P)
            for i in range(6)}


def pick_shift_target():
    """bench_calib.pick_shift_target: the first (sorted device order)
    long-lived SLO tenant placed in a group of two or more, with a demand
    scale that pushes its roofline 1.4x past its duration."""
    trace = generate_trace(TraceConfig(**DRIFT_TRACE))
    sim = Simulator(trace, drift_devices())
    sim.run()
    plan = sim.fleet.plan()
    for did in sorted(plan.placements):
        p = plan.placements[did]
        if len(p.workloads) < 2:
            continue
        for name in p.workloads:
            spec = trace.tenants.get(name)
            if spec is None or spec.priority != SLO \
                    or spec.depart is not None:
                continue
            model = sim.fleet.devices[did].model
            umax = max(spec.profile.mixed_utilization(model).values())
            return name, 1.4 / max(umax, 1e-9)
    raise RuntimeError("drift trace has no colocated SLO tenant to shift")


def run_drift(tenant, scale, sim_pkg=None, core=tc):
    sim_pkg = sim_pkg or tsim
    cfg = sim_pkg.TraceConfig(**DRIFT_TRACE,
                              profile_shifts=((SHIFT_T, tenant, scale),))
    return sim_pkg.Simulator(sim_pkg.generate_trace(cfg),
                             drift_devices(core)).run()


@pytest.fixture(scope="module")
def clean_run():
    sim = Simulator(generate_trace(TraceConfig(**DRIFT_TRACE)),
                    drift_devices())
    return sim.run()


@pytest.fixture(scope="module")
def shift_target():
    return pick_shift_target()


@pytest.fixture(scope="module")
def shifted_run(shift_target):
    return run_drift(*shift_target)


def test_sim_clean_trace_zero_flags(clean_run):
    calib = clean_run["calib"]
    assert calib["observations"] > 0
    assert calib["flags"] == 0 and calib["refits"] == 0
    assert calib["flagged_tenants"] == []


def test_sim_shift_flags_and_refits_exactly_the_tenant(
        shift_target, shifted_run):
    tenant, _ = shift_target
    calib = shifted_run["calib"]
    assert calib["flags"] >= 1 and calib["refits"] >= 1
    assert calib["flagged_tenants"] == [tenant]
    assert shifted_run["fleet"]["event_loop_errors"] == 0


def test_sim_shifted_report_bit_identical(shift_target, shifted_run):
    assert run_drift(*shift_target) == shifted_run


def test_sim_calibration_can_be_disabled(shift_target):
    tenant, scale = shift_target
    cfg = TraceConfig(**DRIFT_TRACE,
                      profile_shifts=((SHIFT_T, tenant, scale),))
    sim = Simulator(generate_trace(cfg), drift_devices(),
                    sim_config=SimConfig(calibrate=False))
    report = sim.run()
    assert sim.fleet.calib is None
    assert report["calib"] == {"observations": 0, "flags": 0,
                               "refits": 0, "flagged_tenants": []}


def test_sim_shift_unknown_tenant_raises():
    cfg = TraceConfig(**DRIFT_TRACE,
                      profile_shifts=((5.0, "nope", 2.0),))
    sim = Simulator(generate_trace(cfg), drift_devices())
    with pytest.raises(KeyError):
        sim.run()


def test_drift_reports_equal_the_reference(shift_target, clean_run):
    """bench_calib's drift run and its clean twin, through both packages
    on the NumPy backend: equal field for field."""
    shifted = run_drift(*shift_target)
    close(shifted, run_drift(*shift_target, sim_pkg=jsim, core=jc), 0.0)
    assert shifted["calib"]["refits"] >= 1
    ref_clean = jsim.Simulator(jsim.generate_trace(jsim.TraceConfig(**DRIFT_TRACE)),
                               drift_devices(jc)).run()
    close(clean_run, ref_clean, 0.0)


# ------------------------------------------------------------------ #
#  The reference's gate trace through both packages                   #
# ------------------------------------------------------------------ #
GATE_TRACE = dict(seed=2026, duration=240.0, n_tenants=36,
                  kills=((120.0, "dev3"),))


def hetero_models(core, n_devices=12):
    return {f"dev{i}": (core.TPU_V5E if i % 2 == 0 else core.TPU_V5P)
            for i in range(n_devices)}


def simulate(sim_pkg, core, trace_kw, n_devices=12, fleet_config=None):
    sim = sim_pkg.Simulator(sim_pkg.generate_trace(sim_pkg.TraceConfig(**trace_kw)),
                            hetero_models(core, n_devices), fleet_config)
    return sim.run(), sim


def test_gate_trace_report_equals_the_reference_on_numpy():
    """The gate trace's report and decision log, field for field: the two
    packages' NumPy backends run the same arithmetic in the same order.
    ``RepairRecord.latency_s`` is wall-clock and is not in the report."""
    got, sim = simulate(tsim, tc, GATE_TRACE)
    want, ref = simulate(jsim, jc, GATE_TRACE)
    close(got, want, 0.0)
    assert decisions(sim.fleet) == decisions(ref.fleet)
    assert got["requests"]["total"] >= 1000 and got["trace"]["tenants"] >= 32
    assert got["fleet"]["device_deaths"] == 1
    assert got["slo"]["per_class"]["slo"]["attainment"] >= 0.95
    assert ([(r.kind, r.reason, r.full, r.targets, r.devices_touched) for r in sim.fleet.repairs]
            == [(r.kind, r.reason, r.full, r.targets, r.devices_touched)
                for r in ref.fleet.repairs])


def test_torch_backend_trace_matches_the_reference_jax_backend():
    """A shorter trace with a kill, on the port's torch solver (CPU) and on
    the reference's jax solver, both on DENSE_SEARCH: the same decisions
    and placements, the report at 1e-9."""
    trace_kw = dict(seed=7, duration=60.0, n_tenants=12, n_bursts=1,
                    kills=((30.0, "dev3"),))
    port_cfg = dataclasses.replace(default_fleet_config(),
                                   fraction_search=tc.DENSE_SEARCH)
    ref_cfg = jc.FleetConfig(**{**dataclasses.asdict(port_cfg),
                                "fraction_search": jc.DENSE_SEARCH})
    with tc.solver_backend("torch", device="cpu"):
        got, sim = simulate(tsim, tc,
                            trace_kw, 6, port_cfg)
    with jc.solver_backend("jax"):
        want, ref = simulate(jsim, jc, trace_kw, 6, ref_cfg)
    close(got, want, 1e-9)
    assert decisions(sim.fleet) == decisions(ref.fleet)
    assert got["fleet"]["device_deaths"] == 1 and got["fleet"]["event_loop_errors"] == 0
    gp, rp = sim.fleet.plan(), ref.fleet.plan()
    assert gp.placed == rp.placed
    for did, p in gp.placements.items():
        q = rp.placements[did]
        assert p.slot_fraction == q.slot_fraction
        assert p.throughput_gain == pytest.approx(q.throughput_gain, rel=1e-9, abs=1e-9)


# ------------------------------------------------------------------ #
#  core/roofline.py on a dry-run record                               #
# ------------------------------------------------------------------ #
def _dryrun_record(arch, shape, kind, n_chips, **extra):
    return {"arch": arch, "shape": shape, "kind": kind, "n_chips": n_chips,
            "n_params": 1.7e9, "n_active_params": 1.5e9, "recipe": "fsdp_tp",
            "hlo_exec": {"mxu_flops": 3.1e15, "hbm_bytes": 4.2e11},
            "collectives": {"total_bytes": 6.0e10},
            "memory": {"argument_bytes": 5e9, "temp_bytes": 7e9,
                       "output_bytes": 2e9, "alias_bytes": 1e9}, **extra}


def test_roofline_rows_equal_the_reference(tmp_path):
    recs = [_dryrun_record("qwen3-1.7b", "train_4k", "train", 256),
            _dryrun_record("gemma3-1b", "decode_32k", "decode", 256, multi_pod=True),
            _dryrun_record("llama3.1-8b", "prefill_32k", "prefill", 256),
            _dryrun_record("hubert-xlarge", "long_500k", "decode", 256, tag="other"),
            {"arch": "x", "skipped": True}]
    for i, rec in enumerate(recs):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(rec))
    got = troof.load_results(str(tmp_path))
    want = jroof.load_results(str(tmp_path))
    assert len(got) == 3
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert troof.table(got) == jroof.table(want)
    assert [dataclasses.asdict(r) for r in troof.load_results(str(tmp_path), tag="other")] \
        == [dataclasses.asdict(r) for r in jroof.load_results(str(tmp_path), tag="other")]
    for rec in recs[:3]:
        assert (dataclasses.asdict(troof.analyze_record(rec, tc.H100))
                == dataclasses.asdict(jroof.analyze_record(rec, jc.H100)))
