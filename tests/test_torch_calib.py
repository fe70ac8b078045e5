"""repro_torch.calib and the sensitivity library against the JAX package's,
on the CPU, in one process.

The twins of tests/test_calib.py's measure → fit → validate tests: the
port's copies of the NumPy modules must give what the reference gives on
the same inputs — identical colocation lists, bit-identical synthetic
measurements on the same truths, seed and noise, and fitted parameters and
validation reports equal to 1e-12 (the two solvers are the same NumPy code,
so they agree to the last bit or to the order of a sum). ``TorchBackend``
needs the card: on the CPU it raises.
"""
import importlib

import numpy as np
import pytest

import repro.calib as rc
import repro_torch.calib as tc
from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.resources import RESOURCE_AXES, TPU_V5E, TPU_V5P

# the modules themselves (both packages' core/__init__ export a function
# named `sensitivity`, which shadows the module as an attribute)
rfs, rprof, rres, rsens = (importlib.import_module(f"repro.core.{m}") for m in
                           ("fracsearch", "profile", "resources", "sensitivity"))
tfs, tprof, tres, tsens = (importlib.import_module(f"repro_torch.core.{m}") for m in
                           ("fracsearch", "profile", "resources", "sensitivity"))

DEV = TPU_V5E
PAIRS = [(tres.TPU_V5E, rres.TPU_V5E), (tres.H100, rres.H100)]


def base_kernels(P, dev) -> dict:
    """A diverse victim set built in package ``P`` (either profile module):
    bandwidth-bound decode, matmul-bound gemm, vector scan, and a
    cache-resident attention-like kernel."""
    C = dev.capacity
    return {
        "decode": P.KernelProfile("decode", demand={
            "hbm": 0.70 * C("hbm"), "mxu": 0.25 * C("mxu"),
            "issue": 0.30 * C("issue")}, duration=1.0),
        "gemm": P.KernelProfile("gemm", demand={
            "mxu": 0.85 * C("mxu"), "hbm": 0.20 * C("hbm")}, duration=1.0),
        "scan": P.KernelProfile("scan", demand={
            "vpu": 0.75 * C("vpu"), "issue": 0.45 * C("issue"),
            "smem": 0.30 * C("smem"), "hbm": 0.25 * C("hbm")}, duration=1.0),
        "attn": P.KernelProfile("attn", demand={
            "hbm": 0.60 * C("hbm"), "vpu": 0.30 * C("vpu")}, duration=1.0,
            cache_working_set=0.5 * dev.cache_capacity, cache_hit_fraction=0.6),
    }


def truths(seed=7, names=("decode", "gemm", "attn"), pair=PAIRS[0]):
    """The same perturbed ground truths in both packages."""
    out = []
    for P, C, dev in ((tprof, tc, pair[0]), (rprof, rc, pair[1])):
        rng = np.random.default_rng(seed)
        base = base_kernels(P, dev)
        out.append({n: C.perturb_profile(base[n], rng, scale=0.25, dev=dev)
                    for n in names})
    return out


def as_tuples(cols):
    return [(c.victim, tuple((s.axis, s.intensity, s.working_set) for s in c.stressors),
             c.cohort, c.observe) for c in cols]


def report_values(rep):
    j = rep.to_json()
    return ([j["n_mixes"], j["max_rel_error"], j["mean_rel_error"]]
            + [v for _, v in sorted(j["per_victim"].items())]
            + [v for _, v in sorted(j["per_axis"].items())]), j["worst_mix"]


# ------------------------------------------------------------------ #
#  the stressor() builder occupies exactly lambda                      #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dev", [TPU_V5E, TPU_V5P, tres.H100],
                         ids=["v5e", "v5p", "h100"])
@pytest.mark.parametrize("lam", [0.1, 0.5, 0.9])
def test_stressor_occupies_lambda_on_axis(dev, lam):
    for axis in RESOURCE_AXES:
        st = tsens.stressor(axis, lam, dev)
        u = st.utilization(dev)
        assert u[axis] == pytest.approx(lam, rel=1e-9)
        assert all(u[o] == 0.0 for o in RESOURCE_AXES if o != axis)
        assert st.isolated_time(dev) == pytest.approx(1.0)
        ref = rsens.stressor(axis, lam, rres.DEVICES[dev.name])
        assert st.name == ref.name and st.demand == ref.demand


# ------------------------------------------------------------------ #
#  measurement sweep structure                                        #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("pair", PAIRS, ids=["v5e", "h100"])
def test_sweep_is_the_references(pair):
    cols = tc.sweep_colocations(["a", "b"], pair[0])
    assert as_tuples(cols) == as_tuples(rc.sweep_colocations(["a", "b"], pair[1]))
    axes = ("mxu", "vpu", "hbm", "smem")
    assert as_tuples(tc.sweep_colocations(["v"], pair[0], axes, tc.FIT_LAMBDAS,
                                          tc.CACHE_WS_FRACTIONS)) == \
        as_tuples(rc.sweep_colocations(["v"], pair[1], axes, rc.FIT_LAMBDAS,
                                       rc.CACHE_WS_FRACTIONS))
    for v in ("a", "b"):
        mine = [c for c in cols if c.victim == v]
        assert {c.single_axis for c in mine if c.single_axis} == set(RESOURCE_AXES)
        assert any(c.observe == "stressor" for c in mine)
        assert any(len(c.stressors) > 1 for c in mine)
        ws = sorted(c.stressors[0].working_set for c in mine if c.is_cache_probe)
        assert ws == sorted(f * pair[0].cache_capacity for f in tc.CACHE_WS_FRACTIONS)


def test_grids_are_the_references():
    assert (tc.FIT_LAMBDAS, tc.CACHE_WS_FRACTIONS, tc.REVERSE_LAMBDAS,
            tc.HOLDOUT_LAMBDAS) == (rc.FIT_LAMBDAS, rc.CACHE_WS_FRACTIONS,
                                    rc.REVERSE_LAMBDAS, rc.HOLDOUT_LAMBDAS)
    for seed in (0, 3):
        names = ["decode", "gemm", "attn"]
        assert as_tuples(tc.holdout_mixes(names, np.random.default_rng(seed))) == \
            as_tuples(rc.holdout_mixes(names, np.random.default_rng(seed)))


def test_colocation_scenario_reverse_probe_observes_stressor():
    k = tprof.KernelProfile("k", demand={"hbm": 0.5 * DEV.capacity("hbm")},
                            duration=1.0)
    c = tc.Colocation("k", (tc.StressorSpec("hbm", 0.9),), observe="stressor")
    sc = tc.colocation_scenario(c, k, DEV, {})
    assert sc.victims[0].name.startswith("stress:hbm")
    assert k in sc.background
    with pytest.raises(ValueError):
        tc.colocation_scenario(tc.Colocation("k", (), observe="stressor"), k, DEV, {})


def test_reverse_probe_reveals_sub_fair_share_demand():
    u = 0.3
    k = tprof.KernelProfile("k", demand={"mxu": u * DEV.capacity("mxu")}, duration=1.0)
    fwd = tc.colocation_scenario(
        tc.Colocation("k", (tc.StressorSpec("mxu", 0.9),)), k, DEV, {})
    rev = tc.colocation_scenario(
        tc.Colocation("k", (tc.StressorSpec("mxu", 0.9),), observe="stressor"),
        k, DEV, {})
    s_fwd, s_rev = solve_scenarios([fwd, rev], DEV).slowdowns[:, 0]
    assert s_fwd == pytest.approx(1.0)
    assert s_rev == pytest.approx(0.9 / (1.0 - u), rel=1e-6)


# ------------------------------------------------------------------ #
#  synthetic backend                                                  #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("pair", PAIRS, ids=["v5e", "h100"])
@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_synthetic_backend_equals_the_references(pair, noise):
    t_truth, r_truth = truths(pair=pair)
    a = tc.SyntheticBackend(t_truth, pair[0], noise=noise, seed=5).run_sweep(sorted(t_truth))
    b = rc.SyntheticBackend(r_truth, pair[1], noise=noise, seed=5).run_sweep(sorted(r_truth))
    assert np.array_equal(a.slowdowns, b.slowdowns)
    assert a.isolated_times == b.isolated_times
    assert as_tuples(a.colocations) == as_tuples(b.colocations)


def test_synthetic_backend_same_seed_bit_identical():
    truth, _ = truths()
    a = tc.SyntheticBackend(truth, DEV, noise=0.02, seed=5).run_sweep(sorted(truth))
    b = tc.SyntheticBackend(truth, DEV, noise=0.02, seed=5).run_sweep(sorted(truth))
    assert np.array_equal(a.slowdowns, b.slowdowns)
    c = tc.SyntheticBackend(truth, DEV, noise=0.02, seed=6).run_sweep(sorted(truth))
    assert not np.array_equal(a.slowdowns, c.slowdowns)


def test_synthetic_backend_hides_truth_but_serves_it():
    truth, _ = truths(names=("decode",))
    be = tc.SyntheticBackend(truth, DEV)
    cols = [tc.Colocation("decode", (tc.StressorSpec("hbm", 0.9),))]
    expect = solve_scenarios(
        [tc.colocation_scenario(cols[0], truth["decode"], DEV, truth)], DEV).slowdowns[0, 0]
    assert be.measure(cols)[0] == pytest.approx(float(expect))
    assert be.isolated_time("decode") == pytest.approx(truth["decode"].isolated_time(DEV))


# ------------------------------------------------------------------ #
#  round-trip fit and validation, both packages                       #
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def roundtrip():
    """One fit per package on the same truths (seed 7), and the validation
    of each on the same held-out mixes."""
    out = {}
    for name, C, dev, truth in (("torch", tc, TPU_V5E, truths()[0]),
                                ("ref", rc, rres.TPU_V5E, truths()[1])):
        be = C.SyntheticBackend(truth, dev, seed=7)
        fitted = C.fit_profiles(be.run_sweep(sorted(truth)))
        rep = C.validate(fitted, be, C.holdout_mixes(sorted(truth),
                                                     np.random.default_rng(107)))
        out[name] = (truth, fitted, rep)
    return out


def test_fit_parameters_equal_the_references(roundtrip):
    _, t_fit, _ = roundtrip["torch"]
    _, r_fit, _ = roundtrip["ref"]
    assert sorted(t_fit) == sorted(r_fit)
    for n in t_fit:
        got = tc.profile_to_params(t_fit[n], TPU_V5E)
        want = rc.profile_to_params(r_fit[n], rres.TPU_V5E)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), (n, k)
        assert t_fit[n].duration == pytest.approx(r_fit[n].duration, rel=1e-12)


def test_validation_reports_equal_the_references(roundtrip):
    got, got_worst = report_values(roundtrip["torch"][2])
    want, want_worst = report_values(roundtrip["ref"][2])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got_worst == want_worst
    assert roundtrip["torch"][2].max_rel_error <= 0.05


def test_roundtrip_recovers_axis_demands_and_cache_knobs(roundtrip):
    truth, fitted, _ = roundtrip["torch"]
    for name, true_k in truth.items():
        got = tc.profile_to_params(fitted[name], DEV)
        want = tc.profile_to_params(true_k, DEV)
        for axis in RESOURCE_AXES:
            if want[f"u:{axis}"] > 0.05:
                assert got[f"u:{axis}"] == pytest.approx(want[f"u:{axis}"], abs=0.03)
        if want["ws"] > 0:
            assert got["ws"] == pytest.approx(want["ws"], rel=0.5)
            assert got["hit"] == pytest.approx(want["hit"], abs=0.15)
        assert fitted[name].isolated_time(DEV) == pytest.approx(true_k.isolated_time(DEV))


def test_roundtrip_survives_measurement_noise():
    truth, _ = truths(seed=3, names=("decode", "scan"))
    be = tc.SyntheticBackend(truth, DEV, noise=0.01, seed=3)
    fitted = tc.fit_profiles(be.run_sweep(sorted(truth)))
    rep = tc.validate(fitted, tc.SyntheticBackend(truth, DEV, seed=3),
                      tc.holdout_mixes(sorted(truth), np.random.default_rng(103)))
    assert rep.max_rel_error <= 0.15


def test_perturb_profile_seeded_feasible_and_the_references():
    base = base_kernels(tprof, DEV)["decode"]
    a = tc.perturb_profile(base, np.random.default_rng(9), dev=DEV)
    b = tc.perturb_profile(base, np.random.default_rng(9), dev=DEV)
    r = rc.perturb_profile(base_kernels(rprof, rres.TPU_V5E)["decode"],
                           np.random.default_rng(9), dev=rres.TPU_V5E)
    assert a.demand == b.demand == r.demand and a.duration == r.duration
    for i in range(20):
        p = tc.perturb_profile(base, np.random.default_rng(i), scale=0.6, dev=DEV)
        assert all(u <= 1.0 + 1e-9 for u in p.utilization(DEV).values())


def test_predict_slowdowns_matches_backend_and_the_reference():
    t_truth, r_truth = truths(seed=11)
    cols = tc.sweep_colocations(sorted(t_truth), DEV)
    got = tc.predict_slowdowns(t_truth, cols, DEV)
    np.testing.assert_allclose(got, tc.SyntheticBackend(t_truth, DEV).measure(cols),
                               rtol=1e-9)
    want = rc.predict_slowdowns(r_truth, rc.sweep_colocations(sorted(r_truth),
                                                              rres.TPU_V5E),
                                rres.TPU_V5E)
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ #
#  the sensitivity library and the fraction search                    #
# ------------------------------------------------------------------ #
def test_sensitivity_batch_equals_the_references():
    t_k = list(base_kernels(tprof, tres.H100).values())
    r_k = list(base_kernels(rprof, rres.H100).values())
    got = tsens.sensitivity_batch(t_k, tres.H100)
    want = rsens.sensitivity_batch(r_k, rres.H100)
    assert [g.curves for g in got] == [w.curves for w in want]
    assert [g.ranked() for g in got] == [w.ranked() for w in want]
    assert tsens.sensitivity(t_k[0], tres.H100).scores == \
        rsens.sensitivity(r_k[0], rres.H100).scores


def test_cache_pollution_curve_equals_the_references():
    t_k = base_kernels(tprof, tres.H100)["attn"]
    r_k = base_kernels(rprof, rres.H100)["attn"]
    ws = [f * 50e6 for f in (0.1, 0.25, 0.5, 1.0, 2.0, 4.0)]
    assert tsens.cache_pollution_curve(t_k, tres.H100, ws) == \
        rsens.cache_pollution_curve(r_k, rres.H100, ws)


def _workloads(P):
    ks = base_kernels(P, tres.H100 if P is tprof else rres.H100)
    return [P.WorkloadProfile("w_decode", (ks["decode"],), slo_slowdown=1.5),
            P.WorkloadProfile("w_gemm", (ks["gemm"], ks["attn"]), slo_slowdown=2.0),
            P.WorkloadProfile("w_scan", (ks["scan"],), slo_slowdown=1.3)]


@pytest.mark.parametrize("member", [0, 2])
def test_partition_curve_equals_the_references(member):
    fr = [0.2, 0.4, 0.5, 0.75]
    assert tsens.partition_curve(_workloads(tprof), tres.H100, member, fr) == \
        rsens.partition_curve(_workloads(rprof), rres.H100, member, fr)
    with pytest.raises(ValueError):
        tsens.partition_curve(_workloads(tprof), tres.H100, 3, fr)


def test_fraction_search_equals_the_references():
    t_w, r_w = _workloads(tprof), _workloads(rprof)
    groups_t, groups_r = [t_w[:2], t_w], [r_w[:2], r_w]
    for cfg_t, cfg_r in ((tfs.FractionSearchConfig(), rfs.FractionSearchConfig()),
                         (tfs.LEGACY_SEARCH, rfs.LEGACY_SEARCH),
                         (tfs.DENSE_SEARCH, rfs.DENSE_SEARCH)):
        got = tfs.search_group_fractions(groups_t, tres.H100, cfg_t)
        want = rfs.search_group_fractions(groups_r, rres.H100, cfg_r)
        assert [(g.fractions, g.gain, g.meets_slo, g.slowdowns) for g in got] == \
            [(w.fractions, w.gain, w.meets_slo, w.slowdowns) for w in want]
    assert tfs.simplex_candidates(3, 6) == rfs.simplex_candidates(3, 6)
    # one solver in the port: the default is the standard grid
    assert tfs.FractionSearchConfig.default() == tfs.FractionSearchConfig()


# ------------------------------------------------------------------ #
#  timer and torch backend                                            #
# ------------------------------------------------------------------ #
def test_median_iqr_time_sanity():
    calls = []
    med, iqr = tc.median_iqr_time(lambda: calls.append(1), repeats=5, warmup=2)
    assert len(calls) == 7
    assert med > 0.0 and iqr >= 0.0


def test_torch_backend_refuses_the_cpu():
    with pytest.raises(ValueError):
        tc.TorchBackend({"v": lambda: None}, tres.H100, device="cpu")


def test_torch_backend_has_the_pallas_backends_api():
    for name in ("isolated_time", "measure", "run_sweep"):
        assert callable(getattr(tc.TorchBackend, name))
        assert callable(getattr(rc.PallasBackend, name))
    import inspect
    assert inspect.signature(tc.TorchBackend.run_sweep).parameters.keys() == \
        inspect.signature(rc.PallasBackend.run_sweep).parameters.keys()


def test_gpu_native_victims_and_their_analytic_profiles():
    """The interference victims at qwen3-1.7b's widths, one layer, on the
    CPU: each runs, and its analytic profile is its bytes and FLOPs over
    the isolated time it is given."""
    from repro_torch.launch import gpu_native
    victims = gpu_native.attention_victims("cpu", n_layers=1)
    assert sorted(victims) == ["decode_attention_step", "prefill_chunk_attention"]
    dec = victims["decode_attention_step"]
    n_keys = sum(gpu_native.DECODE_KV_LEN)
    assert dec.flops == 4.0 * n_keys * 16 * 128
    assert dec.hbm_bytes >= 2 * 2 * n_keys * 8 * 128            # K and V, bf16
    # each on the axis its kernel runs: decode's FMAs on the FP32 pipes,
    # prefill's products on the tensor cores
    assert dec.axis == "vpu" and victims["prefill_chunk_attention"].axis == "mxu"
    for v in victims.values():
        v.fn()
        p = v.profile(2e-3)
        u = p.utilization(tres.H100)
        other = "vpu" if v.axis == "mxu" else "mxu"
        assert p.duration == 2e-3 and u[other] == 0.0
        assert u["hbm"] == pytest.approx(v.hbm_bytes / 2e-3 / tres.H100.hbm_bw)
        assert u[v.axis] == pytest.approx(v.flops / 2e-3 / tres.H100.capacity(v.axis))
    with pytest.raises(ValueError):
        gpu_native.interference_sweep("cpu")


class RecordingBackend(tc.SyntheticBackend):
    """A synthetic backend that keeps ``TorchBackend``'s per-run records."""

    def __init__(self, truth, dev):
        super().__init__(truth, dev)
        self.records = []

    def measure(self, colocations):
        out = super().measure(colocations)
        for c, s in zip(colocations, out):
            self.records.append({"colocation": c, "isolated_s": 1e-3,
                                 "colocated_s": 1e-3 * s, "slowdown": float(s),
                                 "bracket_margin_s": 1e-3, "background_dispatches": 4})
        return out


def test_measure_fit_validate_records_every_run():
    """The interference loop's records on a synthetic backend whose truths
    are the victims' own analytic profiles: 120 runs (48 sweep and 12
    held-out probes per victim), the analytic prediction equal to the
    measurement, the fitted one close, every run bracketed."""
    from repro_torch.launch import gpu_native
    victims = gpu_native.attention_victims("cpu", n_layers=1)
    truth = {n: v.profile(1e-3) for n, v in victims.items()}
    out = gpu_native.measure_fit_validate(victims, RecordingBackend(truth, tres.H100))
    cols = out["colocations"]
    assert len(cols) == 120 and out["brackets"]["all_bracketed"]
    assert sum(r["set"] == "holdout" for r in cols) == 24
    for r in cols:
        assert r["predicted_analytic"] == pytest.approx(r["measured"], rel=1e-9)
    for n, prof in out["profiles"].items():
        err = prof["prediction_error"]
        assert err["fit_set"]["analytic"] == pytest.approx(0.0, abs=1e-9)
        assert err["holdout"]["fitted"] <= 0.05
        assert out["validation"][n]["n_mixes"] == 12
