"""The port's copy of the NumPy interference estimator against
``repro.core``: the same seeded random scenarios through both packages.
Both run the same NumPy arithmetic in f64, so every ``BatchResult`` field
agrees at 1e-12 and the discrete ``bottleneck`` exactly."""
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.core.resources import RESOURCE_AXES


def random_profile(rng, core, name):
    demand = {r: float(rng.uniform(0, 1) ** 3 * scale) for r, scale in zip(
        RESOURCE_AXES, (4e12, 3e11, 5e9, 2e10, 3e10, 5e10, 1e9))}
    kw = {}
    if rng.uniform() < 0.4:      # a cacheable working set, some beyond the L2
        kw = dict(cache_working_set=float(rng.choice([4e6, 20e6, 45e6, 80e6])),
                  cache_hit_fraction=float(rng.uniform(0.2, 0.9)))
    if rng.uniform() < 0.2:
        kw["duration"] = float(rng.uniform(1e-3, 2e-2))
    if rng.uniform() < 0.3:
        kw["slots_needed"] = int(rng.integers(1, 140))
    return core.KernelProfile(name, demand=demand, **kw)


def random_scenarios(seed, n, k_max=4):
    """The same scenarios for both packages, each built from its own
    classes."""
    out = {}
    for core in (jc, tc):
        rng = np.random.default_rng(seed)
        pool = [random_profile(rng, core, f"k{i}") for i in range(24)]
        scs = []
        for _ in range(n):
            k = int(rng.integers(1, k_max + 1))
            members = [pool[i] for i in rng.choice(len(pool), size=k, replace=False)]
            nv = int(rng.integers(1, k + 1))
            frac = None
            if rng.uniform() < 0.4:
                frac = {m.name: float(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0]))
                        for m in members if rng.uniform() < 0.7}
            scs.append(core.Scenario(tuple(members[:nv]), tuple(members[nv:]), frac))
        out[core] = scs
    return out[jc], out[tc]


@pytest.mark.parametrize("device", ["h100_nvl", "tpu_v5e", "rtx3090"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_scenarios_equals_reference(device, seed):
    js, ts = random_scenarios(seed, 120)
    want = jc.solve_scenarios(js, jc.DEVICES[device])
    got = tc.solve_scenarios(ts, tc.DEVICES[device])
    assert len(got) == len(want) == 120
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.bottleneck, want.bottleneck)
    np.testing.assert_array_equal(got.feasible_slots, want.feasible_slots)
    for field in ("speeds", "slowdowns", "axis_load"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=1e-12, err_msg=field)
    assert np.isinf(want.slowdowns).any() == np.isinf(got.slowdowns).any()


def test_cache_cliff_and_scalar_api_equal_reference():
    """Two streaming kernels whose working sets together cross the H100's
    50 MB L2: the thrash cliff, through the name-keyed scalar API."""
    res = {}
    for core in (jc, tc):
        a = core.profile.analytic_copy("a", 20e6, hit_fraction=0.8)
        for ws_b in (20e6, 31e6):              # 80 MB (under) and 102 MB (over)
            b = core.profile.analytic_copy("b", ws_b / 2, hit_fraction=0.8)
            r = core.estimate([a, b], core.H100)
            res.setdefault(core, []).append(
                (r.slowdowns["a"], r.slowdowns["b"], r.bottleneck["a"],
                 r.feasible_slots, core.pairwise_slowdown(a, b, core.H100),
                 core.colocation_speedup(a, b, core.H100)))
    assert res[jc] == res[tc]


def test_device_models_and_profiles_are_the_reference_s():
    assert set(tc.DEVICES) == set(jc.DEVICES)
    for name, dev in jc.DEVICES.items():
        np.testing.assert_array_equal(tc.DEVICES[name].capacity_vector(),
                                      dev.capacity_vector())
        assert tc.DEVICES[name].cache_capacity == dev.cache_capacity
    j = jc.profile.analytic_matmul("m", 512, 512, 512)
    t = tc.profile.analytic_matmul("m", 512, 512, 512)
    assert j.demand == t.demand
    assert j.isolated_time(jc.H100) == t.isolated_time(tc.H100)
    assert j.utilization(jc.H100) == t.utilization(tc.H100)


def test_port_has_one_solver_and_no_backend_switch():
    """Unless asked, the port solves on one backend, the NumPy one, as the
    reference does (its default): nothing switches to the torch solver by
    itself, and an empty solve returns nothing."""
    assert tc.get_solver_backend() == "numpy"
    empty = tc.solve_scenarios([])
    assert len(empty) == 0
