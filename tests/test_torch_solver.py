"""The port's torch solver backend against the JAX package's two solvers,
on the CPU.

The same seeded scenarios (the reference's own generators from
benchmarks/bench_planner.py, steered into every branch: zeroed axes,
smem-saturating, cache-heavy, excluded members) go through
``repro.core``'s NumPy oracle and its ``"jax"`` backend, and through the
port's ``"torch"`` backend on ``device="cpu"``, where the cache-share stage
takes the kernel's plain version. All three are f64 water-filling, so the
numbers agree at rtol = atol = 1e-9 (the reference's own parity contract,
tests/test_estimator_jax.py) and the discrete ``bottleneck`` and
``feasible_slots`` exactly. The plain cache share equals the reference's
``cache_share_ref`` bit for bit: the kernel on the card is held to it
exactly by chip_smoke.py.

``estimator_jax`` turns on jax's x64 at import, so every JAX array here is
made with an explicit dtype.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from bench_planner import random_profile  # noqa: E402
from repro.core import estimator as jest  # noqa: E402
from repro.core import estimator_jax  # noqa: E402
from repro.core.profile import ProfileMatrix as JaxProfileMatrix  # noqa: E402
from repro_torch.configs.registry import get_config, tiny_config  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core import estimator_torch  # noqa: E402
from repro_torch.kernels.cache_share import cache_share, cache_share_plain  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402

RTOL = ATOL = 1e-9
PM_FIELDS = ("names", "demand", "duration", "cache_working_set",
             "cache_hit_fraction", "slots_needed")


def assert_results_equal(want, got):
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.bottleneck, want.bottleneck)
    np.testing.assert_array_equal(got.feasible_slots, want.feasible_slots)
    for field in ("speeds", "slowdowns", "axis_load"):
        a, b = getattr(want, field), getattr(got, field)
        fin = np.isfinite(a)
        np.testing.assert_array_equal(fin, np.isfinite(b), err_msg=field)
        np.testing.assert_allclose(b[fin], a[fin], rtol=RTOL, atol=ATOL, err_msg=field)


def both_matrices(rng, device, n=40):
    """A mixed kernel pool as one ProfileMatrix of each package (the same
    arrays), with random slot needs so that slot feasibility varies."""
    jdev = jc.DEVICES[device]
    pool = [random_profile(rng, f"k{i}", jdev, zero_axes=(i % 3 == 0),
                           smem_heavy=(i % 5 == 0), cache_heavy=(i % 4 == 0))
            for i in range(n)]
    jpm = JaxProfileMatrix.from_profiles(pool)
    slots = rng.integers(0, jdev.n_slots + 2, size=n).astype(np.float64)
    jpm = JaxProfileMatrix(**{f: getattr(jpm, f) for f in PM_FIELDS[:-1]},
                           slots_needed=slots)
    return jpm, tc.ProfileMatrix(**{f: getattr(jpm, f) for f in PM_FIELDS})


# ------------------------------ cache share ---------------------------- #
def reference_case():
    """tests/test_estimator_jax.py's case: 37 x 3 with a row whose total
    working set equals the capacity exactly."""
    rng = np.random.default_rng(9)
    cap = jc.TPU_V5E.cache_capacity
    ws = rng.random((37, 3)) * 2.0 * cap
    ws[rng.random((37, 3)) < 0.3] = 0.0
    ws[0] = [cap / 2, cap / 2, 0.0]
    present = rng.random((37, 3)) < 0.9
    return np.where(present, ws, 0.0), present, cap


def random_case(k, seed):
    rng = np.random.default_rng(seed)
    cap = jc.H100.cache_capacity
    ws = rng.random((500, k)) * rng.choice([0.3, 1.0, 2.0], size=(500, 1)) * cap
    ws[rng.random((500, k)) < 0.3] = 0.0
    ws[:3] = 0.0
    ws[0, :2] = cap / 2                 # total == cap: below the cliff
    ws[1, :2] = [cap / 2, cap / 2 + 1.0]   # one byte over
    ws[2, 0] = 0.5                      # a lone working set under 1 byte
    present = rng.random((500, k)) < 0.85
    present[:3] = True
    return np.where(present, ws, 0.0), present, cap


def assert_share_equals_reference(ws, present, cap):
    want = estimator_jax.cache_share_ref(jnp.asarray(ws, jnp.float64),
                                         jnp.asarray(present, jnp.bool_), cap)
    got = cache_share_plain(torch.from_numpy(ws), torch.from_numpy(present), cap)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        cache_share(torch.from_numpy(ws), torch.from_numpy(present), cap).numpy(),
        np.asarray(want))


def test_cache_share_plain_equals_reference_at_the_boundary():
    ws, present, cap = reference_case()
    assert_share_equals_reference(ws, present, cap)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_cache_share_plain_equals_reference(k):
    ws, present, cap = random_case(k, 40 + k)
    assert_share_equals_reference(ws, present, cap)
    got = cache_share_plain(torch.from_numpy(ws), torch.from_numpy(present), cap)
    assert got[0, 0] == 1.0 and got[1, 0] == 0.0      # the cliff, both sides


def test_cache_share_wrapper_refuses_what_the_kernel_does_not_take():
    ws = torch.zeros((4, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cache_share"):
        cache_share(ws, torch.zeros((4, 3), dtype=torch.bool), 1.0)


# ------------------------------ the solver ----------------------------- #
def solve_three_ways(jpm, tpm, idx, device, frac=None, mask=None):
    jdev, tdev = jc.DEVICES[device], tc.DEVICES[device]
    oracle = jest.solve_batch(jpm, idx, jdev, frac, mask=mask)
    with jc.solver_backend("jax"):
        jitted = jest.solve_batch(jpm, idx, jdev, frac, mask=mask)
    with tc.solver_backend("torch", device="cpu"):
        got = tc.solve_batch(tpm, idx, tdev, frac, mask=mask)
    return oracle, jitted, got


@pytest.mark.parametrize("device", ["h100_nvl", "tpu_v5e", "rtx3090"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
def test_torch_backend_equals_numpy_and_jax(device, k):
    rng = np.random.default_rng(100 + k)
    jpm, tpm = both_matrices(rng, device)
    idx = rng.integers(0, len(jpm.names), (100, k))
    oracle, jitted, got = solve_three_ways(jpm, tpm, idx, device)
    assert_results_equal(oracle, got)
    assert_results_equal(jitted, got)
    if k > 1:
        assert (got.bottleneck >= 0).any()       # some member was throttled


@pytest.mark.parametrize("device", ["h100_nvl", "tpu_v5e", "rtx3090"])
@pytest.mark.parametrize("k", [2, 3, 5, 6])
def test_torch_backend_with_fractions_exclusions_and_ragged_rows(device, k):
    """Slot fractions, some at or below FRACTION_FLOOR (excluded: speed 0,
    slowdown +inf), and ragged widths (mask)."""
    rng = np.random.default_rng(200 + k)
    jpm, tpm = both_matrices(rng, device)
    S = 77                                       # pads up to the bucket of 128
    idx = rng.integers(0, len(jpm.names), (S, k))
    frac = rng.choice([0.0, 5e-7, 0.125, 0.25, 0.5, 0.75, 1.0], size=(S, k))
    mask = rng.random((S, k)) < 0.85
    mask[:, 0] = True
    oracle, jitted, got = solve_three_ways(jpm, tpm, idx, device, frac, mask)
    excluded = mask & (frac <= tc.FRACTION_FLOOR)
    assert excluded.any()
    assert np.all(got.speeds[excluded] == 0) and np.all(np.isinf(got.slowdowns[excluded]))
    assert_results_equal(oracle, got)
    assert_results_equal(jitted, got)


def test_torch_backend_at_the_cache_cliff_through_the_scalar_api():
    """Two streaming kernels whose working sets together reach the H100's
    L2 exactly (no cliff) and one byte over it (the cliff)."""
    res = {}
    for ws_b in (25e6, 25e6 + 1):
        a = tc.profile.analytic_copy("a", 12.5e6, hit_fraction=0.8)
        b = tc.profile.analytic_copy("b", ws_b / 2, hit_fraction=0.8)
        want = tc.estimate([a, b], tc.H100)
        with tc.solver_backend("torch", device="cpu"):
            got = tc.estimate([a, b], tc.H100)
        assert got.bottleneck == want.bottleneck
        for name in "ab":
            assert got.slowdowns[name] == pytest.approx(want.slowdowns[name], rel=RTOL)
        res[ws_b] = got.slowdowns["a"]
    assert res[25e6 + 1] > res[25e6]              # past the cliff: hits are lost


def test_bucket_is_a_power_of_two_floored_at_eight():
    assert [estimator_torch._bucket(s) for s in (1, 8, 9, 100, 128, 129)] == \
        [8, 8, 16, 128, 128, 256]


def test_default_backend_is_numpy_and_an_empty_solve_returns_nothing():
    assert tc.SOLVER_BACKENDS == ("numpy", "torch")
    assert tc.get_solver_backend() == "numpy"
    for name in ("numpy", "torch"):
        with tc.solver_backend(name, device="cpu"):
            empty = tc.solve_scenarios([])
            assert len(empty) == 0


def test_backend_switch_and_env(monkeypatch):
    assert tc.get_solver_backend() in tc.SOLVER_BACKENDS
    prev = tc.set_solver_backend("torch", device="cpu")
    try:
        assert tc.get_solver_backend() == "torch"
        assert tc.get_solver_device() == torch.device("cpu")
        with tc.solver_backend("numpy"):
            assert tc.get_solver_backend() == "numpy"
        assert tc.get_solver_backend() == "torch"
        assert tc.get_solver_device() == torch.device("cpu")
        with pytest.raises(ValueError):
            tc.set_solver_backend("jax")
    finally:
        tc.set_solver_backend(prev)
    assert tc.warmup_solver(tc.H100) == 0
    # the environment is read once, at first use
    monkeypatch.setattr(backend, "_backend", None)
    monkeypatch.setenv("REPRO_TORCH_SOLVER_BACKEND", "NumPy ")
    assert tc.get_solver_backend() == "numpy"
    monkeypatch.setattr(backend, "_backend", None)
    monkeypatch.setenv("REPRO_TORCH_SOLVER_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown solver backend"):
        tc.get_solver_backend()
    monkeypatch.setattr(backend, "_backend", None)
    monkeypatch.setenv("REPRO_TORCH_SOLVER_BACKEND", "torch")
    if not torch.cuda.is_available():   # decided inside the test
        # the torch solver defaults to the card: nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.get_solver_backend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.set_solver_backend("torch")
    monkeypatch.setattr(backend, "_backend", "numpy")
    monkeypatch.setattr(backend, "_device", torch.device("cuda"))


def test_default_search_config_follows_backend():
    with tc.solver_backend("numpy"):
        assert tc.FractionSearchConfig.default() == tc.FractionSearchConfig()
    with tc.solver_backend("torch", device="cpu"):
        assert tc.FractionSearchConfig.default() == tc.DENSE_SEARCH
    with jc.solver_backend("jax"):
        assert jc.FractionSearchConfig.default() == jc.DENSE_SEARCH


@pytest.mark.parametrize("seed,slo", [(1, 2.0), (7, 1.5)])
def test_fraction_search_on_the_torch_backend_equals_the_numpy_one(seed, slo):
    """The k-way fraction search prices its candidates through the solver:
    the same search on both backends selects the same fractions. (The
    groups meet their SLO at one best assignment: where none does, several
    assignments can tie to the last bit, and 1e-15 picks between them.)"""
    rng = np.random.default_rng(seed)
    ws = [tc.WorkloadProfile(f"w{i}", (tc.KernelProfile(f"w{i}k", demand={
        r: float(rng.uniform(0.05, 0.9)) * tc.H100.capacity(r)
        for r in ("mxu", "vpu", "hbm", "l2", "issue", "smem")}),),
        slo_slowdown=slo) for i in range(3)]
    cfg = tc.FractionSearchConfig()
    [want] = tc.search_group_fractions([ws], tc.H100, cfg)
    with tc.solver_backend("torch", device="cpu"):
        [got] = tc.search_group_fractions([ws], tc.H100, cfg)
    assert want.meets_slo and got.meets_slo
    assert got.fractions == want.fractions
    assert got.gain == pytest.approx(want.gain, rel=RTOL)


def test_engine_picks_the_same_chunks_on_both_backends():
    """The tiny qwen3 engine prices every prefill chunk through the
    solver: on both backends it schedules the same chunks and tokens."""
    cfg = tiny_config(get_config("qwen3-1.7b"))

    def run():
        eng = Engine(cfg, ecfg=EngineConfig(max_slots=2, max_len=320, prefill_chunk=64,
                                            mode="interference_aware"), device="cpu",
                     generator=torch.Generator().manual_seed(0))
        eng.submit([1, 2, 3, 4], max_new=24)
        for _ in range(3):
            eng.step()
        eng.submit([1 + i % 250 for i in range(230)], max_new=4)
        metrics = eng.run_until_done()
        chunks = [e.detail["chunk"] for e in eng.events if e.kind == "prefill_chunk"]
        return chunks, [m["output"] for m in metrics.values()]

    chunks, outputs = run()
    with tc.solver_backend("torch", device="cpu"):
        t_chunks, t_outputs = run()
    assert len(chunks) > 2 and t_chunks == chunks
    assert t_outputs == outputs
