"""The port's four stressor kernels against the JAX package's, on the CPU.

The same inputs, drawn with NumPy from a seed, go through the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) or the reference's oracle
(repro/kernels/ref.py), and through the port's wrapper, which on a CPU
tensor computes the kernel's plain PyTorch version. The CUDA kernels are
held against these plain versions on the card by chip_smoke.py.

Tolerances are the reference's own (tests/test_kernels.py): mxu 1e-4 in f32,
vpu 1e-5, vmem 1e-5, hbm exact; bf16 mxu 2e-2, a few bf16 ulps (2^-8) of
outputs of order one: the port rounds c to bf16 before every product, as the
tensor cores take it, the reference keeps it in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels import stressors as jst
from repro_torch.calib.measure import StressorSpec, _stressor_call, stressor_blocks
from repro_torch.kernels import stressors as st

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw(rng, shape, dtype="float32", scale=1.0):
    """One NumPy draw, handed to both frameworks in `dtype`."""
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def to_jax(t: torch.Tensor):
    dtype = "bfloat16" if t.dtype == torch.bfloat16 else "float32"
    return jnp.asarray(t.float().numpy(), JDT[dtype])


# ------------------------- against the Pallas kernels ------------------ #
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_stress_mxu_matches_pallas(dtype, tol):
    rng = np.random.default_rng(0)
    ja, ta = draw(rng, (2, 128, 128), dtype)
    jb, tb = draw(rng, (128, 128), dtype, scale=0.1)
    want = jst.stress_mxu(ja, jb, iters=4, interpret=True)
    got = st.stress_mxu(ta, tb, iters=4)
    assert got.dtype == TDT[dtype]
    close(got, want, tol)


@pytest.mark.parametrize("ilp", [1, 2, 4])
def test_stress_vpu_matches_pallas(ilp):
    jx, tx = draw(np.random.default_rng(1), (256, 128))
    want = jst.stress_vpu(jx, iters=16, ilp=ilp, interpret=True)
    close(st.stress_vpu(tx, iters=16, ilp=ilp), want, 1e-5)


def test_stress_hbm_matches_pallas():
    jx, tx = draw(np.random.default_rng(2), (2048, 128), "bfloat16")
    want = jst.stress_hbm(jx, interpret=True)
    got = st.stress_hbm(tx)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    assert torch.equal(st.stress_hbm(tx, passes=3), tx)


@pytest.mark.parametrize("stride", [1, 8, 32])
def test_stress_vmem_matches_pallas(stride):
    jx, tx = draw(np.random.default_rng(3), (512, 128))
    want = jst.stress_vmem(jx, iters=8, stride=stride, interpret=True)
    close(st.stress_vmem(tx, iters=8, stride=stride), want, 1e-5)


@pytest.mark.parametrize("kernel", ["stress_vpu", "stress_vmem"])
def test_bf16_stressors_match_pallas(kernel):
    """bf16 x: the Pallas kernels loop in f32 and cast back to x's type, as
    the plain versions (and the CUDA kernels) do; the reference's bf16
    tolerance, 2e-2 (a bf16 ulp is 2^-8 of a value)."""
    jx, tx = draw(np.random.default_rng(6), (512, 128), "bfloat16")
    kw = {"iters": 16, "ilp": 4} if kernel == "stress_vpu" else {"iters": 8, "stride": 8}
    want = getattr(jst, kernel)(jx, **kw, interpret=True)
    got = getattr(st, kernel)(tx, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, want, 2e-2)


@pytest.mark.parametrize("R,stride", [(1024, 8), (256, 3), (128, 0)])
def test_stress_vmem_keeps_the_block_semantics(R, stride):
    """Two 512-row blocks roll separately; a short matrix is one block; a
    stride that does not divide the block, or is 0, is still a roll."""
    jx, tx = draw(np.random.default_rng(4), (R, 64))
    want = ref.ref_stress_vmem(jx, iters=6, stride=stride)
    close(st.stress_vmem(tx, iters=6, stride=stride), want, 1e-5)


def test_stress_vmem_stays_finite_where_the_reference_overflows():
    """At 200 iterations the reference's y grows by 2^200 and leaves f32;
    the port halves y on every step, which equals the reference bit for bit
    while it stays finite, and stays an average of the inputs beyond."""
    jx, tx = draw(np.random.default_rng(5), (512, 128))
    assert not np.isfinite(np.asarray(ref.ref_stress_vmem(jx, 200, 8))).all()
    got = st.stress_vmem(tx, iters=200, stride=8)
    assert torch.isfinite(got).all()
    assert got.abs().max() <= tx.abs().max()
    np.testing.assert_array_equal(st.stress_vmem(tx, 40, 8).numpy(),
                                  np.asarray(ref.ref_stress_vmem(jx, 40, 8)))


# ------------------------------ shape checks -------------------------- #
@pytest.mark.parametrize("call", [
    lambda: st.stress_vpu(torch.zeros(300, 128)),                 # 300 % 256
    lambda: st.stress_vpu(torch.zeros(128)),                      # not 2-D
    lambda: st.stress_hbm(torch.zeros(1000, 128), block_rows=512),
    lambda: st.stress_hbm(torch.zeros(64, 128), passes=0),
    lambda: st.stress_vmem(torch.zeros(600, 128)),                # 600 % 512
    lambda: st.stress_vmem(torch.zeros(0, 128)),
    lambda: st.stress_mxu(torch.zeros(2, 128, 64), torch.zeros(64, 64)),
    lambda: st.stress_mxu(torch.zeros(2, 128, 128), torch.zeros(64, 64)),
], ids=["vpu-rows", "vpu-1d", "hbm-rows", "hbm-passes", "vmem-rows",
        "vmem-empty", "mxu-a", "mxu-b"])
def test_wrappers_refuse_the_shapes_the_reference_asserts_against(call):
    with pytest.raises(ValueError):
        call()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = [f.launches for f in (st.stress_mxu, st.stress_vpu,
                                   st.stress_hbm, st.stress_vmem)]
    x = torch.ones(256, 128)
    st.stress_vpu(x, 2, 2), st.stress_hbm(x), st.stress_vmem(x, 2, 1)
    st.stress_mxu(torch.ones(1, 128, 128), torch.eye(128), 2)
    assert [f.launches for f in (st.stress_mxu, st.stress_vpu,
                                 st.stress_hbm, st.stress_vmem)] == before


# ---------------------- the calibration's dispatches ------------------- #
@pytest.mark.parametrize("spec", [
    StressorSpec("mxu", 0.5), StressorSpec("vpu", 0.5),
    StressorSpec("issue", 0.25), StressorSpec("hbm", 0.5),
    StressorSpec("l2", 0.9), StressorSpec("ici", 0.1),
    StressorSpec("smem", 0.75), StressorSpec("hbm", 0.5, working_set=40_000),
], ids=lambda s: f"{s.axis}@{s.intensity}" + ("-ws" if s.working_set else ""))
def test_stressor_call_gives_the_oracles_numbers(spec):
    """``_stressor_call(spec, "cpu")`` at a small size (4 SMs, a dispatch
    of one iteration, a 64 KB stream): the kernel of the axis, one block
    per SM share, and the oracle's output on the same inputs."""
    call = _stressor_call(spec, "cpu", slots=4, target_s=1e-9, stream_bytes=1 << 16)
    blocks = stressor_blocks(spec.intensity, 4)
    assert call.blocks == blocks
    got = call()
    x = call.args[0]
    if call.kernel == "stress_mxu":
        assert spec.axis == "mxu" and x.dtype == torch.bfloat16 and x.shape[0] == blocks
        a, b = (to_jax(t) for t in call.args)
        close(got, ref.ref_stress_mxu(a, b, call.kwargs["iters"]), 2e-2)
        assert call.work == blocks * call.kwargs["iters"] * 2.0 * 128 ** 3
    elif call.kernel == "stress_vpu":
        assert spec.axis in ("vpu", "issue") and x.shape[0] == 256 * blocks
        close(got, ref.ref_stress_vpu(to_jax(x), call.kwargs["iters"],
                                      call.kwargs["ilp"]), 1e-5)
    elif call.kernel == "stress_hbm":
        assert spec.axis in ("hbm", "l2", "ici")
        assert x.shape[0] // call.kwargs["block_rows"] == blocks
        assert x.numel() * 4 >= (spec.working_set or 1 << 16)
        assert torch.equal(got, x)
        assert np.array_equal(np.asarray(ref.ref_stress_hbm(to_jax(x))), x.numpy())
        assert call.work == 2.0 * call.kwargs["passes"] * x.numel() * 4
    else:
        assert spec.axis == "smem" and call.kernel == "stress_vmem"
        assert x.shape == (512, st.VMEM_STRIP * blocks)
        close(got, ref.ref_stress_vmem(to_jax(x), call.kwargs["iters"],
                                       call.kwargs["stride"]), 1e-5)


def test_stressor_blocks_cover_lambda_of_the_sms():
    assert [stressor_blocks(lam, 132) for lam in (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)] \
        == [14, 33, 66, 99, 119, 132]
    assert stressor_blocks(0.0, 132) == 1 and stressor_blocks(1.5, 132) == 132


# Wavefronts of each warp's access in ``stress_vmem``, worked by hand from
# the kernel's lane map (``csrc/stressors.cu:stress_vmem_kernel``): lane j
# reads row (j s + floor(j s / br)) mod br of a column whose rows are
# consecutive 4-byte words, so its bank is that row mod 32 (br is a multiple
# of 32), and a warp takes as many wavefronts as the most of its lanes in one
# bank. br 512: floor(j s / 512) is constant within a warp up to s = 16, so
# s lanes share a bank; at s = 32 every lane's j s is 0 mod 32 and the bank
# is floor(j / 16): two banks of 16. br 96, s = 2: warp 1's lanes 32-47 take
# the even banks once each and lanes 48-63 (floor(2j / 96) = 1) the odd
# ones, while warps 0 and 2 take each even / odd bank twice; s = 4: lanes
# 0-23 of warp 0 take 8 banks three times; s >= 8: three lanes a bank.
VMEM_WAYS = {
    512: {1: [1] * 16, 2: [2] * 16, 4: [4] * 16, 8: [8] * 16, 16: [16] * 16,
          32: [16] * 16},
    96: {1: [1, 1, 1], 2: [2, 1, 2], 4: [3, 2, 3], 8: [3, 3, 3], 16: [3, 3, 3],
         32: [3, 3, 3]},
}


@pytest.mark.parametrize("br", [512, 96])
@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16, 32])
def test_vmem_conflict_degree_follows_the_kernels_lane_map(stride, br):
    """The bank conflicts that bound ``stress_vmem`` on the card: the
    helper's degree is the mean over the block's warps of the wavefronts
    worked out by hand above."""
    ways = VMEM_WAYS[br][stride]
    assert len(ways) == br // 32
    assert st.vmem_conflict_degree(stride, br) == pytest.approx(sum(ways) / len(ways))


def test_stressor_call_sizes_for_the_card():
    """The sizes the card gets (132 SMs, about a millisecond a dispatch),
    computed without making them: one iteration of a block's time budget,
    and at least 4 x the 50 MB L2 streamed by the copy."""
    from repro_torch.calib import measure
    for axis, s in measure._S_PER_ITER.items():
        assert 1e-7 < s < 1e-5, axis
    assert round(1e-3 / measure._S_PER_ITER["mxu"]) > 500
    with pytest.raises(ValueError):
        _stressor_call(StressorSpec("bogus", 0.5), "cpu", slots=1)
