"""The port's Mamba-1 path against the JAX package, on the CPU: the selective
scan's plain version against the Pallas kernel in interpret mode and the
reference's oracle, the model's scan with its final state, the conv and the
decode step, and ``tiny_config(falcon-mamba-7b)`` end to end with the JAX
parameters carried across by ``from_jax_params``.

Tolerances: the scan at 1e-4, the reference's own (tests/test_kernels.py);
f32 parameters at 1e-4 (the two sides differ by the order of f32 sums);
bf16 parameters at the reference's tolerance for bf16 logits, rtol 0.15 /
atol 0.3 (tests/test_models_smoke.py), because the two frameworks round to
bf16 at different places. Every JAX array is made with an explicit dtype:
another test file in the same worker may have turned on jax's x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.models.convert import from_jax_params

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
ARCH = "falcon-mamba-7b"


def close(got: torch.Tensor, want, **tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def scan_inputs(Bb, S, di, N, seed=0):
    """The reference kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    x = normal(Bb, S, di) * 0.5
    dt = np.log1p(np.exp(normal(Bb, S, di) - 2)).astype(np.float32)
    A = -np.exp(normal(di, N) * 0.3)
    return x, dt, A, normal(Bb, S, N) * 0.5, normal(Bb, S, N) * 0.5


def as_jax(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def as_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def falcon_scan_inputs(Bb, S, di, N, seed=0):
    """falcon-mamba's own A, -(1..N) in every channel (A_log = log(1..N)),
    and dt = softplus(u), u uniform in [-4, 3]: the steepest decays its
    initialisation gives. chip_smoke.py holds the CUDA kernel against the
    plain version on this draw (``falcon_scan_inputs`` there)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, S, di), dtype=np.float32) * 0.5
    u = rng.uniform(-4.0, 3.0, (Bb, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(u)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (di, N)).copy()
    B = rng.standard_normal((Bb, S, N), dtype=np.float32) * 0.5
    C = rng.standard_normal((Bb, S, N), dtype=np.float32) * 0.5
    return x, dt, A, B, C


# ------------------------------ the scan ------------------------------- #
# the reference kernel test's draw, and falcon-mamba's decays (seeded by S)
# at its ragged widths and N
SCAN_CASES = [pytest.param(scan_inputs, 0, *c, id="-".join(map(str, c))) for c in [
    (128, 64, 8, 32, 32), (64, 128, 16, 64, 128), (96, 32, 4, 16, 32),
    # above 16 states: the kernel's rounded instantiations (32, 64)
    (32, 64, 20, 32, 64), (32, 32, 32, 32, 32), (16, 32, 64, 16, 32)]] + [
    pytest.param(falcon_scan_inputs, c[0], *c, id="falcon-" + "-".join(map(str, c)))
    for c in [(64, 64, 16, 32, 32), (32, 200, 16, 32, 200), (40, 130, 3, 40, 130)]]


@pytest.mark.parametrize("draw,seed,S,di,N,chunk,block_d", SCAN_CASES)
def test_scan_plain_matches_pallas(draw, seed, S, di, N, chunk, block_d):
    arrays = draw(2, S, di, N, seed=seed)
    if draw is falcon_scan_inputs:
        assert arrays[1].max() > 2.9                   # dt reaches softplus(3)
    want = ssm_scan_pallas(*as_jax(*arrays), chunk=chunk, block_d=block_d,
                           interpret=True)
    y, hT = ssm_scan_plain(*as_torch(*arrays))
    assert y.dtype == torch.float32 and hT.shape == (2, di, N)
    close(y, want, **SCAN_TOL)
    close(ops.ssm_scan(*as_torch(*arrays)), want, **SCAN_TOL)
    # the wrapper takes the plain version for a CPU tensor
    close(ssm_scan(*as_torch(*arrays))[0], want, **SCAN_TOL)


def test_scan_in_bf16_returns_f32_and_ops_casts():
    """x in bf16: the scan's y stays f32 (the model's scan), ``ops.ssm_scan``
    casts it to bf16 (the Pallas kernel's output type)."""
    x, dt, A, B, C = scan_inputs(2, 40, 32, 8, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = ref.ref_ssm_scan(jnp.asarray(xb.float().numpy(), jnp.bfloat16), *as_jax(dt, A, B, C))
    assert want.dtype == jnp.bfloat16
    y, _ = ssm_scan(xb, *as_torch(dt, A, B, C))
    assert y.dtype == torch.float32
    got = ops.ssm_scan(xb, *as_torch(dt, A, B, C))
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=2e-2, atol=2e-2)           # one bf16 ulp


def test_final_state_matches_the_models_scan():
    x, dt, A, B, C = scan_inputs(2, 64, 32, 8, seed=2)
    want_y, want_h = jssm.mamba1_scan(*as_jax(x, dt, A, B, C), chunk=16)
    y, hT = ssm.mamba1_scan(*as_torch(x, dt, A, B, C))
    close(y, want_y, **SCAN_TOL)
    close(hT, want_h, **SCAN_TOL)


def test_scan_continues_from_a_state_in_place():
    """Two halves, the second started from the first's final state written
    in place, give the whole scan; S = 1 from h0 is the reference's step."""
    x, dt, A, B, C = as_torch(*scan_inputs(2, 50, 16, 8, seed=3))
    y, hT = ssm_scan_plain(x, dt, A, B, C)
    state = torch.zeros_like(hT)
    y1, h1 = ssm_scan(x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20], out_state=state)
    y2, h2 = ssm_scan(x[:, 20:], dt[:, 20:], A, B[:, 20:], C[:, 20:], h0=state,
                      out_state=state)
    assert h1 is state and h2 is state
    close(torch.cat([y1, y2], 1), y, rtol=1e-6, atol=1e-6)
    close(state, hT, rtol=1e-6, atol=1e-6)


# ---------------------------- conv and step ---------------------------- #
def test_causal_conv1d_and_step():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24), dtype=np.float32)
    w = rng.standard_normal((24, 4), dtype=np.float32) / 2
    b = rng.standard_normal((24,), dtype=np.float32) / 4
    want = jssm.causal_conv1d(*as_jax(x, w, b))
    close(ssm.causal_conv1d(*as_torch(x, w, b)), want, rtol=1e-5, atol=1e-5)
    state = rng.standard_normal((2, 3, 24), dtype=np.float32)
    js, jy = jssm.conv1d_step(*as_jax(state, x[:, 0], w, b))
    ts, ty = ssm.conv1d_step(*as_torch(state, x[:, 0], w, b))
    close(ts, js, rtol=0, atol=0)
    close(ty, jy, rtol=1e-5, atol=1e-5)


def mixer_params(param_dtype, seed=0):
    jcfg = jax_tiny_config(jax_get_config(ARCH)).with_overrides(param_dtype=param_dtype)
    dtype = jnp.float32 if param_dtype == "float32" else jnp.bfloat16
    jp = jssm.mamba1_init(jax.random.PRNGKey(seed), jcfg, dtype)
    return jcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_mamba1_step_matches_the_reference():
    """The step on the scan (S = 1 from the layer's state) against the
    reference's own step arithmetic, f32 parameters; the state in place."""
    jcfg, jp, p = mixer_params("float32")
    cfg = tiny_config(get_config(ARCH)).with_overrides(param_dtype="float32")
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    conv = rng.standard_normal((2, 3, cfg.d_inner)).astype(np.float32)
    h = rng.standard_normal((2, cfg.d_inner, cfg.ssm.d_state), dtype=np.float32)
    jstate = {"conv": jnp.asarray(conv, jnp.bfloat16), "h": jnp.asarray(h, jnp.float32)}
    want, jnew = jssm.mamba1_step(jp, jcfg, jnp.asarray(u, jnp.float32), jstate)
    state = {"conv": torch.from_numpy(conv).to(torch.bfloat16), "h": torch.from_numpy(h)}
    h_buf, conv_buf = state["h"], state["conv"]
    got, new = ssm.mamba1_step(p, cfg, torch.from_numpy(u), state)
    close(got, want, **TOL["float32"])
    close(new["h"], jnew["h"], **TOL["float32"])
    assert new["h"] is h_buf and new["conv"] is conv_buf          # in place
    # the conv state stays bf16; the reference's promotes to f32 (ROADMAP C15)
    assert jnew["conv"].dtype == jnp.float32 and new["conv"].dtype == torch.bfloat16
    close(new["conv"], np.asarray(jnew["conv"].astype(jnp.bfloat16), np.float32),
          rtol=1e-2, atol=1e-2)


# ---------------------------- the model -------------------------------- #
def both_models(param_dtype):
    jcfg = jax_tiny_config(jax_get_config(ARCH)).with_overrides(param_dtype=param_dtype)
    cfg = tiny_config(get_config(ARCH)).with_overrides(param_dtype=param_dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg, device="cpu"), from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def tokens(shape, seed=0):
    t = np.random.default_rng(seed).integers(1, 256, size=shape)
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}."))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_tree_and_cache_match_the_reference(param_dtype):
    jm, jp, m, _ = both_models(param_dtype)
    p = m.init(torch.Generator().manual_seed(0))
    assert shapes(p) == shapes(jp)
    assert shapes(m.init_cache(3, 40)) == shapes(jm.init_cache(3, 40))
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_the_reference(param_dtype):
    jm, jp, m, p = both_models(param_dtype)
    tol = TOL[param_dtype]
    jt, tt = tokens((2, 13))
    want, _ = jm.forward(jp, {"tokens": jt})
    close(m.forward(p, {"tokens": tt}), want, **tol)

    jl, jc = jm.prefill(jp, {"tokens": jt[:, :12]}, 16)
    logits, cache = m.prefill(p, {"tokens": tt[:, :12]}, 16)
    close(logits, jl, **tol)
    assert shapes(cache) == shapes(jc)
    if param_dtype == "float32":
        close(cache["h"], jc["h"], **tol)
        close(cache["conv"], jc["conv"], rtol=1e-2, atol=1e-2)   # bf16: one ulp
    jl, jc = jm.decode_step(jp, jt[:, 12:13], jc, 12)
    logits, cache = m.decode_step(p, tt[:, 12:13], cache, 12)
    close(logits, jl, **tol)
    close(logits[:, 0], want[:, 12], **TOL["bfloat16"])
    if param_dtype == "float32":
        close(cache["h"], jc["h"], **tol)


def test_prefill_decode_parity():
    """The twin of tests/test_models_smoke.py::test_prefill_decode_parity:
    decoding token t after prefill[0:t] matches the full forward at t."""
    cfg = tiny_config(get_config(ARCH))
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    B, S = 2, 24
    t = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, size=(B, S)))
    full = m.forward(p, {"tokens": t})
    logits_p, cache = m.prefill(p, {"tokens": t[:, :S - 1]}, S + 8)
    close(logits_p[:, 0], full[:, S - 2], **TOL["bfloat16"])
    logits_d, cache = m.decode_step(p, t[:, S - 1:S], cache, S - 1)
    close(logits_d[:, 0], full[:, S - 1], **TOL["bfloat16"])
    assert torch.isfinite(logits_d).all()


def test_decode_continues_the_prefill_exactly_in_f32():
    """Prefill of t tokens then k decode steps gives forward's logits at
    every step (f32 parameters: only the bf16 conv state rounds)."""
    cfg = tiny_config(get_config(ARCH)).with_overrides(param_dtype="float32")
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(1))
    t = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(3, 20)))
    full = m.forward(p, {"tokens": t})
    _, cache = m.prefill(p, {"tokens": t[:, :16]}, 20)
    for i in range(16, 20):
        logits, cache = m.decode_step(p, t[:, i:i + 1], cache, i)
        close(logits[:, 0], full[:, i], rtol=2e-2, atol=2e-2)


def test_scan_wrapper_refuses_what_the_kernel_does_not_take():
    """A CPU tensor takes the plain version (and a ``meta`` one: the dry
    run's count of shapes); any other device without the kernel raises
    instead of falling back: here fake ``xpu`` tensors, which need no such
    device."""
    with FakeTensorMode():
        x = torch.zeros(1, 4, 8, device="xpu")
        with pytest.raises(ValueError, match="ssm_scan"):
            ssm_scan(x, x, torch.zeros(8, 4, device="xpu"), torch.zeros(1, 4, 4, device="xpu"),
                     torch.zeros(1, 4, 4, device="xpu"))
