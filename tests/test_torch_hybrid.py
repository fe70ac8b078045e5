"""The port's Mamba-2 and hybrid (zamba2) path against the JAX package, on
the CPU: the chunked SSD with its final state, ``_segsum``, the decode step,
and ``tiny_config(zamba2-1.2b)`` end to end, with and without a tail of SSM
layers after the last group, with the JAX parameters carried across by
``from_jax_params``. The SSD reaches no Pallas kernel in the reference; the
shared block's attention runs on the kernels' plain versions here.

Tolerances: the SSD in f32 at 1e-5 (the two sides differ by the order of f32
sums); the step and f32 parameters at 1e-4, as in tests/test_torch_ssm.py;
bf16 parameters at the reference's tolerance for bf16 logits, rtol 0.15 /
atol 0.3 (tests/test_models_smoke.py). Every JAX array is made with an
explicit dtype: another test file in the same worker may have turned on
jax's x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import tiny_config as jax_tiny_config
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jhyb
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.models import build_model
from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm
from repro_torch.models.convert import from_jax_params

SSD_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=0.15, atol=0.3)}
# one bf16 ulp (2^-7 of a value at the foot of its binade), beside the f32
# difference of two sums near zero, where one ulp is below it
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)
ARCH = "zamba2-1.2b"


def close(got: torch.Tensor, want, **tol):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def ssd_inputs(b, S, H, P, N, seed=0):
    """x, dt = softplus(normal - 1), A = -exp(normal / 2), B, C: the decays
    and inputs of a Mamba-2 layer, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    dt = np.log1p(np.exp(normal(b, S, H) - 1)).astype(np.float32)
    A = -np.exp(normal(H) * 0.5).astype(np.float32)
    return normal(b, S, H, P), dt, A, normal(b, S, N) * 0.5, normal(b, S, N) * 0.5


# ------------------------------ the SSD -------------------------------- #
def test_segsum_matches_the_reference():
    x = np.random.default_rng(1).standard_normal((2, 3, 16), dtype=np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x, jnp.float32)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isneginf(got[0, 0]), ~np.tri(16, dtype=bool))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **SSD_TOL)


@pytest.mark.parametrize("S", [13, 16, 37])     # below, at and past one chunk, ragged
def test_ssd_chunked_and_final_state_match_the_reference(S):
    x, dt, A, B, C = ssd_inputs(2, S, 4, 8, 6, seed=S)
    want_y, want_h = jssm.ssd_chunked(*[jnp.asarray(a, jnp.float32) for a in (x, dt, A, B, C)],
                                      chunk=16)
    y, h = ssm.ssd_chunked(*[torch.from_numpy(a) for a in (x, dt, A, B, C)], chunk=16)
    assert y.shape == (2, S, 4, 8) and h.shape == (2, 4, 8, 6)
    assert y.dtype == h.dtype == torch.float32
    close(y, want_y, **SSD_TOL)
    close(h, want_h, **SSD_TOL)


def test_ssd_in_two_pieces_is_the_whole():
    """The final state carries the sequence: the second half started from
    the first half's state (through the decay of its chunk) adds up to the
    whole scan's state, computed in chunks of another size."""
    x, dt, A, B, C = [torch.from_numpy(a) for a in ssd_inputs(1, 40, 2, 4, 3, seed=2)]
    _, h = ssm.ssd_chunked(x, dt, A, B, C, chunk=16)
    _, h1 = ssm.ssd_chunked(x[:, :24], dt[:, :24], A, B[:, :24], C[:, :24], chunk=8)
    _, h2 = ssm.ssd_chunked(x[:, 24:], dt[:, 24:], A, B[:, 24:], C[:, 24:], chunk=8)
    decay = torch.exp((dt[:, 24:] * A).sum(1))                     # (b, h)
    close(h, decay[..., None, None] * h1 + h2, rtol=1e-5, atol=1e-5)


# ------------------------------ the step ------------------------------- #
def test_mamba2_step_matches_the_reference():
    """The step against the reference's, f32 parameters: output and h at
    1e-4, h updated in place; the conv states stay bf16, within one bf16
    ulp of the reference's, which promotes them to f32 (ROADMAP C16)."""
    jcfg = jax_tiny_config(jax_get_config(ARCH)).with_overrides(param_dtype="float32")
    cfg = tiny_config(get_config(ARCH)).with_overrides(param_dtype="float32")
    jp = jssm.mamba2_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    H, N = cfg.ssm.n_heads, cfg.ssm.d_state
    u = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    conv_x = rng.standard_normal((2, 3, cfg.d_inner)).astype(np.float32)
    conv_bc = rng.standard_normal((2, 3, 2 * N)).astype(np.float32)
    h = rng.standard_normal((2, H, cfg.d_inner // H, N), dtype=np.float32)
    jstate = {"conv_x": jnp.asarray(conv_x, jnp.bfloat16),
              "conv_bc": jnp.asarray(conv_bc, jnp.bfloat16), "h": jnp.asarray(h, jnp.float32)}
    want, jnew = jssm.mamba2_step(jp, jcfg, jnp.asarray(u, jnp.float32), jstate)
    state = {"conv_x": torch.from_numpy(conv_x).to(torch.bfloat16),
             "conv_bc": torch.from_numpy(conv_bc).to(torch.bfloat16), "h": torch.from_numpy(h)}
    bufs = dict(state)
    got, new = ssm.mamba2_step(p, cfg, torch.from_numpy(u), state)
    assert got.shape == (2, 1, cfg.d_model)
    close(got, want, **TOL["float32"])
    close(new["h"], jnew["h"], **TOL["float32"])
    assert all(new[k] is bufs[k] for k in bufs)                     # in place
    for k in ("conv_x", "conv_bc"):
        assert jnew[k].dtype == jnp.float32 and new[k].dtype == torch.bfloat16
        close(new[k], np.asarray(jnew[k]), **BF16_ULP)


# ---------------------------- the model -------------------------------- #
def configs(param_dtype, n_layers=None):
    """The reference's and the port's tiny zamba2: as is (12 layers, two
    groups, no tail) or with ``n_layers`` (14: two groups and a tail of 2)."""
    kw = dict(param_dtype=param_dtype)
    if n_layers:
        kw["n_layers"] = n_layers
    return (jax_tiny_config(jax_get_config(ARCH)).with_overrides(**kw),
            tiny_config(get_config(ARCH)).with_overrides(**kw))


def both_models(param_dtype, n_layers=None):
    jcfg, cfg = configs(param_dtype, n_layers)
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
    if tree is None:
        return {prefix: None}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif tree is not None:
        yield tree


MODEL_CASES = [pytest.param(d, n, id=f"{d}-{'tail2' if n else 'notail'}")
               for d in ("float32", "bfloat16") for n in (None, 14)]


@pytest.mark.parametrize("param_dtype,n_layers", MODEL_CASES)
def test_init_tree_and_cache_match_the_reference(param_dtype, n_layers):
    jm, jp, m, _ = both_models(param_dtype, n_layers)
    p = m.init(torch.Generator().manual_seed(0))
    assert shapes(p) == shapes(jp)
    assert (p["stack"]["tail"] is None) == (n_layers is None)
    assert shapes(m.init_cache(3, 40)) == shapes(jm.init_cache(3, 40))
    assert sum(t.numel() for t in leaves(p)) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


@pytest.mark.parametrize("param_dtype,n_layers", MODEL_CASES)
def test_forward_prefill_decode_match_the_reference(param_dtype, n_layers):
    jm, jp, m, p = both_models(param_dtype, n_layers)
    tol = TOL[param_dtype]
    jt, tt = tokens((2, 21))
    want, _ = jm.forward(jp, {"tokens": jt})
    close(m.forward(p, {"tokens": tt}), want, **tol)

    jl, jc = jm.prefill(jp, {"tokens": jt[:, :20]}, 24)
    logits, cache = m.prefill(p, {"tokens": tt[:, :20]}, 24)
    close(logits, jl, **tol)
    assert shapes(cache) == shapes(jc)                 # the keys keep their type (C2)
    if param_dtype == "float32":
        for part in ["ssm"] + (["tail"] if n_layers else []):
            close(cache[part]["h"], jc[part]["h"], **tol)
            close(cache[part]["conv_x"], jc[part]["conv_x"], **BF16_ULP)
        close(cache["attn_k"], jc["attn_k"], **tol)
    jl, jc = jm.decode_step(jp, jt[:, 20:21], jc, jnp.asarray(20, jnp.int32))
    logits, cache = m.decode_step(p, tt[:, 20:21], cache, 20)
    close(logits, jl, **tol)
    close(logits[:, 0], want[:, 20], **TOL["bfloat16"])
    if param_dtype == "float32":
        close(cache["ssm"]["h"], jc["ssm"]["h"], **tol)
        close(cache["attn_v"], jc["attn_v"], **tol)


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


def test_full_config_splits_and_counts_as_the_reference():
    """zamba2-1.2b: 6 groups of 6 and a tail of 2, and the parameter count
    of the reference's tree, both reckoned from shapes without allocating."""
    cfg = get_config(ARCH)
    jcfg = jax_get_config(ARCH)
    assert hyb.hybrid_split(cfg) == jhyb.hybrid_split(jcfg) == (6, 2)
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    with FakeTensorMode():
        p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        assert shapes(p) == shapes(jshapes)
        assert sum(t.numel() for t in leaves(p)) == want == 1_104_937_856
