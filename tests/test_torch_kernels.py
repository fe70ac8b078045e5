"""The port's kernels against the JAX package's, on the CPU.

The same inputs, drawn with NumPy from a seed, go through the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and through the port's
wrapper, which on a CPU tensor computes the kernel's plain PyTorch version.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.

Tolerances are the reference's own: f32 2e-5 (1e-5 for rmsnorm), where the
two sides differ by the order of f32 sums only; bf16 2e-2, a few bf16 ulps
(2^-8) of the output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.kernels.decode_attention import flash_decode_bkgd
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.attention import chunk_attention as jax_chunk_attention
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.attention import reference_attention as jax_reference_attention
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import merge_partials_plain, split_plan

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw(rng, shape, dtype="float32"):
    """One NumPy draw, handed to both frameworks in `dtype`."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# --------------------------- flash attention -------------------------- #
@pytest.mark.parametrize("S,T,D,g,kind,dtype", [
    (128, 128, 64, 1, "causal", "float32"),
    (256, 256, 128, 4, "causal", "bfloat16"),
    (128, 384, 64, 2, "bidirectional", "float32"),
    (200, 200, 64, 2, "causal", "float32"),        # non-multiple of block
    (256, 256, 64, 1, "local", "float32"),
    (128, 128, 256, 4, "causal", "bfloat16"),       # head_dim 256: gemma3-1b's group
    (128, 128, 256, 1, "local", "float32"),
])
def test_flash_attention_matches_pallas(S, T, D, g, kind, dtype):
    BKV = 2
    rng = np.random.default_rng(0)
    jq, tq = draw(rng, (BKV * g, S, D), dtype)
    jk, tk = draw(rng, (BKV, T, D), dtype)
    jv, tv = draw(rng, (BKV, T, D), dtype)
    want = flash_attention_bhsd(jq, jk, jv, kind=kind, window=64,
                                block_q=128, block_k=128, interpret=True)
    # the kernel-test layout as strided model-layout views, one KV head
    got = ops.flash_attention(tq.view(BKV, g, S, D).permute(0, 2, 1, 3),
                              tk[:, :, None], tv[:, :, None],
                              kind=kind, window=64)
    got = got.permute(0, 2, 1, 3).reshape(BKV * g, S, D)
    close(got, want, 2e-2 if dtype == "bfloat16" else 2e-5)


def test_flash_attention_model_layout():
    B, S, H, KVH, D = 2, 128, 8, 2, 64
    rng = np.random.default_rng(1)
    jq, tq = draw(rng, (B, S, H, D))
    jk, tk = draw(rng, (B, S, KVH, D))
    jv, tv = draw(rng, (B, S, KVH, D))
    got = ops.flash_attention(tq, tk, tv, kind="causal")
    close(got, jops.flash_attention(jq, jk, jv, kind="causal"), 2e-5)
    close(got, jax_reference_attention(jq, jk, jv, "causal"), 2e-5)


@pytest.mark.parametrize("pos0,C", [(0, 16), (37, 23)])
def test_flash_attention_q_offset_is_chunk_attention(pos0, C):
    """q_offset = pos0 over the first pos0 + C cache rows computes what the
    reference engine's chunk_attention computes over the whole cache."""
    B, H, KVH, D, smax = 2, 4, 2, 16, 80
    rng = np.random.default_rng(2)
    jq, tq = draw(rng, (B, C, H, D))
    jk, tk = draw(rng, (B, smax, KVH, D))
    jv, tv = draw(rng, (B, smax, KVH, D))
    want = jax_chunk_attention(jq, jk, jv, pos0)
    n = pos0 + C
    got = ops.flash_attention(tq, tk[:, :n], tv[:, :n], kind="causal",
                              q_offset=pos0)
    close(got, want, 2e-5)


@pytest.mark.parametrize("B,S,H,T", [
    (1, 128, 16, 640),      # the path's chunk deep in a prompt
    (1, 128, 16, 128),      # ... at pos0 = 0
    (1, 768, 16, 768),      # a whole prompt (serial mode)
    (1, 37, 16, 248),       # a ragged last chunk
    (8, 64, 16, 64),        # one key tile: nothing to split
    (4, 512, 16, 512),      # enough blocks without a split
    (1, 1, 1, 1), (1, 5, 2, 4097), (2, 200, 4, 200),
])
def test_flash_attention_split_plan_covers_the_keys(B, S, H, T):
    """The split of the keys over blocks, which the CUDA kernel relies on:
    whole tiles per split, every key in exactly one split, at most
    MAX_SPLITS pieces; f32 queries run the FMA body unsplit."""
    for kv_splits in (0, 1, 2, 3, 4):
        plan = fa_mod.split_plan(B, S, H, T, torch.bfloat16, kv_splits=kv_splits)
        chunk, n = plan["chunk"], plan["kv_splits"]
        assert plan["body"] == "mma_bf16" and plan["bm"] == fa_mod.TILE
        assert chunk % fa_mod.TILE == 0 and chunk >= fa_mod.TILE
        assert chunk * n >= T > chunk * (n - 1)
        assert 1 <= n <= fa_mod.MAX_SPLITS and (kv_splits == 0 or n <= kv_splits)
        covered = np.zeros(T, int)
        for sp in range(n):
            covered[sp * chunk:(sp + 1) * chunk] += 1
        assert (covered == 1).all()
    # a grid that fills the card is not split
    blocks = -(-S // fa_mod.TILE) * H * B
    if blocks >= fa_mod.BLOCKS_PER_SM * fa_mod.N_SM:
        assert fa_mod.split_plan(B, S, H, T, torch.bfloat16)["kv_splits"] == 1
    plan = fa_mod.split_plan(B, S, H, T, torch.float32)
    assert plan["body"] == "fma_f32" and plan["kv_splits"] == 1
    assert plan["bm"] in (32, 64) and plan["chunk"] >= T


def _partials(s, v, ok, chunk, n_splits):
    """Per split of ``chunk`` keys: the running maximum, the sum of weights
    and the weighted values of the scores ``s`` (..., T) over the keys that
    ``ok`` lets through; a split with no such key gives (-1e30, 0, 0)."""
    ms, ls, accs = [], [], []
    for sp in range(n_splits):
        sl = slice(sp * chunk, (sp + 1) * chunk)
        sc = torch.where(ok[..., sl], s[..., sl], torch.full_like(s[..., sl], -torch.inf))
        m = sc.amax(dim=-1).clamp_min(-1e30)
        w = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(w.sum(dim=-1))
        accs.append(torch.einsum("...t,...td->...d", w, v[..., sl, :]))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


@pytest.mark.parametrize("T,G,D,lens", [(512, 4, 64, (512, 256, 7)),
                                        (1025, 2, 128, (1025, 1, 700)),
                                        (300, 1, 16, (300, 5, 64)),
                                        (300, 4, 256, (300, 130, 9))])
def test_merge_of_decode_partials_is_flash_decode(T, G, D, lens):
    """Split the keys as split_plan does, compute each split's partial
    (m, l, acc) in torch and merge them with merge_partials_plain: the
    Pallas decode kernel's result (interpret mode), in f32. Short lengths
    leave splits that see no valid key."""
    BKV = 3
    rng = np.random.default_rng(7)
    jq, tq = draw(rng, (BKV, G, D))
    jk, tk = draw(rng, (BKV, T, D))
    jv, tv = draw(rng, (BKV, T, D))
    lens = np.array(lens, np.int32)
    want = flash_decode_bkgd(jq, jk, jv, jnp.asarray(lens), block_k=128, interpret=True)
    chunk, n_splits = split_plan(T, BKV)
    assert any(sp * chunk >= n for n in lens for sp in range(n_splits))   # an empty split
    s = torch.einsum("bgd,btd->bgt", tq, tk) / np.sqrt(D)
    ok = (torch.arange(T)[None, :] < torch.from_numpy(lens)[:, None])[:, None, :]
    m, l, acc = _partials(s, tv[:, None].expand(BKV, G, T, D), ok, chunk, n_splits)
    close(merge_partials_plain(m, l, acc, torch.float32), want, 2e-5)


@pytest.mark.parametrize("S,T,kind,kv_splits", [(128, 128, "causal", 2),
                                                (200, 200, "causal", 4),
                                                (128, 384, "bidirectional", 3),
                                                (256, 256, "local", 4)])
def test_merge_of_attention_partials_is_flash_attention(S, T, kind, kv_splits):
    """The same for attention: the keys cut per flash_attention's split
    plan, partials in torch, merged; against the Pallas kernel in interpret
    mode at 2e-5. Causal and local rows see no key in some splits."""
    BKV, g, D = 2, 2, 64
    rng = np.random.default_rng(8)
    jq, tq = draw(rng, (BKV * g, S, D))
    jk, tk = draw(rng, (BKV, T, D))
    jv, tv = draw(rng, (BKV, T, D))
    want = flash_attention_bhsd(jq, jk, jv, kind=kind, window=64, block_q=128,
                                block_k=128, interpret=True)
    plan = fa_mod.split_plan(1, S, 1, T, torch.bfloat16, kv_splits=kv_splits)
    chunk, n_splits = plan["chunk"], plan["kv_splits"]
    assert n_splits > 1
    q = tq.view(BKV, g, S, D)
    s = torch.einsum("bgsd,btd->bgst", q, tk) / np.sqrt(D)
    qp, kp = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = {"causal": kp <= qp, "local": (kp <= qp) & (kp > qp - 64),
          "bidirectional": torch.ones(S, T, dtype=torch.bool)}[kind]
    if kind != "bidirectional":
        assert not ok[:, :chunk].any(dim=1).all() or not ok[:, -chunk:].any(dim=1).all()
    m, l, acc = _partials(s, tv[:, None, None].expand(BKV, g, S, T, D), ok, chunk, n_splits)
    got = merge_partials_plain(m, l, acc, torch.float32).reshape(BKV * g, S, D)
    close(got, want, 2e-5)


def test_flash_attention_refuses_softcap():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q, q, softcap=30.0)


# ---------------------------- flash decode ---------------------------- #
@pytest.mark.parametrize("T,G,D,block_k", [(512, 4, 64, 128),
                                           (384, 1, 128, 256),
                                           (1024, 8, 64, 512),
                                           (256, 4, 256, 128),   # gemma3-1b's group
                                           (256, 8, 256, 128)])  # gemma-2b's
def test_flash_decode_matches_pallas(T, G, D, block_k):
    BKV = 3
    rng = np.random.default_rng(3)
    jq, tq = draw(rng, (BKV, G, D))
    jk, tk = draw(rng, (BKV, T, D))
    jv, tv = draw(rng, (BKV, T, D))
    lens = np.array([T, T // 2, 7], np.int32)
    want = flash_decode_bkgd(jq, jk, jv, jnp.asarray(lens), block_k=block_k,
                             interpret=True)
    got = ops.flash_decode(tq[:, None], tk[:, :, None], tv[:, :, None],
                           torch.from_numpy(lens))
    close(got[:, 0], want, 2e-5)


def test_flash_decode_model_layout():
    B, H, KVH, D, T = 2, 8, 2, 64, 256
    rng = np.random.default_rng(4)
    jq, tq = draw(rng, (B, 1, H, D))
    jk, tk = draw(rng, (B, T, KVH, D))
    jv, tv = draw(rng, (B, T, KVH, D))
    lens = np.array([200, 64], np.int32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lens))
    close(got, jops.flash_decode(jq, jk, jv, jnp.asarray(lens)), 2e-5)
    close(got, jax_decode_attention(jq, jk, jv, jnp.asarray(lens)), 2e-5)
    # a scalar length serves every sequence
    close(ops.flash_decode(tq, tk, tv, 100),
          jax_decode_attention(jq, jk, jv, 100), 2e-5)


@pytest.mark.parametrize("T,n_pairs", [(1025, 64), (97, 4), (64, 1), (4096, 512),
                                       (33, 1000)])
def test_flash_decode_split_plan_covers_the_cache(T, n_pairs):
    """The split of the keys over blocks, which the CUDA kernel relies on:
    whole tiles per split, every key in exactly one split; and short
    splits (``_SPLIT_KEYS``) unless the card is full or the splits run out."""
    chunk, n_splits = split_plan(T, n_pairs)
    assert chunk % dec_mod._TILE == 0 and chunk >= dec_mod._TILE
    assert chunk * n_splits >= T > chunk * (n_splits - 1)
    assert 1 <= n_splits <= dec_mod._MAX_SPLITS
    if n_pairs * -(-T // dec_mod._SPLIT_KEYS) <= dec_mod._MAX_BLOCKS \
            and T <= dec_mod._SPLIT_KEYS * dec_mod._MAX_SPLITS:
        assert chunk == max(dec_mod._TILE, -(-dec_mod._SPLIT_KEYS // dec_mod._TILE)
                            * dec_mod._TILE) or n_splits == 1


@pytest.mark.parametrize("lens", [(200, 64), (1, 256)])
def test_flash_decode_takes_int64_and_int32_lengths(lens):
    """The model hands its lengths over as int64, a caller may have int32:
    ops.flash_decode takes either as it is, with one result, the
    reference's."""
    B, H, KVH, D, T = 2, 8, 2, 64, 256
    rng = np.random.default_rng(9)
    jq, tq = draw(rng, (B, 1, H, D))
    jk, tk = draw(rng, (B, T, KVH, D))
    jv, tv = draw(rng, (B, T, KVH, D))
    l64 = torch.tensor(lens, dtype=torch.int64)
    got64 = ops.flash_decode(tq, tk, tv, l64)
    got32 = ops.flash_decode(tq, tk, tv, l64.to(torch.int32))
    assert torch.equal(got64, got32)
    close(got64, jax_decode_attention(jq, jk, jv, jnp.asarray(np.array(lens, np.int32))), 2e-5)


# ------------------------------ rmsnorm ------------------------------- #
@pytest.mark.parametrize("R,d,dtype", [(64, 256, "float32"),
                                       (100, 512, "bfloat16"),
                                       (1024, 128, "float32")])
def test_rmsnorm_matches_pallas(R, d, dtype):
    rng = np.random.default_rng(5)
    jx, tx = draw(rng, (R, d), dtype)
    js, ts = draw(rng, (d,))
    want = rmsnorm_pallas(jx, js, interpret=True)
    close(ops.rmsnorm(tx, ts), want, 2e-2 if dtype == "bfloat16" else 1e-5)


def test_rmsnorm_leading_dims_and_strided_rows():
    rng = np.random.default_rng(6)
    jx, tx = draw(rng, (3, 10, 64))
    js, ts = draw(rng, (64,))
    close(ops.rmsnorm(tx, ts, 1e-5), jops.rmsnorm(jx, js, eps=1e-5), 1e-5)
    close(ops.rmsnorm(tx[:, -1:], ts), jops.rmsnorm(jx[:, -1:], js), 1e-5)


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version for a CPU tensor (and a ``meta``
    one: the dry run's count of shapes, ``tests/test_torch_dryrun.py``)
    only; any other device without the kernel raises instead of falling
    back: here fake ``xpu`` tensors, which need no such device."""
    with FakeTensorMode():
        x = torch.zeros(2, 8, device="xpu")
        with pytest.raises(ValueError):
            ops.rmsnorm(x, torch.ones(8, device="xpu"))
        q = torch.zeros(1, 1, 2, 16, device="xpu")
        with pytest.raises(ValueError):
            ops.flash_attention(q, q, q)
        with pytest.raises(ValueError):
            dec_mod.flash_decode(q, q, q, torch.ones(1, dtype=torch.int32, device="xpu"))


# ------------------------------ the build ----------------------------- #
def test_ctypes_signatures_match_the_c_prototypes():
    """Every extern "C" entry point of csrc/*.cu has argtypes in _build, of
    the same number and kinds as its C parameters (a mismatch would cut a
    pointer or shift every later argument, and shows only on the card)."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float,
             "double": ctypes.c_double}
    found = {}
    for src in _build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                       src.read_text(), flags=re.S):
            types = []
            for prm in params.split(","):
                t = prm.replace("const", "").strip().rsplit(" ", 1)[0].strip()
                types.append(kinds[t.replace(" *", "*")])
            found[name] = types
    assert found == _build._SIGNATURES
    assert len(_build.sources()) == 7


def test_library_is_keyed_by_its_sources(tmp_path, monkeypatch):
    import shutil

    from repro_torch.kernels import _build
    before = _build.library_path()
    assert before.parent.name == "repro_torch" and before.parent.parent.name == "build"
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path() == before          # same sources, same library
    (copy / "common.cuh").write_text((copy / "common.cuh").read_text() + "\n// edit\n")
    assert _build.library_path() != before          # an edit rebuilds


def test_build_without_a_compiler_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises and nothing stands in for the kernels."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda_here"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []
