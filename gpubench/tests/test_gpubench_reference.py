"""The plain reference against the port's tiny dense and moe decoders on
the CPU, with the benchmark's own weights in float32. The test, not the
reference, imports the port."""
import pytest
import torch

from conftest import TINY_CONFIGS
from gpubench import weights as wt
from gpubench.reference import decoder


def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_reference_matches_the_port(name):
    from repro_torch.models import build_model
    cfg = wt.model_config(TINY_CONFIGS[name]).with_overrides(param_dtype="float32")
    shape = wt.shape(cfg)
    w = f32(wt.draw(shape, 2 ** 33 + 5, "cpu"))
    tokens = torch.randint(0, shape["vocab_size"], (24,), generator=torch.Generator().manual_seed(1))
    port = build_model(cfg, device="cpu").forward(w, {"tokens": tokens[None]})[0]
    at = torch.arange(24)
    ref = decoder.logits(w, shape, tokens, at)
    assert ref.shape == port.shape
    torch.testing.assert_close(ref, port.float(), rtol=2e-4, atol=2e-4)
    # the float8 control is a different computation, well outside that tolerance
    ctl = decoder.logits(w, shape, tokens, at, precision="fp8")
    assert (ctl - ref).abs().max() > 1e-2


def test_expert_capacity_matches_the_port():
    """Each expert keeps its first ``capacity`` assignments in token order,
    as the port's sort-based dispatch keeps them."""
    from repro_torch.models.moe import capacity, moe_ffn_local
    cfg = wt.model_config(TINY_CONFIGS["tiny-moe"]).with_overrides(param_dtype="float32")
    cfg = cfg.with_overrides(moe=cfg.moe.__class__(n_experts=4, top_k=2, d_ff_expert=64,
                                                   capacity_factor=0.25))
    shape = wt.shape(cfg)
    lp = f32(wt.draw(shape, 77, "cpu"))["stack"]["moe"]
    lp = {k: v[0] for k, v in lp.items()}
    x = torch.randn(48, 64, generator=torch.Generator().manual_seed(3))
    cap = capacity(48, cfg)
    assert cap < 48 * 2 / 4                   # some tokens are dropped
    port, _ = moe_ffn_local(lp, cfg, x[None])
    ref = decoder.experts(x, lp, shape, decoder.Precision("f32"), cap)
    torch.testing.assert_close(ref, port[0], rtol=1e-5, atol=1e-5)
    full = decoder.experts(x, lp, shape, decoder.Precision("f32"), None)
    assert (full - ref).abs().max() > 1e-3
