"""The moe cell's per-layer readers on synthetic records: the expert
kernels' roofline against a hand count at a tiny shape, and nothing to read
where a record holds no expert kernel (a dense model, or a program that
runs the experts on another kernel)."""
import numpy as np
import pytest

from gpubench import spec
from gpubench.trace import DeviceEvent

MOE = {"family": "moe", "n_layers": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256,
       "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "qk_norm": False,
       "rope_theta": 1e4, "norm_eps": 1e-5, "tie_embeddings": False,
       "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32, "capacity_factor": 2.0}}


def ev(name, start, dur):
    return DeviceEvent(name, float(start), float(dur))


def traced(shape, expert_kernels=True):
    """Decode replays of 4 slots: one with 1 active slot, one with 3."""
    def events(t0):
        out = [ev("void decode_partial_kernel<128>(DecodeParams)", t0, 2),
               ev("gemm", t0 + 2, 3)]
        if expert_kernels:
            out += [ev("moe_experts_gate_up_kernel(MoeParams)", t0 + 5, 4),
                    ev("moe_experts_down_kernel(MoeParams)", t0 + 9, 2)]
        return out
    replays = [{"kind": "decode", "pos": np.array([5, 64, 64, 64]), "events": events(0)},
               {"kind": "decode", "pos": np.array([1, 2, 3, 64]), "events": events(100)}]
    trace = {"slice": (0.0, 1.0), "offset_us": 0.0, "prefix_kept": 1, "replays": replays,
             "events": replays[0]["events"] + replays[1]["events"], "host": [], "steps": []}
    return {"seconds": 10.0, "requests": [], "steps": [], "picks": [], "chunks": [],
            "max_len": 64, "max_slots": 4, "shape": shape, "trace": trace}


def test_the_expert_roofline_against_a_hand_count():
    rec = traced(MOE)
    L, d, f, E = 2, 64, 32, 4
    bound = 0.0
    for active in (1, 3):
        rows = 2 * active                                # top 2
        nbytes = 2 * (min(E, rows) * 3 * d * f + rows * (d + f + d))
        flops = 6 * rows * d * f
        bound += L * max(nbytes / 3.35e12, flops / 989e12)
    want = 100 * bound / (2 * 6e-6)
    assert spec.load_reader("moe_experts_roofline")(rec) == pytest.approx(want, rel=1e-12)
    assert spec.load_reader("decode_step_ms.moe")(rec) == pytest.approx(11e-3)
    assert spec.load_reader("decode_step_ms.moe")(rec) == spec.load_reader("decode_step_ms")(rec)


@pytest.mark.parametrize("case", ["no trace", "dense", "no expert kernel"])
def test_nothing_to_read(case):
    dense = {k: v for k, v in MOE.items() if k != "moe"} | {"family": "dense"}
    rec = {"no trace": dict(traced(MOE), trace=None), "dense": traced(dense),
           "no expert kernel": traced(MOE, expert_kernels=False)}[case]
    assert spec.load_reader("moe_experts_roofline")(rec) is None
    if case == "no trace":
        assert spec.load_reader("decode_step_ms.moe")(rec) is None
    else:
        want = 11e-3 if case == "dense" else 5e-3
        assert spec.load_reader("decode_step_ms.moe")(rec) == pytest.approx(want)


def test_the_moe_cell_reads_both():
    names = [m.name for m in spec.load_cell("phi3.5-moe-l16.backlog").per_layer]
    assert names == ["moe_experts_roofline", "decode_step_ms.moe"]
