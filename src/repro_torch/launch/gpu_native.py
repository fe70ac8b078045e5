"""The card's own benchmarks, the twin of the reference's TPU-native ones:
the stressor suite timed on the card, and the paper's §4 measure → fit →
validate loop run on CUDA streams against two of the port's attention
kernels at the full width of qwen3-1.7b.

    python -m repro_torch.launch.gpu_native        # JSON lines; needs a GPU

The victims are the attention of one serving step over the 28 layers' own
KV cache (8 slots × 1025 positions × 8 KV heads × 128, bf16: 940 MB for K
and V), each replayed from a CUDA graph so that its time is the device's:

  * ``decode_attention_step``: ``flash_decode`` × 28, B=8, H=16, KVH=8,
    D=128, valid lengths ``DECODE_KV_LEN``;
  * ``prefill_chunk_attention``: ``flash_attention`` × 28, a chunk of 128
    queries over 640 keys at pos0=512, slot 3 of the cache.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.calib import (CACHE_WS_FRACTIONS, FIT_LAMBDAS, StressorSpec,
                               TorchBackend, fit_profiles, holdout_mixes,
                               median_iqr_time, predict_slowdowns,
                               profile_to_params, validate)
from repro_torch.calib.measure import _stressor_call
from repro_torch.configs.registry import get_config
from repro_torch.core.profile import KernelProfile
from repro_torch.core.resources import H100, RESOURCE_AXES
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod

Row = Tuple[str, float, str]
AXES = ("mxu", "vpu", "hbm", "smem")      # one per distinct stressor kernel
SLOTS, CACHE_LEN = 8, 1025                # the serving path's cache
DECODE_KV_LEN = (1025, 1025, 64, 200, 333, 512, 800, 1000)   # idle slots read it all
PREFILL_S, PREFILL_POS0, PREFILL_SLOT = 128, 512, 3


def stressor_suite(repeats: int = 5, device="cuda") -> List[Row]:
    """Device time of each stressor kernel at full intensity (one block per
    SM, a dispatch of about a millisecond), median of ``repeats`` timed on
    a stream by ``median_iqr_time``, and the rate it reaches on its axis."""
    stream = torch.cuda.Stream(device)
    rows = []
    for axis in AXES:
        call = _stressor_call(StressorSpec(axis, 1.0), device)
        torch.cuda.synchronize(device)
        med, iqr = median_iqr_time(call, repeats=repeats, warmup=1, stream=stream)
        unit = "FLOP/s" if axis in ("mxu", "vpu") else "B/s"
        rows.append((f"{call.kernel}_{axis}", med * 1e6,
                     f"blocks={call.blocks}|{json.dumps(call.kwargs)}"
                     f"|median_of={repeats}|iqr_us={iqr * 1e6:.1f}"
                     f"|{unit}={call.work / med:.4g}"))
    return rows


# --------------------------------------------------------------------- #
#  victims                                                               #
# --------------------------------------------------------------------- #
# FLOPs of one warp instruction on each compute axis: 32 lanes x one FMA on
# the FP32 pipes, one mma.sync m16n8k16 (16 x 8 x 16 multiply-adds) on the
# tensor cores
FLOPS_PER_WARP_INSTR = {"vpu": 64.0, "mxu": 4096.0}


@dataclass
class Victim:
    """A victim's zero-argument launcher and the work of one call: bytes
    of device memory, FLOPs and the axis its kernel runs them on (``"mxu"``:
    the tensor cores; ``"vpu"``: the FP32 pipes), and an estimate of its
    shared-memory bytes."""
    name: str
    fn: Callable[[], object]
    hbm_bytes: float
    flops: float
    smem_bytes: float
    axis: str = "vpu"

    def profile(self, t_iso: float) -> KernelProfile:
        """The analytic profile: its bytes and operations over its measured
        isolated time, as a demand vector (warp instructions on the issue
        axis: one per ``FLOPS_PER_WARP_INSTR`` of its axis and one per 512
        bytes of shared memory, 16 bytes a lane, as cp.async, ldmatrix and
        the decode kernel's row loads move them)."""
        demand = {r: 0.0 for r in RESOURCE_AXES}
        demand.update({self.axis: self.flops},
                      issue=self.flops / FLOPS_PER_WARP_INSTR[self.axis] + self.smem_bytes / 512,
                      hbm=self.hbm_bytes, l2=self.hbm_bytes, smem=self.smem_bytes)
        return KernelProfile(f"{self.name}:analytic", demand=demand,
                             duration=t_iso)


def _graphed(fn: Callable[[], object], device) -> Callable[[], object]:
    """On a CUDA device, ``fn`` captured once into a CUDA graph (after one
    warm call): its ``replay``, which launches on the current stream. On
    the CPU, ``fn`` itself."""
    if torch.device(device).type != "cuda":
        return fn
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize(device)
    return graph.replay


def attention_victims(device="cuda", seed: int = 0,
                      n_layers: int = 0) -> Dict[str, Victim]:
    """The two victims over one shared cache of ``n_layers`` layers (0:
    the model's 28), at qwen3-1.7b's widths, inputs from a seeded
    ``torch.Generator`` on ``device``."""
    cfg = get_config("qwen3-1.7b")
    L = n_layers or cfg.n_layers
    H, KVH, D = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    ck, cv = randn(L, SLOTS, CACHE_LEN, KVH, D), randn(L, SLOTS, CACHE_LEN, KVH, D)
    q_dec = randn(L, SLOTS, 1, H, D)
    lens = torch.tensor(DECODE_KV_LEN, dtype=torch.int32, device=device)
    T = PREFILL_POS0 + PREFILL_S
    q_pre = randn(L, 1, PREFILL_S, H, D)
    s = PREFILL_SLOT

    def decode():
        for layer in range(L):
            dec_mod.flash_decode(q_dec[layer], ck[layer], cv[layer], lens)

    def prefill():
        for layer in range(L):
            fa_mod.flash_attention(q_pre[layer], ck[layer, s:s + 1, :T],
                                   cv[layer, s:s + 1, :T], "causal", 0,
                                   PREFILL_POS0)

    n_keys = sum(DECODE_KV_LEN)
    dec_kv = 2 * n_keys * KVH * D                     # K and V elements read
    dec_flops = 4.0 * n_keys * H * D
    pairs = sum(min(T, i + PREFILL_POS0 + 1) for i in range(PREFILL_S))
    pre_flops = 4.0 * pairs * H * D
    tile = fa_mod.TILE
    # key tiles each 64-query tile of the chunk walks (its split pieces add up
    # to the same tiles)
    walked = sum(-(-min(T, q0 + tile + PREFILL_POS0) // tile)
                 for q0 in range(0, PREFILL_S, tile))
    return {
        "decode_attention_step": Victim(
            "decode_attention_step", _graphed(decode, device),
            hbm_bytes=L * (2.0 * dec_kv + 2 * 2 * SLOTS * H * D + 4 * SLOTS),
            flops=L * dec_flops,
            # scores and weighted sums as FMAs on the FP32 pipes; K/V tiles
            # staged in bf16 by cp.async, each element read once by one lane
            smem_bytes=L * 2.0 * 2 * dec_kv, axis="vpu"),
        "prefill_chunk_attention": Victim(
            "prefill_chunk_attention", _graphed(prefill, device),
            hbm_bytes=L * 2.0 * (2 * PREFILL_S * H * D + 2 * T * KVH * D),
            flops=L * pre_flops,
            # products on the tensor cores; bf16 Q written and read once, each
            # K/V tile written once and read by the block's four warps
            smem_bytes=L * H * (2.0 * 2 * PREFILL_S * D + 2.0 * 2 * tile * D * (1 + 4) * walked),
            axis="mxu"),
    }


# --------------------------------------------------------------------- #
#  the §4 loop                                                           #
# --------------------------------------------------------------------- #
def _label(c) -> str:
    parts = [s.axis + f"@{s.intensity:g}" + (f"/ws{s.working_set:.3g}" if s.working_set else "")
             for s in c.stressors]
    return ("reverse:" if c.observe == "stressor" else "") + "+".join(parts)


def _prediction_errors(rows: List[dict]) -> Dict[str, float]:
    """Mean relative error of the analytic and of the fitted prediction
    over ``rows``, each a colocation record."""
    meas = np.asarray([r["measured"] for r in rows])
    return {kind: float(np.mean(np.abs(np.asarray([r[f"predicted_{kind}"]
                                                   for r in rows]) - meas) / meas))
            for kind in ("analytic", "fitted")}


def _utilization(k: KernelProfile) -> Dict[str, float]:
    p = profile_to_params(k, H100)
    return {key: float(v) for key, v in p.items()}


def interference_sweep(device="cuda", repeats: int = 5, seed: int = 0,
                       axes=AXES, lambdas=FIT_LAMBDAS,
                       cache_ws_fractions=CACHE_WS_FRACTIONS) -> dict:
    """Build the two victims, run ``TorchBackend.run_sweep`` over the four
    stressor axes (single, multi-stressor, reverse and cache probes), fit
    each victim's profile (``fit_profiles``), validate it on held-out
    single-stressor probes off the fit grid (``holdout_mixes([victim])``:
    no cohort), and return the records: every colocation's measured
    slowdown beside the slowdowns the analytic and the fitted profiles
    predict, both profiles, the validation reports and the brackets."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"interference_sweep runs on a CUDA device, not {device}")
    victims = attention_victims(device, seed)
    be = TorchBackend({n: v.fn for n, v in victims.items()}, H100,
                      repeats=repeats, device=device)
    return measure_fit_validate(victims, be, seed, axes, lambdas, cache_ws_fractions)


def measure_fit_validate(victims: Dict[str, Victim], be, seed: int = 0,
                         axes=AXES, lambdas=FIT_LAMBDAS,
                         cache_ws_fractions=CACHE_WS_FRACTIONS) -> dict:
    """The loop of ``interference_sweep`` on any backend that keeps a
    ``records`` list as ``TorchBackend`` does."""
    ms = be.run_sweep(list(victims), axes, lambdas, cache_ws_fractions)
    analytic = {n: v.profile(ms.isolated_times[n]) for n, v in victims.items()}
    fitted = fit_profiles(ms)
    reports = {}
    rng = np.random.default_rng(seed)
    for n in victims:
        reports[n] = validate(fitted, be, holdout_mixes([n], rng, axes=axes))
    runs = be.records
    cols = [r["colocation"] for r in runs]
    pred_a = predict_slowdowns(analytic, cols, H100)
    pred_f = predict_slowdowns(fitted, cols, H100)
    n_fit = len(ms)
    colocations = [{
        "victim": r["colocation"].victim, "probe": _label(r["colocation"]),
        "set": "fit" if i < n_fit else "holdout",
        "measured": r["slowdown"], "predicted_analytic": float(pred_a[i]),
        "predicted_fitted": float(pred_f[i]),
        "isolated_ms": r["isolated_s"] * 1e3, "colocated_ms": r["colocated_s"] * 1e3,
        "bracket_margin_ms": r["bracket_margin_s"] * 1e3,
        "background_dispatches": r["background_dispatches"]}
        for i, r in enumerate(runs)]
    single = {i for i, c in enumerate(cols) if c.single_axis}

    def errors(n, subset):
        return _prediction_errors([r for i, r in enumerate(colocations)
                                   if r["victim"] == n and subset(i)])

    profiles = {n: {"isolated_ms": ms.isolated_times[n] * 1e3,
                    "hbm_bytes": v.hbm_bytes, "flops": v.flops,
                    "smem_bytes": v.smem_bytes,
                    "analytic": _utilization(analytic[n]),
                    "fitted": _utilization(fitted[n]),
                    # mean relative error of each profile's predictions: on
                    # the fit set, on its single-stressor probes, held out
                    "prediction_error": {
                        "fit_set": errors(n, lambda i: i < n_fit),
                        "fit_single_stressor": errors(n, lambda i: i < n_fit and i in single),
                        "holdout": errors(n, lambda i: i >= n_fit)}}
                for n, v in victims.items()}
    margins = [r["bracket_margin_s"] for r in runs]
    return {"colocations": colocations, "profiles": profiles,
            "validation": {n: rep.to_json() for n, rep in reports.items()},
            "brackets": {"runs": len(runs), "all_bracketed": min(margins) >= 0,
                         "min_margin_ms": min(margins) * 1e3,
                         "median_margin_ms": float(np.median(margins)) * 1e3}}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gpu_native: no CUDA device (this measures the card)")
    for name, us, note in stressor_suite(args.repeats, args.device):
        print(json.dumps({"row": name, "us": us, "note": note}), flush=True)
    out = interference_sweep(args.device, args.repeats, args.seed)
    for rec in out["colocations"]:
        print(json.dumps(rec), flush=True)
    for key in ("profiles", "validation", "brackets"):
        print(json.dumps({key: out[key]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
