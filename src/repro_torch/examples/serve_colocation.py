"""Serving with interference-aware chunked prefill (paper §4.2/§5.1); the
twin of ``examples/serve_colocation.py``.

Runs the same request mix through the engine in `serial` mode (monolithic
prefills -> head-of-line blocking of the decode batch) and in
`interference_aware` mode (prefill chunks sized per-step by pricing
decode-vs-chunk `Scenario`s so the decode batch's TBT stays within SLO),
and compares decode-gap statistics. The engine runs on ``--device`` (on
the card: the ``rmsnorm``, ``flash_attention`` and ``flash_decode``
kernels, its steps replayed from CUDA graphs) and prices every chunk on
the device model ``--device-model`` through ``--backend``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_colocation [--device cpu]
"""
import numpy as np

from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.core import Scenario, solve_scenarios
from repro_torch.examples import arguments, pricing
from repro_torch.serve import Engine, EngineConfig


def run(mode: str, dev, device):
    cfg = tiny_config(get_config("qwen3-1.7b"))
    eng = Engine(cfg, ecfg=EngineConfig(max_slots=4, max_len=768,
                                        prefill_chunk=64, mode=mode,
                                        tbt_slo_ms=1e-6),
                 dev=dev, device=device)
    # a decode-heavy workload...
    for _ in range(3):
        eng.submit(list(np.random.default_rng(0).integers(1, 99, 12)),
                   max_new=30)
    for _ in range(5):
        eng.step()
    # ...interrupted by a LONG prompt (the paper's sleep-kernel analogue)
    eng.submit(list(np.random.default_rng(1).integers(1, 99, 512)), max_new=4)
    eng.run_until_done()

    # structural HOL metric: how many decode steps ran BETWEEN the long
    # prompt's first and last prefill chunk (serial: 0 — the decode batch
    # stalls for the whole monolithic prefill). The schedule itself, not a
    # wall-clock reading, is the observable the two modes are held to.
    kinds = [e.kind for e in eng.events]
    big_chunks = [i for i, e in enumerate(eng.events)
                  if e.kind == "prefill_chunk" and e.detail.get("chunk", 0) >= 16
                  and i > 8]
    interleaved = (kinds[big_chunks[0]:big_chunks[-1]].count("decode")
                   if len(big_chunks) > 1 else 0)
    chunks = [e.detail["chunk"] for e in eng.events
              if e.kind == "prefill_chunk"]
    print(f"mode={mode:20s} long prompt split into "
          f"{len(chunks) - 3} chunk(s); decode steps interleaved during "
          f"its prefill: {interleaved}")
    return interleaved


def show_chunk_pricing(dev, device):
    """The engine's per-step decision, spelled out: one Scenario per
    chunk candidate (victim = decode batch, background = the chunk).
    Returns the predicted slowdowns."""
    cfg = tiny_config(get_config("qwen3-1.7b"))
    eng = Engine(cfg, ecfg=EngineConfig(), dev=dev, device=device)
    decode = eng._phase_profile("decode", 3)
    cands = [256, 128, 64, 32]
    chunks = [eng._phase_profile(f"prefill{c}", c) for c in cands]
    br = solve_scenarios([Scenario((decode,), (ch,)) for ch in chunks],
                         eng.dev)
    print("\nchunk-size pricing (decode batch of 3):")
    for c, s in zip(cands, br.slowdowns[:, 0]):
        print(f"  chunk {c:4d} -> predicted decode slowdown {s:.2f}x")
    return br.slowdowns[:, 0]


def main(argv=None):
    """Returns (decode steps interleaved in serial mode, in
    interference-aware mode, the chunk prices)."""
    args = arguments(__doc__).parse_args(argv)
    with pricing(args) as dev:
        i_serial = run("serial", dev, args.device)
        i_aware = run("interference_aware", dev, args.device)
        print(f"\nHOL mitigation: serial interleaves {i_serial} decode steps "
              f"during the long prefill; interference-aware interleaves "
              f"{i_aware} (decode batch keeps flowing)")
        if not i_aware > i_serial:
            raise AssertionError(f"interference-aware mode interleaved {i_aware} "
                                 f"decode steps, serial {i_serial}")
        return i_serial, i_aware, show_chunk_pricing(dev, args.device)


if __name__ == "__main__":
    main()
