"""Trace-driven serving walkthrough: generate a diurnal+burst multi-
tenant trace, replay it through the `repro_torch.sim` closed loop with a
mid-trace device kill, and read the SLO-attainment report; the twin of
``examples/trace_serving.py``.

The pipeline, end to end:

  1. `TraceConfig` + `generate_trace` — a seeded, replayable tape of
     tenant arrivals (half in a t=0 storm), best-effort churn,
     per-tenant Poisson request streams shaped by a day-curve and
     fleet-wide burst windows, plus scripted faults; the tenants'
     profiles are drawn for the device model (``--device-model``);
  2. `Simulator` — a virtual-clock loop feeding those events into
     `FleetScheduler.tick()` and serving each placed tenant's requests
     at its interference-inflated rate (tbt_base x the placement's
     predicted slowdown from `solve_scenarios`, one solve on
     ``--backend``);
  3. the report — per-class SLO attainment (TTFT-slack + per-token
     deadlines), observed/service TBT percentiles, goodput, and the
     fleet's eviction/migration/replan counters.

Run:  PYTHONPATH=src python -m repro_torch.examples.trace_serving [--device cpu]
"""
from repro_torch.examples import arguments, pricing
from repro_torch.sim import Simulator, TraceConfig, generate_trace


def main(argv=None):
    args = arguments(__doc__).parse_args(argv)
    with pricing(args) as dev:
        return walkthrough(dev)


def walkthrough(dev):
    """Returns the report and its twin's."""
    cfg = TraceConfig(
        seed=42,
        duration=120.0,          # virtual seconds of traffic
        n_tenants=16,            # half SLO-class, half best-effort
        n_bursts=2,              # fleet-wide 4x burst windows
        churn_fraction=0.25,     # best-effort tenants depart + replace
        kills=((60.0, "dev2"),)  # dev2's host dies mid-trace
    )
    trace = generate_trace(cfg, dev=dev)
    print("== trace ==")
    print(f"  {trace.summary()}")
    slo = trace.tenants_of("slo")
    print(f"  example SLO tenant: {slo[0].name} arch={slo[0].arch} "
          f"tbt_base={slo[0].tbt_base * 1e3:.2f}ms "
          f"tbt_slo={slo[0].tbt_slo * 1e3:.2f}ms/token")

    sim = Simulator(trace, {f"dev{i}": dev for i in range(6)})
    report = sim.run()

    print("\n== serving report ==")
    req = report["requests"]
    print(f"  requests: {req['total']} total, {req['completed']} "
          f"completed, {req['canceled']} canceled (churned tenants)")
    for cls, att in report["slo"]["per_class"].items():
        tbt = report["tbt"][cls]
        print(f"  {cls:>11}: attainment {att['attainment']:.3f} "
              f"({att['met']}/{att['resolved']}), observed TBT "
              f"p50/p99 {tbt['observed_p50_ms']:.1f}/"
              f"{tbt['observed_p99_ms']:.1f} ms")
    g = report["goodput"]
    print(f"  goodput: {g['slo_met_tokens_per_s']:.0f} SLO-met tok/s "
          f"of {g['tokens_per_s']:.0f} tok/s")

    f = report["fleet"]
    print("\n== what the kill cost ==")
    print(f"  device states: {report['devices']['states']}")
    print(f"  {f['device_deaths']} death detected, {f['migrations']} "
          f"migrations, {f['evictions']} evictions, "
          f"{f['replans']} replans, {f['event_loop_errors']} errors")
    print(f"  mean colocation gain {report['devices']['mean_gain']:.2f}x")

    # the determinism contract: same seed, same report, bit for bit
    twin = Simulator(generate_trace(cfg, dev=dev),
                     {f"dev{i}": dev for i in range(6)}).run()
    print(f"\n  same seed -> identical report: {report == twin}")
    return report, twin


if __name__ == "__main__":
    main()
