"""Quickstart: the paper's methodology in 80 lines; the twin of
``examples/quickstart.py``.

1. Build resource profiles for two workload phases (an MXU-bound prefill
   and an HBM-bound decode) on the device model (``--device-model``).
2. Quantify each phase's interference sensitivity (the paper's §4 sweep).
3. Run the ONLINE colocation scheduler: workloads arrive and leave, and
   `plan()` incrementally re-places them (k-way groups, SLO-guarded).
4. Rescue an SLO-violating decode fleet with the k-way slot-fraction
   search (paper §5.3 green contexts): partitioned groups of three share
   each device, at fractions the search finds.

Every price is one solve on ``--backend``: on the card, a torch solve with
one ``cache_share`` launch.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from repro_torch.core import (ColocationScheduler, KernelProfile, Scenario,
                              WorkloadProfile, partition_curve,
                              sensitivity_batch, solve_scenarios)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.examples import arguments, pricing


def phase(dev, name, **utils):
    demand = {r: 0.0 for r in RESOURCE_AXES}
    for axis, frac in utils.items():
        demand[axis] = frac * dev.capacity(axis)
    return KernelProfile(name, demand=demand, duration=1.0)


def main(argv=None):
    args = arguments(__doc__).parse_args(argv)
    with pricing(args) as dev:
        return walkthrough(dev)


def walkthrough(dev):
    """Returns the online scheduler's two plans and the k-way search's."""
    prefill = phase(dev, "prefill_32k", mxu=0.72, hbm=0.25, issue=0.30)
    decode = phase(dev, "decode", mxu=0.04, hbm=0.86, issue=0.12)
    train = phase(dev, "train_step", mxu=0.65, hbm=0.45, issue=0.35, ici=0.40)

    print("== sensitivity fingerprints (slowdown under a 90% stressor) ==")
    # all three fingerprints (3 phases x 7 axes x 5 lambdas) = one solve
    for p, rep in zip((prefill, decode, train),
                      sensitivity_batch((prefill, decode, train), dev)):
        tops = ", ".join(f"{a}={rep.scores[a]:.2f}x" for a in rep.ranked()[:3])
        print(f"  {p.name:12s} dominant axis: {rep.dominant():6s} ({tops})")

    print("\n== pairwise colocation predictions (one Scenario batch) ==")
    pairs = ((prefill, decode), (prefill, train), (decode, train))
    br = solve_scenarios([Scenario((a, b)) for a, b in pairs], dev)
    for s, (a, b) in enumerate(pairs):
        print(f"  {a.name:12s} + {b.name:12s} -> "
              f"{a.name}: {br.slowdowns[s, 0]:.2f}x, "
              f"{b.name}: {br.slowdowns[s, 1]:.2f}x")

    print("\n== online scheduler (SLO: 1.3x, up to 3-way groups) ==")
    sched = ColocationScheduler(dev, max_group_size=3)
    for p in (prefill, decode, train):
        sched.submit(WorkloadProfile(p.name, (p,), slo_slowdown=1.3))
    plan = sched.plan()
    for pl in plan.placements:
        print("  colocate:", pl)
    print("  run solo:", plan.solo)

    plans = [plan]
    sched.remove("train_step")          # departure: zero estimator work
    sched.submit(WorkloadProfile(       # arrival: prices only its row
        "decode_b", (phase(dev, "decode_b", mxu=0.03, hbm=0.30, issue=0.08),),
        slo_slowdown=1.3))
    plan = sched.plan()
    plans.append(plan)
    print("  after train_step leaves and decode_b arrives:")
    for pl in plan.placements:
        print("    colocate:", pl)
    print("    run solo:", plan.solo)
    print(f"  estimator scenarios solved so far: "
          f"{sched.stats['scenarios_solved']}")

    print("\n== k-way slot-fraction search (green contexts, §5.3) ==")
    # a decode fleet too bandwidth-hungry to share a device at full
    # rate, plus short best-effort compute bursts riding along
    def workload(name, slo, dur, **utils):
        d = {r: 0.0 for r in RESOURCE_AXES}
        for axis, frac in utils.items():
            d[axis] = frac * dev.capacity(axis)
        return WorkloadProfile(name, (KernelProfile(
            name + "#step", demand=d, duration=dur),), slo_slowdown=slo)

    fleet = [workload(f"decode_{i}", 1.15, 1.0, mxu=0.4, vpu=0.1,
                      issue=0.1, smem=0.05, hbm=0.6, l2=0.6)
             for i in range(4)]
    fleet += [workload(f"distill_{i}", 12.0, 0.08, vpu=0.072, issue=0.004,
                       mxu=0.004, hbm=0.0016, l2=0.0016) for i in range(2)]
    sched = ColocationScheduler(dev, max_group_size=3)
    for w in fleet:
        sched.submit(w)
    plan = sched.plan()
    plans.append(plan)
    for pl in plan.placements:
        fr = {n: round(f, 3) for n, f in pl.slot_fraction.items()}
        print(f"  colocate {' + '.join(pl.workloads)}  "
              f"slot fractions {fr or 'full sharing'}  "
              f"gain {pl.throughput_gain:.2f}")
    print("  run solo:", plan.solo or "nothing")

    # the §5.3 diagnostic: how each member's slowdown responds as one
    # member's slot share sweeps (the ray the legacy fixed grid explored)
    curves = partition_curve(fleet[:2] + fleet[4:5], dev, member=2,
                             fractions=(0.125, 0.25, 0.5))
    print("  partition response (distill_0 share 12.5% -> 50%):")
    for name, slows in curves.items():
        print(f"    {name:10s}", " ".join(f"{s:6.2f}x" for s in slows))
    return plans


if __name__ == "__main__":
    main()
