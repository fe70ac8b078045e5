"""Fleet failover walkthrough: admission -> eviction -> device kill ->
recovery, on a deterministic virtual clock; the twin of
``examples/fleet_failover.py``.

Drives a 3-device `FleetScheduler` through a scripted fault trace with
`repro_torch.ft.inject`: SLO decode workloads and a best-effort burst
arrive, one device stops heartbeating mid-run, the fleet drains it,
re-places every SLO workload on the survivors (evicting best-effort work,
each eviction an explicit `AdmissionDecision`), and — the recovery
invariant — ends in exactly the state a cold fleet over the survivors
would compute. Every price is one solve on ``--backend``.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_failover [--device cpu]
"""
from repro_torch.core import (BEST_EFFORT, SLO, FleetConfig, FleetScheduler,
                              KernelProfile, WorkloadProfile)
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.examples import arguments, pricing
from repro_torch.ft.inject import FakeClock, FaultInjector, arrive, kill, storm


def decode_heavy_mix(dev, n_decode=4, n_aux=2, core=None):
    """The reference's ``benchmarks/bench_planner.py:decode_heavy_mix``:
    bandwidth-bound decodes (hbm / l2 0.6) with light compute and a tight
    1.15x SLO, which only a slot partition rescues in pairs, then short
    best-effort VPU bursts that pack beside them in k-way groups. Over this
    package's profile classes, or those of the module ``core`` (a test
    hands it the reference's ``repro.core``)."""
    kp = core.KernelProfile if core else KernelProfile
    wp = core.WorkloadProfile if core else WorkloadProfile

    def prof(name, slo, dur, **u):
        d = {r: u.get(r, 0.0) * dev.capacity(r) for r in RESOURCE_AXES}
        return wp(name, (kp(f"{name}#step", demand=d, duration=dur),),
                  slo_slowdown=slo)

    decodes = [prof(f"decode{i}", 1.15, 1.0, mxu=0.4, vpu=0.1, issue=0.1,
                    smem=0.05, hbm=0.6, l2=0.6) for i in range(n_decode)]
    aux = [prof(f"aux{i}", 12.0, 0.08, vpu=0.072, issue=0.004, mxu=0.004,
                hbm=0.0016, l2=0.0016) for i in range(n_aux)]
    return decodes + aux


def main(argv=None):
    args = arguments(__doc__).parse_args(argv)
    with pricing(args) as dev:
        return walkthrough(dev)


def walkthrough(dev):
    """Returns the fleet after the trace, and the cold fleet over its
    survivors."""
    works = decode_heavy_mix(dev, n_decode=3, n_aux=4)
    decodes, auxes = works[:3], works[3:]

    clock = FakeClock()
    fleet = FleetScheduler(
        {f"dev{i}": dev for i in range(3)},
        FleetConfig(max_group_size=3, heartbeat_timeout=3.0,
                    backoff_base=1.0, max_retries=3),
        clock=clock)

    trace = (
        # three latency-critical decode instances trickle in...
        [arrive(float(i), d, priority=SLO) for i, d in enumerate(decodes)]
        # ...then a best-effort burst lands on one tick
        + storm(3.0, auxes, priority=BEST_EFFORT)
        # ...and dev1's host dies (it simply stops heartbeating)
        + [kill(6.0, "dev1")]
    )
    FaultInjector(fleet, clock).run(trace, until=25.0)

    print("== decision log ==")
    for d in fleet.decisions:
        print(f"  {d}")

    plan = fleet.plan()
    print("\n== post-recovery fleet ==")
    print(f"  device states: {plan.device_states}")
    for did, p in sorted(plan.placements.items()):
        print(f"  {did}: {p}")
    if plan.queued or plan.degraded:
        print(f"  waiting: queued={plan.queued} degraded={plan.degraded}")
    slo_names = [d.name for d in decodes]
    print(f"  SLO re-placement rate: {plan.placement_rate(slo_names):.0%}")
    print(f"  evictions recorded: {fleet.stats['evicted']}, "
          f"migrations: {fleet.stats['migrated']}, "
          f"event-loop errors: {fleet.stats['errors']}")

    # the recovery invariant: online state == cold plan over survivors
    cold = FleetScheduler(
        {did: d.model for did, d in fleet.devices.items()
         if d.state != "dead"},
        fleet.cfg)
    for prof, prio in fleet.workloads:
        cold.submit(prof, priority=prio)
    same = fleet.plan().placed == cold.plan().placed
    print(f"  online plan == cold plan over survivors: {same}")
    return fleet, cold


if __name__ == "__main__":
    main()
