"""Trace-driven multi-tenant serving simulation (`repro_torch.sim`).

The closed loop the estimator/scheduler/fleet stack is ultimately judged
by: deterministic diurnal/bursty request traces (`traces`), a
virtual-clock simulator that feeds them through ``FleetScheduler`` and
serves requests at interference-inflated rates (`simulator`), and
per-request / per-tenant SLO-attainment and tail-latency metrics
(`metrics`).  The reference's ``benchmarks/bench_trace.py`` gates the JAX
package's twin; ``chip_smoke.py``'s ``fleet`` phase restates its gates for
this one on the card.
"""
from repro_torch.sim.metrics import RequestRecord, compute_report  # noqa: F401
from repro_torch.sim.simulator import SimConfig, Simulator  # noqa: F401
from repro_torch.sim.traces import (Trace, TraceConfig, TenantSpec,  # noqa: F401
                                    generate_trace, request, tenant_profile)
