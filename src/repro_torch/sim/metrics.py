"""Per-request / per-tenant serving metrics for the trace simulator.

The SLO-attainment and tail-latency vocabulary of "ML Inference
Scheduling with Predictable Latency" (PAPERS.md), applied to the
simulator's request records:

  * a request's **deadline** is ``arrival + slack + n_tokens * tbt_slo``
    — the TTFT+TBT decomposition: an additive first-token slack (absorbs
    scheduling/queueing delay up to the trace's ``queue_slack``) plus
    the tenant's per-token latency target (its interference SLO times a
    headroom margin) scaled by the request length;
  * **SLO attainment** is the fraction of a tenant class's *resolved*
    requests (completed, or still unfinished past their deadline) that
    met their deadline — canceled requests (tenant departed or was
    rejected at admission) and still-censored requests are excluded;
  * **TBT** (time between tokens) is reported two ways: *service* TBT
    (interference-inflated execution only — what `solve_scenarios`
    predicts) and *observed* TBT (end-to-end latency / tokens, queueing
    and outage included); p50/p99 over completed requests;
  * **goodput** counts only tokens of SLO-met requests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np


@dataclass
class RequestRecord:
    """One request's lifecycle inside the simulator."""
    tenant: str
    req_id: int
    arrival: float
    n_tokens: int
    priority: str
    tbt_slo: float
    slack: float = 0.0               # additive TTFT slack in the deadline
    remaining: float = 0.0           # tokens left (fluid)
    start: Optional[float] = None    # first service
    finish: Optional[float] = None
    service: float = 0.0             # seconds of (inflated) execution
    canceled: bool = False

    @property
    def deadline(self) -> float:
        return self.arrival + self.slack + self.n_tokens * self.tbt_slo

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def observed_tbt(self) -> Optional[float]:
        lat = self.latency
        return None if lat is None else lat / max(self.n_tokens, 1)

    @property
    def service_tbt(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.service / max(self.n_tokens, 1)

    def met_slo(self, now: float) -> Optional[bool]:
        """True/False once resolved; None while censored (unfinished and
        the deadline has not passed) or canceled."""
        if self.canceled:
            return None
        if self.finish is not None:
            return self.finish <= self.deadline
        return False if now > self.deadline else None


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def _tbt_stats(recs: List[RequestRecord]) -> Dict[str, float]:
    obs = [r.observed_tbt for r in recs if r.observed_tbt is not None]
    srv = [r.service_tbt for r in recs if r.service_tbt is not None]
    return {
        "observed_p50_ms": _pct(obs, 50) * 1e3,
        "observed_p99_ms": _pct(obs, 99) * 1e3,
        "service_p50_ms": _pct(srv, 50) * 1e3,
        "service_p99_ms": _pct(srv, 99) * 1e3,
    }


def _attainment(recs: List[RequestRecord], now: float) -> Dict[str, float]:
    met = missed = 0
    for r in recs:
        ok = r.met_slo(now)
        if ok is True:
            met += 1
        elif ok is False:
            missed += 1
    resolved = met + missed
    return {
        "resolved": resolved,
        "met": met,
        "missed": missed,
        "attainment": met / resolved if resolved else 1.0,
    }


def compute_report(trace, records: List[RequestRecord], fleet, now: float,
                   busy: Mapping[str, float],
                   resident_time: Mapping[str, float],
                   gain_samples: List[float]) -> Dict:
    """Fold the simulation into one JSON-ready report (everything a
    deterministic function of the trace + fleet replay, so two runs of
    the same seed produce identical reports)."""
    by_class: Dict[str, List[RequestRecord]] = {}
    by_tenant: Dict[str, List[RequestRecord]] = {}
    for r in records:
        by_class.setdefault(r.priority, []).append(r)
        by_tenant.setdefault(r.tenant, []).append(r)

    completed = [r for r in records if r.finish is not None]
    canceled = [r for r in records if r.canceled]
    good_tokens = sum(r.n_tokens for r in completed
                      if r.met_slo(now) is True)
    elapsed = max(now, 1e-9)

    per_tenant = {}
    for name, recs in sorted(by_tenant.items()):
        att = _attainment(recs, now)
        spec = trace.tenants.get(name)
        per_tenant[name] = {
            "priority": spec.priority if spec else "?",
            "arch": spec.arch if spec else "?",
            "requests": len(recs),
            "completed": sum(1 for r in recs if r.finish is not None),
            **att,
        }

    report = {
        "trace": trace.summary(),
        "requests": {
            "total": len(records),
            "completed": len(completed),
            "canceled": len(canceled),
            "unfinished": len(records) - len(completed) - len(canceled),
        },
        "slo": {
            "overall": _attainment(records, now),
            "per_class": {cls: _attainment(recs, now)
                          for cls, recs in sorted(by_class.items())},
        },
        "tbt": {cls: _tbt_stats(recs)
                for cls, recs in sorted(by_class.items())},
        "goodput": {
            "tokens_per_s": sum(r.n_tokens for r in completed) / elapsed,
            "slo_met_tokens_per_s": good_tokens / elapsed,
            "requests_per_s": len(completed) / elapsed,
        },
        "fleet": {
            "evictions": fleet.stats["evicted"],
            "migrations": fleet.stats["migrated"],
            "displaced": fleet.stats["displaced"],
            "replans": fleet.stats["replans"],
            # scoped-repair accounting (repair latencies are wall-clock
            # and deliberately NOT reported — touched counts are the
            # deterministic width metric)
            "scoped_repairs": fleet.stats.get("scoped_repairs", 0),
            "full_replays": fleet.stats.get("full_replays", 0),
            "repair_fallbacks": fleet.stats.get("repair_fallbacks", 0),
            "repair_touched_p95": _pct(
                [float(r.devices_touched)
                 for r in getattr(fleet, "repairs", [])], 95),
            "device_deaths": fleet.stats["device_deaths"],
            "event_loop_errors": fleet.stats["errors"],
            "rejected_arrivals": fleet.stats["rejected"],
            "scenarios_solved": fleet.stats["scenarios_solved"],
            "decisions": len(fleet.decisions),
        },
        "devices": {
            "utilization": {
                did: (busy.get(did, 0.0)
                      / max(resident_time.get(did, 0.0), 1e-9))
                for did in sorted(fleet.devices)},
            "mean_gain": (float(np.mean(gain_samples))
                          if gain_samples else 0.0),
            "states": {did: d.state
                       for did, d in sorted(fleet.devices.items())},
        },
        "per_tenant": per_tenant,
        "calib": {
            "observations": fleet.stats.get("calib_observations", 0),
            "flags": fleet.stats.get("calib_flags", 0),
            "refits": fleet.stats.get("calib_refits", 0),
            "flagged_tenants": sorted(set(
                getattr(getattr(fleet, "calib", None), "flag_log",
                        ()) or ())),
        },
    }
    return report
