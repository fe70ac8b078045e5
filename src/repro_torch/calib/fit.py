"""Profile fitter — invert the water-filling estimator over measurements.

The estimator already answers "given profiles, what slowdowns?"; this
module answers the calibration question "given observed slowdowns, what
profiles?" by batched coordinate descent *through* the estimator —
``solve_scenarios`` (on the active solver backend) is the forward model
that prices the candidate grids.

Parameterization per victim kernel (9 scalars):

  * ``u[axis] ∈ [0, 1]`` for the 7 resource axes — fraction of the axis
    the kernel occupies while running.  ``demand[axis] = u·C_axis·t_iso``
    with the measured isolated time as duration, so the fitted profile
    reproduces t_iso exactly and `utilization()` returns ``u``.
  * ``cache_working_set ≥ 0`` and ``cache_hit_fraction ∈ [0, 1]`` — the
    Fig. 3 cache cliff knobs, identified by the polluter probes in the
    sweep.  The hbm *raw* demand is back-solved through the cache
    discount so ``u[hbm]`` stays the observed isolated utilization.

Descent: round 1 sweeps each parameter over a global grid (full [0,1]
coverage — no reliance on the knee init), later rounds shrink to local
grids; every candidate×observation product is priced in ONE batched
solve, so a full fit is a handful of few-hundred-scenario solves.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calib.measure import (Colocation, MeasurementSet,
                                 colocation_scenario)
from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.profile import KernelProfile
from repro_torch.core.resources import RESOURCE_AXES, DeviceModel

_U_KEYS = tuple(f"u:{axis}" for axis in RESOURCE_AXES)
_WS_KEY = "ws"
_HIT_KEY = "hit"
PARAM_KEYS: Tuple[str, ...] = _U_KEYS + (_WS_KEY, _HIT_KEY)


@dataclass(frozen=True)
class FitConfig:
    rounds: int = 3
    grid: int = 11                    # candidates per parameter sweep
    local_spans: Tuple[float, ...] = (0.2, 0.07)   # rounds 2, 3, ... (u/hit)
    # round-1 refinement of each u on the clean probes, BEFORE the cache
    # sweep: the clean-subset loss is direct in u (reverse probes read it
    # off as λ/(1−u)), and a u pinned to grid resolution there would
    # otherwise be "compensated" by the cache knobs into a joint local
    # minimum no single-coordinate move escapes
    clean_refine_spans: Tuple[float, ...] = (0.05, 0.015)
    # cache working-set candidates (fractions of device cache capacity).
    # Under the thrash-cliff cache model ws is only identifiable to an
    # interval between polluter-probe thresholds (cache − probe_ws), so
    # cover the midpoints of the intervals the default probe working
    # sets (CACHE_WS_FRACTIONS) carve out
    ws_fractions: Tuple[float, ...] = (0.1, 0.25, 0.375, 0.5, 0.625,
                                       0.75, 0.875, 1.0, 1.5, 2.0, 4.0)
    min_improvement: float = 1e-12    # keep incumbent unless strictly better
    fit_cache: bool = True            # sweep ws/hit (off for cache-free fits)


def params_to_profile(name: str, params: Mapping[str, float],
                      t_iso: float, dev: DeviceModel) -> KernelProfile:
    """Materialize a candidate parameter vector as a KernelProfile whose
    isolated behaviour matches (t_iso, u) by construction."""
    ws = max(float(params.get(_WS_KEY, 0.0)), 0.0)
    hit = min(max(float(params.get(_HIT_KEY, 0.0)), 0.0), 1.0)
    if ws <= 0.0:
        hit = 0.0
    demand: Dict[str, float] = {}
    for axis in RESOURCE_AXES:
        u = min(max(float(params.get(f"u:{axis}", 0.0)), 0.0), 1.0)
        demand[axis] = u * dev.capacity(axis) * t_iso
    if hit > 0.0:
        # invert the isolated cache discount: effective_demand multiplies
        # raw hbm by (1 - hit·resident) at cache_share=1
        resident = min(1.0, dev.cache_capacity / max(ws, 1.0))
        demand["hbm"] /= max(1.0 - hit * resident, 1e-6)
    return KernelProfile(name, demand=demand, duration=t_iso,
                         cache_working_set=ws,
                         cache_hit_fraction=hit if ws > 0 else 0.0)


def profile_to_params(k: KernelProfile, dev: DeviceModel) -> Dict[str, float]:
    """The inverse map (for tests / warm starts): observed isolated
    utilization + cache knobs."""
    u = k.utilization(dev)
    params = {f"u:{axis}": u[axis] for axis in RESOURCE_AXES}
    params[_WS_KEY] = k.cache_working_set
    params[_HIT_KEY] = k.cache_hit_fraction
    return params


def perturb_profile(k: KernelProfile, rng: np.random.Generator,
                    scale: float = 0.3,
                    dev: Optional[DeviceModel] = None) -> KernelProfile:
    """A hidden ground truth for round-trip tests: multiplicatively
    perturb every nonzero demand axis (and duration / cache knobs) by
    ``exp(scale·N(0,1))`` from the caller's seeded Generator."""
    demand = {r: (d * float(np.exp(scale * rng.standard_normal()))
                  if d > 0 else d)
              for r, d in k.demand.items()}
    duration = k.duration
    if duration:
        duration = duration * float(np.exp(scale * rng.standard_normal()))
    ws = k.cache_working_set
    hit = k.cache_hit_fraction
    if ws > 0:
        ws = ws * float(np.exp(scale * rng.standard_normal()))
        hit = float(np.clip(hit + 0.25 * scale * rng.standard_normal(),
                            0.05, 0.95))
    out = replace(k, demand=demand, duration=duration,
                  cache_working_set=ws, cache_hit_fraction=hit)
    if dev is not None:
        # keep the truth physical: no axis may exceed its capacity
        u = out.utilization(dev)
        worst = max(u.values())
        if worst > 1.0:
            out = replace(out, demand={r: d / worst
                                       for r, d in out.demand.items()})
    return out


# ------------------------------------------------------------------ #
#  Loss evaluation: all candidates × all observations, one solve       #
# ------------------------------------------------------------------ #
def predict_slowdowns(profiles: Mapping[str, KernelProfile],
                      colocations: Sequence[Colocation],
                      dev: DeviceModel) -> np.ndarray:
    """Estimator predictions for a measurement plan — the forward model
    the fitter minimizes against and the validator scores with."""
    scenarios = [colocation_scenario(c, profiles[c.victim], dev, profiles)
                 for c in colocations]
    if not scenarios:
        return np.zeros(0, np.float64)
    return np.asarray(
        solve_scenarios(scenarios, dev).slowdowns[:, 0], np.float64)


def _candidate_losses(candidates: Sequence[KernelProfile],
                      colocations: Sequence[Colocation],
                      observed: np.ndarray, dev: DeviceModel,
                      fitted: Mapping[str, KernelProfile]) -> np.ndarray:
    """Mean squared log-relative error per candidate profile; one batched
    solve over len(candidates)×len(colocations) scenarios."""
    scenarios = []
    for cand in candidates:
        for c in colocations:
            scenarios.append(colocation_scenario(c, cand, dev, fitted))
    pred = np.asarray(solve_scenarios(scenarios, dev).slowdowns[:, 0],
                      np.float64)
    pred = pred.reshape(len(candidates), len(colocations))
    err = np.log(np.maximum(pred, 1e-9)) - np.log(np.maximum(observed, 1e-9))
    return np.mean(err * err, axis=1)


def _grids(key: str, current: float, rnd: int, cfg: FitConfig,
           dev: DeviceModel) -> np.ndarray:
    if key == _WS_KEY:
        pts = [0.0] + [f * dev.cache_capacity for f in cfg.ws_fractions]
        if rnd > 0 and current > 0:
            pts += [current * 0.7, current, current * 1.4]
        return np.unique(np.asarray(pts, np.float64))
    if rnd == 0:
        return np.linspace(0.0, 1.0, cfg.grid)
    span = cfg.local_spans[min(rnd - 1, len(cfg.local_spans) - 1)]
    return np.unique(np.clip(
        current + span * np.linspace(-1.0, 1.0, cfg.grid), 0.0, 1.0))


def fit_kernel(name: str, colocations: Sequence[Colocation],
               observed: np.ndarray, t_iso: float, dev: DeviceModel,
               cfg: FitConfig = FitConfig(),
               fitted: Optional[Mapping[str, KernelProfile]] = None,
               init: Optional[Mapping[str, float]] = None) -> KernelProfile:
    """Coordinate descent for one victim kernel."""
    fitted = dict(fitted or {})
    params: Dict[str, float] = {k: 0.0 for k in PARAM_KEYS}
    if init:
        params.update({k: float(v) for k, v in init.items()
                       if k in params})
    colocations = list(colocations)
    clean = [i for i, c in enumerate(colocations) if not c.is_cache_probe]

    def sweep(trials: Sequence[Dict[str, float]],
              subset: Optional[Sequence[int]] = None) -> None:
        nonlocal best
        cols = colocations if subset is None \
            else [colocations[i] for i in subset]
        obs = observed if subset is None else observed[list(subset)]
        cands = []
        for t in trials:
            merged = dict(params)
            merged.update(t)
            cands.append(params_to_profile(name, merged, t_iso, dev))
        losses = _candidate_losses(cands, cols, obs, dev, fitted)
        i = int(np.argmin(losses))
        if subset is not None or losses[i] < best - cfg.min_improvement:
            params.update(trials[i])
        if subset is None and losses[i] < best - cfg.min_improvement:
            best = float(losses[i])

    best = _candidate_losses(
        [params_to_profile(name, params, t_iso, dev)],
        colocations, observed, dev, fitted)[0]
    for rnd in range(cfg.rounds):
        for key in _U_KEYS:
            grid = _grids(key, params[key], rnd, cfg, dev)
            # round 1 settles the utilization axes on the clean probes
            # alone: the cache probes otherwise drag u:hbm toward the
            # thrashed demand and strand (ws, hit) in a local minimum
            sweep([{key: float(v)} for v in grid],
                  subset=clean if rnd == 0 else None)
            if rnd == 0:
                for span in cfg.clean_refine_spans:
                    g = np.unique(np.clip(
                        params[key]
                        + span * np.linspace(-1.0, 1.0, cfg.grid),
                        0.0, 1.0))
                    sweep([{key: float(v)} for v in g], subset=clean)
        if rnd == 0:
            best = _candidate_losses(
                [params_to_profile(name, params, t_iso, dev)],
                colocations, observed, dev, fitted)[0]
        if cfg.fit_cache:
            # (ws, hit) move the loss only jointly — a working set with
            # no hits is inert, a hit fraction with no working set is
            # ignored — so sweep the 2-D grid, then let hbm re-settle
            # (the cache discount and u:hbm trade off directly)
            ws_grid = _grids(_WS_KEY, params[_WS_KEY], rnd, cfg, dev)
            hit_grid = _grids(_HIT_KEY, params[_HIT_KEY], rnd, cfg, dev)
            sweep([{_WS_KEY: float(w), _HIT_KEY: float(h)}
                   for w in ws_grid
                   for h in (hit_grid if w > 0 else [0.0])])
            grid = _grids("u:hbm", params["u:hbm"], rnd, cfg, dev)
            sweep([{"u:hbm": float(v)} for v in grid])
    return params_to_profile(name, params, t_iso, dev)


def fit_profiles(ms: MeasurementSet, cfg: FitConfig = FitConfig(),
                 inits: Optional[Mapping[str, Mapping[str, float]]] = None
                 ) -> Dict[str, KernelProfile]:
    """Fit every victim in a MeasurementSet independently (the sweep's
    single-stressor probes carry no cross-victim coupling; cohort mixes
    are the *validator's* held-out material)."""
    out: Dict[str, KernelProfile] = {}
    for v in ms.victims:
        cols, obs = ms.of_victim(v)
        out[v] = fit_kernel(v, cols, obs, ms.isolated_times[v], ms.device,
                            cfg, fitted=out,
                            init=(inits or {}).get(v))
    return out


@dataclass
class FitReport:
    """JSON-able summary of a fit."""
    device: str
    victims: List[str]
    n_observations: int
    train_mse_log: float

    def to_json(self) -> Dict[str, object]:
        return {"device": self.device, "victims": self.victims,
                "n_observations": self.n_observations,
                "train_mse_log": self.train_mse_log}


def fit_report(ms: MeasurementSet,
               fitted: Mapping[str, KernelProfile]) -> FitReport:
    pred = predict_slowdowns(fitted, ms.colocations, ms.device)
    err = np.log(np.maximum(pred, 1e-9)) \
        - np.log(np.maximum(ms.slowdowns, 1e-9))
    return FitReport(ms.device.name, list(ms.victims), len(ms),
                     float(np.mean(err * err)))
