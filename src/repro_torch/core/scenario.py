"""Scenario — the one colocation-query currency of the estimator stack.

Every consumer of the interference estimator asks the same question:
"how much do these VICTIM kernels slow down when colocated with this
BACKGROUND, under these slot fractions, on this device?"  Before this
module each consumer spelled the question differently — the planner
built raw (row, row) index arrays, sensitivity built [[ki, si]] member
lists, the serve engine built its own ProfileMatrix and never asked the
solver at all.  ``Scenario`` is the shared spelling; ``compile_scenarios``
lowers a batch of them to the dense ProfileMatrix + member-index form the
vectorized solver consumes (`repro_torch.core.estimator.solve_scenarios`).

Conventions
  * members are ordered victims-first: row ``s`` of the solved batch has
    the victim slowdowns in ``slowdowns[s, :n_victims[s]]``;
  * ``slot_fraction`` is keyed by KERNEL NAME (the ``estimate()``
    contract): a member picks up a fraction iff its name is a key;
  * kernels are deduplicated by object identity, so a background kernel
    shared across thousands of scenarios occupies one matrix row.

Hot paths that already hold dense index arrays (the scheduler's pairwise
row pricing) skip the per-scenario Python objects and hand `solve_batch`
the arrays directly — Scenario is the currency, not a toll booth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.profile import KernelProfile, ProfileMatrix, WorkloadProfile
from repro_torch.core.resources import DeviceModel


@dataclass(frozen=True)
class Scenario:
    """One colocation query: victims + background + fractions (+ device).

    ``victims`` are the kernels whose slowdowns the caller reads back;
    ``background`` kernels contend but their slowdowns are incidental.
    The split is bookkeeping for the caller — the fluid solver treats
    all members identically.
    """
    victims: Tuple[KernelProfile, ...]
    background: Tuple[KernelProfile, ...] = ()
    slot_fraction: Optional[Mapping[str, float]] = None
    device: Optional[DeviceModel] = None

    @property
    def members(self) -> Tuple[KernelProfile, ...]:
        return tuple(self.victims) + tuple(self.background)

    @property
    def n_victims(self) -> int:
        return len(self.victims)

    def fraction_of(self, kernel: KernelProfile) -> float:
        if not self.slot_fraction:
            return 1.0
        return float(self.slot_fraction.get(kernel.name, 1.0))


@dataclass
class CompiledScenarios:
    """Scenario batch lowered to solver inputs (see estimator.solve_batch).

    ``members`` is always a dense (S, K_max) int64 ndarray.  Uniform-width
    batches (the common fan-out shape) carry ``mask=None``; ragged batches
    are padded to the widest scenario with ``mask`` marking real members,
    so mixed k-way batches still hit one dense solve.
    """
    pm: ProfileMatrix
    members: Union[np.ndarray, List[List[int]]]
    fractions: Optional[Union[np.ndarray, List[List[float]]]]
    n_victims: np.ndarray                 # (S,)
    mask: Optional[np.ndarray] = None     # (S, K_max) bool, None if uniform

    def __len__(self) -> int:
        return len(self.n_victims)


def compile_scenarios(scenarios: Sequence[Scenario]) -> CompiledScenarios:
    """Lower Scenario objects to one ProfileMatrix + member index lists,
    deduplicating kernels by identity across the whole batch."""
    row_of: Dict[int, int] = {}
    profiles: List[KernelProfile] = []

    def row(k: KernelProfile) -> int:
        r = row_of.get(id(k))
        if r is None:
            r = row_of[id(k)] = len(profiles)
            profiles.append(k)
        return r

    members: List[List[int]] = []
    fractions: List[List[float]] = []
    n_victims = np.empty(len(scenarios), np.int64)
    any_fraction = False
    for s, sc in enumerate(scenarios):
        ms = sc.members
        members.append([row(k) for k in ms])
        fractions.append([sc.fraction_of(k) for k in ms])
        any_fraction = any_fraction or bool(sc.slot_fraction)
        n_victims[s] = sc.n_victims

    pm = ProfileMatrix.from_profiles(profiles)
    widths = {len(m) for m in members}
    if len(widths) == 1 and widths != {0}:
        dense = np.asarray(members, np.int64)
        frac = np.asarray(fractions, np.float64) if any_fraction else None
        return CompiledScenarios(pm, dense, frac, n_victims)
    # Ragged (or all-empty) batch: pad to the widest scenario and carry a
    # member mask so the solver still sees ONE dense batch.  Padded slots
    # index row 0 with fraction 1.0 but are masked out of every reduction.
    S = len(members)
    K = max((len(m) for m in members), default=0)
    idx = np.zeros((S, K), np.int64)
    mask = np.zeros((S, K), bool)
    frac = np.ones((S, K), np.float64)
    for s, m in enumerate(members):
        idx[s, :len(m)] = m
        mask[s, :len(m)] = True
        frac[s, :len(m)] = fractions[s]
    return CompiledScenarios(pm, idx, frac if any_fraction else None,
                             n_victims, mask)


def group_victim_scenarios(members: Sequence[WorkloadProfile],
                           reps: Mapping[str, KernelProfile],
                           slot_fraction: Optional[Mapping[str, float]] = None,
                           device: Optional[DeviceModel] = None
                           ) -> List[Scenario]:
    """THE group-pricing probe set, shared by ``evaluate_group``, the
    scheduler's batched group pricing, and the k-way fraction search:
    one Scenario per member kernel — victim = that kernel, background =
    every OTHER member's representative kernel (``reps``, keyed by
    member name).

    Row order of the solved batch is members in the given order, each
    member's kernels in profile order (fold back per workload with
    ``repro_torch.core.fracsearch.member_slowdowns``).  Slot fractions follow
    the estimator contract — they bind by KERNEL name, so a fraction
    keyed by a workload's name restricts its representative (background)
    kernel everywhere, and its victim kernels only when they share the
    workload's name.
    """
    out: List[Scenario] = []
    for m in members:
        bg = tuple(reps[o.name] for o in members if o is not m)
        for k in m.kernels:
            out.append(Scenario((k,), bg, slot_fraction, device))
    return out


def scenario_device(scenarios: Sequence[Scenario],
                    dev: Optional[DeviceModel] = None) -> DeviceModel:
    """Resolve the one device a scenario batch runs on: an explicit `dev`
    wins; otherwise every scenario must name the same device."""
    if dev is not None:
        return dev
    devs = {sc.device for sc in scenarios if sc.device is not None}
    if len(devs) != 1:
        raise ValueError(
            "scenario batch needs one device: pass dev= or set the same "
            f"Scenario.device on every scenario (got {len(devs)})")
    return next(iter(devs))
