"""Interference-profile driver: build per-phase resource profiles of an
architecture from its dry-run records and print its sensitivity
fingerprint + best colocation partners (the paper's methodology applied
to the framework's own workloads); the twin of
``src/repro/launch/profile.py``.

``main`` prices on the torch solver on the card by default: every price is
a torch solve there, with one ``cache_share`` launch; ``--backend numpy``
prices on the NumPy solver on the host. The reference prices on its
``TPU_V5E`` model; this package prices on its ``H100`` model unless
``--device`` names another ``DeviceModel`` of ``core/resources.py``
(ROADMAP C18). The records are this package's dry run
(``launch/dryrun.py``): one chip of the production 16x16 mesh (files tagged
``pod1``) by default, as the reference reads its own, or ``--mesh pod2``
(2x16x16) or ``dev1`` (one device).

  PYTHONPATH=src python -m repro_torch.launch.profile --arch llama3-405b [--plan] \\
      [--backend numpy] [--mesh dev1]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.core import DEVICES, H100, ColocationScheduler, sensitivity_batch
from repro_torch.core.backend import SOLVER_BACKENDS, solver_backend
from repro_torch.core.profile import WorkloadProfile, from_dryrun_json
from repro_torch.launch.dryrun import RESULTS


def load_profiles(arch: str = None, mesh_tag: str = "pod1", results: Path = None):
    profs = []
    for f in sorted((results or RESULTS).glob(f"*__{mesh_tag}.json")):
        rec = json.loads(f.read_text())
        if rec.get("skipped"):
            continue
        if arch and rec["arch"] != arch:
            continue
        profs.append(from_dryrun_json(rec))
    return profs


def fingerprints(profs, dev=H100) -> list:
    """(name, bottleneck, {axis: score}, ranked axes) for each phase, all
    in one batched estimator solve."""
    return [(p.name, p.bottleneck(dev), dict(rep.scores), rep.ranked())
            for p, rep in zip(profs, sensitivity_batch(profs, dev))]


def plan(profs, dev=H100, group_size: int = 2, search=None):
    """The colocation plan of the phases at an SLO of 1.3x (``search``: a
    ``FractionSearchConfig``, None for the backend's default)."""
    sched = ColocationScheduler(dev, max_group_size=group_size, fraction_search=search)
    for p in profs:
        sched.submit(WorkloadProfile(p.name, (p,), slo_slowdown=1.3))
    return sched.plan()


def main(argv=None, search=None, device="cuda"):
    """The CLI; returns (fingerprints, plan or None) as priced (``search``:
    the plan's ``FractionSearchConfig``, None for the backend's default;
    ``device``: where the torch solver runs)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--plan", action="store_true",
                    help="run the colocation scheduler over all phases")
    ap.add_argument("--group-size", type=int, default=2,
                    help="max workloads per device (k-way placements)")
    ap.add_argument("--device", default=H100.name, choices=sorted(DEVICES),
                    help="the DeviceModel that prices the phases")
    ap.add_argument("--backend", default="torch", choices=SOLVER_BACKENDS,
                    help="the solver: torch on the card (default) or numpy on the host")
    ap.add_argument("--results", default=None, help=f"dry-run records (default {RESULTS})")
    ap.add_argument("--mesh", default="pod1", choices=("pod1", "pod2", "dev1"),
                    help="the records' mesh: one chip of 16x16 (default), of 2x16x16, "
                         "or one device")
    args = ap.parse_args(argv)
    dev = DEVICES[args.device]

    profs = load_profiles(args.arch, args.mesh,
                          results=Path(args.results) if args.results else None)
    if not profs:
        print("no dry-run artifacts found; run repro_torch.launch.dryrun first")
        return None, None
    with solver_backend(args.backend, device=device):
        fps = fingerprints(profs, dev)
        p = plan(profs, dev, args.group_size, search) if args.plan else None
    print(f"{'phase':44s} {'bottleneck':11s} sensitivity fingerprint "
          f"(slowdown @ 90% stressor)")
    for name, neck, scores, ranked in fps:
        fp = " ".join(f"{a}:{scores[a]:.2f}" for a in ranked[:4])
        print(f"{name:44s} {neck:11s} {fp}")

    if p is not None:
        print(f"\ncolocation plan (SLO 1.3x, k<={args.group_size}):")
        for pl in p.placements:
            print("  ", pl)
        print("   solo:", p.solo)
    return fps, p

if __name__ == "__main__":
    main()
