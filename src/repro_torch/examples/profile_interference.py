"""Profile this framework's own workloads with the paper's methodology;
the twin of ``examples/profile_interference.py``.

Reads the dry-run records (run ``repro_torch.launch.dryrun`` first: its
one-device records, ``results/dryrun_torch/*__dev1.json``), builds
per-phase resource vectors, prints sensitivity fingerprints, and plans
cross-architecture colocations on one device of the model
``--device-model``, every price one solve on ``--backend``.

Run:  PYTHONPATH=src python -m repro_torch.examples.profile_interference [--device cpu]
"""
from repro_torch.examples import arguments
from repro_torch.launch import profile
from repro_torch.models.model import resolve_device


def main(argv=None):
    """Returns ``launch.profile.main``'s (fingerprints, plan), (None, None)
    without records."""
    args = arguments(__doc__).parse_args(argv)
    resolve_device(args.device)
    return profile.main(["--plan", "--device", args.device_model, "--backend", args.backend,
                         "--mesh", "dev1"], device=args.device)


if __name__ == "__main__":
    main()
