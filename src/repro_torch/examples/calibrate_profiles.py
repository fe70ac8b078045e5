"""Profile-calibration walkthrough: recover what the hardware actually
does from colocated stressor measurements alone; the twin of
``examples/calibrate_profiles.py``.

The setup mirrors the production problem `repro_torch.calib` exists for.
We *believe* an analytic interference profile for each serving tenant
(derived from its registry model config, exactly like the trace
generator builds them). The hardware *actually* runs a perturbed
version of it — here, a hidden ground truth the synthetic backend
serves measurements from; on the card, the same sweep times the
stressor kernels' colocations (``TorchBackend``, ``launch/gpu_native``).
The pipeline:

  1. sweep — colocate each tenant's kernel with calibrated single-axis
     stressors (plus multi-stressor, reverse, and cache-polluter
     probes) and record observed slowdowns;
  2. fit — invert the water-filling estimator over those observations
     (batched coordinate descent; the estimator is the forward model,
     every batch one solve on ``--backend``);
  3. validate — score believed-vs-fitted predictions on held-out k-way
     mixes the fitter never saw.

The point of the printout: the STALE analytic profiles mispredict
colocation slowdowns by tens of percent, the FITTED ones land within a
few percent of the hidden truth — per-axis demands, working set, and
hit fraction included.

Run:  PYTHONPATH=src python -m repro_torch.examples.calibrate_profiles [--device cpu]
"""
import numpy as np

from repro_torch.calib import (SyntheticBackend, fit_profiles, holdout_mixes,
                               perturb_profile, profile_to_params, validate)
from repro_torch.configs.registry import get_config
from repro_torch.core.resources import RESOURCE_AXES
from repro_torch.examples import arguments, pricing
from repro_torch.sim.traces import SLO, tenant_profile

MODELS = ("qwen3-1.7b", "falcon-mamba-7b", "phi3.5-moe-42b-a6.6b")


def believed_kernels(rng, dev):
    """Analytic per-tenant kernels from registry model configs — the
    same construction the trace generator uses (family picks the
    resource-axis mix), one tenant per model family here."""
    out = {}
    for name in MODELS:
        arch = get_config(name)
        prof = tenant_profile(rng, arch.family, arch, dev, SLO)
        out[arch.family] = prof.kernels[0]
    return out


def main(argv=None):
    args = arguments(__doc__).parse_args(argv)
    with pricing(args) as dev:
        return walkthrough(dev)


def walkthrough(dev):
    """Returns the fitted profiles by tenant."""
    rng = np.random.default_rng(7)
    believed = believed_kernels(rng, dev)
    # what the hardware ACTUALLY does: every nonzero axis demand (and
    # the duration) multiplicatively perturbed — compilers, batch
    # shapes, and cache behaviour drift profiles exactly like this
    truth = {n: perturb_profile(k, rng, scale=0.3, dev=dev)
             for n, k in believed.items()}
    backend = SyntheticBackend(truth, dev, seed=7)

    print("== 1. measure: the stressor x victim sweep ==")
    sweep = backend.run_sweep(sorted(truth))
    print(f"  {len(sweep)} colocated observations across "
          f"{len(sweep.victims)} victims on {dev.name}")

    print("\n== 2. fit: invert the estimator over the observations ==")
    fitted = fit_profiles(sweep)
    for name in sorted(truth):
        b = profile_to_params(believed[name], dev)
        t = profile_to_params(truth[name], dev)
        f = profile_to_params(fitted[name], dev)
        print(f"  {name}: axis utilization believed -> true (fitted)")
        for axis in RESOURCE_AXES:
            if max(b[f"u:{axis}"], t[f"u:{axis}"]) < 0.01:
                continue
            print(f"    {axis:>5}: {b[f'u:{axis}']:.3f} -> "
                  f"{t[f'u:{axis}']:.3f} (fitted {f[f'u:{axis}']:.3f})")

    print("\n== 3. validate on held-out k-way mixes ==")
    mixes = holdout_mixes(sorted(truth), np.random.default_rng(99))
    stale = validate(believed, backend, mixes)
    fresh = validate(fitted, backend, mixes)
    print(f"  stale analytic profiles: max rel error "
          f"{stale.max_rel_error:.1%} (mean {stale.mean_rel_error:.1%})")
    print(f"  fitted profiles:         max rel error "
          f"{fresh.max_rel_error:.1%} (mean {fresh.mean_rel_error:.1%})")
    print(f"  worst stale mix: {stale.worst_mix}")
    print("\nThe fleet wiring closes the loop online: "
          "FleetScheduler.attach_calibration(DriftMonitor()) watches "
          "predicted-vs-observed slowdown per tenant, flags sustained "
          "divergence, and refit_workload() re-fits + resubmits "
          "(see the drift gate in benchmarks/bench_calib.py).")
    return {name: profile_to_params(fitted[name], dev) for name in sorted(fitted)}


if __name__ == "__main__":
    main()
