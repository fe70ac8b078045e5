"""repro_torch.calib — measured-profile calibration on the card.

    measure  →  fit  →  validate
  (calib.measure) (calib.fit) (calib.validate)

* ``measure`` runs the §4 stressor × victim sweep behind a pluggable
  backend (the deterministic ``SyntheticBackend`` on the CPU,
  ``TorchBackend`` for real colocated kernel runs on CUDA streams);
* ``fit`` inverts the water-filling estimator over the measured slowdown
  matrix (batched coordinate descent through ``solve_scenarios``);
* ``validate`` scores the fit on held-out mixes the fitter never saw.

The reference package's fourth stage, online drift monitoring, waits for
the port's fleet scheduler and simulator.
"""
from repro_torch.calib.fit import (FitConfig, FitReport, fit_kernel,  # noqa: F401
                                   fit_profiles, fit_report,
                                   params_to_profile, perturb_profile,
                                   predict_slowdowns, profile_to_params)
from repro_torch.calib.measure import (CACHE_WS_FRACTIONS,  # noqa: F401
                                       FIT_LAMBDAS, REVERSE_LAMBDAS,
                                       BracketError, Colocation,
                                       MeasurementSet, StressorCall,
                                       StressorSpec, SyntheticBackend,
                                       TorchBackend, colocation_scenario,
                                       median_iqr_time, stressor_blocks,
                                       sweep_colocations)
from repro_torch.calib.validate import (HOLDOUT_LAMBDAS,  # noqa: F401
                                        ValidationReport, holdout_mixes,
                                        validate)

__all__ = [
    "BracketError", "CACHE_WS_FRACTIONS", "Colocation", "FIT_LAMBDAS",
    "FitConfig", "FitReport", "HOLDOUT_LAMBDAS", "MeasurementSet",
    "REVERSE_LAMBDAS", "StressorCall", "StressorSpec", "SyntheticBackend",
    "TorchBackend", "ValidationReport", "colocation_scenario", "fit_kernel",
    "fit_profiles", "fit_report", "holdout_mixes", "median_iqr_time",
    "params_to_profile", "perturb_profile", "predict_slowdowns",
    "profile_to_params", "stressor_blocks", "sweep_colocations", "validate",
]
