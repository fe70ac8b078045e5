"""Multi-resource interference estimator: the solver that the serve engine
prices prefill chunks with (NumPy by default, or the f64 PyTorch port on a
device, chosen by `repro_torch.core.backend`), the k-way slot-fraction
search, the sensitivity library of the paper's §4 (per-axis stressor
sweeps), and the colocation scheduler, its scoped repair and the fleet
scheduler that price every decision through that solver."""
from repro_torch.core.backend import (SOLVER_BACKENDS, get_solver_backend,  # noqa: F401
                                      get_solver_device, set_solver_backend,
                                      solver_backend, warmup_solver)
from repro_torch.core.resources import (DEVICES, H100, RTX3090, TPU_V5E,  # noqa: F401
                                        TPU_V5P, DeviceModel)
from repro_torch.core.profile import KernelProfile, ProfileMatrix, WorkloadProfile  # noqa: F401
from repro_torch.core.scenario import (CompiledScenarios, Scenario,  # noqa: F401
                                       compile_scenarios,
                                       group_victim_scenarios)
from repro_torch.core.estimator import (FRACTION_FLOOR, BatchResult,  # noqa: F401
                                        ColocationResult, colocation_speedup,
                                        estimate, estimate_batch,
                                        pairwise_slowdown, solve_batch,
                                        solve_scenarios, workload_slowdown)
from repro_torch.core.fracsearch import (DENSE_SEARCH, LEGACY_SEARCH,  # noqa: F401
                                         FractionSearchConfig, GroupFractions,
                                         search_group_fractions,
                                         simplex_candidates)
from repro_torch.core.sensitivity import (SensitivityReport,  # noqa: F401
                                          cache_pollution_curve,
                                          partition_curve, sensitivity,
                                          sensitivity_batch, stressor)
from repro_torch.core.scheduler import (ColocationScheduler, Plan,  # noqa: F401
                                        Placement, evaluate_group,
                                        evaluate_group_partitioned,
                                        evaluate_pair,
                                        evaluate_pair_partitioned,
                                        plan_colocation)
from repro_torch.core.repair import (RepairPlanner, RepairRecord,  # noqa: F401
                                     RepairResult, RepairScope)
from repro_torch.core.fleet import (BEST_EFFORT, SLO,  # noqa: F401
                                    AdmissionDecision, FleetConfig,
                                    FleetPlan, FleetScheduler)
