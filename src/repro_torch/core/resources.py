"""Hardware resource models.

The paper's central abstraction, one level deeper than a utilization
scalar: a device is a VECTOR of contendable resources. The H100 model is
the one this package's serve engine prices against by default; the RTX3090
model validates the estimator against the paper's own measured numbers, and
the analytic TPU v5e / v5p models are kept so that a scenario can be priced
on any device the reference package knows.

Resource vector axes (TPU naming; GPU models map their analogues):
  mxu     — matrix-unit FLOP/s           (GPU: tensor-core / fp pipelines)
  vpu     — vector-unit FLOP/s           (GPU: fma/alu pipelines)
  issue   — instruction-issue slots/s    (GPU: warp-scheduler IPC)
  hbm     — main-memory bandwidth B/s    (GPU: DRAM bandwidth)
  l2      — shared-cache bandwidth B/s   (GPU: L2; TPU: none -> CMEM/inf)
  smem    — on-chip scratch bandwidth B/s(GPU: shared mem; TPU: VMEM)
  smem_cap— on-chip capacity B           (GPU: L2/smem capacity; TPU: VMEM)
  ici     — interconnect B/s             (GPU: NVLink; TPU: ICI per chip)
  slots   — co-resident execution slots  (GPU: SM count; TPU: cores/chip)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict

import numpy as np

RESOURCE_AXES = ("mxu", "vpu", "issue", "hbm", "l2", "smem", "ici")
AXIS_INDEX = {r: i for i, r in enumerate(RESOURCE_AXES)}


@dataclass(frozen=True)
class DeviceModel:
    name: str
    mxu_flops: float            # peak matrix FLOP/s (bf16 / fp16-TC)
    vpu_flops: float            # peak vector FLOP/s (f32)
    issue_rate: float           # instructions/s device-wide
    hbm_bw: float               # B/s
    l2_bw: float                # B/s (aggregate)
    smem_bw: float              # B/s (aggregate on-chip scratch)
    ici_bw: float               # B/s per device off-chip interconnect
    hbm_capacity: float
    cache_capacity: float       # L2 (GPU) / VMEM (TPU) bytes
    n_slots: int                # SMs (GPU) / TensorCores (TPU)
    clock_hz: float

    def capacity(self, axis: str) -> float:
        return {
            "mxu": self.mxu_flops, "vpu": self.vpu_flops,
            "issue": self.issue_rate, "hbm": self.hbm_bw,
            "l2": self.l2_bw, "smem": self.smem_bw, "ici": self.ici_bw,
        }[axis]

    def capacity_vector(self) -> np.ndarray:
        """Per-axis capacities in RESOURCE_AXES order, floored at 1e-9 so
        division-by-capacity is always defined (e.g. ici_bw=0 models)."""
        return np.maximum(
            np.array([self.capacity(r) for r in RESOURCE_AXES], np.float64),
            1e-9)


# --------------------------------------------------------------------- #
#  TPU v5e — analytic model of the reference package's target           #
# --------------------------------------------------------------------- #
TPU_V5E = DeviceModel(
    name="tpu_v5e",
    mxu_flops=197e12,           # bf16
    vpu_flops=197e12 / 16,      # VPU is ~1/16 of MXU throughput
    issue_rate=0.94e9 * 8,      # VLIW bundles/s x slots (approx)
    hbm_bw=819e9,
    l2_bw=819e9,                # no transparent L2: alias HBM
    smem_bw=22e12,              # VMEM load+store aggregate (approx)
    ici_bw=50e9,                # per link; 16x16 torus: ~3 usable links
    hbm_capacity=16e9,
    cache_capacity=128e6,       # VMEM
    n_slots=1,                  # one TensorCore per chip (v5e)
    clock_hz=0.94e9,
)

# --------------------------------------------------------------------- #
#  TPU v5p — the training-class sibling: ~2.3x v5e on compute and        #
#  ~3.4x on HBM bandwidth, two TensorCores per chip, double the VMEM —   #
#  the second model of the heterogeneous fleet gates (a workload priced  #
#  on both sees genuinely different cache/bandwidth headroom)            #
# --------------------------------------------------------------------- #
TPU_V5P = DeviceModel(
    name="tpu_v5p",
    mxu_flops=459e12,           # bf16
    vpu_flops=459e12 / 16,
    issue_rate=1.75e9 * 8,
    hbm_bw=2765e9,
    l2_bw=2765e9,               # no transparent L2: alias HBM
    smem_bw=44e12,              # VMEM aggregate across both cores (approx)
    ici_bw=100e9,               # per link, 3D torus
    hbm_capacity=95e9,
    cache_capacity=256e6,       # VMEM aggregate (2 TensorCores)
    n_slots=2,                  # two TensorCores per chip (v5p)
    clock_hz=1.75e9,
)

# --------------------------------------------------------------------- #
#  NVIDIA H100 — the serve engine's default; also validates against     #
#  the paper's measurements                                              #
# --------------------------------------------------------------------- #
H100 = DeviceModel(
    name="h100_nvl",
    mxu_flops=835e12,           # fp16 tensor core (no sparsity), NVL bin
    vpu_flops=60e12,            # fp32 CUDA cores (~2x for fp16 fma)
    issue_rate=132 * 4 * 1.785e9,  # 132 SMs x 4 warp-sched x clock
    hbm_bw=3.35e12,             # HBM3 (NVL 3.9e12; paper-era 3.35)
    l2_bw=7.0e12,               # approx aggregate L2 bandwidth
    smem_bw=132 * 128 * 4 * 1.785e9,  # 32 banks x 4B x clock x SMs
    ici_bw=450e9,               # NVLink4 per direction
    hbm_capacity=94e9,
    cache_capacity=50e6,        # 50MB L2 (paper §4.3)
    n_slots=132,
    clock_hz=1.785e9,
)
H100 = replace(H100, vpu_flops=66.9e12)

RTX3090 = DeviceModel(
    name="rtx3090",
    mxu_flops=142e12,           # fp16 TC
    vpu_flops=35.6e12,
    issue_rate=82 * 4 * 1.695e9,   # 82 SMs x 4 subpartitions (paper §4.4.2)
    hbm_bw=936e9,
    l2_bw=2.0e12,
    smem_bw=82 * 128 * 4 * 1.695e9,
    ici_bw=0.0,
    hbm_capacity=24e9,
    cache_capacity=6e6,
    n_slots=82,
    clock_hz=1.695e9,
)

DEVICES: Dict[str, DeviceModel] = {d.name: d for d in (TPU_V5E, TPU_V5P,
                                                       H100, RTX3090)}


def fp64_pipe(dev: DeviceModel) -> float:
    """FP64 pipeline (paper §4.4.3: half of FP32 rate on H100)."""
    return dev.vpu_flops / 2
