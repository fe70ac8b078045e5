"""Measurement runner — the paper's §4 stressor × victim sweep as data, on
the card.

The calibration loop starts here: colocate each victim kernel with a
calibrated single-axis stressor at intensity λ (and with cache-polluter
probes of growing working set), record the victim's observed slowdown,
and hand the resulting ``MeasurementSet`` to the fitter
(``repro_torch.calib.fit``).  The sweep itself is backend-pluggable:

  * ``SyntheticBackend`` — serves slowdowns from HIDDEN ground-truth
    ``KernelProfile``s through the water-filling estimator (optionally
    noised under a seeded ``numpy.random.Generator``), so the whole
    measure → fit → validate pipeline runs on the CPU, and the hidden
    truths make round-trip recovery a checkable property.
  * ``TorchBackend`` — runs the CUDA stressor kernels
    (``repro_torch.kernels.stressors``) on their own CUDA streams beside
    real victim callables on another, so that they share the card's SMs,
    tensor cores, L2 and device memory, and times the observed side with
    CUDA events on its stream (``median_iqr_time``).

A ``Colocation`` names its background *declaratively* — stressor
``(axis, intensity, working_set)`` specs plus cohort victims by name —
so the fitter and validator can rebuild the exact same background from
analytic stressor profiles without ever seeing the hidden truths.

On the card, intensity λ is the share of the card's SMs that a
stressor's grid covers: ``ceil(λ · SMs)`` blocks, each of which keeps its
SM busy for the whole dispatch (``_stressor_call``).  What share of the
axis that reaches is measured, not assumed (``chip_smoke.py`` prints it).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimator import solve_scenarios
from repro_torch.core.profile import KernelProfile
from repro_torch.core.resources import H100, RESOURCE_AXES, DeviceModel
from repro_torch.core.scenario import Scenario
from repro_torch.core.sensitivity import stressor
from repro_torch.kernels import stressors

# the default §4 grids: fit on these λ / working-set points, validate on
# points BETWEEN them (see repro_torch.calib.validate.HOLDOUT_LAMBDAS)
FIT_LAMBDAS: Tuple[float, ...] = (0.1, 0.25, 0.5, 0.75, 0.9)
CACHE_WS_FRACTIONS: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
CACHE_PROBE_INTENSITY = 0.5          # hbm intensity of the polluter probes
# reverse-probe intensities: stressor at λ observed against the measured
# kernel — its slowdown λ/(1−u) resolves victim demands u > 1−λ that
# max-min hides from victim-side probes (u below fair share)
REVERSE_LAMBDAS: Tuple[float, ...] = (0.5, 0.75, 0.9, 0.98)


# ------------------------------------------------------------------ #
#  The shared repeat timer (median + IQR)                              #
# ------------------------------------------------------------------ #
def _event_times(fn: Callable[[], object], repeats: int, warmup: int,
                 stream: "torch.cuda.Stream"):
    """``warmup`` untimed then ``repeats`` timed calls of ``fn`` queued on
    ``stream`` back to back, each between two CUDA events on it; waits
    for the last event only (other streams run on). Returns the times in
    seconds and the first start and last stop events."""
    with torch.cuda.stream(stream):
        for _ in range(max(warmup, 0)):
            fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(max(repeats, 1))]
        for start, stop in events:
            start.record()
            fn()
            stop.record()
    events[-1][1].synchronize()
    ts = np.asarray([a.elapsed_time(b) * 1e-3 for a, b in events], np.float64)
    return ts, events[0][0], events[-1][1]


def _median_iqr(ts: np.ndarray) -> Tuple[float, float]:
    return (float(np.median(ts)),
            float(np.percentile(ts, 75) - np.percentile(ts, 25)))


def median_iqr_time(fn: Callable[[], object], repeats: int = 5,
                    warmup: int = 1,
                    stream: Optional["torch.cuda.Stream"] = None
                    ) -> Tuple[float, float]:
    """Time ``fn`` ``repeats`` times after ``warmup`` untimed calls; return
    ``(median_s, iqr_s)``.  The one timer for every kernel measurement of
    the port — the stressor suite and ``TorchBackend`` both use it.

    Given a CUDA ``stream``, ``fn`` is called with that stream current and
    each call is timed by CUDA events on it: the device's own time, with
    the calls queued back to back.  Without one, each call is timed by
    the host clock, which is right for work that is done when ``fn``
    returns (tensors on the CPU)."""
    if stream is not None:
        ts, _, _ = _event_times(fn, repeats, warmup, stream)
        return _median_iqr(ts)
    for _ in range(max(warmup, 0)):
        fn()
    ts = np.empty(max(repeats, 1), np.float64)
    for i in range(len(ts)):
        t0 = time.perf_counter()
        fn()
        ts[i] = time.perf_counter() - t0
    return _median_iqr(ts)


# ------------------------------------------------------------------ #
#  The measurement vocabulary                                          #
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class StressorSpec:
    """One calibrated stressor: ``intensity`` of ``axis`` capacity (plus
    an optional cache working set for polluter probes).  Maps 1:1 to
    ``repro_torch.core.sensitivity.stressor`` and to the stressor kernels."""
    axis: str
    intensity: float
    working_set: float = 0.0

    def profile(self, dev: DeviceModel) -> KernelProfile:
        return stressor(self.axis, self.intensity, dev,
                        working_set=self.working_set)


@dataclass(frozen=True)
class Colocation:
    """One colocated run: ``victim`` (by name) next to analytic
    stressors and/or other measured kernels (``cohort``, by name).

    ``observe`` selects which side's slowdown the run records:
    ``"victim"`` (default) times the measured kernel; ``"stressor"``
    times the FIRST stressor while the measured kernel contends as
    background.  Reverse probes are essential, not a nicety: under
    max-min sharing a kernel whose demand sits below the fair share is
    never throttled itself, so victim-side probes carry zero signal
    about it — but the known stressor's slowdown reveals exactly how
    much of the axis the kernel takes away (§4 measures both sides).
    """
    victim: str
    stressors: Tuple[StressorSpec, ...] = ()
    cohort: Tuple[str, ...] = ()
    observe: str = "victim"

    @property
    def single_axis(self) -> Optional[str]:
        """The axis of a pure single-stressor probe (else None)."""
        if len(self.stressors) == 1 and not self.cohort \
                and self.observe == "victim" \
                and self.stressors[0].working_set == 0.0:
            return self.stressors[0].axis
        return None

    @property
    def is_cache_probe(self) -> bool:
        return any(s.working_set > 0.0 for s in self.stressors)


@dataclass
class MeasurementSet:
    """The sweep's output: observations + per-victim isolated times,
    everything the fitter needs (and nothing the backend should hide)."""
    device: DeviceModel
    colocations: List[Colocation]
    slowdowns: np.ndarray                # (n,) observed victim slowdowns
    isolated_times: Dict[str, float]     # victim -> measured t_iso (s)

    def __len__(self) -> int:
        return len(self.colocations)

    def of_victim(self, name: str) -> Tuple[List[Colocation], np.ndarray]:
        idx = [i for i, c in enumerate(self.colocations) if c.victim == name]
        return [self.colocations[i] for i in idx], self.slowdowns[idx]

    @property
    def victims(self) -> List[str]:
        return sorted(self.isolated_times)


def colocation_scenario(c: Colocation, victim_profile: KernelProfile,
                        dev: DeviceModel,
                        cohort: Mapping[str, KernelProfile]) -> Scenario:
    """Lower a Colocation to the estimator query whose first victim row
    is the OBSERVED kernel — the measured kernel itself, or (reverse
    probes) the first stressor with the measured kernel as background.
    The one lowering both backends and the fitter share, so a fitted
    candidate is scored under exactly the semantics it was measured."""
    stress = tuple(s.profile(dev) for s in c.stressors)
    others = tuple(cohort[n] for n in c.cohort)
    if c.observe == "stressor":
        if not stress:
            raise ValueError("observe='stressor' needs a stressor")
        return Scenario((stress[0],),
                        stress[1:] + (victim_profile,) + others)
    return Scenario((victim_profile,), stress + others)


def sweep_colocations(victims: Sequence[str], dev: DeviceModel,
                      axes: Sequence[str] = RESOURCE_AXES,
                      lambdas: Sequence[float] = FIT_LAMBDAS,
                      cache_ws_fractions: Sequence[float] = CACHE_WS_FRACTIONS
                      ) -> List[Colocation]:
    """The §4 calibration sweep: every victim × every axis × every λ as
    single-stressor probes, same-axis multi-stressor probes (under
    max-min sharing a single stressor can't throttle a victim below the
    1/2 fair share — k saturating stressors lower the victim's share to
    1/(k+1), exposing demands down there), plus hbm polluter probes with
    working sets swept around the device cache capacity (the Fig. 3
    cliff — what identifies ``cache_working_set``/``cache_hit_fraction``)."""
    out: List[Colocation] = []
    for v in victims:
        for axis in axes:
            for lam in lambdas:
                out.append(Colocation(v, (StressorSpec(axis, lam),)))
            for k in (2, 3):
                out.append(Colocation(
                    v, tuple(StressorSpec(axis, 0.9) for _ in range(k))))
            for lam in REVERSE_LAMBDAS:
                out.append(Colocation(v, (StressorSpec(axis, lam),),
                                      observe="stressor"))
        for f in cache_ws_fractions:
            out.append(Colocation(v, (StressorSpec(
                "hbm", CACHE_PROBE_INTENSITY,
                working_set=f * dev.cache_capacity),)))
    return out


# ------------------------------------------------------------------ #
#  Synthetic backend: hidden truth through the estimator               #
# ------------------------------------------------------------------ #
class SyntheticBackend:
    """Serve measurements from hidden ground-truth profiles.

    The backend is the only holder of ``truth``; consumers see nothing
    but observed slowdowns and isolated times — exactly the information
    a hardware run would yield.  With ``noise > 0`` every observation is
    multiplied by ``exp(noise * N(0, 1))`` drawn from a Generator seeded
    at construction, so repeated identical call sequences stay
    bit-identical per seed.
    """

    def __init__(self, truth: Mapping[str, KernelProfile],
                 dev: DeviceModel, noise: float = 0.0, seed: int = 0):
        self._truth = dict(truth)
        self.device = dev
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)

    def isolated_time(self, victim: str) -> float:
        return float(self._truth[victim].isolated_time(self.device))

    def measure(self, colocations: Sequence[Colocation]) -> np.ndarray:
        """Observed victim slowdowns, one per colocation, in order —
        ONE batched estimator solve over the hidden truths."""
        colocations = list(colocations)
        if not colocations:
            return np.zeros(0, np.float64)
        scenarios = [colocation_scenario(c, self._truth[c.victim],
                                         self.device, self._truth)
                     for c in colocations]
        slows = solve_scenarios(scenarios, self.device).slowdowns[:, 0]
        slows = np.asarray(slows, np.float64).copy()
        if self.noise > 0:
            slows *= np.exp(self.noise
                            * self._rng.standard_normal(len(slows)))
        return slows

    def run_sweep(self, victims: Sequence[str],
                  axes: Sequence[str] = RESOURCE_AXES,
                  lambdas: Sequence[float] = FIT_LAMBDAS,
                  cache_ws_fractions: Sequence[float] = CACHE_WS_FRACTIONS
                  ) -> MeasurementSet:
        cols = sweep_colocations(victims, self.device, axes, lambdas,
                                 cache_ws_fractions)
        return MeasurementSet(
            self.device, cols, self.measure(cols),
            {v: self.isolated_time(v) for v in victims})


# ------------------------------------------------------------------ #
#  Stressor dispatches at an intensity                                 #
# ------------------------------------------------------------------ #
# One block's time per loop iteration on an H100 SM, which sizes a dispatch
# to about ``target_s`` (the backend then times what it really takes):
# stress_mxu bf16 as measured, 0.93 us an iteration of its wgmma body at 119
# tiles (chip_smoke.py's stress_mxu time over its iterations, NVIDIA H100
# 80GB HBM3 at 700 W); the others design estimates: stress_vpu at ilp 4,
# 256·128·4 FFMA at 128 a clock and 1.755 GHz; stress_vmem at stride 8,
# 512·32·3 accesses in 8-way-conflicted wavefronts of 32; stress_hbm at an
# SM's share of 3.35 TB/s.
_S_PER_ITER = {"mxu": 0.93e-6,
               "vpu": 256 * 128 * 4 / (128 * 1.755e9),
               "smem": 512 * 32 * 3 / 32 * 8 / 1.755e9}
_HBM_BYTES_PER_S_PER_SM = 3.35e12 / 132
_ROW = 128                           # f32 columns of the vpu / hbm inputs
VPU_ILP = 4
VMEM_STRIDE = 8
TARGET_S = 1e-3                      # the aimed-for time of one dispatch


@dataclass
class StressorCall:
    """One stressor dispatch at a spec's intensity: the wrapper's name, its
    inputs (made once, kept alive for every dispatch on any stream), its
    keyword arguments, the blocks it launches and the work it does on its
    axis (FLOPs for mxu / vpu / issue, bytes for hbm / l2 / ici / smem)."""
    spec: StressorSpec
    kernel: str
    args: Tuple[torch.Tensor, ...]
    kwargs: Dict[str, int]
    blocks: int
    work: float

    def __call__(self) -> torch.Tensor:
        return getattr(stressors, self.kernel)(*self.args, **self.kwargs)


def stressor_blocks(intensity: float, slots: int) -> int:
    """``ceil(λ · slots)`` blocks, at least one and at most ``slots``."""
    lam = min(max(float(intensity), 0.0), 1.0)
    return min(slots, max(1, math.ceil(round(lam * slots, 9))))


def _stressor_call(spec: StressorSpec, device, slots: Optional[int] = None,
                   target_s: float = TARGET_S,
                   stream_bytes: Optional[float] = None) -> StressorCall:
    """The dispatch that loads ``spec.axis`` at ``spec.intensity``, the
    twin of the reference's map of axis to kernel: mxu → ``stress_mxu``
    (bf16, on the tensor cores), vpu and issue → ``stress_vpu``, hbm, l2
    and ici → ``stress_hbm``, smem → ``stress_vmem``.

    ``stressor_blocks(λ, slots)`` blocks (``slots``: the card's SMs, or
    132), each looping about ``target_s``. ``stress_hbm`` streams
    ``spec.working_set`` bytes, else ``stream_bytes`` (4 × the 50 MB L2),
    ``passes`` times. Inputs are drawn from a ``torch.Generator`` seeded
    with 17 on ``device``."""
    device = torch.device(device)
    if slots is None:
        slots = (torch.cuda.get_device_properties(device).multi_processor_count
                 if device.type == "cuda" else H100.n_slots)
    blocks = stressor_blocks(spec.intensity, slots)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if spec.axis == "mxu":
        T = stressors.MXU_TILE
        iters = max(1, round(target_s / _S_PER_ITER["mxu"]))
        a = randn(blocks, T, T).to(torch.bfloat16)
        # a dominant real eigenvalue (2, then at most about 0.2): the loop
        # is a power iteration that settles, so two roundings of it agree
        u = randn(T, 1)
        u = u / u.norm()
        b = (2.0 * u @ u.T + 0.1 * randn(T, T) / math.sqrt(T)).to(torch.bfloat16)
        return StressorCall(spec, "stress_mxu", (a, b), {"iters": iters},
                            blocks, blocks * iters * 2.0 * T ** 3)
    if spec.axis in ("vpu", "issue"):
        iters = max(1, round(target_s / _S_PER_ITER["vpu"]))
        x = randn(blocks * 256, _ROW)
        return StressorCall(spec, "stress_vpu", (x,),
                            {"iters": iters, "ilp": VPU_ILP}, blocks,
                            x.numel() * iters * VPU_ILP * 2.0)
    if spec.axis in ("hbm", "l2", "ici"):
        ws = spec.working_set or stream_bytes or 4 * H100.cache_capacity
        rows = max(1, math.ceil(ws / (4 * _ROW)))
        block_rows = -(-rows // blocks)
        x = randn(blocks * block_rows, _ROW)
        passes = max(1, round(target_s * blocks * _HBM_BYTES_PER_S_PER_SM
                              / (2 * x.numel() * 4)))
        return StressorCall(spec, "stress_hbm", (x,),
                            {"block_rows": block_rows, "passes": passes},
                            blocks, 2.0 * passes * x.numel() * 4)
    if spec.axis == "smem":
        iters = max(1, round(target_s / _S_PER_ITER["smem"]))
        x = randn(512, stressors.VMEM_STRIP * blocks)
        return StressorCall(spec, "stress_vmem", (x,),
                            {"iters": iters, "stride": VMEM_STRIDE}, blocks,
                            iters * 3 * 4.0 * x.numel())
    raise ValueError(f"no stressor for axis {spec.axis!r}")


# ------------------------------------------------------------------ #
#  Torch backend: real colocated kernel runs on CUDA streams           #
# ------------------------------------------------------------------ #
# the observed side's calls: one untimed, then ``repeats`` timed
_WARMUP = 1
# the background first aims to last MARGIN x the observed side's isolated
# window, then, on each of RETRIES repeats if it fell short, twice as long
# or GROWTH x the span the last attempt needed, whichever is longer
MARGIN = 4.0
RETRIES = 3
GROWTH = 1.5


class BracketError(RuntimeError):
    """A colocated run whose background did not cover the timed window."""


class TorchBackend:
    """Measure real colocated runs on the card.

    ``victims`` maps a name to a zero-argument callable that launches the
    victim's work on the current CUDA stream (a CUDA graph's ``replay``,
    say).  For one colocation, every background callable gets its own
    ``torch.cuda.Stream`` and is queued back to back, enough dispatches to
    outlast the observed side's window (sized from the isolated times);
    then the observed side is timed by ``median_iqr_time`` on a stream of
    its own.  No host thread is needed, and nothing runs on the legacy
    default stream, which would serialise with the others.  The observed
    side's stream has the higher priority: blocks already running are
    never preempted, but when an SM frees up, its pending blocks go first.
    At equal priority, two or three saturating stressors (the
    multi-stressor probes) keep every freed SM for their own next
    dispatches and the victim waits until the whole background has
    drained: its "slowdown" would then be however long the background was
    made, a property of the queue and not of the victim.  CUDA events
    before the first and after the last background dispatch must bracket
    the timed window: if they do not, the run is repeated with a
    background twice as long, or ``GROWTH`` times the span from its first
    event to the end of the timed window if that is longer, and after
    ``RETRIES`` such repeats the measurement raises ``BracketError``.

    Slowdowns are ``max(colocated / isolated, 1)`` of the median times.
    A cohort of victims raises ``NotImplementedError``; reverse probes
    (``observe="stressor"``) time the first stressor with the victim in
    the background.  Without a CUDA device it raises: a colocation needs
    streams, and there is no fallback.
    """

    def __init__(self, victims: Mapping[str, Callable[[], object]],
                 dev: DeviceModel, repeats: int = 5, device="cuda"):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"TorchBackend measures colocations on CUDA "
                             f"streams; device {device} has none")
        if not torch.cuda.is_available():
            raise ValueError("TorchBackend: no CUDA device")
        self._victims = dict(victims)
        self.device = dev
        self.cuda_device = device
        self.repeats = int(repeats)
        self.slots = torch.cuda.get_device_properties(device).multi_processor_count
        self._streams: List[torch.cuda.Stream] = []
        self._calls: Dict[StressorSpec, StressorCall] = {}
        self._iso: Dict[object, float] = {}
        # one record per colocated run: times, bracket margin, repeats
        self.records: List[Dict[str, object]] = []
        self.last_bracket: Dict[str, object] = {}

    def _stream(self, i: int) -> "torch.cuda.Stream":
        """Stream 0, the observed side's, at the highest priority the card
        has; the background's streams at the default priority."""
        while len(self._streams) <= i:
            self._streams.append(torch.cuda.Stream(
                self.cuda_device, priority=-8 if not self._streams else 0))
        return self._streams[i]

    def stressor_call(self, spec: StressorSpec) -> StressorCall:
        call = self._calls.get(spec)
        if call is None:
            call = _stressor_call(spec, self.cuda_device, self.slots)
            torch.cuda.synchronize(self.cuda_device)   # inputs made before use
            self._calls[spec] = call
        return call

    def isolated_time(self, victim: str) -> float:
        t = self._iso.get(victim)
        if t is None:
            t, _ = median_iqr_time(self._victims[victim], self.repeats,
                                   _WARMUP, self._stream(0))
            self._iso[victim] = t
        return t

    def stressor_time(self, spec: StressorSpec) -> float:
        t = self._iso.get(spec)
        if t is None:
            t, _ = median_iqr_time(self.stressor_call(spec), self.repeats,
                                   _WARMUP, self._stream(0))
            self._iso[spec] = t
        return t

    def _timed_colocation(self, timed: Callable[[], object], t_timed: float,
                          background: Sequence[Tuple[Callable[[], object], float]]
                          ) -> Tuple[float, float, int]:
        """Median time of ``timed`` while every ``(fn, isolated time)`` of
        ``background`` loops on its own stream; also the smallest bracket
        margin (s) and the number of dispatches queued in all. Each attempt
        leaves its bracket in ``last_bracket``: per background, the time
        from its first event to the timed window's start (``lead_s``) and
        from the window's end to its last event (``tail_s``)."""
        window = (_WARMUP + self.repeats) * t_timed * MARGIN
        # one dispatch on each background stream first, so that its output
        # is allocated before timing: without it, the first colocation of a
        # 200 MB copy started its timed window 48.8 ms after the background
        # (3.5 ms with it), the background's queue held back on the host
        for i, (fn, _) in enumerate(background):
            with torch.cuda.stream(self._stream(i + 1)):
                fn()
        for attempt in range(RETRIES + 1):
            torch.cuda.synchronize(self.cuda_device)
            brackets, counts = [], []
            for i, (fn, t_bg) in enumerate(background):
                n = max(2, math.ceil(window / max(t_bg, 1e-7)) + 1)
                with torch.cuda.stream(self._stream(i + 1)):
                    first = torch.cuda.Event(enable_timing=True)
                    last = torch.cuda.Event(enable_timing=True)
                    first.record()
                    for _ in range(n):
                        fn()
                    last.record()
                brackets.append((first, last))
                counts.append(n)
            ts, start, stop = _event_times(timed, self.repeats, _WARMUP,
                                           self._stream(0))
            torch.cuda.synchronize(self.cuda_device)
            lead = [a.elapsed_time(start) * 1e-3 for a, _ in brackets]
            tail = [stop.elapsed_time(b) * 1e-3 for _, b in brackets]
            self.last_bracket = {
                "attempt": attempt, "timed_iso_s": t_timed,
                "background_iso_s": [t for _, t in background],
                "dispatches": counts, "lead_s": lead, "tail_s": tail,
                "window_s": start.elapsed_time(stop) * 1e-3}
            margin = min(lead + tail)
            if margin >= 0.0:
                return _median_iqr(ts)[0], margin, sum(counts)
            # twice as long, or as long as this attempt showed the background
            # must last (from its start to the end of the timed window): a
            # short victim slowed by waiting for SMs that the background
            # holds outgrows any multiple of its isolated time
            window = max(2.0 * window, GROWTH * (max(lead) + self.last_bracket["window_s"]))
        raise BracketError(
            f"the background did not cover the timed window after "
            f"{RETRIES} longer repeats: {self.last_bracket}")

    def measure(self, colocations: Sequence[Colocation]) -> np.ndarray:
        out = np.empty(len(colocations), np.float64)
        for i, c in enumerate(colocations):
            if c.cohort:
                raise NotImplementedError(
                    "TorchBackend measures stressor backgrounds; a cohort "
                    "of victims would need each victim's callable looping "
                    "on its own stream")
            calls = [self.stressor_call(s) for s in c.stressors]
            victim = self._victims[c.victim]
            if c.observe == "stressor":
                if not calls:
                    raise ValueError("observe='stressor' needs a stressor")
                iso = self.stressor_time(c.stressors[0])
                bg = [(fn, self.stressor_time(s))
                      for fn, s in zip(calls[1:], c.stressors[1:])]
                bg.append((victim, self.isolated_time(c.victim)))
                col, margin, queued = self._timed_colocation(calls[0], iso, bg)
            else:
                iso = self.isolated_time(c.victim)
                bg = [(fn, self.stressor_time(s))
                      for fn, s in zip(calls, c.stressors)]
                col, margin, queued = self._timed_colocation(victim, iso, bg)
            out[i] = max(col / max(iso, 1e-12), 1.0)
            self.records.append({"colocation": c, "isolated_s": iso,
                                 "colocated_s": col, "slowdown": float(out[i]),
                                 "bracket_margin_s": margin,
                                 "background_dispatches": queued})
        return out

    def run_sweep(self, victims: Sequence[str],
                  axes: Sequence[str] = RESOURCE_AXES,
                  lambdas: Sequence[float] = FIT_LAMBDAS,
                  cache_ws_fractions: Sequence[float] = ()
                  ) -> MeasurementSet:
        cols = sweep_colocations(list(victims), self.device, axes, lambdas,
                                 cache_ws_fractions)
        return MeasurementSet(
            self.device, cols, self.measure(cols),
            {v: self.isolated_time(v) for v in victims})
