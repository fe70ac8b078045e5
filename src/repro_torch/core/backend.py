"""Process-wide solver-backend switch: NumPy oracle vs the PyTorch solver.

Every price in the package — the serve engine's chunk sizing, the §4 fit,
the k-way fraction search, the sensitivity sweeps — bottoms out in the
batched water-filling fixed point (`repro_torch.core.estimator.solve_batch`).
This module selects which implementation executes it:

  * ``"numpy"`` (default): the reference implementation, kept as the 1e-9
    oracle;
  * ``"torch"``: the f64 PyTorch port in `repro_torch.core.estimator_torch`
    (the freeze rounds written out over the whole batch), whose tensors
    live on the device this module also carries. On a CUDA device its
    cache-share stage runs on the ``cache_share`` kernel.

Selection is process-wide: ``set_solver_backend("torch", device=...)`` (or
the ``REPRO_TORCH_SOLVER_BACKEND`` environment variable, read once at first
use, with the device ``"cuda"``) switches every consumer in one place.
Consumers that *cache* the backend choice at construction time
(``FractionSearchConfig.default()``) pick up the backend active when they
were built — switch before constructing them.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from repro_torch.models.model import resolve_device

SOLVER_BACKENDS = ("numpy", "torch")
_ENV_VAR = "REPRO_TORCH_SOLVER_BACKEND"

_backend: Optional[str] = None      # resolved lazily from the env
_device: torch.device = torch.device("cuda")


def _validate(name: str) -> str:
    norm = str(name).strip().lower()
    if norm not in SOLVER_BACKENDS:
        raise ValueError(
            f"unknown solver backend {name!r}: expected one of "
            f"{SOLVER_BACKENDS}")
    return norm


def get_solver_backend() -> str:
    """The active solver backend name ("numpy" | "torch")."""
    global _backend, _device
    if _backend is None:
        name = _validate(os.environ.get(_ENV_VAR, "numpy"))
        if name == "torch":
            _device = resolve_device(_device)   # cuda without a card raises
        _backend = name
    return _backend


def get_solver_device() -> torch.device:
    """The device the torch solver's tensors live on."""
    return _device


def set_solver_backend(name: str, device="cuda") -> str:
    """Select the solver backend process-wide, and the device of the torch
    solver; returns the PREVIOUS backend (or use `solver_backend`, which
    also restores the previous device)."""
    global _backend, _device
    prev = get_solver_backend()
    new = _validate(name)
    dev = resolve_device(device) if new == "torch" else torch.device(device)
    _backend, _device = new, dev
    return prev


@contextmanager
def solver_backend(name: str, device="cuda") -> Iterator[str]:
    """Scoped backend override: ``with solver_backend("torch", device="cpu"):``
    restores the previous backend and device on exit."""
    prev, prev_device = get_solver_backend(), _device
    set_solver_backend(name, device)
    try:
        yield get_solver_backend()
    finally:
        set_solver_backend(prev, prev_device)


def warmup_solver(dev, ks=(2, 3), buckets=None) -> int:
    """The reference compiles its jitted solver's shapes here; the torch
    solver captures the CUDA graphs of the same (bucket, K) shapes for the
    device model ``dev`` (``estimator_torch.warmup``). Returns the number of
    new graphs captured: 0 on the NumPy backend and on the CPU, so callers
    may call it unconditionally."""
    if get_solver_backend() != "torch":
        return 0
    from repro_torch.core import estimator_torch
    kwargs = {} if buckets is None else {"buckets": tuple(buckets)}
    return estimator_torch.warmup(dev, ks=tuple(ks), **kwargs)
