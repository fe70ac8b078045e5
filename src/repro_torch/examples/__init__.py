"""Twins of the reference's ``examples/``: each module here is the
walkthrough of the same name, run against this package.

  PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the GPU
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # on the CPU

Every twin prints what its reference example prints, in the same words and
order, and takes the same three flags (``arguments``): ``--device``, the
torch device (``cuda`` by default; without a GPU the twin raises),
``--device-model``, the ``DeviceModel`` of ``core/resources.py`` that
prices everything (``h100_nvl``, the engine's default, by default; the
reference's examples price on ``tpu_v5e``), and ``--backend``, the solver
(``torch`` on ``--device`` by default, with one ``cache_share`` launch a
solve on the card, or ``numpy`` on the host).
"""
from __future__ import annotations

import argparse
import re
from contextlib import contextmanager
from typing import Iterator

from repro_torch.core.backend import SOLVER_BACKENDS, solver_backend
from repro_torch.core.resources import DEVICES, H100, DeviceModel
from repro_torch.models.model import resolve_device


def arguments(doc: str) -> argparse.ArgumentParser:
    """The parser of a twin's three flags; a twin adds its reference's own."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the torch device: cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--device-model", default=H100.name, choices=sorted(DEVICES),
                    help="the DeviceModel that prices the walkthrough")
    ap.add_argument("--backend", default="torch", choices=SOLVER_BACKENDS,
                    help="the solver: torch on --device (default) or numpy on the host")
    return ap


@contextmanager
def pricing(args: argparse.Namespace) -> Iterator[DeviceModel]:
    """The solver backend of ``args`` on its device for the body of the
    walkthrough, restored after it; yields the device model. ``--device
    cuda`` without a GPU raises, whatever the backend."""
    resolve_device(args.device)
    with solver_backend(args.backend, device=args.device):
        yield DEVICES[args.device_model]


_NUMBER = re.compile(r"\d+(?:\.(\d+))?")


def printed_alike(a: str, b: str) -> bool:
    """Two printouts of a walkthrough say the same: the same text around the
    numbers, the same integers, and every decimal within one unit of its
    last printed digit (two solvers equal at 1e-9 may round a last digit
    apart)."""
    words_a, words_b = _NUMBER.split(a), _NUMBER.split(b)
    nums_a, nums_b = list(_NUMBER.finditer(a)), list(_NUMBER.finditer(b))
    if len(nums_a) != len(nums_b):
        return False
    texts = (words_a[::2], words_b[::2])        # split keeps the decimals' groups
    if texts[0] != texts[1]:
        return False
    for x, y in zip(nums_a, nums_b):
        digits = len(x.group(1) or "")
        if digits != len(y.group(1) or "") or (not digits and x.group() != y.group()):
            return False
        if abs(float(x.group()) - float(y.group())) > 10.0 ** -digits * (1 + 1e-9):
            return False
    return True
