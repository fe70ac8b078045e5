"""Fault-tolerant checkpointing: the twin of ``src/repro/checkpoint/__init__.py``,
with its format and protocol, so that a checkpoint written by either
package restores in the other.

  * ASYNC save: device -> host copy on the caller thread (the train step
    updates the parameters in place right after), file write on a
    background thread so the train loop never blocks on disk;
  * ATOMIC publish: write to ``step_XXXXXXXX.tmp/``, then ``os.replace`` to
    ``step_XXXXXXXX/``: a crash mid-write never corrupts the latest
    checkpoint;
  * keep-K retention, and ``restore_latest`` resolves the newest valid
    manifest;
  * MESH-FREE format: ``leaves.npz`` holds each leaf as a full logical
    array (``leaf_<i>``) and ``manifest.json`` its step, count, dtypes and
    shapes. bf16, which npz cannot store, is stored as its bytes (a
    ``uint8`` view) with its dtype named.

Leaves go in ``jax.tree.flatten``'s order (``repro_torch.tree``: dict keys
sorted, tuples in order, a ``None`` is no leaf). A bf16 leaf is restored
through torch views of its bytes, not through ``ml_dtypes``, which this
package does not need.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten

# torch dtypes by the NumPy names the manifest gives them
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_host(t) -> Tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its dtype's name: bf16 as its bytes."""
    t = torch.as_tensor(t).detach()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.contiguous().view(torch.uint8)     # last dim doubled, little-endian
    return t.cpu().numpy().copy(), name


def _from_host(a: np.ndarray, name: str, shape) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    if a.dtype == np.uint8 and name != "uint8":
        # the bytes of a bf16 leaf: as int16 bits, then as bf16
        t = t.view(torch.int16).view(_DTYPES[name])
    return t.reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    # ----------------------------- save ------------------------------ #
    def save(self, step: int, tree: Any, block: bool = False):
        self.wait()
        ls = leaves(tree)
        host = [_to_host(t) for t in ls]                   # device -> host now
        shapes = [list(torch.as_tensor(t).shape) for t in ls]
        t = threading.Thread(target=self._write, args=(step, host, shapes),
                             daemon=True)
        t.start()
        self._pending = t
        if block:
            self.wait()

    def _write(self, step: int, host, shapes):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
        manifest = {"step": step, "n_leaves": len(host), "time": time.time(),
                    "dtypes": [name for _, name in host], "shapes": shapes}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)                     # atomic publish
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------- restore ---------------------------- #
    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return out

    def restore(self, step: int, like: Any = None):
        """The leaves of checkpoint ``step``: with ``like``, in its structure,
        each leaf in the type and on the device of ``like``'s; else a list
        of CPU tensors in their stored types."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "leaves.npz") as data:
            got = [_from_host(data[f"leaf_{i}"], manifest["dtypes"][i],
                              manifest["shapes"][i])
                   for i in range(manifest["n_leaves"])]
        if like is None:
            return got
        refs = leaves(like)
        if len(refs) != len(got):
            raise ValueError(f"checkpoint {d} has {len(got)} leaves, the tree "
                             f"{len(refs)}")
        return unflatten(like, [t.to(device=r.device, dtype=r.dtype)
                                for t, r in zip(got, refs)])

    def restore_latest(self, like: Any = None) -> Optional[Tuple[int, Any]]:
        steps = self.all_steps()
        if not steps:
            return None
        # skip corrupt newest checkpoints (crash-mid-rename safety)
        for s in reversed(steps):
            try:
                return s, self.restore(s, like)
            except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as e:
                print(f"checkpoint step {s} unreadable ({type(e).__name__}: {e}); "
                      "trying an older one")
        return None
