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

A tree of DTensors (a sharded trainer's) is saved as its full arrays: each
leaf is gathered with ``full_tensor()``, a collective, so every rank calls
``save``, and rank 0 alone writes the files (ROADMAP C28); a blocking save
returns on every rank once they are published. ``restore(...,
shardings=)`` lays each leaf onto the given placements over ``like``'s
mesh: the reference's elastic re-shard, onto any mesh.
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
import torch.distributed as dist

from repro_torch.kernels import _mesh
from repro_torch.tree import leaves, map_leaves, unflatten

# torch dtypes by the NumPy names the manifest gives them
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_host(t) -> Tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its dtype's name: bf16 as its
    bytes. A DTensor is gathered to its full array first (a collective)."""
    t = torch.as_tensor(_mesh.whole(t)).detach()
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
        """Every rank of a tree of DTensors calls this; rank 0 writes."""
        self.wait()
        ls = leaves(tree)
        host = [_to_host(t) for t in ls]                   # device -> host now
        shapes = [list(torch.as_tensor(t).shape) for t in ls]
        sharded = any(_mesh.is_dtensor(t) for t in ls)
        if not sharded or dist.get_rank() == 0:
            t = threading.Thread(target=self._write, args=(step, host, shapes),
                                 daemon=True)
            t.start()
            self._pending = t
        if block:
            self.wait()
            if sharded:
                dist.barrier()

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

    def restore(self, step: int, like: Any = None, shardings: Any = None):
        """The leaves of checkpoint ``step``: with ``like``, in its structure,
        each leaf in the type and on the device of ``like``'s, and with
        ``shardings`` (placements for each leaf, ``like``'s nesting: what
        ``parallel.sharding.named`` gives) a DTensor over the mesh of
        ``like``'s DTensor leaves; else a list of CPU tensors in their
        stored types."""
        mesh = _target_mesh(like, shardings)
        return _lay(self._read(step, like), mesh, shardings)

    def _read(self, step: int, like: Any = None):
        """Checkpoint ``step``'s leaves, in ``like``'s structure, types and
        devices where given."""
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

    def restore_latest(self, like: Any = None, shardings: Any = None
                       ) -> Optional[Tuple[int, Any]]:
        """The newest checkpoint that reads, as ``restore`` gives it. Only
        reading falls back to an older step: ``shardings`` that do not fit
        ``like`` raise."""
        mesh = _target_mesh(like, shardings)
        steps = self.all_steps()
        if not steps:
            return None
        # skip corrupt newest checkpoints (crash-mid-rename safety)
        for s in reversed(steps):
            try:
                tree = self._read(s, like)
            except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as e:
                print(f"checkpoint step {s} unreadable ({type(e).__name__}: {e}); "
                      "trying an older one")
                continue
            return s, _lay(tree, mesh, shardings)
        return None


def _target_mesh(like, shardings):
    """The mesh that ``shardings`` place onto: that of ``like``'s DTensor
    leaves (None without ``shardings``). Shardings nested otherwise than
    ``like`` raise here, before any checkpoint is read."""
    if shardings is None:
        return None
    map_leaves(lambda t, pl: None, like, shardings)
    meshes = [r.device_mesh for r in leaves(like) if _mesh.is_dtensor(r)]
    if not meshes:
        raise ValueError("restore: shardings need a tree like that lies on a mesh")
    return meshes[0]


def _lay(tree, mesh, shardings):
    """The restored tree on its placements: the elastic re-shard."""
    if shardings is None:
        return tree
    from repro_torch.parallel.sharding import place
    return place(tree, mesh, shardings)
