"""Train-step builder + Trainer loop: the twin of ``src/repro/train/trainer.py``.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) function with:
  * gradient accumulation over microbatches, in f32 (the reference's
    ``acc_body``): one forward and backward per microbatch;
  * the optional int8 gradient quantiser (``parallel/collectives.py``);
  * the remat policy of the model config (``models/transformer.py:_remat``).

With a ``ParallelContext`` over a mesh (the reference's ``ctx``) the
parameters, the optimiser state and the batch are DTensors and each
microbatch is every rank's own slice of its rows (the rows of a
microbatch differ from the reference's split of the global batch; the
mean over the microbatches does not); where a rank's rows do not split k
ways, the global batch is split as the reference splits it.

PyTorch runs it eagerly where the reference jits it. The parameters stay
plain tensors (no ``requires_grad``): each microbatch differentiates the
loss with respect to fresh views of them, and the optimizer writes the
new values into them in place.

``Trainer`` (used by ``launch/train.py``) adds checkpointing, auto-resume,
straggler monitoring and the log. It runs on the model's device, which is
the card unless the model was built for the CPU.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.ft import StragglerMonitor
from repro_torch.kernels import _mesh
from repro_torch.models.model import Model, mesh_scope, resolve_device
from repro_torch.models.moe import LOCAL_CTX, ParallelContext
from repro_torch.parallel.collectives import compress_grads_int8
from repro_torch.train.optimizer import Optimizer, get_optimizer
from repro_torch.tree import leaves, unflatten


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    def split(x):
        if _mesh.is_dtensor(x):
            return _split_dtensor(x, k, split)
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatches {k}")
        return x.reshape(k, b // k, *x.shape[1:])

    parts = {name: split(x) for name, x in batch.items()}
    return [{name: x[i] for name, x in parts.items()} for i in range(k)]


def _split_dtensor(x, k: int, split):
    """A DTensor batch split k ways: each rank's rows where they split k
    ways; else the global batch, gathered (token ids: small) and split as
    the reference splits it, each microbatch placed back over the mesh dims
    of the rows that it still divides (the most ranks; whole over the
    others)."""
    from torch.distributed.tensor import DTensor
    mesh, pl = x.device_mesh, x.placements
    if x.to_local().shape[0] % k == 0:
        return [DTensor.from_local(u, mesh, pl, run_check=False) for u in split(x.to_local())]
    Replicate = _mesh._types()[2]
    rows = [i for i, p in enumerate(pl) if _mesh.shard_dim(p, x.ndim) == 0]
    whole = x.redistribute(mesh, [Replicate() if i in rows else p for i, p in enumerate(pl)])
    parts = split(whole)
    # the mesh dims of the rows whose split still divides a microbatch's rows,
    # the most ranks among them
    best = max((dims for r in range(len(rows) + 1) for dims in itertools.combinations(rows, r)
                if parts[0].shape[0] % math.prod(mesh.size(i) for i in dims) == 0),
               key=lambda dims: math.prod(mesh.size(i) for i in dims))
    back = [pl[i] if i in best else p for i, p in enumerate(whole.placements)]
    return [_mesh.placed(u, mesh, back) for u in parts]


def make_train_step(model: Model, opt: Optimizer, run: RunConfig,
                    ctx: ParallelContext = LOCAL_CTX) -> Callable:
    k = run.num_microbatches

    def value_and_grad(params, mb):
        """(loss, metrics, grads): grads leaf by leaf of ``leaves(params)``,
        in the parameters' types, ``None`` for a leaf the loss does not
        reach."""
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, metrics = model.loss_fn(unflatten(params, live), mb, ctx)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), {n: v.detach() for n, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        with mesh_scope(ctx):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if k == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            grads = unflatten(params, grads)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for mb in _split_microbatches(batch, k):
                l, _, g = value_and_grad(params, mb)
                for a, gi in zip(acc, g):
                    if gi is not None:       # the reference's a + g.astype(f32): under a
                        a.add_(gi.float())   # mesh a pending sum is reduced in f32
                loss = loss + l
                del g
            grads = unflatten(params, [a.div_(k) for a in acc])
            loss = loss / k
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if run.use_grad_compression:
            grads = compress_grads_int8(grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


# --------------------------------------------------------------------- #
#  Trainer loop (host-side)                                              #
# --------------------------------------------------------------------- #
@dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    optimizer: str = "adamw"
    lr: Optional[float] = None
    straggler_factor: float = 3.0   # step slower than EWMA*factor => flag


class Trainer:
    def __init__(self, model: Model, run: RunConfig, tcfg: TrainerConfig):
        self.device = resolve_device(model.device)
        self.model = model
        self.run = run
        self.tcfg = tcfg
        self.opt = get_optimizer(tcfg.optimizer, tcfg.lr, tcfg.total_steps)
        self.train_step = make_train_step(model, self.opt, run)
        self.ckpt_mgr = None
        if tcfg.checkpoint_dir:
            self.ckpt_mgr = CheckpointManager(tcfg.checkpoint_dir,
                                              keep=tcfg.keep_checkpoints)
        self.straggler = StragglerMonitor(factor=tcfg.straggler_factor)

    def init_state(self, generator: torch.Generator):
        params = self.model.init(generator)
        return params, self.opt.init(params)

    def restore_or_init(self, generator: torch.Generator):
        params, opt_state = self.init_state(generator)
        if self.ckpt_mgr is not None:
            restored = self.ckpt_mgr.restore_latest(like=(params, opt_state))
            if restored is not None:
                step, (params, opt_state) = restored
                return step + 1, params, opt_state
        return 0, params, opt_state

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the model's device, from pinned memory on the card."""
        out = {}
        for name, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[name] = t
        return out

    def fit(self, data: Iterator, generator: Optional[torch.Generator] = None,
            start_step: int = 0, params=None, opt_state=None):
        """Train from ``start_step`` (or from the latest checkpoint, when no
        params are given) to ``total_steps``. Each step's time ends when its
        loss is on the host: that is what the straggler monitor sees."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if params is None:
            start_step, params, opt_state = self.restore_or_init(generator)
            if start_step:
                data.seek(start_step)
        history = []
        for step in range(start_step, self.tcfg.total_steps):
            batch = self.to_device(next(data))
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps - 1:
                history.append((step, loss, dt))
                print(f"step {step:5d}  loss {loss:.4f}  {dt * 1e3:.1f} ms")
            if (self.ckpt_mgr is not None and step > 0
                    and step % self.tcfg.checkpoint_every == 0):
                self.ckpt_mgr.save(step, (params, opt_state))
        if self.ckpt_mgr is not None:
            self.ckpt_mgr.save(self.tcfg.total_steps - 1, (params, opt_state),
                               block=True)
        return params, opt_state, history
