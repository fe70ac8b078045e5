"""Mesh builders over ``torch.distributed``; the twin of
``src/repro/launch/mesh.py``.

Defined as FUNCTIONS so importing this module never touches a process
group. Each builds a ``DeviceMesh`` with ``init_device_mesh`` over the
process group that the caller has initialised (the world's ranks), on the
card's device type unless told.

``fake_world(n)`` gives one process a world of n ranks on PyTorch's
``fake`` backend (``torch.testing._internal.distributed.fake_pg``), whose
collectives move nothing: the dry run counts one rank's work of the
production meshes in it, over ``meta`` tensors. A process has one default
process group, so the helper refuses to run inside another and tears its
own down on the way out, with ``forget_meshes``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

POD1 = ((16, 16), ("data", "model"))
POD2 = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")``, over the initialised world of 256 or 512
    ranks (``fake_world`` gives one in one process)."""
    shape, axes = POD2 if multi_pod else POD1
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a world of "
                           f"{n} ranks, not {have}: initialise one (fake_world({n}) "
                           "for a count in one process)")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda"):
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """(world / model_axis, model_axis) over every rank of the process group."""
    n = dist.get_world_size()
    assert n % model_axis == 0
    return make_mesh((n // model_axis, model_axis), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """This process as rank ``rank`` of a world of ``n_ranks`` on the
    ``fake`` backend, for the length of the ``with``."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; a process has one: "
                           "count the production meshes in a process of their own")
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()
        forget_meshes()


def forget_meshes() -> None:
    """Empty DTensor's caches of sharding propagation and of redistribution
    plans; call it where a world is destroyed. A ``DeviceMesh`` compares
    equal to one of the same shape and names made on the same thread (a
    forked process's main thread is its parent's), and those caches key on
    it: a mesh of a later world, or of a forked child, would meet the dead
    world's entries and come back on its process groups. A cache that this
    PyTorch does not have needs no emptying."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:                  # the dispatch's C++ fast path
        native()
    _redistribute._gen_transform_infos.cache_clear()
    planners = getattr(_redistribute, "clear_redistribute_planner_cache", None)
    if planners is not None:
        planners()
