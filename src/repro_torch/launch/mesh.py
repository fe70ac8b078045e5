"""Mesh builders over ``torch.distributed``; the twin of
``src/repro/launch/mesh.py``.

Defined as FUNCTIONS so importing this module never touches a process
group. Each builds a ``DeviceMesh`` with ``init_device_mesh`` over the
process group that the caller has initialised (the world's ranks), on the
card's device type unless told.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) or (2, 16, 16) mesh: not ported."""
    raise NotImplementedError(
        f"the production {'2x16x16' if multi_pod else '16x16'} mesh and the sharded "
        "forward over it are not ported (ROADMAP A10b)")


def make_mesh(shape, axes, device_type: str = "cuda"):
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """(world / model_axis, model_axis) over every rank of the process group."""
    n = dist.get_world_size()
    assert n % model_axis == 0
    return make_mesh((n // model_axis, model_axis), ("data", "model"), device_type)
