"""Mesh construction — the port of ``repro/launch/mesh.py``.

:func:`make_host_mesh`: a ``DeviceMesh`` of shape (data, model) with dims
named ``("data", "model")`` over the ranks of the initialised
``torch.distributed`` group: on the card each rank's current device (gloo
lets several ranks share one), on the host CPU ranks.

:func:`make_production_mesh`: the production meshes the dry-run compiles
for, single pod 16 × 16 = 256 ranks, axes (data, model), or multi-pod 2 ×
16 × 16 = 512, axes (pod, data, model): the pod axis is the one gradient
reductions cross once a step.  It is built over the ``fake`` process
group (:func:`fake_world`), whose collectives move nothing, so a 512-rank
program can be traced on one host.  The device type is "cpu": no CUDA
device is touched, and the ranks' tensors live on ``meta``.  On real NCCL
ranks the same shapes would be ``init_device_mesh("cuda", ...)``, which
no single card can show.

Functions, not module constants: importing this module touches no device
and starts no process group.
"""
from __future__ import annotations

import contextlib

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A (data, model) mesh over the current ranks; ``data * model`` must
    be the group's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks, the group has {world}")
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group as a ``fake`` one of ``world_size`` ranks,
    this process rank ``rank``, for the duration of the block: its
    collectives return at once and move nothing.  Destroyed on exit, so no
    group outlives the block; raises if a group is already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh over the current group, which must
    have 256 or 512 ranks (inside :func:`fake_world`)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)
