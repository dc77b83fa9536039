"""Host mesh construction — the port of ``repro/launch/mesh.py``'s
``make_host_mesh``.

A ``DeviceMesh`` of shape (data, model) with dims named ``("data",
"model")`` over the ranks of the initialised ``torch.distributed`` group:
on the card each rank's current device (gloo lets several ranks share
one), on the host CPU ranks.
"""
from __future__ import annotations


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
