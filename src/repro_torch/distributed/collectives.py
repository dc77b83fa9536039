"""The collectives of the model path under a mesh, over the ranks' gloo
group.

The ranks of one card share it over gloo (NCCL wants a card a rank).  On
an H100 machine (PyTorch 2.11 for CUDA) every c10d collective called
directly on CUDA tensors works over gloo (all-reduce, all-gather into a
tensor, reduce-scatter, all-to-all, broadcast), and so does DTensor's
functional all-reduce; DTensor's functional all-gather, reduce-scatter and
all-to-all end the process with a segmentation fault.  While a CUDA mesh
over gloo is set (``sharding.set_mesh``), :func:`route_dtensor_collectives`
points those three, named in :data:`ROUTED`, at the direct c10d
collectives on the same CUDA tensors: nothing leaves the card, and
setting no mesh (or a CPU one) puts PyTorch's own functions back.
:func:`routed_counts` says how many calls took that route, and
:func:`traffic` counts the calls and bytes of every collective on CUDA
tensors, DTensor's all-reduces and the model's own ones included.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

import torch

#: DTensor's collectives that run as direct c10d collectives for CUDA
#: tensors while :func:`route_dtensor_collectives` is on.
ROUTED = ("all_gather", "reduce_scatter", "all_to_all")

_ROUTED: Dict[str, int] = {}
#: name -> [calls, bytes] of every collective of the model path on CUDA
#: tensors: DTensor's (while routed) and :func:`all_reduce`'s.
_TRAFFIC: Dict[str, List[int]] = {}
_LOCK = threading.Lock()
#: (module, name) -> PyTorch's own function, while the route is on
_SAVED: Dict[Tuple[Any, str], Any] = {}


def routed_counts() -> Dict[str, int]:
    """How many calls of each of DTensor's collectives took the route."""
    with _LOCK:
        return dict(_ROUTED)


def traffic() -> Dict[str, List[int]]:
    """``{name: [calls, bytes]}`` of the collectives on CUDA tensors since
    the process started (input bytes a rank)."""
    with _LOCK:
        return {k: list(v) for k, v in _TRAFFIC.items()}


def _count(name: str, x: torch.Tensor, routed: bool = True) -> None:
    with _LOCK:
        if routed:
            _ROUTED[name] = _ROUTED.get(name, 0) + 1
        rec = _TRAFFIC.setdefault(name, [0, 0])
        rec[0] += 1
        rec[1] += x.numel() * x.element_size()


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced in place over ``group`` with ``op`` ("sum" or
    "max"), on the tensor's own device; returns ``t``."""
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.device.type == "cuda":
        _count("all_reduce", t, routed=False)
    dist.all_reduce(t, op=rop, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` over ``group``, stacked on a new leading dim in
    rank order, on ``t``'s own device."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    t = t.contiguous()
    if t.device.type == "cuda":
        _count("all_gather", t, routed=False)
    out = t.new_empty(n * t.numel())
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.view((n,) + tuple(t.shape))


def gather_blocks(blocks: List[torch.Tensor], dims: List[int],
                  group) -> List[torch.Tensor]:
    """Each rank's ``blocks`` gathered over ``group``, block i whole along
    its dim ``dims[i]`` (rank order), in one all-gather a dtype: the
    blocks of a layer's weights travel together, as FSDP's flat
    parameters do.  Every rank's block i has the same shape."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(blocks)  # type: ignore
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, b in enumerate(blocks):
        by_dtype.setdefault(b.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([blocks[i].reshape(-1) for i in idx])
        whole = flat.new_empty(n * flat.numel())
        if flat.device.type == "cuda":
            _count("all_gather_blocks", flat, routed=False)
        dist.all_gather_into_tensor(whole, flat, group=group)
        whole = whole.view(n, -1)
        off = 0
        for i in idx:
            k = blocks[i].numel()
            pieces = whole[:, off:off + k].reshape(
                (n,) + tuple(blocks[i].shape))
            out[i] = torch.cat(list(pieces.unbind(0)), dim=dims[i])
            off += k
    return out


def _process_group(group):
    """The c10d group of a functional collective's ``group`` argument
    (DTensor passes ``(mesh, mesh_dim)``)."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(funcol._resolve_group_name(group, ""))


def _gather(x: torch.Tensor, gather_dim: int, group,
            name: str = "all_gather") -> torch.Tensor:
    """The functional all-gather's result, from c10d's all-gather into a
    tensor on ``x``'s device (counted as ``name``)."""
    import torch.distributed as dist
    pg = _process_group(group)
    n = dist.get_world_size(pg)
    x = x.contiguous()
    _count(name, x)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def _reduce_scatter(x: torch.Tensor, op: str, scatter_dim: int,
                    group) -> torch.Tensor:
    """The functional reduce-scatter's result, from c10d's reduce-scatter
    of a tensor on ``x``'s device ("avg" as a sum over the group's size:
    gloo has no average)."""
    import torch.distributed as dist
    pg = _process_group(group)
    n = dist.get_world_size(pg)
    if scatter_dim != 0:
        x = torch.cat(torch.chunk(x, n, dim=scatter_dim))
    x = x.contiguous()
    _count("reduce_scatter", x)
    op = op.lower()
    rop = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=rop, group=pg)
    return out / n if op == "avg" else out


def route_dtensor_collectives(on: bool) -> None:
    """Point DTensor's functional all-gather, reduce-scatter and all-to-all
    of CUDA tensors at the direct c10d collectives (``on``), or give
    PyTorch's own functions back (see the module docstring).  CPU tensors
    keep PyTorch's path either way; the all-to-all takes DTensor's own
    CPU form, an all-gather and this rank's chunk."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt
    with _LOCK:
        if not on:
            for (mod, name), fn in _SAVED.items():
                setattr(mod, name, fn)
            _SAVED.clear()
            return
        if _SAVED:
            return

    def routed(fn, cuda_fn):
        def wrapper(self, *args, **kwargs):
            if self.device.type == "cuda":
                return cuda_fn(self, *args, **kwargs)
            return fn(self, *args, **kwargs)
        return wrapper

    def gather(self, gather_dim, group, tag=""):
        return _gather(self, gather_dim, group)

    def scatter(self, reduceOp, scatter_dim, group, tag=""):
        return _reduce_scatter(self, reduceOp, scatter_dim, group)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        full = _gather(input, gather_dim, (mesh, mesh_dim), "all_to_all")
        return torch.chunk(full, mesh.size(mesh_dim), dim=shard_dim)[
            mesh.get_local_rank(mesh_dim)].contiguous()

    def all_reduce_counted(self, reduceOp, group, tag=""):
        if self.device.type == "cuda":
            _count("dtensor_all_reduce", self, routed=False)
        return _SAVED[(funcol, "all_reduce")](self, reduceOp, group, tag)

    # PyTorch 2.11 names them all_gather_tensor / reduce_scatter_tensor,
    # later versions call the *_single ones too
    swaps = [(funcol, n, gather) for n in ("all_gather_tensor",
                                          "all_gather_single")]
    swaps += [(funcol, n, scatter) for n in ("reduce_scatter_tensor",
                                            "reduce_scatter_single")]
    swaps += [(pt, "shard_dim_alltoall", alltoall),
              (funcol, "all_reduce", None)]
    with _LOCK:
        for mod, name, cuda_fn in swaps:
            if not hasattr(mod, name):
                continue
            fn = getattr(mod, name)
            _SAVED[(mod, name)] = fn
            setattr(mod, name, all_reduce_counted if cuda_fn is None
                    else routed(fn, cuda_fn))
