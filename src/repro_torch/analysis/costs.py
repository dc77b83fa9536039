"""Per-chip FLOPs, memory traffic, collective bytes and peak memory of a
traced step: the port's counterpart of ``repro/analysis/hlo.py``.

The reference AOT-compiles a step and re-derives its roofline inputs from
the post-SPMD HLO text, the per-device program XLA emits (``hlo.py``:
dots and convolutions, operand plus result bytes, collectives by type,
each through while-loop trip counts).  PyTorch compiles no such program:
an eager step is the sequence of ops each rank dispatches.  So the port
runs the real step on ``meta`` tensors (shapes, no data), as DTensors on a
``DeviceMesh`` over the ``fake`` process group (``launch.mesh``), under
:class:`CostMode`, a dispatch mode that sees every op a rank executes:

* **Per chip.**  A DTensor op reaches the mode with global shapes; the
  mode declines it (``NotImplemented``), DTensor then runs the rank's
  *local* ops beneath it with the mode still on the stack, and those are
  counted.  The ops DTensor runs under a ``FakeTensorMode`` to propagate
  global shapes are not work, and are skipped.  (``FlopCounterMode`` pops
  itself before DTensor dispatches, so it counts the global program.)
* **FLOPs** of every op with a formula in
  ``torch.utils.flop_counter.flop_registry``: the matmuls, convolutions,
  and the kernels' custom ops (``kernels.meta``), by the dtype of their
  work (``flops_by_dtype``; the scans' are f32 on CUDA cores).  Other
  elementwise work is not counted, as in the reference.
* **Traffic:** operand plus result bytes of every op that moves data
  (views and uninitialised allocations move none).  Eager PyTorch runs
  every op as a kernel, so this is an upper bound of what fused kernels
  would move, as the reference's CPU-fusion caveat says of its own.
* **Collectives:** the functional collectives (DTensor's) and the c10d
  ones (the model's own ``distributed.collectives``) by type and by mesh
  axis, the input bytes a rank.
* **Peak memory:** every storage an op allocates is live until its last
  reference dies (``weakref`` on the storage), so saved-for-backward
  tensors, remat's recomputes and gradients freed as AdamW uses them are
  counted as the step holds them; a kernel call adds its temporaries for
  its duration and its workspace once, kept (``kernels.meta.OPS``).  Each
  storage is rounded as the CUDA caching allocator rounds it
  (``ALLOC_ROUND``), so the figure is what ``torch.cuda.memory_allocated``
  would show above the state's; cuBLAS's workspaces (``CUBLAS_WORKSPACE``
  a thread that ran a product) are counted apart.  (PyTorch's own
  ``torch.distributed._tools.mem_tracker.MemTracker`` tracks meta tensors
  too, on 2.13; this tracker lives in the same mode as the counts and adds
  what no output shows.)

:func:`roofline_terms` turns a :class:`Costs` into times at an NVIDIA
H100 SXM's published peaks.  Every figure is a prediction computed on the
host, never a measurement.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta as kmeta
from repro_torch.runtime import alloc_bytes

# -- the card (NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit)
#: FLOP/s by the dtype of the work: tensor cores in bf16 and fp16; f32
#: without TF32 (PyTorch's default for matmuls) on the CUDA cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
HBM_BW = 3.35e12           # bytes/s
#: NVLink within a host of GPUS_PER_HOST: 900 GB/s all to all, 450 each way.
NVLINK_BW = 450e9
GPUS_PER_HOST = 8
#: An axis whose ranks span hosts goes over the network: one 400 Gb/s
#: ConnectX-7 InfiniBand port a GPU (NVIDIA DGX H100 data sheet: 8 single-
#: port ConnectX-7 VPI, 400 Gb/s each), 50e9 bytes/s each way.
NETWORK_BW = 50e9
#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3, read on the card with PyTorch 2.11.
HBM_BYTES = 85_017_493_504
#: The CUDA caching allocator rounds each allocation up to a multiple of
#: 512 bytes (``memory_allocated`` counts the rounded size).
ALLOC_ROUND = 512
#: cuBLAS's workspace, which PyTorch allocates through the caching
#: allocator for each (handle, stream) that runs a product and keeps: 32
#: MiB on an sm_90 card (its default for Hopper; on the H100 a prefill's
#: window starts 33,688,064 B above its weights and tokens).  A step's
#: forward runs on the caller's thread and its backward on autograd's
#: device thread, each with its own handle.
CUBLAS_WORKSPACE = 32 << 20

_COLLECTIVES = {
    # functional (DTensor's): op name -> (type, index of the input tensor)
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("broadcast", 0),
    # c10d (direct calls)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "wait_tensor", "_wrap_tensor_autograd"}


def rounded(nbytes: int, round_to: int = ALLOC_ROUND) -> int:
    """``nbytes`` as the allocator counts it (0 stays 0)."""
    return -(-nbytes // round_to) * round_to if nbytes else 0


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Costs:
    """One rank's counts for a traced step (the reference's ``Costs``,
    with the FLOPs by dtype, the collectives by mesh axis and the
    memory)."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: mesh axis (a name, or "+"-joined names) -> collective bytes
    by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the largest sum of live storages the step allocated (its own,
    #: temporaries and workspace included), above what existed before it
    temp_peak_bytes: int = 0
    #: kernel workspace kept across calls (counted in temp_peak_bytes)
    workspace_bytes: int = 0
    #: cuBLAS workspaces of the threads that ran products (forward, and
    #: the backward's): not in temp_peak_bytes
    cublas_bytes: int = 0
    #: ops counted, and kernel custom ops among them
    ops: int = 0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)


class CostMode(TorchDispatchMode):
    """Counts the ops this rank executes while it is on (see the module
    docstring).  ``mesh`` names the axes of the collectives' groups;
    ``round_to`` rounds each storage (1: exact bytes)."""

    def __init__(self, mesh=None, round_to: int = ALLOC_ROUND):
        super().__init__()
        self.costs = Costs()
        self.round_to = round_to
        self._axes: Dict[str, str] = {}
        if mesh is not None:
            names = mesh.mesh_dim_names
            for i, name in enumerate(names):
                self._axes[mesh.get_group(i).group_name] = name
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._workspace: Dict[Any, int] = {}
        self._threads: set = set()   # forward (False), backward (True)

    # -- memory --------------------------------------------------------
    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, outputs, inputs) -> None:
        seen = {id(t.untyped_storage()) for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            seen.add(key)
            n = rounded(st.nbytes(), self.round_to)
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(st, self._free, key)
        self._peak(0)

    def _peak(self, extra: int) -> None:
        now = self._live_bytes + extra
        if now > self.costs.temp_peak_bytes:
            self.costs.temp_peak_bytes = now

    def _kernel(self, func, args) -> None:
        """A kernel call's temporaries (live while it runs, beside its
        outputs) and the growth of its wrapper's workspace."""
        allocs = kmeta.OPS[func](*args)
        name = func._overloadpacket.__name__
        self.costs.kernel_calls[name] = self.costs.kernel_calls.get(name,
                                                                    0) + 1
        for i, a in enumerate(allocs.workspace):
            n = rounded(alloc_bytes([a]), self.round_to)
            grow = n - self._workspace.get((name, i), 0)
            if grow > 0:
                self._workspace[(name, i)] = n
                self._live_bytes += grow
                self.costs.workspace_bytes += grow
        temps = sum(rounded(alloc_bytes([a]), self.round_to)
                    for a in allocs.temps)
        self._peak(temps)

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(is_traceable_wrapper_subclass(a) for a in flat):
            # a DTensor's (or an async collective's result's) op: counted
            # on the local ops it runs beneath
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)   # DTensor's shape propagation
        out = func(*args, **kwargs)
        c = self.costs
        c.ops += 1
        inputs = [a for a in flat if isinstance(a, torch.Tensor)]
        outputs = [o for o in tree_flatten(out)[0]
                   if isinstance(o, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            if func.namespace == "aten":     # a cuBLAS product
                self._threads.add(
                    torch._C._current_graph_task_id() != -1)
                c.cublas_bytes = CUBLAS_WORKSPACE * len(self._threads)
            n = float(flop_registry[packet](*args, **kwargs, out_val=out))
            dtype = (torch.float32 if func in kmeta.F32_WORK
                     else inputs[0].dtype if inputs else torch.float32)
            c.flops += n
            key = str(dtype).replace("torch.", "")
            c.flops_by_dtype[key] = c.flops_by_dtype.get(key, 0.0) + n
        name = packet.__name__
        coll = _COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "c10d") else None
        if coll is not None:
            kind, idx = coll
            src = args[idx]
            nbytes = sum(tensor_bytes(t) for t in (
                src if isinstance(src, (list, tuple)) else [src]))
            c.collective_bytes += nbytes
            c.by_collective[kind] = c.by_collective.get(kind, 0.0) + nbytes
            axis = self._axis_of(flat)
            c.by_axis[axis] = c.by_axis.get(axis, 0.0) + nbytes
        if not func.is_view and name not in _NO_TRAFFIC:
            c.traffic_bytes += sum(map(tensor_bytes, inputs)) + sum(
                map(tensor_bytes, outputs))
        self._track(outputs, inputs)
        if func in kmeta.OPS:    # beside its outputs
            self._kernel(func, args)
        return out

    def _axis_of(self, flat) -> str:
        for a in flat:
            if isinstance(a, str) and a in self._axes:
                return self._axes[a]
            if isinstance(a, torch.ScriptObject):
                from torch._C._distributed_c10d import ProcessGroup
                name = ProcessGroup.unbox(a).group_name
                return self._axes.get(name, name)
        return "?"


def state_bytes(tensors: Iterable[torch.Tensor],
                round_to: int = 1) -> int:
    """The bytes of ``tensors``' distinct storages on this rank (a
    DTensor's local block), each rounded to ``round_to``."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += rounded(st.nbytes(), round_to)
    return total


def count(fn, *args, mesh=None, round_to: int = ALLOC_ROUND, **kwargs):
    """``(fn(*args, **kwargs), Costs)``: one rank's counts of the call."""
    mode = CostMode(mesh, round_to)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.costs


def axis_bandwidth(mesh, axis: str) -> float:
    """Bytes/s a rank's collectives move over ``axis`` (names joined by
    "+" for several): NVLink where every group of the axis lies within one
    host of GPUS_PER_HOST consecutive ranks, else the network."""
    if mesh is None or axis not in _axis_groups(mesh):
        return NETWORK_BW
    for group in _axis_groups(mesh)[axis]:
        if len({r // GPUS_PER_HOST for r in group}) > 1:
            return NETWORK_BW
    return NVLINK_BW


def _axis_groups(mesh) -> Dict[str, list]:
    out = {}
    ranks = mesh.mesh.cpu()
    for i, name in enumerate(mesh.mesh_dim_names):
        moved = ranks.movedim(i, -1).reshape(-1, ranks.shape[i])
        out[name] = [row.tolist() for row in moved]
    return out


def roofline_terms(costs: Costs, mesh=None) -> Dict[str, Any]:
    """The reference's terms at the H100's published peaks: compute (each
    dtype's FLOPs at its peak), memory (traffic over HBM), collectives
    (each axis's bytes over its link), the dominant one and their max as
    a lower bound of the step's time."""
    compute_s = sum(n / PEAK_FLOPS.get(getattr(torch, d, None), 67e12)
                    for d, n in costs.flops_by_dtype.items())
    memory_s = costs.traffic_bytes / HBM_BW
    collective_s = sum(n / axis_bandwidth(mesh, a)
                       for a, n in costs.by_axis.items())
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "step_s_lower_bound": max(compute_s, memory_s, collective_s),
    }
