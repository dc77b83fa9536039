"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a
    usable GPU raises rather than falling back to the CPU.  Pass
    ``device="cpu"`` to run on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "device='cpu' is passed")
    return dev


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would track an output computed from ``tensors``:
    a kernel wrapper whose output has no ``grad_fn`` must refuse then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor?  (None exists unless ``torch.distributed.tensor``
    was imported, so single-device paths never import it.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


#: A tensor a kernel call allocates: its shape and dtype.
Alloc = Tuple[Tuple[int, ...], torch.dtype]


class Allocs(NamedTuple):
    """What one kernel call allocates on its device: the tensors it returns,
    the temporaries it frees before it returns, and the workspace its
    wrapper keeps for later calls (allocated again only to grow).  The
    launchers allocate from it and the kernels' fake implementations
    (``kernels.meta``) mirror it, so the two cannot drift."""
    outputs: Tuple[Alloc, ...]
    temps: Tuple[Alloc, ...] = ()
    workspace: Tuple[Alloc, ...] = ()


def alloc_bytes(allocs) -> int:
    """The bytes of ``(shape, dtype)`` pairs."""
    total = 0
    for shape, dtype in allocs:
        n = 1
        for d in shape:
            n *= d
        total += n * dtype.itemsize
    return total


def empty(alloc: Alloc, device) -> torch.Tensor:
    """An uninitialised tensor of ``alloc`` on ``device``."""
    shape, dtype = alloc
    return torch.empty(shape, dtype=dtype, device=device)
