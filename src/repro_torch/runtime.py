"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import sys

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
