"""Bring the JAX package's parameters into the port.

``params_from_numpy`` takes a tree of numpy arrays (what ``np.asarray``
gives for each leaf of a JAX parameter tree) and returns the same tree of
torch tensors.  bfloat16 and float8 arrays carry ``ml_dtypes`` dtypes that
torch cannot read directly; their bytes move through a same-width integer
view, so no ``ml_dtypes`` import is needed here.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manifest import dtype_from_name
from repro_torch.runtime import resolve_device

_INT_VIEW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def array_to_tensor(a) -> torch.Tensor:
    """One numpy array → a CPU tensor with the same dtype and bytes."""
    a = np.ascontiguousarray(np.asarray(a))
    name = a.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        raw = torch.from_numpy(a.view(_INT_VIEW[a.dtype.itemsize]).copy())
        return raw.view(dtype_from_name(name))
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None) \
        -> Any:
    """The tree with every array leaf as a tensor on ``device``; floating
    leaves are cast to ``dtype`` when it is given."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev, dtype) for v in tree)
    t = array_to_tensor(tree).to(dev)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t
