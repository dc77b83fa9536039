"""The weights of a cell, made by the harness from ``--seed`` on the
device: one ``torch.Generator`` on the card, one draw a stacked leaf
(about a dozen calls), in the port's parameter layout and the
distributions of ``counts.model.leaf_specs``.  The same seed on the same
device gives the same weights, so the check after the window makes them
again instead of keeping a copy."""
from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.counts.model import leaf_specs


def make_flat(run: Dict, seed: int, device, dtype=torch.float32) \
        -> Dict[str, torch.Tensor]:
    """name -> tensor, each drawn in float32 and cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, init) in leaf_specs(run).items():
        kind = init[0]
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32).mul_(init[1])
        elif kind == "zeros":
            t = torch.zeros(shape, device=device, dtype=torch.float32)
        elif kind == "ones":
            t = torch.ones(shape, device=device, dtype=torch.float32)
        elif kind == "uniform":
            t = torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(2).sub_(1).mul_(init[1])
        elif kind == "dt_bias":
            lo, hi, floor = init[1:]
            u = torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float32)
            dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
            dt = dt.clamp_(min=floor)
            t = dt + torch.log(-torch.expm1(-dt))      # softplus⁻¹(dt)
        elif kind == "log_arange":
            row = torch.log(torch.arange(1, init[1] + 1, device=device,
                                         dtype=torch.float32))
            t = row.expand(shape).contiguous()
        else:
            raise ValueError(f"{name}: unknown init {init}")
        out[name] = t if dtype == torch.float32 else t.to(dtype)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The port's nested dict from dotted names."""
    tree: Dict = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted names -> leaves of a nested dict, in sorted key order."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def make(run: Dict, seed: int, device, dtype=torch.float32) -> Dict:
    return nest(make_flat(run, seed, device, dtype))
