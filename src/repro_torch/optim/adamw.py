"""AdamW with global-norm clipping — the port of ``repro/optim/adamw.py``.

The arithmetic is the reference's: gradients scaled by min(1, clip /
global norm), moments in f32, bias corrections and the learning rate from
the incremented count in f32, decoupled weight decay on the f32 master
weights.  The reference returns new trees; here :func:`update` writes the
parameters and moments IN PLACE (no second copy of a 20 GB state on the
card) and frees each gradient once it is used, and still returns
``(params, state, stats)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple

import torch

from repro_torch.runtime import is_dtensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor   # 0-d int32


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (the parameter trees)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts, in sorted key order (the reference's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def init(params) -> AdamWState:
    """Zero moments beside each parameter (same device, f32; a DTensor
    parameter's moments are DTensors placed like it) and count 0 (with
    DTensor parameters, a DTensor every rank holds whole)."""
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=torch.float32, memory_format=torch.contiguous_format)
    first = leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        from repro_torch.distributed import sharding
        count = sharding.distribute(count, first.device_mesh, sharding.P())
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=count)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (f32, on step's
    device)."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place; returns (params, state, stats).

    ``grads`` is a tree like ``params`` (f32 or the parameter's dtype); its
    leaves are dropped from the tree as they are used, so the step's peak
    holds one gradient less at a time.  ``stats`` holds the pre-clip
    ``grad_norm`` and the step's ``lr`` as 0-d f32 tensors.
    """
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm > 0 else torch.ones_like(gnorm))
    count = state.count + 1
    lr = schedule(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(path, p, mu, nu, gtree):
        g = gtree.pop(path).float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step_ = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step_ + cfg.weight_decay * p32))

    def walk(p, mu, nu, g):
        for k in sorted(p):
            if isinstance(p[k], dict):
                walk(p[k], mu[k], nu[k], g[k])
            else:
                upd(k, p[k], mu[k], nu[k], g)

    walk(params, state.mu, state.nu, grads)
    state.count.copy_(count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
