"""Plain AdamW with global-norm clipping, written from its equations: the
update the port's training step applies (``AdamWConfig``'s defaults:
warmup then cosine schedule, decoupled weight decay, moments in f32)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

#: The optimizer's settings, as the benchmark's training step is built.
DEFAULTS = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                clip_norm=1.0, warmup_steps=100, total_steps=10_000,
                min_lr_ratio=0.1)


def lr_at(count: int, c=DEFAULTS) -> float:
    """The learning rate of the ``count``-th update (count from 1)."""
    warm = min((count + 1) / max(1, c["warmup_steps"]), 1.0)
    t = min(max((count - c["warmup_steps"])
                / max(1, c["total_steps"] - c["warmup_steps"]), 0.0), 1.0)
    cos = c["min_lr_ratio"] + (1 - c["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return c["lr"] * warm * cos


class AdamW:
    """State and update over a flat dict of f32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], c=DEFAULTS):
        self.c = c
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update in place; returns the pre-clip global norm, the clip
        scale and each leaf's gradient norm as the optimizer applies it."""
        c = self.c
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(1.0, c["clip_norm"] / max(gnorm, 1e-9))
        self.count += 1
        lr = lr_at(self.count, c)
        c1 = 1 - c["b1"] ** self.count
        c2 = 1 - c["b2"] ** self.count
        leaf_norms: List[float] = []
        for k, p in params.items():
            g = grads[k] * scale
            leaf_norms.append(float(g.norm()))
            self.mu[k].mul_(c["b1"]).add_((1 - c["b1"]) * g)
            self.nu[k].mul_(c["b2"]).add_((1 - c["b2"]) * g.square())
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + c["eps"])
            p.sub_(lr * (upd + c["weight_decay"] * p))
        return {"grad_norm": gnorm, "scale": scale,
                "leaf_norms": dict(zip(params, leaf_norms))}
