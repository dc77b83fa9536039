"""Gradient compression with error feedback — the port of
``repro/distributed/grad_compress.py``.

The reference casts gradients to bf16 before the cross-pod reduction and
keeps the quantization residual in an f32 accumulator.  On one device
there is no reduction, but ``TrainLoopConfig.grad_compress`` still applies
the same round trip, so a run computes the same numbers as the
reference's.  Trees are nested dicts of tensors.

    ef = init_error_feedback(params)
    grads, ef = compress_with_feedback(grads, ef)
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


def compress_grads(grads):
    """Stateless bf16 round-trip: halves reduction bytes for f32 grads."""
    return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads, residual) -> Tuple[Any, Any]:
    """bf16-compress (g + residual); carry the quantization error forward."""
    def one(g, r):
        target = g.float() + r
        sent = target.to(torch.bfloat16).float()
        return sent.to(g.dtype), target - sent

    pairs = tree_map(one, grads, residual)
    return tree_map_pairs(pairs, 0), tree_map_pairs(pairs, 1)


def tree_map_pairs(tree, i: int):
    """Element ``i`` of every (a, b) leaf of a tree of pairs."""
    if isinstance(tree, dict):
        return {k: tree_map_pairs(v, i) for k, v in tree.items()}
    return tree[i]
