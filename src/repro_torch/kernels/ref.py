"""Plain torch oracle for the flash-attention kernel (the allclose ground
truth), the port of ``repro.kernels.ref.flash_attention_ref``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive softmax attention; q: (B, H, Sq, D); k/v: (B, Hkv, Skv, D).

    ``window > 0`` masks keys ``window`` or more positions older than the
    query (0 disables it, as in the Pallas kernel).
    """
    B, H, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)  # rows with no valid key → all-zero output
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
