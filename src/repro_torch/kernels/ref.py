"""Plain torch oracles for the kernels (the allclose ground truth), the
port of ``repro.kernels.ref``."""
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


def ssm_scan_ref(decay, inc, C):
    """Sequential SSM recurrence; decay/inc: (B,S,d,N); C: (B,S,N) → y:
    (B,S,d) f32, one step at a time."""
    decay, inc, C = decay.float(), inc.float(), C.float()
    B, S, d, N = decay.shape
    h = torch.zeros((B, d, N), dtype=torch.float32, device=decay.device)
    ys = []
    for t in range(S):
        h = decay[:, t] * h + inc[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, 1)
