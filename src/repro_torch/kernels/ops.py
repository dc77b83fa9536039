"""Dispatch to the hand-written kernels: the port's counterpart of
``repro.kernels.ops``.

A CUDA tensor goes to the kernel, which raises on what it does not take;
a CPU tensor goes to the kernel's plain torch version.  The choice follows
the tensor's device and nothing else: there is no fallback from the card.
The model's attention and Mamba1 blocks call this dispatcher, so on the
card the kernels are on the model's path.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import (QOffset,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, kv_chunk: int = 512,
                    q_offset: QOffset = 0):
    """(B, S, H, D) attention: the K1 kernel on CUDA, the plain version on
    the CPU (``kv_chunk`` sizes the plain version's chunks only)."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 kv_chunk=kv_chunk, q_offset=q_offset)


def ssm_scan(decay, inc, C, *, chunk: int = 256):
    """(B, S, d, N) selective scan → (B, S, d) f32: the K2 kernel on CUDA,
    the plain version on the CPU (``chunk`` sizes the plain version's work
    only)."""
    if decay.device.type == "cuda":
        return ssm_scan_cuda(decay, inc, C)
    if decay.device.type != "cpu":
        raise ValueError(f"ssm scan: no kernel for device {decay.device}")
    return ssm_scan_plain(decay, inc, C, chunk=chunk)
