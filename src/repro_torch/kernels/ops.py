"""Dispatch to the hand-written kernels: the port's counterpart of
``repro.kernels.ops``.

A CUDA tensor goes to the kernel, which raises on what it does not take;
a CPU tensor goes to the kernel's plain torch version.  The choice follows
the tensor's device and nothing else: there is no fallback from the card.
The model's attention and Mamba1 blocks call this dispatcher, so on the
card the kernels are on the model's path.

Gradients: on the card, attention whose q, k or v requires grad goes
through :class:`FlashAttentionFunction`, K1's forward with its log-sum-exp
and K1's backward kernels; a case they do not cover (the decode kernel, a
query offset held in a tensor, a head dim the backward lacks) raises
before the forward launches.  The fused Mamba1 scan whose
inputs require grad goes through :class:`Mamba1ScanFunction`, the fused
K2 forward (writing the states its backward needs) and K2's backward
kernel.  The unfused K2 (:func:`ssm_scan`) has no backward, on purpose: no
path trains through it, and it raises on inputs that require grad.  On
the CPU autograd differentiates the plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, QOffset,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.ssm_scan import (mamba1_scan_plain,
                                          ssm_scan_bwd_cuda, ssm_scan_cuda,
                                          ssm_scan_fused_cuda, ssm_scan_plain,
                                          states_shape)
from repro_torch.runtime import needs_grad


class FlashAttentionFunction(torch.autograd.Function):
    """K1 under autograd: the prefill kernel with its log-sum-exp forward,
    the three backward kernels backward.  ``torch.utils.checkpoint``
    re-runs the forward, so a remat'd layer launches it twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                q_offset: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(),
                                              lse, **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, kv_chunk: int = 512,
                    q_offset: QOffset = 0):
    """(B, S, H, D) attention: the K1 kernels on CUDA (forward, and the
    backward when q, k or v requires grad), the plain version on the CPU
    (``kv_chunk`` sizes the plain version's chunks only)."""
    if q.device.type == "cuda":
        if needs_grad(q, k, v):
            if q.shape[1] == 1 or isinstance(q_offset, torch.Tensor):
                raise NotImplementedError(
                    "flash attention: no backward kernel for the decode "
                    "kernel (Sq = 1) or a query offset held in a tensor")
            if q.shape[-1] not in BWD_HEAD_DIMS:   # before the forward runs
                raise ValueError(
                    f"flash attention: no backward kernel for head dim "
                    f"{q.shape[-1]} (takes {BWD_HEAD_DIMS})")
            return FlashAttentionFunction.apply(q, k, v, causal, window,
                                                int(q_offset))
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


class Mamba1ScanFunction(torch.autograd.Function):
    """The fused K2 scan under autograd: the fused forward kernel, writing
    the state every ``STATE_EVERY`` steps, forward; K2's backward kernel
    backward, with dA for A (autograd carries it on to ``A_log``).
    ``torch.utils.checkpoint`` re-runs the forward, so a remat'd layer
    launches it twice a step and writes its states twice."""

    @staticmethod
    def forward(ctx, x, dt, Bs, Cs, A):
        states = torch.empty(states_shape(*x.shape, A.shape[1]),
                             dtype=torch.float32, device=x.device)
        y = ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
        ctx.save_for_backward(x, dt, Bs, Cs, A, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, Bs, Cs, A, states = ctx.saved_tensors
        return ssm_scan_bwd_cuda(x, dt, Bs, Cs, A,
                                 dy.float().contiguous(), states)


def mamba1_scan(x, dt, Bs, Cs, A, *, chunk: int = 256):
    """The fused Mamba1 core from h_0 = 0 → y (B, S, d) f32.  On CUDA the
    fused K2 kernel: through :class:`Mamba1ScanFunction` (states written,
    the backward kernel behind it) when an input requires grad, alone
    otherwise.  On the CPU the plain version, which autograd
    differentiates (``chunk`` sizes its work only)."""
    if x.device.type == "cuda":
        if needs_grad(x, dt, Bs, Cs, A):
            return Mamba1ScanFunction.apply(x, dt, Bs, Cs, A)
        return ssm_scan_fused_cuda(x, dt, Bs, Cs, A)
    if x.device.type != "cpu":
        raise ValueError(f"mamba1 scan: no kernel for device {x.device}")
    return mamba1_scan_plain(x, dt, Bs, Cs, A, chunk=chunk)
