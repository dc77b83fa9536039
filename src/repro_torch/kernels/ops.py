"""Dispatch to the hand-written kernels: the port's counterpart of
``repro.kernels.ops``.

A CUDA tensor goes to the kernel, which raises on what it does not take;
a CPU tensor goes to the kernel's plain torch version; a ``meta`` tensor
(the dry-run's) goes to the kernel's custom op in ``kernels.meta``, which
allocates what the launcher allocates and computes nothing (never to the
plain version, whose chunked scores the kernels never allocate).  The
choice follows the tensor's device and nothing else: there is no fallback
from the card, and any other device raises.
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

DTensors (a model under a mesh): each entry runs the same dispatch on
every rank's local block through ``local_map``, with autograd intact.
Attention takes q sharded on heads (or not) and gives each rank the kv
heads of its own q heads; the fused scan takes x, dt and A sharded on
channels (d_inner), which the recurrence never mixes, with B and C made
whole first (they are the sums of every channel's projection).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, QOffset,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 lse_plain)
from repro_torch.kernels.meta import (flash_attention_bwd_meta,
                                      flash_attention_meta,
                                      ssm_scan_bwd_meta, ssm_scan_fused_meta,
                                      ssm_scan_meta)
from repro_torch.kernels.ssm_scan import (fused_allocs, mamba1_scan_plain,
                                          ssm_scan_bwd_cuda, ssm_scan_cuda,
                                          ssm_scan_fused_cuda, ssm_scan_plain)
from repro_torch.runtime import empty, is_dtensor, needs_grad

#: The devices that have a kernel (``meta``: its custom op).
KERNEL_DEVICES = ("cuda", "meta")


def _on(t, cuda, meta):
    """The launcher for ``t``'s device: ``cuda``'s kernel, or on meta its
    custom op's ``meta``."""
    return cuda if t.device.type == "cuda" else meta


class FlashAttentionFunction(torch.autograd.Function):
    """K1 under autograd: the prefill kernel with its log-sum-exp forward,
    the three backward kernels backward (on meta tensors their custom
    ops).  ``torch.utils.checkpoint`` re-runs the forward, so a remat'd
    layer launches it twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                q_offset: int):
        out, lse = _on(q, flash_attention_cuda, flash_attention_meta)(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _on(q, flash_attention_bwd_cuda,
                         flash_attention_bwd_meta)(
            q, k, v, out, dout.contiguous(), lse, **ctx.masks)
        return dq, dk, dv, None, None, None


def _kv_for_local_heads(k, h0: int, Hl: int, H: int):
    """The kv heads (dim 2) that q heads [h0, h0 + Hl) of H read: a slice
    when the local heads are whole groups, else one kv head per q head
    (an index-select), so the kernel's h // (H / Hkv) maps each right."""
    Hkv = k.shape[2]
    rep = H // Hkv
    if Hl == H:
        return k
    if h0 % rep == 0 and Hl % rep == 0:
        return k[:, :, h0 // rep:(h0 + Hl) // rep]
    idx = torch.div(torch.arange(h0, h0 + Hl, device=k.device), rep,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def _sharded_attention(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's local blocks of the DTensors q
    (B, Sq, H, D) and k, v (B, Skv, Hkv, D): q keeps its batch and head
    shards, k and v follow q's batch shard and keep a head shard that
    lines up with q's (whole groups a rank), else are made whole over
    that mesh dim and each rank takes its q heads' kv heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    q_pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in q.placements]
    kv_pl, head_dims = [], []
    for i, p in enumerate(q_pl):
        if p.is_shard(2):
            n = mesh.size(i)
            aligned = Hkv % n == 0 and (H // n) % (H // Hkv) == 0
            kv_pl.append(Shard(2) if aligned else Replicate())
            if not aligned:
                head_dims.append(i)
        else:
            kv_pl.append(p)

    def local(ql, kl, vl):
        Hl = ql.shape[2]
        if head_dims:
            # local heads on a mesh dim whose kv heads were made whole
            coord = mesh.get_coordinate()
            h0, span = 0, H
            for i in range(mesh.ndim):
                if q_pl[i].is_shard(2):
                    span //= mesh.size(i)
                    h0 += coord[i] * span
            kl = _kv_for_local_heads(kl, h0, Hl, H)
            vl = _kv_for_local_heads(vl, h0, Hl, H)
        return fn(ql, kl, vl, **kw)

    # k and v whole over a dim whose ranks use some of their heads each:
    # each rank's gradient of them is a part of the sum
    kv_grad = [Partial() if i in head_dims else p
               for i, p in enumerate(kv_pl)]
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(
        q.redistribute(mesh, q_pl), k.redistribute(mesh, kv_pl),
        v.redistribute(mesh, kv_pl))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, kv_chunk: int = 512,
                    q_offset: QOffset = 0):
    """(B, S, H, D) attention: the K1 kernels on CUDA (forward, and the
    backward when q, k or v requires grad), the plain version on the CPU
    (``kv_chunk`` sizes the plain version's chunks only).  DTensors: the
    same on each rank's local heads (:func:`_sharded_attention`)."""
    if is_dtensor(q):
        return _sharded_attention(flash_attention, q, k, v, causal=causal,
                                  window=window, kv_chunk=kv_chunk,
                                  q_offset=q_offset)
    if q.device.type in KERNEL_DEVICES:
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
        return _on(q, flash_attention_cuda, flash_attention_meta)(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 kv_chunk=kv_chunk, q_offset=q_offset)


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: QOffset = 0,
                        out_f32: bool = False):
    """``(out, lse)`` of attention without gradient, lse (B, H, Sq) f32 as
    :func:`lse_plain` defines it: K1 on CUDA (for Sq = 1 the decode
    kernel, which writes it as it merges its splits, and with
    ``out_f32`` its output in f32), the plain versions on the CPU (their
    output cast to f32 with ``out_f32``).  Sequence-parallel decode
    merges its shards by it."""
    if q.device.type in KERNEL_DEVICES:
        return _on(q, flash_attention_cuda, flash_attention_meta)(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            with_lse=True, out_f32=out_f32)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    return (out.float() if out_f32 else out,
            lse_plain(q, k, v, causal=causal, window=window,
                      q_offset=q_offset))


def _channel_local(fn, chan, whole, chan_dims):
    """``fn(*chan, *whole)`` on local blocks: the DTensors ``chan`` keep
    the first one's batch shard (dim 0) and channel shard (its dim
    ``chan_dims[0]``), each at its own channel dim ``chan_dims[i]`` (a
    parameter, channel dim 0, follows the channel shard alone); ``whole``
    follow the batch shard and are whole on every other mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    first = chan[0]
    mesh = first.device_mesh
    lead = chan_dims[0]
    base = [p if p.is_shard(0) or p.is_shard(lead) else Replicate()
            for p in first.placements]

    def pl_for(cdim):
        out = []
        for p in base:
            if p.is_shard(lead):
                out.append(Shard(cdim))
            elif p.is_shard(0) and cdim != 0:
                out.append(p)
            else:
                out.append(Replicate())
        return out

    chan_pl = [pl_for(c) for c in chan_dims]
    whole_pl = [[p if p.is_shard(0) else Replicate() for p in base]
                for _ in whole]
    # a whole input feeds each rank's channels: its gradient is a part of
    # the sum over the channel shards
    whole_grad = [[Partial() if b.is_shard(lead) else p
                   for b, p in zip(base, pl)] for pl in whole_pl]
    # a parameter (no batch dim) meets one batch shard a rank: its
    # gradient is a part of the sum over the batch shards
    chan_grad = [[Partial() if c == 0 and b.is_shard(0) else p
                  for b, p in zip(base, pl)]
                 for c, pl in zip(chan_dims, chan_pl)]
    args = [t.redistribute(mesh, pl) for t, pl in zip(chan, chan_pl)]
    args += [t.redistribute(mesh, pl) for t, pl in zip(whole, whole_pl)]
    return local_map(fn, out_placements=chan_pl[0],
                     in_placements=tuple(chan_pl + whole_pl),
                     in_grad_placements=tuple(chan_grad + whole_grad),
                     device_mesh=mesh)(*args)


def ssm_scan(decay, inc, C, *, chunk: int = 256):
    """(B, S, d, N) selective scan → (B, S, d) f32: the K2 kernel on CUDA,
    the plain version on the CPU (``chunk`` sizes the plain version's work
    only)."""
    if decay.device.type == "cuda":
        return ssm_scan_cuda(decay, inc, C)
    if decay.device.type == "meta":
        return ssm_scan_meta(decay, inc, C)
    if decay.device.type != "cpu":
        raise ValueError(f"ssm scan: no kernel for device {decay.device}")
    return ssm_scan_plain(decay, inc, C, chunk=chunk)


class Mamba1ScanFunction(torch.autograd.Function):
    """The fused K2 scan under autograd: the fused forward kernel, writing
    the state every ``STATE_EVERY`` steps, forward; K2's backward kernel
    backward, with dA for A (autograd carries it on to ``A_log``).
    ``torch.utils.checkpoint`` re-runs the forward, so a remat'd layer
    launches it twice a step and writes its states twice.  On meta tensors
    the same through the kernels' custom ops."""

    @staticmethod
    def forward(ctx, x, dt, Bs, Cs, A):
        if x.device.type == "cuda":
            states = empty(fused_allocs(*x.shape, A.shape[1],
                                        with_states=True).outputs[1],
                           x.device)
            y = ssm_scan_fused_cuda(x, dt, Bs, Cs, A, states=states)
        else:
            y, states = ssm_scan_fused_meta(x, dt, Bs, Cs, A,
                                            with_states=True)
        ctx.save_for_backward(x, dt, Bs, Cs, A, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, Bs, Cs, A, states = ctx.saved_tensors
        return _on(x, ssm_scan_bwd_cuda, ssm_scan_bwd_meta)(
            x, dt, Bs, Cs, A, dy.float().contiguous(), states)


def mamba1_scan(x, dt, Bs, Cs, A, *, chunk: int = 256):
    """The fused Mamba1 core from h_0 = 0 → y (B, S, d) f32.  On CUDA the
    fused K2 kernel: through :class:`Mamba1ScanFunction` (states written,
    the backward kernel behind it) when an input requires grad, alone
    otherwise.  On the CPU the plain version, which autograd
    differentiates (``chunk`` sizes its work only).  DTensors: on each
    rank's channels, B and C whole."""
    if is_dtensor(x):
        return _channel_local(
            lambda x_, dt_, A_, b_, c_: mamba1_scan(x_, dt_, b_, c_, A_,
                                                    chunk=chunk),
            (x, dt, A), (Bs, Cs), (2, 2, 0))
    if x.device.type in KERNEL_DEVICES:
        if needs_grad(x, dt, Bs, Cs, A):
            return Mamba1ScanFunction.apply(x, dt, Bs, Cs, A)
        return _on(x, ssm_scan_fused_cuda, ssm_scan_fused_meta)(
            x, dt, Bs, Cs, A)
    if x.device.type != "cpu":
        raise ValueError(f"mamba1 scan: no kernel for device {x.device}")
    return mamba1_scan_plain(x, dt, Bs, Cs, A, chunk=chunk)
