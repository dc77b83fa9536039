"""The kernels on the ``meta`` device: what the dry-run traces in their
place.

A ``meta`` tensor holds a shape and a dtype and no data, so a step traced
on meta tensors (``repro_torch.launch.dryrun``) allocates what the card
would and computes nothing.  The model reaches the hand-written kernels
through ``kernels.ops``, which sends a meta tensor here: each kernel entry
is a ``torch.library.custom_op`` of namespace ``repro`` whose fake
implementation allocates exactly what the CUDA launcher allocates
(``flash_attention.fwd_allocs``, ``bwd_allocs``; ``ssm_scan.scan_allocs``,
``fused_allocs``, ``bwd_allocs``: the launchers allocate from the same
functions), and whose FLOP formula
(``torch.utils.flop_counter.register_flop_formula``) counts what the
kernel computes:

* K1 (``k1_fwd``, ``k1_bwd``): the attended (query, key) pairs under the
  causal, window and offset masks (:func:`attended_pairs`), 4·H·D FLOPs a
  pair forward (q·k and p·v) and 10·H·D backward (its five products:
  q·k recomputed, dV, dP, dQ, dK), times B.  A query offset held in a
  tensor (a decode step's position on the device) has no value on meta:
  the query is counted at the cache's last position, the most a step
  attends.
* K2 (``k2``, ``k2_fused``, ``k2_bwd``), the recurrence h_t = decay_t·h +
  inc_t and y_t = Σ_n h_t·C_t, counted a state element (B·S·d·N of them):
  4 FLOPs unfused (the update's multiply and add, the output's); 6 fused
  (decay's dt·A and inc's dt·x·B beside those, the exponential not
  counted); 20 backward (the fused forward's 6 recomputed from the stored
  states, 14 for the carried gradient g_t = dy_t·C_t + decay_{t+1}·g_{t+1}
  and dx, ddt, dB, dC, dA).  It is f32 work on CUDA cores whatever the
  inputs' dtype.

The real implementations raise: only meta tensors reach these ops, and
CUDA tensors go to the launchers (``kernels.ops``).  The decode kernel's
workspace is the launcher's per (device, stream), kept across calls: the
dry-run's counter (``repro_torch.analysis.costs``) counts it once, as
persistent bytes, from ``fwd_allocs``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.runtime import Allocs, empty

#: FLOPs a state element of K2: unfused, fused forward, backward.
K2_FLOPS = {"k2": 4, "k2_fused": 6, "k2_bwd": 20}


def attended_pairs(Sq: int, Skv: int, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0) -> int:
    """(query, key) pairs attention computes for one (batch row, head):
    query i at position ``q_offset + i`` attends key j < Skv where j is at
    most its position (``causal``) and less than ``window`` positions
    older (a window)."""
    p = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv - 1, p) if causal else np.full(Sq, Skv - 1)
    lo = (np.maximum(0, p - window + 1) if window is not None
          else np.zeros(Sq, dtype=np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _qkv_dims(q_shape, k_shape):
    B, Sq, H, D = q_shape
    Skv, Hkv = k_shape[1], k_shape[2]
    return B, Sq, H, D, Skv, Hkv


def k1_flops(q_shape, k_shape, causal, window, q_offset, offset_held,
             per_pair: int) -> int:
    """``per_pair``·H·D FLOPs for each attended pair of each batch row."""
    B, Sq, H, D, Skv, _ = _qkv_dims(q_shape, k_shape)
    if offset_held:
        q_offset = Skv - Sq
    return per_pair * B * H * D * attended_pairs(Sq, Skv, causal, window,
                                                 q_offset)


def _made(allocs: Allocs, device) -> List[torch.Tensor]:
    """The outputs of ``allocs``, its temporaries made and dropped, as the
    launcher does."""
    for a in allocs.temps:
        empty(a, device)
    return [empty(a, device) for a in allocs.outputs]


def _meta_only(name: str):
    raise ValueError(f"repro::{name} takes meta tensors; CUDA tensors go to "
                     f"the kernel's launcher in kernels.ops")


# ------------------------------------------------------------------ K1 --

@torch.library.custom_op("repro::k1_fwd", mutates_args=())
def k1_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], q_offset: int,
           q_offset_t: Optional[torch.Tensor], with_lse: bool,
           out_f32: bool) -> List[torch.Tensor]:
    """K1's forward: [out] or [out, lse]."""
    _meta_only("k1_fwd")


@k1_fwd.register_fake
def _k1_fwd_fake(q, k, v, causal, window, q_offset, q_offset_t, with_lse,
                 out_f32):
    return _made(fa.fwd_allocs(*_qkv_dims(q.shape, k.shape), q.dtype,
                               with_lse=with_lse, out_f32=out_f32), q.device)


@register_flop_formula(torch.ops.repro.k1_fwd)
def _k1_fwd_flops(q_shape, k_shape, v_shape, causal, window, q_offset,
                  q_offset_t, with_lse, out_f32, out_shape=None, **kw):
    return k1_flops(q_shape, k_shape, causal, window, q_offset,
                    q_offset_t is not None, 4)


@torch.library.custom_op("repro::k1_bwd", mutates_args=())
def k1_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
           causal: bool, window: Optional[int],
           q_offset: int) -> List[torch.Tensor]:
    """K1's backward: [dq, dk, dv]."""
    _meta_only("k1_bwd")


@k1_bwd.register_fake
def _k1_bwd_fake(q, k, v, out, dout, lse, causal, window, q_offset):
    return _made(fa.bwd_allocs(*_qkv_dims(q.shape, k.shape), q.dtype),
                 q.device)


@register_flop_formula(torch.ops.repro.k1_bwd)
def _k1_bwd_flops(q_shape, k_shape, v_shape, out_shape_, dout_shape,
                  lse_shape, causal, window, q_offset, out_shape=None, **kw):
    return k1_flops(q_shape, k_shape, causal, window, q_offset, False, 10)


# ------------------------------------------------------------------ K2 --

@torch.library.custom_op("repro::k2", mutates_args=())
def k2(decay: torch.Tensor, inc: torch.Tensor,
       C: torch.Tensor) -> torch.Tensor:
    """The unfused K2: y."""
    _meta_only("k2")


@k2.register_fake
def _k2_fake(decay, inc, C):
    return _made(ss.scan_allocs(*decay.shape), decay.device)[0]


@register_flop_formula(torch.ops.repro.k2)
def _k2_flops(decay_shape, inc_shape, c_shape, out_shape=None, **kw):
    B, S, d, N = decay_shape
    return K2_FLOPS["k2"] * B * S * d * N


@torch.library.custom_op("repro::k2_fused", mutates_args=())
def k2_fused(x: torch.Tensor, dt: torch.Tensor, Bs: torch.Tensor,
             Cs: torch.Tensor, A: torch.Tensor,
             with_states: bool) -> List[torch.Tensor]:
    """The fused K2 forward: [y] or [y, states]."""
    _meta_only("k2_fused")


@k2_fused.register_fake
def _k2_fused_fake(x, dt, Bs, Cs, A, with_states):
    return _made(ss.fused_allocs(*x.shape, A.shape[1], with_states),
                 x.device)


@register_flop_formula(torch.ops.repro.k2_fused)
def _k2_fused_flops(x_shape, dt_shape, b_shape, c_shape, a_shape,
                    with_states, out_shape=None, **kw):
    B, S, d = x_shape
    return K2_FLOPS["k2_fused"] * B * S * d * a_shape[1]


@torch.library.custom_op("repro::k2_bwd", mutates_args=())
def k2_bwd(x: torch.Tensor, dt: torch.Tensor, Bs: torch.Tensor,
           Cs: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
           states: torch.Tensor) -> List[torch.Tensor]:
    """K2's backward: [dx, ddt, dB, dC, dA]."""
    _meta_only("k2_bwd")


@k2_bwd.register_fake
def _k2_bwd_fake(x, dt, Bs, Cs, A, dy, states):
    return _made(ss.bwd_allocs(*x.shape, A.shape[1], x.dtype, dt.dtype,
                               Bs.dtype, Cs.dtype), x.device)


@register_flop_formula(torch.ops.repro.k2_bwd)
def _k2_bwd_flops(x_shape, dt_shape, b_shape, c_shape, a_shape, dy_shape,
                  states_shape, out_shape=None, **kw):
    B, S, d = x_shape
    return K2_FLOPS["k2_bwd"] * B * S * d * a_shape[1]


#: The ops, each with the function that gives its allocations from its
#: arguments (what ``analysis.costs`` adds at a call: temporaries and the
#: workspace, which no output shows).
OPS = {
    torch.ops.repro.k1_fwd.default: lambda q, k, v, causal, window, off, t,
    lse, f32: fa.fwd_allocs(*_qkv_dims(q.shape, k.shape), q.dtype,
                            with_lse=lse, out_f32=f32),
    torch.ops.repro.k1_bwd.default: lambda q, k, *a: fa.bwd_allocs(
        *_qkv_dims(q.shape, k.shape), q.dtype),
    torch.ops.repro.k2.default: lambda decay, inc, C: ss.scan_allocs(
        *decay.shape),
    torch.ops.repro.k2_fused.default: lambda x, dt, Bs, Cs, A, st:
    ss.fused_allocs(*x.shape, A.shape[1], st),
    torch.ops.repro.k2_bwd.default: lambda x, dt, Bs, Cs, A, *a:
    ss.bwd_allocs(*x.shape, A.shape[1], x.dtype, dt.dtype, Bs.dtype,
                  Cs.dtype),
}

#: Ops whose FLOPs are f32 work on CUDA cores, whatever their inputs.
F32_WORK = (torch.ops.repro.k2.default, torch.ops.repro.k2_fused.default,
            torch.ops.repro.k2_bwd.default)


# ------------------------------------------------ the launchers on meta --

def flash_attention_meta(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset=0,
                         with_lse: bool = False, out_f32: bool = False):
    """``flash_attention_cuda``'s contract on meta tensors: the checks the
    launcher makes, then :func:`k1_fwd`."""
    what = "flash attention (meta)"
    _, Sq, *_ = fa._check_qkv(q, k, v, what, device_type="meta")
    fa._check_window(window, what)
    if out_f32 and Sq != 1:
        raise ValueError(f"{what}: out_f32 is the decode kernel's (Sq = 1)")
    held = isinstance(q_offset, torch.Tensor)
    outs = torch.ops.repro.k1_fwd(q, k, v, bool(causal), window,
                                  0 if held else int(q_offset),
                                  q_offset if held else None, with_lse,
                                  out_f32)
    return tuple(outs) if with_lse else outs[0]


def flash_attention_bwd_meta(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0):
    """``flash_attention_bwd_cuda``'s contract on meta tensors."""
    what = "flash attention backward (meta)"
    _, _, _, D, _, _ = fa._check_qkv(q, k, v, what, device_type="meta")
    if D not in fa.BWD_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} (takes {fa.BWD_HEAD_DIMS})")
    return tuple(torch.ops.repro.k1_bwd(q, k, v, out, dout, lse,
                                        bool(causal), window, int(q_offset)))


def _check_scan(what, *tensors, N: int):
    if any(t.device.type != "meta" for t in tensors):
        raise ValueError(f"{what}: takes meta tensors")
    if not 1 <= N <= ss.MAX_STATE:
        raise ValueError(f"{what}: state size {N} (takes 1 to "
                         f"{ss.MAX_STATE})")


def ssm_scan_meta(decay, inc, C):
    """``ssm_scan_cuda``'s contract on meta tensors."""
    _check_scan("ssm scan (meta)", decay, inc, C, N=decay.shape[-1])
    return torch.ops.repro.k2(decay, inc, C)


def ssm_scan_fused_meta(x, dt, Bs, Cs, A, *, with_states: bool = False):
    """``ssm_scan_fused_cuda``'s on meta tensors: y, or (y, states)."""
    _check_scan("fused ssm scan (meta)", x, dt, Bs, Cs, A, N=A.shape[1])
    outs = torch.ops.repro.k2_fused(x, dt, Bs, Cs, A, with_states)
    return tuple(outs) if with_states else outs[0]


def ssm_scan_bwd_meta(x, dt, Bs, Cs, A, dy, states):
    """``ssm_scan_bwd_cuda``'s contract on meta tensors."""
    _check_scan("ssm scan backward (meta)", x, dt, Bs, Cs, A, dy, states,
                N=A.shape[1])
    return tuple(torch.ops.repro.k2_bwd(x, dt, Bs, Cs, A, dy, states))
