"""Building-block layers of the transformer: norms, RoPE, GQA attention
(prefill and decode), MLPs and the token-choice MoE block — the port of
``repro/models/layers.py``.

Plain functions over explicit parameter dicts with the reference's names,
shapes and layouts: 3-D attention projections ``(d_model, heads,
head_dim)``, so one checkpoint loads in both packages.  The reference pads
phantom heads for tensor parallelism (``sharding.padded_heads``); on one
device that padding is the identity and is left out.

Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
the K1 CUDA kernel on the card, its plain torch version on the CPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
# The counterpart of ``layers.flash_attention`` lives beside the kernel it
# is the plain version of.
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_plain as flash_attention)

Params = Dict[str, Any]


class _ShapesOnly:
    """Stands in for a generator where only shapes and dtypes are wanted:
    every draw is an empty tensor on the meta device."""
    device = torch.device("meta")


SHAPES_ONLY = _ShapesOnly()


def _init(gen: torch.Generator, shape, scale=None, *, stack: int = 0,
          dtype=torch.float32):
    """Normal(0, scale²) weights drawn in f32 and cast to ``dtype``,
    ``scale`` defaulting to 1/sqrt(shape[0]); ``stack > 0`` draws that
    many layers' copies along a leading axis."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = ((stack,) if stack else ()) + tuple(shape)
    if gen is SHAPES_ONLY:
        return torch.empty(full, dtype=dtype, device="meta")
    return (torch.randn(full, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ------------------------------------------------------------------- norms --
def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def init_rms_norm(d: int, *, stack: int = 0, device=None,
                  dtype=torch.float32):
    """Stored as an offset from 1 (gemma-style)."""
    return torch.zeros(((stack,) if stack else ()) + (d,), dtype=dtype,
                       device=device)


# -------------------------------------------------------------------- rope --
def rope(x, positions, base: float = 10_000.0):
    """Rotary embedding; x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq  # (..., S, 1, half)
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention --
def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool, *,
                   stack: int = 0, dtype=torch.float32) -> Params:
    kw = dict(stack=stack, dtype=dtype)
    p = {
        "wq": _init(gen, (d_model, n_heads, head_dim), **kw),
        "wk": _init(gen, (d_model, n_kv, head_dim), **kw),
        "wv": _init(gen, (d_model, n_kv, head_dim), **kw),
        "wo": _init(gen, (n_heads, head_dim, d_model),
                    scale=1.0 / math.sqrt(n_heads * head_dim), **kw),
    }
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, device=gen.device, **kw)
        p["k_norm"] = init_rms_norm(head_dim, device=gen.device, **kw)
    return p


def _heads(x, w):
    """einsum("bsd,dhk->bshk") as one matmul on the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, rope_base,
                 eps=1e-6):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    if positions is not None:
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
    return q, k, v


def _output_proj(p, out, n_heads, d_model):
    """out: (B, S, H, hd) → (B, S, d_model)."""
    h, k, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].reshape(h * k, d)


def attention_block(p: Params, x, *, n_heads, n_kv, head_dim, rope_base,
                    causal=True, window=None, kv_chunk=512, positions=None,
                    eps=1e-6):
    """Full attention over a sequence (prefill)."""
    B, S, d_model = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions,
                           rope_base, eps)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              kv_chunk=kv_chunk)
    return _output_proj(p, out, n_heads, d_model)


def attention_decode(p: Params, x, cache_k, cache_v, pos, *, n_heads, n_kv,
                     head_dim, rope_base, window=None, eps=1e-6,
                     kv_chunk=512, pos_index: Optional[torch.Tensor] = None):
    """One-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, Hkv, D); pos: 0-d int32 tensor —
    the number of tokens already in the cache.  Returns (out, cache_k,
    cache_v).  Unlike the reference's functional update, the new key and
    value are written into ``cache_k``/``cache_v`` IN PLACE at ``pos``,
    with a device-side index (``pos_index``, ``pos`` as a 1-element int64
    tensor; derived here when not given), so the step never reads ``pos``
    on the host.
    """
    B = x.shape[0]
    d_model = x.shape[-1]
    positions = pos.expand(B, 1)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions,
                           rope_base, eps)
    if pos_index is None:
        pos_index = pos.reshape(1).long()
    cache_k.index_copy_(1, pos_index, k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos_index, v.to(cache_v.dtype))
    out = ops.flash_attention(q, cache_k, cache_v, causal=True,
                              window=window, kv_chunk=kv_chunk, q_offset=pos)
    return _output_proj(p, out, n_heads, d_model), cache_k, cache_v


# --------------------------------------------------------------------- mlp --
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str, *,
             stack: int = 0, dtype=torch.float32) -> Params:
    kw = dict(stack=stack, dtype=dtype)
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _init(gen, (d_model, d_ff), **kw)
    p["w_up"] = _init(gen, (d_model, d_ff), **kw)
    p["w_down"] = _init(gen, (d_ff, d_model), **kw)
    return p


def _hidden(mlp_type: str, up, gate=None):
    """An MLP's hidden activation from its up projection (and, in the gated
    types, its gate projection)."""
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu(gate) if mlp_type == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        return act * up
    if mlp_type == "relu2":  # nemotron squared-ReLU
        return torch.square(F.relu(up))
    if mlp_type == "gelu":
        return F.gelu(up, approximate="tanh")
    raise ValueError(mlp_type)


def mlp_block(p: Params, x, mlp_type: str):
    gate = x @ p["w_gate"] if "w_gate" in p else None
    return _hidden(mlp_type, x @ p["w_up"], gate) @ p["w_down"]


# --------------------------------------------------------------------- moe --
def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             mlp_type: str, shared_expert: bool, *, stack: int = 0,
             dtype=torch.float32) -> Params:
    """The reference's ``init_moe``: experts stacked on a leading axis, so
    ``w_up`` and ``w_gate`` (n_experts, d_model, d_ff) take its scale
    1/sqrt(n_experts) (``_init`` scales by the first axis of the unstacked
    shape), ``w_down`` 1/sqrt(d_ff), the router 0.02."""
    kw = dict(stack=stack, dtype=dtype)
    p = {
        "router": _init(gen, (d_model, n_experts), scale=0.02, **kw),
        "w_up": _init(gen, (n_experts, d_model, d_ff), **kw),
        "w_down": _init(gen, (n_experts, d_ff, d_model),
                        scale=1.0 / math.sqrt(d_ff), **kw),
    }
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _init(gen, (n_experts, d_model, d_ff), **kw)
    if shared_expert:
        p["shared"] = init_mlp(gen, d_model, d_ff, mlp_type, **kw)
    return p


def stable_top_k(x, k: int):
    """The ``k`` largest entries of each row of ``x`` and their indices,
    largest first, ties to the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` breaks ties in no fixed order)."""
    values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens (the
    reference's ``C``): a decode step of 4 tokens of granite gets 1."""
    return max(1, int(capacity_factor * n_tokens * top_k / n_experts))


class MoeRoute(NamedTuple):
    """Where a call's tokens go: ``probs`` (T, E) f32, each token's ``ids``
    (T, k) and normalized ``gates``, each assignment's slot ``pos`` and
    whether it is kept (``keep``), in (token, choice) order, the
    assignments to each expert (``counts``, dropped ones included) and the
    slots per expert (``capacity``)."""
    probs: torch.Tensor
    gates: torch.Tensor
    ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    capacity: int


def moe_route(router, xt, *, top_k: int, capacity_factor: float = 1.25) \
        -> MoeRoute:
    """The reference's routing of tokens ``xt`` (T, D): softmax of the
    router's logits in f32, each token's ``top_k`` experts (ties to the
    lower expert), gates normalized; each assignment's slot is the count of
    earlier ones to its expert in (token, choice) order, and those past the
    capacity (:func:`moe_capacity`) are dropped."""
    T, E = xt.shape[0], router.shape[-1]
    probs = torch.softmax((xt @ router).float(), dim=-1)
    gates, ids = stable_top_k(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    C = moe_capacity(T, E, top_k, capacity_factor)
    flat_ids = ids.reshape(-1)
    # Each assignment's slot is the count of earlier assignments to its
    # expert: a running count over the (E, T*k) one-hot, expert row after
    # expert row (one 1-D scan), less the assignments to the experts
    # before.  (The reference's scan down the (T*k, E) one-hot's token
    # axis runs on E threads of the card.)
    onehot = torch.arange(E, device=xt.device)[:, None] == flat_ids
    running = onehot.reshape(-1).cumsum(0).view(E, -1)
    ends = running[:, -1]
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    pos = running.gather(0, flat_ids[None])[0] - (ends - counts)[flat_ids] - 1
    return MoeRoute(probs, gates, ids, pos, pos < C, counts, C)


def moe_block(p: Params, x, *, n_experts: int, top_k: int, mlp_type: str,
              capacity_factor: float = 1.25, shared_expert: bool = False):
    """Token-choice top-k MoE with capacity buckets, as the reference's
    ``moe_block``.  Returns ``(y, aux)``: y (B, S, D) in x's dtype, aux the
    f32 load-balance loss.

    The tokens are routed by :func:`moe_route`; a dropped assignment's
    token keeps only the residual path.  Kept tokens are scattered,
    adding, into an (E, C, D) buffer (a dropped assignment adds zeros into
    slot 0, as in the reference), the expert FFNs run as batched matmuls
    on it, and each token sums its experts' outputs scaled by its gates.
    The scatter and the gather address the buffer's (E * C) rows by one
    index (``index_add``, ``index_select``): no row receives two nonzero
    rows, so the sums are exact in any order.  The reference pads the
    expert axis for expert parallelism; on one device that padding is the
    identity and is left out.  Nothing here reads a device value on the
    host.
    """
    B, S, D = x.shape
    T, E, k = B * S, n_experts, top_k
    dtype = x.dtype
    xt = x.reshape(T, D)
    r = moe_route(p["router"], xt, top_k=k, capacity_factor=capacity_factor)
    C = r.capacity
    row = r.ids.reshape(-1) * C + torch.where(r.keep, r.pos, 0)

    src = xt.repeat_interleave(k, 0) * r.keep[:, None].to(dtype)
    buf = xt.new_zeros((E * C, D)).index_add(0, row, src).view(E, C, D)
    gate = torch.bmm(buf, p["w_gate"]) if "w_gate" in p else None
    h = _hidden(mlp_type, torch.bmm(buf, p["w_up"]), gate)
    out = torch.bmm(h, p["w_down"]).view(E * C, D)

    scale = (r.gates.reshape(-1) * r.keep.float()).to(dtype)
    y = (out.index_select(0, row) * scale[:, None]).reshape(T, k, D).sum(1)

    # load-balance aux loss (Switch/GShard)
    aux = E * torch.sum(r.probs.mean(0) * (r.counts.float() / (T * k)))
    if shared_expert:
        y = y + mlp_block(p["shared"], xt, mlp_type)
    return y.reshape(B, S, D), aux
