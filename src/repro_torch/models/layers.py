"""Building-block layers of the dense transformer: norms, RoPE, GQA
attention (prefill and decode) and MLPs — the port of the dense subset of
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
from typing import Any, Dict, Optional

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


def mlp_block(p: Params, x, mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        act = F.silu(gate) if mlp_type == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * (x @ p["w_up"])
    elif mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.square(F.relu(x @ p["w_up"]))
    elif mlp_type == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ p["w_down"]
