"""Building-block layers of the transformer: norms, RoPE, GQA attention
(prefill and decode), MLPs and the token-choice MoE block — the port of
``repro/models/layers.py``.

Plain functions over explicit parameter dicts with the reference's names,
shapes and layouts: 3-D attention projections ``(d_model, heads,
head_dim)``, so one checkpoint loads in both packages.

Under a mesh (``distributed.sharding.set_mesh``) the weights, activations
and caches are DTensors, and the reference's ``constrain`` calls stand at
its points.  Tensor parallelism then pads phantom heads and experts with
zero weights when their counts do not divide the model axis, EXACTLY: a
GQA group's phantom q heads go last in that group
(``sharding.gqa_heads``), so every real head keeps its kv head (the
reference pads after the last group, which moves GQA heads to other kv
heads); MHA pads q and kv heads alike; phantom experts get router logits
of -1e30 and the capacity stays the real experts'.  On one device nothing
is padded and no DTensor is made.

Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
the K1 CUDA kernel on the card, its plain torch version on the CPU, on
each rank's local heads under a mesh.  A decode step whose cache is
sequence-sharded (``sp_decode_axis``) runs K1's decode kernel on each
rank's shard and merges the shards by their log-sum-exps.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.runtime import is_dtensor
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
    """einsum("bsd,dhk->bshk") as one matmul on the flattened heads.  A
    DTensor ``w`` sharded on its head dim (kv heads the model axis does not
    divide: qwen3's 8 on 16) projects each rank's block of every head:
    DTensor (PyTorch 2.11) cannot flatten (h, k) with k sharded, and
    gathering ``w`` first would move every layer's weights."""
    d, h, k = w.shape
    if not is_dtensor(w) or not any(p.is_shard(2) for p in w.placements):
        return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    w_pl = [p if p.is_shard(2) else Replicate() for p in w.placements]
    x_pl = [xp if xp.is_shard(0) and not wp.is_shard(2) else Replicate()
            for xp, wp in zip(x.placements, w_pl)]
    out_pl = [Shard(x.ndim) if wp.is_shard(2) else xp
              for xp, wp in zip(x_pl, w_pl)]
    # x meets each rank's part of the contraction's output, w each rank's
    # batch shard: their gradients are parts of sums
    x_grad = [Partial() if wp.is_shard(2) else xp
              for xp, wp in zip(x_pl, w_pl)]
    w_grad = [Partial() if xp.is_shard(0) else wp
              for xp, wp in zip(x_pl, w_pl)]

    def local(xl, wl):
        return (xl @ wl.reshape(d, -1)).unflatten(-1, (h, -1))

    return local_map(local, out_placements=out_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad), device_mesh=mesh)(
        x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl))


def head_layout(n_heads: int, n_kv: int):
    """``(q heads, kv heads, q heads per kv group)`` once phantom heads are
    padded in for the ambient model axis; the group is None where phantom
    heads go after the real ones (MHA, and no padding at all)."""
    if sh.model_axis_size() <= 1 or n_heads % sh.model_axis_size() == 0:
        return n_heads, n_kv, None
    if n_heads == n_kv:
        h_pad = sh.padded_heads(n_heads)
        return h_pad, h_pad, None
    group = sh.gqa_heads(n_heads, n_kv)
    return n_kv * group, n_kv, group


def _on_blocks(w, axis: int, fn):
    """``fn(w)``, which keeps w's dims and changes its size along ``axis``
    alone; a DTensor's blocks are made whole along ``axis`` first and
    ``fn`` runs on each rank's block (its gradient comes back the same
    way)."""
    if not is_dtensor(w):
        return fn(w)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    pl = [Replicate() if p.is_shard(axis) else p for p in w.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh)(w.redistribute(mesh, pl))


def _pad_axis(w, axis: int, size: int):
    """``w`` with zero slices after its own along ``axis``, to ``size``."""
    have = w.shape[axis]
    if have == size:
        return w

    def pad(t):
        shape = list(t.shape)
        shape[axis] = size - have
        return torch.cat([t, t.new_zeros(shape)], dim=axis)

    return _on_blocks(w, axis, pad)


def pad_heads(w, axis: int, n_heads: int, n_kv: int):
    """A q-side weight (``wq``'s heads at ``axis`` 1, ``wo``'s at 0) laid out
    for :func:`head_layout`: each kv group's heads padded to the group's
    padded count, or the heads padded after the last."""
    h_pad, _, group = head_layout(n_heads, n_kv)
    if group is None:
        return _pad_axis(w, axis, h_pad)
    g_real = n_heads // n_kv

    def pad(t):
        g = t.unflatten(axis, (n_kv, g_real))
        shape = list(g.shape)
        shape[axis + 1] = group - g_real
        return torch.cat([g, g.new_zeros(shape)], dim=axis + 1).flatten(
            axis, axis + 1)

    return _on_blocks(w, axis, pad)


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, rope_base,
                 eps=1e-6, kv_heads_role=None):
    _, kv_pad, _ = head_layout(n_heads, n_kv)
    q = _heads(x, pad_heads(p["wq"], 1, n_heads, n_kv))
    k = _heads(x, _pad_axis(p["wk"], 1, kv_pad))
    v = _heads(x, _pad_axis(p["wv"], 1, kv_pad))
    q = sh.constrain(q, "batch", None, "model", None)
    # the reference's: k and v whole over the model axis; a decode step
    # keeps them on its kv heads (``kv_heads_role="model"``), where its
    # cache holds them
    k = sh.constrain(k, "batch", None, kv_heads_role, None)
    v = sh.constrain(v, "batch", None, kv_heads_role, None)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    if positions is not None:
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
    return q, k, v


def _output_proj(p, out, n_heads, d_model):
    """out: (B, S, H, hd) → (B, S, d_model); under a mesh H counts the
    phantom heads, whose zero ``wo`` rows end them here."""
    wo = pad_heads(p["wo"], 0, n_heads, _kv_of(p))
    h, k, d = wo.shape
    return _row_parallel(out.flatten(-2), wo.reshape(h * k, d),
                         ("batch", None, None))


def _kv_of(p) -> int:
    """The real kv heads of an attention parameter dict."""
    return p["wk"].shape[-2]


@sh.under_mesh
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


@sh.under_mesh
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

    Under a mesh the caches are DTensors (``lm.init_cache(mesh=)``): each
    rank writes the new key and value into its own block, a
    sequence-sharded block only where ``pos`` falls in it (decided on the
    device), and with ``sp_decode_axis`` set the attention runs on each
    shard and is merged (:func:`_sp_decode_attention`).
    """
    B = x.shape[0]
    d_model = x.shape[-1]
    positions = pos.expand(B, 1)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions,
                           rope_base, eps, kv_heads_role="model")
    if pos_index is None:
        pos_index = pos.reshape(1).long()
    # phantom kv heads (MHA's) never reach the (unpadded) cache
    k, v = k[:, :, :n_kv], v[:, :, :n_kv]
    _write_cache(cache_k, k, pos_index)
    _write_cache(cache_v, v, pos_index)
    axis = sh.get_policy().sp_decode_axis
    if axis:
        out = _sp_decode_attention(q, cache_k, cache_v, pos, window, axis)
    elif q.shape[2] != n_kv and q.shape[2] % n_kv:
        # MHA's phantom q heads have no cache rows: attend with the real
        # heads, the phantoms' output is 0 as a prefill's is
        q_real = sh.constrain(q[:, :, :n_kv], "batch", None, "model", None)
        out = ops.flash_attention(q_real, cache_k, cache_v, causal=True,
                                  window=window, kv_chunk=kv_chunk,
                                  q_offset=pos)
        out = sh.constrain(_pad_axis(out, 2, q.shape[2]), "batch", None,
                           "model", None)
    else:
        out = ops.flash_attention(q, cache_k, cache_v, causal=True,
                                  window=window, kv_chunk=kv_chunk,
                                  q_offset=pos)
    return _output_proj(p, out, n_heads, d_model), cache_k, cache_v


def _block_offset(t, dim: int) -> int:
    """Where this rank's block of the DTensor ``t`` starts along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                   t.placements)
    return off[dim]


def _write_cache(cache, new, pos_index) -> None:
    """Write ``new`` (B, 1, Hkv, D) into ``cache`` (B, S, Hkv, D) at the
    position ``pos_index`` (a 1-element int64 tensor), in place.  A
    DTensor cache is written by each rank into its local block: the new
    rows are brought to the cache's placements (a local slice of a
    replicated value), and a rank whose sequence block does not hold the
    position writes back the row it has, so no rank reads it on the
    host."""
    if not is_dtensor(cache):
        cache.index_copy_(1, pos_index, new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    want = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    local_new = new.to(cache.dtype).redistribute(mesh, want).to_local()
    local = cache.to_local()
    S_local = local.shape[1]
    idx = pos_index - _block_offset(cache, 1)
    inside = (idx >= 0) & (idx < S_local)
    idx = idx.clamp(0, max(S_local - 1, 0))
    if S_local == cache.shape[1]:
        local.index_copy_(1, idx, local_new)
        return
    old = local.index_select(1, idx)
    local.index_copy_(1, idx, torch.where(inside, local_new, old))


def _sp_decode_attention(q, cache_k, cache_v, pos, window, axis: str):
    """Sequence-parallel decode attention: the cache is sharded on its
    sequence dim over mesh axis ``axis``.  Each rank runs K1's decode
    kernel (on the CPU its plain version) on its shard with the query
    offset ``pos - offset``, negative where the shard lies wholly past
    ``pos`` (every key masked: output 0, log-sum-exp -inf), and writes
    its rows' log-sum-exps.  The shards then merge with the reference's
    pmax/psum algebra, on every rank from one all-gather over ``axis`` of
    each shard's (out, lse):
        M = max_r lse_r;  w_r = 2^(lse_r - M);
        out = Σ_r w_r·out_r / Σ_r w_r,
    each shard's output in f32 (the kernel's ``out_f32``) and the merge
    too, rounded once at the end as one device's decode is.  Its volume
    is O(B·H·D) a shard, independent of the cache's length."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = sh.get_policy().mesh
    names = list(mesh.mesh_dim_names)
    H = q.shape[2]
    Hkv = cache_k.shape[2]
    msize = sh.axis_size(mesh, sh.MODEL_AXIS)
    heads = axis != sh.MODEL_AXIS and H % msize == 0 and Hkv % msize == 0
    q_pl = [Shard(2) if (heads and n == sh.MODEL_AXIS) else Replicate()
            for n in names]
    kv_pl = [Shard(1) if n == axis else Shard(2) if (
        heads and n == sh.MODEL_AXIS) else Replicate() for n in names]
    group = mesh.get_group(axis)
    S_local = cache_k.shape[1] // sh.axis_size(mesh, axis)
    offset = mesh.get_local_rank(axis) * S_local

    def local(ql, kl, vl):
        lo = (pos - offset).to(torch.int32).reshape(())
        out, lse = ops.flash_attention_lse(ql, kl, vl, window=window,
                                           q_offset=lo, out_f32=True)
        lse = lse.transpose(1, 2)[..., None]              # (B, 1, H, 1)
        # every shard's (out, lse) in one all-gather; each rank merges
        # them alike, in rank order
        both = coll.all_gather(torch.cat([out, lse], dim=-1), group)
        outs, lses = both[..., :-1], both[..., -1:]
        m = lses.amax(0)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = torch.exp2(lses - m)                          # 0 where -inf
        res = (outs * w).sum(0) / w.sum(0).clamp_min(1e-37)
        return res.to(ql.dtype)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh)(
        q.redistribute(mesh, q_pl), cache_k.redistribute(mesh, kv_pl),
        cache_v.redistribute(mesh, kv_pl))


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


@sh.under_mesh
def mlp_block(p: Params, x, mlp_type: str):
    ff = ("batch", None, "model") if x.ndim == 3 else ("batch", "model")
    dm = ("batch", None, None) if x.ndim == 3 else ("batch", None)
    gate = sh.constrain(x @ p["w_gate"], *ff) if "w_gate" in p else None
    h = _hidden(mlp_type, sh.constrain(x @ p["w_up"], *ff), gate)
    return _row_parallel(h, p["w_down"], dm)


def _row_parallel(x, w, roles):
    """``constrain(x @ w, *roles)`` where x and w may share a sharded
    contraction dim (tensor parallelism's row-parallel product): the
    ranks' partial products are made and summed in f32 and rounded to x's
    dtype once, as one device's matmul rounds its f32 accumulator.  No
    mesh set: ``x @ w``."""
    if sh.get_policy().mesh is None:
        return x @ w
    return sh.constrain(x.float() @ w.float(), *roles).to(x.dtype)


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


def moe_route(router, xt, *, top_k: int, capacity_factor: float = 1.25,
              e_pad: Optional[int] = None) -> MoeRoute:
    """The reference's routing of tokens ``xt`` (T, D): softmax of the
    router's logits in f32, each token's ``top_k`` experts (ties to the
    lower expert), gates normalized; each assignment's slot is the count of
    earlier ones to its expert in (token, choice) order, and those past the
    capacity (:func:`moe_capacity`) are dropped.  ``e_pad`` adds phantom
    experts after the router's real ones, with logits of -1e30 (no token
    picks one) and no share of the capacity, which stays the real
    experts'."""
    T, n_real = xt.shape[0], router.shape[-1]
    E = e_pad or n_real
    logits = (xt @ router).float()
    if E != n_real:
        logits = torch.cat([logits, logits.new_full((T, E - n_real), -1e30)],
                           dim=-1)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = stable_top_k(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    C = moe_capacity(T, n_real, top_k, capacity_factor)
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


@sh.under_mesh
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
    rows, so the sums are exact in any order.  Under a mesh the expert
    axis is padded to a model-axis multiple (expert parallelism), with
    zero weights and routing that never reaches a phantom expert, and the
    buffers carry the reference's constraints.  Nothing here reads a
    device value on the host.
    """
    B, S, D = x.shape
    T, k = B * S, top_k
    msize = sh.model_axis_size()
    E = -(-n_experts // msize) * msize
    dtype = x.dtype
    xt = _rows(x, (T, D))
    r = moe_route(p["router"], xt, top_k=k, capacity_factor=capacity_factor,
                  e_pad=E)
    C = r.capacity
    row = r.ids.reshape(-1) * C + torch.where(r.keep, r.pos, 0)

    src = xt.repeat_interleave(k, 0) * r.keep[:, None].to(dtype)
    buf = xt.new_zeros((E * C, D)).index_add(0, row, src).view(E, C, D)
    ep = "model" if msize > 1 else None
    w_up, w_down = _pad_axis(p["w_up"], 0, E), _pad_axis(p["w_down"], 0, E)
    buf = sh.constrain(buf, ep, None, None)
    gate = (torch.bmm(buf, _pad_axis(p["w_gate"], 0, E))
            if "w_gate" in p else None)
    up = sh.constrain(torch.bmm(buf, w_up), ep, None,
                      None if ep else "model")
    h = _hidden(mlp_type, up, gate)
    out = sh.constrain(torch.bmm(h, w_down), ep, None, None)
    out = out.reshape(E * C, D)

    scale = (r.gates.reshape(-1) * r.keep.float()).to(dtype)
    y = (out.index_select(0, row) * scale[:, None]).reshape(T, k, D).sum(1)

    # load-balance aux loss (Switch/GShard), over the real experts
    aux = n_experts * torch.sum(r.probs[:, :n_experts].mean(0) * (
        r.counts[:n_experts].float() / (T * k)))
    if shared_expert:
        y = y + mlp_block(p["shared"], xt, mlp_type)
    return _rows(y, (B, S, D)), aux


def _rows(x, shape):
    """``x.reshape(shape)`` between (B, S, D) and (B * S, D); a DTensor is
    reshaped on each rank's block of whole rows (its batch shard), so the
    gradient comes back in that layout too."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    if len(shape) == 3:
        local_shape = lambda t: t.reshape(-1, shape[1], shape[2])  # noqa: E731
    else:
        local_shape = lambda t: t.reshape(-1, shape[-1])  # noqa: E731
    return local_map(local_shape, out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh)(x.redistribute(mesh, pl))
