"""The language model: init, prefill forward, cached decode and the
training loss — the port of ``repro/models/lm.py``: the dense, moe, ssm
(Mamba1 and Mamba2), hybrid, encdec and vlm families.

Parameters are the reference's nested dict with layers *stacked* on a
leading axis (``params["layers"]["attn"]["wq"]`` is ``(n_layers, d_model,
heads, head_dim)``), so one scda checkpoint loads in both packages.  The
layer loop is a Python loop over views of the stacked tensors.

The reference casts every layer's f32 weights to the compute dtype inside
each step; at full width that would rewrite the whole model once per
decoded token.  For serving, the weights are cast once
(:func:`cast_params`) when they are loaded, and the serving forward
requires weights already in the compute dtype.  Training does what the
reference does: :func:`lm_loss` takes f32 master weights and
``forward_hidden(..., remat=True)`` casts each layer's weights inside the
layer body, which ``torch.utils.checkpoint`` re-runs in the backward pass.
A cast is deterministic, so both paths give the same numbers for the same
weights.

The hybrid family (zamba2) runs in groups: ``shared_attn_every`` Mamba2
layers, then one application of the single shared attention block
(``params["shared_attn"]``), whose weights every group reuses and whose
KV cache each application keeps apart (``cache["k"][g]``).

The moe family is the dense one with each layer's MLP replaced by
:func:`layers.moe_block` (every layer: the reference ignores
``moe_every``); the layers' load-balance losses are summed into the
forward's aux, which :func:`lm_loss` adds with ``aux_weight``.  A decode
step routes its B tokens with the capacity of B tokens, so it may drop
assignments that a prefill of the same tokens keeps, as in the reference.

The encdec family (whisper) runs an encoder of dense layers without the
causal mask over frame embeddings (:func:`encode`), then decoder layers
that add cross-attention to the encoder's output between their
self-attention and their MLP.  A serving caller encodes once and writes
``cache["enc_out"]``; each decode step recomputes the cross-attention's
keys and values from it, as the reference does.  The vlm family (llava)
is the dense one with an image prefix: patch embeddings projected by
``mm_proj`` are put before the text, and the loss covers the text alone.
A decode step never sees the image, as in the reference: its cache holds
text positions only.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.runtime import resolve_device

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (takes "
                         f"{FAMILIES})")


def _groups(cfg: ModelConfig) -> int:
    """The hybrid family's groups: shared_attn_every SSM layers and one
    shared-attention application each."""
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError("hybrid needs n_layers divisible by "
                         "shared_attn_every")
    return cfg.n_layers // cfg.shared_attn_every


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            dtype: torch.dtype = torch.float32) -> Params:
    """Random weights of ``cfg`` on ``device``, drawn in f32 from a
    ``torch.Generator`` seeded with ``seed``.  The distributions are the
    reference's; the numbers are not (torch's generator is not JAX's).
    Each leaf is cast to ``dtype`` as soon as it is drawn, so a bf16 model
    never holds its f32 weights at once (the same values as
    ``cast_params`` of the f32 weights).  ``device="meta"`` draws nothing:
    the tree of shapes and dtypes a restore is given as ``like``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = (L.SHAPES_ONLY if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    n = cfg.n_layers
    kw = dict(stack=n, dtype=dtype)
    p: Params = {
        "embed": L._init(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                         dtype=dtype),
        "final_norm": L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab), dtype=dtype)
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = {
            "ln1": L.init_rms_norm(cfg.d_model, device=dev, **kw),
            "ssm": SSM.init_ssm(gen, cfg, **kw),
        }
        if cfg.family == "hybrid":
            _groups(cfg)
            p["shared_attn"] = {
                "ln": L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype),
                "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim_,
                                         cfg.qk_norm, dtype=dtype),
            }
        return p
    if cfg.family == "encdec":
        p["enc_layers"] = _init_layers(cfg, gen, dev, cfg.encoder_layers,
                                       dtype)
        p["enc_norm"] = L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype)
    p["layers"] = _init_layers(cfg, gen, dev, n, dtype,
                               cross=cfg.family == "encdec")
    if cfg.family == "vlm":
        p["mm_proj"] = L._init(gen, (cfg.d_model, cfg.d_model), dtype=dtype)
    return p


def _init_layers(cfg: ModelConfig, gen, dev, n: int, dtype,
                 cross: bool = False) -> Params:
    """``n`` stacked attention layers: norms, self-attention, (with
    ``cross``, a norm and the cross-attention of a decoder layer,) and the
    MLP or, in the moe family, the MoE block."""
    kw = dict(stack=n, dtype=dtype)

    def attention():
        return L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim_, cfg.qk_norm,
                                **kw)

    p = {"ln1": L.init_rms_norm(cfg.d_model, device=dev, **kw),
         "attn": attention()}
    if cross:
        p["ln_x"] = L.init_rms_norm(cfg.d_model, device=dev, **kw)
        p["cross"] = attention()
    p["ln2"] = L.init_rms_norm(cfg.d_model, device=dev, **kw)
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                              cfg.mlp_type, cfg.shared_expert, **kw)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
    return p


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating-point leaf cast to ``dtype`` — once, at load time.
    Leaves already in ``dtype`` are kept (no copy)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


def _check_dtype(params: Params, dtype: torch.dtype) -> None:
    if params["embed"].dtype != dtype:
        raise ValueError(f"weights are {params['embed'].dtype}, the model "
                         f"computes in {dtype}: cast them once with "
                         f"cast_params(params, {dtype})")


def _unstack(tree, n: int) -> List[Any]:
    """Per-layer views of a stacked subtree (one ``unbind`` per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------------
# Forward (prefill): hidden states
# --------------------------------------------------------------------------

def _windows_per_layer(cfg: ModelConfig, S_kv: int) -> Optional[List[int]]:
    """Per-layer effective window, or None."""
    if cfg.attn_window == 0:
        return None
    return [S_kv if cfg.layer_is_global(i) else cfg.attn_window
            for i in range(cfg.n_layers)]


def _attn_kwargs(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_base=cfg.rope_base,
                eps=cfg.norm_eps)


def _ffn(cfg: ModelConfig, lp: Params, h):
    """A layer's feed-forward on its normed input: (out, the MoE block's
    aux loss, or None in a dense layer)."""
    if cfg.family == "moe":
        return L.moe_block(lp["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.experts_top_k, mlp_type=cfg.mlp_type,
                           capacity_factor=cfg.capacity_factor,
                           shared_expert=cfg.shared_expert)
    return L.mlp_block(lp["mlp"], h, cfg.mlp_type), None


def _layer(cfg: ModelConfig, lp: Params, x, window: Optional[int],
           kv_chunk: int, dtype: Optional[torch.dtype] = None,
           causal: bool = True, enc_out: Optional[torch.Tensor] = None):
    """One layer's residual update of ``x``: (x, the layer's MoE aux loss,
    or None outside the moe family).  With ``dtype`` the layer's weights
    are cast to it first (the training path's per-layer cast).  An
    encoder layer attends with ``causal=False``; a decoder layer of the
    encdec family attends to ``enc_out`` after its self-attention."""
    if dtype is not None:
        lp = cast_params(lp, dtype)
    eps = cfg.norm_eps
    if cfg.family in ("ssm", "hybrid"):
        return x + SSM.ssm_block(lp["ssm"], L.rms_norm(x, lp["ln1"], eps),
                                 cfg), None
    h = L.rms_norm(x, lp["ln1"], eps)
    x = x + L.attention_block(lp["attn"], h, causal=causal, window=window,
                              kv_chunk=kv_chunk, **_attn_kwargs(cfg))
    if enc_out is not None:
        x = x + _cross_attention(cfg, lp["cross"],
                                 L.rms_norm(x, lp["ln_x"], eps), enc_out)
    h, aux = _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], eps))
    return x + h, aux


def _cross_attention(cfg: ModelConfig, p: Params, x, enc_out):
    """Decoder-to-encoder attention: queries from ``x``, keys and values
    from ``enc_out``, no causal mask, no RoPE and no qk-norm (the
    reference's ``_cross_attention``).  The keys and values are computed
    from ``enc_out`` in every call, a decode step's too."""
    q = L._heads(x, p["wq"])
    k = L._heads(enc_out, p["wk"])
    v = L._heads(enc_out, p["wv"])
    out = ops.flash_attention(q, k, v, causal=False)
    return L._output_proj(p, out, cfg.n_heads, x.shape[-1])


def _hybrid_group(cfg: ModelConfig, group: List[Params], sa: Params, x,
                  kv_chunk: int, dtype: Optional[torch.dtype] = None):
    """One hybrid group's residual updates of ``x``: its SSM layers, then
    the shared attention block ``sa`` (already in the compute dtype)."""
    for lp in group:
        x, _ = _layer(cfg, lp, x, None, kv_chunk, dtype)
    h = L.rms_norm(x, sa["ln"], cfg.norm_eps)
    return x + L.attention_block(sa["attn"], h, kv_chunk=kv_chunk,
                                 **_attn_kwargs(cfg))


def encode(cfg: ModelConfig, params: Params, enc_embeds,
           kv_chunk: int = 512, remat: bool = False) -> torch.Tensor:
    """The encdec family's encoder: frame embeddings (B, S_src, d) through
    the encoder layers (self-attention without the causal mask, then the
    MLP) and ``enc_norm`` → (B, S_src, d) in the compute dtype.  A serving
    caller writes its output into ``cache["enc_out"]``.  ``remat`` as in
    :func:`forward_hidden`, each encoder layer a checkpointed body."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: the encdec family needs encoder "
                         f"embeddings (enc_embeds)")
    dtype = compute_dtype(cfg)
    if not remat:
        _check_dtype(params, dtype)
    e = enc_embeds.to(dtype)
    for lp in _unstack(params["enc_layers"], cfg.encoder_layers):
        if remat:
            e, _ = checkpoint(_layer, cfg, lp, e, None, kv_chunk, dtype,
                              False, use_reentrant=False)
        else:
            e, _ = _layer(cfg, lp, e, None, kv_chunk, causal=False)
    return L.rms_norm(e, params["enc_norm"].to(dtype), cfg.norm_eps)


def forward_hidden(cfg: ModelConfig, params: Params, tokens,
                   patch_embeds=None, enc_embeds=None, kv_chunk: int = 512,
                   remat: bool = False) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) → final hidden states (B, S, d), or (B, P + S, d)
    in the vlm family. Returns (hidden, moe_aux): the sum of the moe
    layers' load-balance losses, f32, 0 in the other families.

    The vlm family needs ``patch_embeds`` (B, P, d): projected by
    ``mm_proj``, they are put before the text, and RoPE positions run over
    the whole sequence.  The encdec family needs ``enc_embeds`` (B, S_src,
    d): :func:`encode` runs first, and every decoder layer attends to its
    output.

    ``remat=False`` (serving) takes weights already cast to the compute
    dtype.  ``remat=True`` (training) takes master weights of any float
    dtype: the embedding rows are cast after the gather, each layer's
    weights inside its layer body, and each body runs under
    ``torch.utils.checkpoint``, so the backward pass recomputes a layer's
    internals instead of keeping them (the reference's remat'd scan).  A
    hybrid model's body is a whole group, as the reference remats its
    group scan; its shared attention weights are cast once, outside.  An
    encdec model's bodies are its encoder layers and its decoder layers.
    """
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    if not remat:
        _check_dtype(params, dtype)
    x = params["embed"][tokens].to(dtype)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: the vlm family needs patch "
                             f"embeddings (patch_embeds)")
        prefix = patch_embeds.to(dtype) @ params["mm_proj"].to(dtype)
        x = torch.cat([prefix, x], dim=1)
    enc_out = (encode(cfg, params, enc_embeds, kv_chunk, remat)
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family == "hybrid":
        E = cfg.shared_attn_every
        sa = cast_params(params["shared_attn"], dtype)
        for g in range(_groups(cfg)):
            group = layers[g * E:(g + 1) * E]
            if remat:
                x = checkpoint(_hybrid_group, cfg, group, sa, x, kv_chunk,
                               dtype, use_reentrant=False)
            else:
                x = _hybrid_group(cfg, group, sa, x, kv_chunk)
    else:
        windows = _windows_per_layer(cfg, x.shape[1])
        for i, lp in enumerate(layers):
            window = None if windows is None else windows[i]
            if remat:
                x, a = checkpoint(_layer, cfg, lp, x, window, kv_chunk,
                                  dtype, True, enc_out, use_reentrant=False)
            else:
                x, a = _layer(cfg, lp, x, window, kv_chunk, enc_out=enc_out)
            if a is not None:
                aux = aux + a
    x = L.rms_norm(x, params["final_norm"].to(dtype), cfg.norm_eps)
    return x, aux


def unembed(cfg: ModelConfig, params: Params, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ w.to(hidden.dtype)


def forward(cfg: ModelConfig, params: Params, tokens, **kw):
    """Full logits (small-model / test path)."""
    hidden, _ = forward_hidden(cfg, params, tokens, **kw)
    return unembed(cfg, params, hidden).float()


# --------------------------------------------------------------------------
# Loss with a sequence-chunked, remat'd softmax head
# --------------------------------------------------------------------------

def _chunk_loss(h, w, y):
    """Sum over a chunk of (logsumexp - gold logit), the logits in f32."""
    logits = (h @ w).float()
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def lm_loss(cfg: ModelConfig, params: Params, tokens, labels,
            loss_chunk: int = 256, aux_weight: float = 0.01,
            remat: bool = True, patch_embeds=None, enc_embeds=None,
            kv_chunk: int = 512):
    """Mean next-token cross entropy of ``labels`` (B, S) (integer ids)
    given ``tokens`` (B, S), from master weights (see
    :func:`forward_hidden`'s ``remat``), plus ``aux_weight`` times the
    MoE layers' summed load-balance loss (0 outside the moe family).
    ``patch_embeds`` and ``enc_embeds`` go to :func:`forward_hidden`; a
    vlm model's image prefix carries no loss.

    The head runs over ``loss_chunk``-token slices of the sequence, each
    under ``torch.utils.checkpoint``, so the (B, S, vocab) f32 logits never
    exist whole: a chunk's are recomputed in the backward pass.  The
    unembedding is cast to the compute dtype once per call.
    """
    hidden, aux = forward_hidden(cfg, params, tokens, patch_embeds,
                                 enc_embeds, kv_chunk, remat)
    if cfg.family == "vlm":
        hidden = hidden[:, -tokens.shape[1]:]
    B, S, _ = hidden.shape
    n = max(1, S // loss_chunk)
    chunk = S // n
    if n * chunk != S:
        raise ValueError(f"seq {S} not divisible into {n} loss chunks")
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(hidden.dtype)
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, part], w,
                                   labels[:, part], use_reentrant=False)
    return total / (B * S) + aux_weight * aux


# --------------------------------------------------------------------------
# Decode (serve) path with layer-stacked caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Params:
    """Zero decode cache on ``device``: the position, and per layer a KV
    cache of ``max_len`` (dense) or the SSM state, h in f32 ((L, B,
    d_inner, N) for Mamba1, (L, B, H, N, P) for Mamba2) and the conv window
    (L, B, K-1, d_inner) in the compute dtype (ssm; its size does not
    depend on ``max_len``).  A hybrid model has both: the SSM state of its
    layers and a KV cache of ``max_len`` for each of its G shared-attention
    applications, (G, B, max_len, Hkv, D).  An encdec model also holds
    ``enc_out`` (B, max_source_len, d) in the compute dtype, zeros until
    the caller writes :func:`encode`'s output there."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = SSM.init_ssm_state(cfg, batch, dtype,
                                          stack=cfg.n_layers, device=dev)
        if cfg.family == "ssm":
            return cache
    n = _groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "encdec":
        cache["enc_out"] = torch.zeros((batch, cfg.max_source_len,
                                        cfg.d_model), dtype=dtype, device=dev)
    return cache


def serve_step(cfg: ModelConfig, params: Params, cache: Params, tokens):
    """One decode step: tokens (B, 1) → (logits (B, vocab) f32, cache).

    The cache is updated IN PLACE (the reference returns a new one): each
    dense layer, and each hybrid group's shared-attention application,
    writes its new key/value at ``cache["pos"]`` with a device-side index;
    each ssm layer copies its new h and conv window over its slice of the
    stacked ``cache["ssm"]``.  ``cache["pos"]`` is replaced by ``pos + 1``
    on the device.  Nothing in the step reads a device value on the host.
    An encdec decoder layer attends to ``cache["enc_out"]`` after its
    self-attention; a vlm step is a dense one (it never sees the image).
    """
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    _check_dtype(params, dtype)
    eps = cfg.norm_eps
    pos = cache["pos"]
    x = params["embed"][tokens].to(dtype)
    if cfg.family == "ssm":
        x = _ssm_decode_layers(cfg, _unstack(params["layers"], cfg.n_layers),
                               cache["ssm"], x, 0)
    elif cfg.family == "hybrid":
        x = _hybrid_decode_groups(cfg, params, cache, x)
    else:
        x = _dense_decode_layers(cfg, params, cache, x)
    x = L.rms_norm(x, params["final_norm"], eps)
    logits = unembed(cfg, params, x)[:, 0, :].float()
    cache["pos"] = pos + 1
    return logits, cache


def _ssm_decode_layers(cfg: ModelConfig, layers: List[Params],
                       state: Params, x, first: int):
    """One token through ``layers``, the model's layers ``first``,
    ``first + 1``, …; each reads its slice of the stacked ``state`` and
    overwrites it in place."""
    h_all, conv_all = state["h"], state["conv"]
    for i, lp in enumerate(layers, first):
        h, st = SSM.ssm_decode(
            lp["ssm"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
            {"h": h_all[i], "conv": conv_all[i]}, cfg)
        h_all[i].copy_(st["h"])
        conv_all[i].copy_(st["conv"])
        x = x + h
    return x


def _hybrid_decode_groups(cfg: ModelConfig, params: Params, cache: Params,
                          x):
    """Each group's SSM layers, then application g of the shared attention
    against its own KV cache ``cache["k"][g]``, ``cache["v"][g]``."""
    E = cfg.shared_attn_every
    pos = cache["pos"]
    pos_index = pos.reshape(1).long()
    layers = _unstack(params["layers"], cfg.n_layers)
    sa = params["shared_attn"]
    for g in range(_groups(cfg)):
        x = _ssm_decode_layers(cfg, layers[g * E:(g + 1) * E], cache["ssm"],
                               x, g * E)
        h = L.rms_norm(x, sa["ln"], cfg.norm_eps)
        h, _, _ = L.attention_decode(
            sa["attn"], h, cache["k"][g], cache["v"][g], pos,
            pos_index=pos_index, **_attn_kwargs(cfg))
        x = x + h
    return x


def _dense_decode_layers(cfg: ModelConfig, params: Params, cache: Params,
                         x):
    eps = cfg.norm_eps
    pos = cache["pos"]
    pos_index = pos.reshape(1).long()
    windows = _windows_per_layer(cfg, cache["k"].shape[2])
    enc_out = cache.get("enc_out")
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = L.rms_norm(x, lp["ln1"], eps)
        h, _, _ = L.attention_decode(
            lp["attn"], h, cache["k"][i], cache["v"][i], pos,
            window=None if windows is None else windows[i],
            pos_index=pos_index, **_attn_kwargs(cfg))
        x = x + h
        if enc_out is not None:
            x = x + _cross_attention(cfg, lp["cross"],
                                     L.rms_norm(x, lp["ln_x"], eps), enc_out)
        h, _ = _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], eps))   # aux dropped
        x = x + h
    return x


def param_bytes(params: Params) -> int:
    """Total bytes of the tensors in ``params``."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


__all__ = ["FAMILIES", "compute_dtype", "init_lm", "cast_params",
           "encode", "forward_hidden", "unembed", "forward", "lm_loss",
           "init_cache", "serve_step", "param_bytes"]
