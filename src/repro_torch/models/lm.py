"""The dense language model: init, prefill forward and cached decode — the
port of the dense branch of ``repro/models/lm.py``.

Parameters are the reference's nested dict with layers *stacked* on a
leading axis (``params["layers"]["attn"]["wq"]`` is ``(n_layers, d_model,
heads, head_dim)``), so one scda checkpoint loads in both packages.  The
layer loop is a Python loop over views of the stacked tensors.

The reference casts every layer's f32 weights to the compute dtype inside
each step; at full width that would rewrite the whole model once per
decoded token.  Here the weights are cast once (:func:`cast_params`) when
they are loaded, and the forward functions require weights already in the
compute dtype.  A cast is deterministic, so the results are the same.

Families other than ``dense`` raise :class:`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.runtime import resolve_device

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(dense only)")


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """Random f32 weights of ``cfg`` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed``.  The distributions are the
    reference's; the numbers are not (torch's generator is not JAX's)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = cfg.n_layers
    p: Params = {
        "embed": L._init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": L.init_rms_norm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab))
    p["layers"] = {
        "ln1": L.init_rms_norm(cfg.d_model, stack=n, device=dev),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim_, cfg.qk_norm,
                                 stack=n),
        "ln2": L.init_rms_norm(cfg.d_model, stack=n, device=dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, stack=n),
    }
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


def forward_hidden(cfg: ModelConfig, params: Params, tokens,
                   kv_chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) → final hidden states (B, S, d). Returns (hidden,
    moe_aux); the dense family's aux loss is 0."""
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    _check_dtype(params, dtype)
    eps = cfg.norm_eps
    x = params["embed"][tokens].to(dtype)
    windows = _windows_per_layer(cfg, x.shape[1])
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = L.rms_norm(x, lp["ln1"], eps)
        h = L.attention_block(lp["attn"], h,
                              window=None if windows is None else windows[i],
                              kv_chunk=kv_chunk, **_attn_kwargs(cfg))
        x = x + h
        h = L.rms_norm(x, lp["ln2"], eps)
        x = x + L.mlp_block(lp["mlp"], h, cfg.mlp_type)
    x = L.rms_norm(x, params["final_norm"], eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def unembed(cfg: ModelConfig, params: Params, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ w.to(hidden.dtype)


def forward(cfg: ModelConfig, params: Params, tokens, **kw):
    """Full logits (small-model / test path)."""
    hidden, _ = forward_hidden(cfg, params, tokens, **kw)
    return unembed(cfg, params, hidden).float()


# --------------------------------------------------------------------------
# Decode (serve) path with layer-stacked caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Params:
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def serve_step(cfg: ModelConfig, params: Params, cache: Params, tokens):
    """One decode step: tokens (B, 1) → (logits (B, vocab) f32, cache).

    The cache is updated IN PLACE (the reference returns a new one): each
    layer writes its new key/value at ``cache["pos"]`` with a device-side
    index, and ``cache["pos"]`` is replaced by ``pos + 1`` on the device.
    Nothing in the step reads a device value on the host.
    """
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    _check_dtype(params, dtype)
    eps = cfg.norm_eps
    pos = cache["pos"]
    pos_index = pos.reshape(1).long()
    x = params["embed"][tokens].to(dtype)
    windows = _windows_per_layer(cfg, cache["k"].shape[2])
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = L.rms_norm(x, lp["ln1"], eps)
        h, _, _ = L.attention_decode(
            lp["attn"], h, cache["k"][i], cache["v"][i], pos,
            window=None if windows is None else windows[i],
            pos_index=pos_index, **_attn_kwargs(cfg))
        x = x + h
        h = L.rms_norm(x, lp["ln2"], eps)
        x = x + L.mlp_block(lp["mlp"], h, cfg.mlp_type)
    x = L.rms_norm(x, params["final_norm"], eps)
    logits = unembed(cfg, params, x)[:, 0, :].float()
    cache["pos"] = pos + 1
    return logits, cache


def param_bytes(params: Params) -> int:
    """Total bytes of the tensors in ``params``."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


__all__ = ["compute_dtype", "init_lm", "cast_params", "forward_hidden",
           "unembed", "forward", "init_cache", "serve_step", "param_bytes"]
