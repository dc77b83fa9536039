"""Abstract inputs of each (arch × shape × mesh) cell — the port of
``repro/launch/specs.py``.

The reference builds ``jax.ShapeDtypeStruct`` stand-ins with shardings
attached, which let ``jit(...).lower(...).compile()`` validate a 512-chip
program on a laptop.  The port's stand-ins are tensors on the ``meta``
device (a shape and a dtype, no data): under a mesh each leaf is a
DTensor with the reference's placements whose local block is on meta (so
a rank "holds" exactly its block), with no mesh a plain meta tensor.  The
leaves, their shapes and dtypes are the reference's:

* :func:`abstract_params` — ``init_lm``'s tree on
  ``sharding.params_shardings``' placements, in f32 (the master weights a
  train step takes) or, with ``dtype``, cast as a server holds them
  (``lm.cast_params`` once at load: the port's serving forward takes
  weights already in the compute dtype);
* :func:`abstract_opt_state` — AdamW's f32 moments placed like their
  parameters, and the count, an int32 every rank holds;
* :func:`train_inputs` — tokens and labels (B, S) int32, a vlm's patch
  embeddings, an encdec model's frame embeddings (f32), on
  ``sharding.input_shardings``;
* :func:`decode_inputs` — ``lm.init_cache(..., device="meta", mesh=)``
  (the KV caches, SSM states and encoder output on their placements, the
  position plain) and the (B, 1) int32 tokens.

The reference's ``hybrid_kv_shape_fix`` returns its argument and has no
caller (zamba2's G shared-attention caches carry the rank-5 specs
already), so it has no counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import lm
from repro_torch.optim import adamw


def _placed(mesh, spec, shape, dtype):
    """A meta stand-in of ``shape`` and ``dtype``: on ``mesh`` a DTensor
    with ``spec``'s placements (its local block on meta), else a plain
    meta tensor."""
    like = torch.empty(shape, dtype=dtype, device="meta")
    return like if mesh is None else sh.target(mesh, spec, like)


def abstract_params(cfg: ModelConfig, mesh=None,
                    dtype: torch.dtype = torch.float32):
    """The parameter tree of ``cfg`` as meta stand-ins (f32 master weights
    unless ``dtype``), on ``mesh``'s parameter placements."""
    a = lm.init_lm(cfg, device="meta", dtype=dtype)
    return a if mesh is None else sh.params_shardings(mesh, a)


def abstract_opt_state(cfg: ModelConfig, mesh, params_abs) -> adamw.AdamWState:
    """AdamW's state for ``params_abs`` (``adamw.init`` on the stand-ins):
    f32 moments placed like each parameter, the count an int32 every rank
    holds."""
    return adamw.init(params_abs)


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) \
        -> Dict[str, Any]:
    """A train (or prefill) cell's batch: tokens and labels (B, S) int32,
    and a vlm's ``patch_embeds`` or an encdec model's ``enc_embeds`` in
    f32."""
    B, S = shape.global_batch, shape.seq_len
    shd = (sh.input_shardings(mesh, "train", cfg, shape)
           if mesh is not None else {})
    batch = {"tokens": _placed(mesh, shd.get("tokens"), (B, S), torch.int32),
             "labels": _placed(mesh, shd.get("labels"), (B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _placed(
            mesh, shd.get("patch_embeds"), (B, cfg.num_patches, cfg.d_model),
            torch.float32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _placed(
            mesh, shd.get("enc_embeds"), (B, cfg.max_source_len, cfg.d_model),
            torch.float32)
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) \
        -> Tuple[Any, Any]:
    """(cache, tokens) of a serve-step cell: the cache of ``shape``'s batch
    and length on its placements, the tokens (B, 1) int32."""
    B, S = shape.global_batch, shape.seq_len
    cache = lm.init_cache(cfg, B, S, device="meta", mesh=mesh)
    spec: Optional[sh.PartitionSpec] = None
    if mesh is not None:
        spec = sh.input_shardings(mesh, "decode", cfg, shape)["tokens"]
    return cache, _placed(mesh, spec, (B, 1), torch.int32)
