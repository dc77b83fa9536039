"""Train and serve step builders — the port of ``repro/train/step.py``.

PyTorch runs eagerly, so each builder returns a plain function (no
``jit``).  ``make_train_step(cfg, opt)`` returns
    (params, opt_state, batch) → (params, opt_state, metrics)
with the sequence-chunked loss head and, in the moe family, the
load-balance aux loss at ``lm_loss``'s default weight, as the reference's
step; unlike the reference's pure step it updates ``params`` and
``opt_state`` in place (AdamW in place, gradients freed as they are used)
and returns the same objects.  Every builder passes a batch's
``patch_embeds`` and ``enc_embeds`` on to the model, as the reference's
do.  Under a mesh (``sharding.set_mesh``) the train step takes DTensor
parameters, state and batch, runs forward, backward and update in the
mesh's region, and returns its metrics as plain tensors every rank holds.

The train and prefill steps are the root spans of the compute path's
trace (:func:`repro_torch.core.trace.compute`): ``step.train`` over
``step.forward``, ``step.backward`` and ``step.optimizer``, and
``step.prefill`` (over the last position's logits, ``model.head``), each
with its batch ``B`` and length ``S``.  A builder installs the
``REPRO_SCDA_TRACE`` collector, if the variable is set, once.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.checkpoint.pytree_io import flatten_named
from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace as _trace
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.optim import adamw

#: Batch keys beside tokens and labels that go to the model: the vlm
#: family's image prefix and the encdec family's encoder input.
EMBEDS = ("patch_embeds", "enc_embeds")


def _embeds(batch):
    return {k: batch[k] for k in EMBEDS if k in batch}


def _root(span, batch):
    """A step's root span's batch and length."""
    B, S = batch["tokens"].shape
    span.add(B=B, S=S)


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig,
                    loss_chunk: int = 256,
                    grad_transform: Optional[Callable] = None):
    """Build the loss + grad + update step."""
    _trace.collector()       # installs a REPRO_SCDA_TRACE collector, once

    def step(params, opt_state, batch):
        with _trace.compute("train", "step") as span, sharding.mesh_region():
            if span:
                _root(span, batch)
            named, rebuild = flatten_named(params)
            leaves = [p.requires_grad_(True) for _, p in named]
            with _trace.compute("forward", "step"):
                loss = lm.lm_loss(cfg, params, batch["tokens"],
                                  batch["labels"], loss_chunk=loss_chunk,
                                  **_embeds(batch))
            with _trace.compute("backward", "step", backward=True):
                grads = rebuild(list(torch.autograd.grad(loss, leaves)))
            if grad_transform is not None:
                grads = grad_transform(grads)
            with _trace.compute("optimizer", "step"):
                params, opt_state, stats = adamw.update(opt, grads,
                                                        opt_state, params)
        metrics = {"loss": loss.detach(), **stats}
        if sharding.get_policy().mesh is not None:
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return step


def _whole(x):
    """A DTensor's whole value as a plain tensor; anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_eval_step(cfg: ModelConfig, loss_chunk: int = 256):
    def step(params, batch):
        with torch.no_grad():
            return lm.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                              loss_chunk=loss_chunk, **_embeds(batch))
    return step


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward (prompt ingestion): tokens → last-token
    logits, in the compute dtype."""
    _trace.collector()       # installs a REPRO_SCDA_TRACE collector, once

    def step(params, batch):
        with _trace.compute("prefill", "step") as span:
            if span:
                _root(span, batch)
            hidden, _ = lm.forward_hidden(cfg, params, batch["tokens"],
                                          **_embeds(batch))
            with _trace.compute("head", "model"):
                return lm.unembed(cfg, params, hidden[:, -1:, :])[:, 0, :]
    return step


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, tokens):
        return lm.serve_step(cfg, params, cache, tokens)
    return step
