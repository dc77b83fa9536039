"""Serve step builders — the port of ``make_prefill_step`` and
``make_serve_step`` from ``repro/train/step.py``.  PyTorch runs eagerly,
so each builder returns a plain function (no ``jit``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward (prompt ingestion): tokens → last-token
    logits, in the compute dtype."""
    def step(params, batch):
        hidden, _ = lm.forward_hidden(cfg, params, batch["tokens"])
        return lm.unembed(cfg, params, hidden[:, -1:, :])[:, 0, :]
    return step


def make_serve_step(cfg: ModelConfig):
    def step(params, cache, tokens):
        return lm.serve_step(cfg, params, cache, tokens)
    return step
