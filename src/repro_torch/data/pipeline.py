"""Deterministic synthetic token pipeline — the port of
``repro/data/pipeline.py``.

Every (step, row) of the global batch is a pure function of the seed, so a
restart reproduces its batches from the step counter alone.  ``_tokens``
and ``global_batch_shard`` are the reference's numpy code unchanged, so
both packages feed a run the same tokens.  :meth:`sharded_batch` returns
the whole global batch as tensors on one device, or with a mesh as
DTensors under ``sharding.batch_spec`` (each rank keeps its rows); labels
are int64, as ``gather`` wants them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish stationary distribution over the vocabulary.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._cdf = np.cumsum(probs / probs.sum())

    def _tokens(self, step: int, row_start: int, rows: int) -> np.ndarray:
        """Rows [row_start, row_start+rows) of the global batch at ``step``."""
        cfg = self.cfg
        # one RNG per global row → row content independent of partition
        out = np.empty((rows, cfg.seq_len + 1), np.int32)
        for i in range(rows):
            rng = np.random.Generator(np.random.Philox(
                np.random.SeedSequence(entropy=cfg.seed,
                                       spawn_key=(step, row_start + i))))
            u = rng.random(cfg.seq_len + 1)
            out[i] = np.searchsorted(self._cdf, u).astype(np.int32)
        return out

    def global_batch_shard(self, step: int, row_start: int,
                           rows: int) -> Dict[str, np.ndarray]:
        """tokens/labels for rows of the global batch (host's shard)."""
        seq = self._tokens(step, row_start, rows)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def sharded_batch(self, step: int, device, mesh=None,
                      extra: Optional[Dict[str, torch.Tensor]] = None) \
            -> Dict[str, torch.Tensor]:
        """The full global batch on ``device``: int32 tokens, int64
        labels.  With ``mesh`` (a ``DeviceMesh``) each is a DTensor
        batch-sharded on the data axes (``sharding.batch_spec``): the
        rank's rows on ``device``, the same values as without.  ``extra``
        entries (frame or patch embeddings, say) join the batch as
        given."""
        host = self.global_batch_shard(step, 0, self.cfg.global_batch)
        batch = {
            "tokens": torch.from_numpy(np.ascontiguousarray(host["tokens"]))
            .to(device),
            "labels": torch.from_numpy(host["labels"].astype(np.int64))
            .to(device)}
        if mesh is not None:
            from repro_torch.distributed import sharding as sh
            spec = sh.batch_spec(mesh, 2)
            batch = {k: sh.distribute(v, mesh, spec)
                     for k, v in batch.items()}
        if extra:
            batch.update(extra)
        return batch
