"""The fault-tolerant training loop: restore-or-init, step, async
checkpoint — the port of ``repro/train/loop.py``.

Every run is a restart: boot goes through
``CheckpointManager.restore_or_init``, so a fresh start and a crash
recovery are the same code path.  The state is ``{"params": f32 master
weights, "opt": AdamWState}`` on one device, or with ``mesh`` DTensors
on it: parameters under ``sharding.params_shardings``, AdamW moments
placed like their parameters, the count whole on every rank.  Its
structure for the restore comes from a shape-only model
(``init_lm(device="meta")``), so a resume builds no second state, and a
resume onto another mesh is the same restore: scda's file is the same
whatever mesh wrote it.  Under a mesh every rank runs the loop, and the
manager saves through ``TorchDistComm`` (each rank writes the blocks it
owns; rank 0 commits).  Checkpoint failures are logged, never raised
into the loop; the final save blocks.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import init_lm
from repro_torch.optim import adamw
from repro_torch.runtime import resolve_device
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro-ckpts")
    ckpt_keep: int = 3
    ckpt_compressed: bool = False
    log_every: int = 10
    seed: int = 0
    grad_compress: bool = False


def init_state(cfg: ModelConfig, seed: int, device,
               mesh=None) -> Dict[str, Any]:
    """Fresh f32 master weights from ``seed`` and zero AdamW moments;
    ``device="meta"`` gives the structure only.  With ``mesh`` the
    parameters are DTensors under ``params_shardings`` (every rank draws
    the same weights and keeps its blocks) or, on ``meta``, the restore
    targets of that layout; the moments are placed like them."""
    params = init_lm(cfg, seed, device=device)
    if mesh is not None:
        params = _placed(params, mesh, torch.device(device).type == "meta")
    return {"params": params, "opt": adamw.init(params)}


def _placed(params, mesh, targets_only: bool):
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.distributed import sharding as sh
    named, rebuild = flatten_named(params)
    if targets_only:
        return sh.params_shardings(mesh, params)
    return rebuild([sh.distribute(t, mesh, sh.leaf_spec(mesh, n, t))
                    for n, t in named])


def train(cfg: ModelConfig, loop: TrainLoopConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          data: Optional[SyntheticTokens] = None,
          seq_len: int = 128, global_batch: int = 8,
          hooks: Optional[Dict[str, Callable]] = None,
          device="cuda", mesh=None) -> Dict[str, Any]:
    """Run (or resume) a training job on ``device`` (the GPU unless
    ``device="cpu"``); returns final metrics and state.  With ``mesh`` (a
    ``DeviceMesh`` over every rank, each of which calls this) the policy
    is set to it and the state, batches and step are the mesh's.

    ``hooks``: ``on_step(step, state, metrics)`` after each step,
    ``should_die(step)`` to inject a failure after the step's save (the
    save is waited for, then ``SystemExit`` is raised).
    """
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.distributed import sharding as sh
        sh.set_mesh(mesh)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=loop.total_steps)
    data = data or SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=loop.seed))
    hooks = hooks or {}

    grad_transform = None
    if loop.grad_compress:
        from repro_torch.distributed.grad_compress import compress_grads
        grad_transform = compress_grads

    loss_chunk = min(256, data.cfg.seq_len)
    step_fn = make_train_step(cfg, opt_cfg, loss_chunk=loss_chunk,
                              grad_transform=grad_transform)

    comm = None
    if mesh is not None:
        from repro_torch.core.comm import TorchDistComm
        comm = TorchDistComm()
    mgr = CheckpointManager(loop.ckpt_dir, keep=loop.ckpt_keep,
                            compressed=loop.ckpt_compressed, comm=comm)
    state, start_step = mgr.restore_or_init(
        lambda: init_state(cfg, loop.seed, dev, mesh),
        like=init_state(cfg, loop.seed, "meta", mesh), device=dev)
    if start_step >= 0:
        log.info("resumed from checkpoint at step %d", start_step)
    metrics: Dict[str, Any] = {}
    losses = []
    t0 = time.time()
    for step in range(start_step + 1, loop.total_steps):
        batch = (data.sharded_batch(step, dev) if mesh is None
                 else data.sharded_batch(step, dev, mesh))
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        state = {"params": params, "opt": opt}
        losses.append(float(metrics["loss"]))
        if step % loop.log_every == 0 or step == loop.total_steps - 1:
            log.info("step %d loss %.4f gnorm %.3f lr %.2e (%.2fs)",
                     step, float(metrics["loss"]),
                     float(metrics["grad_norm"]), float(metrics["lr"]),
                     time.time() - t0)
        if "on_step" in hooks:
            hooks["on_step"](step, state, metrics)
        if loop.ckpt_every and step % loop.ckpt_every == 0 and step > 0:
            try:
                mgr.save(step, state)
            except Exception as e:  # noqa: BLE001 — never crash the job
                log.error("checkpoint save failed (continuing): %s", e)
        if "should_die" in hooks and hooks["should_die"](step):
            # failure-injection hook used by tests and the chip smoke run
            mgr.wait()
            raise SystemExit(f"injected failure at step {step}")
    try:
        mgr.save(loop.total_steps - 1, state, blocking=True)
    except Exception as e:  # noqa: BLE001
        log.error("final checkpoint failed: %s", e)
    return {"state": state, "metrics": metrics, "losses": losses,
            "start_step": start_step, "manager": mgr}
