"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke|--no-smoke] [--device cpu]`` — the port of
``repro/launch/train.py``.

Runs the fault-tolerant loop with scda checkpointing on one device: the
GPU, unless ``--device cpu`` is given.  Every arch of the dense, moe, ssm
and hybrid families trains (``--arch granite-moe-3b-a800m`` adds its
layers' load-balance loss at the reference's weight, 0.01).  The encdec
and vlm families are refused: they train on frame or patch embeddings
that the synthetic token pipeline does not yield (nor does the
reference's); ``train.loop.train`` trains them from a data source that
adds those inputs.  ``--data-par`` and ``--model-par`` other than 1 raise
:class:`NotImplementedError`: the port has no mesh yet.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import List, Optional

from repro_torch.configs import REGISTRY, get_config, smoke
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced same-family config (the default)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro-ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-compressed", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-par", type=int, default=1,
                    help="data axis size (only 1: one device)")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError(
            f"--data-par {args.data_par} --model-par {args.model_par}: the "
            f"port trains on one device until the distributed slice")
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = get_config(args.arch)
    missing = {"encdec": "enc_embeds (the encoder's frame embeddings)",
               "vlm": "patch_embeds (the image's patch embeddings)"}
    if cfg.family in missing:
        ap.error(f"--arch {args.arch}: the {cfg.family} family trains on "
                 f"{missing[cfg.family]}, which the synthetic token "
                 f"pipeline does not yield; call train.loop.train with a "
                 f"data source that adds them")
    if args.smoke:
        cfg = smoke(cfg)
    loop = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=f"{args.ckpt_dir}/{cfg.name}", ckpt_keep=3,
        ckpt_compressed=args.ckpt_compressed,
        grad_compress=args.grad_compress)
    out = train(cfg, loop, AdamWConfig(lr=args.lr, total_steps=args.steps),
                seq_len=args.seq_len, global_batch=args.global_batch,
                device=args.device)
    out["manager"].close()
    print(f"done: start_step={out['start_step']} "
          f"final_loss={out['losses'][-1]:.4f} "
          f"checkpoints={out['manager'].all_steps()}")


if __name__ == "__main__":
    main()
