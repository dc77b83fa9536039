"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke|--no-smoke] [--device cpu]`` — the port of
``repro/launch/train.py``.

Runs the fault-tolerant loop with scda checkpointing on the GPU, unless
``--device cpu`` is given.  Every arch of the dense, moe, ssm and hybrid
families trains (``--arch granite-moe-3b-a800m`` adds its layers'
load-balance loss at the reference's weight, 0.01).  The encdec and vlm
families are refused: they train on frame or patch embeddings that the
synthetic token pipeline does not yield (nor does the reference's);
``train.loop.train`` trains them from a data source that adds those
inputs.

``--data-par D --model-par M`` trains under a (D, M) mesh: D·M ranks
joined in a gloo group (``distributed.ranks.spawn_ranks``; on a GPU
machine each on device ``rank % device_count``, so on one card every rank
shares it; with ``--device cpu`` CPU ranks), each running the loop on
``make_host_mesh(D, M)``: FSDP over data, tensor parallelism over model,
one scda file a save written by every rank.  ``--data-par 0`` (the
default) is one rank per visible device, as in the reference; one rank
is the single-device path, with no group and no mesh.
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


def _run(cfg, loop, opt, args, mesh_shape=None):
    """The loop on this process (a spawned rank when ``mesh_shape`` is
    given, on ``make_host_mesh(*mesh_shape)``); a summary of its run."""
    mesh = None
    if mesh_shape is not None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(*mesh_shape, device=args["device"])
    out = train(cfg, loop, opt, seq_len=args["seq_len"],
                global_batch=args["global_batch"], device=args["device"],
                mesh=mesh)
    out["manager"].close()
    return {"start_step": out["start_step"], "losses": out["losses"],
            "checkpoints": out["manager"].all_steps()}


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
    ap.add_argument("--data-par", type=int, default=0,
                    help="data axis size (0 = one rank per visible device)")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

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
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)
    run = dict(device=args.device, seq_len=args.seq_len,
               global_batch=args.global_batch)
    if args.model_par < 1 or args.data_par < 0:
        ap.error("--model-par must be at least 1, --data-par at least 0")
    dp = args.data_par or max(1, _visible_devices(args.device)
                              // args.model_par)
    if dp * args.model_par == 1:
        out = _run(cfg, loop, opt, run)
    else:
        from repro_torch.distributed.ranks import spawn_ranks
        out = spawn_ranks(_run, dp * args.model_par, cfg, loop, opt, run,
                          (dp, args.model_par),
                          device="cpu" if args.device == "cpu" else "cuda")[0]
    print(f"done: start_step={out['start_step']} "
          f"final_loss={out['losses'][-1]:.4f} "
          f"checkpoints={out['checkpoints']}")


def _visible_devices(device: str) -> int:
    """Devices one rank each takes: the visible GPUs, or 1 on the CPU."""
    if device == "cpu":
        return 1
    import torch
    return torch.cuda.device_count()


if __name__ == "__main__":
    main()
