"""End-to-end driver on the PyTorch port: train an LM with
checkpoint/restart and a node failure — the counterpart of
``train_restart.py``.

Phase 1  trains qwen3's smoke config through
         ``repro_torch.train.loop.train``, checkpointing every K steps,
         then "the node dies" (an injected failure halfway).
Phase 2  reboots the job — same entry point — which restores the newest
         scda checkpoint and finishes the run.  The loss continues from
         where it left off (the synthetic data pipeline is a pure function
         of the step counter).

It trains on ``--device`` (the GPU unless ``--device cpu``): a ~1M-param
model for 60 steps by default; ``--full`` is the ~100M configuration.

Run:  PYTHONPATH=src python examples/torch_train_restart.py [--full]
"""
import argparse
import dataclasses
import logging
import math
import tempfile

from repro_torch.configs import get_config, smoke
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import resolve_device
from repro_torch.train.loop import TrainLoopConfig, train


def model_config(full: bool):
    base = smoke(get_config("qwen3-1.7b"))
    if not full:
        return base
    # ~100M-param member of the same family
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=12, d_model=768, vocab=32_000,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048)


def main(argv=None):
    """Train, die halfway, resume; returns the resumed step, the losses
    of the resumed run and the checkpoints kept."""
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s: %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, a few hundred steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_config(args.full)
    steps = args.steps or (300 if args.full else 60)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-train-")
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=max(5, steps // 6),
                           ckpt_dir=ckpt_dir, log_every=max(1, steps // 12))
    die_at = steps // 2
    seq, gb = (512, 32) if args.full else (64, 8)

    print(f"=== phase 1: train to step {die_at}, then the node dies")
    try:
        train(cfg, loop, AdamWConfig(total_steps=steps),
              seq_len=seq, global_batch=gb,
              hooks={"should_die": lambda s: s == die_at}, device=device)
    except SystemExit as e:
        print(f"    {e}")

    print("=== phase 2: reboot — restore latest checkpoint, finish the run")
    out = train(cfg, loop, AdamWConfig(total_steps=steps),
                seq_len=seq, global_batch=gb, device=device)
    assert out["start_step"] >= 0, "restart did not restore a checkpoint"
    print(f"resumed from step {out['start_step']}; "
          f"final loss {out['losses'][-1]:.4f}")
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss {first:.4f} → {last:.4f} "
          f"({'improving' if last < first else 'flat'})")
    kept = out["manager"].all_steps()
    print(f"checkpoints kept: {kept}")
    losses = [float(x) for x in out["losses"]]
    assert all(math.isfinite(x) for x in losses), losses
    return {"start_step": out["start_step"], "die_at": die_at,
            "losses": losses, "kept": kept, "device": str(device),
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
