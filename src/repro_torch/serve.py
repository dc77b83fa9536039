"""Batched serving: restore weights from an scda checkpoint, decode tokens.

The port of ``examples/serve_decode.py`` on every family: the weights are
saved with :func:`repro_torch.checkpoint.save`, restored with
``restore(like=)`` onto the serving device (cast once to the compute
dtype), and a batch of requests is fed token by token through
``serve_step``, then decoded greedily.  Token ids, the cache position and
the argmax stay on the device: the loop reads nothing back until it ends.
An encdec model (whisper) first encodes seeded random frame embeddings
(its audio frontend is a stub, as in the reference) into
``cache["enc_out"]``; a vlm model (llava) serves text, as the
reference's ``serve_step`` does.

Run:  PYTHONPATH=src python -m repro_torch.serve [--arch qwen3-1.7b]
      (``--arch falcon-mamba-7b`` serves the Mamba1 model, ``--arch
      zamba2-2.7b`` the hybrid of Mamba2 layers and shared attention,
      ``--arch granite-moe-3b-a800m`` the MoE model of 40 experts, top-8,
      ``--arch whisper-medium`` the encoder-decoder, ``--arch
      llava-next-mistral-7b`` the VLM's text decoder; ``--device cpu
      --smoke`` runs the reduced config on the host)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (cast_params, compute_dtype, encode,
                                init_cache, init_lm)
from repro_torch.runtime import resolve_device
from repro_torch.train.step import make_serve_step


def load_weights(cfg: ModelConfig, path: str, like, *, device="cuda"):
    """Restore ``path`` onto ``device`` in the structure of ``like`` and
    cast it once to the compute dtype.  Returns ``(params, step)``."""
    dev = resolve_device(device)
    params, step = restore(path, like=like, device=dev)
    return cast_params(params, compute_dtype(cfg)), step


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen_len: int,
             *, max_len: int, enc_out: Optional[torch.Tensor] = None,
             on_step: Optional[Callable[[int, torch.Tensor], None]] = None) \
        -> Dict[str, object]:
    """Feed ``prompts`` (B, P) token by token through ``serve_step``, then
    decode ``gen_len`` tokens greedily.  An encdec model takes the
    encoder's output ``enc_out`` (B, max_source_len, d; :func:`encode`),
    which every decode step's cross-attention reads from the cache.

    Returns ``{"tokens": (B, gen_len) int32, "prompt_logits": logits after
    the last prompt token, "cache": the cache}``.  ``on_step(i, logits)``
    sees every step's logits (step i feeds token i of the sequence).
    """
    step_fn = make_serve_step(cfg)
    batch, prompt_len = prompts.shape
    if prompt_len < 1 or prompt_len + gen_len > max_len:
        raise ValueError(f"prompt {prompt_len} + {gen_len} new tokens do "
                         f"not fit a cache of {max_len}")
    cache = init_cache(cfg, batch, max_len, device=prompts.device)
    if (enc_out is None) != (cfg.family != "encdec"):
        raise ValueError(f"{cfg.name}: enc_out is for the encdec family's "
                         f"decoder, and that family needs it")
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    logits = None
    for i in range(prompt_len):
        logits, cache = step_fn(params, cache, prompts[:, i:i + 1])
        if on_step is not None:
            on_step(i, logits)
    prompt_logits = logits
    generated: List[torch.Tensor] = []
    tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    for j in range(gen_len):
        generated.append(tok)
        logits, cache = step_fn(params, cache, tok)
        if on_step is not None:
            on_step(prompt_len + j, logits)
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    return {"tokens": torch.cat(generated, dim=1), "prompt_logits":
            prompt_logits, "cache": cache}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)

    with tempfile.TemporaryDirectory(prefix="repro-torch-serve-") as tmp:
        # "training" produced a checkpoint…
        ckpt = os.path.join(tmp, "w.scda")
        params = init_lm(cfg, args.seed, device=dev,
                         dtype=compute_dtype(cfg))
        save(ckpt, params, step=1000)
        print(f"checkpoint: {os.path.getsize(ckpt) / 1e6:.1f} MB at {ckpt}")
        # …the serving job restores it and serves a batch.
        weights, step = load_weights(cfg, ckpt, like=params, device=dev)
        del params
    print(f"restored step={step}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc_out = None
        if cfg.family == "encdec":   # the audio frontend is a stub
            frames = torch.randn((args.batch, cfg.max_source_len,
                                  cfg.d_model), generator=gen, device=dev)
            enc_out = encode(cfg, weights, frames)
        out = generate(cfg, weights, prompts, args.gen_len,
                       max_len=args.max_len, enc_out=enc_out)
    tokens = out["tokens"].cpu()  # the loop's one host read
    dt = time.perf_counter() - t0
    total = args.batch * (args.prompt_len + args.gen_len)
    print(f"served {args.batch} requests × {args.gen_len} new tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {dev})")
    for b in range(args.batch):
        print(f"  req{b}: {tokens[b, :12].tolist()}…")
    assert int(out["cache"]["pos"]) == args.prompt_len + args.gen_len
    return out


if __name__ == "__main__":
    main()
