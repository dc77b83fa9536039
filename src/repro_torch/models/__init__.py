"""Model definitions: layers, Mamba1 and Mamba2 blocks and the LM core
(dense, moe, ssm, hybrid, encdec and vlm families)."""
from repro_torch.models.lm import (cast_params, compute_dtype, encode,
                                   forward, forward_hidden, init_cache,
                                   init_lm, lm_loss, param_bytes, serve_step,
                                   unembed)

__all__ = ["cast_params", "compute_dtype", "encode", "forward",
           "forward_hidden", "init_cache", "init_lm", "lm_loss",
           "param_bytes", "serve_step", "unembed"]
