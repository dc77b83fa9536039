"""Model definitions: layers and the dense LM core."""
from repro_torch.models.lm import (cast_params, compute_dtype, forward,
                                   forward_hidden, init_cache, init_lm,
                                   param_bytes, serve_step, unembed)

__all__ = ["cast_params", "compute_dtype", "forward", "forward_hidden",
           "init_cache", "init_lm", "param_bytes", "serve_step", "unembed"]
