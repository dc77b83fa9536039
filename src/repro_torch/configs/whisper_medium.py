"""whisper-medium — encoder-decoder audio transformer [arXiv:2212.04356;
unverified].

24 encoder + 24 decoder layers, d_model 1024, 16H MHA (kv=16, head_dim 64),
gelu d_ff 4096, vocab 51865.  The conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, 1024).  Decode shapes
exercise the decoder with self-attn KV cache + cross-attention.
long_500k skipped (full attention, 448-token decoder by design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    vocab=51_865,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_type="gelu",
    max_source_len=1500,
    frontend="audio",
    tie_embeddings=True,
)
