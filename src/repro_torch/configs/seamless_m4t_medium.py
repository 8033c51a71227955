"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

The JAX package's configuration field for field: 12 encoder + 12 decoder
layers on the text/unit backbone.  The speech frontend is a stub:
precomputed frame embeddings (B, frontend_len, d_model) are the
encoder's input.  The decoder's cross-attention K/V is written once at
prefill and read at every step.
"""
from repro_torch.configs.base import ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family=ENCDEC,
    n_layers=12,           # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    rope_theta=10_000.0,
    frontend="frames",
    frontend_len=512,
)
