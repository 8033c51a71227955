"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family=DENSE,
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    tie_embeddings=True,
)
