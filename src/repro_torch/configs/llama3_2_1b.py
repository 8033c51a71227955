"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family=DENSE,
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    rope_theta=500_000.0,
    tie_embeddings=True,
)
