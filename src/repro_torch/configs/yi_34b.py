"""yi-34b — dense llama-arch GQA [arXiv:2403.04652]; head_dim 128 from
d_model / n_heads."""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family=DENSE,
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
)
