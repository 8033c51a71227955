"""minicpm-2b — WSD schedule, llama-like arch [arXiv:2404.06395].

kv=36 == n_heads -> MHA: the paper's own prototype regime (group=1, pure
GEMV attention, OI ~ 1).  The vocabulary, 122753, is not a multiple of
256: the tied table is padded to 122880 rows and the pad logits masked.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family=DENSE,
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
