"""internvl2-76b — InternViT + LM backbone (llama3-70b-like) [arXiv:2404.16821].

Only the transformer backbone is modelled, as in the JAX package: the
InternViT frontend is a stub whose precomputed patch embeddings, of
length ``frontend_len``, are prepended to the token embeddings
(``models/dense.py:prefill(..., embeds=)``) and take cache positions.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family=DENSE,
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    frontend="patches",
    frontend_len=256,
)
