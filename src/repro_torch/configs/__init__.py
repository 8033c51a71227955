"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Arch ids accept dashes, underscores or dots interchangeably.  All ten of
the reference's architectures: the dense family (yi-34b, llama3.2-1b,
llama3.2-3b, minicpm-2b and internvl2-76b's backbone), the MoE moonshot,
deepseek-v3 (MLA + MoE), rwkv6-7b, zamba2-1.2b (mamba2 + a shared
attention block) and seamless-m4t-medium (encoder-decoder).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import DEEPSEEK, DENSE, MOE, ModelConfig  # noqa: F401

# arch id -> module name under repro_torch.configs
ARCHS: dict[str, str] = {
    "yi-34b": "yi_34b",
    "llama3.2-1b": "llama3_2_1b",
    "llama3.2-3b": "llama3_2_3b",
    "minicpm-2b": "minicpm_2b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def _canon(arch: str) -> str:
    key = arch.strip().lower().replace("_", "-")
    for k in ARCHS:
        if key == k or key == k.replace(".", "-") or key.replace("-", "") == k.replace(
            ".", ""
        ).replace("-", ""):
            return k
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[_canon(arch)]}")
    return mod.CONFIG

