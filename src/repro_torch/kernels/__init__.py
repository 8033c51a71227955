"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Nothing here builds or loads a kernel at import: ``_build`` is imported
by a wrapper only when it is about to launch on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses

import torch

# storage dtype of a quantized K/V -> the name of the kernels' scaled variant
SCALED = {torch.float8_e4m3fn: "fp8", torch.int8: "int8"}


def variant(kv_dtype: torch.dtype) -> str:
    """The launch counters' variant name for a K/V storage dtype."""
    return SCALED.get(kv_dtype, "unscaled")


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches made by one wrapper; a run that should have gone
    through the kernel reads ``launches`` to prove it did, ``variants`` to
    see which of the kernel's variants ("unscaled", or the "fp8"/"int8"
    scaled ones) it launched, and ``shapes`` at which head shapes
    (:func:`heads`)."""

    name: str
    launches: int = 0
    variants: dict[str, int] = dataclasses.field(default_factory=dict)
    # (variant, head shape) -> launches: a target and a smaller draft model
    # calling one kernel are counted apart
    shapes: dict[tuple[str, str], int] = dataclasses.field(default_factory=dict)

    def count(self, variant: str = "unscaled", shape: str = "") -> None:
        self.launches += 1
        self.variants[variant] = self.variants.get(variant, 0) + 1
        self.shapes[variant, shape] = self.shapes.get((variant, shape), 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.variants.clear()
        self.shapes.clear()

    def copy(self) -> LaunchCounter:
        return LaunchCounter(self.name, self.launches, dict(self.variants), dict(self.shapes))

    def set_to(self, other: LaunchCounter) -> None:
        self.launches = other.launches
        self.variants = dict(other.variants)
        self.shapes = dict(other.shapes)

    def minus(self, base: LaunchCounter) -> LaunchCounter:
        """The launches counted since ``base`` (a copy taken earlier)."""
        variants = {k: n - base.variants.get(k, 0) for k, n in self.variants.items()}
        shapes = {k: n - base.shapes.get(k, 0) for k, n in self.shapes.items()}
        return LaunchCounter(self.name, self.launches - base.launches,
                             {k: n for k, n in variants.items() if n},
                             {k: n for k, n in shapes.items() if n})

    def add(self, delta: LaunchCounter) -> None:
        self.launches += delta.launches
        for k, n in delta.variants.items():
            self.variants[k] = self.variants.get(k, 0) + n
        for k, n in delta.shapes.items():
            self.shapes[k] = self.shapes.get(k, 0) + n


def heads(Hkv: int, G: int, D: int, block_size: int | None = None) -> str:
    """The launch counters' shape key of a call: KV heads, GQA group, head
    dim (and the paged pool's block size)."""
    key = f"Hkv{Hkv} G{G} D{D}"
    return key if block_size is None else f"{key} bs{block_size}"
