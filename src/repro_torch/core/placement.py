"""KV-cache placement policies (paper Fig. 4) and the activation rules.

A copy of ``repro.core.placement`` (pure Python).  The paper spreads the
KV cache over several HPU cards in two ways:

  * **batch-parallel** (the paper's preference): each card owns whole
    sequences (all heads) for a slice of the batch; results merge
    contiguously;
  * **head-parallel**: each card owns a slice of the heads for the whole
    batch; merging interleaves per-head vectors.

The reference adds **sequence** (flash-decoding: the cache split along
its positions, each rank's partial attention merged by log-sum-exp) and
**batch_seq** (batch over ``pod``/``data``, sequence over ``model``), and
``none`` (batch only, the compute layout's rows).  A policy is a rules
dict from the *logical* axes of cache and boundary tensors to mesh axes;
``models.common.resolve_spec`` drops mesh axes that do not divide.

The reference hands the rules to GSPMD, which inserts the collectives;
the port runs one process per rank and ``core.offload`` writes them out.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.models.common import Spec, resolve_spec

POLICIES = ("batch", "head", "sequence", "batch_seq", "none")

# logical axes of caches / boundary tensors
KV_CACHE_AXES = ("kv_batch", "kv_seq", "kv_heads", "head_dim")
# paged pool leaves (kernel-native, heads before positions): the block axis
# replaces the batch axis as the unit the HPU lanes split
PAGED_KV_CACHE_AXES = ("kv_blocks", "kv_heads", "kv_seq", "head_dim")


def kv_rules(policy: str) -> dict[str, tuple[str, ...]]:
    if policy == "batch":
        return {"kv_batch": ("pod", "data"), "kv_blocks": ("pod", "data"),
                "kv_heads": ("model",), "kv_seq": (), "head_dim": (), "state": ("model",)}
    if policy == "head":
        return {"kv_batch": ("pod",), "kv_blocks": ("pod",), "kv_heads": ("data", "model"),
                "kv_seq": (), "head_dim": (), "state": ("data", "model")}
    if policy == "sequence":
        return {"kv_batch": ("pod",), "kv_blocks": ("data", "model"), "kv_heads": (),
                "kv_seq": ("data", "model"), "head_dim": (), "state": ("data", "model")}
    if policy == "batch_seq":
        return {"kv_batch": ("pod", "data"), "kv_blocks": ("pod", "data", "model"),
                "kv_seq": ("model",), "kv_heads": (), "head_dim": (), "state": ("model",)}
    if policy == "none":
        return {"kv_batch": ("pod", "data"), "kv_blocks": (), "kv_heads": (), "kv_seq": (),
                "head_dim": (), "state": ()}
    raise ValueError(f"unknown kv policy {policy!r}")


def activation_rules(sequence_parallel: bool = False) -> dict[str, tuple[str, ...]]:
    """The compute side: tensor parallel over ``model``, data parallel over
    ``pod`` and ``data``; optionally the sequence over ``model``."""
    return {
        "batch": ("pod", "data"),
        "seq": ("model",) if sequence_parallel else (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "embed": (),
        "head_dim": (),
        "layers": (),
        "state": (),
        "kv_batch": ("pod", "data"),
        "kv_seq": (),
    }


def param_rules(sequence_parallel: bool = False, fsdp: bool = False) -> dict[str, tuple[str, ...]]:
    """Weights: tensor parallel over ``model``; with ``fsdp`` every
    weight's d_model axis also over ``pod`` and ``data`` (ZeRO-3)."""
    rules = dict(activation_rules(sequence_parallel))
    rules["embed"] = ("pod", "data") if fsdp else ()
    rules["batch"] = ()
    return rules


# the reference's Env fields the port does not run yet, at their defaults,
# each with the part of ROADMAP item 9b (or 9c) it waits for
NOT_PLACED_YET = {
    "sequence_parallel": (False, "item 9b: the families' training and sequence parallelism"),
    "ep_wide": (False, "item 9b: the other families serving on a mesh (MoE ep_wide)"),
    "bf16_combine": (False, "item 9b: the other families serving on a mesh (MLA bf16_combine)"),
    "moe_a2a": (False, "item 9b: the other families serving on a mesh (MoE moe_a2a)"),
    "use_pallas": (False, "item 9c: the dry run (the port's kernels are its CUDA ones)"),
}


@dataclass(frozen=True)
class Env:
    """What the model code needs to know of the runtime: the mesh's axis
    sizes (``{}``: one device, no collectives) and the policies.  The
    reference's fields and defaults; the port runs ``axes``, ``kv_policy``
    and ``offload`` (serving on the dense cache and the paged pool),
    ``sub_batches`` (the dry run's record of the engine's sub-batches: the
    engine takes its own ``sub_batches``, which a placed engine runs) and
    ``fsdp`` (training's ZeRO-3 split of every weight's d_model over the
    batch axes), and an ``Env`` that sets any other field off its default
    raises (:data:`NOT_PLACED_YET`)."""
    axes: dict[str, int] = field(default_factory=dict)
    kv_policy: str = "batch"
    offload: str = "hpu"        # "hpu" | "none"
    sub_batches: int = 1
    sequence_parallel: bool = False
    fsdp: bool = False
    ep_wide: bool = False       # experts over (pod, data, model)
    bf16_combine: bool = False  # cross-shard lse-combine partials in bf16
    moe_a2a: bool = False
    use_pallas: bool = False

    def __post_init__(self):
        off = [f"{f} waits for {why}" for f, (default, why) in NOT_PLACED_YET.items()
               if getattr(self, f) != default]
        if off:
            raise NotImplementedError(f"Env: {'; '.join(off)} (a later slice of the placement)")

    def act_rules(self) -> dict[str, tuple[str, ...]]:
        return activation_rules(self.sequence_parallel)

    def param_rules(self) -> dict[str, tuple[str, ...]]:
        return param_rules(self.sequence_parallel, self.fsdp)

    def policy(self) -> str:
        """The KV policy in force: ``none`` without the HPU offload."""
        return self.kv_policy if self.offload == "hpu" else "none"

    def kv_spec(self, logical: tuple[str | None, ...], shape) -> Spec:
        return resolve_spec(logical, kv_rules(self.policy()), self.axes, tuple(shape))

    def act_spec(self, logical: tuple[str | None, ...], shape) -> Spec:
        return resolve_spec(logical, self.act_rules(), self.axes, tuple(shape))


def lanes(axes: dict[str, int]) -> int:
    """Number of HPU lanes: the chips the KV pool spans."""
    n = 1
    for v in axes.values():
        n *= v
    return n
