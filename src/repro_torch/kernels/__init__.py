"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Nothing here builds or loads a kernel at import: ``_build`` is imported
by a wrapper only when it is about to launch on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches made by one wrapper; a run that should have gone
    through the kernel reads ``launches`` to prove it did."""

    name: str
    launches: int = 0
