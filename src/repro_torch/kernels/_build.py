"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries are named by a hash of their source and the
flags, so an edited kernel rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` when set, else
``build/repro_torch_kernels/`` at the root of the checkout.

Nothing here runs at import: this module is imported only by a kernel
wrapper that is about to launch on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}.{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict[str, float]:
    """Compile every source not yet built, one ``nvcc`` each, all in
    parallel.  Returns seconds per source built (empty if all cached)."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in sources() if not _lib_path(n).exists()}
    done, errors = {}, []
    for name, (proc, tmp, out) in jobs.items():
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as err:      # report every failed source, not the first
            errors.append(str(err))
        done[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
