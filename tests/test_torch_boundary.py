"""The port's package boundary: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads no ``jax`` module and no module of ``repro``."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CODE = r"""
import importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_imports_nothing_of_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", CODE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout            # every module was walked
    assert bad == "[]", bad
