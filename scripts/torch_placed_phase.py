"""Time one tree's placed phase of ``chip_smoke.py`` on the card.

  python3 scripts/torch_placed_phase.py [ROOT]

Imports ``ROOT/chip_smoke.py`` (default: this checkout; a parent tree
unpacked under ``build/`` to compare two trees in one call, in turns),
builds ROOT's kernels, loads llama3.2-1b at full width, serves the
one-rank paths the placed phase is held to (``dense`` and ``dense-8``: the
serve shape's first 16 requests through the CUDA graphs, whose tokens are
those the full run's first 16 requests get) and runs ROOT's
``placed_phase``, checks included.  Prints its lines, then one JSON line:
the root, the card, the placed phase's seconds and the script's.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def main(root: Path) -> None:
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)             # puts ROOT/src first on sys.path
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    model, params = cs.load_model()
    by_path = {}
    for label, extra in (("dense", []), ("dense-8", ["--slots", "8"])):
        args = serve.build_parser().parse_args(cs.SERVE_FLAGS + ["--requests", "16",
                                                                 "--graphs", "on"] + extra)
        res = serve.serve(args, model, params)
        by_path[label] = cs.PathRun({}, res.stats, [r.out_tokens for r in res.driver.submitted],
                                    res.wall_s, res)
    t1 = time.perf_counter()
    cs.placed_phase(model, params, by_path)
    placed_s = time.perf_counter() - t1
    print(json.dumps({"root": str(root), "card": smi, "placed_s": round(placed_s, 1),
                      "script_s": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main(Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
         .resolve())
