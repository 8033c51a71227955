"""The train CLI on a 2-rank CPU world (gloo), ``--reduced --device cpu``
with float32 weights (the reduced llama3.2-1b, 2 layers, d_model 64, B 4
x S 16): the mesh line for ``--model-parallel 2`` and 1, a simulated
failure at step 7 restarting every rank once from the step-5 checkpoint,
a checkpoint written on data 2 x model 1 restored on data 1 x model 2
(the reference's restore onto another mesh) continuing within 1e-4
relative of the unbroken run, and that checkpoint's leaves equal to a
one-rank run's within that tolerance, in the reference's format (whole
leaves under their paths, the manifest's keys, shapes and dtypes).
"""
import json

import numpy as np
import pytest
from torch_placement_worker import run_world

from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import train as train_cli

COMMON = ["--batch", "4", "--seq", "16"]
RUNS = [
    ("tp", ["--model-parallel", "2", "--steps", "2", "--ckpt-every", "0"] + COMMON, {}),
    ("ft", ["--model-parallel", "1", "--steps", "12", "--ckpt-every", "5", "--fail-at-step", "7",
            "--ckpt-dir", "{out}/ft"] + COMMON, {}),
    ("unbroken", ["--model-parallel", "1", "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
                  "{out}/moved"] + COMMON, {}),
    # the step-2 checkpoint of the run above, restored on the other mesh
    ("moved", ["--model-parallel", "2", "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
               "{out}/moved"] + COMMON, {"moved": [2]}),
]
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli2")
    outs = run_world(2, dict(kind="train_cli", runs=RUNS), tmp)
    return tmp, outs


def _lines(o, name):
    return json.loads(str(o[f"{name}/lines"]))


@pytest.mark.parametrize("name,mesh", [("tp", "{'data': 1, 'model': 2}"),
                                       ("ft", "{'data': 2, 'model': 1}")])
def test_the_mesh_line(world, name, mesh):
    _, outs = world
    for o in outs:
        assert _lines(o, name)[0].endswith(f" mesh={mesh}"), _lines(o, name)[0]


def test_a_failure_restarts_every_rank_from_the_last_checkpoint(world):
    _, outs = world
    for o in outs:
        lines = _lines(o, "ft")
        assert int(o["ft/restarts"]) == 1
        assert "restored from step 5" in lines
        assert "done (1 restart(s)); checkpoints: [5, 10, 12]" in lines
    np.testing.assert_array_equal(outs[0]["ft/losses"], outs[1]["ft/losses"])


def test_a_checkpoint_restores_onto_another_mesh(world):
    _, outs = world
    for o in outs:
        assert "restored from step 2" in _lines(o, "moved")
        np.testing.assert_array_equal(o["moved/steps"], [2, 3])
        want = o["unbroken/losses"][2:]
        got = o["moved/losses"]
        assert float((np.abs(got - want) / want).max()) < LOSS_RTOL, (got, want)


def test_a_placed_checkpoint_is_a_one_rank_checkpoint(world, monkeypatch):
    """The step-2 checkpoint written on data 2 x model 1 holds the whole
    leaves a one-rank run writes, in its format."""
    tmp, _ = world
    monkeypatch.setattr(train_cli, "reduce_config",
                        lambda arch: reduce_config(arch).with_overrides(dtype="float32"))
    one = tmp / "one"
    train_cli.run(train_cli.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
         str(one)] + COMMON), echo=False)
    step = "step_0000000002"
    placed_m = json.loads((tmp / "moved" / step / "manifest.json").read_text())
    one_m = json.loads((one / step / "manifest.json").read_text())
    for key in ("step", "keys", "shapes", "dtypes"):
        assert placed_m[key] == one_m[key], key
    placed = np.load(tmp / "moved" / step / "arrays.npz")
    ref = np.load(one / step / "arrays.npz")
    for k in one_m["keys"]:
        a, b = placed[k], ref[k]
        if k == "opt/step":
            np.testing.assert_array_equal(a, b)
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= LOSS_RTOL * scale, k
