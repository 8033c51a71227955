"""The port's checkpointer and fault-tolerance pieces against the JAX
package's: round trip (bf16 exact), async save, keep-N GC, the atomic
rename, the npz bytes against ``np.savez``'s and the CRC check on
restore, each package restoring the other's checkpoint, and the
supervisor, straggler monitor, heartbeat and rescale planner."""
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.distributed import fault_tolerance as jft
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _read_npz, _write_npz
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.training.optimizer import leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g).bfloat16(),
                   "b": torch.randn(4, generator=g)},
        "opt": {"m": torch.randn(8, 4, generator=g), "step": torch.tensor(7, dtype=torch.int32)},
        "err": {"f8": torch.randn(6, generator=g).to(torch.float8_e4m3fn)},
    }


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x,
                               y.view(torch.uint8) if y.dtype == torch.float8_e4m3fn else y)
               for x, y in zip(leaves(a), leaves(b), strict=True))


def test_roundtrip_exact(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(3, state, meta={"arch": "x"})
    template = jax.tree.map(lambda t: torch.empty_like(t, device="meta"), state)
    step, restored = ck.restore(template)
    assert step == 3 and _equal(state, restored)
    assert restored["params"]["w"].device.type == "cpu"
    m = ck.manifest(3)
    assert m["dtypes"]["params/w"] == "uint16" and m["dtypes"]["err/f8"] == "uint8"
    assert m["keys"] == sorted(m["keys"]) and m["meta"] == {"arch": "x"}


def test_async_save_snapshots_before_the_state_moves_on(tmp_path):
    """The trainer updates its state in place right after an async save:
    the checkpoint holds the state as it was at the call."""
    ck = Checkpointer(str(tmp_path))
    state = _state()
    before = jax.tree.map(torch.clone, state)
    ck.save(1, state, blocking=False)
    state["params"]["b"].add_(1.0)
    ck.wait()
    assert ck.latest_step() == 1
    _, restored = ck.restore(before)
    assert _equal(before, restored)


def test_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert ck.all_steps() == [3, 4]


def test_atomic_no_partial_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _state())
    os.makedirs(tmp_path / "tmp.6")
    (tmp_path / "tmp.6" / "arrays.npz").write_bytes(b"garbage")
    assert ck.all_steps() == [5] and ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["step_0000000005", "tmp.6"]


def test_restore_latest_specific_and_missing(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=5)
    s1, s2 = _state(1), _state(2)
    ck.save(1, s1)
    ck.save(2, s2)
    assert ck.restore(s1)[0] == 2
    step, r = ck.restore(s1, step=1)
    assert step == 1 and _equal(s1, r)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(s1)


def _jstate():
    ks = jax.random.split(jax.random.key(0), 3)
    return {
        "params": {"w": jax.random.normal(ks[0], (8, 4)).astype(jnp.bfloat16),
                   "b": jax.random.normal(ks[1], (4,))},
        "opt": {"m": jax.random.normal(ks[2], (8, 4)), "step": jnp.int32(7)},
    }


def test_port_restores_a_reference_checkpoint(tmp_path):
    js = _jstate()
    JCheckpointer(str(tmp_path)).save(4, js)
    template = {"params": {"w": torch.empty(8, 4, dtype=torch.bfloat16, device="meta"),
                           "b": torch.empty(4, device="meta")},
                "opt": {"m": torch.empty(8, 4, device="meta"),
                        "step": torch.empty((), dtype=torch.int32, device="meta")}}
    step, r = Checkpointer(str(tmp_path)).restore(template, device="cpu")
    assert step == 4
    for x, y in zip(leaves(r), jax.tree.leaves(js), strict=True):
        y = np.asarray(y)
        assert x.shape == y.shape
        assert x.view(torch.int16).numpy().tobytes() == y.tobytes() if x.dtype == torch.bfloat16 \
            else x.numpy().tobytes() == y.tobytes()


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = {k: v for k, v in _state().items() if k != "err"}
    Checkpointer(str(tmp_path)).save(9, state)
    jck = JCheckpointer(str(tmp_path))
    tmpl = jax.eval_shape(_jstate)
    step, r = jck.restore(tmpl)
    assert step == 9
    assert jck.manifest(9)["keys"] == Checkpointer(str(tmp_path)).manifest(9)["keys"]
    for x, y in zip(leaves(state), jax.tree.leaves(r), strict=True):
        y = np.asarray(y)
        assert str(y.dtype) == str(x.dtype).removeprefix("torch.")
        want = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
        assert want.tobytes() == y.tobytes()


def test_npz_is_what_np_savez_writes(tmp_path):
    """``arrays.npz``'s members are ``np.savez``'s bytes for the same
    leaves (0-d, empty, bf16 bits, fp8 bits, f32), its zip reads back
    through ``zipfile`` and ``np.load``, and a restore reads ``np.savez``'s
    file."""
    state = _state()
    state["opt"]["empty"] = torch.zeros(0, 3)
    flat = _flatten(state)
    _write_npz(str(tmp_path / "port.npz"), flat)
    np.savez(tmp_path / "numpy.npz", **flat)
    with zipfile.ZipFile(tmp_path / "port.npz") as zp, \
            zipfile.ZipFile(tmp_path / "numpy.npz") as zn:
        assert zp.testzip() is None and sorted(zp.namelist()) == sorted(zn.namelist())
        assert all(zp.read(n) == zn.read(n) for n in zn.namelist())
    with np.load(tmp_path / "port.npz") as z:
        assert all(z[k].dtype == v.dtype and np.array_equal(z[k], v) for k, v in flat.items())
    got = _read_npz(str(tmp_path / "numpy.npz"))
    assert all(got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v)
               for k, v in flat.items())


def test_restore_refuses_a_corrupt_member(tmp_path):
    """A flipped bit in a leaf's bytes fails the member's CRC-32."""
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(1, state)
    path = tmp_path / "step_0000000001" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    want = state["opt"]["m"].numpy().tobytes()
    raw[raw.find(want) + 5] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32"):
        ck.restore(state)


# ------------------------------------------------------ fault tolerance
def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    mine = ft.StragglerMonitor(n_workers=5, window=4, threshold=1.5, patience=2)
    ref = jft.StragglerMonitor(n_workers=5, window=4, threshold=1.5, patience=2)
    for _ in range(30):
        for w in range(5):
            t = float(rng.lognormal(0.0, 0.5)) * (3.0 if w == 3 and rng.random() < 0.7 else 1.0)
            mine.record(w, t)
            ref.record(w, t)
        assert mine.check() == ref.check()
        assert mine.fleet_median() == ref.fleet_median()


def test_heartbeat_matches_reference():
    mine, ref = ft.Heartbeat(3, timeout=10.0), jft.Heartbeat(3, timeout=10.0)
    for hb in (mine, ref):
        for w in range(3):
            hb.beat(w, now=100.0)
        hb.beat(0, now=115.0)
    assert mine.dead(now=115.0) == ref.dead(now=115.0) == [1, 2]


@settings(max_examples=150, deadline=None)
@given(n=st.integers(1, 4096), mp=st.sampled_from([1, 2, 4, 8, 16]),
       gb=st.sampled_from([32, 64, 128, 256, 512]), pod=st.sampled_from([None, 256]))
def test_property_plan_rescale_matches_reference(n, mp, gb, pod):
    try:
        want = jft.plan_rescale(n, mp, gb, pod)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ft.plan_rescale(n, mp, gb, pod)
        return
    got = ft.plan_rescale(n, mp, gb, pod)
    assert (got.shape, got.axes, got.global_batch, got.grad_accum) == (
        want.shape, want.axes, want.global_batch, want.grad_accum)


@pytest.mark.parametrize("fail_at", [[], [4], [4, 6], [1, 2, 3, 5]])
def test_supervisor_matches_reference(fail_at):
    def make(mod):
        calls, saved, fails = [], {"latest": None}, list(fail_at)

        def run_fn(start):
            calls.append(start)
            for s in range(start, 10):
                saved["latest"] = s
                if fails and s == fails[0]:
                    fails.pop(0)
                    raise RuntimeError("node died")
            return 9
        return mod.Supervisor(run_fn, lambda: saved["latest"], max_restarts=3), calls

    (mine, mc), (ref, rc) = make(ft), make(jft)
    outcome = []
    for sup in (mine, ref):
        try:
            outcome.append(sup.run(0))
        except RuntimeError:
            outcome.append("gave up")
    assert outcome[0] == outcome[1] and mc == rc and mine.restarts == ref.restarts
