"""The placed train step on an 8-rank CPU world (gloo) against the JAX
train step on one device, on the same weights and batches.

``tests/test_sharded.py``'s reduced llama (2 layers, d_model 64, 4/2
heads of 16, d_ff 128, vocab 256, tied embeddings), B 4 x S 8 with a
mask that drops some positions, 3 steps of AdamW at the reference's
defaults (test_sharded.py's: lr 3e-4 after 100 warmup steps, clip 1.0);
the weights are the JAX model's ``init(jax.random.key(0))``
handed over as numpy.  One world (``tests/torch_placement_worker.py``)
runs every case on a mesh of its first ranks:

* ``fsdp``: data 4 x model 2 with ``Env(fsdp=True)`` (test_sharded.py's
  train case): every weight's d_model also over ``data``;
* ``zero1``: data 2 x model 1, the moments sharded over ``data``;
* ``tp``: data 1 x model 2;
* ``int8``: data 4 x model 2 under int8 gradient compression;
* ``accum``: data 2 x model 2, ``grad_accum`` 2.

In float32 each step's loss and grad norm are within 1e-4 relative of the
reference's, every rank reports the same loss bit for bit, and the
params after 3 steps differ from the reference's by at most 2 lr x 3
anywhere (an Adam step moves an element by about lr x sign(g), so a
near-zero gradient whose sign flips under another summation order moves
it by 2 lr) and by at most 1e-6 on at least 99.9% of the elements.  In
bf16 the losses are within 5e-2 (test_sharded.py's bound for GSPMD's own
sharded run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_placement_worker import flat, run_world

from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env as JEnv
from repro.models.registry import build_model as jbuild_model
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.placement import Env
from repro_torch.models.registry import build_model
from repro_torch.training.trainer import make_train_step

B, S, VOCAB, STEPS, WORLD = 4, 8, 256, 3, 8
# the reference's defaults (test_sharded.py's): lr 3e-4 after 100 warmup steps
TRAIN = dict()
CASES = [
    dict(name="fsdp", mesh={"data": 4, "model": 2}, fsdp=True, grad_accum=1, compression="none"),
    dict(name="zero1", mesh={"data": 2, "model": 1}, fsdp=False, grad_accum=1,
         compression="none"),
    dict(name="tp", mesh={"data": 1, "model": 2}, fsdp=False, grad_accum=1, compression="none"),
    dict(name="int8", mesh={"data": 4, "model": 2}, fsdp=False, grad_accum=1, compression="int8"),
    dict(name="accum", mesh={"data": 2, "model": 2}, fsdp=False, grad_accum=2,
         compression="none"),
]
NAMES = [c["name"] for c in CASES]
DTYPES = ("float32", "bfloat16")
LOSS_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _jcfg(dtype):
    return jreduce_config("llama3.2-1b").with_overrides(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=VOCAB, head_dim=16,
        dtype=dtype)


def _reference(dtype, batches, grad_accum, compression):
    """The JAX single-device train step: losses, grad norms, final params."""
    model = jbuild_model(_jcfg(dtype), JEnv())
    run = JRunConfig(model=model.cfg, parallel=JParallelConfig(
        grad_accum=grad_accum, grad_compression=compression), train=JTrainConfig(**TRAIN))
    init_state, train_step, _, _ = jmake_train_step(model, run)
    state = init_state(jax.random.key(0))
    step = jax.jit(train_step)
    losses, norms = [], []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"loss": np.asarray(losses), "grad_norm": np.asarray(norms),
            "params": {k: np.asarray(v, np.float32) for k, v in flat(state["params"])}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train8")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, VOCAB, (B, S + 1))
        batches.append({"inputs": toks[:, :-1].astype(np.int32),
                        "targets": toks[:, 1:].astype(np.int32),
                        "mask": (rng.random((B, S)) < 0.8).astype(np.float32)})
    np.savez(tmp / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                     for k, v in b.items()})
    for dtype in DTYPES:
        params = jbuild_model(_jcfg(dtype), JEnv()).init(jax.random.key(0))
        np.savez(tmp / f"params_{dtype}.npz",
                 **{k: np.asarray(v, np.float32) for k, v in flat(params)})
    want = {}
    for dtype in DTYPES:
        for run in {(c["grad_accum"], c["compression"]) for c in CASES}:
            want[(dtype, *run)] = _reference(dtype, batches, *run)
    outs = run_world(WORLD, dict(kind="train", cases=CASES, dtypes=list(DTYPES), vocab=VOCAB,
                                 steps=STEPS, train=TRAIN), tmp)
    return want, outs, batches


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _want(want, name, dtype):
    c = _case(name)
    return want[(dtype, c["grad_accum"], c["compression"])]


def _ranks(name):
    m = _case(name)["mesh"]
    return m["data"] * m["model"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_losses_match_the_single_device_reference(world, name, dtype):
    want, outs, _ = world
    ref = _want(want, name, dtype)
    got = outs[0][f"{name}/{dtype}/loss"]
    err = np.abs(got - ref["loss"])
    if dtype == "float32":
        err = err / np.abs(ref["loss"])
    assert float(err.max()) < LOSS_TOL[dtype], (got, ref["loss"])


@pytest.mark.parametrize("name", NAMES)
def test_grad_norms_match_the_single_device_reference(world, name):
    want, outs, _ = world
    ref = _want(want, name, "float32")["grad_norm"]
    got = outs[0][f"{name}/float32/grad_norm"]
    assert float((np.abs(got - ref) / ref).max()) < 1e-4, (got, ref)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_rank_reports_the_same_loss_bit_for_bit(world, name, dtype):
    _, outs, _ = world
    bits = [o[f"{name}/{dtype}/loss_bits"] for o in outs[:_ranks(name)]]
    for b in bits[1:]:
        np.testing.assert_array_equal(b, bits[0])
    for o in outs[_ranks(name):]:                 # ranks outside the mesh ran nothing
        assert f"{name}/{dtype}/loss" not in o


@pytest.mark.parametrize("name", NAMES)
def test_params_after_three_steps_match_the_reference(world, name):
    want, outs, _ = world
    ref = _want(want, name, "float32")["params"]
    lr = JTrainConfig(**TRAIN).lr
    n = above = 0
    worst = 0.0
    for path, w in ref.items():
        got = outs[0][f"{name}/float32/params/{path}"]
        assert got.shape == w.shape, path
        d = np.abs(got - w)
        worst = max(worst, float(d.max()))
        above += int((d > 1e-6).sum())
        n += d.size
    print(f"[{name}] params: {above} of {n} elements differ by more than 1e-6; "
          f"largest difference {worst:.3e}")
    assert worst <= 2 * lr * STEPS
    assert above <= 1e-3 * n


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_shards_of_params_and_moments(world, name):
    """Each rank holds the shard of the params and of ``m`` that the
    reference's ``state_specs()`` on the same mesh gives it (ZeRO-1: the
    f32 moments over ``data`` whatever the params are)."""
    _, outs, _ = world
    c = _case(name)
    jmodel = jbuild_model(_jcfg("float32"), JEnv(axes=c["mesh"], fsdp=c["fsdp"]))
    specs = jmake_train_step(jmodel, JRunConfig(model=jmodel.cfg, train=JTrainConfig()))[2]()
    shapes = dict(flat(jmodel.init(jax.random.key(0))))

    def shard_bytes(tree):
        n = 0
        for path, spec in _spec_leaves(tree):
            split = 1
            for part in spec:
                for a in (part,) if isinstance(part, str) else (part or ()):
                    split *= c["mesh"][a]
            n += 4 * shapes[path].size // split
        return n

    for o in outs[:_ranks(name)]:
        assert int(o[f"{name}/float32/m_bytes"]) == shard_bytes(specs["opt"]["m"])
        assert int(o[f"{name}/float32/param_bytes"]) == shard_bytes(specs["params"])


def test_fsdp_prefill_matches_the_reference(world):
    """Serving gathers FSDP's split of the weights too."""
    want, outs, batches = world
    m = jbuild_model(_jcfg("float32"), JEnv())
    params = m.init(jax.random.key(0))
    toks = jnp.asarray(batches[0]["inputs"])
    ref, _ = jax.jit(m.prefill)(params, toks, m.init_cache(B, S))
    for o in outs[:_ranks("fsdp")]:
        assert float(np.abs(o["fsdp/float32/prefill"] - np.asarray(ref)).max()) < 1e-4


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_state_specs_match_the_reference(compression):
    """``state_specs()`` on a data 2 x model 2 mesh equals the reference's
    leaf for leaf (tests/test_training.py's case), with ZeRO-1's moments."""
    axes = {"data": 2, "model": 2}
    jmodel = jbuild_model(_jcfg("float32"), JEnv(axes=axes))
    jspecs = jmake_train_step(jmodel, JRunConfig(model=jmodel.cfg, parallel=JParallelConfig(
        grad_compression=compression), train=JTrainConfig()))[2]()
    cfg = reduce_config("llama3.2-1b", vocab=VOCAB)
    model = build_model(cfg, "cpu", Env(axes=axes), _FakeMesh(axes))
    specs = make_train_step(model, RunConfig(model=cfg, parallel=ParallelConfig(
        grad_compression=compression), train=TrainConfig()))[2]()
    flat_j = dict(_spec_leaves(jspecs))
    flat_t = dict(_spec_leaves(specs))
    assert sorted(flat_j) == sorted(flat_t)
    for k, s in flat_j.items():
        assert tuple(flat_t[k]) == tuple(s), k


class _FakeMesh:
    """Axis names and sizes only (no world): ``build_model`` checks them,
    and ``state_specs`` reads nothing else."""

    def __init__(self, axes):
        self.axis_names, self.shape = tuple(axes), tuple(axes.values())


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_state_specs_cover_the_state():
    """On one device the specs' tree is the state's (the reference's
    tests/test_training.py::test_state_specs_match_state_tree) and every
    leaf is whole."""
    cfg = reduce_config("llama3.2-1b")
    _, _, state_specs, state_shapes = make_train_step(build_model(cfg, "cpu"), RunConfig(
        model=cfg, parallel=ParallelConfig(grad_compression="int8"), train=TrainConfig()))
    keys = [k for k, _ in _spec_leaves(state_specs())]
    assert keys == [k for k, _ in _spec_leaves(state_shapes())]
    assert all(tuple(s) == () for _, s in _spec_leaves(state_specs()))
