"""The port's GPipe pipeline, ``int8_psum`` and ``collective_bytes_of_spec``
against the reference's.

``pipeline_forward`` runs on a 4-rank CPU world (gloo, one stage per
rank, ``tests/torch_placement_worker.py``) on ``tests/test_pipeline_pp.py``'s
toy: 8 layers of ``tanh(h @ w)`` at D 16 over 6 microbatches of 2 x 4,
the reference's weights and inputs (``jax.random`` keys 0 and 1) handed
over as numpy.  Its output is within 1e-5 of the reference's
``sequential_reference`` and the gradient of ``sum(out ** 2)`` within 1e-4
of ``jax.grad``'s.  ``int8_psum`` over the 4 ranks, with payloads and
scales that differ per rank, equals the reference's formula bit for bit
(the int32 sum, times the largest scale, over the group's size), and its
one-rank form the reference's on a 1-device mesh.  The same world holds
the differentiable reduce-scatter and all-gather (``scatter_to``,
``gather_from``) and their backwards to exact sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_placement_worker import run_world

from repro.distributed import collectives as jcollectives
from repro.launch.mesh import compat_mesh
from repro.training.pipeline_pp import sequential_reference, split_stages
from repro_torch.distributed import collectives
from repro_torch.training import pipeline_pp

L, D, N_MICRO, B, S, STAGES = 8, 16, 6, 2, 4, 4
PSUM_SHAPE = (5, 7)


def _block(p, h):
    def body(hc, wl):
        return jnp.tanh(hc @ wl), None

    return jax.lax.scan(body, h, p["w"])[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe4")
    w = jax.random.normal(jax.random.key(0), (L, D, D)) * 0.3
    x = jax.random.normal(jax.random.key(1), (N_MICRO, B, S, D))
    np.savez(tmp / "pipe.npz", w=np.asarray(w), x=np.asarray(x))
    stage_params = split_stages({"w": w}, STAGES)
    ref = jax.jit(lambda sp: sequential_reference(_block, sp, x, STAGES))(stage_params)
    g_ref = jax.jit(jax.grad(
        lambda sp: jnp.sum(sequential_reference(_block, sp, x, STAGES) ** 2)))(stage_params)
    outs = run_world(STAGES, dict(kind="pipeline", psum_shape=list(PSUM_SHAPE)), tmp)
    return np.asarray(ref), np.asarray(g_ref["w"]), outs


def test_gpipe_forward_matches_sequential_reference(world):
    ref, _, outs = world
    for o in outs:                                  # every rank holds the last stage's output
        assert float(np.abs(o["out"] - ref).max()) < 1e-5
        np.testing.assert_array_equal(o["out"], outs[0]["out"])


def test_gpipe_gradients_match_jax_grad(world):
    _, g_ref, outs = world
    got = np.concatenate([o["grad"] for o in outs])  # stage by stage
    assert got.shape == g_ref.shape
    assert float(np.abs(got - g_ref).max()) < 1e-4


def test_reduce_scatter_and_all_gather_with_their_backwards(world):
    """``scatter_to``: the sum over the ranks, each keeping its rows; its
    backward gathers every rank's gradient.  ``gather_from``: every rank's
    rows; its backward sums the gradients and keeps this rank's rows.
    Rank r's input is (r + 1) x a ramp, its loss weight r + 1."""
    *_, outs = world
    n = len(outs)
    ramp = np.arange(n * 6, dtype=np.float64).reshape(n * 2, 3)
    weights = np.repeat(np.arange(1, n + 1, dtype=np.float64), 2)[:, None] * np.ones((1, 3))
    total = n * (n + 1) / 2
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["scattered"], total * ramp[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["g_scatter"], weights)
        np.testing.assert_array_equal(o["gathered"], ramp * weights)
        np.testing.assert_array_equal(o["g_gather"], np.full((2, 3), total))


def test_int8_psum_on_four_ranks_is_the_formula(world):
    *_, outs = world
    total = np.sum([o["q"].astype(np.int32) for o in outs], axis=0, dtype=np.int32)
    s_max = np.max([o["scale"] for o in outs]).astype(np.float32)
    want = total.astype(np.float32) * s_max / np.float32(len(outs))
    for o in outs:
        assert o["psum"].dtype == np.float32
        np.testing.assert_array_equal(o["psum"], want)


def test_int8_psum_on_one_rank_matches_the_reference():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (64, 33)).astype(np.int8)
    scale = np.float32(0.0371)
    mesh = compat_mesh((1,), ("data",))
    want = np.asarray(jcollectives.int8_psum(jnp.asarray(q), jnp.asarray(scale), mesh, "data"))
    got = collectives.int8_psum(torch.from_numpy(q), torch.tensor(scale), None).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("shape,dtype_bytes,n", [((4, 1024), 2, 8), ((128256, 2048), 4, 2),
                                                 ((7,), 1, 3)])
def test_collective_bytes_of_spec_matches_the_reference(kind, shape, dtype_bytes, n):
    assert collectives.collective_bytes_of_spec(shape, dtype_bytes, n, kind) == \
        jcollectives.collective_bytes_of_spec(shape, dtype_bytes, n, kind)


def test_collective_bytes_of_spec_refuses_an_unknown_kind():
    for mod in (collectives, jcollectives):
        with pytest.raises(ValueError):
            mod.collective_bytes_of_spec((4,), 4, 2, "broadcast")


def test_split_stages_matches_the_reference():
    w = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = pipeline_pp.split_stages({"w": torch.from_numpy(w)}, 4)["w"].numpy()
    np.testing.assert_array_equal(got, np.asarray(split_stages({"w": jnp.asarray(w)}, 4)["w"]))
    with pytest.raises(ValueError):
        pipeline_pp.split_stages({"w": torch.zeros(6, 2)}, 4)


def test_sequential_reference_on_one_rank_is_the_pipeline():
    """A one-stage mesh: pipeline_forward is the sequential loop."""
    from repro_torch.launch.mesh import DeviceMesh

    w = torch.randn(4, 4, 4, generator=torch.Generator().manual_seed(0)) * 0.3
    x = torch.randn(3, 2, 5, 4, generator=torch.Generator().manual_seed(1))

    def block(p, h):
        for wl in p["w"]:
            h = torch.tanh(h @ wl)
        return h

    sp = pipeline_pp.split_stages({"w": w}, 1)
    got = pipeline_pp.pipeline_forward(block, sp, x, DeviceMesh({"stage": 1}))
    want = pipeline_pp.sequential_reference(block, sp, x, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
