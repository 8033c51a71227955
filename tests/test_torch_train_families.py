"""Training the DeepSeek, encoder-decoder, RWKV6 and Zamba2 families in the
port against the JAX package's, on the CPU: loss, metrics and every
gradient leaf of the reduced float32 models against
``jax.value_and_grad`` of the reference's ``loss_fn``; the functional
train forms of the WKV and SSD scans against the reference's
``_wkv_scan`` / ``_ssd_scan`` (values and gradients, one plain scan at S
100 and chunks of 256 under remat at S 512); 3-step trajectories from a
carried state against the reference's trainer; the train CLI's lines;
checkpoint round trips of the new train states; and one train step of
every arch id.

Tolerances (float32): loss 1e-5 relative and every gradient leaf within
5e-4 of its largest element, as ``tests/test_torch_training.py``'s
``_check_grads``; the scans' outputs and final states within 1e-5 and
their gradients within 1e-4 of their largest element (f32 sums over up
to 512 steps in other orders); trajectories 1e-5 relative for steps 0
and 1, 2e-3 after (the same chaotic parting as the dense family's,
measured there).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import host_batch as jhost_batch
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models.registry import build_model as jbuild_model
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.bridge import params_from_numpy, state_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import make_train_step

FAMILIES = ["deepseek-v3-671b", "seamless-m4t-medium", "rwkv6-7b", "zamba2-1.2b"]
METRICS = {"deepseek-v3-671b": ("loss", "ce", "aux", "mtp_ce")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads; one thread
    keeps this module from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=2, S=16, step=0):
    """The synthetic pipeline's batch; the encoder-decoder's also holds
    ``src_embeds`` (B, frontend_len, d_model), as the reference's tests
    build one."""
    b = jhost_batch(JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B), step, 0, 1)
    if cfg.family == "encdec":
        b["src_embeds"] = np.random.default_rng(step).standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return b


def _pair(arch):
    jcfg = jreduce_config(arch).with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(arch).with_overrides(dtype="float32"), "cpu")
    return jmodel, jparams, model, params_from_numpy(_tree_np(jparams))


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_reference(arch):
    jmodel, jparams, model, params = _pair(arch)
    batch = _batch(jmodel.cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    req = jax.tree.map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(req))
    assert set(metrics) == set(jmetrics) == set(METRICS.get(arch, ("loss",)))
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=5e-4 * np.abs(jg).max() + 1e-12)


# ------------------------------------------------------------- the scans
def _scan_inputs(kind: str, S: int):
    rng = np.random.default_rng(S + (kind == "ssd"))
    B, H, N = 2, 3, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if kind == "wkv":
        w = np.exp(-np.exp(f(B, S, H, N) * 0.5 - 0.5)).astype(np.float32)
        return [f(B, S, H, N), f(B, S, H, N) * 0.3, f(B, S, H, N), w, f(H, N) * 0.1,
                f(B, H, N, N)]
    P = 4
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    return [f(B, S, H, P), f(B, S, H, N) * 0.3, f(B, S, H, N), dt * 0.2, -np.exp(f(H) * 0.3),
            f(B, H, P, N)]


@pytest.mark.parametrize("S", [100, 512])
@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_train_scan_matches_reference(kind, S):
    """The functional train scan against the reference's (chunk 256: one
    plain scan at S 100, two recomputed chunks at S 512), from a random
    state: outputs, final state and the gradients of every input and of
    the state under random cotangents; the state it was given unchanged.
    The serving scan gives the same outputs from a copy of the state."""
    xs = _scan_inputs(kind, S)
    rng = np.random.default_rng(7)
    ref_scan = jrwkv6._wkv_scan if kind == "wkv" else jmamba2._ssd_scan
    train_scan = rwkv6._wkv_scan_train if kind == "wkv" else mamba2._ssd_scan_train
    serve_scan = rwkv6._wkv_scan if kind == "wkv" else mamba2._ssd_scan
    y_shape = xs[0].shape
    dy = rng.standard_normal(y_shape).astype(np.float32)
    ds = rng.standard_normal(xs[-1].shape).astype(np.float32)

    def objective(*a):
        y, s = ref_scan(*a, chunk=256)
        return jnp.sum(y * dy) + jnp.sum(s * ds), (y, s)

    (_, (jy, js)), jgrads = jax.jit(jax.value_and_grad(objective, argnums=tuple(range(6)),
                                                       has_aux=True))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    state_before = ts[-1].detach().clone()
    y, s = train_scan(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                                + (s * torch.from_numpy(ds)).sum(), ts)
    assert torch.equal(ts[-1].detach(), state_before)
    for got, want in ((y, jy), (s, js)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for g, jg in zip(grads, jgrads, strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    with torch.no_grad():
        sy, ss = serve_scan(*[t.detach().clone() for t in ts])
    y, s = y.detach(), s.detach()
    np.testing.assert_allclose(sy.numpy(), y.numpy(), rtol=0, atol=1e-5 * float(y.abs().max()))
    np.testing.assert_allclose(ss.numpy(), s.numpy(), rtol=0, atol=1e-5 * float(s.abs().max()))


# ------------------------------------------------------ the trajectories
@pytest.mark.parametrize("arch", ["rwkv6-7b", "deepseek-v3-671b"])
def test_trajectory_from_a_carried_state_matches_reference(arch):
    """Both packages step three times from one state (the reference's
    init carried across with ``bridge.state_from_numpy``) on the same
    batches; loss and lr agree step by step."""
    jcfg = jreduce_config(arch).with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jinit, jstep, _, _ = jmake_train_step(jmodel, JRunConfig(
        model=jcfg, parallel=JParallelConfig(),
        train=JTrainConfig(lr=3e-3, warmup_steps=2, total_steps=50)))
    jstate = jinit(jax.random.key(0))
    model = build_model(reduce_config(arch).with_overrides(dtype="float32"), "cpu")
    _, step, _, _ = make_train_step(model, RunConfig(
        model=model.cfg, parallel=ParallelConfig(),
        train=TrainConfig(lr=3e-3, warmup_steps=2, total_steps=50)))
    state = state_from_numpy(_tree_np(jstate))
    jstep = jax.jit(jstep)
    for i in range(3):
        b = _batch(jcfg, B=4, step=i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i < 2 else 2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)


# --------------------------------------------------------------- the CLI
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "rwkv6-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_train_cli_prints_the_reference_lines(arch, tmp_path, capsys):
    """``--reduced --device cpu``: the ``arch= params= mesh=`` line and the
    ``done`` line are the reference CLI's; seamless fails in both with the
    KeyError of its missing ``src_embeds``, after the same restarts."""
    from repro.launch import train as jtrain_cli

    flags = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
             "--ckpt-every", "2"]
    args = train_cli.build_parser().parse_args(
        flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    argv = sys.argv
    sys.argv = ["train"] + flags + ["--ckpt-dir", str(tmp_path / "ref")]
    try:
        if arch == "seamless-m4t-medium":
            with pytest.raises(KeyError, match="src_embeds"):
                train_cli.run(args, echo=False)
            with pytest.raises(KeyError, match="src_embeds"):
                jtrain_cli.main()
            return
        res = train_cli.run(args, echo=False)
        capsys.readouterr()
        jtrain_cli.main()
    finally:
        sys.argv = argv
    ref_lines = capsys.readouterr().out.splitlines()
    assert res.lines[0] == ref_lines[0]                      # arch= params= mesh=
    assert [l for l in res.lines if l.startswith("done")] == [ref_lines[-1]]
    assert res.checkpoints == [2, 3] and all(np.isfinite(list(res.losses.values())))


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_checkpoint_round_trip_is_bit_equal(arch, tmp_path):
    """A bf16 train state one step in (params, AdamW moments, step),
    saved and restored into ``state_shapes()``: every leaf bit-equal,
    deepseek's MTP subtree and zamba2's shared block included."""
    cfg = reduce_config(arch)
    model = build_model(cfg, "cpu")
    init_state, train_step, _, state_shapes = make_train_step(model, RunConfig(
        model=cfg, parallel=ParallelConfig(), train=TrainConfig()))
    state, _ = train_step(init_state(0), _batch(cfg))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=False)
    ck.wait()
    step, restored = ck.restore(state_shapes(), device="cpu")
    names = {"deepseek-v3-671b": "mtp", "zamba2-1.2b": "shared"}
    if arch in names:
        assert names[arch] in restored["params"] and names[arch] in restored["opt"]["m"]
    a, b = leaves(state), leaves(restored)
    assert step == 1 and len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------ every arch trains
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_takes_a_train_step(arch):
    """``build_model(cfg).loss_fn`` trains every arch id: one bf16 step of
    the reduced model gives a finite loss and grad norm, and moves at
    least 80% of the parameter leaves (the reference's smoke test's
    share)."""
    cfg = reduce_config(arch)
    model = build_model(cfg, "cpu")
    init_state, train_step, _, _ = make_train_step(model, RunConfig(
        model=cfg, parallel=ParallelConfig(), train=TrainConfig(lr=1e-2, warmup_steps=1)))
    state = init_state(0)
    before = [p.clone() for p in leaves(state["params"])]
    state, m = train_step(state, _batch(cfg))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    moved = sum(not torch.equal(a, b) for a, b in zip(before, leaves(state["params"])))
    assert moved >= 0.8 * len(before), (moved, len(before))


def test_train_cli_ckpt_every_zero_writes_no_checkpoint(tmp_path):
    """The port's ``--ckpt-every 0`` (a full-width state is tens of GB):
    every step runs, no checkpoint is written."""
    res = train_cli.run(train_cli.build_parser().parse_args(
        ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "8", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)]), echo=False)
    assert sorted(res.losses) == [0, 1] and res.checkpoints == [] and res.restarts == 0
    assert "done (0 restart(s)); checkpoints: []" in res.lines
