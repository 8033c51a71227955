"""The port's training path against the JAX package's, on the CPU: LR
schedules, AdamW, int8 gradient compression, the flash backward's plain
version, loss and gradients of reduced llama3.2-1b and moonshot, the
first-step grad norm at llama3.2-1b's attention width in float32 and, at
full depth, in float64 (where rounding no longer hides the comparison),
a carried-across trajectory, gradient accumulation, bit-exact resume and
the train CLI.

Tolerances (float32 unless said): schedules 1e-7 of the peak lr (both
compute in f32, but the two libraries' f32 cos differ in the last bit,
and near the end of the cosine tail 1 + cos(pi f) cancels to a few ulp);
AdamW 1e-6 (the same f32 ops in the same order; the last bits of pow and
sqrt may differ); int8 payload and error byte for byte (the jitted
reference's form); attention gradients 2e-5 (f32 sums in other orders);
loss 1e-5 relative and every gradient leaf within 5e-4 of its largest
element: against a float64 run of the port, torch's f32 gradients of q
and k sit ~1.5e-4 of their largest (the attention backward's P * (dP -
delta) cancels where the random model attends almost uniformly) and
XLA's ~2e-5, the other leaves ~1e-5 both.  A 5-step trajectory: the
losses of steps 0 and 1 (one whole update) within 1e-5 relative, of
steps 2-4 within 2e-3: once m/sqrt(v) is +-1 (step 1), a gradient
element whose sign differs between the frameworks moves its param 2 lr
apart, and the two runs part chaotically (lr 3e-3; 6e-4 at step 4,
1e-3 with int8 compression, measured).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduce_config as jreduce_config
from repro.core.placement import Env
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import host_batch as jhost_batch
from repro.models import attention as jattn
from repro.models.registry import build_model as jbuild_model
from repro.training import compression as jcompression
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import make_schedule as jmake_schedule
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import offload
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import flash_attention_bwd as kbwd
from repro_torch.kernels import ref
from repro_torch.launch import train as train_cli
from repro_torch.models.bridge import params_from_numpy, state_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, leaves, make_schedule
from repro_torch.training.trainer import make_train_step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors gain nothing from intra-op threads; one thread
    keeps this module from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("name", ["cosine", "wsd", "const"])
def test_schedules_match_reference(name):
    tc = TrainConfig(lr=3e-3, warmup_steps=37, total_steps=1000, schedule=name)
    jtc = JTrainConfig(lr=3e-3, warmup_steps=37, total_steps=1000, schedule=name)
    steps = np.arange(0, 1101, dtype=np.float32)
    want = np.asarray(jax.vmap(jmake_schedule(jtc))(jnp.asarray(steps)))
    got = make_schedule(tc)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7 * tc.lr)


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One update from a state three steps in (step 1's m/sqrt(v) is +-1
    everywhere, which says nothing about the arithmetic), params and
    moments in ``dtype``; the grad norm clips (grad_clip 1)."""
    rng = np.random.default_rng(0)
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    jtc = JTrainConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    jdt = jnp.dtype(dtype)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
    mk = lambda s, sc=1.0: jax.tree.map(  # noqa: E731
        lambda sh: jnp.asarray(rng.standard_normal(sh) * sc, jdt), s,
        is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(shapes), mk(shapes, 0.3)
    state = {"m": mk(shapes, 0.05), "v": jax.tree.map(jnp.abs, mk(shapes, 0.01)),
             "step": jnp.int32(3)}
    jopt = JAdamW(jtc, moment_dtype=jdt)
    jp, js, jm = jax.jit(jopt.update)(grads, state, params)
    opt = AdamW(tc, moment_dtype=getattr(torch, dtype))
    tp = params_from_numpy(_tree_np(params))
    ts = params_from_numpy(_tree_np(state))
    p, s, m = opt.update(params_from_numpy(_tree_np(grads)), ts, tp)
    assert int(s["step"]) == 4 and s["step"].dtype == torch.int32
    for a, b in zip(leaves(p) + leaves(s["m"]) + leaves(s["v"]),
                    jax.tree.leaves(jp) + jax.tree.leaves(js["m"]) + jax.tree.leaves(js["v"])):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)


def test_adamw_moves_toward_minimum():
    tc = TrainConfig(lr=0.1, warmup_steps=1, total_steps=200, schedule="const",
                     weight_decay=0.0)
    opt = AdamW(tc)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(150):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.3


# ---------------------------------------------------- int8 compression
def test_compress_grads_byte_equal_to_jitted_reference():
    rng = np.random.default_rng(1)
    grads = {f"g{i}": (rng.standard_normal((33, 7)) * 10.0 ** rng.uniform(-3, 3))
             .astype(np.float32) for i in range(40)}
    grads["h"] = {"bf": rng.standard_normal((64,)).astype(np.float32)}
    err = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32),
                       grads)
    jgrads = jax.tree.map(jnp.asarray, grads)
    jq, js, je = jax.jit(jcompression.compress)(jgrads, jax.tree.map(jnp.asarray, err))
    jout, jerr = jax.jit(jcompression.compress_grads)(jgrads, jax.tree.map(jnp.asarray, err))
    q, s, e = compression.compress(params_from_numpy(grads), params_from_numpy(err))
    out, new_err = compression.compress_grads(params_from_numpy(grads), params_from_numpy(err))
    for mine, theirs in ((q, jq), (s, js), (e, je), (out, jout), (new_err, jerr)):
        for a, b in zip(leaves(mine), jax.tree.leaves(theirs), strict=True):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype
            assert a.numpy().tobytes() == b.tobytes()


def test_int8_error_feedback_unbiased_over_time():
    g = {"g": torch.tensor([0.301, -0.777, 0.0031, 1.9])}
    err = compression.init_error(g)
    acc = torch.zeros(4)
    for _ in range(200):
        out, err = compression.compress_grads(g, err)
        acc = acc + out["g"]
    np.testing.assert_allclose((acc / 200).numpy(), g["g"].numpy(), rtol=2e-3, atol=2e-4)


# ---------------------------------------------- flash backward (plain)
@pytest.mark.parametrize("G,D", [(1, 16), (4, 64), (8, 128), (1, 128), (4, 16)])
def test_flash_bwd_plain_matches_jax_grad_and_autograd(G, D):
    rng = np.random.default_rng(G * 1000 + D)
    B, S, Hkv = 2, 19, 2
    q, do = (rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = ref.naive_attention(tq, tk, tv)
    lse = ref.attention_lse(tq, tk)
    got = kbwd.plain(tq, tk, tv, o, tdo, lse)

    def f(q, k, v):
        return jnp.sum(jattn.chunked_attention(q, k, v, causal=True, chunk=8) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves_ = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    ref.naive_attention(*leaves_).backward(tdo)
    for a, b, c in zip(got, want, leaves_):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(a.numpy(), c.grad.numpy(), rtol=2e-5, atol=2e-5)
    # the forward's lse, and the train path's attention on CPU tensors
    # (offload.prefill_attention under autograd: the plain chunked_attention)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(
        torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(G, 2)) / np.sqrt(D)
        + torch.triu(torch.full((S, S), -torch.inf), 1), -1).numpy(), rtol=1e-5, atol=1e-5)
    fn_leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    offload.prefill_attention(*fn_leaves, chunk=8).backward(tdo)
    for a, c in zip(got, fn_leaves):
        np.testing.assert_allclose(a.numpy(), c.grad.numpy(), rtol=2e-5, atol=2e-5)


def test_flash_bwd_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 16, 64)
    with pytest.raises(ValueError, match="G = Hq / Hkv"):
        kbwd.check(q, torch.zeros(1, 8, 1, 64), torch.zeros(1, 8, 1, 64))
    with pytest.raises(ValueError, match="Sq == Sk"):
        kbwd.check(q, torch.zeros(1, 9, 4, 64), torch.zeros(1, 9, 4, 64))
    with pytest.raises(ValueError, match="D % 8"):
        kbwd.check(torch.zeros(1, 8, 4, 20), torch.zeros(1, 8, 4, 20), torch.zeros(1, 8, 4, 20))


# ---------------------------------------------------- loss and gradients
def _pair(arch, **kw):
    jcfg = jreduce_config(arch).with_overrides(dtype="float32", **kw)
    jmodel = jbuild_model(jcfg, Env())
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(reduce_config(arch).with_overrides(dtype="float32", **kw), "cpu")
    return jmodel, jparams, model, params_from_numpy(_tree_np(jparams))


def _batch(vocab, B=2, S=16, step=0, embeds_len=0, D=64):
    b = jhost_batch(JDataConfig(vocab=vocab, seq_len=S, global_batch=B), step, 0, 1)
    if embeds_len:
        b["embeds"] = np.random.default_rng(step).standard_normal(
            (B, embeds_len, D)).astype(np.float32)
    return b


def _check_grads(jmodel, jparams, model, params, batch, keys=("loss",)):
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    req = jax.tree.map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(req))
    for k in keys:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=5e-4 * np.abs(jg).max() + 1e-12)
    return grads


@pytest.mark.parametrize("embeds", [0, 5])
def test_dense_loss_and_grads_match_reference(embeds):
    jmodel, jparams, model, params = _pair("llama3.2-1b")
    _check_grads(jmodel, jparams, model, params, _batch(512, embeds_len=embeds))


def test_moe_loss_and_grads_match_reference():
    jmodel, jparams, model, params = _pair("moonshot-v1-16b-a3b")
    _check_grads(jmodel, jparams, model, params, _batch(512, B=2, S=12),
                 keys=("loss", "ce", "aux"))


def _grad_norm(grads) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64))) for g in grads)))


@pytest.mark.parametrize("n_layers", [2, 16])
def test_first_step_grad_norm_at_full_attention_width_matches_reference(n_layers):
    """llama3.2-1b's attention at its full width (d 2048, 32 query and 8 KV
    heads of 64) under the reference's init, which scales the 4-D
    attention weights by the head count's fan-in, from the same weights
    (batch 1 x 32 tokens, float32).  At 2 layers the port's first-step
    global grad norm is the reference's within 1e-4 relative.  With depth
    the norm grows ~1e5-fold and rounding grows with it: at 16 layers the
    reference's own norm moves by a factor of a few when its weights move
    by one f32 ulp, so the port's is held to be above 1e6 and no further
    from the reference's (in log) than that nudge moves it.  The FFN width
    and the vocabulary are cut (256, 512) to keep the run small: their
    weights are scaled by their true fan-in and take no part in the
    growth."""
    kw = dict(n_layers=n_layers, d_ff=256, vocab=512, dtype="float32")
    jmodel = jbuild_model(jget_config("llama3.2-1b").with_overrides(**kw), Env())
    jparams = jmodel.init(jax.random.key(0))
    batch = _batch(512, B=1, S=32)
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))
    want = _grad_norm(jax.tree.leaves(jgrad(jparams, jax.tree.map(jnp.asarray, batch))))
    model = build_model(get_config("llama3.2-1b").with_overrides(**kw), "cpu")
    req = jax.tree.map(lambda p: p.requires_grad_(), params_from_numpy(_tree_np(jparams)))
    loss, _ = model.loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = _grad_norm(torch.autograd.grad(loss, leaves(req)))
    print(f"first-step grad norm, llama3.2-1b attention width, {n_layers} layers: "
          f"reference {want:.6g}, port {got:.6g}")
    if n_layers == 2:
        np.testing.assert_allclose(got, want, rtol=1e-4)
        return
    nudged = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf) if a.ndim >= 2 else a, jparams)
    moved = _grad_norm(jax.tree.leaves(jgrad(nudged, jax.tree.map(jnp.asarray, batch))))
    print(f"  the reference with its weights one ulp up: {moved:.6g}")
    assert min(want, got, moved) > 1e6
    assert abs(np.log(got / want)) <= abs(np.log(moved / want)), (got, want, moved)


class _WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``: put in the place
    of the reference's ``jnp`` in ``repro.models.common`` (rmsnorm,
    layernorm, rope, cross-entropy) and ``repro.models.attention``
    (chunked attention), it widens their f32 casts under x64, as the
    port's ``common.acc_dtype`` does for an f64 model.  Nothing else of
    the reference changes; AdamW (``repro.training.optimizer``) keeps its
    f32 update on both sides."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def test_full_depth_at_attention_width_matches_reference_in_float64(monkeypatch):
    """The open fault of the float32 test above, decided where rounding
    is no longer the noise: llama3.2-1b's attention width at 16 layers
    (FFN 256, vocab 512, 1 x 32 tokens), the reference's weights carried
    over, both packages in float64 (the reference under
    ``jax.enable_x64()``, no global flag) with the f32 casts of rmsnorm,
    rope, chunked attention and cross-entropy widened to f64 on both sides
    (:class:`_WideJnp`; left in f32 they put f32 noise back in).  At step
    0 the loss agrees within 1e-7 relative and the global grad norm
    within 1e-3: one f64 ulp on the reference's own weights moves its
    norm by a few 1e-6 (printed), so the problem's condition number, not
    the port, sets that figure.  Then two AdamW steps each (f32 updates,
    as both optimizers compute them): after one update the losses are
    within 0.1 of each other (the reference moved by its ulp nudge
    differs by ~2e-2 after one, ~0.3 after two; printed).  Last, the
    reference's own float32 train step
    at this width and depth over six steps, printed: its loss does not
    fall either."""
    import repro.models.attention as jattn_mod
    import repro.models.common as jcommon

    L, n_steps = 16, 3
    kw = dict(n_layers=L, d_ff=256, vocab=512)
    dc = JDataConfig(vocab=512, seq_len=32, global_batch=1)
    jp32 = jbuild_model(jget_config("llama3.2-1b").with_overrides(dtype="float32", **kw),
                        Env()).init(jax.random.key(0))
    jtc = JTrainConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    monkeypatch.setattr(jcommon, "jnp", _WideJnp())
    monkeypatch.setattr(jattn_mod, "jnp", _WideJnp())
    with jax.enable_x64(True):
        jmodel = jbuild_model(jget_config("llama3.2-1b").with_overrides(dtype="float64", **kw),
                              Env())
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp32)
        vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b)[0]))
        jb = jax.tree.map(jnp.asarray, host_batch(DataConfig(vocab=512, seq_len=32,
                                                             global_batch=1), 0, 0, 1))
        jloss, jg = vg(jp, jb)
        want = (float(jloss), _grad_norm(jax.tree.leaves(jg)))
        del jg
        nudged = vg(jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf) if a.ndim >= 2 else a,
                                 jp), jb)
        moved = (float(nudged[0]), _grad_norm(jax.tree.leaves(nudged[1])))
        del nudged
        _, jstep, _, _ = jmake_train_step(jmodel, JRunConfig(model=jmodel.cfg,
                                                             parallel=JParallelConfig(),
                                                             train=jtc))
        jstep = jax.jit(jstep)
        zeros = lambda t: jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), t)  # noqa: E731
        state0 = _tree_np({"params": jp, "opt": {"m": zeros(jp), "v": zeros(jp),
                                                 "step": jnp.int32(0)}})
        jlosses = []
        for nudge in (False, True):
            st = jax.tree.map(jnp.asarray, state0)
            if nudge:
                st["params"] = jax.tree.map(
                    lambda a: jnp.nextafter(a, jnp.inf) if a.ndim >= 2 else a, st["params"])
            out = []
            for i in range(n_steps):
                st, m = jstep(st, jax.tree.map(jnp.asarray, jhost_batch(dc, i, 0, 1)))
                out.append(float(m["loss"]))
            jlosses.append(out)
            del st
        del jp
    model = build_model(get_config("llama3.2-1b").with_overrides(dtype="float64", **kw), "cpu")
    state = state_from_numpy(state0)
    del state0
    req = jax.tree.map(lambda p: p.detach().requires_grad_(), state["params"])
    loss, _ = model.loss_fn(req, {k: torch.from_numpy(v) for k, v in jhost_batch(dc, 0, 0, 1)
                                  .items()})
    assert loss.dtype == torch.float64
    got = (float(loss.detach()), _grad_norm(torch.autograd.grad(loss, leaves(req))))
    del req, loss
    run = RunConfig(model=model.cfg, parallel=ParallelConfig(), train=TrainConfig(
        lr=3e-3, warmup_steps=2, total_steps=50))
    _, step, _, _ = make_train_step(model, run)
    losses = []
    for i in range(n_steps):
        state, m = step(state, host_batch(DataConfig(vocab=512, seq_len=32, global_batch=1),
                                          i, 0, 1))
        losses.append(float(m["loss"]))
    del state
    print(f"float64, {L} layers at llama3.2-1b's attention width, step 0: loss reference "
          f"{want[0]!r} port {got[0]!r}; grad norm reference {want[1]:.6g} port {got[1]:.6g} "
          f"(the reference one f64 ulp up: loss {moved[0]!r}, grad norm {moved[1]:.6g})")
    print(f"  losses by step: reference {jlosses[0]}, reference one ulp up {jlosses[1]}, "
          f"port {losses}")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-7)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    assert all(np.isfinite(losses)) and abs(losses[1] - jlosses[0][1]) < 0.1, (losses, jlosses)
    # the reference's own train step in float32, no cast widened
    monkeypatch.undo()
    jmodel = jbuild_model(jget_config("llama3.2-1b").with_overrides(dtype="float32", **kw), Env())
    jinit, jstep, _, _ = jmake_train_step(jmodel, JRunConfig(model=jmodel.cfg,
                                                             parallel=JParallelConfig(),
                                                             train=jtc))
    st, jstep, own = jinit(jax.random.key(0)), jax.jit(jstep), []
    for i in range(6):
        st, m = jstep(st, jax.tree.map(jnp.asarray, jhost_batch(dc, i, 0, 1)))
        own.append(round(float(m["loss"]), 4))
    print(f"  the reference's own float32 train step, {L} layers, losses by step: {own} "
          f"(last {'below' if own[-1] < own[0] else 'not below'} the first)")
    assert all(np.isfinite(own))


# ------------------------------------------------------------ the step
def _setup(arch="llama3.2-1b", dtype="bfloat16", **pkw):
    cfg = reduce_config(arch).with_overrides(dtype=dtype)
    model = build_model(cfg, "cpu")
    run = RunConfig(model=cfg, parallel=ParallelConfig(**pkw),
                    train=TrainConfig(lr=3e-3, warmup_steps=2, total_steps=50))
    return cfg, model, make_train_step(model, run)


@pytest.mark.parametrize("pkw", [{}, {"grad_accum": 2, "grad_compression": "int8"}])
def test_trajectory_from_a_carried_state_matches_reference(pkw):
    """Both packages step five times from one state (the reference's init
    carried across), on the same batches; losses agree step by step."""
    jcfg = jreduce_config("llama3.2-1b").with_overrides(dtype="float32")
    jmodel = jbuild_model(jcfg, Env())
    jrun = JRunConfig(model=jcfg, parallel=JParallelConfig(**pkw),
                      train=JTrainConfig(lr=3e-3, warmup_steps=2, total_steps=50))
    jinit, jstep, _, _ = jmake_train_step(jmodel, jrun)
    jstate = jinit(jax.random.key(0))
    _, _, (_, step, _, _) = _setup(dtype="float32", **pkw)
    state = state_from_numpy(_tree_np(jstate))
    assert set(state) == set(jstate) and state["opt"]["step"].dtype == torch.int32
    jstep = jax.jit(jstep)
    dc = DataConfig(vocab=512, seq_len=16, global_batch=4)
    for i in range(5):
        b = host_batch(dc, i, 0, 1)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if i < 2 else 2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)


def test_loss_decreases():
    cfg, model, (init_state, train_step, _, _) = _setup()
    state = init_state(0)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    losses = []
    for i in range(15):
        state, m = train_step(state, host_batch(dc, i, 0, 1))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_grad_accum_matches_full_batch():
    """accum=2 over the same tokens must match accum=1 closely (bf16
    params; accumulation reorders the reductions)."""
    cfg, _, (init1, step1, _, _) = _setup(grad_accum=1)
    _, _, (init2, step2, _, _) = _setup(grad_accum=2)
    b = host_batch(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8), 0, 0, 1)
    s1, _ = step1(init1(0), b)
    s2, _ = step2(init2(0), b)
    err = max(float((a.float() - c.float()).abs().max())
              for a, c in zip(leaves(s1["params"]), leaves(s2["params"])))
    assert err < 2e-2, err


def test_resume_is_bit_exact(tmp_path):
    """Four steps straight equal two steps, a checkpoint, a restore into
    the template and two more, bit for bit (params, moments, step, err)."""
    cfg, _, (init_state, train_step, _, state_shapes) = _setup(grad_compression="int8")
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    straight = init_state(0)
    for i in range(4):
        straight, _ = train_step(straight, host_batch(dc, i, 0, 1))
    state = init_state(0)
    for i in range(2):
        state, _ = train_step(state, host_batch(dc, i, 0, 1))
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state, blocking=False)
    ck.wait()
    _, state = ck.restore(state_shapes(), device="cpu")
    for i in range(2, 4):
        state, _ = train_step(state, host_batch(dc, i, 0, 1))
    a, b = leaves(straight), leaves(state)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


# ------------------------------------------------------------- the CLI
def test_train_cli_restarts_once_with_the_reference_done_line(tmp_path, capsys):
    from repro.launch import train as jtrain_cli

    flags = ["--reduced", "--steps", "12", "--ckpt-every", "5", "--fail-at-step", "7"]
    res = train_cli.run(train_cli.build_parser().parse_args(
        flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]))
    assert res.restarts == 1 and res.checkpoints == [5, 10, 12]
    assert "restored from step 5" in res.lines
    assert sorted(res.losses) == list(range(12))
    capsys.readouterr()
    argv = sys.argv
    sys.argv = ["train"] + flags + ["--ckpt-dir", str(tmp_path / "ref")]
    try:
        jtrain_cli.main()
    finally:
        sys.argv = argv
    ref_lines = capsys.readouterr().out.splitlines()
    assert res.lines[0] == ref_lines[0]                      # arch= params= mesh=
    assert [l for l in res.lines if l.startswith("done")] == [ref_lines[-1]]


def test_train_cli_refuses_model_parallel(tmp_path):
    """The CLI no longer refuses ``--model-parallel``: on one process (no
    world) a ``model`` axis of 2 does not divide the one rank, so it
    trains on one rank, as the reference does on one device (its
    ``make_host_mesh`` falls back to a model axis of 1), and prints the
    one-device mesh; a world of ranks runs it placed
    (tests/test_torch_train_cli_placed.py)."""
    res = train_cli.run(train_cli.build_parser().parse_args(
        ["--reduced", "--steps", "2", "--model-parallel", "2", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)]))
    assert res.mesh == {"data": 1, "model": 1} and sorted(res.losses) == [0, 1]
    assert res.lines[0].endswith(" mesh={'data': 1, 'model': 1}")
