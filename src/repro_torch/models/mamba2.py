"""Mamba2 SSD block: the building block of zamba2.

Counterpart of ``repro.models.mamba2`` (``dims``, ``param_defs``,
:func:`_ssd_scan`, :func:`forward`).  x -> in_proj -> [z, xBC, dt];
xBC -> causal depthwise conv (its last ``d_conv - 1`` inputs carried as
state) -> silu -> [x', B, C]; the SSD recurrence per head (state (P, N)
in f32, a scalar decay per head):

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * (x'_t (x) B_t)
    y_t = C_t . h_t + D_h * x'_t

then the gated RMSNorm of y * silu(z) -> out_proj.  The recurrence runs
one time step at a time in f32, as the reference's scan does.
:func:`forward` advances the SSM state it is given in place and returns
the new conv state; with ``train`` it reads the state and writes
nothing, through the functional :func:`_ssd_scan_train` with the
reference's time-chunked remat, so autograd can take it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ParamDef

Pytree = Any

SCAN_CHUNK = 64  # prompt steps whose states one history buffer holds


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.d_head
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    return d_inner, H, conv_dim, d_in_proj


def param_defs(cfg, L: int) -> Pytree:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_dim, d_in_proj = dims(cfg)
    return {
        "ln_s": ParamDef((L, D), ("layers", "embed"), "zeros"),
        "in_proj": ParamDef((L, D, d_in_proj), ("layers", "embed", "mlp")),
        "conv_w": ParamDef((L, s.d_conv, conv_dim), ("layers", None, "mlp"), "small"),
        "conv_b": ParamDef((L, conv_dim), ("layers", "mlp"), "zeros"),
        "dt_bias": ParamDef((L, H), ("layers", "state"), "zeros"),
        "A_log": ParamDef((L, H), ("layers", "state"), "zeros"),
        "D_skip": ParamDef((L, H), ("layers", "state"), "ones"),
        "norm_s": ParamDef((L, d_inner), ("layers", "mlp"), "zeros"),
        "out_proj": ParamDef((L, d_inner, D), ("layers", "mlp", "embed")),
    }


def _ssd_scan(xp: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
              A: torch.Tensor, state: torch.Tensor):
    """xp (B, S, H, P); Bm / Cm (B, S, H, N); dt (B, S, H); A (H,); state
    (B, H, P, N) f32, advanced in place.  Returns y (B, S, H, P) and the
    state.  The decays and the ``dt * x`` inputs of every step are formed
    at once; a decode step (S 1) updates the state in place; over a prompt,
    as ``rwkv6._wkv_scan``, each chunk of ``SCAN_CHUNK`` steps forms its
    outer products at once and writes every step's state into a history
    buffer, one launch a step, then reads all of them out at once."""
    decay = torch.exp(dt * A)                                      # (B, S, H)
    dtx = dt[..., None] * xp                                       # (B, S, H, P)
    if xp.shape[1] == 1:
        state.mul_(decay[:, 0, :, None, None]).addcmul_(dtx[:, 0, ..., None],
                                                        Bm[:, 0, :, None, :])
        return (state @ Cm[:, 0, ..., None])[None, ..., 0].transpose(0, 1), state
    decay, dtx, Bm, Cm = (t.transpose(0, 1) for t in (decay, dtx, Bm, Cm))
    ys = []
    for c0 in range(0, dtx.shape[0], SCAN_CHUNK):
        c = slice(c0, c0 + SCAN_CHUNK)
        xb = dtx[c, ..., None] * Bm[c, ..., None, :]               # (C, B, H, P, N)
        hist = torch.empty((xb.shape[0] + 1, *state.shape), dtype=state.dtype,
                           device=state.device)
        hist[0] = state
        for a, prev, d, nxt in zip(xb.unbind(0), hist.unbind(0),
                                   decay[c, ..., None, None].unbind(0), hist[1:].unbind(0)):
            torch.addcmul(a, prev, d, out=nxt)
        ys.append(torch.einsum("cbhpn,cbhn->cbhp", hist[1:], Cm[c]))
        state.copy_(hist[-1])
    return torch.cat(ys).transpose(0, 1), state


def _ssd_steps(state: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               decay: torch.Tensor):
    """Functional SSD steps over time-major dtx (C, B, H, P), Bm / Cm
    (C, B, H, N), decay (C, B, H) from ``state``: ``(C_t . h_t`` for each
    step (C, B, H, P), the last state)``.  Nothing is written in place:
    each step is one ``addcmul``; the inputs ``dt x (x) B`` and the
    read-outs are one batched product each."""
    hs = []
    for a, d in zip((dtx[..., None] * Bm[..., None, :]).unbind(0),
                    decay[..., None, None].unbind(0)):
        state = torch.addcmul(a, state, d)
        hs.append(state)
    return torch.einsum("cbhpn,cbhn->cbhp", torch.stack(hs), Cm), state


def _ssd_scan_train(xp: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, state: torch.Tensor, chunk: int = cm.SCAN_REMAT_CHUNK):
    """The SSD recurrence of :func:`_ssd_scan` in a functional form for
    training: the same shapes, ``state`` (B, H, P, N) f32 read and not
    written; returns y (B, S, H, P) and the final state, with the
    reference's remat over time (:func:`common.scan_in_chunks`)."""
    xs = [dt[..., None] * xp, Bm, Cm, torch.exp(dt * A)]
    y, state = cm.scan_in_chunks(_ssd_steps, state, [t.transpose(0, 1) for t in xs], chunk)
    return y.transpose(0, 1), state


def forward(cfg, p, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
            norm_eps: float = 1e-5, train: bool = False):
    """One mamba2 layer over a segment.  x (B, S, D); conv_state
    (B, d_conv - 1, conv_dim); ssm_state (B, H, P, N) f32, advanced in
    place (``train``: read only, the new state returned).  Returns
    (out (B, S, D), new conv state, the new SSM state)."""
    s = cfg.ssm
    d_inner, H, conv_dim, _ = dims(cfg)
    B, S, _ = x.shape
    h = cm.rmsnorm(x, p["ln_s"], norm_eps)
    z, xBC, dt = torch.split(cm.linear(h, p["in_proj"]), [d_inner, conv_dim, H], dim=-1)

    # causal depthwise conv with carried state: the d_conv windows summed
    # in f32 and rounded once, as the reference's einsum over them
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    new_conv = full[:, -(s.d_conv - 1):] if s.d_conv > 1 else conv_state
    w = p["conv_w"].float()
    acc = sum(full[:, i:i + S].float() * w[i] for i in range(s.d_conv))
    xBC = F.silu(acc.to(x.dtype) + p["conv_b"])

    xp, Bm, Cm = torch.split(xBC, [d_inner, s.n_groups * s.d_state,
                                   s.n_groups * s.d_state], dim=-1)
    xp = xp.reshape(B, S, H, s.d_head).float()
    rep = H // s.n_groups
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state).float().repeat_interleave(rep, dim=2)
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state).float().repeat_interleave(rep, dim=2)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, ssm_state = (_ssd_scan_train if train else _ssd_scan)(xp, Bm, Cm, dtv, A, ssm_state)
    y = y + p["D_skip"].float()[None, None, :, None] * xp
    y = y.reshape(B, S, d_inner) * F.silu(z.float())
    y = cm.rmsnorm(y, p["norm_s"], norm_eps)
    return cm.linear(y.to(x.dtype), p["out_proj"]), new_conv, ssm_state
