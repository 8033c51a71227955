"""Where one decode step of ``--sub-batches 2`` parts from the full batch.

  python3 scripts/torch_sub_batch_diff.py [--slots 16] [--requests 64]

Full-width llama3.2-1b (bf16, random weights from seed 0) on the GPU: a
dense engine admits the first ``--slots`` requests of the serve CLI's
random workload, then one decode step runs over the whole batch and,
from the same cache, over each half, op by op (the layers of
``models/dense.py:decode_step``).  Prints every op whose halves are not
bit-identical to the whole (rows and elements that differ, the largest
difference), the first decode's argmax per row, and for the model's GEMM
shapes whether ``(B/2, K) @ W`` gives the rows of ``(B, K) @ W``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import offload  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import dense  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.workload import build_workload  # noqa: E402


def decode(model, params, cache, tokens, rec):
    """``dense.decode_step``'s ops in order, each output appended to ``rec``."""
    cfg = model.cfg
    lengths, S, B = cache["lengths"], cache["k"].shape[2], tokens.shape[0]
    x = cm.embed_lookup(params["embed"], tokens)
    pos = lengths.long()
    bidx = torch.arange(B, device=x.device)
    valid, wpos, attn_len = pos < S, pos.clamp(max=S - 1), lengths + 1
    for l in range(cfg.n_layers):
        p = dense._layer(params, l)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        qkv = [cm.linear(h, p[w]) for w in ("wq", "wk", "wv")]
        rec += [(l, name, t) for name, t in zip(("wq", "wk", "wv"), qkv)]
        q = cm.rope(qkv[0][:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k = cm.rope(qkv[1][:, None], pos[:, None], cfg.rope_theta)[:, 0]
        dense._append(cache["k"][l], k, bidx, wpos, valid)
        dense._append(cache["v"][l], qkv[2], bidx, wpos, valid)
        o = offload.decode_attention(q, cache["k"][l], cache["v"][l], attn_len)
        wo = cm.linear(o, p["wo"], n_in=2)
        x = x + wo
        h2 = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        up = cm.linear(h2, p["w_gate"]), cm.linear(h2, p["w_up"])
        f = cm.linear(torch.nn.functional.silu(up[0]) * up[1], p["w_down"])
        rec += [(l, "attention", o), (l, "wo", wo), (l, "w_gate", up[0]), (l, "w_up", up[1]),
                (l, "w_down", f)]
        x = x + f
    x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    rec.append((cfg.n_layers, "logits", cm.unembed(x, dense._unembed_table(params), cfg.vocab)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=64)
    opt = ap.parse_args()
    args = serve.build_parser().parse_args(["--arch", "llama3.2-1b", "--device", "cuda"])
    model, params = serve.load_model(args)
    cfg, B = model.cfg, opt.slots
    eng = Engine(model, params, n_slots=B, max_seq=1024, async_mode=False, graphs=False)
    for i, a in enumerate(build_workload("random", opt.requests, vocab=cfg.vocab, max_seq=1024,
                                         max_new=64, seed=0)):
        eng.submit(Request(uid=i, prompt=a.prompt, max_new_tokens=64))
    eng._admit()
    tokens = torch.tensor(eng._decode_tokens(), device="cuda")
    whole, halves = [], []
    decode(model, params, {k: v.clone() for k, v in eng.cache.items()}, tokens, whole)
    for rows in (slice(0, B // 2), slice(B // 2, B)):
        rec: list = []
        sub = {k: (v[rows] if k == "lengths" else v[:, rows]).clone()
               for k, v in eng.cache.items()}
        decode(model, params, sub, tokens[rows], rec)
        halves.append(rec)
    torch.cuda.synchronize()
    for (l, name, a), (_, _, b0), (_, _, b1) in zip(whole, *halves):
        b = torch.cat([b0, b1])
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs()
            rows = d.reshape(B, -1).amax(-1).nonzero().flatten().tolist()
            print(f"layer {l} {name}: {int((d > 0).sum())} of {d.numel()} elements differ, "
                  f"max {d.max().item():.4g}, rows {rows}")
    lw, lh = whole[-1][2], torch.cat([halves[0][-1][2], halves[1][-1][2]])
    print(f"first decode argmax differs in rows "
          f"{(lw.argmax(-1) != lh.argmax(-1)).nonzero().flatten().tolist()}")
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    for K, N in ((D, D), (D, cfg.n_kv_heads * cfg.resolved_head_dim()), (D, F), (F, D), (D, V)):
        x = torch.randn(B, K, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(K, N, device="cuda", dtype=torch.bfloat16) * 0.02
        y, y2 = x @ w, torch.cat([x[:B // 2] @ w, x[B // 2:] @ w])
        print(f"GEMM ({B}, {K}) @ ({K}, {N}) vs two halves: {int((y != y2).sum())} of "
              f"{y.numel()} outputs differ")
    print(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
