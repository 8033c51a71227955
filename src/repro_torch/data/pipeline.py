"""Deterministic synthetic token pipeline (+ binary-file reader).

A copy of ``repro.data.pipeline`` (pure numpy, so the port's batches are
the reference's byte for byte); the train step moves a batch to its
device.  Synthetic batches are a pure function of (seed, step, host) so every
restart — including elastic restarts on a different host count — replays
the identical global stream: host h of H draws the global batch and takes
its slice, which keeps the global data order invariant under rescale.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2      # token distribution skew (LM-ish)


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def global_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """(inputs, targets, mask) for one step; targets are inputs shifted."""
    rng = _rng(cfg, step)
    # zipf over vocab, clipped; +1 so 0 can serve as pad/eos
    toks = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = np.minimum(toks, cfg.vocab - 1).astype(np.int32)
    return {
        "inputs": toks[:, :-1],
        "targets": toks[:, 1:],
        "mask": np.ones((cfg.global_batch, cfg.seq_len), np.float32),
    }


def host_batch(cfg: DataConfig, step: int, host: int, n_hosts: int) -> dict[str, np.ndarray]:
    g = global_batch(cfg, step)
    per = cfg.global_batch // n_hosts
    sl = slice(host * per, (host + 1) * per)
    return {k: v[sl] for k, v in g.items()}


def batches(cfg: DataConfig, start_step: int = 0, host: int = 0, n_hosts: int = 1) -> Iterator[dict]:
    step = start_step
    while True:
        yield host_batch(cfg, step, host, n_hosts)
        step += 1


class TokenFileDataset:
    """Memory-mapped pre-tokenized corpus (flat int32 tokens)."""

    def __init__(self, path: str, seq_len: int, batch: int, seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, self.n_windows, size=self.batch)
        starts = idx * self.seq_len
        inp = np.stack([self.tokens[s : s + self.seq_len] for s in starts])
        tgt = np.stack([self.tokens[s + 1 : s + 1 + self.seq_len] for s in starts])
        return {
            "inputs": inp.astype(np.int32),
            "targets": tgt.astype(np.int32),
            "mask": np.ones_like(inp, np.float32),
        }
