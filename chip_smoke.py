"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds every kernel in ``src/repro_torch/kernels/csrc/`` with nvcc
   (one process per source, in parallel) and prints the build time and,
   per kernel, ptxas's registers, shared memory and spills.
3. Kernel phase: each kernel variant against its plain PyTorch version
   at the main paths' shapes, with its device time (the calls queued
   behind a spin kernel, so events time the device and not the host)
   beside the plain version's,
   a PyTorch yardstick on the same work (``scaled_dot_product_attention``;
   for the paged kernel ``gather_paged_cache`` then SDPA, since no single
   call computes paged attention; for the fp8/int8 variants the
   dequantization too; never used by the port) and the least time the
   card could take.  Every prefill case also runs with ``q_offset`` as a
   ``(1,)`` int32 device tensor (what a captured graph passes), which must
   give the int form's bits; the chunk rows are timed in that form too.
   Fifty-six rows: decode (split across CTAs, partials
   merged by a second kernel); prefill unscaled at a whole prompt and at
   the hybrid chunk shape (32 queries at q_offset 192 against the
   1024-position staging stripe, after the chunk edge cases), int8 and
   fp8 K/V, and f32 queries over f32 K/V (float32 mode's CUDA-core
   kernel); paged unscaled, fp8 and int8 pools (split across CTAs like
   the decode); the speculative draft's decode and prefill chunk at its
   own heads (Hkv 2, G 2, D 16); paged bf16 and fp8 pools at block size
   128; decode and whole-prompt prefill at moonshot-v1-16b-a3b's heads
   (Hq = Hkv = 16, G 1, D 128); and at the heads of minicpm-2b (G 1, D 64,
   Hkv 36), llama3.2-3b (G 3), yi-34b (G 7) and internvl2-76b (G 8, the
   kernels' limit; all three D 128, Hkv 8): decode and whole-prompt
   prefill, and for the first three the chunk and paged rows of their
   paged-hybrid paths; decode and whole-prompt prefill at zamba2-1.2b's
   shared block (Hq = Hkv = 32, D 128) and at seamless-m4t-medium's
   decoder heads (Hq = Hkv = 16, D 64), whose decode also reads the 512
   cached frames whole in every row (``decode_attention[seamless-cross]``).  The paged variants are also checked with f32 queries,
   with a ``starts`` window + lse, with NaN in null block 0 and past each
   row's length (never read: equal to the plain version on zeros there)
   and with every window empty (the cold launch of a step with nothing
   spilled: out 0, lse <= -1e30).  The scaled and f32 prefill variants
   are on no serving path (the reference's quantized pools prefill into
   the bf16 staging cache; float32 mode runs in the reference checks):
   kernel level only.  Four rows of the train paths: the flash forward
   with its log-sum-exp (``prefill_attention[train-lse]``: output against
   the plain version and bit-equal to the launch without lse, lse against
   ``logsumexp``) and the flash backward (``flash_attention_bwd``: dq, dk,
   dv against the plain backward, 2e-2 of max(1, |plain|) and 1e-2 in
   norm; two launches bit-equal; an f32 case at 1e-4), at llama3.2-1b's training shape (B 8,
   S 1024, Hq 32, Hkv 8, D 64) and minicpm-2b's microbatch (B 4, Hq = Hkv
   = 36, D 64), and (slice 16) at moonshot's (B 4, Hq = Hkv = 16, D 128:
   the backward's 8-warp route), zamba2's shared block (B 4, Hq = Hkv =
   32, D 128) and seamless's decoder (B 4, Hq = Hkv = 16, D 64); their
   yardsticks are causal SDPA's forward and SDPA's forward + backward
   through autograd.  Three rows of the placed paths (slice 17): the
   decode kernel with its lse output at the serve shape (out and lse
   against the plain version; the two halves of the cache lse-merged
   against the whole-cache kernel; SDPA, which gives no lse, as the
   yardstick), at the head policy's shard on two ranks (Hkv 4) and at the
   sequence policy's window (512 positions, with lse).  Four rows of the
   placed train paths (slice 18): the flash forward with its lse and the
   backward at a rank's share of their 4 x 512 batch, model 2's heads
   (B 4, S 512, Hq 16, Hkv 4, D 64: ``[train-lse-tp2]``, ``[tp2]``) and
   data 2's rows (B 2, Hq 32, Hkv 8: ``[train-lse-dp2]``, ``[dp2]``).
4. Serve phase: full-width llama3.2-1b with seeded random weights through
   ``repro_torch.launch.serve``, seventeen paths, every dispatch kind of each
   one captured CUDA graph (the engine's default on the card; the counts
   of each kind's calls, replays and capture time are printed), each with
   every launch counter zeroed before its async run and read after it:
   a. dense cache, decode-only schedule (slice 1's main path);
   b. paged cache, hybrid chunked-prefill schedule, a pool of 385 blocks
      (6144 positions for up to 16 x 576: admission waits on blocks);
   c. paged-tiered (slice 3's main path): hybrid schedule, fp8 pool of
      129 blocks (2048 positions: the pool must spill) and a host tier
      of 512 blocks;
   d. the same tier with an int8 pool on the decode-only schedule;
   e. dense-spec (slice 6's main path): a with ``--spec-depth 2`` and the
      default reduced draft, on a's first 32 requests;
   f. paged-hybrid-spec: b with ``--spec-depth 2``, on b's first 32;
   g. target-draft: a's first 16 requests at depth 2 with the target as
      its own draft (its cache prefilled whole, the draft's in chunks);
   h. target-draft-hybrid: the same on the dense hybrid schedule, where
      both caches are filled by the same chunk calls: acceptance >= 0.99;
   i. rag: b's pool with the ``rag`` open-loop workload (64 requests at
      0.5 per round, ten shared documents): prefix hits must occur;
   j. chat-fan: c's tiered pool with ``chat-fan`` (64 requests, groups of
      4 sharing a prefix): prefix hits, COW copies, spills, rehydrations;
   k. agentic: a's dense cache with ``agentic`` (16 sessions x 3 turns,
      each turn resubmitted with the prior output as a grown prefix): 32
      resubmissions;
   l. the cluster tier, two replicas on the one card sharing the weights,
      each path async with its launches counted over both replicas and its
      tokens held to its single-engine path's by the tiered criterion
      (every first token equal, >= 60% of all): cluster-affinity and
      cluster-round-robin, i's rag traffic routed by ``--route
      prefix_affinity`` and ``round_robin`` (the router's hit rate of
      each); disagg, b's pool as ``--role-map 1p+1d`` (KV blocks migrate
      from the prefill replica to the decode one: none lost);
      disagg-tiered, the same on c's fp8 pools with host tiers;
   m. sub-batches: a with ``--sub-batches 2`` (two sub-batches of 8 rows,
      each on its own CUDA stream inside the decode graph), async, eager
      and sync; n. dense-8: a at ``--slots 8``, whose decode batch is one
      sub-batch's 8 rows: m's tokens must be n's exactly (a's 16-row
      GEMMs sum one product in another order, so m's agreement with a is
      printed only); then wall ms per engine step of m against
      ``--sub-batches 1`` in turns, and a profile of its decode steps
      (graphs and eager): kernels per stream id and how long kernels ran
      at once.
   o. The placed paths (slice 17): the serve CLI's ``balancer:`` line on
      one rank and on two, checked against the strings the CPU test pins;
      then two ranks of this script on the one card over gloo (started as
      ``torchrun`` starts them, ``--placed-worker``), eager (gloo
      collectives cannot be captured), a's first 16 requests, each rank
      with its own load check (the bytes of its shards): placed-dp (the
      serve CLI's placement: mesh data 2, the batch policy; each rank
      decodes 8 rows) must give n's tokens exactly; placed-head and
      placed-seq (mesh model 2, tensor parallel, the KV heads or the
      positions split) a teacher-forced decode step in float32 (weights,
      activations and cache) at full width cut to 2 layers within 0.1 of
      one rank's logits (at full depth the random model amplifies any
      rounding difference: ``scripts/torch_placed_depth.py``), and in
      bf16 at full depth (the served models) equal to a's model rounding
      wo and w_down as two ranks do (``tp_rounding``), the distance to a's
      own step printed; their agreement with a printed; every rank's tokens,
      ``EngineStats`` and launches (per layer of each step, at the shard's
      heads) equal.  Since slice 19 the same two ranks then serve the
      paged pool on the hybrid schedule, rag's 16 requests under block
      pressure (``--blocks 130``: the block axis splits, and the run
      holds more blocks than a lane's 65, so both lanes hold blocks;
      prefix hits and preemptions must occur): placed-paged-dp (the
      serve CLI's placement, data 2) and placed-paged-seq (model 2, the
      sequence policy, an fp8 pool); every plain attention refused; each
      rank's ``EngineStats``, ``PoolStats`` and ``pool:`` line equal, and
      equal to a one-rank run at the same flags; the paged kernel with
      its lse once per layer of each decode step on a lane's shard and the
      flash kernel once per layer of each chunk at the rank's heads; a
      teacher-forced paged step in float32 at 2 layers, every block copied
      on write to another lane and read back, within PLACED_PAGED_TOL of
      one rank's, every block read back equal to what was written; tok/s
      per rank and collectives a decode step printed.  The kernel phase's lane rows hold two lanes'
      lse-merged partials to the whole-pool kernel, for the block and the
      position cut, bf16 and fp8.  Since slice 20 the same two ranks then
      serve what one rank serves beside: placed-tiered-dp (data 2, an fp8
      pool of ``PLACED_TIERED_BLOCKS`` and a host tier of 512 blocks on the
      hybrid schedule, a's first 16 requests: the host tier whole on each
      rank) and placed-tiered-seq (model 2, the sequence policy, an int8
      pool: the host tier's positions split), each spilling and not
      preempting, its ``EngineStats`` and ``PoolStats`` equal on both
      ranks and to one rank's, the paged kernel twice per layer of each
      decode step (the hot window on the lane's shard, the cold one on the
      rank's share of the host tier), every spilled block's host copy
      equal byte for byte to the device block read before the spill, both
      gathered from the ranks' raw shards (``checked_spills``), and a
      teacher-forced tiered step in float32 at 2 layers: the two ranks'
      pool within one code step of one rank's, and their logits within
      PLACED_TIERED_TOL of one rank's attending over the same pool bytes;
      placed-spec (data 2, ``--spec-depth 2``, the draft placed on the same
      mesh): placed-dp's tokens exactly; placed-sub-batches (data 2,
      ``--sub-batches 2``): one rank's ``--sub-batches 2`` stats, a float32
      step within 1e-3 of one rank's, its token agreement with placed-dp
      and its ms per engine step against placed-dp's printed; and the int8
      dense cache at model level (float32, 2 layers) on data 2 and model
      2 against one rank, each data-2 rank's int8 payload and scales equal
      byte for byte to one rank's rows.  Every path's seconds are printed
      (``[placed] seconds per path``), and the script's phases' at the end
      (``phase seconds:``).
   p. The cluster on meshes of its own (slice 21, ``world_phase``): ranks
      of this script on the one card over gloo (``--world-worker``), each
      running the whole cluster loop through the serve entry points with a
      replica per slice of the world (``launch.mesh.replica_meshes``), the
      other replicas mirrored: world-disagg, two ranks of one replica each
      with graphs, ``DISAGG_FLAGS`` exactly at full width and depth:
      ClusterStats and every replica's EngineStats and PoolStats equal the
      in-process disagg path's on every rank (every request finishes at
      max_new: the step clock does not depend on the tokens), no migration
      lost, the two ranks' launches the step clock's, the tokens held to
      disagg's by the token floor (the count equal printed); placed-disagg,
      four ranks, two replicas of data 2 (eager) on placed-tiered-dp's fp8
      pool and host tier at ``PLACED_LAYERS``: ClusterStats and PoolStats
      equal one rank's cluster at the same flags and depth, every rank's
      tokens equal, every spill's host copy byte-equal, every block a
      migration lands on the decode replica's lanes byte-equal to the block
      exported from the prefill replica's lanes (each read raw on its
      lanes, gathered once at the end), each rank's launches its replica's
      step clock's.  Each prints tok/s, ms a round, world
      broadcasts a round and the migration payloads' bytes and ms.
   Paths a-k, m and n run async (dispatch-ahead) and then sync; the greedy tokens must
   be identical, each kernel row must have launched once per layer of
   every prefill, chunk and decode step of its path (twice per layer of a
   decode step on the tiered paths: hot and cold windows; k + 1 times per
   layer of a speculative window, the target's and the draft's layers
   counted apart by head shape), and the paged paths' pools must drain;
   the tiered paths must spill and not preempt; the speculative paths'
   tokens must equal their non-speculative path's.  Paths a, b, c and e
   (the profiled ones) also run eagerly (``--graphs off``) in the same
   call: graph and eager greedy tokens must be identical; tok/s and wall
   ms per engine step of both.  The eager and sync reruns of a, b, c, e
   and m run llama3.2-1b cut to 2 of its 16 layers (``RERUN_LAYERS``,
   views of the same weights), held to a graph run at that depth: an
   eager step's host time grows with the layers (slice 18); since slice
   19 every other path's sync rerun too, to pay for the placed paged
   paths.
   Then the observatory: path b traced (``--trace`` to a file in the
   temporary directory, wall stamps on) and profiled (``--profile 8``:
   every eighth dispatch fenced on the card) against the same run
   untraced: the trace validates and holds a finished, well-formed span
   tree per request; tokens, stats and launch counts are the untraced
   run's; no dispatch that captured a graph is sampled; no sample's
   measured MFU or MBU (against the H100 SXM's peaks) exceeds 1.05.  It
   prints per dispatch kind the samples, median measured ms, MFU, MBU and
   GB/s, and tok/s traced vs untraced.
   Then the moe path, once llama's weights and every engine are freed:
   moonshot-v1-16b-a3b at full width cut to 8 of its 48 layers
   (``SERVE_LAYERS``: 4,872,112,128 parameters, seeded random bf16
   weights as the serve CLI's loader draws them: memory allocated
   before and after, the peak), its first MoE layer in float32 on the card
   against the CPU (expert ids equal), the serve shape with ``--arch
   moonshot-v1-16b-a3b`` as a-k are run (async through the graphs with
   the counters zeroed, eager, sync: tokens identical; the decode kernel
   once per layer of every decode step and the prefill kernel once per
   layer of every prefill at moonshot's heads), its step clock against the CPU's prediction,
   tok/s and wall ms per decode step beside the weight stream's bound, a
   ``--profile 8`` run's measured decode MBU beside the bytes the
   dropping dispatch really streams, and profiles with graphs and eagerly
   (see 5).
   Before moonshot, dense-kvq: path a on llama3.2-1b's weights with the
   dense cache's int8 ``kv_quant`` form (async; launches as a's; every
   first token equal to a's; the cache under 0.65x of bf16's; the share of
   tokens equal to a's beside a yardstick: one decode step from one
   prefilled state on the bf16 cache moved one ulp, and on the int8 cache;
   the dequantize's device time per layer; a graph profile).  Then the
   rest of the dense registry, one family per phase on a card freed of the
   one before (at most 0.1 GB allocated before each full-width load,
   moonshot's too, with the blocks still held by size): minicpm-2b,
   llama3.2-3b at full width and depth and yi-34b at full
   width and 4 of its 60 layers (dense and paged-hybrid; yi-34b's also sync, and its
   dense eagerly) and internvl2-76b at full width and 16 of its 80
   layers (dense; prefilling 256
   ``embeds`` rows ``embed[u]`` before a prompt equals prefilling ``u``
   with it, bit for bit); each path's step clock against the CPU's
   prediction, its launches per kernel row at its heads, tok/s against
   the bound; float32 at full width cut to 2 layers on the card against
   the CPU for minicpm-2b and yi-34b; and a graph profile of each dense
   path.
   After moonshot, the deepseek path on a card freed of it:
   deepseek-v3-671b at full width cut to 4 of its 61 layers (its 3 dense
   layers and its first MoE layer; 15,797,366,784 parameters, seeded random bf16
   weights drawn on the card: memory before and after the load, the peak),
   float32 at full width cut to its 2 first (dense MLA) layers on the card
   against the CPU, the MLA identity at full width (the absorbed decode
   against expanding K and V per head, float32), its first MoE layer in
   float32 (router and dispatch over all 256 experts; the whole MoE FFN on
   the first 32 experts), the serve shape with ``--arch deepseek-v3-671b``
   (graphs, ``--graphs off``, ``--async off``: tokens identical, the step
   clock the CPU's, and no launch of the three attention kernels: prefill
   runs the plain chunked attention at q/k head dim 192, decode the plain
   absorbed MLA over the latent cache), tok/s against the bound of the
   weights a step reads, the per-step f32 cast of W_O, a ``--profile 8``
   run's decode MBU beside the bytes really read, a graph profile, and the
   device time of one MoE layer's expert bmms, of one layer's MLA decode
   (beside its bound and SDPA over the latent as one shared head) and of
   its prefill attention (beside causal SDPA).
   Then, each on a card freed of the one before, rwkv6-7b and zamba2-1.2b
   at full width, cut to 8 of 32 and 12 of 38 layers (float32 check at 2 layers; the first 32
   requests of the serve shape with ``--arch``, async through the graphs,
   eager and sync: tokens identical, the step clock the CPU's; no attention
   launch on rwkv6, the decode and flash kernels once per shared-block slot
   of each decode step and prefill on zamba2; tok/s against the bound of
   the bytes a step reads; a graph profile; one layer's WKV / SSD scan at a
   decode step and over 509 tokens; a 509-token prefill's wall), and
   seamless-m4t-medium at model level (float32 check at 2 + 2 layers; 16
   rows of seeded frames, a 32-token prompt, 64 greedy steps as one CUDA
   graph: 12 flash launches a prefill and 24 decode launches a step; the
   same against the plain attention on the card; the decode step's busy
   time against its bound).
   Then the train phase (``train_phase``), on a card freed of serving,
   every plain attention refused while its paths run: llama3.2-1b at full
   width and depth through ``repro_torch.launch.train`` (20 steps of 8 x
   1024 tokens; launches exactly 2 L forward with lse (remat) and L
   backward a step; losses and grad norms finite; ms per step, tokens/s,
   MFU against 6 N T + attention, peak memory), the same at full width
   cut to 2 layers (``--layers 2``; the loss must fall: at full depth the
   reference's init makes grad norms ~1e11 and 20 steps do not move it),
   that run failing at step 12 with a checkpoint every 10 (one restart
   from step 10: final params, m, v and step bit-equal to the
   uninterrupted run's, losses of steps 10-19 equal), minicpm-2b at full
   width and depth
   through ``examples/torch_train_minicpm_wsd.py`` (WSD, grad_accum 2,
   int8 compression, 4 steps); then (``family_train_phase``, each on a
   freed card, no checkpoint written) moonshot-v1-16b-a3b at 4 layers,
   deepseek-v3-671b at its 3 dense layers and the MTP block, rwkv6-7b at 4
   layers and zamba2-1.2b at 6 layers (one shared block) through the train CLI, and
   seamless-m4t-medium at model level through ``make_train_step`` (each:
   losses finite, whether they fall printed; launches per step as
   ``train_launches`` says; the plain ``chunked_attention`` calls the
   reference makes too, deepseek's MLA and seamless's encoder and cross
   attention, counted; ms per step, tokens/s, MFU, peak memory); and
   every family reduced in float32, card against CPU: loss and metrics,
   every gradient leaf, one ``train_step``.
   Then the placed train phase (slice 18, ``placed_train_phase``): the
   same work on one rank in this process first, then two ranks of this
   script on the card over gloo (``--placed-train-worker``), llama3.2-1b
   at full width from seed-0 weights and the train CLI's global batch of
   4 x 512: placed-train-dp (data 2 x model 1, ZeRO-1 moments) and
   placed-train-tp (data 1 x model 2) through the train CLI, 8 of the 16
   layers, 3 steps (finite losses, equal on both ranks, step 0's within 5e-2 of one
   rank's; ``m`` and ``v`` per rank half of the whole on data 2; the flash
   lse forward 2 L and the backward L times a step at the shard's heads;
   ms per step and tok/s per rank); placed-train-fsdp (data 2,
   ``Env.fsdp``, 4 layers, 2 steps: losses within 5e-2 of one rank's);
   placed-train-f32 (both meshes, float32, 2 layers, 3 steps at the
   reference's ``TrainConfig()``: step 0's loss and grad norm within
   1e-4 relative of one rank's, every step's within 1e-2); a checkpoint
   of the reduced model (since slice 21) written on data 2 x model 1
   (``--ckpt-every 2``) restored on data 1 x model 2, whose step-2 loss
   is the unbroken run's within 5e-2;
   GPipe over a ``stage`` axis of the two ranks (8 + 8 layers of the train
   block, 4 microbatches of 1 x 512: forward and the stage's weight
   gradients against ``sequential_reference`` over all 16 layers in each
   process); ``int8_psum`` of llama's embedding leaf as int8 (128256 x
   2048, a payload and a scale per rank) equal to its formula; each
   part's wall.
5. Profiles (torch.profiler) of steady async steps on paths a, b, c and
   e, with graphs (eagerly only moonshot's, to keep the script inside its
   time; the other families' and deepseek's with graphs), for where the
   time goes: wall and device
   busy ms per step, device ops per step, host launches per step (graph
   launches and kernel launches apart) and every port kernel's time and
   launches per step (the split kernels and the combine kernel apart); on path c
   also the hot and the cold paged call of one layer on the profiled
   state: device time (queued behind a spin kernel) and host time per
   call.
6. A small-input check: reduced llama3.2-1b in float32 through the
   kernels on the GPU against the plain path on the CPU, same weights:
   prefill and decode on the dense cache, chunked ``prefill_step`` and
   ``paged_decode_step`` on the paged pool — bf16, fp8 and int8 pools,
   the quantized ones also with their first blocks spilled to the host
   tier.
7. A preemption check: reduced llama3.2-1b on a pool too small for both
   sequences, on the GPU, async against sync (greedy tokens) and both
   against the CPU engine (step clock), decode-only and hybrid.
8. A host-tier check: the same model on the GPU with a host tier, async
   and sync: live spills instead of preemption with the unspilled run's
   tokens, a freed prefix re-hydrated with the same continuation, a
   spilled slot reused by another prompt, and the step clock of the CPU
   engine.
9. A speculative check: reduced float32 engines at depth 2 on the GPU
   (async, sync) against the CPU, {dense, paged} x {decode-only, hybrid},
   a mismatched draft and the target as draft: tokens (also those of the
   plain run) and step clock equal; ``verify_step`` / ``paged_verify_step``
   logits GPU vs CPU, with windows past ``max_seq`` and past the table.
10. Block size 128: a reduced serve at ``--cache paged --block-size 128``
   (launches exact at that shape) and reduced float32 engines on the GPU
   against the CPU.
11. A temperature check under graphs: the reduced model's logits for 16
   prompts sampled (temperature 1, top-k 8) by a captured program, 512
   replays against 512 eager draws: consecutive replays draw different
   tokens, each set's counts fit the exact distribution and the two sets
   fit each other (chi-square bounds stated there); then a temperature
   serve through the graphs, plain and speculative.
12. A migration check: a request exported from one reduced engine and
   imported into another (bf16 pool; fp8 pool with its scale pools): the
   gathered blocks equal the source's and the landed blocks the payload,
   by ``torch.equal`` on their bytes; the unmigrated run's tokens.
13. A cluster check: reduced float32 two-replica clusters (1P+1D paged
   hybrid, 1P+1D dense, prefix-affinity paged hybrid), async and sync,
   on the card under graphs against the CPU: tokens, ``ClusterStats`` and
   ``RouterStats`` equal.
14. A sub-batch check: ``sub_batches=2`` under graphs against eager
   and against a plain engine whose batch is one sub-batch (bf16; tokens,
   stats, the decode kernel twice per layer and step), and float32 on the
   card against the CPU.
15. A MoE check: reduced moonshot-v1-16b-a3b in float32, engines on the
   card (graphs) and on the CPU, async and sync, one decode batch and two
   sub-batches: tokens and ``EngineStats`` equal.
16. The same for reduced minicpm-2b (G 1) on the dense cache and on the
   paged pool with the hybrid schedule, and for reduced llama3.2-1b with
   ``kv_quant`` at one and two sub-batches.
17. The same for reduced deepseek-v3-671b (MLA + MoE) at one and two
   sub-batches.

Any failure raises (non-zero exit).  The line before the last is a JSON
object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import balance, offload  # noqa: E402
from repro_torch.core import pipeline as sub_batching  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import heads as kernel_heads  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kbwd  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpaged  # noqa: E402
from repro_torch.kernels import prefill_attention as kpre  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.core.placement import Env  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch.mesh import (DeviceMesh, make_host_mesh, mesh_axes,  # noqa: E402
                                     rank_device, replica_meshes)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import dense as dense_mod  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import mamba2 as mamba2_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rwkv6 as rwkv6_mod  # noqa: E402
from repro_torch.models import zamba2 as zamba2_mod  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.cluster import Cluster  # noqa: E402
from repro_torch.serving.engine import Engine, EngineStats, Request  # noqa: E402
from repro_torch.serving.paged import device as pdev  # noqa: E402
from repro_torch.serving import kv_cache, programs  # noqa: E402
from repro_torch.serving.programs import Program  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig, sample_on_device  # noqa: E402
from repro_torch.serving.telemetry import build_request_trees, validate_trace  # noqa: E402
from repro_torch.serving.workload import build_workload  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch  # noqa: E402
from repro_torch.training.optimizer import leaves, tree_map  # noqa: E402
from repro_torch.training import pipeline_pp  # noqa: E402
from repro_torch.training.trainer import make_train_step, to_device  # noqa: E402
from repro_torch.configs.base import ParallelConfig, RunConfig, TrainConfig  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_8BIT_OPS = 1979e12   # fp8 flop/s and int8 op/s
PEAK_F32_FLOPS = 67e12    # CUDA cores, outside the tensor cores
L2_BYTES = 50 * 2**20
BF16_TOL = 2e-2           # bf16 output, as tests/test_kernels.py holds the Pallas kernels
F32_TOL = 1e-4            # f32 queries: the kernels' f32 sums in another order
SERVE_FLAGS = ["--arch", "llama3.2-1b", "--requests", "64", "--slots", "16",
               "--max-seq", "1024", "--max-new", "64", "--workload", "random",
               "--workload-seed", "0", "--seed", "0", "--device", "cuda"]
PAGED_FLAGS = ["--cache", "paged", "--schedule", "hybrid", "--blocks", "385"]
# 128 usable blocks against the ~185 the paged-hybrid run holds at its peak
# the host tier's blocks on the tiered paths (the null block aside)
HOST_BLOCKS = 512
TIER = ["--host-blocks", str(HOST_BLOCKS), "--blocks", "129"]
TIERED_FLAGS = ["--cache", "paged", "--schedule", "hybrid", "--kv-dtype", "fp8", *TIER]
TIERED_INT8_FLAGS = ["--cache", "paged", "--schedule", "decode-only", "--kv-dtype", "int8",
                     *TIER]
CHUNK_SQ, CHUNK_OFFSET = 32, 192       # a hybrid chunk (--prefill-chunk 32) mid-prompt
# the open-loop workloads at full width: shared documents on the paged
# pool, shared chat prefixes on the tiered pool, grown agentic sessions
RAG_FLAGS = PAGED_FLAGS + ["--workload", "rag", "--arrival-rate", "0.5"]
CHAT_FAN_FLAGS = TIERED_FLAGS + ["--workload", "chat-fan", "--fan", "4"]
AGENTIC_FLAGS = ["--workload", "agentic", "--requests", "16", "--turns", "3"]
# the cluster tier (two replicas on the one card, sharing the weights):
# rag's traffic routed by prefix affinity and by round robin; a 1P+1D
# disaggregated layout on paged-hybrid's and on paged-tiered's pools
CLUSTER_FLAGS = ["--replicas", "2"]
AFFINITY_FLAGS = CLUSTER_FLAGS + ["--route", "prefix_affinity"] + RAG_FLAGS
ROUND_ROBIN_FLAGS = CLUSTER_FLAGS + ["--route", "round_robin"] + RAG_FLAGS
DISAGG_FLAGS = CLUSTER_FLAGS + ["--role-map", "1p+1d"] + PAGED_FLAGS
DISAGG_TIERED_FLAGS = CLUSTER_FLAGS + ["--role-map", "1p+1d"] + TIERED_FLAGS
SUB_BATCH_FLAGS = ["--sub-batches", "2"]
TOKEN_FLOOR = 0.6         # the tiered criterion: every first token equal, >= 60% of all
KVQ_BYTES = 0.65          # the int8 dense cache against bf16's (tests/test_models.py)
PROFILE_EVERY = 8
MAX_SHARE = 1.05          # a measured MFU or MBU above this is a fault, not a reading
SPEC_DEPTH = 2
# the speculative paths serve the first half of the base paths' requests
SPEC_FLAGS = ["--spec-depth", str(SPEC_DEPTH), "--requests", "32"]
PORT_KERNELS = ("decode_split_mma_kernel", "decode_split_fma_kernel", "span_combine_kernel",
                "flash_prefill_mma_kernel", "flash_prefill_fma_kernel",
                "paged_split_mma_kernel", "paged_split_fma_kernel")
LENGTHS = [1, 1024, 1033, 2, 37, 100, 255, 256, 257, 511, 512, 513, 700, 900, 1000, 1023]
# dense decode kernel rows -> (B, S, Hkv, G, D)
DECODE_SHAPES = {"decode_attention": (16, 1024, 8, 4, 64),          # llama3.2-1b
                 "decode_attention[draft]": (16, 1024, 2, 2, 16),   # its reduced draft
                 "decode_attention[moe]": (16, 1024, 16, 1, 128),   # moonshot-v1-16b-a3b
                 "decode_attention[minicpm]": (16, 1024, 36, 1, 64),
                 "decode_attention[llama3b]": (16, 1024, 8, 3, 128),
                 "decode_attention[yi]": (16, 1024, 8, 7, 128),
                 "decode_attention[internvl]": (16, 1024, 8, 8, 128),
                 "decode_attention[zamba2]": (16, 1024, 32, 1, 128),      # its shared block
                 "decode_attention[seamless]": (16, 1024, 16, 1, 64),     # decoder self
                 # decoder cross: every row reads all 512 cached frames
                 "decode_attention[seamless-cross]": (16, 512, 16, 1, 64),
                 # placement (slice 17): llama3.2-1b's decode with the lse output
                 # at the serve shape, and the shards of two ranks: the head
                 # policy's 4 KV heads, the sequence policy's 512-position window
                 "decode_attention[lse]": (16, 1024, 8, 4, 64),
                 "decode_attention[shard-head2]": (16, 1024, 4, 4, 64),
                 "decode_attention[shard-seq2]": (16, 512, 8, 4, 64)}
# the decode rows that return the lse (f32, held to LSE_DECODE_TOL), and the
# window row, whose lengths are rank 0's: LENGTHS clamped to its 512
DECODE_LSE_ROWS = ("decode_attention[lse]", "decode_attention[shard-seq2]")
LSE_DECODE_TOL = 1e-3
# llama3.2-1b's eager and sync reruns (and the graph run they are held to)
# run at this depth: an eager engine step's host time grows with the layers.
# Every llama path's sync rerun since slice 19 (the eager paths' since
# slice 18), to pay for the placed paged paths
RERUN_LAYERS = 2
# the placed paths: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device), each a process of this script (--placed-worker)
PLACED_RANKS = 2
PLACED_FLAGS = ["--requests", "16", "--graphs", "off"]
PLACED_TIMEOUT = 420
# the placed paged paths (slice 19): the paged pool on two lanes, the hybrid
# schedule, rag's 16 requests (shared documents: prefix hits, each a block
# gathered back from the lane that holds it) under block pressure (a pool
# of 129 usable blocks against the ~186 the run would hold: preemptions and
# re-prefills).  An even block count, so that the block axis splits (385
# would leave each lane the whole pool: resolve_spec drops a split that
# does not divide), and one whose lanes hold fewer blocks than the run's
# peak: then some of the blocks in use lie on each lane, whatever ids the
# free list hands out.  scripts/torch_step_clock.py --cache paged
# --schedule hybrid --requests 16 --workload rag --blocks 130: 129 engine
# steps, 735 prefix hits, 7 preemptions, peak 129 blocks.  No workload of
# the serve CLI shares a partial block, so copy-on-write runs in
# teacher_forced_paged instead.
PLACED_PAGED_BLOCKS = 130
PLACED_PAGED_FLAGS = RAG_FLAGS + ["--blocks", str(PLACED_PAGED_BLOCKS)]
# label -> (mesh (data, model), KV policy, kv dtype, the paged kernel's row)
PLACED_PAGED = {"placed-paged-dp": ((2, 1), "batch", "bf16",
                                    "paged_decode_attention[lane-block2]"),
                "placed-paged-seq": ((1, 2), "sequence", "fp8",
                                     "paged_decode_attention[lane-block2,fp8]")}
# the teacher-forced paged step's pool: room for the 16 rag prompts' blocks
# (37 each at most) and their copies, an even count
PLACED_TEACHER_BLOCKS = 1186
# a teacher-forced decode step, 2 ranks (tensor parallel) vs 1.  In float32
# at full width cut to 2 layers, within PLACED_LOGIT_TOL of one rank: the
# random model amplifies any rounding difference about tenfold every 2
# layers (scripts/torch_placed_depth.py), so only a shallow step can be held
# to one rank.  In bf16 (the served route) at full depth, equal
# (PLACED_TP_ROUNDING_TOL) to the one-rank model that rounds wo and w_down
# as two ranks do (tp_rounding): that rounding is the whole difference
PLACED_LOGIT_TOL = 0.1
PLACED_CHECK_LAYERS = 2
PLACED_TP_ROUNDING_TOL = 0.0
# the teacher-forced paged step in float32 at PLACED_CHECK_LAYERS, two ranks
# vs one: placed-paged-dp (the bf16-named pool: f32 in float32 mode) differs
# from one rank only by the lanes' lse merge (6.39e-05 over 8 random-workload
# prompts on the H100); placed-paged-seq adds the tensor-parallel rounding
# of K/V that its fp8 pool can move by a quantum (1.09e-02), held to
# PLACED_LOGIT_TOL as the dense cache's tensor-parallel paths are
PLACED_PAGED_TOL = {"placed-paged-dp": 1e-3, "placed-paged-seq": PLACED_LOGIT_TOL}
# the served depth of the placed paths other than placed-dp and the paths
# held to it (placed-spec, placed-sub-batches): llama3.2-1b at full width cut
# to 2 of its 16 layers (slice 20, to pay for its paths: a placed step's
# time is gloo's collectives, about four a layer), each held to one rank at
# the same depth from the same seed (placed_one_rank)
PLACED_LAYERS = 2
# the placed tiered paths (slice 20): the host tier across the lanes, random's
# first 16 requests (PLACED_FLAGS) on the hybrid schedule.  An even block
# count (the block axis splits over 2 lanes), small enough that one rank
# spills and does not preempt, with a peak above half of it (blocks in use
# on both lanes): scripts/torch_step_clock.py --requests 16 --cache paged
# --schedule hybrid --kv-dtype fp8 --host-blocks 512 --blocks 192: 242 engine
# steps, 228 decode steps, 191 chunks, 352 spills (each finished prefix's
# blocks at free time), no preemption, a peak of 182 blocks.  Served at
# PLACED_LAYERS
PLACED_TIERED_BLOCKS = 192
PLACED_TIERED_FLAGS = ["--cache", "paged", "--schedule", "hybrid", "--host-blocks",
                       str(HOST_BLOCKS), "--blocks", str(PLACED_TIERED_BLOCKS)]
# label -> (mesh (data, model), KV policy, kv dtype, the hot window's row, the
# cold window's): data 2 holds the host tier whole on each rank, model 2 (the
# sequence policy) splits the positions of every host block
PLACED_TIERED = {"placed-tiered-dp": ((2, 1), "batch", "fp8",
                                      "paged_decode_attention[lane-block2,fp8]",
                                      "paged_decode_attention[host-whole,fp8]"),
                 "placed-tiered-seq": ((1, 2), "sequence", "int8",
                                       "paged_decode_attention[lane-block2,int8]",
                                       "paged_decode_attention[host-pos2,int8]")}
# the teacher-forced tiered step in float32 at PLACED_CHECK_LAYERS, two ranks
# vs one: label -> (tolerance of the logits against one rank's own step, None
# for printed only; tolerance against one rank attending over the two ranks'
# pool bytes).  The pools differ where rounding moves a K/V value across a
# code boundary: on data 2 only the lanes' lse merge rounds otherwise (the
# raw step 3.52e-4 on the H100 at 700 W); on model 2 the tensor-parallel
# wo / w_down sums move layer 1's K/V too, and an int8 V code moved by one
# step (amax / 127) next to a heavily attended position moves the logits by
# up to 0.217 on the same card, so the step is held over the same pool
# bytes, where only the rounding of the step itself is left, and the pools
# to one code step (_code_excess; PLACED_SCALE_TOL for their scales)
PLACED_TIERED_TOL = {"placed-tiered-dp": (1e-3, 1e-3), "placed-tiered-seq": (None, 1e-2)}
PLACED_SCALE_TOL = 1e-3
PLACED_CODE_SLACK = 1e-4
PLACED_SPEC_FLAGS = ["--spec-depth", str(SPEC_DEPTH)]
# the sub-batches' teacher-forced step in float32 at PLACED_CHECK_LAYERS
PLACED_SUB_TOL = 1e-3
# the int8 dense cache at model level (float32, PLACED_CHECK_LAYERS): label ->
# (mesh, KV policy, tolerance against one rank)
PLACED_KVQ = {"placed-kvq-dp": ((2, 1), "batch", 1e-3),
              "placed-kvq-seq": ((1, 2), "sequence", PLACED_LOGIT_TOL)}
# slice 21, the cluster on meshes of its own: world-disagg, DISAGG_FLAGS on
# two ranks of the card, one replica each (with graphs), held to the
# in-process disagg path; placed-disagg, two replicas of data 2 (four ranks,
# eager) on placed-tiered-dp's fp8 pool and host tier at PLACED_LAYERS, held
# to one rank's cluster at the same flags and depth
WORLD_RANKS = 2
PLACED_DISAGG_RANKS = 4
PLACED_DISAGG_FLAGS = (PLACED_FLAGS + ["--replicas", "2", "--role-map", "1p+1d"]
                       + PLACED_TIERED_FLAGS + ["--kv-dtype", "fp8"])
WORLD_TIMEOUT = 420
# the serve CLI's balancer line for llama3.2-1b on a world of 1 and of 2
# (data 2): tests/test_torch_placement.py pins the same strings
BALANCER = {1: "balancer: policy=batch sub_batches=1 bottleneck=attention "
               "(t_att=167.81ms t_lin=3.66ms)",
            2: "balancer: policy=batch sub_batches=1 bottleneck=attention "
               "(t_att=83.91ms t_lin=1.83ms)"}
# attention heads (Hq, Hkv, D) of the full-width families beside llama3.2-1b,
# by the tag their kernel rows carry
HEADS = {"moe": (16, 16, 128),            # moonshot-v1-16b-a3b
         "minicpm": (36, 36, 64),         # minicpm-2b: G 1, the paper's regime
         "llama3b": (24, 8, 128),         # llama3.2-3b: G 3
         "yi": (56, 8, 128),              # yi-34b: G 7
         "internvl": (64, 8, 128),        # internvl2-76b's backbone: G 8, the kernels' MAX_G
         "zamba2": (32, 32, 128),         # zamba2-1.2b's shared block: 2 * 2048 / 32 wide
         "seamless": (16, 16, 64),        # seamless-m4t-medium's decoder self-attention
         "tp2": (16, 4, 64)}              # llama3.2-1b on one of two tensor-parallel ranks
# the MoE path: moonshot-v1-16b-a3b at full width on the dense cache
MOE_FLAGS = ["--arch", "moonshot-v1-16b-a3b"]
MOE_PARAMS = 4872112128
# its step clock as `scripts/torch_step_clock.py --arch moonshot-v1-16b-a3b`
# predicts it on the CPU (the reduced model at the full vocabulary)
MOE_CLOCK = {"prefills": 64, "decode_steps": 252, "engine_steps": 841, "generated": 4096}
MOE_LAYER_TOL = 1e-4      # one MoE layer in float32, card vs CPU: f32 sums in other orders
# the DeepSeek path: deepseek-v3-671b at full width, cut from 61 layers to its 3
# dense layers and its first MoE layer (31.59 GB of bf16 weights; 5 layers, 54.61,
# until slice 21)
DS_FLAGS = ["--arch", "deepseek-v3-671b"]
DS_LAYERS = 4
DS_PARAMS = 15797366784
# its step clock as `scripts/torch_step_clock.py --arch deepseek-v3-671b` predicts it
DS_CLOCK = {"prefills": 64, "decode_steps": 252, "engine_steps": 841, "generated": 4096}
# the float32 MoE layer check: the router and the dispatch over all 256 experts, the
# whole moe_ffn over the first 32 (its 45 GB of f32 experts fit neither beside the
# weights on the card nor comfortably on the host)
DS_EXPERT_SLICE = 32
# absorbed vs expanded MLA at full width in f32: f32 sums of 512 and 192 terms in
# other orders, against the largest output
MLA_IDENTITY_TOL = 1e-4
# the rest of the dense registry at full width: arch -> the tag of its kernel rows
WIDE_TAGS = {"minicpm-2b": "minicpm", "llama3.2-3b": "llama3b", "yi-34b": "yi",
             "internvl2-76b": "internvl"}
# the families served at full width and a cut depth: internvl2-76b's 80
# layers (141 GB of bf16 weights) to 16, which one card holds; the others
# so that the whole script ends well inside its 1200 s limit on the
# slowest host measured (PERF.md: at full depth it took 1408 s)
SERVE_LAYERS = {"internvl2-76b": 16, "yi-34b": 4, "moonshot-v1-16b-a3b": 8,
                "rwkv6-7b": 8, "zamba2-1.2b": 12}
# parameters at the depth run
WIDE_PARAMS = {"minicpm-2b": 2725173504, "llama3.2-3b": 3212749824, "yi-34b": 3148938240,
               "internvl2-76b": 15791824896}
# step clocks as `scripts/torch_step_clock.py --arch <id> [PAGED_FLAGS]` predicts them
# on the CPU (the reduced model at the full vocabulary: the vocabulary, not the
# model, sets the random workload's prompt lengths, since a token draw's
# rejection sampling depends on it)
_DENSE_CLOCK = {"prefills": 64, "decode_steps": 252, "generated": 4096}
WIDE_CLOCK = {("minicpm-2b", "dense"): {**_DENSE_CLOCK, "engine_steps": 841},
              ("llama3.2-3b", "dense"): {**_DENSE_CLOCK, "engine_steps": 880},
              ("yi-34b", "dense"): {**_DENSE_CLOCK, "engine_steps": 858},
              ("internvl2-76b", "dense"): {**_DENSE_CLOCK, "engine_steps": 880},
              ("minicpm-2b", "paged-hybrid"): {
                  **_DENSE_CLOCK, "prefill_chunks": 603, "decode_steps": 610,
                  "engine_steps": 624, "preemptions": 0},
              ("llama3.2-3b", "paged-hybrid"): {
                  **_DENSE_CLOCK, "prefill_chunks": 643, "decode_steps": 649,
                  "engine_steps": 663, "preemptions": 0},
              ("yi-34b", "paged-hybrid"): {
                  **_DENSE_CLOCK, "prefill_chunks": 619, "decode_steps": 629,
                  "engine_steps": 643, "preemptions": 0}}
# the family whose paths also run synchronously, and its dense path eagerly
# (tokens equal to the async graph run's); the other new paths run async
# only, to keep the script inside its time
REPEAT_ARCHS = ("yi-34b",)
# float32 at full width, cut to 2 layers, card vs CPU (TF32 off): the logits of
# a prefill (f32 sums in other orders through two layers and the unembedding)
# and of a decode step (the plain decode also rounds p to the bf16 cache's
# dtype before P.V, the kernel does not: as reference_check's 5e-2)
F32_WIDE = {"prefill": 1e-3, "decode": 5e-2}
# the same for the encoder-decoder: its 4-D attention weights are drawn with
# the reference's fan-in of their second-to-last axis (the 16 heads), so the
# random model's q and k reach ~40 and its scores hundreds, where f32 ulps of
# a score move the near one-hot softmax: the plain attention alone, on the
# same inputs, differs by 1.2e-3 of outputs ~35 between card and CPU
F32_WIDE_ENCDEC = {"prefill": 5e-2, "decode": 5e-2}
MEM_FREED = 0.1e9         # bytes a freed card may hold before a full-width load
# the recurrent families at full width and SERVE_LAYERS' depth, served on the dense state
# cache: arch -> the tag of their lines and kernel rows
RECURRENT_TAGS = {"rwkv6-7b": "rwkv6", "zamba2-1.2b": "zamba2"}
RECURRENT_PARAMS = {"rwkv6-7b": 2296922112, "zamba2-1.2b": 623062784}
# their eager whole-prompt prefills step the recurrence one token at a time,
# host-bound (~0.4 s for 509 tokens): their serve paths take the first 32 of
# the serve shape's 64 requests, to keep the script inside its time
RECURRENT_REQUESTS = ["--requests", "32"]
# their step clocks as `scripts/torch_step_clock.py --arch <id> --requests 32`
# predicts them
_RECURRENT_CLOCK = {"prefills": 32, "decode_steps": 126, "engine_steps": 468,
                    "generated": 2048}
RECURRENT_CLOCK = {"rwkv6-7b": _RECURRENT_CLOCK, "zamba2-1.2b": _RECURRENT_CLOCK}
# seamless-m4t-medium at model level (the serving engine passes no frames):
# rows, frames of the stub frontend, decoder prompt tokens, greedy steps
SEAMLESS = "seamless-m4t-medium"
SEAMLESS_PARAMS = 977860608
SEAMLESS_ROWS, SEAMLESS_PROMPT, SEAMLESS_STEPS = 16, 32, 64
# training: llama3.2-1b at full width and depth through the train CLI, 20
# steps of 8 x 1024 tokens, then at 2 layers, then that with a failure at
# step 12 and a checkpoint every 10 (one restart, from step 10; at 2 layers
# since slice 19: the full depth's two saves and restore of its 12.4 GB
# state took ~43 s of the script's 1200); minicpm-2b at full width
# through the port of examples/train_minicpm_wsd.py (WSD, grad_accum 2,
# int8 compression, 8 x 1024 tokens: microbatches of 4 rows)
TRAIN_FLAGS = ["--arch", "llama3.2-1b", "--batch", "8", "--seq", "1024", "--steps", "20",
               "--device", "cuda"]
TRAIN_RESUME_FLAGS = ["--fail-at-step", "12", "--ckpt-every", "10"]
TRAIN_STEPS, TRAIN_FAIL, TRAIN_CKPT = 20, 12, 10
MINICPM_TRAIN_STEPS = 4
# the other families' train paths at full width, each on a card freed of
# the one before: moonshot-v1-16b-a3b cut to 4 layers (1 dense + 3 MoE),
# deepseek-v3-671b to its 3 dense layers and the MTP block (one MoE layer
# alone is 11.3e9 parameters), rwkv6-7b to 4 layers, zamba2-1.2b to 6 (12
# until slice 20, whose placed paths it pays for: 6 is the least depth that
# holds a shared attention block, whose kernels the path must launch); no
# checkpoint is written (--ckpt-every 0)
FAMILY_TRAIN = {
    "train-moe": ["--arch", "moonshot-v1-16b-a3b", "--layers", "4", "--batch", "4",
                  "--seq", "1024", "--steps", "4"],
    "train-deepseek": ["--arch", "deepseek-v3-671b", "--layers", "3", "--batch", "1",
                       "--seq", "1024", "--steps", "3"],
    "train-rwkv6": ["--arch", "rwkv6-7b", "--layers", "4", "--batch", "4", "--seq", "1024",
                    "--steps", "3"],
    "train-zamba2": ["--arch", "zamba2-1.2b", "--layers", "6", "--batch", "4", "--seq", "1024",
                     "--steps", "3"],
}
# seamless-m4t-medium at full depth, at model level (the synthetic batches
# hold no source frames): rows, decoder tokens, steps; frontend_len frames
SEAMLESS_TRAIN = (4, 1024, 4)
# the kernel rows of each train path, by the tag of its attention shape
TRAIN_TAGS = {"train-moe": "moe", "train-zamba2": "zamba2", "train-seamless": "seamless"}
# (B, S, Hq, Hkv, D) of the attention on each train path: llama's batch,
# minicpm's microbatch of 4 rows, moonshot's (D 128, the backward's
# 8-warp route), zamba2's shared block (D 128) and seamless's decoder
TRAIN_SHAPES = {None: (8, 1024, 32, 8, 64), "minicpm": (4, 1024, 36, 36, 64),
                "moe": (4, 1024, 16, 16, 128), "zamba2": (4, 1024, 32, 32, 128),
                "seamless": (4, 1024, 16, 16, 64),
                # a rank's share of the placed train paths' 4 x 512 batch:
                # the heads of model 2, the rows of data 2 (slice 18)
                "tp2": (4, 512, 16, 4, 64), "dp2": (2, 512, 32, 8, 64)}
PT_TAGS = ("tp2", "dp2")
TRAIN_F32_CASE = (1, 300, 4)      # (B, S, Hkv/G scale-down) of the f32 backward check
LSE_TOL = 1e-4                    # f32 in both: the kernel's log2-domain sums vs logsumexp
# each bf16 gradient's ||kernel - plain|| / ||plain||: bf16 rounding of P,
# dS and the outputs reads a few 1e-3; a wrong delta or lse reads 1e-1
BWD_REL_NORM_TOL = 1e-2
TRAIN_LOSS_TOL = 1e-5             # reduced float32 loss, card vs CPU (relative)
# every gradient leaf within this share of its largest element, card vs
# CPU in float32: the attention backward's P * (dP - delta) cancels where
# the random model attends almost uniformly; the CPU's own f32 gradients
# of q and k sit ~1.5e-4 of their largest from a float64 run
TRAIN_GRAD_TOL = 1e-3

# the placed train paths (slice 18): two ranks of this script on the one
# card over gloo (--placed-train-worker), llama3.2-1b at full width from
# seeded random weights, the train CLI's global batch of 4 x 512
PT_CONFIG = functools.partial(get_config, "llama3.2-1b")
PT_FLAGS = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "512", "--ckpt-every", "0"]
PT_BATCH, PT_SEQ = 4, 512
PT_LAYERS, PT_STEPS = 8, 3              # placed-train-dp / -tp: 8 of 16 layers, for time
PT_FSDP_LAYERS, PT_FSDP_STEPS = 4, 2
PT_F32_LAYERS = 2                       # placed-train-f32 and -restore
PT_CKPT = 2                             # -restore: --ckpt-every, the step restored
PT_TIMEOUT = 420
# bf16 losses against one rank's (absolute): the two ranks' GEMMs see half
# the rows or half the K dim and round elsewhere; test_sharded.py's bound
# for GSPMD's own sharded run
PT_LOSS_TOL = 5e-2
# float32 losses and grad norms against one rank's, relative: step 0 is
# rounding alone; later steps are one Adam update away, which moves every
# element by ~lr x sign(g) whatever |g|, so an element whose gradient
# changes sign between two summation orders moves 2 lr the other way, and
# the random 2-layer model's grad norm is that sensitive to its params
# (142.4 -> 149.8 from step 1 to 2 at lr 6e-6 on the H100: PERF.md)
PT_F32_TOL, PT_F32_STEP_TOL = 1e-4, 1e-2
# GPipe over two stages: 8 + 8 layers, 4 microbatches of 1 x PT_SEQ;
# forward (of max(1, |ref|)) and gradients (in norm) against
# sequential_reference: the same products on the same inputs
PIPE_LAYERS, PIPE_MICRO, PIPE_TOL = 16, 4, 2e-2


def _time_ms(fns, iters: int = 30) -> float:
    """Mean device time of one call, cycling through ``fns`` (one per
    input copy, so inputs larger than L2 are read cold)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fns, iters: int = 30) -> float:
    """Device time of one call, cycling through ``fns``: the calls are
    queued behind a spin kernel (``torch.cuda._sleep``), so the events
    around them time the device alone and not the host's dispatch.  The
    spin doubles until the host had queued every call before the device
    reached the first."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    while cycles < 1 << 34:
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("_device_ms: the host could not queue the calls ahead of the device")


def _times(kernel, plain, library) -> dict:
    """A kernel row's times per call: ``ms``, ``plain_ms`` and
    ``library_ms`` are device time (:func:`_device_ms`, gaps between a
    call's kernels included); ``event_ms`` is
    the kernel wrapper's CUDA-event time over back-to-back calls, which
    measures the host's dispatch instead once the kernel is faster than
    the wrapper's Python (earlier PRs' kernel times were event times)."""
    return {"ms": _device_ms(kernel), "event_ms": _time_ms(kernel),
            "plain_ms": _device_ms(plain, 10), "library_ms": _device_ms(library)}


def _bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------- kernel phase
def decode_phase(dev, name: str = "decode_attention") -> dict:
    """Decode attention at 16 slots, max_seq 1024, bf16, at the heads of
    the row ``name`` (:data:`DECODE_SHAPES`): llama3.2-1b's; its
    ``--spec-depth`` draft's (reduced llama3.2-1b: Hkv 2, G 2, D 16, padded
    to 32 in the tensor-core kernel), which decodes k + 1 times per
    speculative step; moonshot-v1-16b-a3b's (Hkv 16, G 1, D 128: one real
    row in each m16 tile); and the full-width families'."""
    B, S, Hkv, G, D = DECODE_SHAPES[name]
    lse = name in DECODE_LSE_ROWS
    gen = torch.Generator(device=dev).manual_seed(1)
    # a cache shorter than LENGTHS' (the cross cache) is read whole by every
    # row; the sequence policy's window holds LENGTHS' first 512 positions
    lengths = torch.tensor(LENGTHS if S == 1024 else [S] * B, dtype=torch.int32, device=dev)
    if name == "decode_attention[shard-seq2]":
        lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev).clamp(max=S)
    cache_bytes = 2 * B * S * Hkv * D * 2
    n_copies = max(1, math.ceil(2 * L2_BYTES / cache_bytes))
    sets = []
    for _ in range(n_copies):
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
        sets.append((q, k, v))
    q, k, v = sets[0]
    extra = {}
    if lse:
        out, out_lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
        exp, exp_lse = kdec.plain(q, k, v, lengths, return_lse=True)
        extra["lse_max_abs_err"] = _max_err(out_lse, exp_lse)
        if not extra["lse_max_abs_err"] <= LSE_DECODE_TOL:
            raise AssertionError(f"{name} kernel lse vs plain: max err {extra}")
    else:
        out = ops.decode_attention(q, k, v, lengths)
        exp = kdec.plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    if not err <= BF16_TOL:
        raise AssertionError(f"{name} kernel vs plain: max err {err}")
    if name == "decode_attention[lse]":
        # the sequence policy on two ranks: each half with its lse, merged,
        # against the kernel over the whole cache
        h = S // 2
        halves = [ops.decode_attention(q, k[:, a:a + h], v[:, a:a + h],
                                       (lengths - a).clamp(0, h), return_lse=True)
                  for a in (0, h)]
        extra["merged_halves_err"] = _max_err(ref.lse_merge(halves), out)
        if not extra["merged_halves_err"] <= BF16_TOL:
            raise AssertionError(f"{name}: merged halves vs the whole cache {extra}")
        print(f"kernel {name}: two windows' partials lse-merged vs the whole-cache kernel: "
              f"max err {extra['merged_halves_err']:.2e} (tol {BF16_TOL})")

    pos = torch.arange(S, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]            # (B,1,1,S)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.view(B, Hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_out = library(q, k, v).view(B, Hkv * G, D)
    lib_err = _max_err(lib_out, exp)
    live = int(lengths.clamp(max=S).sum())
    nbytes = 2 * live * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4 + (B * Hkv * G * 4 if lse else 0)
    flops = 4 * live * Hkv * G * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "decode_attention", "variant": "lse" if lse else "unscaled",
        "heads": kernel_heads(Hkv, G, D), "route": "cuda", "source": kdec.SOURCE,
        "replaces": kdec.REPLACES, "max_abs_err": err, "tol": BF16_TOL, **extra,
        **_times([lambda s=s: ops.decode_attention(*s, lengths, return_lse=lse) for s in sets],
                 [lambda s=s: kdec.plain(*s, lengths, return_lse=lse) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} S={S} Hkv={Hkv} G={G} D={D} bf16 lengths={lengths.tolist()} "
                 f"split={kdec.plan_split(S, B * Hkv, kdec.sm_count(dev))}",
    }


def _quantize(x: torch.Tensor, kv: str | None):
    """``(payload, scale)`` of ``x`` in the pool's storage: bf16 and no
    scale for the unscaled kernels, fp8/int8 with f32 scales else."""
    if kv is None:
        return x.bfloat16(), None
    return ref.kv_quantize(x, kv)


def _row_name(kernel: str, kv: str | None) -> str:
    return kernel if kv is None else f"{kernel}[{kv}]"


def _same_at_tensor_offset(out, q, k, v, off: int, ks=None, vs=None) -> None:
    """The flash kernel with ``q_offset`` read from device memory (a
    ``(1,)`` int32 tensor, as a captured graph passes it) must give the
    bits of its int form ``out``."""
    dev_off = torch.tensor([off], dtype=torch.int32, device=q.device)
    got = ops.flash_attention(q, k, v, q_offset=dev_off, k_scale=ks, v_scale=vs)
    if not torch.equal(got, out):
        raise AssertionError(f"prefill_attention at a tensor q_offset {off} differs from the "
                             f"int form (Sq={q.shape[1]}, K/V {k.dtype}): max err "
                             f"{_max_err(got, out)}")


def prefill_phase(dev, kv: str | None = None, tag: str | None = None) -> dict:
    """llama3.2-1b prefill attention (Hq 32, Hkv 8, D 64, bf16 queries, B 1)
    at odd prompt lengths, q_offset 0 (the main path) and 17; ``kv``:
    int8/fp8 K/V with (B, Sk, Hkv) f32 scales (the scaled variant);
    ``tag``: at another family's heads (:data:`HEADS`)."""
    Hq, Hkv, D = HEADS[tag] if tag else (32, 8, 64)
    name = f"prefill_attention[{tag}]" if tag else _row_name("prefill_attention", kv)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases, timed = [], None
    for sq, off in ((37, 0), (37, 17), (509, 17), (509, 0)):
        sk = sq + off
        q = torch.randn(1, sq, Hq, D, generator=gen, device=dev).bfloat16()
        k, ks = _quantize(torch.randn(1, sk, Hkv, D, generator=gen, device=dev), kv)
        v, vs = _quantize(torch.randn(1, sk, Hkv, D, generator=gen, device=dev), kv)
        out = ops.flash_attention(q, k, v, q_offset=off, k_scale=ks, v_scale=vs)
        exp = kpre.plain(q, k, v, q_offset=off, k_scale=ks, v_scale=vs)
        _same_at_tensor_offset(out, q, k, v, off, ks, vs)
        torch.cuda.synchronize()
        err = _max_err(out, exp)
        if not err <= BF16_TOL:
            raise AssertionError(f"{name} kernel vs plain at Sq={sq} q_offset={off}: "
                                 f"max err {err}")
        cases.append({"sq": sq, "sk": sk, "q_offset": off, "max_abs_err": err})
        timed = (q, k, v, ks, vs, sq, sk, off)
    q, k, v, ks, vs, sq, sk, off = timed      # the main path's case: q_offset 0, Sq 509

    def library():
        kd = k if kv is None else ref.kv_dequantize(k, ks)
        vd = v if kv is None else ref.kv_dequantize(v, vs)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    exp = kpre.plain(q, k, v, k_scale=ks, v_scale=vs)
    lib_err = _max_err(library().transpose(1, 2), exp)
    pairs = sum(min(sk, off + i + 1) for i in range(sq))    # visible (q, k) pairs
    flops = 4 * pairs * Hq * D
    scale_bytes = 0 if kv is None else 2 * ks.numel() * 4
    nbytes = 2 * 2 * q.numel() + k.numel() * k.element_size() * 2 + scale_bytes
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS if kv is None
                                else PEAK_8BIT_OPS)
    return {
        "name": name, "kernel": "prefill_attention",
        "variant": kv or "unscaled", "heads": kernel_heads(Hkv, Hq // Hkv, D),
        "route": "cuda", "source": kpre.SOURCE,
        "replaces": kpre.REPLACES,
        "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": BF16_TOL,
        **_times([lambda: ops.flash_attention(q, k, v, k_scale=ks, v_scale=vs)],
                 [lambda: kpre.plain(q, k, v, k_scale=ks, v_scale=vs)], [library]),
        "library": "scaled_dot_product_attention" if kv is None
                   else "ref.kv_dequantize (k, v) + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "f32_fma_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "shape": f"B=1 Sq=Sk={sq} Hq={Hq} Hkv={Hkv} D={D} q bf16, K/V {kv or 'bf16'} "
                 "causal q_offset=0",
        "cases": cases,
    }


def prefill_chunk_phase(dev, tag: str | None = None) -> dict:
    """llama3.2-1b prefill attention at the hybrid schedule's chunk shape
    (``--prefill-chunk 32``): 32 bf16 queries at q_offset 192 against the
    1024-position staging stripe (B 1, Hq 32, Hkv 8, D 64, causal), after
    the chunk's edge cases Sq in {1, 5, 32} x q_offset in {0, 17, 192,
    991}.  ``tag`` "draft": the same at the ``--spec-depth`` draft's heads
    (Hq 4, Hkv 2, D 16), whose cache is prefilled in such chunks against
    its 1024-position stripe; another ``tag``: at that family's heads
    (:data:`HEADS`), the paged-hybrid path's chunk.  Yardstick: one SDPA call over ``k[:, :q_offset
    + Sq]`` with a lower-right causal mask.  The bound counts the keys the
    chunk sees."""
    draft = tag == "draft"
    Hq, Hkv, D = (4, 2, 16) if draft else HEADS[tag] if tag else (32, 8, 64)
    S = 1024
    name = f"prefill_attention[{tag}-chunk]" if tag else "prefill_attention[chunk]"
    sq, off = CHUNK_SQ, CHUNK_OFFSET
    gen = torch.Generator(device=dev).manual_seed(3)
    n_copies = max(1, math.ceil(2 * L2_BYTES / (2 * S * Hkv * D * 2)))
    sets = [tuple(torch.randn(1, *shape, generator=gen, device=dev).bfloat16()
                  for shape in ((sq, Hq, D), (S, Hkv, D), (S, Hkv, D)))
            for _ in range(n_copies)]
    _, k, v = sets[0]
    cases = []
    for n in (1, 5, 32):
        for o in (0, 17, 192, 991):
            q = torch.randn(1, n, Hq, D, generator=gen, device=dev).bfloat16()
            out = ops.flash_attention(q, k, v, q_offset=o)
            exp = kpre.plain(q, k, v, q_offset=o)
            _same_at_tensor_offset(out, q, k, v, o)
            torch.cuda.synchronize()
            err = _max_err(out, exp)
            if not err <= BF16_TOL:
                raise AssertionError(f"{name} kernel vs plain at Sq={n} "
                                     f"q_offset={o}: max err {err}")
            cases.append({"sq": n, "q_offset": o, "max_abs_err": err})
    q, k, v = sets[0]
    out = ops.flash_attention(q, k, v, q_offset=off)
    exp = kpre.plain(q, k, v, q_offset=off)
    _same_at_tensor_offset(out, q, k, v, off)
    err = _max_err(out, exp)
    if not err <= BF16_TOL:
        raise AssertionError(f"{name} kernel vs plain: max err {err}")
    mask = torch.ones(sq, off + sq, dtype=torch.bool, device=dev).tril(diagonal=off)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :off + sq].transpose(1, 2),
            v[:, :off + sq].transpose(1, 2), attn_mask=mask, enable_gqa=True)

    lib_err = _max_err(library(q, k, v).transpose(1, 2), exp)
    dev_off = torch.tensor([off], dtype=torch.int32, device=dev)
    pairs = sum(min(S, off + i + 1) for i in range(sq))
    flops = 4 * pairs * Hq * D
    nbytes = 2 * 2 * q.numel() + 2 * (off + sq) * Hkv * D * 2
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "prefill_attention",
        "variant": "unscaled", "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda",
        "source": kpre.SOURCE,
        "replaces": kpre.REPLACES, "max_abs_err": max([err] + [c["max_abs_err"] for c in cases]),
        "tol": BF16_TOL,
        **_times([lambda s=s: ops.flash_attention(*s, q_offset=off) for s in sets],
                 [lambda s=s: kpre.plain(*s, q_offset=off) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        # the form the captured graphs launch: q_offset read from device memory
        "device_offset_ms": _device_ms([lambda s=s: ops.flash_attention(*s, q_offset=dev_off)
                                        for s in sets]),
        "library": "scaled_dot_product_attention over k[:, :q_offset + Sq], lower-right "
                   "causal mask",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B=1 Sq={sq} q_offset={off} Sk={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
                 + ("(the draft's prefill chunk against its cache stripe)" if draft
                    else "(the hybrid chunk against the staging stripe)"),
        "cases": cases,
    }


def prefill_f32_phase(dev) -> dict:
    """float32 mode's flash prefill: f32 queries over f32 K/V (the
    CUDA-core kernel) at the whole-prompt shape, llama3.2-1b's heads (Hq
    32, Hkv 8, D 64), B 1, Sq = Sk = 509, causal.  Its bound takes the f32
    flops at the CUDA cores' peak: float32 mode's tolerances rule out
    bf16 and TF32 operands.  Yardstick: one SDPA call on the same f32
    tensors (TF32 off, PyTorch's default for matrix products)."""
    Hq, Hkv, D, sq = 32, 8, 64, 509
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(1, sq, h, D, generator=gen, device=dev) for h in (Hq, Hkv, Hkv))
    out = ops.flash_attention(q, k, v)
    exp = kpre.plain(q, k, v)
    _same_at_tensor_offset(out, q, k, v, 0)
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    if not (out.dtype == torch.float32 and err <= F32_TOL):
        raise AssertionError(f"prefill_attention[f32] kernel vs plain: max err {err}")

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True)

    lib_err = _max_err(library().transpose(1, 2), exp)
    flops = 4 * (sq * (sq + 1) // 2) * Hq * D
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_F32_FLOPS)
    return {
        "name": "prefill_attention[f32]", "kernel": "prefill_attention",
        "variant": "f32-query", "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda",
        "source": kpre.SOURCE,
        "replaces": kpre.REPLACES, "max_abs_err": err, "tol": F32_TOL,
        **_times([lambda: ops.flash_attention(q, k, v)], [lambda: kpre.plain(q, k, v)],
                 [library]),
        "library": "scaled_dot_product_attention (f32)", "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B=1 Sq=Sk={sq} Hq={Hq} Hkv={Hkv} D={D} q, K/V f32 causal q_offset=0",
    }


def _poison(pool, spool, tables, lengths, bs: int, nan: bool):
    """Copies of a pool and its scales with null block 0 and every
    position past its row's length inside a live block set to NaN (``nan``;
    an fp8 payload of 0x7F, an int8 payload of 127 with a NaN scale) or
    to zeros."""
    pool, spool = pool.clone(), None if spool is None else spool.clone()
    if pool.dtype == torch.float8_e4m3fn:
        fill = 0x7F if nan else 0
    elif pool.dtype == torch.int8:
        fill = 127 if nan else 0
    else:
        fill = float("nan") if nan else 0.0
    sfill = float("nan") if nan else 0.0
    rows = ref.byte_view(pool)
    rows[0] = fill
    if spool is not None:
        spool[0] = sfill
    for b, n in enumerate(lengths.tolist()):
        if 0 < n < tables.shape[1] * bs and n % bs:
            blk = int(tables[b, n // bs])
            rows[blk, :, n % bs:] = fill
            if spool is not None:
                spool[blk, :, n % bs:] = sfill
    return pool, spool


def paged_phase(dev, kv: str | None = None, bs: int = 16, tag: str | None = None) -> dict:
    """llama3.2-1b paged decode attention at the serve shapes: 16 slots,
    block 16, 64 blocks per row, a pool of 1025 blocks, bf16 queries; the
    decode row's ragged lengths (clamped to 1024 by the kernel), a
    scrambled table and garbage in null block 0 (of the scale pools too).
    ``kv``: an fp8/int8 pool with its f32 scale pools.  ``bs``: another
    block size over the same 1024 positions (``--block-size 128``: 8
    blocks per row).  ``tag``: at another family's heads (:data:`HEADS`)."""
    Hq, Hkv, D = HEADS[tag] if tag else (32, 8, 64)
    B, G, MB = 16, Hq // Hkv, 1024 // bs
    N = B * MB + 1
    name = _row_name("paged_decode_attention", ",".join(
        x for x in (tag, kv, None if bs == 16 else f"bs{bs}") if x) or None)
    gen = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(5)) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(LENGTHS):
        k = min(-(-n // bs), MB)
        tables[b, :k] = perm[used:used + k]
        used += k
    tables = tables.to(dev)
    elem = 2 if kv is None else 1
    pool_bytes = 2 * N * Hkv * bs * D * elem
    n_copies = max(1, math.ceil(2 * L2_BYTES / pool_bytes))
    sets = []
    for _ in range(n_copies):
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).bfloat16()
        kf = torch.randn(N, Hkv, bs, D, generator=gen, device=dev)
        vf = torch.randn(N, Hkv, bs, D, generator=gen, device=dev)
        kf[0], vf[0] = 99.0, -99.0
        (kp, ks), (vp, vs) = _quantize(kf, kv), _quantize(vf, kv)
        if kv is not None:
            ks[0], vs[0] = 7.5, -3.0
        sets.append((q, kp, vp, ks, vs))

    def call(fn, q, kp, vp, ks, vs, **kw):
        return fn(q, kp, vp, tables, lengths, k_scale=ks, v_scale=vs, **kw)

    q, kp, vp, ks, vs = sets[0]
    out = call(ops.paged_decode_attention, *sets[0])
    exp = call(kpaged.plain, *sets[0])
    torch.cuda.synchronize()
    err = _max_err(out, exp)
    # float32 mode: f32 queries over the bf16 / quantized pool
    err32 = _max_err(call(ops.paged_decode_attention, q.float(), kp, vp, ks, vs),
                     call(kpaged.plain, q.float(), kp, vp, ks, vs))
    # a hot window and the lse (row 0's window is empty: out 0, lse <= -1e30)
    starts = (lengths // 3).to(torch.int32)
    starts[0] = 5
    out_w, lse = call(ops.paged_decode_attention, *sets[0], starts=starts, return_lse=True)
    exp_w, exp_lse = call(kpaged.plain, *sets[0], starts=starts, return_lse=True)
    torch.cuda.synchronize()
    err_w = max(_max_err(out_w, exp_w), _max_err(lse[1:], exp_lse[1:]))
    # NaN in null block 0 and past each row's length inside its last live
    # block is never read: the kernel on that pool equals the plain version
    # on the pool with zeros there
    (kd, ksd), (vd, vsd) = (_poison(p, sc, tables, lengths, bs, nan=True)
                            for p, sc in ((kp, ks), (vp, vs)))
    (kc, ksc), (vc, vsc) = (_poison(p, sc, tables, lengths, bs, nan=False)
                            for p, sc in ((kp, ks), (vp, vs)))
    out_n = call(ops.paged_decode_attention, q, kd, vd, ksd, vsd)
    err_n = (_max_err(out_n, call(kpaged.plain, q, kc, vc, ksc, vsc))
             if bool(torch.isfinite(out_n).all()) else math.inf)
    # every window empty: the cold launch of a step with nothing spilled
    out_e, lse_e = ops.paged_decode_attention(q, kp, vp, tables, torch.zeros_like(lengths),
                                              return_lse=True, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    empty_ok = float(out_e.abs().max()) == 0.0 and float(lse_e.max()) <= -1e30
    print(f"{name} kernel checks: bf16 err {err:.2e}, f32-query err {err32:.2e}, "
          f"window+lse err {err_w:.2e}, empty window lse {float(lse[0].max()):.3e}, "
          f"NaN-garbage err {err_n:.2e}, all windows empty: out 0 and lse "
          f"{float(lse_e.max()):.3e} {'ok' if empty_ok else 'FAILED'}")
    if not (err <= BF16_TOL and err32 <= F32_TOL and err_w <= BF16_TOL and err_n <= BF16_TOL
            and float(out_w[0].abs().max()) == 0.0 and float(lse[0].max()) <= -1e30
            and empty_ok):
        raise AssertionError(f"{name} kernel vs plain: {err}, {err32}, {err_w}, {err_n}, "
                             f"all empty {empty_ok}")

    S = MB * bs
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None, None, :]

    def library(q, kp, vp, ks, vs):
        k = ref.gather_paged_cache(kp, tables)
        v = ref.gather_paged_cache(vp, tables)
        if kv is not None:
            k = ref.kv_dequantize(k, ref.gather_paged_scales(ks, tables))
            v = ref.kv_dequantize(v, ref.gather_paged_scales(vs, tables))
        return F.scaled_dot_product_attention(
            q.view(B, Hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_err = _max_err(library(*sets[0]).view(B, Hkv * G, D), exp)
    live = int(lengths.clamp(max=S).sum())
    scale_bytes = 0 if kv is None else 2 * live * Hkv * 4
    nbytes = (2 * live * Hkv * D * elem + scale_bytes + 2 * q.numel() * 2 + B * 4
              + tables.numel() * 4)
    flops = 4 * live * Hkv * G * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS if kv is None
                                else PEAK_8BIT_OPS)
    return {
        "name": name, "kernel": "paged_decode_attention", "variant": kv or "unscaled",
        "heads": kernel_heads(Hkv, G, D, bs), "route": "cuda", "source": kpaged.SOURCE,
        "replaces": kpaged.REPLACES, "max_abs_err": max(err, err_w), "tol": BF16_TOL,
        "f32_query_max_abs_err": err32,
        **_times([lambda s=s: call(ops.paged_decode_attention, *s) for s in sets],
                 [lambda s=s: call(kpaged.plain, *s) for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        "library": "ref.gather_paged_cache (k, v) + scaled_dot_product_attention"
                   if kv is None else "ref.gather_paged_cache + gather_paged_scales + "
                   "kv_dequantize (k, v) + scaled_dot_product_attention",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} Hkv={Hkv} G={G} D={D} block={bs} MB={MB} N={N} q bf16, pool "
                 f"{kv or 'bf16'} live={live} "
                 f"split={kpaged.plan(MB, bs, B, Hkv, kdec.sm_count(dev))}",
    }


# the two lanes of each cut of the placed pool: (physical blocks, positions
# in a block) of lane 0 and lane 1, of a pool of N blocks of 16
LANE_CUTS = {"block2": lambda N: [((0, N // 2), (0, 16)), ((N // 2, N), (0, 16))],
             "pos2": lambda N: [((0, N), (0, 8)), ((0, N), (8, 16))],
             "whole": lambda N: [((0, N), (0, 16))]}


def lane_phase(dev, kv: str | None, cut: str, host: bool = False) -> dict:
    """The paged kernel with its lse over one lane's shard of llama3.2-1b's
    serve-shape pool (:func:`paged_phase`'s lengths and scrambled tables,
    1026 blocks): ``cut`` "block2", the placed-paged paths' cut (lane 0
    holds blocks 0-512, each row's table compacted by
    ``offload.lane_tables``), or "pos2", the sequence policy's at a block
    count that does not split (positions 0-7 of every block of 16).  With
    ``host`` the pool is the host tier of the placed tiered paths (513
    blocks) and each row's window its cold prefix, the whole blocks below
    half its length: ``cut`` "whole" (the batch policy: every rank holds
    the host tier) or "pos2" (the sequence policy: the positions of every
    host block over the lanes).  The lanes' partials, lse-merged, against
    the whole-pool kernel, and each lane's out and lse against the plain
    version, within BF16_TOL (an empty window's lse <= -1e30 in both).
    The row times lane 0's call (library: its blocks gathered, then SDPA,
    no lse)."""
    Hq, Hkv, D, bs, B, MB = 32, 8, 64, 16, 16, 64
    G, N = Hq // Hkv, (HOST_BLOCKS + 1 if host else 16 * 64 + 2)
    name = _row_name("paged_decode_attention",
                     ",".join(x for x in (f"{'host' if host else 'lane'}-{cut}", kv) if x))
    gen = torch.Generator(device=dev).manual_seed(5)
    lens = [n // 2 // bs * bs for n in LENGTHS] if host else LENGTHS
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(5)) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lens):
        k = min(-(-n // bs), MB)
        tables[b, :k] = perm[used:used + k]
        used += k
    tables = tables.to(dev)
    lanes = [(blocks, pos, *offload.lane_tables(tables, lengths, bs, N, blocks, pos))
             for blocks, pos in LANE_CUTS[cut](N)]
    n_lanes = len(lanes)
    elem = 2 if kv is None else 1
    n_copies = max(1, math.ceil(2 * L2_BYTES / (2 * N * Hkv * bs * D * elem)))
    sets = []
    for _ in range(n_copies):
        q = torch.randn(B, Hq, D, generator=gen, device=dev).bfloat16()
        (kp, ks), (vp, vs) = (_quantize(torch.randn(N, Hkv, bs, D, generator=gen, device=dev),
                                        kv) for _ in range(2))
        shards = [tuple(None if x is None else x[b0:b1, :, p0:p1].contiguous()
                        for x in (kp, vp, ks, vs))
                  for (b0, b1), (p0, p1), _, _ in lanes]
        sets.append((q, kp, vp, ks, vs, shards))

    def lane(fn, q, shard, lane_i, **kw):
        kp, vp, ks, vs = shard
        t, n = lanes[lane_i][2:]
        return fn(q, kp, vp, t, n, k_scale=ks, v_scale=vs, **kw)

    q, kp, vp, ks, vs, shards = sets[0]
    whole = ops.paged_decode_attention(q, kp, vp, tables, lengths, k_scale=ks, v_scale=vs)
    parts = [lane(ops.paged_decode_attention, q, shards[i], i, return_lse=True)
             for i in range(n_lanes)]
    merge_err = _max_err(ref.lse_merge(parts), whole)
    err = 0.0
    for i, (o, lse) in enumerate(parts):
        o_exp, lse_exp = lane(kpaged.plain, q, shards[i], i, return_lse=True)
        live = lse_exp > -1e29
        if not bool((lse[~live] <= -1e29).all()):
            raise AssertionError(f"{name}: lane {i}'s empty windows have a finite lse")
        err = max(err, _max_err(o, o_exp), _max_err(lse[live], lse_exp[live]))
    torch.cuda.synchronize()
    print(f"kernel {name}: lanes' lengths {' / '.join(str(x[3].tolist()) for x in lanes)}; "
          f"{n_lanes} lane(s) lse-merged vs the whole-pool kernel: max err {merge_err:.2e}, "
          f"each lane vs plain {err:.2e} (tol {BF16_TOL})")
    if not (merge_err <= BF16_TOL and err <= BF16_TOL):
        raise AssertionError(f"{name}: merged {merge_err}, lane vs plain {err}")
    t0, n0 = lanes[0][2:]
    bl = LANE_CUTS[cut](N)[0][1][1] - LANE_CUTS[cut](N)[0][1][0]
    S = MB * bl
    mask = (torch.arange(S, device=dev)[None] < n0[:, None])[:, None, None, :]

    def library(q, kp, vp, ks, vs, shards):
        kp, vp, ks, vs = shards[0]
        k, v = ref.gather_paged_cache(kp, t0), ref.gather_paged_cache(vp, t0)
        if kv is not None:
            k = ref.kv_dequantize(k, ref.gather_paged_scales(ks, t0))
            v = ref.kv_dequantize(v, ref.gather_paged_scales(vs, t0))
        return F.scaled_dot_product_attention(
            q.view(B, Hq, 1, D), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    live = int(n0.clamp(max=S).sum())
    nbytes = (2 * live * Hkv * D * elem + (0 if kv is None else 2 * live * Hkv * 4)
              + 2 * q.numel() * 2 + B * 4 + t0.numel() * 4 + B * Hkv * G * 4)
    flops = 4 * live * Hkv * G * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS if kv is None
                                else PEAK_8BIT_OPS)
    return {
        "name": name, "kernel": "paged_decode_attention", "variant": kv or "unscaled",
        "heads": kernel_heads(Hkv, G, D, bl), "route": "cuda", "source": kpaged.SOURCE,
        "replaces": kpaged.REPLACES, "max_abs_err": max(err, merge_err), "tol": BF16_TOL,
        "merged_lanes_err": merge_err,
        **_times([lambda s=s: lane(ops.paged_decode_attention, s[0], s[5][0], 0,
                                   return_lse=True) for s in sets],
                 [lambda s=s: lane(kpaged.plain, s[0], s[5][0], 0, return_lse=True)
                  for s in sets],
                 [lambda s=s: library(*s) for s in sets]),
        "library": "ref.gather_paged_cache (k, v; + gather_paged_scales, kv_dequantize) of "
                   "the lane's blocks + scaled_dot_product_attention (no lse)",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"lane 0 of {cut}{' (host tier, cold windows)' if host else ''}: B={B} "
                 f"Hkv={Hkv} G={G} D={D} block={bl} of 16 MB={MB} blocks {lanes[0][0]} of "
                 f"N={N} q bf16, pool {kv or 'bf16'} live={live}",
    }


# ------------------------------------------------------------ serve phase
def load_cut(args):
    """``serve.load_model(args)`` at ``SERVE_LAYERS``' depth for ``--arch``
    (the same seeded weights for the layers kept)."""
    cfg = serve.load_config(args)
    model = build_model(cfg.with_overrides(n_layers=SERVE_LAYERS.get(args.arch, cfg.n_layers)),
                        args.device)
    return model, model.init(args.seed)


def load_model():
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    t0 = time.perf_counter()
    model, params = serve.load_model(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"serve: {cfg.name} n_params={model.n_params()} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"weights {time.perf_counter() - t0:.1f}s")
    return model, params


def _expected(per_row: dict[str, int], rows: dict[str, dict]):
    """The launches ``per_row`` names per kernel row, summed per kernel
    and variant, and per kernel, variant and head shape: what the launch
    counters must read (rows of one shape, such as a whole prompt and a
    chunk, share a key)."""
    by_variant = {k: {} for k in ops.KERNELS}
    by_shape = {k: {} for k in ops.KERNELS}
    for name, n in per_row.items():
        r = rows[name]
        v, key = by_variant[r["kernel"]], (r["variant"], r["heads"])
        v[r["variant"]] = v.get(r["variant"], 0) + n
        by_shape[r["kernel"]][key] = by_shape[r["kernel"]].get(key, 0) + n
    return by_variant, by_shape


class PathRun(NamedTuple):
    launches: dict[str, int]          # kernel row -> launches in the async run
    stats: object
    tokens: list[list[int]]           # each request's greedy tokens
    wall_s: float
    res: object                       # the async run's serve.ServeResult


def _rate(res) -> str:
    st = res.stats
    return (f"{st.generated / res.wall_s:.1f} tok/s, "
            f"{res.wall_s * 1e3 / st.engine_steps:.3f} ms per engine step")


def graph_summary(eng) -> str:
    """Each dispatch kind's program: calls, graph replays and capture
    time; raises unless every program of a graphs engine was captured."""
    if eng.graphs and any(p.graph is None for p in eng.programs.values()):
        raise AssertionError(f"uncaptured programs: {eng.programs}")
    return ", ".join(f"{k} {p.calls} calls/{p.replays} replays/capture "
                     f"{p.capture_s * 1e3:.1f} ms" for k, p in eng.programs.items())


def serve_phase(model, params, label: str, flags: list[str], want, rows: dict[str, dict],
                tiered: bool = False, base: PathRun | None = None,
                draft=None, min_accept: float = 0.0, eager: bool = False,
                open_loop: bool = False, preempt_ok: bool = False,
                sync: bool = True, rerun_layers: int | None = None) -> PathRun:
    """One path through the serve entry point, every dispatch kind one
    CUDA graph: a short warm-up, the async
    run with every launch counter zeroed before it and read after it,
    then the sync run (``eager``: then the async run with ``--graphs
    off``, whose tokens and launches must be the graph run's); checks
    launches per kernel row (``want(stats)``:
    row name -> launches, summed per kernel and variant and per head shape
    against the counters), completion, a drained pool, sync/async greedy
    identity, (``tiered``) spills without preemption and (``base``: the
    non-speculative run of a superset of these requests) token identity
    with it.  ``draft``: the speculative draft (model, params) instead of
    the serve CLI's default; ``min_accept``: the least acceptance rate.
    ``open_loop``: arrivals over rounds, so sync and async step clocks may
    differ (the async engine frees a finished slot when it observes it, a
    step later, so an arrival or a resubmission is admitted later; the
    reference's engines differ alike) and requests are paired by prompt
    (an agentic turn's prompt grows from its session's earlier output and
    resubmission round); tokens must still be identical, on the tiered
    pool by its criterion, whose first tokens are compared where both
    modes began a request's prefills at the same positions (a prefix read
    from the quantized pool is not bit-equal to one recomputed, and the
    modes' hits differ with their timing): such a path runs traced.
    ``preempt_ok``: a tiered path whose host tier fills may preempt.
    ``sync=False`` skips the sync run (the async run's checks stay).
    ``rerun_layers``: the eager and sync reruns, and the graph run they
    are held to, run the model cut to its first ``rerun_layers`` layers
    (views of the same weights; the target as its own draft cut alike),
    every check kept: an eager step's host time grows with the layers."""
    cfg = model.cfg
    t_phase = time.perf_counter()
    # traced for the prefill chunks' positions; the trace is not written
    if open_loop and tiered:
        flags = flags + ["--trace", str(Path(tempfile.gettempdir()) / "unwritten.json"),
                         "--profile", "0"]
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--async", "on"])
    warm = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--requests", "4"])
    serve.serve(warm, model, params, draft)    # warm-up: cuBLAS handles, allocator

    ops.reset_launch_counts()
    res = serve.serve(args, model, params, draft)      # the path's main run
    launches, shapes = ops.variant_counts(), ops.shape_counts()
    print(f"[{label}] serve {' '.join(flags) or '(dense, decode-only)'}")
    for line in serve.report(args, res):
        print(f"[{label}] {line}")
    st = res.stats
    per_row = {name: n for name, n in want(st).items() if n}
    exp_variant, exp_shape = _expected(per_row, rows)
    print(f"[{label}] preemptions={st.preemptions} victim_drains={st.victim_drains} "
          f"spills={st.spills} rehydrations={st.rehydrations} "
          f"dispatches={dict(res.engine.dispatch_counts)} launches: {launches} expected "
          f"{exp_variant}; by head shape {shapes}")
    if not res.engine.graphs:
        raise AssertionError(f"[{label}] the serve path ran without graphs")
    print(f"[{label}] graphs: {graph_summary(res.engine)}; {_rate(res)}")
    if launches != exp_variant or shapes != exp_shape:
        raise AssertionError(f"[{label}] kernel launches {launches} / {shapes} != expected "
                             f"{exp_variant} / {exp_shape}")
    if args.cache == "paged" and res.engine.pool.in_use:
        raise AssertionError(f"[{label}] pool holds {res.engine.pool.in_use} blocks after "
                             "the run")
    if tiered and not (st.spills >= 1 and (st.preemptions == 0 or preempt_ok)):
        raise AssertionError(f"[{label}] spills={st.spills} preemptions={st.preemptions}: "
                             "the tiered pool should spill, not preempt")
    reqs = res.driver.submitted
    for r in reqs:
        if not (r.done and len(r.out_tokens) == args.max_new
                and all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"[{label}] request {r.uid}: done={r.done} "
                                 f"tokens={len(r.out_tokens)}")
    if args.spec_depth:
        short = sum(x < 1.0 for x in st.spec_accept_samples)
        print(f"[{label}] acceptance rate {st.acceptance_rate:.4f}: "
              f"{len(st.spec_accept_samples)} windows, {short} below 1.0; "
              f"spec_steps={st.spec_steps} decode_steps={st.decode_steps} "
              f"draft_steps={st.draft_steps}")
        if st.spec_steps != st.decode_steps or st.acceptance_rate < min_accept:
            raise AssertionError(f"[{label}] a decode dispatch ran without speculation, "
                                 f"or acceptance under {min_accept}")
    if base is not None:
        differ = [(r.uid, next(i for i, (x, y) in enumerate(zip(r.out_tokens, b)) if x != y))
                  for r, b in zip(reqs, base.tokens) if r.out_tokens != b]
        print(f"[{label}] vs the non-speculative run: {len(reqs) - len(differ)}/{len(reqs)} "
              f"requests token-identical; differing (uid, first position): {differ}")
        if differ:
            raise AssertionError(f"[{label}] speculative greedy tokens differ from the "
                                 "non-speculative run's")

    # the reruns' model and the graph run they are held to
    full = (res, reqs, st, shapes)
    if rerun_layers is not None:
        cut = rerun_layers
        target = model
        model, params = _cut_model(model, params, cut)
        if draft is not None and draft[0] is target:
            draft = (model, params)
        ops.reset_launch_counts()
        res = serve.serve(args, model, params, draft)
        reqs, st, shapes = res.driver.submitted, res.stats, ops.shape_counts()
        print(f"[{label}] reruns at {cut} of {cfg.n_layers} layers: graphs {_rate(res)}")
    if eager:
        eager_args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--graphs", "off"])
        ops.reset_launch_counts()
        ref_run = serve.serve(eager_args, model, params, draft)
        same_eager = [r.out_tokens for r in ref_run.driver.submitted] == [
            r.out_tokens for r in reqs]
        print(f"[{label}] graphs vs eager (async, same call): graphs {_rate(res)}; eager "
              f"{_rate(ref_run)}; greedy tokens identical: {same_eager}; launches equal: "
              f"{ops.shape_counts() == shapes}")
        if not (same_eager and ops.shape_counts() == shapes
                and ref_run.stats.engine_steps == st.engine_steps):
            raise AssertionError(f"[{label}] graph and eager runs differ")
        del ref_run                 # its cache, before the sync run's

    if not sync:
        wall = time.perf_counter() - t_phase
        print(f"[{label}] phase wall {wall:.1f}s (warm-up and async run"
              f"{', eager' if eager else ''}; no sync run)")
        res, reqs, st, _ = full
        return PathRun(per_row, st, [r.out_tokens for r in reqs], wall, res)
    sync_args = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--async", "off"])
    sync = serve.serve(sync_args, model, params, draft)
    for line in serve.report(sync_args, sync):
        print(f"[{label}] {line}")
    print(f"[{label}] sync graphs: {graph_summary(sync.engine)}")
    pairs = list(zip(reqs, sync.driver.submitted))
    if open_loop:
        by_prompt = {r.prompt.tobytes(): r for r in reqs}
        pairs = [(by_prompt[b.prompt.tobytes()], b) for b in sync.driver.submitted
                 if b.prompt.tobytes() in by_prompt]
        if len(pairs) < args.requests:
            raise AssertionError(f"[{label}] only {len(pairs)} sync requests have an async "
                                 "request of the same prompt")
    same = [a.out_tokens == b.out_tokens for a, b in pairs]
    same_clock = sync.stats.engine_steps == st.engine_steps
    print(f"[{label}] sync vs async greedy: {sum(same)}/{len(same)} requests "
          f"token-identical (of {len(reqs)} async, {len(sync.driver.submitted)} sync); "
          f"engine steps async {st.engine_steps}, sync {sync.stats.engine_steps}; rounds "
          f"async {res.rounds}, sync {sync.rounds}")
    if (same_clock or args.spec_depth or (open_loop and not tiered)) and not all(same):
        raise AssertionError(f"[{label}] sync and async greedy tokens differ")
    if not same_clock and open_loop and not tiered:
        print(f"[{label}] step clocks differ (open-loop arrivals admitted a step later "
              "in async mode)")
    elif not same_clock and args.spec_depth:
        # the async engine plans from the one token a window surely
        # commits, so it dispatches windows past a finish that accepted
        # drafts brought forward (masked when observed): more steps, the
        # same tokens, as in the reference
        print(f"[{label}] step clocks differ (async dispatches past early finishes)")
    elif not same_clock:
        # Only with a host tier under pool pressure: the reference's async
        # engine spills before it observes the slots that finish this step
        # (sync frees their blocks first), so its chunks and hot/cold
        # splits land elsewhere and bf16 rounding may flip near-ties.  Hold
        # the runs to the reference's own quantized-pool criterion
        # (tests/test_kv_tiering.py): every first token equal, >= 60% of all.
        tokens = [(x, y) for a, b in pairs for x, y in zip(a.out_tokens, b.out_tokens)]
        agree = sum(x == y for x, y in tokens) / len(tokens)
        print(f"[{label}] step clocks differ (async spills before observing); "
              f"{agree:.1%} of tokens equal")
        first = pairs
        if res.tracer is not None:
            starts = ({}, {})
            for by_uid, run in zip(starts, (res, sync)):
                for sp in run.tracer.spans:
                    if sp.name == "prefill_chunk":
                        by_uid.setdefault(sp.uid, []).append(sp.attrs["pos"])
            first = [(a, b) for a, b in pairs if starts[0][a.uid] == starts[1][b.uid]]
            other = [a.out_tokens[0] == b.out_tokens[0] for a, b in pairs
                     if starts[0][a.uid] != starts[1][b.uid]]
            print(f"[{label}] {len(first)}/{len(pairs)} requests began their prefills at the "
                  f"same positions in both modes; the others' first tokens equal: "
                  f"{sum(other)}/{len(other)}")
        if not (tiered and agree >= 0.6
                and all(a.out_tokens[0] == b.out_tokens[0] for a, b in first)):
            raise AssertionError(f"[{label}] sync and async runs diverge")
    wall = time.perf_counter() - t_phase
    print(f"[{label}] phase wall {wall:.1f}s (warm-up, async and sync runs"
          + (f"; reruns at {rerun_layers} layers)" if rerun_layers is not None else ")"))
    res, reqs, st, _ = full
    return PathRun(per_row, st, [r.out_tokens for r in reqs], wall, res)


def _cut_model(model, params, layers: int):
    """``model`` and ``params`` cut to the first ``layers`` layers: a model
    of that depth on the same device, and views of the same weights."""
    cut = build_model(model.cfg.with_overrides(n_layers=layers), model.device)
    return cut, {**params, "blocks": {k: v[:layers] for k, v in params["blocks"].items()}}


def observatory_phase(model, params) -> None:
    """The paged-hybrid path traced (``--trace`` to a file in the temporary
    directory) and profiled (``--profile 8``: every eighth dispatch fenced
    on the card with ``torch.cuda.synchronize``) against the same run
    untraced, in this call.  The trace must validate and hold one finished,
    well-formed request tree per submitted request; tokens, ``EngineStats``
    and launch counts must equal the untraced run's; no sampled dispatch may
    be one that captured its kind's graph; no sample's measured MFU or MBU
    (against the H100 SXM's peaks) may exceed ``MAX_SHARE``.  Prints, per
    dispatch kind, the samples, median measured ms, MFU, MBU and GB/s, and
    tok/s traced vs untraced."""
    t_phase = time.perf_counter()
    trace = Path(tempfile.gettempdir()) / f"chip_smoke_trace_{os.getpid()}.json"
    runs = {}
    for label, extra in (("untraced", []),
                         ("traced", ["--trace", str(trace), "--profile", str(PROFILE_EVERY)])):
        args = serve.build_parser().parse_args(SERVE_FLAGS + PAGED_FLAGS + extra)
        ops.reset_launch_counts()
        res = serve.serve(args, model, params)
        runs[label] = (res, ops.shape_counts())
        for line in serve.report(args, res) + serve.write_outputs(args, res):
            print(f"[observatory {label}] {line}")
    (plain, plain_counts), (res, counts) = runs["untraced"], runs["traced"]
    obj = json.loads(trace.read_text())
    trace.unlink()
    problems = validate_trace(obj)
    if problems:
        raise AssertionError(f"[observatory] invalid trace: {problems[:5]}")
    trees = build_request_trees(res.tracer)
    uids = {r.uid for r in res.driver.submitted}
    bad = [t.well_formed() for t in trees.values() if not t.finished or t.well_formed()]
    print(f"[observatory] trace: {len(obj['traceEvents'])} events, {len(trees)} request trees "
          f"for {len(uids)} requests, {len(res.tracer.steps)} step records; malformed {bad}")
    if {uid for _, uid in trees} != uids or bad:
        raise AssertionError("[observatory] the trace does not cover every request")
    same = ([r.out_tokens for r in res.driver.submitted]
            == [r.out_tokens for r in plain.driver.submitted])
    print(f"[observatory] traced vs untraced: tokens identical {same}, stats equal "
          f"{res.stats == plain.stats}, launches equal {counts == plain_counts}; "
          f"untraced {_rate(plain)}; traced {_rate(res)}")
    if not (same and res.stats == plain.stats and counts == plain_counts):
        raise AssertionError("[observatory] tracing changed the run")
    eng, samples = res.engine, res.profiler.samples
    captured = set(eng.capture_steps.items())
    ticks = sum(eng.dispatch_counts.values()) - len(captured)
    print(f"[observatory] {len(samples)} sampled dispatches of {ticks} counted; captures "
          f"(kind, step) {sorted(captured)}")
    if {(s.kind, s.step) for s in samples} & captured or len(samples) != ticks // PROFILE_EVERY:
        raise AssertionError("[observatory] a capturing dispatch was sampled, or the "
                             "sampling missed dispatches")
    for kind in sorted({s.kind for s in samples}):
        ss = [s for s in samples if s.kind == kind]
        med = {k: statistics.median(getattr(s, k) for s in ss)
               for k in ("seconds", "measured_mfu", "measured_mbu", "achieved_gbps")}
        top = max(max(s.measured_mfu, s.measured_mbu) for s in ss)
        print(f"[observatory] measured {kind}: {len(ss)} samples, median "
              f"{med['seconds'] * 1e3:.3f} ms, mfu {med['measured_mfu']:.4f}, mbu "
              f"{med['measured_mbu']:.4f}, {med['achieved_gbps']:.1f} GB/s; largest share "
              f"{top:.4f} (device {res.profiler.device.name})")
        if top > MAX_SHARE:
            raise AssertionError(f"[observatory] {kind}: a measured share {top:.4f} > "
                                 f"{MAX_SHARE}")
    print(f"[observatory] phase wall {time.perf_counter() - t_phase:.1f}s")


def agreement(label: str, reqs, base: PathRun, exact: bool = False,
              floor: bool = True) -> None:
    """Token agreement of a full-width path with the single-engine path
    ``base`` of the same workload (requests paired by uid): prints the
    requests and the share of tokens identical; raises under the tiered
    criterion (every first token equal, at least ``TOKEN_FLOOR`` of all
    tokens), or (``exact``) unless every token is identical; ``floor=False``
    only prints.  At bf16 a replica batches other rows than the single engine
    does (and a sub-batch half of them), so its GEMMs may round otherwise
    and a near-tie may flip; a flip changes that request's later tokens."""
    pairs = list(zip([r.out_tokens for r in reqs], base.tokens, strict=True))
    same = sum(a == b for a, b in pairs)
    tokens = [(x, y) for a, b in pairs for x, y in zip(a, b, strict=True)]
    share = sum(x == y for x, y in tokens) / len(tokens)
    first = sum(a[0] == b[0] for a, b in pairs)
    print(f"[{label}] vs the {len(base.res.engine.slots)}-slot "
          f"single-engine path: {same}/{len(pairs)} requests token-identical, {share:.1%} "
          f"of tokens, first tokens equal {first}/{len(pairs)}")
    if exact and same != len(pairs):
        raise AssertionError(f"[{label}] tokens differ from the single-engine path's")
    if floor and (first != len(pairs) or share < TOKEN_FLOOR):
        raise AssertionError(f"[{label}] under the token floor against the single-engine path")


class _Summed:
    """The step-clock fields of a cluster's replicas, summed (what the
    launch counters read over the whole cluster)."""

    def __init__(self, engines):
        for f in ("prefills", "prefill_chunks", "decode_steps", "engine_steps",
                  "migrations_out", "migrations_in"):
            setattr(self, f, sum(getattr(e.stats, f) for e in engines))


def cluster_phase(model, params, label: str, flags: list[str], want, rows: dict[str, dict],
                  base: PathRun, tiered: bool = False) -> PathRun:
    """A two-replica cluster through the serve entry point, every replica's
    dispatch kinds CUDA graphs: a short warm-up, then the async run with
    every launch counter zeroed before it and read after it.  Checks the
    launches per kernel row over both replicas (``want`` of the summed
    step clocks), completion, drained pools, (``tiered``) spills on every
    replica; with a
    role map, that no migration is lost (every export was imported, every
    request finished: one that found no decode replica decoded at home);
    and the token floor against ``base``.  Prints the cluster's lines,
    tokens per round, round-clock TTFT, hit rate, tok/s, per-replica
    graphs and step clocks."""
    t_phase = time.perf_counter()
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags)
    warm = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--requests", "4"])
    serve.serve(warm, model, params)
    ops.reset_launch_counts()
    res = serve.serve(args, model, params)
    launches, shapes = ops.variant_counts(), ops.shape_counts()
    cl, cs = res.cluster, res.stats
    tot = _Summed(cl.engines)
    print(f"[{label}] serve {' '.join(flags)}")
    for line in serve.report(args, res):
        print(f"[{label}] {line}")
    per_row = {name: n for name, n in want(tot).items() if n}
    exp_variant, exp_shape = _expected(per_row, rows)
    print(f"[{label}] launches: {launches} expected {exp_variant}")
    if launches != exp_variant or shapes != exp_shape:
        raise AssertionError(f"[{label}] kernel launches {launches} / {shapes} != expected "
                             f"{exp_variant} / {exp_shape}")
    for i, eng in enumerate(cl.engines):
        st = eng.stats
        print(f"[{label}] r{i}[{eng.role}] {serve.stats_line(cs.replicas[i].routed, st)}; "
              f"spills={st.spills} rehydrations={st.rehydrations} "
              f"preemptions={st.preemptions} migrations out/in={st.migrations_out}/"
              f"{st.migrations_in}; graphs: {graph_summary(eng)}")
        if not eng.graphs:
            raise AssertionError(f"[{label}] replica {i} ran without graphs")
        if args.cache == "paged" and eng.pool.in_use:
            raise AssertionError(f"[{label}] replica {i}'s pool holds {eng.pool.in_use} blocks")
    reqs = res.driver.submitted
    bad = [r.uid for r in reqs if not (r.done and len(r.out_tokens) == args.max_new)]
    if bad:
        raise AssertionError(f"[{label}] requests {bad} did not finish")
    if tiered and not all(e.stats.spills for e in cl.engines):
        raise AssertionError(f"[{label}] a replica's tiered pool never spilled")
    if cl.disaggregated:
        home = sum(1 for r in reqs if cl.placement[r.uid] == 0)
        print(f"[{label}] migrations {cs.migrations} (exported {tot.migrations_out}, imported "
              f"{tot.migrations_in}); {home} requests finished on the prefill replica "
              f"(no decode replica could take them when they were tried)")
        if not (cs.migrations > 0 and tot.migrations_out == tot.migrations_in == cs.migrations
                and cs.migrations + home == len(reqs)):
            raise AssertionError(f"[{label}] a migration was lost")
    print(f"[{label}] rounds {cs.rounds}, {cs.tokens_per_round:.3f} tokens per round, "
          f"ttft_rounds mean {cs.mean_ttft_rounds:.2f} p99 {cs.ttft_rounds_percentile(99):.0f}, "
          f"prefix hit rate {cs.prefix_hit_rate:.4f}, imbalance {cs.load_imbalance:.3f}; "
          f"{cs.generated / res.wall_s:.1f} tok/s, {res.wall_s * 1e3 / cs.rounds:.3f} ms per "
          f"round, {res.wall_s * 1e3 / tot.engine_steps:.3f} ms per engine step")
    agreement(label, reqs, base)
    wall = time.perf_counter() - t_phase
    print(f"[{label}] phase wall {wall:.1f}s (warm-up and async run)")
    return PathRun(per_row, cs, [r.out_tokens for r in reqs], wall, res)


# ----------------------------------------------------- placed paths (slice 17)
def teacher_forced(model, params, prompts, n_sub: int = 1, keep_cache: bool = False):
    """One decode step's logits (B, V) f32 after each prompt is prefilled
    into its slot of a fresh cache as the engine admits it (a slot's
    view), each row fed its prompt's last token: fixed inputs, so a placed
    model and the one-rank model can be held to each other.  The cache is
    in the model's dtype: a float32 model's is f32 too, since one bf16 ulp
    anywhere in the cache moves every argmax of the random model at full
    depth (``kvq_sensitivity``); a ``kv_quant`` model's is int8.  ``n_sub``
    runs the step as that many sub-batches (``core.pipeline``, in order);
    ``keep_cache`` also returns the cache."""
    cache = model.init_cache(len(prompts), 1024, dtype=cm.param_dtype(model.cfg))
    for i, p in enumerate(prompts):
        model.prefill(params, torch.as_tensor(p, dtype=torch.int64, device=model.device)[None],
                      kv_cache.slot_view(cache, i))
    feed = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32, device=model.device)
    logits = sub_batching.pipelined_step(model.decode_step, n_sub)(params, cache, feed)[0]
    return (logits.float(), cache) if keep_cache else logits.float()


@contextlib.contextmanager
def tp_rounding(cfg, n: int = PLACED_RANKS):
    """While open, a one-rank dense model rounds its row-parallel products
    (``wo``, ``w_down``) as ``n`` tensor-parallel ranks do: ``n`` partial
    products over consecutive slices of the contracted dim, each rounded
    to the model's dtype, then summed in that dtype (the all-reduce).  For
    bf16 that is one more rounding per product than one rank makes."""
    plain = cm.linear

    def linear(x, w, n_in=1):
        if not (n_in == 2 or w.shape[0] == cfg.d_ff):     # wo (H, Dh, D), w_down (F, D)
            return plain(x, w, n_in)
        k = math.prod(w.shape[:n_in])
        lead = x.shape[: x.dim() - n_in]
        xs, ws = x.reshape(*lead, k), w.reshape(k, -1)
        out = functools.reduce(torch.add, [xs[..., i * k // n:(i + 1) * k // n]
                                           @ ws[i * k // n:(i + 1) * k // n] for i in range(n)])
        return out.reshape(*lead, *w.shape[n_in:])

    cm.linear = linear
    try:
        yield
    finally:
        cm.linear = plain


@contextlib.contextmanager
def counting_collectives():
    """While open, count the collectives the placed model calls
    (``distributed.collectives``' all-reduces and gathers over a group of
    more than one rank), by name."""
    counts = collections.Counter()
    saved = {n: getattr(collectives, n) for n in ("all_reduce", "all_reduce_max",
                                                  "gather_stack")}

    def counted(n, f):
        def call(x, group, *a, **kw):
            counts[n] += group is not None
            return f(x, group, *a, **kw)
        return call

    for n, f in saved.items():
        setattr(collectives, n, counted(n, f))
    try:
        yield counts
    finally:
        for n, f in saved.items():
            setattr(collectives, n, f)


@contextlib.contextmanager
def forbid_plain_serving():
    """While open, every plain attention a serving step could route to
    raises: a placed path on the card must run the kernels only."""
    def refuse(*a, **kw):
        raise AssertionError("a plain attention ran on the card's placed serve path")

    names = [(attn_mod, "chunked_attention"), (attn_mod, "decode_attention"),
             (ref, "paged_decode_attention"), (ref, "naive_decode_attention"),
             (kpaged, "plain"), (kpre, "plain"), (kdec, "plain")]
    saved = [getattr(m, n) for m, n in names]
    for m, n in names:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)


def _placed_run(args, env, mesh, label: str, out: Path, warm_up: bool = False,
                teacher: bool = False, layers: int | None = None) -> dict:
    """One placed path on this rank, through the serve entry points: the
    load (each rank keeps its shards: checked by their bytes), a warm-up
    (the process's first path: cuBLAS handles, the allocator), then the
    run with every launch counter zeroed before it and read after it and
    every plain attention refused (:func:`forbid_plain_serving`), and one
    more decode step of the served model on its cache with its collectives
    counted; rank 0 keeps the run's prompts and, with ``teacher``, the
    served model's teacher-forced step over them (``{label}-bfloat16.pt``).
    ``layers`` cuts the served model to that depth (the same seeded weights
    for the layers kept)."""
    t0 = time.perf_counter()
    if layers is None:
        model, params = serve.load_model(args, env, mesh)
    else:
        model = build_model(serve.load_config(args).with_overrides(n_layers=layers),
                            args.device, env, mesh)
        params = model.init(args.seed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    specs = model.param_specs()
    held = sum(t.numel() * t.element_size() for t in leaves(params))
    want = 0
    for path, defn in cm._leaves(model.param_defs):
        spec = functools.reduce(lambda t, k: t[k], path, specs)
        want += math.prod(model.placement.local_shape(spec, defn.shape)) * 2
    if warm_up:
        warm = serve.build_parser().parse_args(SERVE_FLAGS + PLACED_FLAGS + ["--requests", "4"])
        warm.device = args.device
        serve.serve(warm, model, params)
    ops.reset_launch_counts()
    with forbid_plain_serving():
        res = serve.serve(args, model, params)
    shapes = {k: {f"{v}|{h}": n for (v, h), n in d.items()}
              for k, d in ops.shape_counts().items() if d}
    reqs = res.driver.submitted
    paged = args.cache == "paged"
    feed = torch.zeros(args.slots, dtype=torch.int32, device=model.device)
    with counting_collectives() as step_collectives:
        (model.paged_decode_step if paged else model.decode_step)(params, res.engine.cache, feed)
    row = {"load_s": load_s, "param_bytes": held, "shard_bytes": want,
           "full_bytes": model.n_params() * 2, "wall_s": res.wall_s,
           "graphs": res.engine.graphs, "stats": dataclasses.asdict(res.stats),
           "tokens": [r.out_tokens for r in reqs], "launches": shapes,
           "lines": serve.report(args, res), "axes": dict(env.axes), "policy": env.kv_policy,
           "step_collectives": dict(step_collectives),
           "pool": dataclasses.asdict(res.engine.pool.stats) if paged else None,
           "pool_shard_bytes": (sum(t.numel() * t.element_size()
                                    for t in res.engine.cache.values()) if paged else None)}
    prompts = [np.asarray(r.prompt) for r in reqs]
    logits = teacher_forced(model, params, prompts) if teacher else None
    if dist.get_rank() == 0:
        (out / "prompts").mkdir(exist_ok=True)
        torch.save(prompts, out / "prompts" / f"{label}.pt")
        if teacher:
            torch.save(logits.cpu(), out / f"{label}-bfloat16.pt")
    del model, params, res
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _staged_prompts(model, params, cache, prompts, per_row: int):
    """Each prompt prefilled as decode-only admission does: a staging
    cache, its blocks handed to the pool by ``write_prompt_block`` at
    physical blocks scattered over the pool by a seeded permutation (so
    that a row's blocks lie on every lane).  Yields, prompt by prompt,
    ``(row, prompt length, its blocks (the prompt's and the fed
    token's), per_row x that many scattered ids, the first ones written,
    and the staging cache)``."""
    bs = pdev._block_size(cache)
    dt = cm.param_dtype(model.cfg)
    n_blocks = cache.n_blocks if isinstance(cache, offload.ShardedPool) else cache["k"].shape[1]
    perm = (torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(9)) + 1).tolist()
    used = 0
    for i, p in enumerate(prompts):
        n = len(p)
        nb = -(-(n + 1) // bs)
        sub = model.init_cache(1, nb * bs, dtype=dt, staging=True)
        model.prefill(params, torch.as_tensor(p, dtype=torch.int64, device=model.device)[None],
                      sub)
        ids = perm[used:used + per_row * nb]
        used += per_row * nb
        for j in range(-(-n // bs)):
            pdev.write_prompt_block(cache, sub, ids[j], j * bs)
        yield i, n, nb, ids, sub


def teacher_forced_paged(model, params, prompts, kv: str,
                         n_blocks: int = PLACED_TEACHER_BLOCKS) -> tuple[torch.Tensor, float]:
    """:func:`teacher_forced` through the paged pool: the prompts staged
    (:func:`_staged_prompts`), each block copied on write
    (``copy_block``) to another scattered block, which the row's table
    names, and read back from there into a second staging cache as a
    prefix hit does (``read_block``); then one paged decode step over the
    copies, each row fed its prompt's last token.  Staging and a bf16 pool
    in the model's dtype.  Returns the step's logits and the largest
    difference between a block read back and what was written (through
    the pool's quantization): 0 when the copies and reads move every
    byte."""
    bs, mb = 16, 64
    dt = cm.param_dtype(model.cfg)
    quant = None if kv == "bf16" else kv
    cache = model.init_paged_cache(len(prompts), n_blocks, bs, mb, dtype=dt, kv_dtype=kv)
    err = 0.0
    for i, n, nb, ids, sub in _staged_prompts(model, params, cache, prompts, 2):
        back = model.init_cache(1, nb * bs, dtype=dt, staging=True)
        w = -(-n // bs)
        for j in range(w):
            pdev.copy_block(cache, ids[j], ids[nb + j])
            pdev.read_block(back, cache, ids[nb + j], j * bs)
        for key in ("k", "v"):
            x = sub[key][:, 0, :w * bs]
            if quant:
                x = ref.kv_dequantize(*ref.kv_quantize(x, quant), dt)
            err = max(err, float((back[key][:, 0, :w * bs] - x).abs().max()))
        row = np.zeros(mb, np.int32)
        row[:nb] = ids[nb:]
        pdev.sync_slot(cache, i, row, n)
    feed = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32, device=model.device)
    return model.paged_decode_step(params, cache, feed)[0].float(), err


def _held_piece(cache, idx: int, host: bool = False) -> tuple | None:
    """This rank's raw shard of device block ``idx`` (of host-tier block
    ``idx``: ``host``) as the rank holds it, copied: ``(heads, positions,
    leaves as bytes)``, None where another lane holds the block.  Read
    from the pool's leaves directly, by the ranges the rank holds (none of
    the pool's own moves)."""
    keys, pre = pdev._pool_keys(cache), "host_" if host else ""
    k = cache[pre + "k"]
    if not isinstance(cache, offload.ShardedPool):
        heads, pos, (b0, b1) = (0, k.shape[2]), (0, k.shape[3]), (0, k.shape[1])
    else:
        heads, pos = cache.heads, cache.host_pos if host else cache.pos
        b0, b1 = (0, k.shape[1]) if host else cache.blocks
    if not b0 <= idx < b1:
        return None
    return heads, pos, [ref.byte_view(cache[pre + key][:, idx - b0]).clone() for key in keys]


def _assembled(pieces: list[tuple], n_kv: int, bs: int) -> tuple[list[torch.Tensor], bool]:
    """A block whole from its ranks' ``pieces`` (:func:`_held_piece`), and
    whether they cover every (head, position) of it."""
    covered = torch.zeros(n_kv, bs, dtype=torch.bool)
    whole = [torch.zeros((x.shape[0], n_kv, bs, *x.shape[3:]), dtype=x.dtype)
             for x in pieces[0][2]]
    for (h0, h1), (p0, p1), leaves in pieces:
        covered[h0:h1, p0:p1] = True
        for w, x in zip(whole, leaves):
            w[:, h0:h1, p0:p1] = x
    return whole, bool(covered.all())


def _spill_differs(n_kv: int, bs: int, dev: list[tuple], host: list[tuple]) -> bool:
    """Whether a spill's host-tier pieces ``host`` (read after it) differ
    in any byte from the device block whose pieces ``dev`` were read
    before it, or leave some of the block out: every rank's piece is held
    to the device block's same heads and positions."""
    whole, full = _assembled(dev, n_kv, bs)
    return not (full and _assembled(host, n_kv, bs)[1] and all(
        torch.equal(w[:, h0:h1, p0:p1], x)
        for (h0, h1), (p0, p1), leaves in host for w, x in zip(whole, leaves)))


@contextlib.contextmanager
def checked_spills():
    """While open, every spill (``serving.paged.device.spill_block``, as the
    engine applies a spill directive) keeps this rank's raw shard of the
    device block from before it and of the host-tier block after it
    (:func:`_held_piece`); on closing, every rank's shards are gathered in
    one plain ``all_gather_object`` (on a placed pool) and each host copy
    is held to its device block (:func:`_spill_differs`): the counts of
    spills and of blocks whose host copy differs in any byte."""
    saved = pdev.spill_block
    counts = {"spills": 0, "differ": 0}
    taken = []
    me = dist.get_rank() if dist.is_initialized() else 0

    def spill(cache, dev, host):
        before = _held_piece(cache, dev)
        saved(cache, dev, host)
        placed = isinstance(cache, offload.ShardedPool)
        # the pool's owner (its mesh's first rank): a cluster's replicas
        # spill on their own meshes
        taken.append((cache.place.mesh.ranks[0] if placed else me,
                      (cache.n_kv, cache.block_size) if placed else tuple(cache["k"].shape[2:4]),
                      before, _held_piece(cache, host, host=True)))
        return cache

    pdev.spill_block = spill
    try:
        yield counts
    finally:
        pdev.spill_block = saved
    mine = [(owner, dims, *[None if x is None else (x[0], x[1], [t.cpu() for t in x[2]])
                            for x in pair]) for owner, dims, *pair in taken]
    ranks = [mine]
    if dist.is_initialized() and dist.get_world_size() > 1:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
    for owner in sorted({t[0] for r in ranks for t in r}):
        lists = [[t for t in r if t[0] == owner] for r in ranks]
        lists = [x for x in lists if x]
        for i in range(len(lists[0])):
            dev, host = ([x[i][j] for x in lists if x[i][j] is not None] for j in (2, 3))
            counts["differ"] += _spill_differs(*lists[0][i][1], dev, host)
    counts["spills"] = len(taken)


def pool_whole(cache) -> dict[str, torch.Tensor] | None:
    """Every leaf of a placed pool and of its host tier whole, on rank 0
    (None on the others): each rank's shards, raw, through a plain
    ``all_gather_object``, put in place by the blocks, heads and positions
    the rank holds."""
    keys = pdev._pool_keys(cache)
    mine = {}
    for key in keys:
        mine[key] = (cache.blocks, cache.pos, ref.byte_view(cache[key]).cpu())
        mine["host_" + key] = ((0, cache.n_host), cache.host_pos,
                               ref.byte_view(cache["host_" + key]).cpu())
    shards = [None] * dist.get_world_size()
    dist.all_gather_object(shards, (cache.heads, mine))
    if dist.get_rank():
        return None
    whole = {}
    for key, (_, _, x) in mine.items():
        n = cache.n_blocks if key in keys else cache.n_host
        whole[key] = torch.zeros((x.shape[0], n, cache.n_kv, cache.block_size, *x.shape[4:]),
                                 dtype=x.dtype)
    for (h0, h1), leaves in shards:
        for key, ((b0, b1), (p0, p1), x) in leaves.items():
            whole[key][:, b0:b1, h0:h1, p0:p1] = x
    return whole


@contextlib.contextmanager
def attending_over(cache, whole: dict[str, torch.Tensor]):
    """While open, every paged attention call of a one-rank step over
    ``cache`` reads ``whole``'s bytes (:func:`pool_whole` of a placed run
    of the same step, or some of its leaves): each pool layer it is given
    is overwritten by that layer of ``whole`` just before the call, after the step's own append,
    so the step attends over the placed run's K/V and scales exactly."""
    plain = offload.paged_decode_attention
    keys = pdev._pool_keys(cache)
    layers = {cache[key][l].data_ptr(): (key, l) for key in keys + tuple(f"host_{k}" for k in keys)
              for l in range(cache[key].shape[0])}

    def attend(q, k_pool, v_pool, *a, **kw):
        for x in (k_pool, v_pool, kw.get("k_scale"), kw.get("v_scale")):
            if x is not None:
                key, l = layers[x.data_ptr()]
                if key in whole:
                    ref.byte_view(x).copy_(whole[key][l])
        return plain(q, k_pool, v_pool, *a, **kw)

    offload.paged_decode_attention = attend
    try:
        yield
    finally:
        offload.paged_decode_attention = plain


def teacher_forced_tiered(model, params, prompts, kv: str, n_blocks: int = PLACED_TEACHER_BLOCKS,
                          over: dict[str, torch.Tensor] | None = None):
    """:func:`teacher_forced` through the tiered pool: the prompts staged
    (:func:`_staged_prompts`), then the first half of each one's full
    blocks spilled (:func:`checked_spills`) to host-tier blocks scattered
    by a seeded permutation, their table columns set to the null block
    and the cold length to their positions, as a spill leaves a row; then
    one paged decode step (the hot and the cold windows merged), each row
    fed its prompt's last token; with ``over`` (one rank) the step attends
    over those pool bytes (:func:`attending_over`).  Returns the step's
    logits, the count of spilled blocks whose host copy differs from the
    device block in any byte, and the pool."""
    bs, mb = 16, 64
    dt = cm.param_dtype(model.cfg)
    cache = model.init_paged_cache(len(prompts), n_blocks, bs, mb, dtype=dt, kv_dtype=kv,
                                   host_blocks=HOST_BLOCKS)
    hperm = (torch.randperm(HOST_BLOCKS, generator=torch.Generator().manual_seed(10))
             + 1).tolist()
    hused = 0
    with checked_spills() as spills:
        for i, n, nb, ids, _ in _staged_prompts(model, params, cache, prompts, 1):
            row, host_row = np.zeros(mb, np.int32), np.zeros(mb, np.int32)
            row[:nb] = ids
            n_cold = n // bs // 2
            for j in range(n_cold):
                pdev.spill_block(cache, ids[j], hperm[hused])
                row[j], host_row[j] = 0, hperm[hused]
                hused += 1
            pdev.sync_slot(cache, i, row, n)
            pdev.sync_host_slot(cache, i, host_row, n_cold * bs)
    feed = torch.tensor([int(p[-1]) for p in prompts], dtype=torch.int32, device=model.device)
    over = None if over is None else {k: v.to(model.device) for k, v in over.items()}
    with attending_over(cache, over) if over else contextlib.nullcontext():
        logits = model.paged_decode_step(params, cache, feed)[0].float()
    return logits, spills["differ"], cache


def placed_slice20_worker(out: Path, got: dict) -> None:
    """The slice-20 paths on this rank, after the paged ones: placed-tiered-dp
    (data 2, the serve CLI's placement: the pool's blocks over ``data``, an
    fp8 pool, the host tier whole on each rank) and placed-tiered-seq
    (model 2, the sequence policy: the blocks over ``model``, an int8
    pool, the host tier's positions split), every spill read back whole
    (:func:`checked_spills`); placed-spec (data 2, the dense cache, the
    draft placed on the same mesh) and placed-sub-batches (data 2, two
    sub-batches); then in float32 at PLACED_CHECK_LAYERS the tiered
    paths' teacher-forced step (:func:`teacher_forced_tiered`), the
    sub-batches' and the int8 dense cache's on data 2 and model 2
    (``{label}-float32.pt``; the data-2 ranks' int8 payload and scales
    beside them).  ``got["phase_s"]`` takes each path's seconds."""
    rank = dist.get_rank()
    phase_s = got.setdefault("phase_s", {})
    runs = {}
    for label, ((d, m), policy, kv, _, _) in PLACED_TIERED.items():
        t0 = time.perf_counter()
        args = serve.build_parser().parse_args(
            SERVE_FLAGS + PLACED_FLAGS + PLACED_TIERED_FLAGS + ["--kv-dtype", kv])
        mesh, env = _placed_mesh(args, m, policy)
        with checked_spills() as spills:
            got[label] = _placed_run(args, env, mesh, label, out, layers=PLACED_LAYERS)
        got[label]["spill_check"] = dict(spills)
        runs[label] = (args, mesh, env, kv)
        phase_s[label] = time.perf_counter() - t0
    for label, flags in (("placed-spec", PLACED_SPEC_FLAGS),
                         ("placed-sub-batches", SUB_BATCH_FLAGS)):
        t0 = time.perf_counter()
        args = serve.build_parser().parse_args(SERVE_FLAGS + PLACED_FLAGS + flags)
        mesh, env = _placed_mesh(args, 1, None)
        got[label] = _placed_run(args, env, mesh, label, out)
        phase_s[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prompts = torch.load(out / "prompts" / "placed-tiered-dp.pt", weights_only=False)
    base = serve.load_config(args).with_overrides(dtype="float32", n_layers=PLACED_CHECK_LAYERS)
    for label, (args, mesh, env, kv) in runs.items():
        model = build_model(base, args.device, env, mesh)
        params = model.init(args.seed)
        got[label]["teacher_differ"] = 0
        for name, pool_kv in _tiered_steps(label, kv):
            logits, differ, cache = teacher_forced_tiered(model, params, prompts, pool_kv)
            got[label]["teacher_differ"] += differ
            whole = pool_whole(cache)
            if rank == 0:
                torch.save(logits.cpu(), out / f"{name}-float32.pt")
                torch.save(whole, out / f"{name}-pool.pt")
            del cache, whole
        del model, params
    mesh, env = _placed_mesh(args, 1, None)
    model = build_model(base, args.device, env, mesh)
    logits = teacher_forced(model, model.init(args.seed), prompts, n_sub=2)
    if rank == 0:
        torch.save(logits.cpu(), out / "placed-sub-batches-float32.pt")
    for label, ((d, m), policy, _) in PLACED_KVQ.items():
        mesh, env = _placed_mesh(args, m, policy)
        model = build_model(base.with_overrides(kv_quant=True), args.device, env, mesh)
        logits, cache = teacher_forced(model, model.init(args.seed), prompts, keep_cache=True)
        if rank == 0:
            torch.save(logits.cpu(), out / f"{label}-float32.pt")
        if m == 1:
            torch.save({"rows": cache.rows, **{k: v.cpu() for k, v in cache.items()}},
                       out / f"{label}-cache-rank{rank}.pt")
        del model, cache
    phase_s["placed-f32-checks"] = time.perf_counter() - t0


def _tiered_steps(label: str, kv: str) -> list[tuple[str, str]]:
    """The teacher-forced tiered steps of a placed-tiered path, ``(name,
    pool dtype)``: its own pool's, and on an int8 pool the same mesh's
    with an fp8 pool beside it."""
    return [(label, kv)] + ([(f"{label}-fp8", "fp8")] if kv == "int8" else [])


def _placed_mesh(args, model_parallel: int, policy: str | None):
    """The mesh and Env of a placed path on this rank: with ``model_parallel``
    1 the serve CLI's own placement (the world as a (data 2, model 1) mesh,
    the balancer's policy: ``policy`` None), else a (data 1, model 2) mesh
    under ``policy``.  Sets ``args.device`` to this rank's card."""
    args.device = None                   # the serve CLI's default: this rank's card
    if model_parallel == 1 and policy in (None, "batch"):
        mesh, env, _ = serve.place(args, serve.load_config(args))
        return mesh, env
    args.device = str(rank_device(None))
    mesh = make_host_mesh(model_parallel, device=args.device)
    return mesh, Env(axes=mesh_axes(mesh), kv_policy=policy)


def placed_paged_worker(out: Path, got: dict) -> None:
    """placed-paged-dp through the serve CLI's own placement (the world as
    a (data 2, model 1) mesh, the balancer's policy: the pool's blocks over
    ``data``), then placed-paged-seq on a (data 1, model 2) mesh (the
    sequence policy: the blocks over ``model``, an fp8 pool); then each
    one's teacher-forced paged step in float32 at PLACED_CHECK_LAYERS
    (``{label}-float32.pt``; its blocks copied and read back across the
    lanes: ``read_err``), on one set of f32 shards."""
    runs = {}
    for label, ((d, m), policy, kv, _) in PLACED_PAGED.items():
        args = serve.build_parser().parse_args(
            SERVE_FLAGS + PLACED_FLAGS + PLACED_PAGED_FLAGS + ["--kv-dtype", kv])
        mesh, env = _placed_mesh(args, m, policy)
        got[label] = _placed_run(args, env, mesh, label, out, layers=PLACED_LAYERS)
        runs[label] = (args, mesh, env, kv)
    prompts = torch.load(out / "prompts" / "placed-paged-dp.pt", weights_only=False)
    for label, (args, mesh, env, kv) in runs.items():
        cfg = serve.load_config(args).with_overrides(dtype="float32",
                                                     n_layers=PLACED_CHECK_LAYERS)
        model = build_model(cfg, args.device, env, mesh)
        logits, got[label]["read_err"] = teacher_forced_paged(model, model.init(args.seed),
                                                              prompts, kv)
        if dist.get_rank() == 0:
            torch.save(logits.cpu(), out / f"{label}-float32.pt")
        del model


def placed_worker(out: Path) -> None:
    """A rank of the placed paths (``chip_smoke.py --placed-worker DIR``,
    started by :func:`placed_phase` as torchrun starts one): placed-dp
    through the serve CLI's own placement (the launcher's world as a
    (data 2, model 1) mesh, the balancer's policy), then placed-head and
    placed-seq on a (data 1, model 2) mesh, then the paged pool's paths
    (:func:`placed_paged_worker`); writes ``rank{r}.json``."""
    args = serve.build_parser().parse_args(SERVE_FLAGS + PLACED_FLAGS)
    args.device = None                   # the serve CLI's default: this rank's card
    mesh, env, line = serve.place(args, serve.load_config(args))
    rank = dist.get_rank()
    got = {"balancer": line, "backend": dist.get_backend(), "device": args.device}
    t0 = time.perf_counter()
    _placed_dense_worker(args, mesh, env, out, got)
    t1 = time.perf_counter()
    placed_paged_worker(out, got)
    t2 = time.perf_counter()
    placed_slice20_worker(out, got)
    got["phase_s"].update({"placed-dense (dp, head, seq)": t1 - t0,
                           "placed-paged (dp, seq)": t2 - t1})
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _placed_dense_worker(args, mesh, env, out: Path, got: dict) -> None:
    """The dense cache's placed paths (slice 17) on this rank."""
    rank = dist.get_rank()
    got["placed-dp"] = _placed_run(args, env, mesh, "placed-dp", out, warm_up=True)
    mesh = make_host_mesh(2, device=args.device)
    envs = {"placed-head": Env(axes=mesh_axes(mesh), kv_policy="head"),
            "placed-seq": Env(axes=mesh_axes(mesh), kv_policy="sequence")}
    for label, env in envs.items():
        got[label] = _placed_run(args, env, mesh, label, out, teacher=True,
                                 layers=PLACED_LAYERS)
    # the teacher-forced step in float32 (f32 weights, activations and
    # cache) at PLACED_CHECK_LAYERS: both policies on one set of f32 shards
    # (the weights' split does not depend on the KV policy)
    prompts = torch.load(out / "prompts" / "placed-dp.pt", weights_only=False)
    cfg = serve.load_config(args).with_overrides(dtype="float32",
                                                 n_layers=PLACED_CHECK_LAYERS)
    params = None
    for label, env in envs.items():
        model = build_model(cfg, args.device, env, mesh)
        params = params or model.init(args.seed)
        logits = teacher_forced(model, params, prompts)
        if rank == 0:
            torch.save(logits.cpu(), out / f"{label}-float32.pt")
    del model, params


def _spawn_ranks(out: Path, worker: str = "--placed-worker",
                 timeout: float = PLACED_TIMEOUT, n_ranks: int = PLACED_RANKS) -> None:
    """Start ``n_ranks`` processes of this script (``worker``'s role) as
    ``torchrun`` would (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, a
    rendezvous on a free localhost port) and wait for them, killing every
    one of them on a failure or at ``timeout``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    logs = [out / f"rank{r}.log" for r in range(n_ranks)]
    procs = []
    try:
        for r in range(n_ranks):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), worker, str(out)],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        for r, log in enumerate(logs):
            print(f"[{worker}] rank {r} exit {procs[r].returncode}, log tail:\n"
                  f"{log.read_text()[-4000:]}")
        raise AssertionError(f"[{worker}] a rank failed or timed out")


def placed_phase(model, params, by_path: dict[str, PathRun]) -> dict[str, PathRun]:
    """The placed paths of llama3.2-1b at full width: two ranks over gloo on
    the one card, eagerly (gloo collectives cannot be captured in a CUDA
    graph), every plain attention refused: the first 16 requests of the
    serve workload on the dense cache (:func:`_placed_dense_checks`:
    placed-dp, placed-head and placed-seq), then rag's 16 on the paged
    pool with the hybrid schedule (:func:`_placed_paged_checks`:
    placed-paged-dp and placed-paged-seq), held to one-rank runs at the
    same flags, made here first.  Every rank holds the same tokens and
    ``EngineStats``; each kernel launched once per layer of every prefill
    (chunk) and decode step at its shard's heads."""
    t0 = time.perf_counter()
    cfg = model.cfg
    line = serve.place(serve.build_parser().parse_args(SERVE_FLAGS + PLACED_FLAGS), cfg)[2]
    print(f"[placed] one rank: {line}")
    if line != BALANCER[1]:
        raise AssertionError(f"[placed] balancer line {line!r} != {BALANCER[1]!r}")
    one = placed_paged_baselines(model, params)
    out = Path(tempfile.mkdtemp(prefix="placed-"))
    try:
        _spawn_ranks(out)
        got = [json.loads((out / f"rank{r}.json").read_text()) for r in range(PLACED_RANKS)]
        logits = {tuple(f.stem.rsplit("-", 1)): torch.load(f) for f in out.glob("*-*.pt")
                  if "-cache-" not in f.stem and not f.stem.endswith("-pool")}
        pools = {f.stem.removesuffix("-pool"): torch.load(f) for f in out.glob("*-pool.pt")}
        kvq_caches = [torch.load(out / f"placed-kvq-dp-cache-rank{r}.pt")
                      for r in range(PLACED_RANKS)]
        prompts = {f.stem: torch.load(f, weights_only=False)
                   for f in (out / "prompts").glob("*.pt")}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    g0 = got[0]
    print(f"[placed] {PLACED_RANKS} ranks on one card, backend {g0['backend']}: {g0['balancer']}")
    if g0["backend"] != "gloo" or g0["balancer"] != BALANCER[2]:
        raise AssertionError(f"[placed] backend {g0['backend']}, line {g0['balancer']!r}")
    print("[placed] seconds per path on the ranks (rank 0): " + ", ".join(
        f"{k} {v:.1f}" for k, v in g0["phase_s"].items()))
    runs = _placed_dense_checks(model, params, by_path, got, logits, prompts["placed-dp"], one)
    runs.update(_placed_paged_checks(model, got, logits, prompts["placed-paged-dp"], one))
    runs.update(_placed_slice20_checks(model, got, logits, pools, prompts["placed-tiered-dp"],
                                       one, runs["placed-dp"], kvq_caches))
    print(f"[placed] phase wall {time.perf_counter() - t0:.1f}s")
    return runs


def _placed_dense_checks(model, params, by_path: dict[str, PathRun], got: list[dict],
                         logits: dict, prompts, one: dict[str, dict]) -> dict[str, PathRun]:
    """placed-dp (mesh data 2, the batch policy: each rank decodes 8 rows)
    must give dense-8's tokens exactly; placed-head and placed-seq (mesh
    model 2: the tensor-parallel model, the KV heads or the positions
    split) must give a teacher-forced decode step's logits in float32 (an
    f32 cache too) at PLACED_CHECK_LAYERS within PLACED_LOGIT_TOL of the
    one-rank model's (at full depth the random model turns any rounding
    difference into whole logits: ``scripts/torch_placed_depth.py``) and
    in bf16 at full depth those of the one-rank model rounding as two
    ranks do (:func:`placed_logit_check`); their token agreement with
    one rank at their depth (``one["placed-dense"]``) is printed."""
    # per path: the decode kernel's variant and KV heads per rank, its row
    # (the prefill runs at the compute side's heads: 8 on data 2, 4 on model
    # 2), the served depth (placed-head and -seq at PLACED_LAYERS since slice
    # 20, held to one rank at that depth: placed_one_rank)
    paths = {"placed-dp": ("unscaled", 8, 8, "decode_attention", model.cfg.n_layers),
             "placed-head": ("unscaled", 4, 4, "decode_attention[shard-head2]", PLACED_LAYERS),
             "placed-seq": ("lse", 8, 4, "decode_attention[shard-seq2]", PLACED_LAYERS)}
    runs = {}
    for label, (variant, hkv, hkv_pre, row, L) in paths.items():
        rs = [g[label] for g in got]
        r0 = rs[0]
        st = EngineStats(**r0["stats"])
        for line in r0["lines"]:
            print(f"[{label}] {line}")
        want = {"decode_attention": {f"{variant}|{kernel_heads(hkv, 4, 64)}": st.decode_steps * L},
                "prefill_attention": {f"unscaled|{kernel_heads(hkv_pre, 4, 64)}": st.prefills * L}}
        print(f"[{label}] mesh {r0['axes']} policy {r0['policy']}; load {r0['load_s']:.1f}s, "
              f"{r0['param_bytes'] / 1e9:.3f} GB of weights held per rank (shard "
              f"{r0['shard_bytes'] / 1e9:.3f}, whole {r0['full_bytes'] / 1e9:.3f}); "
              f"launches per rank {r0['launches']} expected {want}; wall {r0['wall_s']:.2f}s "
              f"-> {st.generated / r0['wall_s']:.1f} tok/s "
              f"graphs={'on' if r0['graphs'] else 'off'}")
        for r in rs:
            if not (r["param_bytes"] == r["shard_bytes"] and r["launches"] == want
                    and r["stats"] == r0["stats"] and r["tokens"] == r0["tokens"]
                    and not r["graphs"]):
                raise AssertionError(f"[{label}] a rank's load, launches, stats or tokens differ")
        if label != "placed-dp" and not r0["shard_bytes"] < r0["full_bytes"]:
            raise AssertionError(f"[{label}] the tensor-parallel ranks hold whole weights")
        per_row = {row: st.decode_steps * L}
        if label == "placed-dp":
            per_row["prefill_attention"] = st.prefills * L
        runs[label] = PathRun(per_row, st, r0["tokens"], r0["wall_s"], None)
    if not all(runs[p].stats == runs["placed-dp"].stats for p in runs):
        raise AssertionError("[placed] the paths' EngineStats differ: placement changed the clock")
    sub = [Request(uid=i, prompt=p, max_new_tokens=64) for i, p in enumerate(prompts)]
    dense8 = by_path["dense-8"]._replace(tokens=by_path["dense-8"].tokens[:len(sub)])
    for r, toks in zip(sub, runs["placed-dp"].tokens):
        r.out_tokens = toks
    agreement("placed-dp", sub, dense8, exact=True)
    placed_logit_check(*placed_one_rank(model), logits, prompts)
    base = one["placed-dense"]["tokens"]
    for label in ("placed-head", "placed-seq"):
        pairs = list(zip(runs[label].tokens, base, strict=True))
        share = (sum(x == y for a, b in pairs for x, y in zip(a, b, strict=True))
                 / sum(len(a) for a, _ in pairs))
        print(f"[{label}] vs one rank at {PLACED_LAYERS} layers: "
              f"{sum(a == b for a, b in pairs)}/{len(pairs)} requests token-identical, "
              f"{share:.1%} of tokens")
    return runs


def placed_one_rank(model):
    """One rank's ``model`` at the placed paths' served depth
    (PLACED_LAYERS) and its weights, drawn from the serve CLI's seed as the
    ranks draw theirs (a cut depth draws other numbers than a view of the
    whole model's layers would hold)."""
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    cut = build_model(model.cfg.with_overrides(n_layers=PLACED_LAYERS), model.device)
    return cut, cut.init(args.seed)


def placed_paged_baselines(model, params) -> dict[str, dict]:
    """One-rank runs at each placed paged, tiered and sub-batched path's
    flags and served depth, with graphs (the step clock does not depend on
    them): the EngineStats, PoolStats and tokens the two ranks are held
    to."""
    one = {}
    flags = {label: PLACED_PAGED_FLAGS + ["--kv-dtype", kv]
             for label, (_, _, kv, _) in PLACED_PAGED.items()}
    flags.update({label: PLACED_TIERED_FLAGS + ["--kv-dtype", kv]
                  for label, (_, _, kv, _, _) in PLACED_TIERED.items()})
    flags["placed-sub-batches"] = SUB_BATCH_FLAGS
    flags["placed-dense"] = []                  # placed-head / -seq's depth
    cut = placed_one_rank(model)
    for label, extra in flags.items():
        args = serve.build_parser().parse_args(SERVE_FLAGS + PLACED_FLAGS + extra
                                               + ["--graphs", "on"])
        res = serve.serve(args, *(cut if label != "placed-sub-batches" else (model, params)))
        paged = args.cache == "paged"
        one[label] = {"stats": dataclasses.asdict(res.stats),
                      "pool": dataclasses.asdict(res.engine.pool.stats) if paged else None,
                      "tokens": [r.out_tokens for r in res.driver.submitted],
                      "kv_bytes": res.engine.kv_bytes(), "rate": _rate(res)}
        print(f"[{label}] one rank, graphs: {one[label]['rate']}"
              + (f"; pool: {res.engine.pool.stats}" if paged else ""))
        del res
    return one


def _placed_paged_checks(model, got: list[dict], logits: dict, prompts,
                         one: dict[str, dict]) -> dict[str, PathRun]:
    """placed-paged-dp (data 2, the batch policy: the pool's blocks over
    ``data``) and placed-paged-seq (model 2, the sequence policy: the blocks
    over ``model``, tensor parallel, an fp8 pool): every rank's
    EngineStats, PoolStats, ``pool:`` line and tokens equal, and the stats
    equal the one-rank run's; the paged kernel with its lse launched once
    per layer of every decode step on each lane's shard (all 8 KV heads)
    and the flash kernel once per layer of every chunk at the rank's
    heads; each lane holds half the pool; prefix hits and preemptions
    occurred; a teacher-forced paged step (:func:`teacher_forced_paged`:
    every block copied on write and read back across the lanes) in
    float32 at PLACED_CHECK_LAYERS within PLACED_PAGED_TOL of one rank's,
    every block read back equal to what was written.  Prints tok/s per
    rank, collectives per decode step and the token agreement with one
    rank.  Served at PLACED_LAYERS, as the one-rank runs are."""
    L = PLACED_LAYERS
    runs = {}
    for label, ((_, m), _, kv, row) in PLACED_PAGED.items():
        rs = [g[label] for g in got]
        r0, base = rs[0], one[label]
        st = EngineStats(**r0["stats"])
        for line in r0["lines"]:
            print(f"[{label}] {line}")
        chunk_row = "prefill_attention[chunk]" if m == 1 else "prefill_attention[tp2-chunk]"
        want = {"paged_decode_attention": {
                    f"{'unscaled' if kv == 'bf16' else kv}|{kernel_heads(8, 4, 64, 16)}":
                    st.decode_steps * L},
                "prefill_attention": {f"unscaled|{kernel_heads(8 // m, 4, 64)}":
                                      st.prefill_chunks * L}}
        n_coll = sum(r0["step_collectives"].values())
        print(f"[{label}] mesh {r0['axes']} policy {r0['policy']} pool {kv}; load "
              f"{r0['load_s']:.1f}s, {r0['param_bytes'] / 1e9:.3f} GB of weights and "
              f"{r0['pool_shard_bytes'] / 1e9:.4f} GB of the {base['kv_bytes'] / 1e9:.4f} GB "
              f"pool per rank; launches per rank {r0['launches']} expected {want}; wall "
              f"{r0['wall_s']:.2f}s -> {st.generated / r0['wall_s']:.1f} tok/s per rank "
              f"(one rank with graphs: {base['rate']}); collectives per decode step {n_coll} "
              f"{r0['step_collectives']}")
        pool_lines = {next(x for x in r["lines"] if x.startswith("pool:")) for r in rs}
        for r in rs:
            if not (r["param_bytes"] == r["shard_bytes"] and r["launches"] == want
                    and r["stats"] == r0["stats"] and r["pool"] == r0["pool"]
                    and r["tokens"] == r0["tokens"] and not r["graphs"]):
                raise AssertionError(f"[{label}] a rank's load, launches, stats or tokens differ")
        lane = PLACED_PAGED_BLOCKS // 2
        if (len(pool_lines) != 1 or not 2 * r0["pool_shard_bytes"] < base["kv_bytes"] + 2**20
                or not r0["pool"]["peak_in_use"] > lane - 1
                or not r0["pool"]["hash_hits"] > 0 or not r0["pool"]["preemptions"] > 0):
            raise AssertionError(f"[{label}] pool lines {pool_lines}, a rank holds "
                                 f"{r0['pool_shard_bytes']} of {base['kv_bytes']} bytes, "
                                 f"peak {r0['pool']['peak_in_use']} blocks in use of a lane's "
                                 f"{lane}, {r0['pool']['hash_hits']} prefix hits, "
                                 f"{r0['pool']['preemptions']} preemptions")
        steps = ("engine_steps", "decode_steps", "prefill_chunks", "prefills", "preemptions")
        clock = {k: (r0["stats"][k], base["stats"][k]) for k in steps}
        pool = {k: (r0["pool"][k], base["pool"][k]) for k in ("hash_hits", "cow_copies",
                                                                "preemptions", "allocs")}
        print(f"[{label}] two ranks vs one rank: {clock}; pool {pool}")
        if r0["stats"] != base["stats"] or r0["pool"] != base["pool"]:
            raise AssertionError(f"[{label}] EngineStats or PoolStats differ from one rank's: "
                                 f"{r0['stats']} {r0['pool']} vs {base['stats']} {base['pool']}")
        pairs = list(zip(r0["tokens"], base["tokens"], strict=True))
        share = (sum(x == y for a, b in pairs for x, y in zip(a, b, strict=True))
                 / sum(len(a) for a, _ in pairs))
        print(f"[{label}] vs one rank: {sum(a == b for a, b in pairs)}/{len(pairs)} requests "
              f"token-identical, {share:.1%} of tokens")
        runs[label] = PathRun({row: st.decode_steps * L, chunk_row: st.prefill_chunks * L}, st,
                              r0["tokens"], r0["wall_s"], None)
    f32 = build_model(model.cfg.with_overrides(dtype="float32", n_layers=PLACED_CHECK_LAYERS),
                      model.device)
    f32_params = f32.init(0)
    for label, (_, _, kv, _) in PLACED_PAGED.items():
        ref_logits, one_read = teacher_forced_paged(f32, f32_params, prompts, kv)
        reads = [g[label]["read_err"] for g in got]
        got_logits = logits[(label, "float32")]
        err = _max_err(got_logits, ref_logits.cpu())
        same = int((got_logits.argmax(-1) == ref_logits.cpu().argmax(-1)).sum())
        tol = PLACED_PAGED_TOL[label]
        print(f"[{label}] teacher-forced paged decode step in float32 at {PLACED_CHECK_LAYERS} "
              f"layers ({kv} pool, every block copied on write and read back) vs one rank: "
              f"logits max err {err:.2e} (tol {tol}), argmax equal {same}/{len(prompts)}; "
              f"blocks read back vs written: max err per rank {reads}, one rank {one_read}")
        if not err <= tol:
            raise AssertionError(f"[{label}] float32 logits {err} from one rank's")
        if any(reads) or one_read:
            raise AssertionError(f"[{label}] a block read back differs from what was written")
    del f32, f32_params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _placed_expected(label: str, r0: dict, want: dict, base: dict | None = None) -> None:
    """Print a placed path's lines, load, launches and rate; raise unless
    both ranks' loads, launches (``want``), stats, pool stats and tokens
    are equal, and, with ``base`` (a one-rank run's), unless the stats and
    pool stats equal that run's."""
    st = EngineStats(**r0["stats"])
    for line in r0["lines"]:
        print(f"[{label}] {line}")
    n_coll = sum(r0["step_collectives"].values())
    print(f"[{label}] mesh {r0['axes']} policy {r0['policy']}; load {r0['load_s']:.1f}s, "
          f"{r0['param_bytes'] / 1e9:.3f} GB of weights per rank; launches per rank "
          f"{r0['launches']} expected {want}; wall {r0['wall_s']:.2f}s -> "
          f"{st.generated / r0['wall_s']:.1f} tok/s per rank, "
          f"{r0['wall_s'] * 1e3 / st.engine_steps:.1f} ms per engine step"
          + (f" (one rank with graphs: {base['rate']})" if base else "")
          + f"; collectives per decode step {n_coll} {r0['step_collectives']}")
    if base is not None:
        steps = ("engine_steps", "decode_steps", "prefill_chunks", "prefills", "preemptions",
                 "spills", "rehydrations")
        print(f"[{label}] two ranks vs one rank: "
              f"{ {k: (r0['stats'][k], base['stats'][k]) for k in steps} }")
        if r0["stats"] != base["stats"] or r0["pool"] != base["pool"]:
            raise AssertionError(f"[{label}] EngineStats or PoolStats differ from one rank's: "
                                 f"{r0['stats']} {r0['pool']} vs {base['stats']} {base['pool']}")


def _placed_slice20_checks(model, got: list[dict], logits: dict, pools: dict, prompts,
                           one: dict[str, dict], dp: PathRun,
                           kvq_caches: list[dict]) -> dict[str, PathRun]:
    """The slice-20 paths against one rank and each other.  placed-tiered-dp
    / -seq: spills and no preemption, every rank's stats, pool stats and
    tokens equal and equal to one rank's run, the paged kernel twice a layer
    of every decode step (the hot window on the lane's shard, the cold one
    on the rank's share of the host tier), every spilled block's host copy
    byte-equal to the device block, and the teacher-forced tiered step in
    float32: the pools' codes within one step of one rank's and their
    scales within PLACED_SCALE_TOL, the logits within PLACED_TIERED_TOL's
    pair of one rank's (None: printed only) and of one rank's attending
    over the two ranks' pool bytes.  placed-spec: placed-dp's tokens
    exactly (each rank decodes the same 8 rows in the same per-position
    passes), the target's and the draft's kernels once a layer per pass.
    placed-sub-batches: one rank's ``--sub-batches 2`` stats, the decode
    kernel twice a layer per step, the float32 step within PLACED_SUB_TOL;
    its tokens against placed-dp's and its ms per engine step against
    placed-dp's printed.  The int8 dense cache: the float32 step on data 2
    and model 2 within PLACED_KVQ's tolerances, the data-2 ranks' payload
    and scales byte-equal to one rank's rows."""
    L, k = model.cfg.n_layers, SPEC_DEPTH
    runs = {}
    for label, ((_, m), _, kv, hot_row, cold_row) in PLACED_TIERED.items():
        Lt = PLACED_LAYERS
        rs = [g[label] for g in got]
        r0, base = rs[0], one[label]
        st = EngineStats(**r0["stats"])
        cold_bs = 16 if m == 1 else 8
        heads, cold_heads = kernel_heads(8, 4, 64, 16), kernel_heads(8, 4, 64, cold_bs)
        dec = {f"{kv}|{heads}": st.decode_steps * Lt}
        dec[f"{kv}|{cold_heads}"] = dec.get(f"{kv}|{cold_heads}", 0) + st.decode_steps * Lt
        want = {"paged_decode_attention": dec,
                "prefill_attention": {f"unscaled|{kernel_heads(8 // m, 4, 64)}":
                                      st.prefill_chunks * Lt}}
        _placed_expected(label, r0, want, base)
        checks, teacher = [r["spill_check"] for r in rs], [r["teacher_differ"] for r in rs]
        print(f"[{label}] spills read back whole from the host tier vs the device block, per "
              f"rank: {checks}; teacher-forced spills differing {teacher}")
        for r in rs:
            if not (r["param_bytes"] == r["shard_bytes"] and r["launches"] == want
                    and r["stats"] == r0["stats"] and r["pool"] == r0["pool"]
                    and r["tokens"] == r0["tokens"] and not r["graphs"]):
                raise AssertionError(f"[{label}] a rank's load, launches, stats or tokens differ")
            sc = r["spill_check"]
            if not (sc["spills"] == st.spills > 0 and sc["differ"] == 0
                    and r["teacher_differ"] == 0):
                raise AssertionError(f"[{label}] spills {sc}, teacher {r['teacher_differ']}")
        if st.preemptions or not r0["pool"]["peak_in_use"] > PLACED_TIERED_BLOCKS // 2:
            raise AssertionError(f"[{label}] {st.preemptions} preemptions, peak "
                                 f"{r0['pool']['peak_in_use']} blocks")
        runs[label] = PathRun({hot_row: st.decode_steps * Lt, cold_row: st.decode_steps * Lt,
                               "prefill_attention[chunk]" if m == 1
                               else "prefill_attention[tp2-chunk]": st.prefill_chunks * Lt},
                              st, r0["tokens"], r0["wall_s"], None)
    f32 = build_model(model.cfg.with_overrides(dtype="float32", n_layers=PLACED_CHECK_LAYERS),
                      model.device)
    f32_params = f32.init(0)
    for label, (_, _, kv, _, _) in PLACED_TIERED.items():
        raw_tol, tol = PLACED_TIERED_TOL[label]
        for name, pool_kv in _tiered_steps(label, kv):
            one_logits, differ, cache = teacher_forced_tiered(f32, f32_params, prompts, pool_kv)
            if differ:
                raise AssertionError(f"[{name}] one rank's spills differ in {differ} blocks")
            got_logits, whole = logits[(name, "float32")], pools[name]
            excess, n_diff, n_codes, scale_err = _pool_distance(whole, cache)
            del cache
            over = teacher_forced_tiered(f32, f32_params, prompts, pool_kv, over=whole)[0]
            raw = _max_err(got_logits, one_logits.cpu())
            same = int((got_logits.argmax(-1) == one_logits.cpu().argmax(-1)).sum())
            print(f"[{name}] teacher-forced tiered step ({pool_kv} pool, half of each prompt's "
                  f"full blocks spilled) in float32 at {PLACED_CHECK_LAYERS} layers vs one rank: "
                  f"logits max err {raw:.2e} (tol {raw_tol}), argmax equal {same}/{len(prompts)}; "
                  f"the pools: {n_diff} of {n_codes} K/V codes differ, by at most {excess:.3f} "
                  f"of a code step (tol 1), scales by {scale_err:.2e} relative (tol "
                  f"{PLACED_SCALE_TOL})")
            _f32_check(name, "the same step with one rank attending over the two ranks' pool "
                       "bytes", got_logits, over, tol)
            if raw_tol is not None and not raw <= raw_tol:
                raise AssertionError(f"[{name}] float32 logits {raw} from one rank's")
            if not (excess <= 1 and scale_err <= PLACED_SCALE_TOL):
                raise AssertionError(f"[{name}] the pools differ: codes by {excess} steps, "
                                     f"scales by {scale_err} relative")
    # speculation: placed-dp's tokens, the draft's kernels at its heads
    r0 = got[0]["placed-spec"]
    st = EngineStats(**r0["stats"])
    Ld = serve.load_draft(serve.build_parser().parse_args(SERVE_FLAGS), model)[0].cfg.n_layers
    chunks = st.draft_steps - (k + 1) * st.spec_steps
    want = {"decode_attention": {f"unscaled|{kernel_heads(8, 4, 64)}": st.spec_steps * (k + 1) * L,
                                 f"unscaled|{kernel_heads(2, 2, 16)}":
                                     st.spec_steps * (k + 1) * Ld},
            "prefill_attention": {f"unscaled|{kernel_heads(8, 4, 64)}": st.prefills * L,
                                  f"unscaled|{kernel_heads(2, 2, 16)}": chunks * Ld}}
    _placed_expected("placed-spec", r0, want)
    for g in got:
        r = g["placed-spec"]
        if not (r["launches"] == want and r["stats"] == r0["stats"]
                and r["tokens"] == r0["tokens"]):
            raise AssertionError("[placed-spec] a rank's launches, stats or tokens differ")
    same = sum(a == b for a, b in zip(r0["tokens"], dp.tokens, strict=True))
    print(f"[placed-spec] vs placed-dp: {same}/{len(dp.tokens)} requests token-identical; "
          f"acceptance {st.acceptance_rate:.3f}")
    if r0["tokens"] != dp.tokens:
        raise AssertionError("[placed-spec] tokens differ from placed-dp's")
    runs["placed-spec"] = PathRun({"decode_attention": st.spec_steps * (k + 1) * L,
                                   "decode_attention[draft]": st.spec_steps * (k + 1) * Ld,
                                   "prefill_attention": st.prefills * L,
                                   "prefill_attention[draft-chunk]": chunks * Ld},
                                  st, r0["tokens"], r0["wall_s"], None)
    # sub-batches: one rank's clock, the decode kernel twice a layer a step
    r0, base = got[0]["placed-sub-batches"], one["placed-sub-batches"]
    st = EngineStats(**r0["stats"])
    want = {"decode_attention": {f"unscaled|{kernel_heads(8, 4, 64)}": 2 * st.decode_steps * L},
            "prefill_attention": {f"unscaled|{kernel_heads(8, 4, 64)}": st.prefills * L}}
    _placed_expected("placed-sub-batches", r0, want, base)
    for g in got:
        r = g["placed-sub-batches"]
        if not (r["launches"] == want and r["stats"] == r0["stats"]
                and r["tokens"] == r0["tokens"]):
            raise AssertionError("[placed-sub-batches] a rank's launches, stats or tokens differ")
    pairs = list(zip(r0["tokens"], dp.tokens, strict=True))
    share = (sum(x == y for a, b in pairs for x, y in zip(a, b, strict=True))
             / sum(len(a) for a, _ in pairs))
    print(f"[placed-sub-batches] vs placed-dp: {sum(a == b for a, b in pairs)}/{len(pairs)} "
          f"requests token-identical, {share:.1%} of tokens; ms per engine step on the mesh: "
          f"--sub-batches 2 {r0['wall_s'] * 1e3 / st.engine_steps:.1f}, --sub-batches 1 "
          f"(placed-dp) {dp.wall_s * 1e3 / dp.stats.engine_steps:.1f}")
    runs["placed-sub-batches"] = PathRun({"decode_attention": 2 * st.decode_steps * L,
                                          "prefill_attention": st.prefills * L},
                                         st, r0["tokens"], r0["wall_s"], None)
    _f32_check("placed-sub-batches", "teacher-forced step as two sub-batches",
               logits[("placed-sub-batches", "float32")],
               teacher_forced(f32, f32_params, prompts, n_sub=2), PLACED_SUB_TOL)
    del f32
    # the int8 dense cache: one rank's model of the same weights
    q32 = build_model(model.cfg.with_overrides(dtype="float32", n_layers=PLACED_CHECK_LAYERS,
                                               kv_quant=True), model.device)
    half = len(prompts) // PLACED_RANKS
    for label, (_, _, tol) in PLACED_KVQ.items():
        one_logits = teacher_forced(q32, f32_params, prompts)
        _f32_check(label, "teacher-forced step on the int8 dense cache",
                   logits[(label, "float32")], one_logits, tol)
    # each data-2 rank's rows against one rank's step over the same 8 rows
    # (the decode GEMMs then have the rows' shape on both sides)
    differ = []
    for r, cache in enumerate(kvq_caches):
        lo, hi = cache["rows"]
        _, one_cache = teacher_forced(q32, f32_params, prompts[lo:hi], keep_cache=True)
        differ.append([name for name in ("k", "v", "k_scale", "v_scale")
                       if not torch.equal(cache[name], one_cache[name].cpu())])
        if (hi - lo) != half:
            raise AssertionError(f"[placed-kvq-dp] rank {r} holds rows {lo}-{hi}")
    print(f"[placed-kvq-dp] each rank's int8 payload and bf16 scales vs one rank's same rows: "
          f"leaves differing per rank {differ}")
    if any(differ):
        raise AssertionError("[placed-kvq-dp] a rank's int8 cache differs from one rank's rows")
    del q32, f32_params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _code_excess(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How far two int8 / fp8-e4m3 payloads (``p = x / scale``; fp8 as its
    bytes) lie apart, code by code: ``|pa - pb|`` over one code step at
    the larger of the two plus PLACED_CODE_SLACK of the format's largest
    code (the rounding of the value before it is quantized), so that 1
    is a value moved to a neighbouring code.  fp8's step shrinks towards
    0 (2^-9 below 2^-6), where the same rounding moves a value by several."""
    if a.dtype == torch.int8:
        pa, pb, qmax, step = a.float(), b.float(), 127.0, 1.0
    else:
        pa, pb = (x.view(torch.float8_e4m3fn).float() for x in (a, b))
        qmax = 448.0
        m = torch.maximum(pa.abs(), pb.abs()).clamp_min(2.0 ** -6)
        step = torch.exp2(torch.floor(torch.log2(m)) - 3)
    return (pa - pb).abs() / (step + PLACED_CODE_SLACK * qmax)


def _pool_distance(whole: dict[str, torch.Tensor], cache) -> tuple[float, int, int, float]:
    """How far a placed run's pool (:func:`pool_whole`) lies from one
    rank's ``cache`` of the same step: the largest :func:`_code_excess`
    of a K/V code, the counts of codes that differ and of all codes, and
    the largest relative difference of a scale."""
    excess, n_diff, n_codes, scale_err = 0.0, 0, 0, 0.0
    for key, a in whole.items():
        b = ref.byte_view(cache[key]).cpu()
        if key.endswith("_scale"):
            d = (a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
            scale_err = max(scale_err, float(d.max()))
            continue
        excess = max(excess, float(_code_excess(a, b).max()))
        n_diff, n_codes = n_diff + int((a != b).sum()), n_codes + a.numel()
    return excess, n_diff, n_codes, scale_err


def _f32_check(label: str, what: str, got: torch.Tensor, want: torch.Tensor,
               tol: float) -> None:
    """A placed float32 step's logits against one rank's, within ``tol``."""
    want = want.cpu()
    err = _max_err(got, want)
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[{label}] {what} in float32 at {PLACED_CHECK_LAYERS} layers vs one rank: logits "
          f"max err {err:.2e} (tol {tol}), argmax equal {same}/{len(got)}")
    if not err <= tol:
        raise AssertionError(f"[{label}] float32 logits {err} from one rank's")


def placed_logit_check(model, params, logits: dict, prompts) -> None:
    """The tensor-parallel teacher-forced steps ``logits[(label, dtype)]``
    (placed-head, placed-seq; :func:`placed_worker`) against one rank's.
    float32 at PLACED_CHECK_LAYERS: within PLACED_LOGIT_TOL of the one-rank
    model's.  bf16 at full depth (the served models, the decode kernel's
    mma route): the ranks round each row-parallel partial product (wo,
    w_down) to bf16 before the all-reduce sums them, one rounding more
    than one rank makes, so the step is held to ``model`` (the served
    one-rank model) rounding as two ranks do (:func:`tp_rounding`), within
    PLACED_TP_ROUNDING_TOL; its distance to ``model`` itself is printed."""
    f32 = build_model(model.cfg.with_overrides(dtype="float32", n_layers=PLACED_CHECK_LAYERS),
                      model.device)
    one = {"float32": teacher_forced(f32, f32.init(0), prompts).cpu(),
           "bfloat16": teacher_forced(model, params, prompts).cpu()}
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    with tp_rounding(model.cfg):
        rounded = teacher_forced(model, params, prompts).cpu()
    n = len(prompts)
    for label in ("placed-head", "placed-seq"):
        got = logits[(label, "float32")]
        err = _max_err(got, one["float32"])
        same = int((got.argmax(-1) == one["float32"].argmax(-1)).sum())
        print(f"[{label}] teacher-forced decode step in float32 at {PLACED_CHECK_LAYERS} layers "
              f"vs one rank: logits max err {err:.2e} (tol {PLACED_LOGIT_TOL}), argmax equal "
              f"{same}/{n}")
        if not err <= PLACED_LOGIT_TOL:
            raise AssertionError(f"[{label}] float32 logits {err} from one rank's")
        got = logits[(label, "bfloat16")]
        err = _max_err(got, rounded)
        print(f"[{label}] teacher-forced decode step in bf16 at {model.cfg.n_layers} layers vs "
              f"one rank rounding wo and w_down as two ranks do: logits max err {err:.2e} (tol "
              f"{PLACED_TP_ROUNDING_TOL}), argmax equal "
              f"{int((got.argmax(-1) == rounded.argmax(-1)).sum())}/{n}; vs one rank "
              f"{_max_err(got, one['bfloat16']):.2e}, argmax equal "
              f"{int((got.argmax(-1) == one['bfloat16'].argmax(-1)).sum())}/{n}; one rank "
              f"rounding as two vs one rank {_max_err(rounded, one['bfloat16']):.2e}")
        if not err <= PLACED_TP_ROUNDING_TOL:
            raise AssertionError(f"[{label}] bf16 logits {err} from one rank's with TP rounding")


# ------------------------------------ the cluster on meshes of its own (slice 21)
@contextlib.contextmanager
def timed_handoffs():
    """While open, count and time the migration payloads that move between
    two meshes (``collectives.send_tree`` on the source's first rank, its
    device-to-host copy included; ``recv_tree`` on a destination rank)."""
    moves = {"sent": 0, "received": 0, "bytes": 0, "send_s": 0.0, "recv_s": 0.0}
    send, recv = collectives.send_tree, collectives.recv_tree

    def timed_send(tree, dst, group):
        t0 = time.perf_counter()
        send(tree, dst, group)
        moves["send_s"] += time.perf_counter() - t0
        moves["sent"] += 1
        moves["bytes"] += sum(t.numel() * t.element_size() for t in tree.values())

    def timed_recv(src, group, pin=False):
        t0 = time.perf_counter()
        out = recv(src, group, pin)
        moves["recv_s"] += time.perf_counter() - t0
        moves["received"] += 1
        return out

    collectives.send_tree, collectives.recv_tree = timed_send, timed_recv
    try:
        yield moves
    finally:
        collectives.send_tree, collectives.recv_tree = send, recv


@contextlib.contextmanager
def checked_migrations():
    """While open, every migration keeps this rank's raw shards of the
    blocks it moves (:func:`_held_piece`, none of the pool's own moves):
    on the source's mesh those it exports, read just after
    ``serving.paged.device.copy_blocks_out``; on the destination's those it
    lands, read just after ``copy_blocks_in``, each tagged with the
    migration's number (every rank exports every migration: mirrors keep
    the bookkeeping).  On closing, every rank's shards are gathered on
    rank 0 in one plain ``gather_object``, and each landed block, put
    together from its lanes, is held to the exported block it lands, put
    together from the source's lanes: on rank 0 the counts of migrations,
    of blocks landed, and of those that differ in any byte or that the
    lanes leave partly uncovered (None on the other ranks)."""
    saved_out, saved_in, saved_export = pdev.copy_blocks_out, pdev.copy_blocks_in, \
        Engine.export_request
    number = [0]
    taken = []

    def dims(cache):
        if isinstance(cache, offload.ShardedPool):
            return cache.n_kv, cache.block_size
        return tuple(cache["k"].shape[2:4])

    def held(cache, ids):
        pieces = [_held_piece(cache, i) for i in ids]
        return [None if x is None else (x[0], x[1], [t.cpu() for t in x[2]]) for x in pieces]

    def export(self, slot):
        number[0] += 1
        return saved_export(self, slot)

    def blocks_out(cache, ids):
        payload = saved_out(cache, ids)
        taken.append(("out", number[0], dims(cache), None, held(cache, ids)))
        return payload

    def blocks_in(cache, payload, sel, dst):
        saved_in(cache, payload, sel, dst)
        taken.append(("in", number[0], dims(cache), list(sel), held(cache, dst)))
        return cache

    pdev.copy_blocks_out, pdev.copy_blocks_in = blocks_out, blocks_in
    Engine.export_request = export
    counts = {}
    try:
        yield counts
    finally:
        pdev.copy_blocks_out, pdev.copy_blocks_in = saved_out, saved_in
        Engine.export_request = saved_export
    ranks = [taken]
    if dist.is_initialized() and dist.get_world_size() > 1:
        ranks = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
        dist.gather_object(taken, ranks, dst=0)
    if ranks is None:
        counts.update(migrations=None, blocks=None, differ=None)
        return
    events = [t for r in ranks for t in r]
    moved = sorted({n for kind, n, *_ in events if kind == "in"})
    blocks = differ = 0
    for n in moved:
        outs = [t for t in events if t[:2] == ("out", n)]
        ins = [t for t in events if t[:2] == ("in", n)]
        (n_kv, bs), sel = ins[0][2], ins[0][3]
        for j, s in enumerate(sel):
            src = [t[4][s] for t in outs if t[4][s] is not None]
            dst = [t[4][j] for t in ins if t[4][j] is not None]
            (a, a_full), (b, b_full) = _assembled(src, n_kv, bs), _assembled(dst, n_kv, bs)
            blocks += 1
            differ += not (a_full and b_full and all(map(torch.equal, a, b)))
    counts.update(migrations=len(moved), blocks=blocks, differ=differ)


def _world_run(flags: list[str], layers: int | None = None, device: str | None = None,
               migrations: bool = False) -> dict:
    """One cluster path on this rank of a world whose replicas each have a
    mesh of their own, through the serve entry points: the world joined
    (``serve.place``), ``replica_meshes``, a warm-up of 4 requests, then
    the run with every launch counter zeroed before it and read after it,
    every plain attention refused, every spill read back
    (:func:`checked_spills`), every payload between meshes timed
    (:func:`timed_handoffs`) and, with ``migrations``, every migrated
    block read back on both meshes (:func:`checked_migrations`).
    ``layers`` cuts the served model to that depth (the serve loader's
    weights for the layers kept); ``device`` (default: this rank's card)
    serves elsewhere (a CPU rehearsal)."""
    saved = serve.load_config
    if layers is not None:
        serve.load_config = lambda a: saved(a).with_overrides(n_layers=layers)
    try:
        args = serve.build_parser().parse_args(SERVE_FLAGS + flags)
        args.device = device             # the serve CLI's default: this rank's card
        serve.place(args, serve.load_config(args))
        meshes = replica_meshes(args.replicas, device=args.device)
        warm = serve.build_parser().parse_args(SERVE_FLAGS + flags + ["--requests", "4"])
        warm.device = args.device
        serve.serve(warm, None, None, meshes=meshes)
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        with (forbid_plain_serving(), checked_spills() as spills, timed_handoffs() as moves,
              checked_migrations() if migrations else contextlib.nullcontext({}) as migrated):
            res = serve.serve(args, None, None, meshes=meshes)
    finally:
        serve.load_config = saved
    cl = res.cluster
    row = {"stats": dataclasses.asdict(res.stats), "wall_s": res.wall_s,
           "pools": [dataclasses.asdict(e.pool.stats) if args.cache == "paged" else None
                     for e in cl.engines],
           "tokens": [r.out_tokens for r in res.driver.submitted],
           "placement": [cl.placement[r.uid] for r in res.driver.submitted],
           "launches": {k: {f"{v}|{h}": n for (v, h), n in d.items()}
                        for k, d in ops.shape_counts().items() if d},
           "members": [e.member for e in cl.engines],
           "graphs": [e.graphs for e in cl.engines],
           "programs": [graph_summary(e) if e.member else None for e in cl.engines],
           "broadcasts": sum(e._fanout.broadcasts for e in cl.engines if e._fanout),
           "mirror_caches": [e.cache is not None for e in cl.engines if not e.member],
           "handoffs": moves, "spill_check": dict(spills), "migration_check": dict(migrated),
           "param_bytes": sum(t.numel() * t.element_size() for e in cl.engines if e.member
                              for t in leaves(e.params)),
           "lines": serve.report(args, res)}
    del res, cl
    gc.collect()
    torch.cuda.empty_cache()
    return row


def world_worker(out: Path, device: str | None = None) -> None:
    """A rank of the cluster paths on meshes of their own (``chip_smoke.py
    --world-worker DIR``, started by :func:`world_phase` as torchrun starts
    one): on a world of WORLD_RANKS world-disagg, on one of
    PLACED_DISAGG_RANKS placed-disagg; writes ``rank{r}.json``."""
    n = int(os.environ["WORLD_SIZE"])
    t0 = time.perf_counter()
    if n == WORLD_RANKS:
        label, got = "world-disagg", _world_run(DISAGG_FLAGS, device=device)
    else:
        label, got = "placed-disagg", _world_run(PLACED_DISAGG_FLAGS, layers=PLACED_LAYERS,
                                                 device=device, migrations=True)
    got.update(label=label, backend=dist.get_backend(), seconds=time.perf_counter() - t0)
    (out / f"rank{dist.get_rank()}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _world_spawn(n_ranks: int) -> list[dict]:
    out = Path(tempfile.mkdtemp(prefix="world-"))
    try:
        _spawn_ranks(out, "--world-worker", WORLD_TIMEOUT, n_ranks)
        return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n_ranks)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _world_common(label: str, got: list[dict], base_stats: dict, base_pools: list,
                  n_requests: int) -> EngineStats:
    """Checks every cluster path on meshes of its own passes: every rank's
    ClusterStats, PoolStats, tokens and placements equal, and the
    ClusterStats and PoolStats those of the cluster in one process
    (``base_*``); no migration lost; mirrors hold no cache and the world
    broadcasts its fetches; prints the path's lines and figures."""
    r0 = got[0]
    cs = r0["stats"]
    for line in r0["lines"]:
        print(f"[{label}] {line}")
    for r, g in enumerate(got):
        if not (g["stats"] == cs and g["pools"] == r0["pools"] and g["tokens"] == r0["tokens"]
                and g["placement"] == r0["placement"] and not any(g["mirror_caches"])):
            raise AssertionError(f"[{label}] rank {r}'s cluster differs from rank 0's")
    if cs != base_stats or r0["pools"] != base_pools:
        raise AssertionError(f"[{label}] ClusterStats or PoolStats differ from the cluster in one "
                             f"process: {cs} {r0['pools']} vs {base_stats} {base_pools}")
    st = [EngineStats(**rep["engine"]) for rep in cs["replicas"]]
    out = sum(s.migrations_out for s in st)
    into = sum(s.migrations_in for s in st)
    home = sum(1 for p in r0["placement"] if p == 0)
    if not (cs["migrations"] > 0 and out == into == cs["migrations"]
            and cs["migrations"] + home == n_requests):
        raise AssertionError(f"[{label}] a migration was lost: {cs['migrations']} migrations, "
                             f"{out} out, {into} in, {home} finished at home")
    rounds = cs["rounds"]
    moved = [g["handoffs"] for g in got]
    sent = sum(m["sent"] for m in moved)
    nbytes = sum(m["bytes"] for m in moved)
    gen = sum(s.generated for s in st)
    wall = max(g["wall_s"] for g in got)
    print(f"[{label}] {len(got)} ranks, backend {r0['backend']}: ClusterStats and PoolStats equal "
          f"on every rank and to the cluster in one process; migrations {cs['migrations']} "
          f"(out {out}, in {into}, {home} finished on the prefill replica); rounds {rounds}; "
          f"{gen / wall:.1f} tok/s, {wall * 1e3 / rounds:.3f} ms per round; world broadcasts "
          f"{r0['broadcasts']} ({r0['broadcasts'] / rounds:.2f} a round); payloads sent "
          f"{sent}, {nbytes / max(sent, 1) / 1e6:.3f} MB each, send "
          f"{sum(m['send_s'] for m in moved) * 1e3 / max(sent, 1):.3f} ms / receive "
          f"{sum(m['recv_s'] for m in moved) * 1e3 / max(sent, 1):.3f} ms each; seconds per "
          f"rank {[round(g['seconds'], 1) for g in got]}")
    return st


def world_phase(model, params, by_path: dict[str, PathRun],
                rows: dict[str, dict]) -> dict[str, PathRun]:
    """The cluster on meshes of its own (slice 21).  world-disagg: two
    ranks of this script on the one card over gloo, one replica each
    (``replica_meshes``: every rank runs the whole cluster loop, mirroring
    the other's replica), ``DISAGG_FLAGS`` exactly at full width and depth
    through the graphs: ClusterStats and every replica's EngineStats and
    PoolStats equal the in-process disagg path's (every request finishes at
    max_new, so the step clock does not depend on the tokens), no migration
    lost, the launches of both ranks those the step clock gives, and the
    tokens held to disagg's by the token floor (the count equal printed).
    placed-disagg: four ranks, two replicas of data 2 on placed-tiered-dp's
    fp8 pool and host tier at PLACED_LAYERS, eagerly, held to one rank's
    cluster at the same flags and depth (ClusterStats and PoolStats), every
    rank's tokens equal, every spill's host copy byte-equal to its device
    block, every block a migration lands on the decode replica's lanes
    byte-equal to the block exported from the prefill replica's lanes
    (:func:`checked_migrations`), each rank's launches its replica's step
    clock gives."""
    t0 = time.perf_counter()
    runs = {}
    base = by_path["disagg"]
    got = _world_spawn(WORLD_RANKS)
    base_cl = base.res.cluster
    st = _world_common("world-disagg", got, dataclasses.asdict(base.stats),
                       [dataclasses.asdict(e.pool.stats) for e in base_cl.engines],
                       len(base.tokens))
    tot = _Summed([types.SimpleNamespace(stats=s) for s in st])
    L = model.cfg.n_layers
    per_row = {"prefill_attention[chunk]": tot.prefill_chunks * L,
               "paged_decode_attention": tot.decode_steps * L}
    want = {k: {f"{v}|{h}": n for (v, h), n in d.items()}
            for k, d in _expected(per_row, rows)[1].items() if d}
    summed: dict = {}
    for r, g in enumerate(got):
        for k, d in g["launches"].items():
            for key, n in d.items():
                summed.setdefault(k, {})[key] = summed.setdefault(k, {}).get(key, 0) + n
        if not all(g["graphs"][i] for i, m in enumerate(g["members"]) if m):
            raise AssertionError("[world-disagg] a replica ran without graphs")
        print(f"[world-disagg] rank {r} holds replicas "
              f"{[i for i, m in enumerate(g['members']) if m]}; graphs: "
              f"{[p for p in g['programs'] if p]}")
    print(f"[world-disagg] launches over both ranks {summed} expected {want}")
    if summed != want:
        raise AssertionError("[world-disagg] kernel launches differ from the step clock's")
    same = sum(a == b for a, b in zip(got[0]["tokens"], base.tokens, strict=True))
    print(f"[world-disagg] {same}/{len(base.tokens)} requests token-identical to disagg's")
    agreement("world-disagg", [types.SimpleNamespace(out_tokens=t) for t in got[0]["tokens"]],
              base)
    runs["world-disagg"] = PathRun(per_row, st, got[0]["tokens"], got[0]["wall_s"], None)
    # placed-disagg: one rank's cluster first, in this process
    args = serve.build_parser().parse_args(SERVE_FLAGS + PLACED_DISAGG_FLAGS + ["--graphs", "on"])
    res = serve.serve(args, *placed_one_rank(model))
    one = {"stats": dataclasses.asdict(res.stats), "tokens": [r.out_tokens for r in
                                                              res.driver.submitted],
           "pools": [dataclasses.asdict(e.pool.stats) for e in res.cluster.engines]}
    print(f"[placed-disagg] one rank's cluster, graphs: {res.stats.generated / res.wall_s:.1f} "
          f"tok/s, {res.wall_s * 1e3 / res.stats.rounds:.3f} ms per round")
    del res
    got = _world_spawn(PLACED_DISAGG_RANKS)
    st = _world_common("placed-disagg", got, one["stats"], one["pools"], len(one["tokens"]))
    Lt = PLACED_LAYERS
    heads = kernel_heads(8, 4, 64, 16)
    per_row = {}
    for r, g in enumerate(got):
        rep = [i for i, m in enumerate(g["members"]) if m]
        s = st[rep[0]]
        want = {k: {key: n} for k, key, n in (
            ("paged_decode_attention", f"fp8|{heads}", 2 * s.decode_steps * Lt),
            ("prefill_attention", f"unscaled|{kernel_heads(8, 4, 64)}", s.prefill_chunks * Lt))
                if n}
        sc = g["spill_check"]
        print(f"[placed-disagg] rank {r}: replica {rep}, launches {g['launches']} expected "
              f"{want}; spills read back {sc}; {g['param_bytes'] / 1e9:.3f} GB of weights")
        if g["launches"] != want or sc["spills"] != s.spills or sc["differ"]:
            raise AssertionError(f"[placed-disagg] rank {r}'s launches or spills")
        if r % 2 == 0:                   # one rank of each replica
            for row, n in (("paged_decode_attention[lane-block2,fp8]", s.decode_steps * Lt),
                           ("paged_decode_attention[host-whole,fp8]", s.decode_steps * Lt),
                           ("prefill_attention[chunk]", s.prefill_chunks * Lt)):
                per_row[row] = per_row.get(row, 0) + n
    if not sum(s.spills for s in st) or any(s.preemptions for s in st):
        raise AssertionError(f"[placed-disagg] spills {[s.spills for s in st]}, preemptions "
                             f"{[s.preemptions for s in st]}")
    mc = got[0]["migration_check"]
    print(f"[placed-disagg] migrated blocks read back on both meshes: {mc}")
    if not (mc["migrations"] == one["stats"]["migrations"] and mc["blocks"] and not mc["differ"]):
        raise AssertionError(f"[placed-disagg] a migrated block differs from the one exported, "
                             f"or a migration was not read back: {mc}")
    pairs = list(zip(got[0]["tokens"], one["tokens"], strict=True))
    print(f"[placed-disagg] vs one rank's cluster: {sum(a == b for a, b in pairs)}/{len(pairs)} "
          f"requests token-identical, first tokens equal "
          f"{sum(a[0] == b[0] for a, b in pairs)}/{len(pairs)}")
    runs["placed-disagg"] = PathRun(per_row, st, got[0]["tokens"], got[0]["wall_s"], None)
    print(f"[world] phase wall {time.perf_counter() - t0:.1f}s")
    return runs


def _concurrency(kernels: list[dict]) -> tuple[float, float, float]:
    """Over kernel events (``ts``, ``dur`` in us, ``args.stream``): the time
    some kernel runs, the time two or more run at once, and the time kernels
    of two or more stream ids run at once."""
    marks = sorted([(e["ts"], 1, e["args"].get("stream", -1)) for e in kernels]
                   + [(e["ts"] + e["dur"], -1, e["args"].get("stream", -1)) for e in kernels])
    live: dict[int, int] = {}
    busy = many = streams = 0.0
    last = None
    for t, d, sid in marks:
        if last is not None:
            n = sum(live.values())
            busy += (t - last) if n else 0.0
            many += (t - last) if n > 1 else 0.0
            streams += (t - last) if sum(v > 0 for v in live.values()) > 1 else 0.0
        live[sid] = live.get(sid, 0) + d
        last = t
    return busy, many, streams


def sub_batch_phase(model, params) -> None:
    """``--sub-batches 2`` against ``--sub-batches 1`` on the dense path: the
    serve run of each in turns (1, 2, 2, 1; async, graphs), wall ms per
    engine step; then ``torch.profiler`` over 8 steady decode steps of a
    ``sub_batches=2`` engine with graphs and eagerly: kernels per stream id,
    and how long kernels of two streams ran at once (all kernels, and the
    dense decode kernel's), from the trace's timestamps."""
    t_phase = time.perf_counter()
    ms = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        args = serve.build_parser().parse_args(SERVE_FLAGS + ["--sub-batches", str(n)])
        res = serve.serve(args, model, params)
        ms[n].append(res.wall_s * 1e3 / res.stats.engine_steps)
    print("[sub-batches] wall ms per engine step, in turns 1, 2, 2, 1 (dense, async, graphs): "
          f"--sub-batches 1 {ms[1][0]:.3f}, {ms[1][1]:.3f}; --sub-batches 2 {ms[2][0]:.3f}, "
          f"{ms[2][1]:.3f}; ratio of means {statistics.mean(ms[2]) / statistics.mean(ms[1]):.3f}")
    for graphs in (True, False):
        args = serve.build_parser().parse_args(SERVE_FLAGS + SUB_BATCH_FLAGS
                                               + ["--graphs", "on" if graphs else "off"])
        eng = serve.make_engine(args, model, params)
        for i, arr in enumerate(build_workload("random", args.slots, vocab=model.cfg.vocab,
                                               max_seq=args.max_seq, max_new=args.max_new,
                                               seed=1)):
            eng.submit(Request(uid=i, prompt=arr.prompt, max_new_tokens=arr.max_new_tokens))
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 8
        eng.run()
        path = Path(tempfile.gettempdir()) / f"chip_smoke_sub_{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        path.unlink()
        kernels = [e for e in trace["traceEvents"]
                   if e.get("cat") == "kernel" and e.get("ph") == "X"]
        mode = "graphs" if graphs else "eager"
        if not kernels:
            print(f"[sub-batches {mode}] profile: wall {wall_ms:.3f} ms/step; kernel overlap "
                  "not measured (the profiler saw no kernels)")
            continue
        per_stream: dict[int, int] = {}
        for e in kernels:
            sid = e["args"].get("stream", -1)
            per_stream[sid] = per_stream.get(sid, 0) + 1
        busy, many, streams = _concurrency(kernels)
        _, attn_many, _ = _concurrency([e for e in kernels if "decode_split" in e["name"]])
        print(f"[sub-batches {mode}] profile over 8 decode steps: wall {wall_ms:.3f} ms/step, "
              f"kernels busy {busy / 8e3:.3f} ms/step; kernels per stream id {per_stream}; "
              f"two or more kernels at once {many / 8e3:.3f} ms/step "
              f"({many / max(busy, 1e-9):.1%} of the busy time; of two stream ids "
              f"{streams / 8e3:.3f}); two decode-kernel launches at once "
              f"{attn_many / 8e3:.4f} ms/step")
    print(f"[sub-batches] overlap phase wall {time.perf_counter() - t_phase:.1f}s")


# host-side launch calls the profiler records, by what they launch
GRAPH_LAUNCH = ("cudaGraphLaunch",)
KERNEL_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profile_phase(model, params, label: str, flags: list[str], warm_steps: int,
                  n_steps: int = 8, graphs: bool = True, drain: bool = True) -> None:
    """Where a steady step's time goes: ``torch.profiler`` over ``n_steps``
    async steps after ``warm_steps`` (32 requests over 16 slots), with
    every dispatch kind one CUDA graph or (``graphs=False``) eagerly.
    Prints wall time per step, device busy time per step (the device-side
    events' time: kernels, copies and fills), device ops and host launch
    calls per step (graph launches and kernel launches apart) and the top
    kernels; reports "not measured" if the profiler sees no device time.  With a host tier, also times one layer's hot and cold
    paged launches on the state the window ended in.  ``drain``: run the
    engine's requests to their end afterwards (the MoE path skips it: its
    eager steps take a quarter second)."""
    label = f"{label}{'' if graphs else ' eager'}"
    args = serve.build_parser().parse_args(SERVE_FLAGS + flags
                                           + ["--graphs", "on" if graphs else "off"])
    eng = serve.make_engine(args, model, params)
    for i, arr in enumerate(build_workload("random", 2 * args.slots, vocab=model.cfg.vocab,
                                           max_seq=args.max_seq, max_new=args.max_new,
                                           seed=1)):
        eng.submit(Request(uid=i, prompt=arr.prompt, max_new_tokens=arr.max_new_tokens))
    for _ in range(warm_steps):
        eng.step()
    torch.cuda.synchronize()
    st0 = dataclasses.replace(eng.stats)
    replays0 = sum(p.replays for p in eng.programs.values())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    st = eng.stats
    replays = sum(p.replays for p in eng.programs.values()) - replays0
    mix = (f"{st.decode_steps - st0.decode_steps} decode batches (mean "
           f"{(st.generated - st0.generated) / n_steps:.1f} tokens/step), "
           f"{st.prefill_chunks - st0.prefill_chunks} prefill chunks in {n_steps} steps, "
           f"{replays / n_steps:.2f} graph replays/step")
    events = prof.key_averages()
    launch_calls = {kind: sum(e.count for e in events if e.key in names) / n_steps
                    for kind, names in (("graph", GRAPH_LAUNCH), ("kernel", KERNEL_LAUNCH))}
    if "host_k" in eng.cache:
        tier_launches(eng, label)
    if drain:
        eng.run()
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched, which are events of their own
    rows = [e for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    if not rows:
        print(f"[{label}] profile: wall {wall_ms:.2f} ms/step; device time not "
              f"measured (the profiler saw no device activity); host launches/step: "
              f"{launch_calls['graph']:.2f} graph, {launch_calls['kernel']:.1f} kernel; {mix}")
        return
    print(f"[{label}] profile: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} "
          f"ms/step ({busy_ms / wall_ms:.0%}), {sum(e.count for e in rows) // n_steps} "
          f"device ops/step, host launches/step: {launch_calls['graph']:.2f} graph, "
          f"{launch_calls['kernel']:.1f} kernel; {mix}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
              f"{e.count / n_steps:7.1f}x  {e.key[:90]}")
    for e in rows:                   # every launch of the port's kernels, by kernel
        name = next((n for n in PORT_KERNELS if n in e.key), None)
        if name:
            print(f"[{label}] port kernel {name}: {e.self_device_time_total / 1e3 / n_steps:.4f}"
                  f" ms/step over {e.count / n_steps:.1f} launches/step "
                  f"({e.self_device_time_total / max(e.count, 1):.2f} us each)")


def tier_launches(eng, label: str) -> None:
    """The two paged calls of one layer of a tiered decode step, on the
    engine's current cache (layer 0, random bf16 queries): the hot window
    ``[cold_len, len)`` of the device pool and the cold prefix in the host
    pool.  Device time per call (:func:`_device_ms`: split and combine
    kernels), and the host's time per call (wrapper included) over 30
    back-to-back calls."""
    c, cfg = eng.cache, eng.model.cfg
    gen = torch.Generator(device=eng.device).manual_seed(7)
    q = torch.randn(len(eng.slots), cfg.n_heads, cfg.resolved_head_dim(), generator=gen,
                    device=eng.device).bfloat16()
    scales = "k_scale" in c

    def hot():
        return ops.paged_decode_attention(
            q, c["k"][0], c["v"][0], c["block_tables"], c["lengths"],
            starts=c["cold_lengths"], return_lse=True,
            k_scale=c["k_scale"][0] if scales else None,
            v_scale=c["v_scale"][0] if scales else None)

    def cold():
        return ops.paged_decode_attention(
            q, c["host_k"][0], c["host_v"][0], c["host_tables"], c["cold_lengths"],
            return_lse=True, k_scale=c["host_k_scale"][0] if scales else None,
            v_scale=c["host_v_scale"][0] if scales else None)

    def host_ms(fn, n=30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    cap = c["block_tables"].shape[1] * eng.block_size
    live = c["lengths"].clamp(max=cap)
    cold_n = int(c["cold_lengths"].sum())
    hot_n = int((live - c["cold_lengths"]).clamp(min=0).sum())
    dev = {k: _device_ms([fn]) for k, fn in (("hot", hot), ("cold", cold))}
    print(f"[{label}] tier launches (layer 0, this state): hot device {dev['hot']:.4f} ms "
          f"over {hot_n} positions, cold device {dev['cold']:.4f} ms over {cold_n} positions in "
          f"{int((c['cold_lengths'] > 0).sum())} slots; host per call {host_ms(hot):.4f} / "
          f"{host_ms(cold):.4f} ms; spills so far {eng.stats.spills}")


def _cpu(tree):
    """A parameter tree (nested dicts of tensors) copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _reduced_pair(dev, seeds=(3,), arch: str = "llama3.2-1b", **overrides):
    """Reduced ``arch`` in float32 (and ``overrides``) on the GPU and on the
    CPU, with the same weights for each seed: (gpu, cpu, [(gpu params,
    cpu params)])."""
    cfg = reduce_config(arch).with_overrides(dtype="float32", **overrides)
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    out = []
    for seed in seeds:
        p_gpu = gpu.init(seed=seed)
        out.append((p_gpu, _cpu(p_gpu)))
    return gpu, cpu, out


def reference_check(dev) -> None:
    """Reduced llama3.2-1b in float32: kernels on the GPU vs the plain path
    on the CPU, same weights.  Dense cache: prefill + 4 decode steps.
    Paged pool (bf16, fp8 and int8, the quantized ones also with a host
    tier holding spilled blocks): :func:`_paged_reference`.  Tolerance
    5e-2 on logits: the plain decode path rounds p to the bf16 cache dtype
    before P·V (as the JAX reference does), the kernels keep it in f32."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(1, gpu.cfg.vocab, (2, 29), generator=gen)
    caches = gpu.init_cache(2, 64), cpu.init_cache(2, 64)
    lg, _ = gpu.prefill(p_gpu, prompt.to(dev), caches[0])
    lc, _ = cpu.prefill(p_cpu, prompt, caches[1])
    worst = _max_err(lg.cpu(), lc)
    for _ in range(4):
        tok = lc.argmax(-1).to(torch.int32)
        lg, _ = gpu.decode_step(p_gpu, caches[0], tok.to(dev))
        lc, _ = cpu.decode_step(p_cpu, caches[1], tok)
        worst = max(worst, _max_err(lg.cpu(), lc))
    print(f"reference check, dense (reduced f32, GPU kernels vs CPU plain): "
          f"max |logit diff| {worst:.3e}")

    worst_paged = {f"{kv}{'+host' if host else ''}":
                   _paged_reference(dev, gpu, cpu, p_gpu, p_cpu, prompt, kv, host)
                   for kv, host in (("bf16", 0), ("fp8", 0), ("fp8", 4), ("int8", 0),
                                    ("int8", 4))}
    print("reference check, paged + chunked prefill (reduced f32, GPU kernels vs CPU "
          "plain): max |logit diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_paged.items()))
    if not (worst <= 5e-2 and max(worst_paged.values()) <= 5e-2):
        raise AssertionError(f"GPU vs CPU logits differ by {worst}, {worst_paged}")


def _paged_reference(dev, gpu, cpu, p_gpu, p_cpu, prompt, kv: str, host: int) -> float:
    """Two prompts in chunks of 16 through ``prefill_step`` into the two
    staging lanes, their blocks written (quantized when ``kv`` is fp8 or
    int8) into scrambled pool blocks, garbage in null block 0 of every
    pool; with ``host`` blocks, lane 0's first two blocks and lane 1's
    first spill to the host tier (cold lengths 16 and 8).  Then 4
    ``paged_decode_step``s.  Max |logit diff|, GPU kernels vs CPU plain."""
    bs, MB, N = 8, 8, 17
    tables = torch.zeros(2, MB, dtype=torch.int32)
    tables[0, :4] = torch.tensor([9, 2, 14, 5])       # 29 prompt + 4 decode positions
    tables[1, :3] = torch.tensor([16, 1, 11])          # 17 + 4
    lens, spilled = (29, 17), (2, 1)
    runs = []
    for model, params, d in ((gpu, p_gpu, dev), (cpu, p_cpu, torch.device("cpu"))):
        staging = model.init_cache(2, MB * bs)
        pool = model.init_paged_cache(2, N, bs, MB, kv_dtype=kv, host_blocks=host)
        for key in ("k", "v", "host_k", "host_v"):                # null-block garbage
            if key in pool:
                ref.byte_view(pool[key])[:, 0] = 50 if key.endswith("k") else 60
                if f"{key}_scale" in pool:
                    pool[f"{key}_scale"][:, 0] = 5.0
        logits = []
        for lane, n in enumerate(lens):
            for start in range(0, n, 16):
                nv = min(16, n - start)
                chunk = torch.zeros(1, 16, dtype=torch.int32)
                chunk[0, :nv] = prompt[lane, start:start + nv]
                lg, _ = model.prefill_step(params, staging, chunk.to(d), lane, start, nv)
            logits.append(lg)
            row = tables[lane].clone()
            for j in range(-(-n // bs)):
                pdev.write_prompt_block(pool, staging, int(row[j]), j * bs, lane)
            if host:
                host_row = torch.zeros(MB, dtype=torch.int32)
                for j in range(spilled[lane]):
                    host_row[j] = 1 + lane * 2 + j
                    pdev.spill_block(pool, int(row[j]), int(host_row[j]))
                    row[j] = 0
                pdev.sync_host_slot(pool, lane, host_row.numpy(), spilled[lane] * bs)
            pdev.sync_slot(pool, lane, row.numpy(), n)
        runs.append((model, params, pool, torch.cat(logits)))
    (gm, gp, gpool, glog), (cm_, cp, cpool, clog) = runs
    worst = _max_err(glog.cpu(), clog)
    for _ in range(4):
        tok = clog.argmax(-1).to(torch.int32)
        glog, _ = gm.paged_decode_step(gp, gpool, tok.to(dev))
        clog, _ = cm_.paged_decode_step(cp, cpool, tok)
        worst = max(worst, _max_err(glog.cpu(), clog))
    return worst


def preemption_check(dev) -> None:
    """Reduced llama3.2-1b on a pool too small for both sequences (8
    usable blocks of 4 tokens): the youngest is preempted and refolded.
    On the GPU, async (victim-only drain) and sync give the same greedy
    tokens, and the step clock equals the CPU engine's (it does not
    depend on token values)."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    prompts = [torch.arange(1, 10, dtype=torch.int32).numpy(),
               torch.arange(3, 8, dtype=torch.int32).numpy()]
    for schedule in ("decode-only", "hybrid"):
        runs = []
        for model, params, async_mode in ((gpu, p_gpu, True), (gpu, p_gpu, False),
                                          (cpu, p_cpu, False)):
            eng = Engine(model, params, n_slots=2, max_seq=32, cache_kind="paged",
                         block_size=4, n_blocks=9, schedule=schedule, prefill_chunk=8,
                         async_mode=async_mode)
            reqs = [Request(uid=i, prompt=p, max_new_tokens=10)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            runs.append((eng.run(), [r.out_tokens for r in reqs], eng.pool.in_use))
        (a, a_tok, a_use), (s_, s_tok, s_use), (c, _, _) = runs
        print(f"preemption check ({schedule}, GPU): preemptions={a.preemptions} "
              f"victim_drains={a.victim_drains} sync/async tokens equal: {a_tok == s_tok}")
        if not (a.preemptions >= 1 and a.victim_drains >= 1 and a_tok == s_tok
                and a_use == s_use == 0
                and (a.engine_steps, a.preemptions, a.decode_steps, a.prefill_chunks)
                == (s_.engine_steps, s_.preemptions, s_.decode_steps, s_.prefill_chunks)
                == (c.engine_steps, c.preemptions, c.decode_steps, c.prefill_chunks)):
            raise AssertionError(f"preemption check ({schedule}) failed: {a} / {s_} / {c}")


def host_tier_check(dev) -> None:
    """Reduced llama3.2-1b in float32 with a host tier (block 4, 8 usable
    device blocks, 8 host blocks), on the GPU, async and sync — the cases
    of ``tests/test_kv_tiering.py``:
    * two sequences that do not fit: live spills, no preemption, and the
      greedy tokens of an unspilled run (the hot/cold lse merge is exact);
    * a finished prompt's prefix spills at free time and re-hydrates for
      the same prompt, which continues identically;
    * a third prompt in the slot the first spilled from decodes as in an
      unspilled run (its cold window starts empty);
    and the step clock of each equals the CPU engine's."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    a, b, c = (torch.arange(lo, hi, dtype=torch.int32).numpy()
               for lo, hi in ((1, 10), (3, 8), (40, 49)))

    def run(model, params, prompts, n_slots=2, **kw):
        eng = Engine(model, params, n_slots=n_slots, max_seq=32, cache_kind="paged",
                     block_size=4, **kw)
        reqs = []
        for i, p in enumerate(prompts):          # one run() per prompt when n_slots == 1
            reqs.append(Request(uid=i, prompt=p, max_new_tokens=10))
            eng.submit(reqs[-1])
            if n_slots == 1:
                eng.run()
        st = eng.run()
        return st, [r.out_tokens for r in reqs], eng.pool.in_use

    for case, prompts, kw in (
            ("spill", [a, b], dict(n_blocks=9, host_blocks=8)),
            ("reuse", [a, b, c], dict(n_blocks=9, host_blocks=8)),
            ("rehydrate", [a, a], dict(n_slots=1, host_blocks=8))):
        _, base, _ = run(gpu, p_gpu, prompts, n_slots=kw.get("n_slots", 2))
        (st, toks, use), (st_s, toks_s, use_s), (st_c, _, _) = (
            run(m, p, prompts, async_mode=am, **kw)
            for m, p, am in ((gpu, p_gpu, True), (gpu, p_gpu, False), (cpu, p_cpu, False)))
        clock = [(x.engine_steps, x.decode_steps, x.spills, x.rehydrations, x.preemptions)
                 for x in (st, st_s, st_c)]
        print(f"host-tier check ({case}, GPU): spills={st.spills} "
              f"rehydrations={st.rehydrations} preemptions={st.preemptions}; tokens == "
              f"unspilled: {toks == base}, sync == async: {toks == toks_s}; step clock "
              f"async/sync/CPU {clock}")
        moved = st.rehydrations >= 2 if case == "rehydrate" else st.spills >= 1
        if not (moved and st.preemptions == 0 and toks == toks_s == base
                and use == use_s == 0 and clock[0] == clock[1] == clock[2]):
            raise AssertionError(f"host-tier check ({case}) failed: {clock}")


SPEC_COMBOS = {
    "dense/decode-only": {},
    "dense/hybrid": dict(schedule="hybrid", prefill_chunk=8),
    "paged/decode-only": dict(cache_kind="paged", block_size=8),
    "paged/hybrid": dict(cache_kind="paged", block_size=8, schedule="hybrid", prefill_chunk=8),
}


def spec_reference_check(dev) -> None:
    """Speculative decoding, reduced llama3.2-1b in float32 (depth 2): the
    engine on the GPU (async and sync) against the CPU engine, same
    weights, over {dense, paged} x {decode-only, hybrid} with a mismatched
    draft and with the target as its own draft: greedy tokens and the
    step clock (engine, spec and draft steps, drafted and accepted tokens,
    prefills, chunks) equal mode for mode (async dispatches windows past a
    finish that accepted drafts brought forward, so its clock may run
    ahead of sync's, in the reference too), and the tokens those of the
    GPU's plain run.  Then :func:`verify_reference_check`."""
    gpu, cpu, ((pt_g, pt_c), (pd_g, pd_c)) = _reduced_pair(dev, seeds=(3, 5))
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10, dtype=np.int32),
               np.arange(2, 13, dtype=np.int32), np.arange(4, 25, dtype=np.int32)]

    def run(model, params, **kw):
        eng = Engine(model, params, n_slots=2, max_seq=32, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        st = eng.run()
        clock = (st.engine_steps, st.spec_steps, st.draft_steps, st.drafted_tokens,
                 st.accepted_tokens, st.prefills, st.prefill_chunks, st.decode_steps)
        return [r.out_tokens for r in reqs], clock, st

    for combo, kw in SPEC_COMBOS.items():
        plain, _, _ = run(gpu, pt_g, **kw)
        for draft, (dg, dc) in (("mismatched", (pd_g, pd_c)), ("target", (pt_g, pt_c))):
            spec = dict(spec_depth=2, **kw)
            (ta, ca, sa), (ts, cs, _), (tca, cca, _), (tcs, ccs, _) = (
                run(m, p, async_mode=am, draft_model=m, draft_params=d, **spec)
                for m, p, d, am in ((gpu, pt_g, dg, True), (gpu, pt_g, dg, False),
                                    (cpu, pt_c, dc, True), (cpu, pt_c, dc, False)))
            ok = (ta == ts == tca == tcs == plain and ca == cca and cs == ccs
                  and sa.spec_steps >= 1)
            print(f"spec reference check ({combo}, {draft} draft): acceptance "
                  f"{sa.acceptance_rate:.3f}; tokens GPU async == sync == CPU == plain: "
                  f"{ta == ts == tca == tcs == plain}; step clock GPU/CPU async {ca} {cca}, "
                  f"sync {cs} {ccs}")
            if not ok:
                raise AssertionError(f"spec reference check ({combo}, {draft}) failed")
    verify_reference_check(dev, gpu, cpu, pt_g, pt_c)


def verify_reference_check(dev, gpu, cpu, p_gpu, p_cpu) -> None:
    """``verify_step`` and ``paged_verify_step`` on the GPU against the CPU
    (reduced float32, a window of 3): logits within the 5e-2 of
    :func:`reference_check`, lengths returned unchanged.  The dense
    window of slot 1 overshoots ``max_seq`` (16): those writes drop.  The
    paged window of slot 1 runs past its table: positions 12 and 13 land
    in null block 0, and no block but those the windows address changes."""
    cfg = gpu.cfg
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 3)).astype(np.int32))
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    dense_kv = torch.from_numpy(rng.standard_normal((2, L, 2, 16, Hkv, Dh), np.float32))
    pool_kv = torch.from_numpy(rng.standard_normal((2, L, 10, Hkv, 4, Dh), np.float32))
    tables = torch.tensor([[3, 7, 0], [5, 2, 9]], dtype=torch.int32)
    out = []
    for model, params, d in ((gpu, p_gpu, dev), (cpu, p_cpu, torch.device("cpu"))):
        dc = model.init_cache(2, 16)
        pc = model.init_paged_cache(2, 10, 4, 3)
        for i, key in enumerate(("k", "v")):
            dc[key].copy_(dense_kv[i])
            pc[key].copy_(pool_kv[i])
        dc["lengths"].copy_(torch.tensor([4, 14]))
        pc["lengths"].copy_(torch.tensor([3, 11]))
        pc["block_tables"].copy_(tables)
        ld, dc = model.verify_step(params, dc, toks.to(d))
        lp, pc = model.paged_verify_step(params, pc, toks.to(d))
        out.append((ld.cpu(), lp.cpu(), {k: v.cpu() for k, v in dc.items()},
                    {k: v.cpu() for k, v in pc.items()}))
    (ldg, lpg, dcg, pcg), (ldc, lpc, _, _) = out
    worst = max(_max_err(ldg, ldc), _max_err(lpg, lpc))
    changed = {key: {int(b) for b in torch.nonzero(
        (pcg[key].float() != pool_kv[i].bfloat16().float()).flatten(2).any(-1).any(0)
    ).flatten()} for i, key in enumerate(("k", "v"))}
    kept = bool(torch.equal(dcg["k"][:, 1, :14].float(),
                            dense_kv[0][:, 1, :14].bfloat16().float()))
    print(f"verify reference check (reduced f32, GPU vs CPU): max |logit diff| {worst:.3e}; "
          f"lengths {dcg['lengths'].tolist()} {pcg['lengths'].tolist()}; paged blocks "
          f"written {changed}; dense slot 1 below its length kept: {kept}")
    if not (worst <= 5e-2 and dcg["lengths"].tolist() == [4, 14]
            and pcg["lengths"].tolist() == [3, 11] and kept
            and changed == {"k": {0, 3, 7, 9}, "v": {0, 3, 7, 9}}):
        raise AssertionError("verify reference check failed")


def block128_check(dev) -> None:
    """``--block-size 128`` on the card: a reduced serve through
    ``repro_torch.launch.serve`` (bf16, paged, decode-only, prompts over
    one block) whose paged launches, at the block-128 shape key, number 2
    per decode step; then reduced float32 engines on the GPU (async and
    sync) against the CPU: greedy tokens and step clock equal."""
    flags = ["--reduced", "--requests", "6", "--slots", "3", "--max-seq", "512",
             "--max-new", "12", "--cache", "paged", "--block-size", "128",
             "--device", "cuda"]
    args = serve.build_parser().parse_args(flags)
    model, params = serve.load_model(args)
    ops.reset_launch_counts()
    res = serve.serve(args, model, params)
    cfg, st = model.cfg, res.stats
    key = ("unscaled", kernel_heads(cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                                    cfg.resolved_head_dim(), 128))
    got = ops.shape_counts()["paged_decode_attention"]
    print(f"block-128 serve (reduced, bf16): {serve.stats_line(args.requests, st)}; paged "
          f"launches {got}, expected {{{key}: {st.decode_steps * cfg.n_layers}}}")
    if not (got == {key: st.decode_steps * cfg.n_layers} and res.engine.pool.in_use == 0
            and all(r.done and len(r.out_tokens) == 12 for r in res.driver.submitted)):
        raise AssertionError("block-128 serve failed")
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    rng = np.random.default_rng(128)
    prompts = [rng.integers(1, gpu.cfg.vocab, n).astype(np.int32) for n in (150, 260, 90)]
    runs = []
    for m, p, am in ((gpu, p_gpu, True), (gpu, p_gpu, False), (cpu, p_cpu, False)):
        eng = Engine(m, p, n_slots=2, max_seq=512, cache_kind="paged", block_size=128,
                     async_mode=am)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=10) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        s_ = eng.run()
        runs.append(([r.out_tokens for r in reqs], (s_.engine_steps, s_.decode_steps)))
    print(f"block-128 reference check (reduced f32): tokens GPU async == sync == CPU: "
          f"{runs[0][0] == runs[1][0] == runs[2][0]}; step clocks {[c for _, c in runs]}")
    if not (runs[0] == runs[1] == runs[2]):
        raise AssertionError("block-128 reference check failed")


def _chi2(counts: torch.Tensor, expected: torch.Tensor) -> float:
    return float(((counts - expected) ** 2 / expected).sum())


def temperature_check(dev) -> None:
    """Sampling under graphs, reduced llama3.2-1b (bf16): the logits of 16
    random 12-token prompts (one whole-prompt prefill each) sampled at
    temperature 1, top-k 8, by a captured program (``sample_on_device``
    with its registered device generator, what every async graph runs):
    512 replays, then 512 eager draws from the same generator.
    Consecutive replays must draw different tokens (a generator the graph
    did not register would raise; one whose state the graph froze would
    repeat them); each set's per-row counts must fit the exact top-8
    distribution and the two sets each other (chi-square over 16 x 7
    degrees of freedom at least, bound: mean + 6 standard deviations).
    The support is what the sampler keeps: every token at or above a
    row's 8th largest logit (bf16 logits tie there).
    Then temperature runs of the engine through the graphs, plain and
    speculative, on the hybrid schedule: they complete, their replays
    ran, and no request repeats one token throughout."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    rng = np.random.default_rng(17)
    logits = torch.cat([m.prefill(params, torch.from_numpy(
        rng.integers(1, cfg.vocab, (1, 12))).to(dev), m.init_cache(1, 16))[0]
        for _ in range(16)]).float()
    sampler = SamplerConfig(temperature=1.0, top_k=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    prog = Program("sample", lambda inp: (sample_on_device(logits, gen, sampler),), {}, dev,
                   graphs=True, pool=torch.cuda.graph_pool_handle(), generators=(gen,))
    n = 512
    graph_draws = torch.stack([prog()[0].clone() for _ in range(n)])[1:]   # replays only
    eager_draws = torch.stack([sample_on_device(logits, gen, sampler) for _ in range(n - 1)])
    repeats = int((graph_draws[1:] == graph_draws[:-1]).all(dim=1).sum())
    keep = logits >= torch.topk(logits, 8, dim=-1).values[:, -1:]          # (16, V)
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)[keep]
    dof = int(keep.sum()) - 16
    bound = dof + 6 * (2 * dof) ** 0.5

    def counts(draws):
        return F.one_hot(draws.long(), logits.shape[-1]).sum(dim=0).float()   # (16, V)

    cg, ce = counts(graph_draws), counts(eager_draws)
    outside = int(cg[~keep].sum() + ce[~keep].sum())
    cg, ce = cg[keep], ce[keep]
    pooled = (cg + ce) / 2
    chi = {"graph": _chi2(cg, (n - 1) * probs), "eager": _chi2(ce, (n - 1) * probs),
           "graph vs eager": _chi2(cg, pooled) + _chi2(ce, pooled)}
    print(f"temperature check (reduced, T=1, top-k 8: {int(keep.sum())} kept tokens in 16 rows, "
          f"{n - 1} replays vs {n - 1} eager draws): consecutive replays equal {repeats}; "
          f"draws outside the kept tokens {outside}; chi-square (dof {dof}, bound {bound:.1f}) "
          + ", ".join(f"{k} {v:.1f}" for k, v in chi.items()))
    if repeats or outside or max(chi.values()) >= bound:
        raise AssertionError("temperature draws under graphs do not fit the distribution")
    prompts = [rng.integers(1, cfg.vocab, 10).astype(np.int32) for _ in range(6)]
    for label, extra in (("plain", {}), ("spec", dict(spec_depth=2, draft_model=m,
                                                      draft_params=m.init(5)))):
        eng = Engine(m, params, n_slots=3, max_seq=64, sampler=SamplerConfig(temperature=1.0),
                     schedule="hybrid", prefill_chunk=8, **extra)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=12) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        replays = {k: p.replays for k, p in eng.programs.items()}
        ok = (all(r.done and len(r.out_tokens) == 12 and len(set(r.out_tokens[1:])) > 1
                  for r in reqs) and sum(replays.values()) > 0)
        print(f"temperature serve through graphs ({label}): replays {replays}; "
              f"all complete, fresh tokens: {ok}")
        if not ok:
            raise AssertionError(f"temperature serve through graphs ({label}) failed")


def migration_check(dev) -> None:
    """KV block migration on the card, reduced llama3.2-1b (bf16): a
    request exported after two decode steps and imported into a second
    engine, for a bf16 pool and an fp8 pool with its scale pools.  The
    blocks the export gathers equal (``torch.equal`` on their bytes) the
    source's blocks, and the blocks the import lands equal the payload;
    decode on the destination gives the unmigrated run's tokens."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    prompt = np.random.default_rng(5).integers(1, cfg.vocab, 21).astype(np.int32)
    for kv in ("bf16", "fp8"):
        kw = dict(n_slots=2, max_seq=64, cache_kind="paged", block_size=4, kv_dtype=kv)
        solo = Engine(m, params, **kw)
        solo_req = Request(uid=0, prompt=prompt, max_new_tokens=8)
        solo.submit(solo_req)
        solo.run()
        src = Engine(m, params, **kw)
        req = Request(uid=0, prompt=prompt, max_new_tokens=8)
        src.submit(req)
        src.step()
        src.step()
        ids = list(src.manager.blocks[0])
        keys = ("k", "v", "k_scale", "v_scale") if kv == "fp8" else ("k", "v")
        before = {k: ref.byte_view(src.cache[k][:, ids]).clone() for k in keys}
        req, ticket, payload = src.export_request(0)
        dst = Engine(m, params, **kw)
        slot = dst.import_request(req, ticket, payload)
        landed = pdev.copy_blocks_out(dst.cache, dst.manager.blocks[slot][:ticket.n_blocks])
        gathered = all(torch.equal(ref.byte_view(payload[k]), before[k]) for k in keys)
        exact = all(torch.equal(ref.byte_view(landed[k]), ref.byte_view(payload[k]))
                    for k in keys)
        dst.run()
        torch.cuda.synchronize()
        print(f"migration check ({kv}, {ticket.n_blocks} blocks, leaves {sorted(payload)}): "
              f"gathered == source blocks {gathered}, landed == payload {exact}, tokens == "
              f"unmigrated run's {req.out_tokens == solo_req.out_tokens}")
        if not (gathered and exact and set(payload) == set(keys)
                and req.out_tokens == solo_req.out_tokens):
            raise AssertionError(f"migration check ({kv}) failed")


CLUSTER_COMBOS = {
    "1p+1d paged hybrid": dict(roles="1p+1d", cache_kind="paged", block_size=4,
                               schedule="hybrid", prefill_chunk=8),
    "1p+1d dense decode-only": dict(roles="1p+1d"),
    "2 mixed prefix_affinity paged hybrid": dict(route="prefix_affinity", cache_kind="paged",
                                                 block_size=4, schedule="hybrid",
                                                 prefill_chunk=8),
}


def cluster_reference_check(dev) -> None:
    """Reduced llama3.2-1b in float32, the same weights on the card and on
    the CPU: two-replica clusters (1P+1D paged hybrid, 1P+1D dense, two
    mixed replicas routed by prefix affinity), async and sync, the card's
    under CUDA graphs.  Tokens, ``ClusterStats`` and ``RouterStats`` equal
    the CPU cluster's exactly."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    rng = np.random.default_rng(23)
    doc = rng.integers(1, gpu.cfg.vocab, 12).astype(np.int32)
    prompts = [np.concatenate([doc, rng.integers(1, gpu.cfg.vocab, n).astype(np.int32)])
               if i % 2 else rng.integers(1, gpu.cfg.vocab, n + 4).astype(np.int32)
               for i, n in enumerate((3, 9, 5, 2, 7, 4, 1, 6))]
    for combo, kw in CLUSTER_COMBOS.items():
        for async_mode in (True, False):
            runs = []
            for m, p in ((gpu, p_gpu), (cpu, p_cpu)):
                cl = Cluster(m, p, 2, n_slots=3, max_seq=64, async_mode=async_mode, **kw)
                reqs = [Request(uid=i, prompt=x, max_new_tokens=6) for i, x in enumerate(prompts)]
                for r in reqs:
                    cl.submit(r)
                st = cl.run()
                runs.append(([r.out_tokens for r in reqs], dataclasses.asdict(st),
                             dataclasses.asdict(cl.router.stats)))
            (tg, sg, rg), (tc, sc, rc) = runs
            print(f"cluster reference check ({combo}, {'async' if async_mode else 'sync'}): "
                  f"rounds {sg['rounds']}, migrations {sg['migrations']}, prefix hit tokens "
                  f"{rg['prefix_hit_tokens']}; tokens, ClusterStats, RouterStats GPU == CPU: "
                  f"{tg == tc}, {sg == sc}, {rg == rc}")
            if not (tg == tc and sg == sc and rg == rc
                    and (sg["migrations"] > 0) == ("roles" in kw)):
                raise AssertionError(f"cluster reference check ({combo}) failed")


def sub_batch_check(dev) -> None:
    """``sub_batches=2`` at reduced size: bf16 under CUDA graphs (two
    stream branches in the decode graph) against the same engine eager,
    async and sync, tokens and step clock equal and the dense decode kernel
    twice per layer and step; float32 on the card against the CPU, tokens
    equal."""
    cfg = reduce_config("llama3.2-1b")
    m = build_model(cfg, dev)
    params = m.init(3)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (5, 3, 11, 21, 4, 9)]

    def run(model, p, **kw):
        eng = Engine(model, p, n_slots=4, max_seq=64, sub_batches=2, **kw)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=8) for i, x in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launch_counts()
        st = eng.run()
        return [r.out_tokens for r in reqs], st, ops.variant_counts()["decode_attention"], eng

    for async_mode in (True, False):
        (tg, sg, lg, eng), (te, se, le, _) = (run(m, params, graphs=g, async_mode=async_mode)
                                              for g in (True, False))
        want = {"unscaled": 2 * sg.decode_steps * cfg.n_layers}
        prog = eng.programs["decode"]
        # the plain engine whose decode batch is one sub-batch's 2 rows
        narrow = Engine(m, params, n_slots=2, max_seq=64, async_mode=async_mode)
        reqs = [Request(uid=i, prompt=x, max_new_tokens=8) for i, x in enumerate(prompts)]
        for r in reqs:
            narrow.submit(r)
        narrow.run()
        tn = [r.out_tokens for r in reqs]
        print(f"sub-batch check ({'async' if async_mode else 'sync'}, bf16): graphs vs eager "
              f"tokens equal {tg == te}, stats equal {sg == se}; tokens == a 2-slot engine's "
              f"{tg == tn}; decode launches {lg} (eager {le}, expected {want}); decode graph "
              f"{prog.calls} calls/{prog.replays} replays")
        if not (tg == te == tn and sg == se and lg == le == want and prog.graph is not None):
            raise AssertionError("sub-batch check: graphs, eager and the narrow engine differ")
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev)
    (tg, sg, _, _), (tc, sc, _, _) = run(gpu, p_gpu), run(cpu, p_cpu)
    print(f"sub-batch check (float32, GPU vs CPU): tokens equal {tg == tc}, stats equal "
          f"{sg == sc}")
    if not (tg == tc and sg == sc):
        raise AssertionError("sub-batch check: GPU and CPU differ")


# ---------------------------------------------------------------- MoE path
def moe_phase(dev, rows: dict[str, dict]) -> PathRun:
    """moonshot-v1-16b-a3b at full width and ``SERVE_LAYERS``' depth, on a
    card that holds nothing of the llama phases: its weights from seed 0
    as the serve CLI's ``load_model`` draws them (:func:`load_cut`; memory allocated before and after, the peak, the load
    seconds); one full-width MoE layer on the card against the CPU
    (:func:`moe_layer_check`); ``SERVE_FLAGS`` with ``--arch
    moonshot-v1-16b-a3b`` through :func:`serve_phase` (async through the
    CUDA graphs with the launch counters zeroed before it, ``--graphs
    off``, ``--async off``: tokens identical; the decode kernel once per
    layer of a decode step and the prefill kernel once per layer of a prefill, at
    moonshot's heads), its step clock held to the CPU's prediction
    (``MOE_CLOCK``), tok/s and wall ms per decode step beside the weight
    stream's bound; a ``--profile 8`` run's measured decode MBU (the
    reference's cost model counts the active experts only, the dropping
    dispatch streams all 64); and steady decode steps under
    ``torch.profiler`` with graphs and eagerly.  Returns the path's run
    without its engine."""
    t_phase = time.perf_counter()
    before = freed_card(dev, "moe")
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.build_parser().parse_args(SERVE_FLAGS + MOE_FLAGS)
    t0 = time.perf_counter()
    model, params = load_cut(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg, m = model.cfg, model.cfg.moe
    print(f"[moe] serve: {cfg.name} n_params={model.n_params()} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.resolved_head_dim()} experts={m.n_experts} top_k={m.top_k} "
          f"shared={m.n_shared} weights {load_s:.1f}s; memory allocated "
          f"{before / 1e9:.3f} GB before the load, {torch.cuda.memory_allocated(dev) / 1e9:.3f} "
          f"GB after, peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if model.n_params() != MOE_PARAMS:
        raise AssertionError(f"[moe] {model.n_params()} parameters, not {MOE_PARAMS}")
    moe_layer_check(model, params)
    L = cfg.n_layers
    run = serve_phase(model, params, "moe", MOE_FLAGS, lambda st: {
        "decode_attention[moe]": st.decode_steps * L,
        "prefill_attention[moe]": st.prefills * L}, rows, eager=True)
    st, res = run.stats, run.res
    clock = {k: getattr(st, k) for k in MOE_CLOCK}
    print(f"[moe] step clock {clock}, rounds {res.rounds}; the CPU's prediction {MOE_CLOCK}")
    if clock != MOE_CLOCK:
        raise AssertionError("[moe] the step clock is not the CPU's prediction")
    weight_bytes = 2 * model.n_params()
    kv_bytes = balance.kv_bytes_per_seq(cfg, 8115)
    bound_ms = (weight_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
    print(f"[moe] {st.generated / res.wall_s:.1f} tok/s, {res.wall_s * 1e3 / st.decode_steps:.3f} "
          f"wall ms per decode step (the run's wall over its {st.decode_steps} decode steps, "
          f"its 64 whole-prompt prefills included); bound per decode step: the weight stream "
          f"{weight_bytes / 1e9:.2f} GB in {weight_bytes / PEAK_BYTES_S * 1e3:.2f} ms + "
          f"{kv_bytes / 1e9:.2f} GB of KV at 8115 live positions = {bound_ms:.2f} ms, "
          f"{16e3 / bound_ms:.0f} tok/s at 16 rows")
    tokens = run.tokens
    run = run._replace(res=None)
    del res

    pargs = serve.build_parser().parse_args(SERVE_FLAGS + MOE_FLAGS
                                            + ["--profile", str(PROFILE_EVERY)])
    pres = serve.serve(pargs, model, params)
    for line in serve.telemetry_lines(pres):
        print(f"[moe profile] {line}")
    same = [r.out_tokens for r in pres.driver.submitted] == tokens
    decode = [s for s in pres.profiler.samples if s.kind == "decode"]
    top = max(max(s.measured_mfu, s.measured_mbu) for s in pres.profiler.samples)
    med = statistics.median(s.seconds for s in decode)
    active = balance._active_params(cfg)
    print(f"[moe] measured decode (--profile {PROFILE_EVERY}, graphs): {len(decode)} samples, "
          f"median {med * 1e3:.3f} ms, MBU "
          f"{statistics.median(s.measured_mbu for s in decode):.4f} against the cost model's "
          f"{2 * active / 1e9:.2f} GB of active weights ({active:.4e} active params); "
          f"the {weight_bytes / 1e9:.2f} GB the dropping dispatch streams at that median: "
          f"{weight_bytes / med / PEAK_BYTES_S:.4f} of {PEAK_BYTES_S / 1e12:.2f} TB/s; largest "
          f"share {top:.4f}; tokens as the unprofiled run's: {same}")
    if not same or top > MAX_SHARE:
        raise AssertionError("[moe] the profiled run differs, or a measured share > "
                             f"{MAX_SHARE}")
    del pres
    for graphs in (True, False):
        profile_phase(model, params, "moe", MOE_FLAGS, warm_steps=4, graphs=graphs,
                      n_steps=8 if graphs else 4, drain=False)
    print(f"[moe] phase wall {time.perf_counter() - t_phase:.1f}s (load, layer check, serve "
          "runs, profiles)")
    return run


def kvq_sensitivity(model, model_q, params) -> None:
    """One full-width decode step from one prefilled state: the first 16
    prompts of the serve workload, one per slot, prefilled into a bf16
    cache (the dense path) and an int8 one (``kv_quant``: the same prefill
    logits, bit for bit), then decoded from the bf16 cache, from that cache
    with every K/V value moved one bf16 ulp up or down at random (the size
    of a rounding difference), and from the int8 cache.  Prints each
    step's argmax agreement with the bf16 step's and its max |logit diff|
    over the max |logit|: the random-weight model amplifies any change of
    its cache, so the int8 cache's agreement reads against the 1-ulp
    yardstick's (the sub-batches path's 1-ulp GEMM differences move its
    tokens off the dense path's alike)."""
    dev, cfg = model.device, model.cfg
    arrivals = build_workload("random", 16, vocab=cfg.vocab, max_seq=1024, max_new=64, seed=0)
    bf16, int8 = model.init_cache(16, 1024), model_q.init_cache(16, 1024)
    first, same_prefill = [], True
    for i, a in enumerate(arrivals):
        prompt = torch.as_tensor(a.prompt[None], device=dev)
        lg, _ = model.prefill(params, prompt, kv_cache.slot_view(bf16, i))
        lq, _ = model_q.prefill(params, prompt, kv_cache.slot_view(int8, i))
        same_prefill &= torch.equal(lg, lq)
        first.append(lg.argmax(-1))
    tok = torch.cat(first).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(17)
    moved = {k: v.clone() for k, v in bf16.items()}
    for k in ("k", "v"):
        step = torch.randint(0, 2, moved[k].shape, generator=gen, device=dev,
                             dtype=torch.int16) * 2 - 1
        step *= moved[k] != 0           # zeros (past the lengths) stay: -1 is a NaN's bits
        moved[k] = (moved[k].view(torch.int16) + step).view(torch.bfloat16)
    base, _ = model.decode_step(params, {k: v.clone() for k, v in bf16.items()}, tok)
    out = {"1-ulp bf16 cache": model.decode_step(params, moved, tok)[0],
           "int8 cache": model_q.decode_step(params, int8, tok)[0]}
    scale = float(base.float().abs().max())
    print(f"[dense-kvq] one decode step from the same prefilled state (16 prompts; prefill "
          f"logits bf16 == int8 bit for bit: {same_prefill}), against the bf16 cache's: "
          + "; ".join(f"{k}: argmax equal {int((v.argmax(-1) == base.argmax(-1)).sum())}/16, "
                      f"max |logit diff| / max |logit| {_max_err(v, base) / scale:.4f}"
                      for k, v in out.items()))
    if not same_prefill:
        raise AssertionError("[dense-kvq] the int8 cache's prefill logits differ from bf16's")


def freed_card(dev, label: str) -> int:
    """Free what the previous phase left and print what the card still
    holds before ``label``'s full-width load: bytes allocated, and the
    blocks of 1 MiB or more by size.  The cuBLAS workspaces (one of 32 MiB
    per stream that ran a product) are released only when no captured
    graph is alive (``programs.release_workspaces``), so an engine that
    outlived its phase shows here.  Raises above ``MEM_FREED``."""
    gc.collect()
    released = programs.release_workspaces()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    blocks = collections.Counter(
        b["size"] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
        if b["state"] == "active_allocated" and b["size"] >= 1 << 20)
    print(f"[{label}] before the load: {held / 1e9:.3f} GB allocated; cuBLAS workspaces "
          f"released {released} (captured graphs alive: {programs.live_graphs()}); blocks "
          f"of 1 MiB or more still allocated (bytes: count) {dict(blocks) or 'none'}")
    if held > MEM_FREED:
        raise AssertionError(f"[{label}] {held / 1e9:.3f} GB still allocated before the load")
    return held


def wide_f32_check(dev, arch: str, tag: str | None = None, tol: dict = F32_WIDE,
                   **overrides) -> None:
    """``arch`` at full width cut to 2 layers (``overrides`` of its config
    beside), in float32 with TF32 off: seed-0 weights drawn on the card and
    copied to the CPU; a 24-token prefill and one decode step through the
    kernels (deepseek: its plain attention) on the card against the plain
    versions on the CPU (the encoder-decoder's prefill also encodes
    seeded random frames).  Argmax equal, and the logits within ``tol``."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"[{arch}] TF32 matmuls are on: the float32 check needs them off")
    t0 = time.perf_counter()
    cfg = get_config(arch).with_overrides(**{"n_layers": 2, **overrides}, dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    p_gpu = gpu.init(0)
    p_cpu = _cpu(p_gpu)
    prompt = torch.randint(1, cfg.vocab, (1, 24), generator=torch.Generator().manual_seed(12))
    caches = gpu.init_cache(1, 64), cpu.init_cache(1, 64)
    frames = None
    if cfg.frontend == "frames":
        frames = torch.randn(1, cfg.frontend_len, cfg.d_model,
                             generator=torch.Generator().manual_seed(14))
    lg, _ = gpu.prefill(p_gpu, prompt.to(dev), caches[0],
                        embeds=None if frames is None else frames.to(dev))
    lc, _ = cpu.prefill(p_cpu, prompt, caches[1], embeds=frames)
    err = {"prefill": _max_err(lg.cpu(), lc)}
    same = {"prefill": bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)))}
    tok = lc.argmax(-1).to(torch.int32)
    lg, _ = gpu.decode_step(p_gpu, caches[0], tok.to(dev))
    lc, _ = cpu.decode_step(p_cpu, caches[1], tok)
    err["decode"] = _max_err(lg.cpu(), lc)
    same["decode"] = bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)))
    print(f"[{tag or WIDE_TAGS[arch]}] float32 check (full width, 2 layers, TF32 off, card vs "
          "CPU): "
          f"argmax equal {same}, max |logit diff| prefill {err['prefill']:.3e} / decode "
          f"{err['decode']:.3e} (tol {tol}), max |logit| "
          f"{float(lc[:, :cfg.vocab].abs().max()):.3f}; "
          f"{time.perf_counter() - t0:.1f}s")
    if not (all(same.values()) and all(err[k] <= tol[k] for k in err)):
        raise AssertionError(f"[{arch}] float32 card and CPU differ: {err}, {same}")


def embeds_check(model, params) -> None:
    """internvl2-76b's stub frontend on the card: 256 embeddings
    ``E = embed[u]`` prepended to a 100-token prompt ``t`` must prefill
    exactly as the tokens ``u + t`` do (logits and cache bit for bit), the
    cache holding ``256 + len(t)`` positions."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(13)
    u = torch.randint(1, cfg.vocab, (1, cfg.frontend_len), generator=gen, device=dev)
    t = torch.randint(1, cfg.vocab, (1, 100), generator=gen, device=dev)
    a_logits, a = model.prefill(params, t, model.init_cache(1, 1024),
                                embeds=params["embed"][u.long()])
    b_logits, b = model.prefill(params, torch.cat([u, t], 1), model.init_cache(1, 1024))
    same = torch.equal(a_logits, b_logits) and all(torch.equal(a[k], b[k]) for k in a)
    print(f"[internvl] embeds check: prefill(t, embeds=embed[u]) == prefill(u + t) bit for bit "
          f"(logits and cache): {same}; lengths {a['lengths'].tolist()} == frontend_len "
          f"{cfg.frontend_len} + len(t) {t.shape[1]}")
    if not (same and a["lengths"].tolist() == [cfg.frontend_len + t.shape[1]]):
        raise AssertionError("[internvl] the embeds prefill differs from the tokens'")


def family_phase(dev, arch: str, rows: dict[str, dict]) -> dict[str, PathRun]:
    """One more dense architecture at full width on a freed card (memory
    before the load must be under ``MEM_FREED``): for minicpm-2b and
    yi-34b first :func:`wide_f32_check`; seeded random bf16 weights
    as the serve CLI's loader draws them (internvl2-76b and yi-34b at
    ``SERVE_LAYERS``' depth, :func:`load_cut`), memory before, after and at peak; the
    serve shape on the dense cache, decode-only, and (not internvl2-76b)
    paged-hybrid, through :func:`serve_phase` (yi-34b's paths also
    synchronously and its dense path eagerly: tokens equal), each with its
    launches per kernel row at the family's heads, its step clock against
    ``WIDE_CLOCK``, tok/s and wall ms per decode step beside the bound of
    the weight and KV streams;
    internvl2-76b's :func:`embeds_check`; a profile of steady dense
    decode steps under the graphs.  Returns the runs without engines."""
    t_phase = time.perf_counter()
    tag = WIDE_TAGS[arch]
    if arch in ("minicpm-2b", "yi-34b"):
        wide_f32_check(dev, arch)
    before = freed_card(dev, tag)
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.build_parser().parse_args(SERVE_FLAGS + ["--arch", arch])
    t0 = time.perf_counter()
    model, params = load_cut(args)
    torch.cuda.synchronize()
    cfg, L = model.cfg, model.cfg.n_layers
    print(f"[{tag}] serve: {cfg.name} n_params={model.n_params()} layers={L} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.resolved_head_dim()} vocab={cfg.vocab} (padded "
          f"{cfg.padded_vocab()}) weights {time.perf_counter() - t0:.1f}s; memory allocated "
          f"{before / 1e9:.3f} GB before the load, {torch.cuda.memory_allocated(dev) / 1e9:.3f} "
          f"GB after, peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if model.n_params() != WIDE_PARAMS[arch]:
        raise AssertionError(f"[{tag}] {model.n_params()} parameters, not {WIDE_PARAMS[arch]}")
    weight_bytes = 2 * model.n_params()
    kv_bytes = balance.kv_bytes_per_seq(cfg, 8115)
    bound_ms = (weight_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
    runs = {}
    paths = {tag: ([], lambda st: {f"decode_attention[{tag}]": st.decode_steps * L,
                                   f"prefill_attention[{tag}]": st.prefills * L})}
    if arch != "internvl2-76b":
        paths[f"{tag}-paged-hybrid"] = (PAGED_FLAGS, lambda st: {
            f"prefill_attention[{tag}-chunk]": st.prefill_chunks * L,
            f"paged_decode_attention[{tag}]": st.decode_steps * L})
    for label, (flags, want) in paths.items():
        kind = "dense" if label == tag else "paged-hybrid"
        run = serve_phase(model, params, label, ["--arch", arch] + flags, want, rows,
                          eager=kind == "dense" and arch in REPEAT_ARCHS,
                          sync=arch in REPEAT_ARCHS)
        st = run.stats
        want_clock = WIDE_CLOCK[arch, kind]
        clock = {k: getattr(st, k) for k in want_clock}
        print(f"[{label}] step clock {clock}, rounds {run.res.rounds}; the CPU's prediction "
              f"{want_clock}")
        if clock != want_clock:
            raise AssertionError(f"[{label}] the step clock is not the CPU's prediction")
        print(f"[{label}] {st.generated / run.res.wall_s:.1f} tok/s, "
              f"{run.res.wall_s * 1e3 / st.decode_steps:.3f} wall ms per decode step (the run's "
              f"wall over its {st.decode_steps} decode steps, prefills included); bound per "
              f"decode step: the weights {weight_bytes / 1e9:.2f} GB in "
              f"{weight_bytes / PEAK_BYTES_S * 1e3:.2f} ms + {kv_bytes / 1e9:.2f} GB of KV at "
              f"8115 live positions = {bound_ms:.2f} ms, {16e3 / bound_ms:.0f} tok/s at 16 rows")
        runs[label] = run._replace(res=None)
        del run
    if arch == "internvl2-76b":
        embeds_check(model, params)
    profile_phase(model, params, tag, ["--arch", arch], warm_steps=4, drain=False)
    print(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f}s (f32 check, load, serve "
          "runs, profile)")
    return runs


def moe_layer_check(model, params) -> None:
    """The first MoE layer of the loaded weights at full width, in float32,
    at T = 16 (a decode batch: capacity 6 rows per expert) on random
    inputs: its ``router_scores`` and ``moe_ffn`` on the card against the
    CPU.  The expert ids must be equal, the output within
    ``MOE_LAYER_TOL`` (TF32 off: full f32 products on both)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[moe] TF32 matmuls are on: the float32 check needs them off")
    cfg = model.cfg.with_overrides(dtype="float32")
    keys = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")
    p_gpu = {k: params["moe_blocks"][k][0].float() for k in keys}
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(11))
    (wg, ig), (wc, ic) = (moe_mod.router_scores(cfg, p["router"], t)
                          for p, t in ((p_gpu, x.to(model.device)), (p_cpu, x)))
    yg, yc = (moe_mod.moe_ffn(cfg, p, t) for p, t in ((p_gpu, x.to(model.device)), (p_cpu, x)))
    _, (_, _, dropped) = moe_mod.dispatch(cfg, x, ic)
    err = _max_err(yg.cpu(), yc)
    print(f"[moe] layer check (moe_blocks[0], float32, T=16, capacity "
          f"{moe_mod.capacity(cfg, 16)}): expert ids card == CPU {torch.equal(ig.cpu(), ic)}, "
          f"router weights max diff {_max_err(wg.cpu(), wc):.2e}, output max |diff| {err:.2e} "
          f"(tol {MOE_LAYER_TOL}, output max |y| {float(yc.abs().max()):.3f}), "
          f"{int(dropped.sum())} of {dropped.numel()} assignments dropped")
    if not (torch.equal(ig.cpu(), ic) and err <= MOE_LAYER_TOL):
        raise AssertionError("[moe] the MoE layer differs between the card and the CPU")


def _engines_equal(label: str, gpu, cpu, p_gpu, p_cpu, combos: dict[str, dict]) -> None:
    """Engines of the same float32 weights on the card (graphs) and on the
    CPU, async and sync, for each combination of engine keywords in
    ``combos``: tokens and ``EngineStats`` equal."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, gpu.cfg.vocab, n).astype(np.int32)
               for n in (5, 3, 11, 21, 4, 9, 30, 2)]
    for name, kw in combos.items():
        for async_mode in (True, False):
            runs = []
            for m, p in ((gpu, p_gpu), (cpu, p_cpu)):
                eng = Engine(m, p, n_slots=4, max_seq=64, async_mode=async_mode, **kw)
                reqs = [Request(uid=i, prompt=x, max_new_tokens=8)
                        for i, x in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                runs.append(([r.out_tokens for r in reqs], eng.run()))
            (tg, sg), (tc, sc) = runs
            print(f"{label} reference check ({'async' if async_mode else 'sync'}, {name}, "
                  f"float32, GPU kernels vs CPU plain): tokens equal {tg == tc}, stats equal "
                  f"{sg == sc}; decode steps {sg.decode_steps}")
            if not (tg == tc and sg == sc):
                raise AssertionError(f"{label} reference check: the card and the CPU differ")


def moe_reference_check(dev) -> None:
    """Reduced moonshot-v1-16b-a3b in float32, the same weights on the card
    and on the CPU: engines async (the card's under CUDA graphs) and sync
    at ``sub_batches`` 1 and 2, tokens and ``EngineStats`` equal."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev, arch="moonshot-v1-16b-a3b")
    _engines_equal("moe", gpu, cpu, p_gpu, p_cpu,
                   {"sub_batches 1": {}, "sub_batches 2": dict(sub_batches=2)})


def wide_reference_check(dev) -> None:
    """Float32 engines on the card (graphs) and on the CPU, async and sync,
    tokens and ``EngineStats`` equal: reduced minicpm-2b (G 1 even reduced:
    as many KV heads as query heads) on the dense cache and on the paged
    pool with the hybrid schedule; reduced llama3.2-1b with ``kv_quant``
    (int8 K/V, bf16 scales) on the dense cache at one and two
    sub-batches."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev, arch="minicpm-2b")
    if gpu.cfg.n_kv_heads != gpu.cfg.n_heads:
        raise AssertionError("reduced minicpm-2b should keep G 1")
    _engines_equal("minicpm", gpu, cpu, p_gpu, p_cpu, {
        "dense": {}, "paged-hybrid": dict(cache_kind="paged", block_size=8,
                                          schedule="hybrid", prefill_chunk=8)})
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev, kv_quant=True)
    _engines_equal("dense-kvq", gpu, cpu, p_gpu, p_cpu,
                   {"sub_batches 1": {}, "sub_batches 2": dict(sub_batches=2)})


# ----------------------------------------------------------- DeepSeek path
def mla_identity_check(model, params) -> None:
    """The MLA identity at full width on the card, in float32 (TF32 off):
    the absorbed decode (W_UK folded into the query, attention over the
    latent, then W_UV) against expanding per-head K and V from the latent
    and attending, with layer 0's W_UK / W_UV, random latents, rope keys
    and queries at the serve shape (16 rows, 1024 positions, the kernel
    phase's lengths).  Within ``MLA_IDENTITY_TOL`` of the largest output."""
    cfg, dev, a = model.cfg, model.device, model.cfg.mla
    B, S, H = 16, 1024, cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(19)
    w_uk, w_uv = (params["dense_blocks"][k][0].float() for k in ("w_uk", "w_uv"))
    ckv, krope, q_nope, q_rope = (
        torch.randn(shape, generator=gen, device=dev)
        for shape in ((B, S, a.kv_lora_rank), (B, S, a.qk_rope_head_dim),
                      (B, H, a.qk_nope_head_dim), (B, H, a.qk_rope_head_dim)))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)
    kf = torch.cat([torch.einsum("bsr,rhk->bshk", ckv, w_uk),
                    krope[:, :, None].expand(B, S, H, a.qk_rope_head_dim)], -1)
    vf = torch.einsum("bsr,rhk->bshk", ckv, w_uv)
    expected = attn_mod.decode_attention(torch.cat([q_nope, q_rope], -1), kf, vf,
                                               lengths, scale=scale)
    del kf, vf
    lat = offload.mla_decode_attention(torch.einsum("bhn,rhn->bhr", q_nope, w_uk), q_rope,
                                       ckv, krope, lengths, scale=scale)
    got = torch.einsum("bhr,rhn->bhn", lat, w_uv)
    err, top = _max_err(got, expected), float(expected.abs().max())
    print(f"[deepseek] MLA identity (full width, float32, B={B} S={S} H={H}, "
          f"{int(lengths.clamp(max=S).sum())} live positions): absorbed vs expanded max "
          f"|diff| {err:.3e}, max |out| {top:.3f} (tol {MLA_IDENTITY_TOL} of it)")
    if not err <= MLA_IDENTITY_TOL * top:
        raise AssertionError("[deepseek] the absorbed MLA decode differs from the expanded one")


def ds_moe_layer_check(model, params) -> None:
    """The first MoE layer of the loaded weights, in float32 on the card
    against the CPU, at T = 16 (a decode batch) on random inputs: at full
    width (256 experts) the router (top-8 ids equal, weights within 1e-6)
    and the dropping dispatch (rows, drops and buffers equal); the whole
    ``moe_ffn`` (router, dispatch, expert products, combine, shared expert)
    on the first ``DS_EXPERT_SLICE`` experts, within ``MOE_LAYER_TOL``."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[deepseek] TF32 matmuls are on: the float32 check needs them off")
    dev = model.device
    cfg = model.cfg.with_overrides(dtype="float32")
    layer = {k: v[0] for k, v in params["moe_blocks"].items()}
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(11))
    router = layer["router"].float()
    (wg, ig), (wc, ic) = (moe_mod.router_scores(cfg, r, t)
                          for r, t in ((router, x.to(dev)), (router.cpu(), x)))
    (dg, mg), (dc, mc) = (moe_mod.dispatch(cfg, t, i) for t, i in ((x.to(dev), ig), (x, ic)))
    same_dispatch = (torch.equal(dg.cpu()[:, :-1], dc[:, :-1])
                     and all(torch.equal(g.cpu(), c) for g, c in zip(mg, mc)))
    E = min(DS_EXPERT_SLICE, cfg.moe.n_experts)
    sliced = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, n_experts=E))
    p_gpu = {k: (v[..., :E] if k == "router" else v[:E] if k.startswith("we_") else v).float()
             for k, v in layer.items() if k == "router" or k.startswith(("we_", "ws_"))}
    p_cpu = _cpu(p_gpu)
    (_, sg), (_, sc) = (moe_mod.router_scores(sliced, p["router"], t)
                        for p, t in ((p_gpu, x.to(dev)), (p_cpu, x)))
    yg, yc = (moe_mod.moe_ffn(sliced, p, t) for p, t in ((p_gpu, x.to(dev)), (p_cpu, x)))
    err = _max_err(yg.cpu(), yc)
    print(f"[deepseek] MoE layer check (moe_blocks[0], float32, T=16): full width, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, capacity "
          f"{moe_mod.capacity(cfg, 16)}: expert ids card == CPU {torch.equal(ig.cpu(), ic)}, "
          f"router weights max diff {_max_err(wg.cpu(), wc):.2e}, dispatch rows, drops and "
          f"buffers equal {same_dispatch} ({int(mc[2].sum())} of {mc[2].numel()} assignments "
          f"dropped); moe_ffn on the first {E} experts (capacity {moe_mod.capacity(sliced, 16)}"
          f"): expert ids equal {torch.equal(sg.cpu(), sc)}, output max |diff| {err:.2e} "
          f"(tol {MOE_LAYER_TOL}, max |y| {float(yc.abs().max()):.3f})")
    if not (torch.equal(ig.cpu(), ic) and _max_err(wg.cpu(), wc) <= 1e-6 and same_dispatch
            and torch.equal(sg.cpu(), sc) and err <= MOE_LAYER_TOL):
        raise AssertionError("[deepseek] the MoE layer differs between the card and the CPU")


def mla_decode_timing(model) -> float:
    """The absorbed MLA decode of one layer (``offload.mla_decode_attention``,
    plain torch: the reference has no Pallas kernel for it) at the serve
    shape: 16 rows, bf16 queries and latent cache of 1024 positions, the
    kernel phase's 8115 live positions.  Device time, device ops per call,
    and the bound: the whole cache read once (the plain version reads every
    position; the live ones alone beside it), queries read and output
    written once.  Beside it, ``scaled_dot_product_attention`` over the
    latent as one K/V head shared by every query head (never used by the
    port), checked to compute the same.  Returns the device ms."""
    cfg, dev, a = model.cfg, model.device, model.cfg.mla
    B, S, H, Dc, Dr = 16, 1024, cfg.n_heads, a.kv_lora_rank, a.qk_rope_head_dim
    gen = torch.Generator(device=dev).manual_seed(21)
    q_lat, q_rope, ckv, krope = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                                 for shape in ((B, H, Dc), (B, H, Dr), (B, S, Dc), (B, S, Dr)))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(a.qk_nope_head_dim + Dr)

    def mla():
        return offload.mla_decode_attention(q_lat, q_rope, ckv, krope, lengths, scale=scale)

    q = torch.cat([q_lat, q_rope], -1)[:, :, None]
    k = torch.cat([ckv, krope], -1)[:, None].expand(B, H, S, Dc + Dr)
    v = ckv[:, None].expand(B, H, S, Dc)
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None, None]

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)[:, :, 0]

    out = mla()
    lib_err = _max_err(library(), out)
    ms, lib_ms = _device_ms([mla]), _device_ms([library], 10)
    calls = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            mla()
        torch.cuda.synchronize()
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    ops_per_call = (f"{n_ops / calls:.0f} device ops per call" if n_ops else
                    "device ops per call not measured (the profiler saw no device activity)")
    io = (q_lat.numel() + q_rope.numel() + out.numel()) * 2
    live = int(lengths.clamp(max=S).sum())
    whole, live_bytes = B * S * (Dc + Dr) * 2 + io, live * (Dc + Dr) * 2 + io
    flops = 2 * H * live * (2 * Dc + Dr)
    bound_ms, by = _bound(whole, flops, PEAK_BF16_FLOPS)
    print(f"[deepseek] MLA decode (one layer, plain torch, B={B} H={H} S={S} Dc={Dc} Dr={Dr}, "
          f"bf16): {ms:.4f} ms device, {ops_per_call}; bound {bound_ms:.4f} "
          f"ms ({by}: {whole / 1e6:.1f} MB, the whole cache; the {live} live positions "
          f"{live_bytes / 1e6:.1f} MB: {live_bytes / PEAK_BYTES_S * 1e3:.4f} ms; "
          f"{flops / 1e9:.2f} GFLOP: {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms); SDPA over the "
          f"latent as one shared K/V head {lib_ms:.4f} ms (max |diff| {lib_err:.2e}, tol "
          f"{BF16_TOL})")
    if lib_err > BF16_TOL:
        raise AssertionError("[deepseek] SDPA over the latent differs from the MLA decode")
    return ms


def mla_prefill_timing(model) -> None:
    """The expanded MLA's prefill attention of one layer
    (``attention.chunked_attention``, plain torch, f32 inside: no flash
    kernel takes q/k head dim 192 beside v 128) at a 509-token prompt,
    bf16 in and out: event time against its bound (q, k, v read and the
    output written once; the causal half of the products) and against
    causal ``scaled_dot_product_attention`` on the same inputs (never used
    by the port), checked to compute the same."""
    cfg, dev, a = model.cfg, model.device, model.cfg.mla
    S, H, Dqk, Dv = 509, cfg.n_heads, a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    gen = torch.Generator(device=dev).manual_seed(27)
    q, k, v = (torch.randn(1, S, H, d, generator=gen, device=dev).bfloat16()
               for d in (Dqk, Dqk, Dv))
    scale = 1.0 / math.sqrt(Dqk)

    def plain():
        return attn_mod.chunked_attention(q, k, v, causal=True, scale=scale)

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              scale=scale).transpose(1, 2)

    err = _max_err(library(), plain())
    # event time over back-to-back calls, host included: the plain version
    # makes its int q_offset a device tensor, a copy from pageable memory
    # that waits for the device, so no call can be queued ahead of it
    ms, lib_ms = _time_ms([plain], 10), _time_ms([library], 10)
    nbytes = (2 * q.numel() + 2 * v.numel()) * 2
    flops = 2 * H * (S * (S + 1) // 2) * (Dqk + Dv)
    bound_ms, by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    print(f"[deepseek] MLA prefill attention (one layer, plain chunked, Sq=Sk={S} H={H} q/k "
          f"D {Dqk} v D {Dv}, bf16): {ms:.4f} ms (events, host included); bound {bound_ms:.4f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); causal SDPA {lib_ms:.4f} ms "
          f"(max |diff| {err:.2e}, tol {BF16_TOL})")
    if err > BF16_TOL:
        raise AssertionError("[deepseek] SDPA differs from the plain MLA prefill attention")


def expert_bmm_timing(model, params) -> float:
    """The three expert ``bmm``s of one MoE layer at a decode batch's shape
    (16 tokens routed top-8 over 256 experts: capacity 8, 9 rows each),
    device time, against their weight stream.  Returns the device ms."""
    cfg, dev = model.cfg, model.device
    p = {k: v[0] for k, v in params["moe_blocks"].items()}
    x = torch.randn(16, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(23),
                    device=dev).bfloat16()
    disp, _ = moe_mod.dispatch(cfg, x, moe_mod.router_scores(cfg, p["router"], x)[1])

    def experts():
        h = F.silu(torch.bmm(disp, p["we_gate"])) * torch.bmm(disp, p["we_up"])
        return torch.bmm(h, p["we_down"])

    ms = _device_ms([experts], 10)
    nbytes = sum(p[k].numel() for k in ("we_gate", "we_up", "we_down")) * 2
    print(f"[deepseek] expert bmms of one MoE layer (disp {tuple(disp.shape)}): {ms:.3f} ms "
          f"device, {nbytes / 1e9:.2f} GB of experts at {nbytes / ms / 1e9:.2f} TB/s (bound "
          f"{nbytes / PEAK_BYTES_S * 1e3:.3f} ms)")
    return ms


def deepseek_phase(dev) -> PathRun:
    """deepseek-v3-671b at full width, cut to ``DS_LAYERS`` layers (its 3
    dense layers and its first MoE layer: every kind of layer and the
    dense-to-MoE transition), on a card that holds nothing of the phases before:
    first the float32 check at full width cut to its 2 first (dense MLA)
    layers, card against CPU (:func:`wide_f32_check`); seed-0 bf16 weights
    drawn on the card (memory allocated before and after, the peak, the
    load seconds); the MLA identity (:func:`mla_identity_check`) and the
    MoE layer in float32 (:func:`ds_moe_layer_check`); ``SERVE_FLAGS``
    with ``--arch deepseek-v3-671b`` through :func:`serve_phase` (async
    through the CUDA graphs with the launch counters zeroed, ``--graphs
    off``, ``--async off``: tokens identical, and none of the three
    attention kernels launched: prefill runs the plain chunked attention at
    q/k head dim 192, decode the plain absorbed MLA), its step clock held to
    ``DS_CLOCK``, tok/s and wall ms per decode step beside the bound of the
    weights a step reads and the latent cache; the per-step f32 cast of
    W_O; a ``--profile 8`` run's measured decode MBU (the cost model counts
    the active experts, the dropping dispatch streams all 256); steady
    decode steps under ``torch.profiler`` with graphs, the expert bmms'
    and the MLA decode's device time (:func:`expert_bmm_timing`,
    :func:`mla_decode_timing`) and the prefill attention's
    (:func:`mla_prefill_timing`).  Returns the path's run without its
    engine."""
    t_phase = time.perf_counter()
    full = get_config("deepseek-v3-671b")
    wide_f32_check(dev, full.name, "deepseek", mtp_depth=0,
                   moe=dataclasses.replace(full.moe, moe_layer_start=2))
    before = freed_card(dev, "deepseek")
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.build_parser().parse_args(SERVE_FLAGS + DS_FLAGS)
    t0 = time.perf_counter()
    model = build_model(full.with_overrides(n_layers=DS_LAYERS), dev)
    params = model.init(args.seed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg, m, a, L = model.cfg, model.cfg.moe, model.cfg.mla, model.cfg.n_layers
    print(f"[deepseek] serve: {cfg.name} n_params={model.n_params()} layers={L} "
          f"({m.moe_layer_start} dense, {L - m.moe_layer_start} MoE; of {full.n_layers}) "
          f"d_model={cfg.d_model} heads={cfg.n_heads} q/k head dim "
          f"{a.qk_nope_head_dim}+{a.qk_rope_head_dim} v {a.v_head_dim} latent "
          f"{a.kv_lora_rank}+{a.qk_rope_head_dim} experts={m.n_experts} top_k={m.top_k} "
          f"shared={m.n_shared} weights {load_s:.1f}s; memory allocated "
          f"{before / 1e9:.3f} GB before the load, {torch.cuda.memory_allocated(dev) / 1e9:.3f} "
          f"GB after, peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if model.n_params() != DS_PARAMS:
        raise AssertionError(f"[deepseek] {model.n_params()} parameters, not {DS_PARAMS}")
    mla_identity_check(model, params)
    ds_moe_layer_check(model, params)
    run = serve_phase(model, params, "deepseek", DS_FLAGS, lambda st: {}, {}, eager=True)
    counts = ops.launch_counts()
    print(f"[deepseek] attention kernel launches over the eager and sync runs: {counts} "
          "(the async run's are checked by serve_phase: none expected)")
    if any(counts.values()):
        raise AssertionError("[deepseek] an attention kernel launched on the MLA path")
    st, res = run.stats, run.res
    clock = {k: getattr(st, k) for k in DS_CLOCK}
    print(f"[deepseek] step clock {clock}, rounds {res.rounds}; the CPU's prediction {DS_CLOCK}")
    if clock != DS_CLOCK:
        raise AssertionError("[deepseek] the step clock is not the CPU's prediction")
    defs = model.param_defs
    # a decode step reads every weight but the embedding table (16 rows of it)
    # and the MTP block (serving never runs it)
    stream = 2 * (model.n_params() - cm.count_params(defs["mtp"])
                  - math.prod(defs["embed"].shape))
    kv_bytes = balance.kv_bytes_per_seq(cfg, 8115)
    bound_ms = (stream + kv_bytes) / PEAK_BYTES_S * 1e3
    print(f"[deepseek] {st.generated / res.wall_s:.1f} tok/s, "
          f"{res.wall_s * 1e3 / st.decode_steps:.3f} wall ms per decode step (the run's wall "
          f"over its {st.decode_steps} decode steps, its 64 whole-prompt prefills included); "
          f"bound per decode step: the weights read {stream / 1e9:.2f} GB in "
          f"{stream / PEAK_BYTES_S * 1e3:.2f} ms + {kv_bytes / 1e9:.4f} GB of latent cache at "
          f"8115 live positions = {bound_ms:.2f} ms, {16e3 / bound_ms:.0f} tok/s at 16 rows")
    tokens = run.tokens
    run = run._replace(res=None)
    del res
    wo = params["dense_blocks"]["wo"][0]
    cast_ms = _device_ms([lambda: wo.float()], 10)
    print(f"[deepseek] W_O's f32 cast per layer and step (the reference's f32 output product; "
          f"kept over an f32 copy at load, which would hold {L * wo.numel() * 4 / 1e9:.2f} GB "
          f"more): {cast_ms:.4f} ms device ({wo.numel() * 6 / 1e9:.3f} GB moved), x {L} layers "
          f"= {cast_ms * L:.3f} ms per decode step")

    pargs = serve.build_parser().parse_args(SERVE_FLAGS + DS_FLAGS
                                            + ["--profile", str(PROFILE_EVERY)])
    pres = serve.serve(pargs, model, params)
    for line in serve.telemetry_lines(pres):
        print(f"[deepseek profile] {line}")
    same = [r.out_tokens for r in pres.driver.submitted] == tokens
    decode = [s for s in pres.profiler.samples if s.kind == "decode"]
    top = max(max(s.measured_mfu, s.measured_mbu) for s in pres.profiler.samples)
    med = statistics.median(s.seconds for s in decode)
    active = balance._active_params(cfg)
    print(f"[deepseek] measured decode (--profile {PROFILE_EVERY}, graphs): {len(decode)} "
          f"samples, median {med * 1e3:.3f} ms, MBU "
          f"{statistics.median(s.measured_mbu for s in decode):.4f} against the cost model's "
          f"{2 * active / 1e9:.2f} GB of active weights ({active:.4e} active params); the "
          f"{stream / 1e9:.2f} GB a step really reads at that median: "
          f"{stream / med / PEAK_BYTES_S:.4f} of {PEAK_BYTES_S / 1e12:.2f} TB/s; largest share "
          f"{top:.4f}; tokens as the unprofiled run's: {same}")
    if not same or top > MAX_SHARE:
        raise AssertionError("[deepseek] the profiled run differs, or a measured share > "
                             f"{MAX_SHARE}")
    del pres
    profile_phase(model, params, "deepseek", DS_FLAGS, warm_steps=4, drain=False)
    bmm_ms = expert_bmm_timing(model, params)
    mla_ms = mla_decode_timing(model)
    mla_prefill_timing(model)
    print(f"[deepseek] per decode step: expert bmms {bmm_ms * (L - m.moe_layer_start):.3f} ms "
          f"({L - m.moe_layer_start} MoE layers), MLA decode {mla_ms * L:.4f} ms ({L} layers), "
          f"W_O casts {cast_ms * L:.3f} ms")
    print(f"[deepseek] phase wall {time.perf_counter() - t_phase:.1f}s (f32 check, load, "
          "checks, serve runs, profiles)")
    return run


def deepseek_reference_check(dev) -> None:
    """Reduced deepseek-v3-671b in float32, the same weights on the card and
    on the CPU: engines async (the card's under CUDA graphs) and sync at
    ``sub_batches`` 1 and 2, tokens and ``EngineStats`` equal."""
    gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev, arch="deepseek-v3-671b")
    _engines_equal("deepseek", gpu, cpu, p_gpu, p_cpu,
                   {"sub_batches 1": {}, "sub_batches 2": dict(sub_batches=2)})

def _profiled_busy_ms(fn, n: int = 3) -> float:
    """Device-busy ms of one call of ``fn`` (device-side events under
    ``torch.profiler``, over ``n`` calls after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def scan_timing(model, tag: str) -> None:
    """One layer's recurrence as the serve path runs it, on seeded random f32
    inputs of the layer's shapes: the WKV scan (rwkv6) or the SSD scan
    (zamba2), at a 16-row decode step (S 1) and over a 509-token prompt
    (B 1).  Device time (at S 1 the calls queued behind a spin kernel; the
    prompt's ~1500 launches overflow the device's launch queue, so there
    the device-busy time under ``torch.profiler``), event time over
    back-to-back calls (the host's, once it is slower), and the bound:
    each input read once, the output and the state written once, the
    operations (5 per state element and step: the read-out's 2, the
    update's 3) at the f32 CUDA-core peak."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(29)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for B, S in ((16, 1), (1, 509)):
        if tag == "rwkv6":
            H, N = rwkv6_mod._dims(cfg)
            w = torch.rand(B, S, H, N, generator=gen, device=dev)     # decays in (0, 1)
            args = (rnd(B, S, H, N), rnd(B, S, H, N), rnd(B, S, H, N), w,
                    rnd(H, N, scale=0.1), rnd(B, H, N, N, scale=0.1))
            fn, name = functools.partial(rwkv6_mod._wkv_scan, *args), "WKV scan"
            ins, outs, state = 4 * B * S * H * N + H * N, B * S * H * N, B * H * N * N
        else:
            _, H, _, _ = mamba2_mod.dims(cfg)
            P, N = cfg.ssm.d_head, cfg.ssm.d_state
            dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.1
            args = (rnd(B, S, H, P), rnd(B, S, H, N), rnd(B, S, H, N), dt,
                    -torch.rand(H, generator=gen, device=dev), rnd(B, H, P, N, scale=0.1))
            fn, name = functools.partial(mamba2_mod._ssd_scan, *args), "SSD scan"
            ins, outs, state = B * S * H * (P + 2 * N + 1) + H, B * S * H * P, B * H * P * N
        nbytes = 4 * (ins + outs + 2 * state)
        flops = 5 * S * state
        bound_ms, bound_by = _bound(nbytes, flops, PEAK_F32_FLOPS)
        if S == 1:
            dev_ms, event_ms = _device_ms([fn]), _time_ms([fn])
        else:   # more launches than the device's queue holds: none can wait behind a spin
            dev_ms, event_ms = _profiled_busy_ms(fn), _time_ms([fn], 3)
        print(f"[{tag}] one layer's {name} at B={B} S={S} (f32): {dev_ms:.4f} ms device"
              f"{'' if S == 1 else ' busy (torch.profiler)'}, {event_ms:.4f} ms event time "
              f"(the host's, once it is slower); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP); {dev_ms / bound_ms:.1f}x the "
              f"bound; x {cfg.n_layers} layers = {dev_ms * cfg.n_layers:.3f} ms device")


def recurrent_phase(dev, arch: str, rows: dict[str, dict]) -> PathRun:
    """rwkv6-7b or zamba2-1.2b at full width and ``SERVE_LAYERS``' depth on a freed card:
    first the float32 check at full width cut to 2 layers, card against
    CPU (:func:`wide_f32_check`; zamba2 at a shared-block period of 2, so
    that its second layer is followed by the shared block and both kernels
    run with f32 queries); seed-0 bf16 weights through the serve CLI's
    loader (memory before and after, the peak); the serve shape on the
    dense state cache, decode-only, through :func:`serve_phase` (async
    through the graphs, ``--graphs off``, ``--async off``: tokens
    identical; rwkv6 launches no attention kernel, zamba2 the decode kernel
    6 times per decode step and the flash kernel 6 times per prefill, one
    per shared-block slot); the step clock against ``RECURRENT_CLOCK``;
    tok/s and wall ms per decode step beside the bound of the bytes a step
    reads (every weight but the embedding table, zamba2's weight-tied
    shared block once per slot, the K/V at 8115 live positions, and the
    recurrent state read and written); steady decode steps under
    ``torch.profiler`` with graphs; one layer's scan (:func:`scan_timing`);
    and a 509-token prompt's whole prefill, wall time.  Returns the path's
    run without its engine."""
    t_phase = time.perf_counter()
    tag, full = RECURRENT_TAGS[arch], get_config(arch)
    wide_f32_check(dev, arch, tag, **({"hybrid": dataclasses.replace(
        full.hybrid, shared_block_period=2)} if full.hybrid else {}))
    before = freed_card(dev, tag)
    torch.cuda.reset_peak_memory_stats(dev)
    flags = ["--arch", arch, *RECURRENT_REQUESTS]
    print(f"[{tag}] the serve path takes the first 32 of the serve shape's 64 requests "
          f"({' '.join(flags)}): its eager prefills step the recurrence one token at a time")
    t0 = time.perf_counter()
    model, params = load_cut(serve.build_parser().parse_args(SERVE_FLAGS + flags))
    torch.cuda.synchronize()
    cfg, defs = model.cfg, model.param_defs
    print(f"[{tag}] serve: {cfg.name} n_params={model.n_params()} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab} weights "
          f"{time.perf_counter() - t0:.1f}s; memory allocated {before / 1e9:.3f} GB before the "
          f"load, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB after, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if model.n_params() != RECURRENT_PARAMS[arch]:
        raise AssertionError(f"[{tag}] {model.n_params()} parameters, not "
                             f"{RECURRENT_PARAMS[arch]}")
    if tag == "zamba2":
        n_slots = len(zamba2_mod._slots(cfg))

        def want(st):
            return {"decode_attention[zamba2]": st.decode_steps * n_slots,
                    "prefill_attention[zamba2]": st.prefills * n_slots}
    else:
        def want(st):
            return {}
    run = serve_phase(model, params, tag, flags, want, rows, eager=True)
    if tag == "rwkv6":
        counts = ops.launch_counts()
        print(f"[rwkv6] attention kernel launches over the eager and sync runs: {counts} (the "
              "async run's are checked by serve_phase: none expected)")
        if any(counts.values()):
            raise AssertionError("[rwkv6] an attention kernel launched on the attention-free "
                                 "path")
    st, res = run.stats, run.res
    clock = {k: getattr(st, k) for k in RECURRENT_CLOCK[arch]}
    print(f"[{tag}] step clock {clock}, rounds {res.rounds}; the CPU's prediction "
          f"{RECURRENT_CLOCK[arch]}")
    if clock != RECURRENT_CLOCK[arch]:
        raise AssertionError(f"[{tag}] the step clock is not the CPU's prediction")
    # a decode step reads every weight but the embedding table (16 rows of it)
    stream = 2 * (model.n_params() - math.prod(defs["embed"].shape))
    c, kv = res.engine.cache, 0
    if tag == "zamba2":
        tied = cm.count_params({k: d for k, d in defs["shared"].items()
                                if k not in ("lora_a", "lora_b", "down")})
        stream += 2 * (n_slots - 1) * tied
        kv = 2 * n_slots * 8115 * cfg.n_kv_heads * c["k"].shape[-1] * 2
    state = 2 * sum(t.numel() * t.element_size() for k, t in c.items() if k not in
                    ("k", "v", "lengths"))
    bound_ms = (stream + kv + state) / PEAK_BYTES_S * 1e3
    print(f"[{tag}] {st.generated / res.wall_s:.1f} tok/s, "
          f"{res.wall_s * 1e3 / st.decode_steps:.3f} wall ms per decode step (the run's wall "
          f"over its {st.decode_steps} decode steps, its {st.prefills} whole-prompt prefills "
          f"included); bound per decode step: the weights read {stream / 1e9:.3f} GB"
          + (f" (the shared block's {2 * tied / 1e9:.3f} GB once per slot, x {n_slots})"
             if tag == "zamba2" else "")
          + f" + {kv / 1e9:.3f} GB of K/V at 8115 live positions + the state read and written "
          f"{state / 1e9:.3f} GB = {(stream + kv + state) / 1e9:.3f} GB in {bound_ms:.3f} ms, "
          f"{16e3 / bound_ms:.0f} tok/s at 16 rows")
    run = run._replace(res=None)
    del res, c
    profile_phase(model, params, tag, flags, warm_steps=4, drain=False)
    scan_timing(model, tag)
    prompt = torch.randint(1, cfg.vocab, (1, 509), generator=torch.Generator().manual_seed(19))
    cache = model.init_cache(1, 1024)
    walls = []
    for _ in range(2):
        kv_cache.reset_slot(cache, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, prompt.to(dev), cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[{tag}] a 509-token prompt's whole prefill (B 1, eager): {walls[1]:.1f} ms wall "
          f"(first call {walls[0]:.1f} ms)")
    print(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f}s (f32 check, load, serve "
          "runs, profile, timings)")
    return run


def encoder_attention_timing(model) -> None:
    """The encoder's non-causal self-attention as the port runs it (the
    plain ``chunked_attention``: no TPU kernel takes it) at the seamless
    phase's shape, 16 rows x 512 frames x 16 heads of 64, bf16, against
    one non-causal SDPA call on the same inputs: device-busy time under
    ``torch.profiler`` (the plain call's host-to-device copy of its
    ``q_offset`` cannot wait behind a spin kernel) and the bound."""
    cfg, dev = model.cfg, model.device
    B, T, H, D = SEAMLESS_ROWS, cfg.frontend_len, cfg.n_heads, cfg.resolved_head_dim()
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16() for _ in range(3))

    def plain():
        return attn_mod.chunked_attention(q, k, v, causal=False)

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)).transpose(1, 2)

    err = _max_err(plain(), library())
    nbytes, flops = 4 * q.numel() * 2, 4 * B * H * T * T * D
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    print(f"[seamless] encoder self-attention (B={B} T={T} H={H} D={D} bf16, non-causal): plain "
          f"chunked_attention {_profiled_busy_ms(plain):.4f} ms device busy, {_time_ms([plain], 10):.4f} "
          f"ms event time; SDPA {_device_ms([library]):.4f} ms device; bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); max |plain - SDPA| "
          f"{err:.2e}; x {cfg.n_enc_layers} encoder layers per prefill")


@contextlib.contextmanager
def plain_attention():
    """Route ``core.offload``'s decode and prefill attention to the plain
    model-level versions (those CPU tensors take) for CUDA tensors too."""
    saved = offload.decode_attention, offload.prefill_attention
    offload.decode_attention = attn_mod.decode_attention
    offload.prefill_attention = functools.partial(attn_mod.chunked_attention, causal=True)
    try:
        yield
    finally:
        offload.decode_attention, offload.prefill_attention = saved


@contextlib.contextmanager
def checked_attention(errs: dict[str, list]):
    """Run ``core.offload``'s decode and prefill attention through the
    kernels as usual, and beside each call the kernel's plain version on
    the same inputs: ``errs["decode"]`` / ``errs["prefill"]`` collect
    (max |kernel - plain|, max |plain|) per call.  The plain calls launch
    no kernel."""
    saved = offload.decode_attention, offload.prefill_attention

    def decode(q, k_cache, v_cache, lengths, **kw):
        out = saved[0](q, k_cache, v_cache, lengths, **kw)
        exp = kdec.plain(q, k_cache, v_cache, lengths, **kw)
        errs.setdefault("decode", []).append((_max_err(out, exp), float(exp.abs().max())))
        return out

    def prefill(q, k, v, **kw):
        out = saved[1](q, k, v, **kw)
        exp = kpre.plain(q, k, v, causal=True, q_offset=kw.get("q_offset", 0))
        errs.setdefault("prefill", []).append((_max_err(out, exp), float(exp.abs().max())))
        return out

    offload.decode_attention, offload.prefill_attention = decode, prefill
    try:
        yield errs
    finally:
        offload.decode_attention, offload.prefill_attention = saved


def _teacher_forced(model, params, frames, prompt, feed, ref_logits) -> dict:
    """Prefill ``prompt`` over ``frames`` and decode, eagerly, feeding the
    tokens ``feed`` (B, n) of another run; each step's logits against that
    run's ``ref_logits``: ``errs`` (max |logit diff| per step), ``differ``
    (greedy tokens that differ), ``first`` (of them, the prefill's), and
    ``near`` / ``flips``: rows whose reference top-two margin is at most
    twice the row's largest logit difference (rounding may flip them), and
    tokens that differ outside them."""
    cache = model.init_cache(frames.shape[0], 1024)
    out = {"errs": [], "differ": 0, "first": 0, "near": 0, "flips": 0}
    for i, want in enumerate(ref_logits):
        if i:
            lp, _ = model.decode_step(params, cache, feed[:, i - 1])
        else:
            lp, _ = model.prefill(params, prompt, cache, embeds=frames)
        diff = (lp.float() - want.float()).abs().amax(-1)
        top = want.float().topk(2, dim=-1).values
        tie = (top[:, 0] - top[:, 1]) <= 2 * diff
        differ = lp.argmax(-1) != want.argmax(-1)
        out["errs"].append(float(diff.max()))
        out["differ"] += int(differ.sum())
        out["first"] += int(differ.sum()) if i == 0 else 0
        out["near"] += int(tie.sum())
        out["flips"] += int((differ & ~tie).sum())
    return out


def seamless_phase(dev, rows: dict[str, dict]) -> PathRun:
    """seamless-m4t-medium at full width and depth at model level (the
    serving engine passes no frames; the reference's cannot serve it
    either): first the float32 check at full width cut to 2 encoder and 2
    decoder layers, card against CPU; seed-0 bf16 weights on a freed card;
    ``SEAMLESS_ROWS`` rows of seeded random frames (512 x 1024) and a
    ``SEAMLESS_PROMPT``-token decoder prompt: ``prefill(..., embeds=)``
    eagerly (the flash kernel once per decoder layer), then
    ``SEAMLESS_STEPS`` greedy ``decode_step`` calls as one CUDA graph (the
    decode kernel twice per layer and step: the self cache and the 512
    cached frames), launches checked per kernel row; the decode step's
    wall and device-busy ms (8 graph replays under ``torch.profiler``)
    beside the bound of the bytes it reads (the decoder's weights but the
    encoder's and the cross K/V projections, the unembedding, the static
    cross K/V and the self cache at the run's mean length); the encoder
    attention's time (:func:`encoder_attention_timing`).  Then the same
    prefill and steps eagerly, fed the graph run's tokens, with every
    kernel call held against the kernel's plain version on the same inputs
    (:func:`checked_attention`: within ``BF16_TOL`` of the call's largest
    output, as the kernel rows hold unit-scale ones) and the greedy tokens
    equal to the graph run's outside near-ties; and, printed only, the
    whole path with the plain attention (:func:`plain_attention`) beside a
    yardstick: the plain path again with every frame moved one bf16 ulp.
    The random model at full depth moves its logits by O(1) under either
    (its 4-D attention weights drawn with the reference's fan-in of their
    second-to-last axis make q and k ~8x wide, scores reach hundreds, and
    the plain decode rounds ``q * scale`` to bf16 where the kernels scale
    f32 scores), so no logit tolerance can hold between them.  Returns the
    graph run's launches and tokens."""
    t_phase = time.perf_counter()
    wide_f32_check(dev, SEAMLESS, "seamless", F32_WIDE_ENCDEC, n_enc_layers=2)
    before = freed_card(dev, "seamless")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(get_config(SEAMLESS), dev)
    params = model.init(0)
    torch.cuda.synchronize()
    cfg, L = model.cfg, model.cfg.n_layers
    print(f"[seamless] {cfg.name} n_params={model.n_params()} encoder {cfg.n_enc_layers} + "
          f"decoder {L} layers, d_model={cfg.d_model} heads={cfg.n_heads} of "
          f"{cfg.resolved_head_dim()} vocab={cfg.vocab} weights {time.perf_counter() - t0:.1f}s; "
          f"memory allocated {before / 1e9:.3f} GB before the load, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB after, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if model.n_params() != SEAMLESS_PARAMS:
        raise AssertionError(f"[seamless] {model.n_params()} parameters, not {SEAMLESS_PARAMS}")
    B, n = SEAMLESS_ROWS, SEAMLESS_STEPS
    gen = torch.Generator(device=dev).manual_seed(17)
    frames = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=gen, device=dev)
    prompt = torch.randint(1, cfg.vocab, (B, SEAMLESS_PROMPT), generator=gen, device=dev)

    ops.reset_launch_counts()
    cache = model.init_cache(B, 1024)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, prompt, cache, embeds=frames.bfloat16())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prog = Program("seamless-decode",
                   lambda inp: (model.decode_step(params, cache, inp["tokens"])[0],),
                   {"tokens": (B,)}, dev, graphs=True, pool=torch.cuda.graph_pool_handle())
    steps, toks = [logits.clone()], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(n):
        out, = prog(tokens=toks[-1].cpu().numpy())
        steps.append(out.clone())
        toks.append(out.argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    per_row = {"prefill_attention[seamless]": L, "decode_attention[seamless]": n * L,
               "decode_attention[seamless-cross]": n * L}
    exp_variant, exp_shape = _expected(per_row, rows)
    launches, shapes = ops.variant_counts(), ops.shape_counts()
    tokens = torch.stack(toks, 1)
    print(f"[seamless] prefill ({B} rows x {SEAMLESS_PROMPT} tokens over {cfg.frontend_len} "
          f"frames, eager) {prefill_ms:.1f} ms; {n} decode steps as one CUDA graph "
          f"({prog.replays} replays, capture {prog.capture_s * 1e3:.1f} ms): {decode_ms:.3f} "
          f"wall ms per step with the host's token round trip; launches {launches} by head "
          f"shape {shapes}, expected {exp_variant} / {exp_shape}")
    if launches != exp_variant or shapes != exp_shape:
        raise AssertionError("[seamless] kernel launches differ from the expected")
    if not (all(bool(torch.isfinite(x[:, :cfg.vocab]).all()) for x in steps)
            and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())):
        raise AssertionError("[seamless] non-finite logits or a token outside the vocabulary")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    feed = toks[-1].cpu().numpy()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            prog(tokens=feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    busy = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in busy) / 1e3 / 8
    dec = params["dec_blocks"]
    weights = 2 * (sum(t.numel() for k, t in dec.items() if k not in ("x_wk", "x_wv"))
                   + params["unembed"].numel() + params["final_norm"].numel())
    cross = sum(cache[k].numel() * 2 for k in ("xk", "xv"))
    mean_len = SEAMLESS_PROMPT + n / 2
    self_kv = 2 * L * B * mean_len * cfg.n_kv_heads * cfg.resolved_head_dim() * 2
    bound_ms = (weights + cross + self_kv) / PEAK_BYTES_S * 1e3
    print(f"[seamless] decode step, graph replays under torch.profiler: wall {wall_ms:.3f} ms "
          f"(with the token copy), device busy {busy_ms:.3f} ms, "
          f"{sum(e.count for e in busy) // 8} device ops per step; bound: the weights read "
          f"{weights / 1e9:.3f} GB + the static cross K/V {cross / 1e9:.3f} GB + the self cache "
          f"{self_kv / 1e9:.4f} GB at {mean_len:.0f} positions = "
          f"{(weights + cross + self_kv) / 1e9:.3f} GB in {bound_ms:.3f} ms; busy "
          f"{busy_ms / bound_ms:.1f}x the bound")
    for e in sorted(busy, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / 8:8.3f} ms/step "
              f"{e.count / 8:7.1f}x  {e.key[:90]}")
    encoder_attention_timing(model)
    del cache, prog

    errs: dict[str, list] = {}
    with checked_attention(errs):
        eager = _teacher_forced(model, params, frames.bfloat16(), prompt, tokens, steps)
    worst = {k: max(e / max(m, 1.0) for e, m in v) for k, v in errs.items()}
    print(f"[seamless] eager, fed the graph run's tokens: every kernel call against its plain "
          f"version on the same inputs, largest error over max(1, the call's largest output): "
          f"{ {k: f'{w:.2e}' for k, w in worst.items()} } over "
          f"{ {k: len(v) for k, v in errs.items()} } calls (tol {BF16_TOL}); logits against the "
          f"graph run's: max |diff| {max(eager['errs']):.3e}, tokens that differ "
          f"{eager['differ']}/{B * (n + 1)} ({eager['flips']} outside near-ties)")
    if max(worst.values()) > BF16_TOL or eager["flips"]:
        raise AssertionError("[seamless] a kernel call differs from its plain version, or the "
                             "eager run's tokens from the graph run's")
    bf16_frames = frames.bfloat16()
    moved = (bf16_frames.view(torch.int16) + 1).view(torch.bfloat16)   # one ulp outwards
    with plain_attention():
        plain = _teacher_forced(model, params, bf16_frames, prompt, tokens, steps)
        ulp = _teacher_forced(model, params, moved, prompt, tokens, [
            model.prefill(params, prompt, model.init_cache(B, 1024), embeds=bf16_frames)[0]])
    print(f"[seamless] the whole path with the plain attention, fed the same tokens (printed, "
          f"not held): max |logit diff| prefill {plain['errs'][0]:.3e}, decode "
          f"{max(plain['errs'][1:]):.3e}; tokens that differ {plain['differ']}/{B * (n + 1)}, "
          f"first tokens {plain['first']}/{B}; yardstick, the plain prefill with every frame "
          f"moved one bf16 ulp: max |logit diff| {ulp['errs'][0]:.3e}, first tokens that differ "
          f"{ulp['first']}/{B}")
    del model, params, steps
    wall = time.perf_counter() - t_phase
    print(f"[seamless] phase wall {wall:.1f}s (f32 check, load, graph run, profile, checked "
          "and plain runs)")
    return PathRun(per_row, None, tokens.tolist(), wall, None)


# ----------------------------------------------------------- training path
def _train_shape(tag: str | None):
    B, S, Hq, Hkv, D = TRAIN_SHAPES[tag]
    pairs = B * S * (S + 1) // 2                       # visible causal (query, key) pairs
    return B, S, Hq, Hkv, D, pairs


def _train_inputs(dev, tag, seed, dtype=torch.bfloat16, shape=None):
    B, S, Hq, Hkv, D = shape or TRAIN_SHAPES[tag]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    return q, k, v, do


def train_lse_phase(dev, tag: str | None = None) -> dict:
    """The flash forward with its log-sum-exp (the train path's launch) at
    a train path's attention shape (:data:`TRAIN_SHAPES`): output against
    the plain version (and bit-equal to the launch without lse), lse
    against ``logsumexp(scale * q k^T)``; device time beside the plain
    version's and causal SDPA's forward."""
    name = "prefill_attention[train-lse" + (f"-{tag}]" if tag else "]")
    B, S, Hq, Hkv, D, pairs = _train_shape(tag)
    q, k, v, _ = _train_inputs(dev, tag, 21)
    out, lse = kpre.kernel(q, k, v, return_lse=True)
    exp, exp_lse = kpre.plain(q, k, v, return_lse=True)
    if not torch.equal(out, kpre.kernel(q, k, v)):
        raise AssertionError(f"{name}: writing the lse changed the output's bits")
    torch.cuda.synchronize()
    err, lse_err = _max_err(out, exp), _max_err(lse, exp_lse)
    if not (err <= BF16_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"{name} vs plain: out {err}, lse {lse_err}")
    del exp, exp_lse

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True, enable_gqa=True)

    flops = 4 * pairs * Hq * D
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "prefill_attention", "variant": "lse",
        "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda", "source": kpre.SOURCE,
        "replaces": kpre.REPLACES, "max_abs_err": err, "tol": BF16_TOL,
        "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
        **_times([lambda: kpre.kernel(q, k, v, return_lse=True)],
                 [lambda: kpre.plain(q, k, v, return_lse=True)], [library]),
        "library": "scaled_dot_product_attention (causal forward)",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} Sq=Sk={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal, lse (B, Hq, S) f32",
    }


def _bwd_errs(got, want) -> float:
    """Largest |kernel - plain| / max(1, |plain|) over dq, dk and dv."""
    return max(float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1)).max())
               for a, b in zip(got, want))


def _bwd_rel_norm(got, want) -> float:
    """Largest ||kernel - plain|| / ||plain|| over dq, dk and dv."""
    return max(float((a.float() - b.float()).norm() / b.float().norm())
               for a, b in zip(got, want))


def train_bwd_phase(dev, tag: str | None = None) -> dict:
    """The flash backward at a train path's shape: dq, dk, dv against the
    plain version from the same saved tensors (2e-2 of max(1, |plain|) in
    bf16, and each within ``BWD_REL_NORM_TOL`` in norm), two launches bit-equal (no atomics); an f32 case (the FMA
    kernels, float32 mode) at 1e-4; device time beside the plain version's
    and SDPA forward + backward through autograd on the same tensors."""
    name = "flash_attention_bwd" + (f"[{tag}]" if tag else "")
    B, S, Hq, Hkv, D, pairs = _train_shape(tag)
    q, k, v, do = _train_inputs(dev, tag, 22)
    out, lse = kpre.kernel(q, k, v, return_lse=True)
    got = kbwd.kernel(q, k, v, out, do, lse)
    if not all(torch.equal(a, b) for a, b in zip(got, kbwd.kernel(q, k, v, out, do, lse))):
        raise AssertionError(f"{name}: two launches differ")
    want = kbwd.plain(q, k, v, out, do, lse)
    err, rel = _bwd_errs(got, want), _bwd_rel_norm(got, want)
    del want
    fB, fS, fdiv = TRAIN_F32_CASE
    f32 = _train_inputs(dev, tag, 23, torch.float32, (fB, fS, Hq // fdiv, Hkv // fdiv, D)
                        if Hkv % fdiv == 0 else (fB, fS, Hq, Hkv, D))
    fo, flse = kpre.kernel(*f32[:3], return_lse=True)
    f32_err = _bwd_errs(kbwd.kernel(*f32[:3], fo, f32[3], flse),
                        kbwd.plain(*f32[:3], fo, f32[3], flse))
    torch.cuda.synchronize()
    if not (err <= BF16_TOL and rel <= BWD_REL_NORM_TOL and f32_err <= F32_TOL):
        raise AssertionError(f"{name} vs plain: bf16 {err} (in norm {rel}), f32 {f32_err}")
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    do_t = do.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qs, ks, vs), do_t)

    flops = 10 * pairs * Hq * D                 # five products of the visible pairs
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {
        "name": name, "kernel": "flash_attention_bwd", "variant": "unscaled",
        "heads": kernel_heads(Hkv, Hq // Hkv, D), "route": "cuda", "source": kbwd.SOURCE,
        "replaces": kbwd.REPLACES, "max_abs_err": err, "tol": BF16_TOL,
        "rel_norm_err": rel, "rel_norm_tol": BWD_REL_NORM_TOL, "f32_max_rel_err": f32_err, "f32_tol": F32_TOL,
        **_times([lambda: kbwd.kernel(q, k, v, out, do, lse)],
                 [lambda: kbwd.plain(q, k, v, out, do, lse)], [library]),
        "library": "scaled_dot_product_attention forward + backward (autograd)",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal; f32 case B={fB} S={fS}",
        "note": "no Pallas backward in the reference: its train step differentiates "
                "chunked_attention with XLA",
    }


# the modules whose own plain chunked_attention calls the reference makes too
# (not through offload): deepseek's causal MLA (q/k D 192, v D 128) and the
# encoder-decoder's non-causal encoder and cross attention
PLAIN_CALLERS = {"repro_torch.models.deepseek": True, "repro_torch.models.encdec": False}


@contextlib.contextmanager
def forbid_plain(calls: collections.Counter | None = None):
    """Make every plain attention (forward or backward) that the reference
    routes through ``offload.prefill_attention`` raise while a train path
    runs on the card: the path must go through the kernels.  The plain
    ``chunked_attention`` calls the reference makes itself
    (:data:`PLAIN_CALLERS`, each with its causality) run and are counted in
    ``calls`` by (module, "causal" | "non-causal"); any other raises."""
    plain_chunked = attn_mod.chunked_attention
    calls = collections.Counter() if calls is None else calls

    def chunked(*a, causal: bool = True, **kw):
        caller = sys._getframe(1).f_globals.get("__name__")
        if PLAIN_CALLERS.get(caller) is not causal:
            raise AssertionError(f"a plain {'causal' if causal else 'non-causal'} attention "
                                 f"from {caller} ran on the card's train path")
        calls[(caller.rsplit(".", 1)[-1], "causal" if causal else "non-causal")] += 1
        return plain_chunked(*a, causal=causal, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a plain attention ran on the card's train path")

    names = [(attn_mod, "chunked_attention", chunked),
             (encdec_mod, "chunked_attention", chunked), (ref, "naive_attention", refuse),
             (kpre, "plain", refuse), (kbwd, "plain", refuse)]
    saved = [getattr(m, n) for m, n, _ in names]
    for m, n, f in names:
        setattr(m, n, f)
    try:
        yield calls
    finally:
        for (m, n, _), f in zip(names, saved):
            setattr(m, n, f)


def train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model flops of one step: 6 N T (every weight in one product per
    token; the tied table's is the unembedding) plus the causal
    attention's 12 L pairs Hq D (its forward's 4, the backward's 8)."""
    pairs = B * S * (S + 1) // 2
    return 6 * n_params * B * S + 12 * cfg.n_layers * pairs * cfg.n_heads * cfg.resolved_head_dim()


def _train_counts(label: str, want_fwd: int, want_bwd: int, heads: str | None) -> None:
    """Every launch of a train path: the lse forward and the backward at
    ``heads``, nothing else (no serving variant, no decode, no paged; none
    at all on a path without flash attention)."""
    want_v = {k: {} for k in ops.KERNELS}
    want_s = {k: {} for k in ops.KERNELS}
    if want_fwd:
        want_v["prefill_attention"], want_s["prefill_attention"] = \
            {"lse": want_fwd}, {("lse", heads): want_fwd}
    if want_bwd:
        want_v["flash_attention_bwd"], want_s["flash_attention_bwd"] = \
            {"unscaled": want_bwd}, {("unscaled", heads): want_bwd}
    got_v, got_s = ops.variant_counts(), ops.shape_counts()
    if (got_v, got_s) != (want_v, want_s):
        raise AssertionError(f"[{label}] launches {got_s}, expected {want_s}")
    print(f"[{label}] launches: flash forward with lse {want_fwd}, backward {want_bwd}"
          + (f" at {heads}" if heads else "") + " (= the counters)")


def train_launches(cfg):
    """Per train step of ``cfg``'s family: (flash forwards with lse, flash
    backwards, their head shape, the plain ``chunked_attention`` calls by
    (module, causality)).  A block under remat runs its forward twice;
    zamba2's shared block and deepseek's MTP block run without remat, as in
    the reference."""
    L = cfg.n_layers
    if cfg.family in ("dense", "moe"):
        return 2 * L, L, kernel_heads(cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                                      cfg.resolved_head_dim()), {}
    if cfg.family == "deepseek":
        return 0, 0, None, {("deepseek", "causal"): 2 * L + cfg.mtp_depth}
    if cfg.family == "zamba2":
        n = len(zamba2_mod._slots(cfg))
        return n, n, kernel_heads(cfg.n_heads, 1, 2 * cfg.d_model // cfg.n_heads), {}
    if cfg.family == "encdec":
        return 2 * L, L, kernel_heads(cfg.n_heads, 1, cfg.resolved_head_dim()), \
            {("encdec", "non-causal"): 2 * (cfg.n_enc_layers + L)}
    return 0, 0, None, {}                                # rwkv6: no attention


def family_train_flops(cfg, n_params: int, B: int, S: int) -> tuple[float, str]:
    """Model flops of one train step of the families beside the dense one,
    and what they count: 6 x (weights in a product) x (tokens through
    them), plus 6 x pairs x heads x (Dqk + Dv) for each attending layer
    (the forward's 2 products, the backward's 4).  An embedding lookup is
    no product; the recurrences' scans are not counted."""
    pairs = B * S * (S + 1) // 2
    V, D, L, H = cfg.padded_vocab(), cfg.d_model, cfg.n_layers, cfg.n_heads
    Dh = cfg.resolved_head_dim()
    if cfg.family == "moe":
        return (6 * balance._active_params(cfg) * B * S + 12 * L * pairs * H * Dh,
                "6 N T with N the active parameters of core/balance.py:_active_params "
                "(top-k and shared experts; embedding and unembedding) + attention")
    if cfg.family == "deepseek":
        a = cfg.mla
        d_qk = a.qk_nope_head_dim + a.qk_rope_head_dim
        attn = 6 * (L + cfg.mtp_depth) * pairs * H * (d_qk + a.v_head_dim)
        return (6 * n_params * B * S + attn,
                "6 N T over all parameters (the embedding is looked up, the unembedding runs "
                "for the main and the MTP head) + MLA attention at q/k 192, v 128")
    if cfg.family == "rwkv6":
        return (6 * (n_params - V * D) * B * S,
                "6 N T without the embedding; the WKV scan not counted")
    if cfg.family == "zamba2":
        n = len(zamba2_mod._slots(cfg))
        core = cm.count_params({k: v for k, v in zamba2_mod.param_defs(cfg)["shared"].items()
                                if k not in ("lora_a", "lora_b", "down")})
        attn = 12 * n * pairs * H * (2 * D // H)
        return (6 * (n_params - V * D + (n - 1) * core) * B * S + attn,
                f"6 N T without the embedding, the shared block counted at each of its {n} "
                "slots; its attention; the SSD scan not counted")
    T = cfg.frontend_len                                  # encoder-decoder
    defs = encdec_mod.param_defs(cfg)
    cross_kv = L * 2 * D * H * Dh
    per_frame = cm.count_params(defs["enc_blocks"]) + cross_kv
    per_token = cm.count_params(defs["dec_blocks"]) - cross_kv + V * D
    attn = 12 * H * Dh * (cfg.n_enc_layers * B * T * T + L * B * S * T + L * pairs)
    return (6 * (per_frame * B * T + per_token * B * S) + attn,
            f"6 N T: encoder (and the cross K/V) over {T} frames, decoder and unembedding over "
            "the tokens; encoder, cross and causal self attention")


def _train_report(label: str, cfg, n_params: int, losses: dict, step_s: dict, B: int,
                  S: int, peak: int, grad_norms: dict | None = None,
                  must_fall: bool = False, flops: tuple[float, str] | None = None) -> dict:
    """Print a train run's losses (and grad norms), ms per step, tokens/s,
    MFU and peak memory; raise on a loss that is not finite, or with
    ``must_fall`` on a last loss not below the first.  ``flops``: a step's
    model flops and what they count (default :func:`train_flops`)."""
    steps = sorted(losses)
    vals = [losses[s] for s in steps]
    if not all(math.isfinite(x) for x in vals) or (must_fall and not vals[-1] < vals[0]):
        raise AssertionError(f"[{label}] losses not finite or not falling: {vals}")
    if grad_norms is not None:
        print(f"[{label}] grad norm by step: "
              + ", ".join(f"{s} {grad_norms[s]:.4g}" for s in sorted(grad_norms)))
    steady = [step_s[s] for s in steps[1:]]
    ms = 1e3 * statistics.mean(steady)
    tok_s = B * S / (ms / 1e3)
    flops, counted = flops or (train_flops(cfg, n_params, B, S),
                               "6 N T + attention")
    mfu = flops / (ms / 1e3) / PEAK_BF16_FLOPS
    print(f"[{label}] loss by step: " + ", ".join(f"{s} {losses[s]:.4f}" for s in steps)
          + f"; last {'below' if vals[-1] < vals[0] else 'not below'} the first")
    print(f"[{label}] {ms:.3f} ms per step (mean of steps 1-{steps[-1]}; step 0 "
          f"{step_s[steps[0]] * 1e3:.1f} ms), {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
          f"({flops / 1e12:.2f} TFLOP a step: {counted}; against 989 TFLOP/s bf16), "
          f"peak device memory {peak / 1e9:.2f} GB")
    return {"ms": ms, "tok_s": tok_s, "mfu": mfu, "peak_gb": peak / 1e9}


def _reduced_train_batch(cfg, dev=None, B: int = 4, S: int = 64, step: int = 0) -> dict:
    """The synthetic pipeline's batch; the encoder-decoder's also holds
    ``src_embeds`` (B, frontend_len, d_model), seeded (on ``dev``)."""
    b = host_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B), step, 0, 1)
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev or "cpu").manual_seed(step)
        b["src_embeds"] = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=gen,
                                      device=dev or "cpu").to(torch.bfloat16)
    return b


def train_reference_check(dev) -> None:
    """Every family reduced, in float32 (TF32 off), the same weights on the
    card (the flash kernels with lse and the f32 backward kernels where the
    family attends through them) and on the CPU (plain, under autograd):
    loss and every metric within 1e-5 relative and every gradient leaf
    within ``TRAIN_GRAD_TOL`` of its largest element; the card's launches
    as :func:`train_launches` says; then one ``train_step`` each from the
    same state: loss, lr and grad norm.  deepseek's reduced model has its
    MoE layers and the MTP block."""
    for arch in ("llama3.2-1b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
                 "seamless-m4t-medium", "rwkv6-7b", "zamba2-1.2b"):
        gpu, cpu, ((p_gpu, p_cpu),) = _reduced_pair(dev, arch=arch)
        cfg = gpu.cfg
        batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in _reduced_train_batch(cfg).items()}
        res = []
        ops.reset_launch_counts()
        for model, params in ((gpu, p_gpu), (cpu, p_cpu)):
            req = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, metrics = model.loss_fn(req, to_device(batch, model.device))
            grads = torch.autograd.grad(loss, leaves(req), allow_unused=True,
                                        materialize_grads=True)
            res.append(({k: float(v.detach()) for k, v in metrics.items()},
                        [g.cpu() for g in grads]))
            if model is gpu:
                fwd, bwd, heads, _ = train_launches(cfg)
                _train_counts(f"train-check {arch}", fwd, bwd, heads)
        (mg, gg), (mc, gc_) = res
        loss_err = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
        grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(gg, gc_))
        run = RunConfig(model=cfg, parallel=ParallelConfig(),
                        train=TrainConfig(lr=3e-3, warmup_steps=2, total_steps=50))
        (init_g, step_g, _, _), (_, step_c, _, _) = (make_train_step(m, run)
                                                     for m in (gpu, cpu))
        s_gpu = init_g(3)
        s_cpu = _cpu(s_gpu)
        _, m_g = step_g(s_gpu, batch)
        _, m_c = step_c(s_cpu, batch)
        step_err = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k]))
                    for k in ("loss", "lr", "grad_norm")}
        print(f"[train-check] {arch} reduced float32, card vs CPU: loss {loss_err} (tol "
              f"{TRAIN_LOSS_TOL}), largest gradient error over its leaf's largest {grad_err:.2e} "
              f"over {len(gg)} leaves (tol {TRAIN_GRAD_TOL}); one train_step: {step_err}")
        if not (max(loss_err.values()) <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
                and step_err["loss"] <= TRAIN_LOSS_TOL and step_err["lr"] == 0
                and step_err["grad_norm"] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"[train-check] {arch}: card and CPU differ")


def _family_train_check(label: str, cfg, n_params: int, losses: dict, step_s: dict, B: int,
                        S: int, peak: int, n_steps: int, plain: collections.Counter,
                        wall: float, grad_norms: dict | None = None) -> PathRun:
    """The launches and plain calls of one of the other families' train
    runs (:func:`train_launches` a step), and its report."""
    fwd, bwd, heads, want_plain = train_launches(cfg)
    _train_counts(label, fwd * n_steps, bwd * n_steps, heads)
    want_plain = {k: v * n_steps for k, v in want_plain.items()}
    if dict(plain) != want_plain:
        raise AssertionError(f"[{label}] plain chunked_attention calls {dict(plain)}, "
                             f"expected {want_plain}")
    print(f"[{label}] plain chunked_attention calls the reference makes too: "
          f"{dict(plain) or 'none'} (expected)")
    rep = _train_report(label, cfg, n_params, losses, step_s, B, S, peak, grad_norms,
                        flops=family_train_flops(cfg, n_params, B, S))
    print(f"[{label}] {cfg.name} at full width, {cfg.n_layers} layers, {n_params:,} params, "
          f"B {B} x S {S}, {n_steps} steps: wall {wall:.1f}s")
    tag = TRAIN_TAGS.get(label)
    launches = ({f"prefill_attention[train-lse-{tag}]": fwd * n_steps,
                 f"flash_attention_bwd[{tag}]": bwd * n_steps} if tag else {})
    return PathRun(launches, rep, [], wall, None)


def family_train_phase(dev) -> dict[str, PathRun]:
    """The other families' train paths at full width, each on a card freed
    of the one before, every plain attention but the reference's own
    refused (:func:`forbid_plain`): moonshot, deepseek, rwkv6 and zamba2
    through the train CLI (:data:`FAMILY_TRAIN`), seamless at model level
    through ``make_train_step`` on batches with source frames.  Each
    prints its losses (finite; whether the last is below the first),
    launches, ms per step, tokens/s, MFU and peak memory."""
    t_phase = time.perf_counter()
    runs: dict[str, PathRun] = {}
    with tempfile.TemporaryDirectory() as tmp, forbid_plain() as plain:
        for label, flags in FAMILY_TRAIN.items():
            freed_card(dev, label)
            ops.reset_launch_counts()
            plain.clear()
            t0 = time.perf_counter()
            args = train_cli.build_parser().parse_args(
                flags + ["--device", "cuda", "--ckpt-every", "0",
                         "--ckpt-dir", f"{tmp}/{label}"])
            res = train_cli.run(args)
            wall = time.perf_counter() - t0
            cfg = get_config(args.arch).with_overrides(n_layers=args.layers or
                                                       get_config(args.arch).n_layers)
            runs[label] = _family_train_check(label, cfg, res.n_params, res.losses, res.step_s,
                                              args.batch, args.seq, res.peak_bytes, args.steps,
                                              plain, wall, res.grad_norms)
            del res
        freed_card(dev, "train-seamless")
        ops.reset_launch_counts()
        plain.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        B, S, n_steps = SEAMLESS_TRAIN
        t0 = time.perf_counter()
        cfg = get_config(SEAMLESS)
        model = build_model(cfg, dev)
        run = RunConfig(model=cfg, parallel=ParallelConfig(),
                        train=TrainConfig(lr=3e-3, warmup_steps=2, total_steps=n_steps))
        init_state, train_step, _, _ = make_train_step(model, run)
        state = init_state(0)
        losses, step_s, norms = {}, {}, {}
        for i in range(n_steps):
            batch = _reduced_train_batch(cfg, dev, B, S, i)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            state, m = train_step(state, batch)
            losses[i], norms[i] = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize(dev)
            step_s[i] = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        runs["train-seamless"] = _family_train_check(
            "train-seamless", cfg, model.n_params(), losses, step_s, B, S,
            torch.cuda.max_memory_allocated(dev), n_steps, plain, wall, norms)
        del state, model
    print(f"[train-families] phase wall {time.perf_counter() - t_phase:.1f}s")
    return runs


def _load_example(name: str):
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_phase(dev, rows: dict[str, dict]) -> dict[str, PathRun]:
    """Training on a card freed of the serving phases: llama3.2-1b at full
    width and depth through the train CLI (20 steps; launches 2 L per step
    forward, L backward), then cut to 2 layers (a falling loss), that run
    again failing at step 12 (one restart from the step-10 checkpoint, the
    final params, m and v bit-equal to the uninterrupted run's), minicpm-2b at full width through
    the example's port (WSD, grad_accum 2, int8), every plain attention
    refused meanwhile; then the reduced float32 card-vs-CPU checks."""
    t_phase = time.perf_counter()
    runs: dict[str, PathRun] = {}
    L = get_config("llama3.2-1b").n_layers
    heads = rows["prefill_attention[train-lse]"]["heads"]
    with tempfile.TemporaryDirectory() as tmp, forbid_plain():
        freed_card(dev, "train-llama")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_cli.run(train_cli.build_parser().parse_args(
            TRAIN_FLAGS + ["--ckpt-dir", f"{tmp}/straight"]))
        wall = time.perf_counter() - t0
        _train_counts("train-llama", 2 * L * TRAIN_STEPS, L * TRAIN_STEPS, heads)
        cfg = get_config("llama3.2-1b")
        rep = _train_report("train-llama", cfg, res.n_params, res.losses, res.step_s, 8, 1024,
                            res.peak_bytes, res.grad_norms)
        runs["train-llama"] = PathRun({"prefill_attention[train-lse]": 2 * L * TRAIN_STEPS,
                                       "flash_attention_bwd": L * TRAIN_STEPS},
                                      rep, [], wall, None)
        print(f"[train-llama] wall {wall:.1f}s (init, {TRAIN_STEPS} steps, the step-20 "
              "checkpoint)")
        shutil.rmtree(f"{tmp}/straight")
        del res
        # the reference's init at full depth: grad norms ~1e11 (measured), so
        # global clipping leaves the unembedding and later layers updates
        # below Adam's eps, and 20 steps do not move the loss (PERF.md); at
        # full width cut to 2 layers (grad norm ~1e2) the loss must fall
        freed_card(dev, "train-llama-2l")
        two = ["--layers", "2"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_cli.run(train_cli.build_parser().parse_args(
            TRAIN_FLAGS + two + ["--ckpt-dir", f"{tmp}/two"]))
        wall = time.perf_counter() - t0
        _train_counts("train-llama-2l", 2 * 2 * TRAIN_STEPS, 2 * TRAIN_STEPS, heads)
        rep = _train_report("train-llama-2l", cfg.with_overrides(n_layers=2),
                            res.n_params, res.losses, res.step_s, 8, 1024, res.peak_bytes,
                            res.grad_norms, must_fall=True)
        runs["train-llama-2l"] = PathRun({"prefill_attention[train-lse]": 4 * TRAIN_STEPS,
                                          "flash_attention_bwd": 2 * TRAIN_STEPS},
                                         rep, [], wall, None)
        print(f"[train-llama-2l] wall {wall:.1f}s")
        straight, straight_losses = res.state, res.losses
        shutil.rmtree(f"{tmp}/two")
        del res
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_cli.run(train_cli.build_parser().parse_args(
            TRAIN_FLAGS + two + TRAIN_RESUME_FLAGS + ["--ckpt-dir", f"{tmp}/resume"]))
        wall = time.perf_counter() - t0
        n_steps = TRAIN_FAIL + TRAIN_STEPS - TRAIN_CKPT
        _train_counts("train-llama-resume", 2 * 2 * n_steps, 2 * n_steps, heads)
        if res.restarts != 1 or f"restored from step {TRAIN_CKPT}" not in res.lines:
            raise AssertionError(f"[train-llama-resume] {res.restarts} restarts: {res.lines}")
        pairs = list(zip(leaves(straight["params"]) + leaves(straight["opt"]),
                         leaves(res.state["params"]) + leaves(res.state["opt"]), strict=True))
        same = sum(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        equal_losses = all(res.losses[s] == straight_losses[s]
                           for s in range(TRAIN_CKPT, TRAIN_STEPS))
        print(f"[train-llama-resume] at 2 layers: failed at step {TRAIN_FAIL}, restarted once "
              f"from step {TRAIN_CKPT}; final params, m, v and step bit-equal to the "
              f"uninterrupted run: {same}/{len(pairs)} leaves; losses of steps "
              f"{TRAIN_CKPT}-{TRAIN_STEPS - 1} equal: {equal_losses}; wall {wall:.1f}s "
              f"({n_steps} steps, 2 checkpoint saves, 1 restore)")
        if same != len(pairs) or not equal_losses:
            raise AssertionError("[train-llama-resume] the resumed state differs from the "
                                 "uninterrupted run's")
        runs["train-llama-resume"] = PathRun(
            {"prefill_attention[train-lse]": 2 * 2 * n_steps, "flash_attention_bwd": 2 * n_steps},
            None, [], wall, None)
        del res, straight, pairs
        freed_card(dev, "train-minicpm")
        example = _load_example("torch_train_minicpm_wsd")
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = example.main(["--steps", str(MINICPM_TRAIN_STEPS), "--ckpt-dir", f"{tmp}/minicpm"])
        wall = time.perf_counter() - t0
        mcfg = out["cfg"]
        Lm, n_fwd = mcfg.n_layers, 2 * mcfg.n_layers * 2 * MINICPM_TRAIN_STEPS
        _train_counts("train-minicpm", n_fwd, n_fwd // 2,
                      rows["prefill_attention[train-lse-minicpm]"]["heads"])
        n_params = build_model(mcfg, "cpu").n_params()
        rep = _train_report("train-minicpm", mcfg, n_params, out["losses"], out["step_s"], 8, 1024,
                            torch.cuda.max_memory_allocated(dev))
        print(f"[train-minicpm] minicpm-2b ({n_params:,} params, {Lm} layers, WSD, grad_accum 2, "
              f"int8 compression) wall {wall:.1f}s")
        runs["train-minicpm"] = PathRun({"prefill_attention[train-lse-minicpm]": n_fwd,
                                         "flash_attention_bwd[minicpm]": n_fwd // 2},
                                        rep, [], wall, None)
        del out
    runs.update(family_train_phase(dev))
    freed_card(dev, "train-check")
    train_reference_check(dev)
    print(f"[train] phase wall {time.perf_counter() - t_phase:.1f}s")
    return runs


# ------------------------------------------------ placed training (slice 18)
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pt_steps(cfg, dev, env: Env, mesh, steps: int) -> dict:
    """``steps`` train steps of ``cfg`` from seeded random weights through
    ``make_train_step`` at the reference's ``TrainConfig()`` (lr 3e-4 after
    100 warmup steps: an Adam step moves each element by about lr x
    sign(g), so at the CLI's lr a gradient element near 0 whose sign
    differs between two summation orders moves the later steps' losses
    and grad norms by more than the rounding itself), on ``mesh`` under
    ``env`` (``Env()``: one rank), the CLI's global batches: losses, grad
    norms, seconds per step and the bytes of this rank's ``m``."""
    model = build_model(cfg, dev, env, mesh if env.axes else None)
    run = RunConfig(model=cfg, parallel=ParallelConfig(), train=TrainConfig())
    init_state, train_step, _, _ = make_train_step(model, run)
    state = init_state(0)
    dc = DataConfig(vocab=cfg.vocab, seq_len=PT_SEQ, global_batch=PT_BATCH)
    out = {"losses": [], "grad_norms": [], "step_s": []}
    for step in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, host_batch(dc, step, 0, 1))
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
    out["m_bytes"] = sum(t.numel() * t.element_size() for t in leaves(state["opt"]["m"]))
    out["n_params"] = model.n_params()
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pt_counts() -> dict:
    """The launch counters as JSON: kernel -> {"variant|heads": n}."""
    return {k: {f"{v}|{h}": n for (v, h), n in d.items()}
            for k, d in ops.shape_counts().items() if d}


def _pt_cli(flags: list[str]) -> dict:
    """One run of the train CLI on this rank's world, its launches counted
    (zeroed before, read after)."""
    args = train_cli.build_parser().parse_args(PT_FLAGS + flags)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_cli.run(args, echo=False)
    wall = time.perf_counter() - t0
    row = {"losses": [res.losses[s] for s in sorted(res.losses)],
           "grad_norms": [res.grad_norms[s] for s in sorted(res.grad_norms)],
           "step_s": [res.step_s[s] for s in sorted(res.step_s)], "wall_s": wall,
           "lines": res.lines, "restarts": res.restarts, "mesh": res.mesh,
           "launches": _pt_counts(), "n_params": res.n_params,
           "m_bytes": sum(t.numel() * t.element_size() for t in leaves(res.state["opt"]["m"])),
           "v_bytes": sum(t.numel() * t.element_size() for t in leaves(res.state["opt"]["v"]))}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _pt_pipeline(dev) -> dict:
    """GPipe over a ``stage`` mesh of the two ranks: llama3.2-1b's train
    block at full width, :data:`PIPE_LAYERS` layers split into two stages,
    :data:`PIPE_MICRO` microbatches of 1 x :data:`PT_SEQ`; the output and
    the gradient of ``mean(out ** 2)`` with respect to this stage's weights
    against ``sequential_reference`` over every layer in this process."""
    cfg = PT_CONFIG().with_overrides(n_layers=PIPE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = cm.init_params(dense_mod.param_defs(cfg)["blocks"], gen, torch.bfloat16, dev)
    x = torch.randn(PIPE_MICRO, 1, PT_SEQ, cfg.d_model, generator=gen, device=dev
                    ).to(torch.bfloat16)
    positions = torch.arange(PT_SEQ, device=dev).expand(1, PT_SEQ)

    def block_fn(p, h):
        for layer in cm.unstack(p):
            h = cm.remat(dense_mod._block_train, cfg, layer, h, positions)
        return h

    mesh = DeviceMesh({"stage": 2})
    stage = mesh.index(("stage",))
    split = pipeline_pp.split_stages(blocks, 2)
    mine = {k: v[stage:stage + 1].clone().requires_grad_() for k, v in split.items()}
    _sync(dev)
    t0 = time.perf_counter()
    out = pipeline_pp.pipeline_forward(block_fn, mine, x, mesh)
    grads = torch.autograd.grad(out.float().square().mean(), leaves(mine))
    _sync(dev)
    wall = time.perf_counter() - t0
    whole = {k: v.clone().requires_grad_() for k, v in split.items()}
    ref = pipeline_pp.sequential_reference(block_fn, whole, x, 2)
    ref_grads = torch.autograd.grad(ref.float().square().mean(), leaves(whole))
    out, ref = out.detach(), ref.detach()
    fwd_err = _max_err(out, ref) / max(1.0, float(ref.float().abs().max()))
    grad_err = max(float((g.float() - r[stage:stage + 1].float()).norm()
                         / r[stage:stage + 1].float().norm().clamp_min(1e-30))
                   for g, r in zip(grads, ref_grads, strict=True))
    exact = torch.equal(out, ref) and all(torch.equal(g, r[stage:stage + 1])
                                          for g, r in zip(grads, ref_grads))
    del blocks, split, mine, whole, out, ref, grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "fwd_err": fwd_err, "grad_rel_norm": grad_err, "exact": exact}


def _pt_int8_psum(dev) -> dict:
    """``int8_psum`` of llama's ``embed`` leaf as int8 (a payload and a
    scale drawn per rank) over the world: against the formula from both
    ranks' payloads (each rank redraws the other's), bit for bit."""
    n, me = dist.get_world_size(), dist.get_rank()
    V, D = PT_CONFIG().padded_vocab(), PT_CONFIG().d_model

    def payload(r):
        gen = torch.Generator(device=dev).manual_seed(100 + r)
        q = torch.randint(-127, 128, (V, D), generator=gen, device=dev, dtype=torch.int8)
        return q, torch.rand((), generator=gen, device=dev) + 0.01

    q, scale = payload(me)
    _sync(dev)
    t0 = time.perf_counter()
    got = collectives.int8_psum(q, scale, dist.group.WORLD)
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    parts = [payload(r) for r in range(n)]
    total = functools.reduce(torch.add, [p.to(torch.int32) for p, _ in parts])
    want = total.float() * torch.stack([s for _, s in parts]).max() / float(n)
    return {"equal": torch.equal(got, want), "ms": ms, "shape": [V, D],
            "bytes": q.numel() * q.element_size()}


def placed_train_worker(out: Path, device: str | None = None) -> None:
    """A rank of the placed train paths (``chip_smoke.py
    --placed-train-worker DIR``, started by :func:`placed_train_phase` as
    torchrun starts one) on ``device`` (default: this rank's card); writes
    ``rank{r}.json``."""
    got = {}
    dev_flags = [] if device is None else ["--device", device]
    # through the train CLI: it joins the launcher's world
    got["placed-train-dp"] = _pt_cli(dev_flags + ["--layers", str(PT_LAYERS), "--steps",
                                                  str(PT_STEPS), "--model-parallel", "1"])
    got["placed-train-tp"] = _pt_cli(dev_flags + ["--layers", str(PT_LAYERS), "--steps",
                                                  str(PT_STEPS), "--model-parallel", "2"])
    rank = dist.get_rank()
    dev = rank_device(device)
    cfg = PT_CONFIG()
    walls = got["walls"] = {}
    t0 = time.perf_counter()
    mesh = make_host_mesh(1, device=dev)
    ops.reset_launch_counts()
    got["placed-train-fsdp"] = _pt_steps(cfg.with_overrides(n_layers=PT_FSDP_LAYERS), dev,
                                         Env(axes=mesh_axes(mesh), fsdp=True), mesh,
                                         PT_FSDP_STEPS)
    got["placed-train-fsdp"]["launches"] = _pt_counts()
    walls["fsdp"] = time.perf_counter() - t0
    f32 = cfg.with_overrides(n_layers=PT_F32_LAYERS, dtype="float32")
    for mp in (2, 1):
        t0 = time.perf_counter()
        mesh = make_host_mesh(mp, device=dev)
        got[f"placed-train-f32-mp{mp}"] = _pt_steps(f32, dev, Env(axes=mesh_axes(mesh)), mesh,
                                                    PT_STEPS)
        walls[f"f32-mp{mp}"] = time.perf_counter() - t0
    # a checkpoint written on data 2 x model 1 restored on data 1 x model 2
    ck = out / "ckpt"
    # on the reduced model since slice 21: at full width the embedding's
    # state made its three saves and one restore cost ~22 s of I/O
    restore = dev_flags + ["--reduced", "--layers", str(PT_F32_LAYERS), "--steps", str(PT_STEPS),
                           "--ckpt-every", str(PT_CKPT), "--ckpt-dir", str(ck)]
    t0 = time.perf_counter()
    got["placed-train-restore-dp"] = _pt_cli(restore + ["--model-parallel", "1"])
    if rank == 0:
        for d in ck.iterdir():
            if d.name.startswith("step_") and int(d.name[5:]) != PT_CKPT:
                shutil.rmtree(d)
    dist.barrier()
    got["placed-train-restore-tp"] = _pt_cli(restore + ["--model-parallel", "2"])
    walls["restore"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got["pipeline"] = _pt_pipeline(dev)
    walls["pipeline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got["int8_psum"] = _pt_int8_psum(dev)
    walls["int8_psum"] = time.perf_counter() - t0
    got["backend"] = dist.get_backend()
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _pt_expected(label: str, row: dict, layers: int, steps: int, heads: str) -> dict:
    """A train path's launches per rank (the lse forward twice a layer
    under remat, the backward once), checked against the counters."""
    want = {"prefill_attention": {f"lse|{heads}": 2 * layers * steps},
            "flash_attention_bwd": {f"unscaled|{heads}": layers * steps}}
    if row["launches"] != want:
        raise AssertionError(f"[{label}] launches {row['launches']}, expected {want}")
    return want


def placed_train_phase(dev) -> dict[str, PathRun]:
    """The placed train paths of llama3.2-1b at full width: two ranks of
    this script on the one card over gloo (``--placed-train-worker``),
    after one-rank runs of the same work in this process.

    placed-train-dp (data 2 x model 1, ZeRO-1 moments) and placed-train-tp
    (data 1 x model 2) through the train CLI: :data:`PT_LAYERS` layers,
    :data:`PT_STEPS` steps of the CLI's global batch of 4 x 512; finite
    losses, step 0's within :data:`PT_LOSS_TOL` of one rank's, every rank's
    losses equal, ``m`` and ``v`` per rank half of the whole on data 2,
    the flash lse forward and backward launched 2 L and L times a step at
    the shard's heads.  placed-train-fsdp (data 2, ``Env.fsdp``) through
    ``make_train_step`` at :data:`PT_FSDP_LAYERS` layers; placed-train-f32
    (both meshes, float32, :data:`PT_F32_LAYERS` layers): losses and grad
    norms within :data:`PT_F32_TOL` of one rank's; placed-train-restore: a
    checkpoint of the reduced model written on data 2 x model 1 (every
    ``PT_CKPT`` steps)
    restored on data 1 x model 2, whose step ``PT_CKPT`` loss is the
    unbroken run's within :data:`PT_LOSS_TOL`; the GPipe pipeline over a
    ``stage`` axis against ``sequential_reference``; ``int8_psum`` of
    llama's ``embed`` leaf against its formula."""
    t_phase = time.perf_counter()
    freed_card(dev, "placed-train")
    cfg = PT_CONFIG()
    one = {}
    t0 = time.perf_counter()
    args = train_cli.build_parser().parse_args(
        PT_FLAGS + ["--layers", str(PT_LAYERS), "--steps", "1"])
    res = train_cli.run(args, echo=False)
    one["bf16"] = res.losses[0]
    del res
    one["fsdp"] = _pt_steps(cfg.with_overrides(n_layers=PT_FSDP_LAYERS), dev, Env(), None,
                            PT_FSDP_STEPS)
    one["f32"] = _pt_steps(cfg.with_overrides(n_layers=PT_F32_LAYERS, dtype="float32"), dev,
                           Env(), None, PT_STEPS)
    print(f"[placed-train] one rank: step 0 loss {one['bf16']:.6f} at {PT_LAYERS} layers; "
          f"fsdp's {PT_FSDP_LAYERS} layers {one['fsdp']['losses']}; float32 at "
          f"{PT_F32_LAYERS} layers losses {one['f32']['losses']} grad norms "
          f"{one['f32']['grad_norms']} ({time.perf_counter() - t0:.1f}s)")
    freed_card(dev, "placed-train ranks")
    out = Path(tempfile.mkdtemp(prefix="placed-train-"))
    try:
        t0 = time.perf_counter()
        _spawn_ranks(out, "--placed-train-worker", PT_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        got = [json.loads((out / f"rank{r}.json").read_text()) for r in range(PLACED_RANKS)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    g0 = got[0]
    print(f"[placed-train] {PLACED_RANKS} ranks on one card, backend {g0['backend']}, "
          f"{ranks_s:.1f}s from start to exit; walls (rank 0): dp "
          f"{g0['placed-train-dp']['wall_s']:.1f}s, tp {g0['placed-train-tp']['wall_s']:.1f}s, "
          + ", ".join(f"{k} {v:.1f}s" for k, v in g0["walls"].items()))
    G, Dh = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim()
    heads = {1: kernel_heads(cfg.n_kv_heads, G, Dh), 2: kernel_heads(cfg.n_kv_heads // 2, G, Dh)}
    rows = {1: ("prefill_attention[train-lse-dp2]", "flash_attention_bwd[dp2]"),
            2: ("prefill_attention[train-lse-tp2]", "flash_attention_bwd[tp2]")}
    runs = {}
    tokens = PT_BATCH * PT_SEQ
    for label, mp in (("placed-train-dp", 1), ("placed-train-tp", 2)):
        r0 = g0[label]
        if not all(g[label]["losses"] == r0["losses"] for g in got):
            raise AssertionError(f"[{label}] the ranks' losses differ")
        want = {}
        for g in got:
            want = _pt_expected(label, g[label], PT_LAYERS, PT_STEPS, heads[mp])
        d = 2 // mp
        whole = 4 * r0["n_params"]
        err = abs(r0["losses"][0] - one["bf16"])
        ms = 1e3 * statistics.mean(r0["step_s"][1:])
        print(f"[{label}] {r0['lines'][0]}; losses {r0['losses']}, grad norms "
              f"{[round(x, 4) for x in r0['grad_norms']]}; step 0 vs one rank {err:.3e} (tol "
              f"{PT_LOSS_TOL}); m {r0['m_bytes'] / 1e9:.3f} GB and v {r0['v_bytes'] / 1e9:.3f} "
              f"GB per rank of {whole / 1e9:.3f} GB whole; launches per rank {r0['launches']} "
              f"(= 2 L and L a step); {ms:.1f} ms per step (steps 1-{PT_STEPS - 1}), "
              f"{tokens / PLACED_RANKS / (ms / 1e3):.1f} tok/s per rank; wall {r0['wall_s']:.1f}s")
        if not (all(math.isfinite(x) for x in r0["losses"]) and err <= PT_LOSS_TOL):
            raise AssertionError(f"[{label}] losses {r0['losses']} against one rank's "
                                 f"{one['bf16']}")
        if d == 2 and not all(g[label]["m_bytes"] == g[label]["v_bytes"] == whole // 2
                              for g in got):
            raise AssertionError(f"[{label}] m / v per rank are not half of the whole")
        runs[label] = PathRun({rows[mp][0]: want["prefill_attention"][f"lse|{heads[mp]}"],
                               rows[mp][1]: want["flash_attention_bwd"][f"unscaled|{heads[mp]}"]},
                              None, [], r0["wall_s"], None)
    fs = g0["placed-train-fsdp"]
    for g in got:
        _pt_expected("placed-train-fsdp", g["placed-train-fsdp"], PT_FSDP_LAYERS, PT_FSDP_STEPS,
                     heads[1])
    err = max(abs(a - b) for a, b in zip(fs["losses"], one["fsdp"]["losses"]))
    print(f"[placed-train-fsdp] data 2, Env.fsdp, {PT_FSDP_LAYERS} layers: losses "
          f"{fs['losses']} vs one rank {one['fsdp']['losses']}: {err:.3e} (tol {PT_LOSS_TOL}); "
          f"m {fs['m_bytes'] / 1e9:.3f} GB per rank; "
          f"{1e3 * statistics.mean(fs['step_s'][1:]):.1f} ms per step")
    if not err <= PT_LOSS_TOL:
        raise AssertionError("[placed-train-fsdp] losses differ from one rank's")
    runs["placed-train-fsdp"] = PathRun(
        {rows[1][0]: 2 * PT_FSDP_LAYERS * PT_FSDP_STEPS,
         rows[1][1]: PT_FSDP_LAYERS * PT_FSDP_STEPS}, None, [], sum(fs["step_s"]), None)
    for mp in (2, 1):
        r = g0[f"placed-train-f32-mp{mp}"]
        errs = [max(abs(a - b) / abs(b) for a, b in pairs) for pairs in (
            list(zip(r["losses"], one["f32"]["losses"])),
            list(zip(r["grad_norms"], one["f32"]["grad_norms"])))]
        first = [abs(r[k][0] - one["f32"][k][0]) / abs(one["f32"][k][0])
                 for k in ("losses", "grad_norms")]
        print(f"[placed-train-f32] data {2 // mp} x model {mp}: losses {r['losses']}, grad norms "
              f"{r['grad_norms']}; relative to one rank at step 0: loss {first[0]:.3e}, grad "
              f"norm {first[1]:.3e} (tol {PT_F32_TOL}); over the steps: {errs[0]:.3e}, "
              f"{errs[1]:.3e} (tol {PT_F32_STEP_TOL}); "
              f"{1e3 * statistics.mean(r['step_s'][1:]):.1f} ms per step")
        if not (max(first) <= PT_F32_TOL and max(errs) <= PT_F32_STEP_TOL):
            raise AssertionError("[placed-train-f32] losses or grad norms differ from one rank's")
    a, b = g0["placed-train-restore-dp"], g0["placed-train-restore-tp"]
    err = abs(b["losses"][0] - a["losses"][PT_CKPT])
    done = next(line for line in a["lines"] if line.startswith("done"))
    print(f"[placed-train-restore] saved on {a['mesh']} ({done}), restored on {b['mesh']} "
          f"from step {PT_CKPT}, the later checkpoints removed; step {PT_CKPT} loss "
          f"{b['losses'][0]:.6f} vs the unbroken run's {a['losses'][PT_CKPT]:.6f}: {err:.3e} "
          f"(tol {PT_LOSS_TOL}); wall {g0['walls']['restore']:.1f}s")
    if not (f"restored from step {PT_CKPT}" in b["lines"] and b["restarts"] == 0
            and err <= PT_LOSS_TOL):
        raise AssertionError("[placed-train-restore] the restored run differs")
    for g in got:
        p = g["pipeline"]
        print(f"[pipeline] stage 2, {PIPE_LAYERS} layers, {PIPE_MICRO} microbatches of 1 x "
              f"{PT_SEQ}: forward {p['fwd_err']:.3e} of max(1, |ref|), gradients "
              f"{p['grad_rel_norm']:.3e} in norm (tol {PIPE_TOL}); bit-equal {p['exact']}; "
              f"{p['wall_s'] * 1e3:.1f} ms forward + backward")
        if not (p["fwd_err"] <= PIPE_TOL and p["grad_rel_norm"] <= PIPE_TOL):
            raise AssertionError("[pipeline] the pipeline differs from sequential_reference")
        q = g["int8_psum"]
        print(f"[int8_psum] {q['shape']} int8 ({q['bytes'] / 1e6:.1f} MB a rank) over data 2: "
              f"equal to the formula {q['equal']}; {q['ms']:.1f} ms (gloo: a ring of int8 sends "
              "through pinned host memory)")
        if not q["equal"]:
            raise AssertionError("[int8_psum] differs from the formula")
    print(f"[placed-train] phase wall {time.perf_counter() - t_phase:.1f}s")
    return runs


def ptxas_lines(name: str) -> list[str]:
    """One line per kernel of ``csrc/<name>.cu`` from its build log
    (``-Xptxas -v``): registers, shared memory, spills."""
    lines, kern, spill = [], "?", ""
    for line in _build.build_log(name).splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEv", m.group(1))
            kern = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)[:80]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            lines.append(f"ptxas {name} {kern}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    t0 = time.perf_counter()
    walls: dict[str, float] = {}
    mark = [t0]

    def lap(name: str) -> None:
        """Record the seconds since the last lap as phase ``name``'s."""
        now = time.perf_counter()
        walls[name] = now - mark[0]
        mark[0] = now

    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc in parallel) -> {_build.build_dir()}")
    for name in _build.sources():
        for line in ptxas_lines(name):
            print(line)
    lap("build")

    rows = [decode_phase(dev), prefill_phase(dev), prefill_chunk_phase(dev),
            prefill_phase(dev, "int8"), prefill_phase(dev, "fp8"), prefill_f32_phase(dev),
            paged_phase(dev), paged_phase(dev, "fp8"), paged_phase(dev, "int8"),
            decode_phase(dev, "decode_attention[draft]"), prefill_chunk_phase(dev, tag="draft"),
            paged_phase(dev, bs=128), paged_phase(dev, "fp8", bs=128),
            decode_phase(dev, "decode_attention[moe]"), prefill_phase(dev, tag="moe")]
    for tag in WIDE_TAGS.values():
        rows += [decode_phase(dev, f"decode_attention[{tag}]"), prefill_phase(dev, tag=tag)]
        if tag != "internvl":           # dense only: every other family has a paged path
            rows += [prefill_chunk_phase(dev, tag), paged_phase(dev, tag=tag)]
    rows += [decode_phase(dev, "decode_attention[zamba2]"), prefill_phase(dev, tag="zamba2"),
             decode_phase(dev, "decode_attention[seamless]"),
             decode_phase(dev, "decode_attention[seamless-cross]"),
             prefill_phase(dev, tag="seamless")]
    rows += [train_lse_phase(dev), train_bwd_phase(dev), train_lse_phase(dev, "minicpm"),
             train_bwd_phase(dev, "minicpm")]
    rows += [decode_phase(dev, name) for name in
             ("decode_attention[lse]", "decode_attention[shard-head2]",
              "decode_attention[shard-seq2]")]
    # the placed paged paths (slice 19): a lane's shard of the pool, and the
    # chunk at a tensor-parallel rank's heads
    rows += [lane_phase(dev, kv, cut) for cut in ("block2", "pos2") for kv in (None, "fp8")]
    rows.append(prefill_chunk_phase(dev, "tp2"))
    # the placed tiered paths (slice 20): the int8 pool's lane, and the cold
    # window on a rank's share of the host tier (whole, or its positions)
    rows += [lane_phase(dev, "int8", "block2"), lane_phase(dev, "fp8", "whole", host=True),
             lane_phase(dev, "int8", "pos2", host=True)]
    for tag in TRAIN_TAGS.values():
        rows += [train_lse_phase(dev, tag), train_bwd_phase(dev, tag)]
    for tag in PT_TAGS:
        rows += [train_lse_phase(dev, tag), train_bwd_phase(dev, tag)]
    for r in rows:
        dev_off = (f" (at a device q_offset {r['device_offset_ms']:.4f})"
                   if "device_offset_ms" in r else "")
        in_norm = (f", in norm {r['rel_norm_err']:.2e} (tol {r['rel_norm_tol']})"
                   if "rel_norm_err" in r else "")
        print(f"kernel {r['name']}: err {r['max_abs_err']:.2e} (tol {r['tol']}){in_norm} "
              f"kernel {r['ms']:.4f} ms{dev_off} (events {r['event_ms']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']}")
    by_name = {r["name"]: r for r in rows}
    lap("kernel rows")
    freed_card(dev, "llama3.2-1b")
    model, params = load_model()
    L, k = model.cfg.n_layers, SPEC_DEPTH
    Ld = serve.load_draft(serve.build_parser().parse_args(SERVE_FLAGS), model)[0].cfg.n_layers

    def draft_chunks(st):
        """The draft's prefill chunks: its steps less k + 1 decodes per window."""
        return st.draft_steps - (k + 1) * st.spec_steps

    by_path: dict[str, PathRun] = {}

    def path(label, flags, want, **kw):
        if kw.get("eager") or kw.get("sync", True):
            kw["rerun_layers"] = RERUN_LAYERS
        by_path[label] = serve_phase(model, params, label, flags, want, by_name, **kw)

    def dense_want(st):
        return {"decode_attention": st.decode_steps * L, "prefill_attention": st.prefills * L}

    def paged_want(st):
        return {"prefill_attention[chunk]": st.prefill_chunks * L,
                "paged_decode_attention": st.decode_steps * L}

    def tiered_want(st):
        # every decode step attends twice per layer (hot and cold windows);
        # prefill runs unscaled on the bf16 staging cache
        return {"prefill_attention[chunk]": st.prefill_chunks * L,
                "paged_decode_attention[fp8]": 2 * st.decode_steps * L}

    path("dense", [], dense_want, eager=True)
    path("paged-hybrid", PAGED_FLAGS, paged_want, eager=True)
    path("paged-tiered", TIERED_FLAGS, tiered_want, tiered=True, eager=True)
    path("paged-tiered-int8", TIERED_INT8_FLAGS, lambda st: {
        "prefill_attention": st.prefills * L,
        "paged_decode_attention[int8]": 2 * st.decode_steps * L}, tiered=True)
    # speculative: each window is k + 1 verify passes of the target (L
    # layers) and k + 1 draft decodes (Ld layers); the draft's cache is
    # prefilled in 32-token chunks at its own heads
    path("dense-spec", SPEC_FLAGS, lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * L,
        "decode_attention[draft]": st.spec_steps * (k + 1) * Ld,
        "prefill_attention": st.prefills * L,
        "prefill_attention[draft-chunk]": draft_chunks(st) * Ld}, base=by_path["dense"],
        eager=True)
    path("paged-hybrid-spec", PAGED_FLAGS + SPEC_FLAGS, lambda st: {
        "paged_decode_attention": st.spec_steps * (k + 1) * L,
        "decode_attention[draft]": st.spec_steps * (k + 1) * Ld,
        "prefill_attention[chunk]": st.prefill_chunks * L,
        "prefill_attention[draft-chunk]": draft_chunks(st) * Ld},
        base=by_path["paged-hybrid"])
    # the target as its own draft: both decode at the target's heads, the
    # draft's cache prefilled in chunks of the hybrid chunk's shape
    path("target-draft", ["--spec-depth", str(k), "--requests", "16"], lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * 2 * L,
        "prefill_attention": st.prefills * L,
        "prefill_attention[chunk]": draft_chunks(st) * L},
        base=by_path["dense"], draft=(model, params))
    # the same on the dense hybrid schedule: the target's cache is then
    # filled by the very chunk calls that fill the draft's, so every
    # drafted token should be accepted (min_accept)
    path("target-draft-hybrid", ["--spec-depth", str(k), "--requests", "16", "--schedule",
                                 "hybrid"], lambda st: {
        "decode_attention": st.spec_steps * (k + 1) * 2 * L,
        "prefill_attention[chunk]": (st.prefill_chunks + draft_chunks(st)) * L},
        draft=(model, params), min_accept=0.99)
    # the open-loop workloads: shared documents hit the paged pool's prefix
    # cache; shared chat prefixes on the tiered pool; grown agentic turns
    path("rag", RAG_FLAGS, paged_want, open_loop=True)
    # the host tier fills (512 blocks) and then the pool preempts
    path("chat-fan", CHAT_FAN_FLAGS, tiered_want, tiered=True, open_loop=True, preempt_ok=True)
    path("agentic", AGENTIC_FLAGS, dense_want, open_loop=True)
    for label in ("rag", "chat-fan", "agentic"):
        run = by_path[label]
        pool = run.res.engine.pool.stats if label != "agentic" else None
        print(f"[{label}] workload: rounds {run.res.rounds}, resubmits "
              f"{run.res.driver.resubmits}, {_rate(run.res)}"
              + (f"; prefix hits {pool.hash_hits}, COW copies {pool.cow_copies}, spills "
                 f"{run.stats.spills}, rehydrations {run.stats.rehydrations}" if pool else ""))
    if by_path["rag"].res.engine.pool.stats.hash_hits <= 0:
        raise AssertionError("[rag] no prefix hit on the shared documents")
    if by_path["agentic"].res.driver.resubmits != 32:
        raise AssertionError("[agentic] 16 sessions x 3 turns should resubmit 32 times")
    lap("llama paths (load, dense .. agentic)")
    # the cluster tier: two replicas on the one card, sharing the weights;
    # each path's tokens held to its single-engine path's by the token floor
    for label, flags, want, base, kw in (
            ("cluster-affinity", AFFINITY_FLAGS, paged_want, "rag", {}),
            ("cluster-round-robin", ROUND_ROBIN_FLAGS, paged_want, "rag", {}),
            ("disagg", DISAGG_FLAGS, paged_want, "paged-hybrid", {}),
            ("disagg-tiered", DISAGG_TIERED_FLAGS, tiered_want, "paged-tiered",
             dict(tiered=True))):
        by_path[label] = cluster_phase(model, params, label, flags, want, by_name,
                                       by_path[base], **kw)
    hit = {p: by_path[p].stats.prefix_hit_rate for p in ("cluster-affinity",
                                                          "cluster-round-robin")}
    print(f"[cluster] router prefix hit rate: prefix_affinity {hit['cluster-affinity']:.4f}, "
          f"round_robin {hit['cluster-round-robin']:.4f}")
    lap("cluster paths")
    # sub-batch pipelining: two sub-batches of 8 rows, each on its own
    # stream inside the decode graph: the dense decode kernel twice a layer
    path("sub-batches", SUB_BATCH_FLAGS, lambda st: {
        "decode_attention": 2 * st.decode_steps * L, "prefill_attention": st.prefills * L},
        eager=True)
    # a sub-batch's decode GEMMs have 8 rows, the dense path's 16, and
    # cuBLAS sums the 8192-deep FFN-down product of 8 rows in another order
    # (1-ulp differences in ~0.2% of its outputs, which the random-weight
    # model amplifies until a near-tie flips): the plain engine whose decode
    # batch has 8 rows must give the sub-batches' tokens exactly
    path("dense-8", ["--slots", "8"], dense_want)
    sub = by_path["sub-batches"].res.driver.submitted
    agreement("sub-batches", sub, by_path["dense-8"], exact=True)
    agreement("sub-batches", sub, by_path["dense"], floor=False)
    sub_batch_phase(model, params)
    lap("sub-batches, dense-8")
    by_path.update(placed_phase(model, params, by_path))
    lap("placed")
    by_path.update(world_phase(model, params, by_path, by_name))
    lap("world (world-disagg, placed-disagg)")
    # the dense cache's int8 kv_quant form, on llama's weights (the same
    # parameters): the prefill attends over unquantized K/V, so every first
    # token must be the dense path's; the later ones are printed beside
    # kvq_sensitivity's yardstick (the random-weight model amplifies any
    # change of its cache, a 1-ulp one too)
    model_q = build_model(model.cfg.with_overrides(kv_quant=True), dev)
    by_path["dense-kvq"] = serve_phase(model_q, params, "dense-kvq", [], dense_want, by_name,
                                       sync=False)
    kvq, dense = by_path["dense-kvq"].res, by_path["dense"].res
    agreement("dense-kvq", kvq.driver.submitted, by_path["dense"], floor=False)
    ratio = kvq.engine.kv_bytes() / dense.engine.kv_bytes()
    if not (all(a.out_tokens[0] == b[0] for a, b in zip(kvq.driver.submitted,
                                                        by_path["dense"].tokens, strict=True))
            and ratio < KVQ_BYTES):
        raise AssertionError(f"[dense-kvq] a first token differs from dense's, or the cache is "
                             f"{ratio:.4f}x of bf16's")
    kvq_sensitivity(model, model_q, params)
    print(f"[dense-kvq] cache {kvq.engine.kv_bytes() / 1e9:.4f} GB against bf16's "
          f"{dense.engine.kv_bytes() / 1e9:.4f} GB: {ratio:.4f}x (< {KVQ_BYTES}); "
          "wall ms per decode step "
          f"{kvq.wall_s * 1e3 / kvq.stats.decode_steps:.3f} against dense's "
          f"{dense.wall_s * 1e3 / dense.stats.decode_steps:.3f} (prefills included)")
    # the dequantize a kv_quant decode step runs before the kernel, per layer
    c = kvq.engine.cache
    deq_ms = _device_ms([lambda: (dense_mod._kv_dequantize(c["k"][0], c["k_scale"][0]),
                                  dense_mod._kv_dequantize(c["v"][0], c["v_scale"][0]))])
    deq_bytes = 2 * c["k"][0].numel() * 3 + 2 * c["k_scale"][0].numel() * 2
    print(f"[dense-kvq] dequantize of one layer's K and V ({tuple(c['k'][0].shape)} int8 and "
          f"bf16 scales -> bf16): {deq_ms:.4f} ms device ({deq_bytes / 1e6:.1f} MB moved, bound "
          f"{deq_bytes / PEAK_BYTES_S * 1e3:.4f} ms); x {L} layers = {deq_ms * L:.3f} ms per "
          "decode step")
    del kvq, dense, c
    profile_phase(model_q, params, "dense-kvq", [], warm_steps=4, drain=False)
    lap("dense-kvq")
    observatory_phase(model, params)
    lap("observatory")
    print("phase walls: " + ", ".join(f"{p} {r.wall_s:.1f}s" for p, r in by_path.items()))
    # with graphs only: llama's eager profiles are left out to keep the
    # script inside its time (moonshot's stays)
    profile_phase(model, params, "dense", [], warm_steps=4)
    profile_phase(model, params, "paged-hybrid", PAGED_FLAGS, warm_steps=48)
    # 60 steps in, the profile's 32 requests have filled the pool and begun to spill
    profile_phase(model, params, "paged-tiered", TIERED_FLAGS, warm_steps=60)
    profile_phase(model, params, "dense-spec", SPEC_FLAGS, warm_steps=4)
    lap("llama profiles")
    # free llama's weights and every engine (caches, graph pools): each
    # family below loads on a card freed of the one before (freed_card)
    del model, model_q, params, run, sub
    by_path = {p: r._replace(res=None) for p, r in by_path.items()}
    for arch in WIDE_TAGS:
        by_path.update(family_phase(dev, arch, by_name))
        lap(arch)
    by_path["moe"] = moe_phase(dev, by_name)
    lap("moe")
    deepseek_phase(dev)
    lap("deepseek")
    for arch, tag in RECURRENT_TAGS.items():
        by_path[tag] = recurrent_phase(dev, arch, by_name)
        lap(tag)
    by_path["seamless"] = seamless_phase(dev, by_name)
    lap("seamless")
    by_path.update(train_phase(dev, by_name))
    lap("train (llama, minicpm, the families)")
    by_path.update(placed_train_phase(dev))
    lap("placed-train")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference_check(dev)
    preemption_check(dev)
    host_tier_check(dev)
    spec_reference_check(dev)
    block128_check(dev)
    temperature_check(dev)
    migration_check(dev)
    cluster_reference_check(dev)
    sub_batch_check(dev)
    moe_reference_check(dev)
    wide_reference_check(dev)
    deepseek_reference_check(dev)
    print(f"reduced checks: {time.perf_counter() - t0:.1f}s")
    lap("reduced checks")
    for r in rows:
        r["launches_by_path"] = {p: run.launches.get(r["name"], 0)
                                 for p, run in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        # on no serving path: the scaled and f32 prefill variants (the
        # reference's quantized pools prefill into the bf16 staging cache;
        # float32 mode runs in the reference checks) and block size 128
        # (a --block-size the serve paths do not pass; block128_check runs
        # it at reduced size)
        # and the lse decode at the serve shape (the placed-seq path
        # launches it at each rank's window, counted in [shard-seq2]); the
        # position cut of the placed pool (the placed-paged paths' 258
        # blocks split the block axis; 385 would cut the positions)
        r["on_main_path"] = not ((r["kernel"] == "prefill_attention"
                                  and r["variant"] not in ("unscaled", "lse"))
                                 or "bs128" in r["name"] or "lane-pos2" in r["name"]
                                 or r["name"] == "decode_attention[lse]")
        if r["on_main_path"] and not r["launches"]:
            raise AssertionError(f"{r['name']} never launched on the main paths")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {sum(walls.values()):.1f}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--placed-worker"]:
        placed_worker(Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--placed-train-worker"]:
        placed_train_worker(Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--world-worker"]:
        world_worker(Path(sys.argv[2]))
    else:
        main()
