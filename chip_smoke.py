#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port on one NVIDIA H100:

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch/CUDA versions,
   compute capability (sm_90 required); TF32 is switched off so every
   float32 reference is full float32.
2. Kernels: builds the CUDA sources of coot_videotext_tpu_torch/csrc with
   nvcc (sm_90a) and holds each kernel (B1 input FC, B2 GenPool, B3 masked
   attention, forward and backward, B4 dropout and B5 row gather) against
   its plain PyTorch version on the card, in bfloat16 and float32, at the
   slices' shapes and edge cases (ragged S, constant rows, all-masked rows,
   Lq = 1, B1 at the video global net's 5,120 x 4096, a ragged 4,099 x
   4096, rows of 100 + 0.5 N, S = 17 and 1, din 48 -> dout 32, B2 at the
   four calls of a train step (and D 32 / H 64, one head at D 32 and
   128 / H 64, D 512), B3 at the video context's N = 512, L = 24, 320, a
   ragged 37 x 130 (also at d_head 16 and 64) and Lq = 1 over 130 keys,
   dropout on with one seed (a seed state on the card, from which each
   kernel derives its seed, as philox.derive_seed does on the host): the
   masks must agree exactly; B2's and B3's
   forwards and B1's, B2's and B3's backwards repeat bit for bit, B2's
   errors printed by gradient, its db2 at
   dropout 0.1 also held relative to its own largest value;
   B4 bit-equal, also on a misaligned view and a transposed cotangent; B5
   bit-equal, its noise's bounds and std, a 4.4 GB table).
3. Validation at full width: generates a synthetic YouCook2-like val set
   (4096-d video / 1536-d text features, 128 val videos) in a temporary
   directory and runs `python -m coot_videotext_tpu_torch.train_retrieval
   -c <yc2_2d3d_coot.yaml with npy features> --validate --ignore_untrained
   --save_embeddings` in-process four ways (host dense, host slab, device
   store with host index collation, device store with on-device sampling
   and packing via --fixed_shapes), each with every kernel's launch count
   set to 0 just before and read just after; checks finite embeddings,
   every mode's rows against mode 1's (cosine), device ranks against host
   ranks, and one batch against the port on the CPU in float32; the
   captured eval step on an id batch of mode 4 is traced in a warm
   replay, where B1, B2, B3 and B5 must each appear by kernel name.
4. Training at full width (bf16 compute, f32 master weights, dropout 0.01
   at every site, frame noise 0.01): on a generated 256-video train split
   the CLI trains one epoch from the device store with on-device sampling
   and packing, validates and checkpoints, with every launch count set to
   0 just before and read just after; `--validate --load_epoch 0` reads
   the checkpoint back; the run resumes for 4 more epochs (16 steps),
   which time training end to end; the store with host-sampled index
   batches (the config's default, no --fixed_shapes) trains one epoch (the
   host dense path trains in phase 10a); one fixed id batch
   trained 16 steps must lower its loss; the warm train step is timed,
   profiled and its peak memory read.
4b. synthetic_smoke.yaml trains one epoch through the CLI from the device
   store, in float32 as shipped and in bfloat16: its text input FC (48 ->
   32) runs B1's backward on padded widths, its GenPool (D 32, H 64) B2's.
4c. The group step: on a generated 640-video train split (10 steps an
   epoch) the CLI trains one epoch with `-o train.steps_per_dispatch=4
   --preload_device --fixed_shapes` in groups of 4, 4 and 2, each step
   after the first a replay of the captured train step, with every launch
   count set to 0 just before and read just after (the wrappers count at
   the eager first step and at the capture); the run resumed to 3 epochs
   and the per-step CLI on the same split time epochs 1-2 end to end; one
   fixed id batch trains 16 steps per step and as 2 groups of 8 replays
   from the same state (no wrapper runs during them): seed states equal,
   losses and parameters within the bf16 tolerance, the loss falling; for
   K = 1, 4 and 8, the warm wall ms per step, the profiler's device-busy ms
   per step (max(K, 2) steps traced), train videos/s and peak device
   memory, and for K = 4 the device time per step by kernel family.
5. Times each kernel, forward and backward, at the main path's shapes (CUDA
   events) beside its plain version, its library yardstick where one
   exists, and its bound; B1 at all four calls of a step (clips, video
   global, paragraph, sentences), each first held against its plain
   version (forward and backward, at that call's row splits) and its
   backward repeated bit for bit, with the profiler's device time by
   kernel (row_stats alone among them), the host time per backward call
   and torch.matmul of its product alone as `product_ms`; B2's forward
   (with and without the stats: train and eval; the tile pass and the
   pooling pass apart) and backward at the same four calls, each held
   against its plain version and repeated bit for bit, the backward
   through autograd with the profiler's device time of the tile pass and
   the weight-gradient products apart; B3's forward at the step's six
   shapes (clips, video context, paragraph, sentences, global, cross),
   train and eval, in turns with SDPA; B3's backward at the clips, the
   video context, the paragraph's L = 320 (its D pass) and the sentences;
   B4 and F.dropout's backward as bare launches, profiler device time,
   host time per call and through autograd; B5 at each store gather of a
   step, with and without noise.
6. Caption serving at the full width of yc2_2d3d_coot_vidclip_mart.yaml
   (hidden 768, 2 memory layers, 12 heads, vocabulary 992, f32): COOT
   embeddings from a seed for every video and clip of the real YouCook2
   caption splits (`.npz`, vid / ctx 768, clip 384) and the port's model
   from seed 0 with GloVe, saved as `{"model": state_dict}`; `python -m
   coot_videotext_tpu_torch.train_caption -c <yaml> --validate
   --load_model <pth>` in-process on the card over the 457-video val
   split (batches of 50, greedy), with every kernel's launch count set to
   0 just before and read just after (the caption path launches none):
   model and batches on the card, one translated sentence per sentence of
   the split, finite BLEU-4 / METEOR / ROUGE-L / CIDEr; val videos/s, the
   median eval-step and decode ms per batch, forwards per batch and peak
   memory printed. One batch of 8 videos on the card against the port on
   the CPU (loss within 1e-4 relative, n_correct within 0.5% of n_word, at
   least 98% of the greedy sentences token-identical); the first 2
   sentence steps of a greedy batch of 50 traced (wall and device-busy
   ms, launches per decoded token, device time by kernel family). The
   decodes and eval steps run as CUDA graphs (phase 13 holds them against
   the eager path).

7. Caption training at the full width of yc2_2d3d_coot_vidclip_mart.yaml
   (batch 16, S up to 12 sentence steps, dropout 0.1 at every site, the
   EMA, BertAdam with warmup_linear): `python -m
   coot_videotext_tpu_torch.train_caption -c <yaml> --seed 0` in-process
   on the card over the first 320 videos of the YouCook2 train split (20
   steps an epoch) for 2 epochs, validating on the first 50 val videos,
   with every kernel's launch count set to 0 just before and read just
   after (B4's forward and backward must run, B1-B3 and B5 must not):
   model and batches on the card, finite step losses and grad norms, the
   checkpoint, EMA and translation files; resumed to epoch 3 with
   `--load_epoch 1`; `--validate --load_epoch 2` must give the training
   run's epoch-2 val loss (the EMA weights). One train batch of 8 videos
   on the card against the port on the CPU, same weights and seed state,
   3 steps (loss, grad_norm, n_correct, every gradient, the parameters and
   the EMA after 1 and 3 steps, tolerances at CAPTION_TRAIN_*); one batch
   of 16 trained 16 steps at a fixed lr (the loss falls; the warm step's
   median wall ms, one traced step's device-busy ms and launches by
   family, B4 apart; peak memory); B4 in float32 at the caption shapes
   (16, 25, 768) and (16, 12, 25, 25), bit-equal to its plain version,
   timed bare and through autograd beside F.dropout and its bound.

8. The caption variants of the shipped configs, at full width, inputs
   from seed 0, each with the launch counts set to 0 just before its CLI
   run and read just after (B4 forward and backward must run, nothing
   else). (a) Raw-feature MART at yc2_mart.yaml (3072-d rgb+flow
   features, L = 100 + 22, batch 16, dropout 0.1): the first 160 train
   and 50 val videos of the real YouCook2 caption annotations copied to
   the temporary directory, features generated there by the port's
   generate_caption_video_features (resnet 2048 + bn 1024 rows at 2 a
   second of each video's duration, ~2 GB); `train_caption -c
   yc2_mart.yaml --video_feature_dir <dir>` trains one epoch and
   validates, then `--validate --load_epoch 0` must give the training
   run's val loss (the EMA weights); one train batch of 4 videos card
   against CPU over 3 steps (phase 7's tolerances); one val batch of 2
   videos: eval step within phase 6's tolerances and greedy tokens
   identical card against CPU; one batch of 16 trained 16 steps: the loss
   falls, the warm step's wall and device-busy ms, B4 the only port kernel
   of a traced step, peak memory. (b) The MTransformer at
   yc2_100m_coot_vidclip_mtrans.yaml (COOT vid+clip embeddings from seed
   0, 1152-d, single sentences, batches of 16 and 50): the same checks,
   the CLI over the sentences of the first 320 train and 50 val videos,
   a train batch of 16 and a val batch of 50 sentences card against CPU.
   (c) B4 in float32 bit-equal to its plain version at the new shapes
   (two of them with element counts that are no multiple of 4), timed
   bare and through autograd beside F.dropout, and its bound.

9. The rest of the caption family at the full width of
   yc2_2d3d_coot_vidclip_mart.yaml (COOT vid+clip embeddings from seed 0),
   each reached by `-o` overrides of it and each CLI run with the launch
   counts set to 0 just before and read just after. (a) Beam search
   (use_beam=true; beam 2, n_best 1, min_sen_len 5, max_sen_len 30 from
   the yaml) on MART trained one epoch by the CLI on the first 160 train
   videos: one val batch of 50 videos beam-decoded on the card, its first
   4 on the CPU too, in the fixed and the reference_compat mode (at
   least 98% of those sentences token-identical), beam against greedy on
   the card (ms,
   forwards, host reads), one traced beam decode of its first
   TRACE_STEPS sentence steps (no port kernel),
   `--validate --load_epoch 0 -o use_beam=true` over 50 val videos.
   (b-e) The TransformerXL (xl=true), the untied model
   (recurrent=false,untied=true), the joint single-sentence model
   (recurrent=false) and the decoder tied to the word embeddings
   (share_wd_cls_weight=true,word_vec_size=768,use_glove=false): the CLI
   trains one epoch on the first 160 train videos and validates on 50
   (B4 forward and backward, nothing else), `--validate --load_epoch 0`
   gives its val loss; from its weights a train batch card against CPU
   over 3 steps (phase 7's tolerances; XL's with xl_grad=true), a val
   batch's eval step and greedy tokens card against CPU (identical), a
   train batch of 16 trained 16 steps, timed and traced (B4 the only
   port kernel). (f) B4 bit-equal to its plain version at the new shapes,
   timed beside F.dropout, and its bound.

10. The prefetch pipeline and the tail. (a) On a generated 64 + 64-video
   split at yc2_2d3d_coot width with `preload_device: false`: a train and
   a val batch of 16 of the dense and the slab layout through
   data/pipeline.py `prefetch` equal to `to_device`'s on the card
   (torch.equal, host frame noise on); the dense CLI trains 1 step of 64
   and validates (train and val videos/s, the step meter's "other"
   share), then 1 step and a val batch under torch.profiler (the pinned
   copies must run on streams of their own; their time under a kernel is
   printed; tools/host_path.py); B1-B4 must run, B5 not; the slab CLI
   trains 1 step and validates (B5 runs). (b) S3D at full width, 2
   generated videos of 256 frames of 256 x 256 (16 windows of 32 each,
   one batch of 16) through the extractor's CLI where PIL is installed
   (else its
   `extract_video` on the arrays, and it says so), float32 and bfloat16,
   no port kernel launched; bf16 against f32 features (cosine >= 0.99);
   one window card against CPU (f32 within 1e-4 of max |CPU|, bf16
   cosine >= 0.99); a batch timed (windows/s), traced (device-busy share,
   device time by family; the trace must hold a device record for every
   kernel launched, traced again up to 3 times), its GFLOP a window from
   the conv shapes and the share of the dense peak, peak memory; bf16
   NCDHW against channels-last-3d weights. (c) The MLP example trained 2 epochs,
   resumed to 3 and epoch 2 reloaded on the card (the reloaded val loss
   equals training's). (d) profile_device_and_ram (a 2 GiB block shows)
   and a trace() file holding each of its 61 launches as a kernel on the
   card (traced again, up to 3 times, where it lost some; the first
   kernel's start after its launch is logged). Every trace first launches
   and waits for empty kernels (utils/profiling.py `warm_trace`), which
   are left out of its counts and times; a trace with fewer device
   records than kernel launches says so.

11. Data parallelism (parallel/mesh.py) at yc2_2d3d_coot width, global
   batch 64, on a generated 128 + 64-video split, the store with device
   sampling and packing: (a) W = 1 over NCCL (a process group of one
   rank) bit-equal to no process group over 3 steps and a group of 4
   (bf16, dropout and noise on; B1-B5 launched); (b) W = 2 rank processes
   on the one card over gloo (a probe of two NCCL ranks on one card logs
   NCCL's refusal) against W = 1 in f32 at dropout 0: loss and grad_norm
   within 1e-4 relative, parameters within 5% of lr a step, the ranks
   equal; 3 steps at dropout 0.01 launch B1-B5 on each rank, and the
   first B4 mask of their first step (a forward hook) differs between the
   ranks while rank 0's equals one process's on the same rows; (c) MART at
   yc2_2d3d_coot_vidclip_mart width, 3 steps on each rank's 8 of 16
   videos against W = 1 (phase 7's tolerances), the EMA equal on both
   ranks; (d) `torchrun --standalone --nproc_per_node=1` of the retrieval
   CLI (NCCL) writes the single-process CLI's files and model keys.

12. Tensor parallelism (parallel/tp.py) at {data: 1, model: 2}: two rank
   processes on the one card over gloo, started beside phase 11's, each
   holding half of the 26 COOT and 22 MART kernels that JAX's rules shard:
   (a) phase 11b's retrieval run against one process (the same
   tolerances), the ranks' whole parameters equal, the eval batch on the
   sharded model against the checkpoint rank 0 saved (whole tensors)
   loaded into one process (loss parts within 1e-4); (b) 3 steps at
   dropout 0.01 launch B1-B5 on each rank, B1 at dout 192 and B3 at 4
   heads, the first B4 mask (a replicated site) equal on both ranks and
   B3's first keep mask (the rank's heads) different; (c) phase 11c's
   MART steps against one process, the EMA equal on both ranks, and a
   greedy decode of the batch token-identical to one process's with the
   saved weights (eagerly on the ranks: gloo runs on the host; through
   the graphs in one process); (d) the TransformerXL and the joint model,
   which run replicated under a `model` axis as JAX runs them: one step
   on each rank equal, bit for bit, to one process's.

13. The serving programs as CUDA graphs (utils/graphs.py), each against
   the eager path on the same weights and inputs: (a) MART at
   yc2_2d3d_coot_vidclip_mart width over the 457-video YouCook2 val split
   (phase 6's inputs): the eval step (equal to eager within 1e-5), then
   greedy and beam (fixed) decoded eagerly and through the graphs, every
   sentence token-identical, beam reference_compat on the first batch;
   ms, forwards, host reads and program runs a batch, the graphs' extra
   peak memory, the first 2 sentence steps of batch 0 traced each way
   (device busy, the host's kernel launches a forward); (b) the
   TransformerXL, the untied and joint models (phase 9's widths) and the
   MTransformer (yc2_100m_coot_vidclip_mtrans) from seed 0: the eval step
   and the greedy decode of one val batch, identical; (c) retrieval on
   yc2_2d3d_coot.yaml id batches (128 generated val videos): validation
   through the graph (capturing, then warm) and eagerly, embeddings,
   losses and metrics equal (bf16 within 1e-2 allowed; bit for bit
   expected), device ranks equal host ranks, the warm eval step timed and
   traced each way: the wrappers' launches (a replay runs none) and the
   port's kernels on the device by name, B1, B2, B3 and B5 each present
   in the traced replay and as many as in the eager step; (d, e)
   anet_coot.yaml (2048-d video) and yc2_100m_coot.yaml (512-d video),
   one batch of 64 generated val videos each: the same,
   the card in f32 against the CPU (1e-4), and B1-B3 against their plain
   versions at the batch's shapes. The phase logs its time against
   SERVING_LIMIT_S. Phase 2b runs B3's bf16 backward against its plain
   version over B3_SEEDS draws at each of phase 2's shapes, each held to
   phase 2's gate.

14. The caption train step as a captured program (tasks/caption/steps.py
   `train_programs`) for every caption model the CLI trains, from seed 0
   at its yaml's dropout (B4 at every site) and batch size: MART at
   yc2_2d3d_coot_vidclip_mart width over two sentence-step buckets (S = 4
   and 12), raw-feature MART (yc2_mart), the TransformerXL with and
   without xl_grad, the tied decoder, the untied and joint models (phase
   9's widths) and the MTransformer (yc2_100m_coot_vidclip_mtrans): 8
   steps through the programs and 8 eager steps from an equal state on the
   same batches at changing lrs, every step's metrics and the whole state
   after them bit for bit equal, each key's first call exactly one step;
   each path's warm step (wall ms, the trainer's one read included), one
   traced warm step each way (device busy, the host's kernel and graph
   launches, the port's kernels by name: B4 alone, as many in the replay
   as eagerly) and each path's peak memory (the programs' extra). The
   phase logs its time against TRAIN_PROGRAMS_LIMIT_S. Phases 7-9 time
   the eager step (`eager=True`); their CLI runs train through the
   programs.

The order of a run: phase 1 and the build of phase 2; then phases 6-8
and phase 9 (the caption family, which shares nothing with the rest) in
two processes of their own (`--side-phases`, each with SIDE_THREADS
intra-op threads on the host), beside the rest of phase 2, 2b, 3, 4, 4b
and 10-12 in the main one, whose host and device times they share; their
logs are printed after phase 12; then, with the card the main process's
alone, 4c, 5, 13 and 14, which time it. Phase 4c also logs what the
in-process CLI runs left allocated on the card (as left, after a garbage
collection, after utils/graphs.py `release_all`). The synthetic retrieval splits
(DATA_SPLITS) are written by DATA_WORKERS worker processes from the
start, each moved into its phase's directory when the phase needs it.
Every worker and side process is stopped at exit.

Prints `{"kernels": [...]}` on the line before the last (each entry's
`eval_graph_launches`: the port's kernels of its source on the device in
the traced replay of (c)'s captured eval step, by name;
`caption_train_graph_launches`: B4's kernel in a traced warm replay of
MART's captured train step in phase 14, by name: B4's forward and
backward are one kernel function, so the count holds both directions and
stands on `dropout`, with 0 on `dropout_bwd` and the other kernels;
`caption_train_eager_launches`: the same step run eagerly, by the
wrappers' counts, forward on `dropout` and backward on `dropout_bwd`,
whose sum phase 14 holds equal to the replay's count) and
`{"ok": true, "device": {...}}` as the last line; exits non-zero (and
prints no result) on any failure, without a CUDA device, or outside a
checkout of the repository.
"""

from __future__ import annotations

import atexit
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

# the process's start: phase 10d logs the age with the trace's first kernel
STARTED = time.time()
ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "coot_videotext_tpu_torch"
CONFIG = ROOT / "config" / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"
SMOKE = ROOT / "config" / "retrieval" / "default" / "synthetic_smoke.yaml"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances, max |kernel - plain| / max(1, max |plain|):
# float32: the two sum in different orders (1e-4 covers K = 4096 sums);
# bfloat16: the outputs are rounded to 8 significant bits, so two float32
# results that differ in the last digits can land one bf16 step apart
# (2^-7 relative at worst).
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# One batch on the card in bfloat16 against the CPU in float32, and each
# validation path against the host dense one: cosine of each embedding row.
MIN_COSINE = 0.99


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def errors(out, ref):
    """(max abs error, the same relative to max(1, max |ref|))."""
    out, ref = out.detach().float(), ref.detach().float()
    if not bool(out.isfinite().all()):
        return math.inf, math.inf
    err = float((out - ref).abs().max())
    return err, err / max(1.0, float(ref.abs().max()))


def device_seed(value: int = 20261016, call: int = 0):
    """A kernel call's seed: a seed state of `value` on the card and the
    call's position (ops/philox.py); the kernels derive the seed there."""
    from coot_videotext_tpu_torch.ops import philox
    return philox.Seed(philox.seed_state(value, "cuda"), call)


def check_tol(name, dn, desc, err, rel) -> None:
    """Logs one check's error and fails when it is above TOL."""
    tol = TOL[dn]
    log(f"  {name:13s} {dn:8s} {desc:34s} max abs err {err:.3e}, "
        f"relative {rel:.3e} (tol {tol:.0e})")
    if not rel <= tol:
        fail(f"{name} {dn} {desc}: error {rel} > {tol}")


# ---------------- kernel inputs ----------------

def input_fc_inputs(s, din, dout, dtype, gen, constant_rows=0,
                    offset=False):
    """x ~ 2 N + 0.5, or with `offset` 100 + 0.5 N (mean^2 >> var: the
    norm's shifted sums); its first `constant_rows` rows constant."""
    import torch
    dev = "cuda"
    x = torch.randn(s, din, generator=gen, device=dev)
    x = x * 0.5 + 100.0 if offset else x * 2.0 + 0.5
    x[:constant_rows] = 3.0  # zero-variance rows
    gain = 1.0 + 0.1 * torch.randn(din, generator=gen, device=dev)
    bias = 0.1 * torch.randn(din, generator=gen, device=dev)
    w = torch.randn(dout, din, generator=gen, device=dev) / math.sqrt(din)
    b = 0.1 * torch.randn(dout, generator=gen, device=dev)
    return x.to(dtype), gain, bias, w.to(dtype), b


def genpool_inputs(s, length, d, h, heads, dtype, gen, masked_rows=0):
    import torch
    dev = "cuda"
    dh, dho = h // heads, d // heads
    f = torch.randn(s, length, d, generator=gen, device=dev)
    lens = torch.randint(1, length + 1, (s,), generator=gen, device=dev)
    mask = torch.arange(length, device=dev)[None] < lens[:, None]
    mask[:masked_rows] = False  # fully padded slots
    w1 = torch.randn(heads, d, dh, generator=gen, device=dev) / math.sqrt(d)
    b1 = 0.1 * torch.randn(heads, dh, generator=gen, device=dev)
    w2 = torch.randn(heads, dh, dho, generator=gen, device=dev) / math.sqrt(dh)
    b2 = 0.1 * torch.randn(heads, dho, generator=gen, device=dev)
    return f.to(dtype), mask, w1.to(dtype), b1, w2.to(dtype), b2


def attention_inputs(b, heads, lq, lk, dh, dtype, gen, masked_rows=0):
    import torch
    dev = "cuda"
    n = b * heads
    q = torch.randn(n, lq, dh, generator=gen, device=dev)
    k = torch.randn(n, lk, dh, generator=gen, device=dev)
    v = torch.randn(n, lk, dh, generator=gen, device=dev)
    lens = torch.randint(1, lk + 1, (b,), generator=gen, device=dev)
    key_valid = torch.arange(lk, device=dev)[None] < lens[:, None]
    key_valid[:masked_rows] = False  # every key masked
    return q.to(dtype), k.to(dtype), v.to(dtype), key_valid


# B3 at phase 2's shapes: (description, dropout rate, attention_inputs'
# (b, heads, lq, lk, dh[, masked rows]))
B3_SHAPES = (
    ("local N=8192 L=80", 0.0, (1024, 8, 80, 80, 48, 16)),
    ("local N=8192 L=80 dropout 0.1", 0.1, (1024, 8, 80, 80, 48, 16)),
    ("global Lq=Lk=16", 0.0, (64, 8, 16, 16, 48, 4)),
    ("cross Lq=1 Lk=16", 0.0, (64, 8, 1, 16, 48, 4)),
    ("paragraph Lq=Lk=300", 0.0, (64, 8, 300, 300, 48, 2)),
    ("sentences N=8192 L=24 dropout 0.1", 0.1, (1024, 8, 24, 24, 48, 16)),
    ("paragraph N=512 L=320 dropout 0.01", 0.01, (64, 8, 320, 320, 48, 2)),
    ("ragged Lq=37 Lk=130 dropout 0.1", 0.1, (64, 8, 37, 130, 48, 2)),
    ("video ctx N=512 L=80 dropout 0.01", 0.01, (64, 8, 80, 80, 48, 2)),
    ("Dh=16 Lq=37 Lk=130 dropout 0.1", 0.1, (64, 8, 37, 130, 16, 2)),
    ("Dh=64 Lq=37 Lk=130 dropout 0.1", 0.1, (64, 8, 37, 130, 64, 2)),
    ("cross Lq=1 Lk=130 dropout 0.1", 0.1, (64, 8, 1, 130, 48, 2)),
)
# B3's bf16 backward over many draws (phase_b3_seeds): draws per shape,
# each held to phase 2's gate
B3_SEEDS = 32


# ---------------- phases ----------------

def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}, capability sm_{cap[0]}{cap[1]}")
    if cap != (9, 0):
        fail(f"needs an sm_90 (Hopper) card, got sm_{cap[0]}{cap[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: float32 references are full "
        "float32")
    return card


def _kernel_name(mangled: str) -> str:
    """A kernel's name from its Itanium-mangled symbol: the last part of the
    nested name and, roughly, its template arguments (`input_fc_fwd_mma`,
    `row_stats<__nv_bfloat16>`, `row_stats<f>`)."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while s[:1].isdigit():
        n = re.match(r"\d+", s)[0]
        name, s = s[len(n):len(n) + int(n)], s[len(n) + int(n):]
    if s.startswith("I"):
        name += "<" + re.sub(r"^\d+", "", s[1:s.index("E")]) + ">"
    return name


def phase_build():
    from coot_videotext_tpu_torch.ops import cuda_build
    t0 = time.time()
    lib = cuda_build.build_library()
    cuda_build.load_library()
    log(f"built {lib.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    report = (lib.parent / "build.log").read_text(encoding="utf8")
    entries = [line.split("'")[1] for line in report.splitlines()
               if "Compiling entry function" in line]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [line.strip() for line in report.splitlines()
              if "spill" in line and not re.search(
                  r"0 bytes spill stores, 0 bytes spill loads", line)]
    log(f"  ptxas: {len(entries)} kernels, registers per thread "
        f"{min(regs, default=0)}-{max(regs, default=0)}; "
        f"{len(spills)} with spills" + "".join(
            f"\n    {line[:150]}" for line in spills))
    # per kernel: registers, static shared memory (the dynamic share is set
    # at launch) and spills, in the order ptxas compiled them
    name, spill = "?", ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name, spill = _kernel_name(line.split("'")[1]), ""
        elif "spill stores" in line:
            spill = "spills (stores/loads, bytes) " + "/".join(
                re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            log(f"    {name}: {re.search(r'Used (\d+)', line)[1]} registers, "
                f"{smem[1] if smem else 0} bytes static smem; {spill}")


def _grads(fn, inputs, dout):
    """Gradients of fn's output against dout through the autograd
    Function (the backward kernel on CUDA tensors)."""
    import torch
    inputs = [a.detach().clone().requires_grad_() for a in inputs]
    out = fn(*inputs)
    torch.autograd.backward(out, dout.to(out.dtype))
    return [a.grad for a in inputs]


def backward_case(name, args, rate, gen, g=None):
    """(kernel gradients, plain gradients) of one backward case; the
    differentiable inputs are f32 parameters (and f / q, k, v in the
    compute dtype), as on the main path. For input_fc and attention the
    kernel's list ends with the cotangent, which `g` passes in again."""
    import torch
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_backward_plain)
    from coot_videotext_tpu_torch.ops.genpool import (
        genpool, genpool_backward_plain)
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_backward_plain)
    seed = device_seed()
    if name == "input_fc":
        x, *params = args
        params = [p.float() for p in params]
        dy = g if g is not None else torch.randn(
            x.shape[0], params[2].shape[0], generator=gen, device="cuda")
        ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"),
                      params, dy)
        ours.append(dy)
        ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                            dy.to(x.dtype))
    elif name == "genpool":
        f, mask, *params = args
        params = [p.float() for p in params]
        dout = g if g is not None else torch.randn(
            f.shape[0], f.shape[2], generator=gen, device="cuda")
        ours = _grads(lambda f_, *p: genpool(f_, mask, *p, "gelu", rate,
                                             seed), [f] + params, dout)
        ours.append(dout)
        ref = genpool_backward_plain(f, mask, *params, "gelu",
                                     dout.to(f.dtype), rate, seed)
    else:
        q, k, v, kv = args
        if g is None:
            g = torch.randn(q.shape, generator=gen, device="cuda")
        ours = _grads(lambda *a: masked_attention(*a, kv, 8, 48 ** -0.5,
                                                  rate, seed), [q, k, v], g)
        ours.append(g)
        ref = masked_attention_backward_plain(q, k, v, kv, g.to(q.dtype), 8,
                                              48 ** -0.5, rate, seed)
    return ours, list(ref)


def phase_kernel_checks():
    """Each kernel, forward and backward, against its plain version on the
    card; B4 and the dropout of B2/B3 with one seed, where the masks must
    agree exactly."""
    import torch
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain)
    from coot_videotext_tpu_torch.ops.dropout import dropout, dropout_plain
    from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases += [
            ("input_fc", dn, "video clips S=81920 4096->384", 0.0,
             lambda dt=dtype: input_fc_inputs(81920, 4096, 384, dt, gen, 5)),
            ("input_fc", dn, "text, ragged S=1001 1536->384", 0.0,
             lambda dt=dtype: input_fc_inputs(1001, 1536, 384, dt, gen, 3)),
            ("input_fc", dn, "video global S=5120 4096->384", 0.0,
             lambda dt=dtype: input_fc_inputs(5120, 4096, 384, dt, gen, 5)),
            ("input_fc", dn, "ragged S=4099 4096->384", 0.0,
             lambda dt=dtype: input_fc_inputs(4099, 4096, 384, dt, gen, 7)),
            ("input_fc", dn, "offset 100 S=4099 4096->384", 0.0,
             lambda dt=dtype: input_fc_inputs(4099, 4096, 384, dt, gen, 7,
                                              offset=True)),
            ("input_fc", dn, "S=17 1536->384", 0.0,
             lambda dt=dtype: input_fc_inputs(17, 1536, 384, dt, gen, 2)),
            ("input_fc", dn, "S=1 4096->384", 0.0,
             lambda dt=dtype: input_fc_inputs(1, 4096, 384, dt, gen)),
            # synthetic_smoke's text input FC: the backward pads 48 -> 64
            ("input_fc", dn, "ragged widths S=1001 48->32", 0.0,
             lambda dt=dtype: input_fc_inputs(1001, 48, 32, dt, gen, 3)),
            ("genpool", dn, "clips S=1024 L=80", 0.0,
             lambda dt=dtype: genpool_inputs(1024, 80, 384, 768, 2, dt, gen,
                                             16)),
            ("genpool", dn, "clips S=1024 L=80 dropout 0.1", 0.1,
             lambda dt=dtype: genpool_inputs(1024, 80, 384, 768, 2, dt, gen,
                                             16)),
            ("genpool", dn, "paragraph S=37 L=300", 0.0,
             lambda dt=dtype: genpool_inputs(37, 300, 384, 768, 2, dt, gen,
                                             2)),
            ("genpool", dn, "L=1", 0.0,
             lambda dt=dtype: genpool_inputs(64, 1, 384, 768, 2, dt, gen)),
            # the four calls of a train step, dropout 0.01 as trained
            ("genpool", dn, "clips S=832 L=80 dropout 0.01", 0.01,
             lambda dt=dtype: genpool_inputs(832, 80, 384, 768, 2, dt, gen,
                                             16)),
            ("genpool", dn, "video ctx S=64 L=80 dropout 0.01", 0.01,
             lambda dt=dtype: genpool_inputs(64, 80, 384, 768, 2, dt, gen,
                                             2)),
            ("genpool", dn, "paragraph S=64 L=320 dropout 0.01", 0.01,
             lambda dt=dtype: genpool_inputs(64, 320, 384, 768, 2, dt, gen,
                                             2)),
            ("genpool", dn, "sentences S=832 L=24 dropout 0.01", 0.01,
             lambda dt=dtype: genpool_inputs(832, 24, 384, 768, 2, dt, gen,
                                             16)),
            ("genpool", dn, "D=32 H=64 S=64 L=20 dropout 0.1", 0.1,
             lambda dt=dtype: genpool_inputs(64, 20, 32, 64, 2, dt, gen, 2)),
            # one head of one 64-unit block (the pooler's default head
            # count): pass B's first step follows pass A's last closely
            ("genpool", dn, "1 head D=32 H=64 S=64 L=20 dropout 0.1", 0.1,
             lambda dt=dtype: genpool_inputs(64, 20, 32, 64, 1, dt, gen, 2)),
            ("genpool", dn, "1 head D=128 H=64 S=64 L=20 dropout 0.1", 0.1,
             lambda dt=dtype: genpool_inputs(64, 20, 128, 64, 1, dt, gen,
                                             2)),
            # two column groups
            ("genpool", dn, "D=512 H=512 S=64 L=37 dropout 0.1", 0.1,
             lambda dt=dtype: genpool_inputs(64, 37, 512, 512, 2, dt, gen,
                                             2)),
        ] + [("attention", dn, desc, rate,
               lambda dt=dtype, a=args: attention_inputs(*a[:5], dt, gen,
                                                         *a[5:]))
              for desc, rate, args in B3_SHAPES]
    for dtype in (torch.bfloat16, torch.float32):
        # B1 column-parallel under a model axis (parallel/tp.py): dout
        # 384 / M, a data rank's 33,280 clip frames at {data: 2}; drawn
        # after the cases above, which keep their inputs
        dn = str(dtype).split(".")[-1]
        cases += [
            ("input_fc", dn, "TP M=2 clips S=33280 4096->192", 0.0,
             lambda dt=dtype: input_fc_inputs(33280, 4096, 192, dt, gen, 5)),
            ("input_fc", dn, "TP M=4 clips S=33280 4096->96", 0.0,
             lambda dt=dtype: input_fc_inputs(33280, 4096, 96, dt, gen, 5)),
            ("input_fc", dn, "TP M=2 text, ragged S=1001 1536->192", 0.0,
             lambda dt=dtype: input_fc_inputs(1001, 1536, 192, dt, gen, 3)),
            ("input_fc", dn, "TP M=4 text, ragged S=1001 1536->96", 0.0,
             lambda dt=dtype: input_fc_inputs(1001, 1536, 96, dt, gen, 3)),
        ]
    seed = device_seed()
    funcs = {
        "input_fc": (lambda a, r: fused_input_fc(*a, 1e-6, "gelu"),
                     lambda a, r: fused_input_fc_plain(*a, 1e-6, "gelu")),
        "genpool": (lambda a, r: genpool(*a, "gelu", r, seed),
                    lambda a, r: genpool_plain(*a, "gelu", r, seed)),
        "attention": (lambda a, r: masked_attention(*a, 8, 48 ** -0.5, r,
                                                    seed),
                      lambda a, r: masked_attention_plain(
                          *a, 8, 48 ** -0.5, r, seed)),
    }

    def record(name, dn, desc, err, rel):
        check_tol(name, dn, desc, err, rel)
        if dn == "bfloat16":
            worst[name] = max(worst.get(name, 0.0), err)

    for name, dn, desc, rate, make in cases:
        args = make()
        kern, plain = funcs[name]
        with torch.inference_mode():
            out = kern(args, rate)
            torch.cuda.synchronize()
            record(name, dn, desc, *errors(out, plain(args, rate)))
            if name != "input_fc" and not torch.equal(out, kern(args, rate)):
                fail(f"{name} {dn} {desc}: two forward calls on the same "
                     "inputs differ")
        ours, ref = backward_case(name, args, rate, gen)
        torch.cuda.synchronize()
        errs = [errors(a, r) for a, r in zip(ours, ref)]
        record(name + "_bwd", dn, desc, max(e[0] for e in errs),
               max(e[1] for e in errs))
        if name == "genpool":
            log("    relative error by gradient: " + ", ".join(
                f"{g_} {e[1]:.2e}" for g_, e in zip(
                    ("df", "dw1", "db1", "dw2", "db2"), errs)))
            # db2 is ~0 at small rates (and at L = 1), so the check above
            # holds it absolutely; at 0.1 the keep2 mask makes it clearly
            # nonzero, and it is also held relative to its own largest value
            db2_rel = errs[4][0] / max(float(ref[4].float().abs().max()),
                                       1e-30)
            log(f"    db2 relative to max |db2| {db2_rel:.2e}")
            if rate >= 0.1 and args[0].shape[1] > 1:
                check_tol("genpool_db2", dn, desc, errs[4][0], db2_rel)
        if name == "attention" and desc.startswith("local"):
            # all-masked batch rows: no score gradient, so dq = dk = 0
            if float(ours[0][:16 * 8].abs().max()) != 0.0:
                fail("attention_bwd: dq is not 0 on all-masked rows")
        if name in ("attention", "input_fc", "genpool"):
            # no float atomics: a second backward repeats bit for bit
            n_out = len(ref)
            again, _ = backward_case(name, args, rate, gen, ours[n_out])
            if not all(torch.equal(a, b) for a, b in zip(ours[:n_out],
                                                         again)):
                fail(f"{name}_bwd {dn} {desc}: two backward calls on the "
                     "same inputs differ")
        del args, out, ours, ref
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for shape in ((81920, 384), (1001, 383)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            with torch.inference_mode():
                y = dropout(x, seed, 0.01)
            gx, = _grads(lambda a: dropout(a, seed, 0.01), [x], g)
            torch.cuda.synchronize()
            y_ref, g_ref = dropout_plain(x, seed, 0.01), \
                dropout_plain(g, seed, 0.01)
            kept = float((y_ref != 0).float().mean())
            desc = f"{shape[0]}x{shape[1]} rate 0.01 (kept {kept:.4f})"
            if not (torch.equal(y, y_ref) and torch.equal(gx, g_ref)):
                fail(f"dropout {dn} {desc}: kernel and plain differ")
            # the seed the kernel derived on the card is the host's
            by_value = philox.derive_seed(20261016, seed.call)
            if not torch.equal(y, dropout_plain(x, by_value, 0.01)):
                fail(f"dropout {dn} {desc}: the kernel's seed is not "
                     "philox.derive_seed's")
            record("dropout", dn, desc, *errors(y, y_ref))
            record("dropout_bwd", dn, desc, *errors(gx, g_ref))
        # 2 bytes off 16-byte alignment (a scalar head and tail around the
        # vectors), and a transposed (non-contiguous) cotangent
        flat = torch.randn(1001 * 383 + 1, generator=gen,
                           device="cuda").to(dtype)
        x = flat[1:].view(1001, 383)
        g_t = torch.randn(383, 1001, generator=gen, device="cuda").to(
            dtype).t()
        for what, g in (("misaligned", x), ("transposed", g_t)):
            with torch.inference_mode():
                y = dropout(x, seed, 0.01)
            gx, = _grads(lambda a: dropout(a, seed, 0.01), [x], g)
            torch.cuda.synchronize()
            if not (torch.equal(y, dropout_plain(x, seed, 0.01)) and
                    torch.equal(gx, dropout_plain(g, seed, 0.01))):
                fail(f"dropout {dn} misaligned x, {what} cotangent: kernel "
                     "and plain differ")
            log(f"  dropout       {dn:8s} {'x misaligned, g ' + what:34s} "
                "bit-equal")
    torch.cuda.empty_cache()
    return worst


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch
    x = torch.as_tensor(x, dtype=torch.float32).abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def phase_b3_seeds() -> dict:
    """B3's bf16 backward against its plain version over B3_SEEDS draws at
    each of phase 2's shapes (B3_SHAPES): each draw its own inputs,
    cotangent and dropout seed. Per shape: the gate's relative error (max
    abs error over max(1, max |plain|)) of the worst gradient, its
    quantiles over the draws; for the worst draw the gradient, the
    element, |plain| there, and the error in bf16 ulps of |plain| at that
    element and of the gradient's largest |plain|. Both versions round
    their f32 sums to bf16, so rounding shows as one or two ulps. Every
    draw is held to phase 2's gate (TOL): a draw over it, or a non-finite
    gradient, fails the run. Returns the summary by shape."""
    import torch
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_backward_plain)
    t0 = time.time()
    bf = torch.bfloat16
    tol = TOL["bfloat16"]
    summary = {}
    ulp_hist = {}
    for desc, rate, shape in B3_SHAPES:
        rels, worst = [], None
        for draw in range(B3_SEEDS):
            gen = torch.Generator(device="cuda").manual_seed(7919 + draw)
            q, k, v, kv = attention_inputs(*shape[:5], bf, gen, *shape[5:])
            g = torch.randn(q.shape, generator=gen, device="cuda")
            seed = philox.Seed(philox.seed_state(20261016 + draw, "cuda"),
                               0)
            ours = _grads(lambda *a: masked_attention(
                *a, kv, 8, 48 ** -0.5, rate, seed), [q, k, v], g)
            ref = masked_attention_backward_plain(
                q, k, v, kv, g.to(bf), 8, 48 ** -0.5, rate, seed)
            draw_worst = None
            for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
                a, r = a.float(), r.float()
                if not bool(a.isfinite().all()):
                    fail(f"B3 bf16 backward {desc} draw {draw}: {name} is "
                         "not finite")
                diff = (a - r).abs()
                top = float(r.abs().max())
                idx = int(diff.argmax())
                err = float(diff.view(-1)[idx])
                at = float(r.view(-1)[idx])
                rec = dict(draw=draw, grad=name, rel=err / max(1.0, top),
                           abs=err, plain_at=at, max_plain=top,
                           ulps_at=err / float(_bf16_ulp(at)),
                           ulps_max=err / float(_bf16_ulp(top)),
                           index=tuple(int(i) for i in torch.unravel_index(
                               torch.tensor(idx), r.shape)))
                if draw_worst is None or rec["rel"] > draw_worst["rel"]:
                    draw_worst = rec
            rels.append(draw_worst["rel"])
            # whole ulps, 17 for more than 16 (an element near 0)
            key = min(math.ceil(draw_worst["ulps_at"] - 1e-6), 17)
            ulp_hist[key] = ulp_hist.get(key, 0) + 1
            if worst is None or draw_worst["rel"] > worst["rel"]:
                worst = draw_worst
        rels.sort()
        over = sum(r > tol for r in rels)
        summary[desc] = dict(worst, median=rels[len(rels) // 2],
                             p90=rels[int(0.9 * (len(rels) - 1))],
                             over_tol=over)
        log(f"  B3 bf16 bwd {desc:36s} rel max {rels[-1]:.3e} p90 "
            f"{summary[desc]['p90']:.3e} median {summary[desc]['median']:.3e}"
            f"; {over} of {B3_SEEDS} draws over {tol:.0e}; worst: draw "
            f"{worst['draw']} {worst['grad']}{list(worst['index'])} abs "
            f"{worst['abs']:.4g} at |plain| {abs(worst['plain_at']):.4g} "
            f"(max {worst['max_plain']:.4g}): {worst['ulps_at']:.2f} ulps "
            f"there, {worst['ulps_max']:.2f} of the max")
    log(f"  each draw's worst error in bf16 ulps at its element, rounded "
        f"up, 17 for more than 16 (count of draws): "
        f"{dict(sorted(ulp_hist.items()))}; "
        f"{len(B3_SHAPES) * B3_SEEDS} draws in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    failed = {d: v for d, v in summary.items() if v["over_tol"]}
    if failed:
        fail(f"B3 bf16 backward: draws over the gate {tol}: {failed}")
    return summary


# standard normal truncated at +-2: the std of B5's noise draws
TRUNCNORM_STD = math.sqrt(
    1.0 - 4.0 * math.exp(-2.0) / math.sqrt(2.0 * math.pi)
    / math.erf(math.sqrt(2.0)))


def phase_gather_checks():
    """B5 against its plain version: bit-equal with and without the fused
    noise (both take the same Philox bits, CUDA's erfinvf and one rounding
    to the table's dtype; a tolerance would let a kernel that drops or
    mis-keys noise of std 0.01 pass); the noise's bounds and std over 1e6
    draws; a 4.4 GB table (540,000 x 4096 bf16, a real YouCook2 video
    store) gathered near its end, past 2^31 elements."""
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build, philox
    from coot_videotext_tpu_torch.ops.gather import (
        GatherNoise, gather_rows, gather_rows_plain)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def launch(table, idx, noise=None):
        before = cuda_build.launch_counts["gather"]
        out = gather_rows(table, idx, noise)
        torch.cuda.synchronize()
        if cuda_build.launch_counts["gather"] != before + 1:
            fail("gather: the wrapper did not count its launch")
        return out

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for d in (4096, 1536):
            table = torch.randn(20000, d, generator=gen,
                                device="cuda").to(dtype)
            for n in (81920, 1001):
                idx = torch.randint(0, 20000, (n,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                idx[:7] = 19999  # the last row, repeated
                idx[7:11] = idx[11]
                desc = f"T=20000 D={d} N={n}"
                out = launch(table, idx)
                if not torch.equal(out, gather_rows_plain(table, idx)):
                    fail(f"gather {dn} {desc}: kernel and plain differ")
                log(f"  gather        {dn:8s} {desc:34s} bit-equal")
                noise = GatherNoise(0.01, device_seed(call=3),
                                    philox.SITE_NOISE_CLIP)
                out = launch(table, idx, noise)
                ref = gather_rows_plain(table, idx, noise)
                if not torch.equal(out, ref):
                    fail(f"gather {dn} {desc} noise: kernel and plain "
                         f"differ by up to {errors(out, ref)[0]}")
                if torch.equal(out, gather_rows_plain(table, idx)):
                    fail(f"gather {dn} {desc} noise: no noise was added")
                log(f"  gather        {dn:8s} {desc + ' noise 0.01':34s} "
                    "bit-equal")
            del table
    # the noise alone: 1e6 draws of std 1 on a zero table
    zeros = torch.zeros(1, 1000, device="cuda")
    rows = torch.zeros(1000, dtype=torch.int32, device="cuda")
    noise = GatherNoise(1.0, device_seed(7), philox.SITE_NOISE_VIDEO)
    draws = launch(zeros, rows, noise)
    if not torch.equal(draws, gather_rows_plain(zeros, rows, noise)):
        fail("gather noise: the draws differ from the plain version's")
    top, std = float(draws.abs().max()), float(draws.std())
    log(f"  gather noise: 1e6 draws, max |tn| {top:.6f}, std {std:.5f} "
        f"(truncated normal {TRUNCNORM_STD:.5f}), mean "
        f"{float(draws.mean()):+.5f}")
    if top > 2.0 or abs(std / TRUNCNORM_STD - 1.0) > 0.02:
        fail(f"gather noise: max {top}, std {std}")
    # 64-bit offsets: the last rows of a 4.4 GB store
    rows = 540000
    big = torch.empty(rows, 4096, dtype=torch.bfloat16, device="cuda")
    for r0 in range(0, rows, 60000):
        big[r0:r0 + 60000] = torch.randn(min(60000, rows - r0), 4096,
                                         generator=gen, device="cuda")
    idx = (rows - 1 - torch.arange(1001, device="cuda") * 37).to(
        torch.int32)
    idx[:3] = rows - 1
    if not torch.equal(launch(big, idx), gather_rows_plain(big, idx)):
        fail("gather: the 4.4 GB table's last rows differ")
    gb = big.numel() * 2 / 1e9
    log(f"  gather        bfloat16 540000x4096 table ({gb:.2f} GB), 1001 "
        "rows near its end: bit-equal")
    del big
    torch.cuda.empty_cache()
    return 0.0  # the largest error: every comparison above is bit-equal


def _config(tmp: Path, **dataset) -> Path:
    """yc2_2d3d_coot.yaml with npy feature files (the card's machine has
    no h5py) and `dataset` set on dataset_train, which dataset_val
    inherits (same_as), written to tmp/yc2_2d3d_coot.yaml."""
    import yaml
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(CONFIG)
    cfg["dataset_train"].update(vid_feat_source="npy",
                                text_feat_source="npy", **dataset)
    # named, so that `-o train.steps_per_dispatch=K` can set it
    cfg["train"].setdefault("steps_per_dispatch", 1)
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / CONFIG.name
    # in the file's order: a same_as group must follow the one it names
    path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf8")
    return path


# the four validation paths: (name, dataset keys, extra CLI flags)
VAL_MODES = (
    ("host dense", dict(preload_device=False, pack_transfer=False), []),
    ("host slab", dict(preload_device=False), []),
    ("store, host indices", {}, []),
    ("store, device sampling + packing", {}, ["--fixed_shapes"]),
)


def _cosines(embs, ref, valid):
    """Smallest cosine of an embedding row against the reference's, over
    the embedding keys (rows of real videos / parts only)."""
    import numpy as np
    worst = 1.0
    for key in valid:
        a, b = embs[key], ref[key]
        if a.shape != b.shape:
            fail(f"{key}: {a.shape} vs {b.shape}")
        cos = (a * b).sum(-1) / np.maximum(
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)
        worst = min(worst, float(cos.min()))
    return worst


def phase_slice(tmp: Path):
    """The validation + embedding export path at full width, four ways
    (host dense, host slab, store with host index collation, store with
    on-device sampling and packing), all without frame noise."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_retrieval
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.retrieval.steps import EMB_KEYS

    made = _take_data("val", tmp / "data")
    log(f"the synthetic yc2-like set (128 val videos): {made}")
    runs = []
    for i, (name, dataset, flags) in enumerate(VAL_MODES):
        mode_dir = tmp / f"mode{i + 1}"
        argv = ["-c", str(_config(mode_dir, frames_noise=0, **dataset)),
                "--validate", "--ignore_untrained", "--save_embeddings",
                "--data_path", str(tmp / "data"), "--log_dir",
                str(mode_dir / "experiments"), "--embeddings_format",
                "npz"] + flags
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.time()
        results = train_retrieval.main(argv)[0]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_build.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_vid, batches = results["num_videos"], results["num_batches"]
        log(f"validation mode {i + 1} ({name}): launches {launches}; "
            f"{n_vid} videos in {batches} batches, "
            f"{n_vid / results['total_s']:.2f} videos/s end to end (pass "
            f"{results['total_s']:.2f} s, main() {wall:.2f} s), "
            f"{results['forward_s'] / batches * 1e3:.2f} ms per batch in "
            f"the eval step ({results['eval_step']}), peak device memory "
            f"{peak_gb:.2f} GB")
        # id batches (fixed shapes) run the captured step, the rest eagerly
        expect = "CUDA graph" if "--fixed_shapes" in flags else "eager"
        if results["eval_step"] != expect:
            fail(f"validation mode {i + 1}: the eval step ran as "
                 f"{results['eval_step']}, not {expect}")
        for kernel in ("input_fc", "genpool", "attention"):
            if launches.get(kernel, 0) <= 0:
                fail(f"kernel {kernel} was not launched in validation mode "
                     f"{i + 1}")
        if (launches.get("gather", 0) > 0) != (i > 0):
            fail(f"validation mode {i + 1}: {launches.get('gather', 0)} "
                 "gather launches (0 on the host dense path, > 0 else)")
        embs = results["embeddings"]
        for key, arr in embs.items():
            if not np.isfinite(arr).all():
                fail(f"mode {i + 1}: non-finite values in {key}")
        if n_vid != 128 or embs["vid_emb"].shape != (128, 768):
            fail(f"mode {i + 1}: unexpected embeddings "
                 f"{embs['vid_emb'].shape}")
        with np.load(results["emb_file"]) as saved:
            expect = {"clip_num", "sent_num", "key"} | {
                f"{k}{s}" for k in embs for s in ("", "_before_norm")}
            if set(saved.files) != expect or len(saved["key"]) != n_vid:
                fail(f"embedding file {results['emb_file']} lacks the "
                     "schema")
        if runs:
            cos = _cosines(embs, runs[0][1]["embeddings"], EMB_KEYS)
            log(f"  against mode 1: min cosine per row {cos:.6f} (need >= "
                f"{MIN_COSINE}); v2p r1 {results['v2p']['r1']:.4f} vs "
                f"{runs[0][1]['v2p']['r1']:.4f}")
            if not cos >= MIN_COSINE:
                fail(f"validation mode {i + 1} vs mode 1: cosine {cos}")
        runs.append((launches, results))
    results = runs[0][1]
    embs = results["embeddings"]
    log(f"v2p {results['v2p']} c2s {results['c2s']}")

    _hold_ranks(embs)
    log("device ranks == host ranks (vid/par, clip/sent)")

    # one batch on the card (bf16) against the CPU (f32), same weights
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        retrieval_eval_step)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = RetrievalConfig(load_yaml_config_file(_config(
        tmp / "mode1", frames_noise=0, **VAL_MODES[0][1])), is_train=False)
    _, _, _, loader = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=torch.device("cuda"))
    host_batch = next(iter(loader))
    kw = dict(loss_weights=cfg.train.contrastive_loss_config.as_dict(),
              margin=cfg.train.contrastive_loss_config.margin,
              loss_cycle_cons=cfg.train.loss_cycle_cons)
    gpu = RetrievalModelManager(cfg, torch.device("cuda"), seed=0)
    cpu = RetrievalModelManager(cfg, torch.device("cpu"), seed=0)
    e_gpu, _ = retrieval_eval_step(
        gpu.model, to_device(host_batch, torch.device("cuda")),
        compute_dtype=gpu.val_dtype, eager=True, **kw)
    t0 = time.time()
    e_cpu, _ = retrieval_eval_step(
        cpu.model, to_device(host_batch, torch.device("cpu")),
        compute_dtype=torch.float32, eager=True, **kw)
    log(f"CPU float32 forward of one batch: {time.time() - t0:.1f} s")
    bv = torch.from_numpy(host_batch["batch_valid"])
    worst_cos = 1.0
    for key in EMB_KEYS:
        a = e_gpu[key].float().cpu()
        b = e_cpu[key].float()
        if key in ("clip_emb", "sent_emb"):
            valid = e_cpu[key.replace("emb", "valid")].bool() & bv[:, None]
            a, b = a[valid], b[valid]
        else:
            a, b = a[bv], b[bv]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        worst_cos = min(worst_cos, float(cos.min()))
        # the main path's own embeddings of this batch, from main()
        first = embs[key][:a.shape[0]]
        if np.abs(first - a.numpy()).max() > 1e-3:
            fail(f"{key}: the re-run of batch 0 differs from main()")
    log(f"batch 0 bf16 on the card vs f32 on the CPU: min cosine "
        f"{worst_cos:.5f} (need >= {MIN_COSINE})")
    if not worst_cos >= MIN_COSINE:
        fail(f"card vs CPU cosine {worst_cos} < {MIN_COSINE}")
    dev_batch = to_device(host_batch, torch.device("cuda"))
    # the same videos as an id batch: sampled, packed and gathered on the
    # device
    _, _, _, id_loader = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=torch.device("cuda"),
        fixed_shapes=True, device_preload=True)
    id_batch = to_device(next(iter(id_loader)), torch.device("cuda"))
    source = FeatureSource.of(id_loader)

    # as validation runs them: host dense batches eagerly, id batches
    # through the captured step (phase 13 times both ways); the traced
    # replay of the captured step holds B1, B2, B3 and B5 by name
    for what, batch, src in (("host dense", dev_batch, None),
                             ("id batch, store", id_batch, source)):
        def eval_step():
            retrieval_eval_step(gpu.model, batch, source=src,
                                compute_dtype=gpu.val_dtype,
                                eager=src is None, **kw)
            torch.cuda.synchronize()

        eval_step()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            eval_step()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        log(f"eval step on a warm card ({what}, batch 0, 5 runs): median "
            f"{walls[2]:.2f} ms, min {walls[0]:.2f}, max {walls[-1]:.2f}")
        events = profile_step(eval_step, f"eval ({what})")
        if src is not None:
            counts = _port_kernel_counts(events)
            log(f"  the port's kernels on the device in the traced replay: "
                f"{counts}")
            missing = [k for k in EVAL_KERNELS if counts.get(k, 0) <= 0]
            if missing:
                fail(f"the traced replay of the captured eval step on an id "
                     f"batch holds no {missing} kernels: {counts}")
    del gpu, e_gpu, dev_batch, id_batch, source, id_loader
    torch.cuda.empty_cache()
    return [launches for launches, _ in runs]


KERNELS = ("input_fc", "input_fc_bwd", "genpool", "genpool_bwd",
           "attention", "attention_bwd", "dropout", "dropout_bwd", "gather",
           "coot_norm", "coot_norm_bwd")


def _yc2_dataset(root: Path, num_videos: int, num_val_videos: int,
                 seed: int, config: Path = CONFIG) -> None:
    """A synthetic split at the widths of the retrieval `config`."""
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    ds = load_yaml_config_file(config)["dataset_train"]
    generate_retrieval_dataset(
        root, dataset_name=ds["name"], metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=num_videos,
        num_val_videos=num_val_videos, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=seed,
        feat_format="npy")


# ---------- the synthetic splits, made beside the phases ----------

# worker processes that write the synthetic retrieval splits (numpy on the
# host, the same files as written in line) while the phases before the
# one that needs each run
DATA_WORKERS = 3
_DATA = {}        # split -> its pending result in the pool
_DATA_ROOT = []   # the working directory: the splits under data/
_CHILDREN = []    # the pool and the processes of the side phases


def _make_data(split: str, root: str) -> float:
    """Writes `split` of DATA_SPLITS to `root` (in a worker process);
    returns the seconds it took."""
    t0 = time.time()
    _yc2_dataset(Path(root), *DATA_SPLITS[split])
    return time.time() - t0


def _start_data(work: Path) -> None:
    """Starts writing every split of DATA_SPLITS under `work`/data, in
    the order the phases need them, DATA_WORKERS at a time."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(DATA_WORKERS)
    _CHILDREN.append(pool)
    _DATA_ROOT.append(work)
    for split in DATA_SPLITS:
        _DATA[split] = pool.apply_async(
            _make_data, (split, str(work / "data" / split)))
    pool.close()


def _take_data(split: str, dest: Path) -> str:
    """Waits for `split`, moves it to `dest` and says how it was made."""
    t0 = time.time()
    took = _DATA.pop(split).get()
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(_DATA_ROOT[0] / "data" / split), str(dest))
    return (f"made in a worker process in {took:.1f} s beside the phases "
            f"before, waited {time.time() - t0:.1f} s for it")


def _stop_children() -> None:
    """Stops the data workers and the side phases' processes that are
    still running and removes the working directory (at exit, on success
    or failure)."""
    for child in _CHILDREN:
        if not isinstance(child, subprocess.Popen):
            child.terminate()  # the pool
            child.join()
        elif child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
            lines = child.log_path.read_text(
                encoding="utf8", errors="replace").splitlines()
            log(f"== stopped the side process {child.args[2:4]}; the end "
                "of its log:\n" + "\n".join(lines[-40:]))
    for root in _DATA_ROOT:
        shutil.rmtree(root, ignore_errors=True)
    _CHILDREN.clear()
    _DATA_ROOT.clear()


def _train_cli(config: Path, tmp: Path, extra, epochs: int = 1,
               overrides: str = ""):
    """CLI training to `epochs` (each epoch trains, validates and
    checkpoints; a run with checkpoints resumes from the newest) with the
    launch counts set to 0 just before and read just after."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_retrieval
    from coot_videotext_tpu_torch.ops import cuda_build
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.time()
    result = train_retrieval.main(
        ["-c", str(config), "--data_path", str(tmp / "data"), "--log_dir",
         str(config.parent / "experiments"), "-o",
         f"train.num_epochs={epochs},val.val_start=0{overrides}"] + extra)[0]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_build.launch_counts)
    if not np.isfinite(result["step_losses"]).all():
        fail(f"training losses {result['step_losses']}")
    return result, launches, wall


def _epoch_train_s(models: Path, epochs) -> list:
    """Each epoch's training seconds (its time without its validation),
    from the cumulative times of the trainerstate files."""
    def train_s(ep):
        state = json.loads((models / f"trainerstate_{ep}.json").read_text(
            encoding="utf8"))
        return state["time_total"] - state["time_val"]
    return [train_s(ep) - train_s(ep - 1) for ep in epochs]


def phase_train(tmp: Path):
    """The training path at full width: the CLI trains one epoch from the
    device store with on-device sampling and packing (256 train videos, 4
    steps), validates and checkpoints; the checkpoint is validated back;
    the run resumes for 4 more epochs (16 steps) to time training end to
    end past the first epoch; the store with host-sampled index batches
    (the config's default, without --fixed_shapes) trains one epoch (the
    host dense path trains in phase 10a); one fixed id batch trains 16
    steps through B5."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_retrieval
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        TrainState, retrieval_train_step)
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    made = _take_data("train", tmp / "data")
    log(f"a yc2-like train split (256 videos, 64 val): {made}")
    config = _config(tmp / "store")
    result, launches, wall = _train_cli(config, tmp, ["--fixed_shapes"])
    log(f"training path launches (store, device sampling + packing): "
        f"{launches}")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the training path")
    losses, state = result["step_losses"], result["state"]
    if len(losses) != 4 or result["layout"] != "ids":
        fail(f"expected 4 training steps on id batches, got {losses} on "
             f"{result['layout']} batches")
    train_s = state["time_total"] - state["time_val"]
    log(f"CLI (store): 1 epoch of {len(losses)} steps (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}) and its validation in "
        f"{wall:.1f} s; epoch time {state['time_total']:.2f} s of which "
        f"validation {state['time_val']:.2f} s; {256 / train_s:.2f} train "
        f"videos/s end to end")
    models = result["path_base"] / "models"
    for name in ("model_0.pth", "optimizer_0.pth", "trainerstate_0.json",
                 "scheduler_0.json"):
        if not (models / name).is_file():
            fail(f"checkpoint file {name} missing")
    val = train_retrieval.main(
        ["-c", str(config), "--data_path", str(tmp / "data"), "--log_dir",
         str(config.parent / "experiments"), "--fixed_shapes", "--validate",
         "--load_epoch", "0"])[0]
    if not np.isfinite(val["loss_total"]) or \
            val["embeddings"]["vid_emb"].shape != (64, 768):
        fail("the trained checkpoint does not validate")
    log(f"--validate --load_epoch 0: val loss {val['loss_total']:.5f}, "
        f"v2p r1 {val['v2p']['r1']:.4f}, c2s r1 {val['c2s']['r1']:.4f}; "
        f"{64 / val['total_s']:.2f} val videos/s end to end")

    # the same run resumed to 5 epochs: 16 steps past the first epoch
    result, _, wall = _train_cli(config, tmp, ["--fixed_shapes"], epochs=5,
                                 overrides=",saving.keep_freq=1")
    if len(result["step_losses"]) != 20:
        fail(f"the resumed run has {len(result['step_losses'])} steps")
    per_epoch = _epoch_train_s(result["path_base"] / "models", range(1, 5))
    log(f"CLI (store, device sampling + packing) resumed for epochs 1-4 "
        f"(16 steps) in {wall:.1f} s: train seconds per epoch "
        f"{', '.join(f'{t:.3f}' for t in per_epoch)}; "
        f"{4 * 256 / sum(per_epoch):.2f} train videos/s end to end over the "
        f"16 steps (per epoch {min(256 / t for t in per_epoch):.2f} to "
        f"{max(256 / t for t in per_epoch):.2f})")

    # the config's default on the card: the store with host-sampled index
    # batches and the frame noise fused into the gathers
    result, idx_launches, wall = _train_cli(_config(tmp / "store_idx"), tmp,
                                            [])
    losses, state = result["step_losses"], result["state"]
    if len(losses) != 4 or result["layout"] != "indices":
        fail(f"store, host indices: losses {losses} on {result['layout']} "
             "batches")
    for name in KERNELS:
        if idx_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the store path with "
                 "host indices")
    log(f"CLI (store, host indices): 1 epoch of {len(losses)} steps (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}) in {wall:.1f} s; epoch "
        f"time {state['time_total']:.2f} s of which validation "
        f"{state['time_val']:.2f} s; launches {idx_launches}")

    # one fixed id batch, 16 steps: frames resampled and noised on the
    # device at every step; RAdam's rectified updates start at step 6
    cfg = RetrievalConfig(load_yaml_config_file(config))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=torch.device("cuda"),
        fixed_shapes=True)
    source = FeatureSource.of(loader, cfg.dataset_train.frames_noise,
                              cfg.dataset_train.words_noise)
    batch = to_device(next(iter(loader)), torch.device("cuda"))
    mgr = RetrievalModelManager(cfg, torch.device("cuda"), seed=0)
    ts = TrainState(mgr.model, make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0, "cuda"))
    kw = dict(lr=cfg.optimizer.lr, clip_gradient=cfg.train.clip_gradient,
              compute_dtype=mgr.train_dtype, source=source,
              loss_weights=cfg.train.contrastive_loss_config.as_dict(),
              margin=cfg.train.contrastive_loss_config.margin,
              loss_cycle_cons=cfg.train.loss_cycle_cons)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fixed, walls = [], []
    for _ in range(16):
        t0 = time.perf_counter()
        fixed.append(float(retrieval_train_step(ts, batch, **kw)
                           ["loss_total"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("fixed id batch, 16 steps: loss " +
        " ".join(f"{v:.4f}" for v in fixed))
    if not (np.isfinite(fixed).all()
            and np.mean(fixed[-3:]) < np.mean(fixed[:3])):
        fail("the loss of the fixed batch did not fall")
    warm = sorted(walls[4:])
    med = warm[len(warm) // 2]
    b = batch["dp_idx"].shape[0]
    log(f"warm train step (store, device sampling + packing, bf16, batch "
        f"{b}, steps 5-16): median {med:.2f} ms, min {warm[0]:.2f}, max "
        f"{warm[-1]:.2f}; {b / med * 1e3:.1f} videos/s on the device; peak "
        f"device memory {peak_gb:.2f} GB")
    profile_step(lambda: retrieval_train_step(ts, batch, **kw), "train")
    shapes = dict(loader.device_meta.shapes, b=b, din=cfg.dataset_train
                  .vid_feat_dim, dtext=cfg.dataset_train.text_feat_dim)
    del mgr, ts, batch, source, loader
    torch.cuda.empty_cache()
    return launches, shapes


def phase_synthetic_smoke(tmp: Path) -> None:
    """synthetic_smoke.yaml (its text input FC 48 -> 32 wide, GenPool D 32
    / H 64) trained one epoch on the card through the CLI from the device
    store, as shipped (float32) and in bfloat16: B1's backward at widths
    it pads (din 48) and B2's backward at small widths, on the main path."""
    import yaml
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    generate_retrieval_dataset(tmp / "data", num_videos=16, num_val_videos=8,
                               seed=0, feat_format="npy")
    cfg = load_yaml_config_file(SMOKE)
    cfg["dataset_train"].update(vid_feat_source="npy", text_feat_source="npy")
    for dtype, flags in (("float32", ""),
                         ("bfloat16", ",fp16_train=true,fp16_val=true")):
        (tmp / dtype).mkdir(parents=True, exist_ok=True)
        config = tmp / dtype / SMOKE.name
        config.write_text(yaml.safe_dump(cfg, sort_keys=False),
                          encoding="utf8")
        result, launches, wall = _train_cli(
            config, tmp, ["--preload_device", "--fixed_shapes"],
            overrides=flags)
        for name in ("input_fc_bwd", "genpool_bwd"):
            if launches.get(name, 0) <= 0:
                fail(f"synthetic_smoke {dtype}: {name} was not launched")
        log(f"CLI synthetic_smoke ({dtype}, store): 1 epoch of "
            f"{len(result['step_losses'])} steps (losses "
            f"{', '.join(f'{v:.5f}' for v in result['step_losses'])}) and "
            f"its validation in {wall:.1f} s; launches {launches}")


CAPTION_CONFIG = (ROOT / "config" / "caption" / "paper2020" /
                  "yc2_2d3d_coot_vidclip_mart.yaml")
# Caption serving, one val batch on the card against the port on the CPU,
# both float32 without TF32: the teacher-forced loss (relative), n_correct
# (as a share of n_word), the share of token-identical greedy sentences.
CAPTION_LOSS_RTOL = 1e-4
CAPTION_CORRECT_TOL = 0.005
CAPTION_MIN_SAME = 0.98


def _coot_embeddings(tmp: Path, cfg) -> Path:
    """COOT embeddings from seed 0 for every video and clip of the real
    YouCook2 caption splits, as `<coot_model_name>_{train,val}.npz` in the
    export schema (rows of unit length, the config's widths), under
    tmp/embeddings, which is returned."""
    import numpy as np
    ann = ROOT / "annotations" / "youcook2"
    emb_dir = tmp / "embeddings"
    emb_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)

    def unit_rows(n, d):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    for split in ("train", "val"):
        data = json.loads((ann / f"captioning_{split}.json").read_text(
            encoding="utf8"))
        clip_num = np.asarray([len(v["timestamps"]) for v in data.values()],
                              np.int64)
        np.savez(emb_dir / f"{cfg.coot_model_name}_{split}.npz",
                 key=np.asarray(list(data)), clip_num=clip_num,
                 vid_emb=unit_rows(len(data), cfg.coot_dim_vid),
                 vid_context=unit_rows(len(data), cfg.coot_dim_vid),
                 clip_emb=unit_rows(int(clip_num.sum()), cfg.coot_dim_clip))
        log(f"  {split}: {len(data)} videos, {int(clip_num.sum())} clips "
            f"(max {int(clip_num.max())} a video); embeddings vid / ctx "
            f"{cfg.coot_dim_vid}, clip {cfg.coot_dim_clip}")
    return emb_dir


def _caption_inputs(tmp: Path, cfg) -> tuple:
    """The COOT embeddings (_coot_embeddings) and the port's model at the
    config's width from seed 0 with GloVe applied, saved as a
    reference-layout `{"model": state_dict}`. Returns the embedding dir,
    the checkpoint and the val annotations."""
    import torch
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager, load_glove_matrix)
    ann = ROOT / "annotations" / "youcook2"
    emb_dir = _coot_embeddings(tmp, cfg)
    vocab = json.loads((ann / "mart_word2idx.json").read_text(
        encoding="utf8"))
    mgr = build_mart_model_manager(cfg, len(vocab), torch.device("cpu"),
                                   seed=0, cache_dir=str(ROOT /
                                                         "cache_caption"))
    glove = load_glove_matrix(str(ROOT / "cache_caption"), "youcook2")
    if not torch.equal(mgr.model.embeddings.word_embeddings.weight,
                       torch.from_numpy(glove)):
        fail("caption: the GloVe vectors were not applied")
    pth = tmp / "mart_seed0.pth"
    torch.save(mgr.state_dict(), pth)
    log(f"  model: {mgr.count_parameters():,} parameters (hidden "
        f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, vocabulary {len(vocab)}, GloVe "
        f"{glove.shape[1]}-d), seed 0, saved as {{'model': state_dict}}")
    val = json.loads((ann / "captioning_val.json").read_text(
        encoding="utf8"))
    return emb_dir, pth, val


def phase_caption(tmp: Path) -> None:
    """Phase 6, caption serving at the full width of
    yc2_2d3d_coot_vidclip_mart.yaml: (a) the inputs (_caption_inputs);
    (b) `train_caption --validate --load_model` on the card over the whole
    val split, with the launch counts of B1-B5 set to 0 just before and
    read just after (the caption path runs none); (c) one val batch of 8
    videos on the card against the port on the CPU; (d) the first
    TRACE_STEPS sentence steps of a greedy batch of 50 videos traced with
    torch.profiler."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.data.caption_dataset import (
        STACKED_KEYS, RecursiveCaptionDataset)
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_eval_step)
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    def config():
        return MartConfig(load_yaml_config_file(CAPTION_CONFIG))

    cfg = config()
    log("(a) inputs: the real YouCook2 caption annotations, embeddings "
        "from seed 0")
    emb_dir, pth, val = _caption_inputs(tmp, cfg)
    max_sen = cfg.max_n_sen + cfg.max_n_sen_add_val
    n_sentences = sum(min(len(v["sentences"]), max_sen)
                      for v in val.values())

    log("(b) the CLI on the card over the val split")
    cuda_build.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    t0 = time.perf_counter()
    result = train_caption.main([
        "-c", str(CAPTION_CONFIG), "--validate", "--load_model", str(pth),
        "--annotations_dir", str(ROOT / "annotations"),
        "--coot_feat_dir", str(emb_dir),
        "--cache_dir", str(ROOT / "cache_caption"),
        "--log_dir", str(tmp / "experiments")])[0]
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    launches = dict(cuda_build.launch_counts)
    if any(launches.values()):
        fail(f"caption serving launched the port's kernels: {launches}")
    if result["model_device"].type != "cuda" \
            or result["batch_device"].type != "cuda":
        fail(f"caption serving ran on {result['model_device']} with "
             f"batches on {result['batch_device']}, not on the card")
    translations = json.loads(result["translation_file"].read_text(
        encoding="utf8"))["results"]
    n_out = sum(len(v) for v in translations.values())
    if len(translations) != len(val) or n_out != n_sentences:
        fail(f"caption serving: {len(translations)} videos and {n_out} "
             f"sentences translated, the split has {len(val)} and "
             f"{n_sentences}")
    metrics = json.loads(result["metrics_file"].read_text(encoding="utf8"))
    for key in ("cap/b4", "cap/met", "cap/rol", "cap/cid"):
        (_, value), = metrics[key]
        if not math.isfinite(value) or value < 0:
            fail(f"caption serving: {key} = {value}")
    scores = {k: metrics[k][0][1] for k in ("cap/b4", "cap/met", "cap/rol",
                                            "cap/cid", "val/loss_word",
                                            "val/acc")}
    log(f"  on {result['model_device']} (batches on "
        f"{result['batch_device']}); launches of B1-B5 {launches}")
    log(f"  {len(val)} val videos, {n_out} sentences, "
        f"{result['num_batches']} batches of {cfg.val.batch_size}: "
        f"{len(val) / wall:.2f} val videos/s end to end ({wall:.2f} s, the "
        f"CLI's main()), {len(val) / result['val_seconds']:.2f} over the "
        f"validation pass ({result['val_seconds']:.2f} s: eval step, decode "
        f"and metrics)")
    log(f"  median per batch: eval step "
        f"{statistics.median(result['eval_ms']):.2f} ms, greedy decode "
        f"{statistics.median(result['decode_ms']):.2f} ms; forwards "
        f"per batch {result['forwards']}; peak device memory "
        f"{peak:.3f} GB above the {held / 1e9:.3f} GB the earlier phases "
        "hold")
    log(f"  eval ms by batch {[round(v, 2) for v in result['eval_ms']]}; "
        f"decode ms {[round(v, 1) for v in result['decode_ms']]}")
    log(f"  metrics (random weights): {json.dumps(scores)}")

    log("(c) one val batch of 8 videos: the card against the CPU, float32")
    dataset = RecursiveCaptionDataset(
        "youcook2", cfg.max_t_len, cfg.max_v_len, max_sen, mode="val",
        coot_model_name=cfg.coot_model_name, coot_mode=cfg.coot_mode,
        coot_dim_vid=cfg.coot_dim_vid, coot_dim_clip=cfg.coot_dim_clip,
        annotations_dir=str(ROOT / "annotations"),
        coot_feat_dir=str(emb_dir))
    state = torch.load(pth, map_location="cpu", weights_only=True)
    outs, decs = {}, {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        mgr = build_mart_model_manager(config(), len(dataset.word2idx),
                                       device, seed=1)
        mgr.load_state(state)
        stacked, sizes, _ = dataset.collate_fn([dataset[i]
                                                for i in range(8)])
        batch = {k: torch.from_numpy(stacked[k]).to(device)
                 for k in STACKED_KEYS}
        outs[name] = {k: float(v) for k, v in
                      caption_eval_step(mgr.model, batch).items()}
        decs[name] = Translator(mgr.model, mgr.cfg).translate_batch_greedy(
            batch["input_ids"], batch["video_feature"], batch["input_mask"],
            batch["token_type_ids"])
        if name == "cuda":
            profile_model, profile_cfg = mgr.model, mgr.cfg
    gpu, cpu = outs["cuda"], outs["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    correct_diff = abs(gpu["n_correct"] - cpu["n_correct"]) / cpu["n_word"]
    pairs = [(decs["cuda"][s][i], decs["cpu"][s][i])
             for i, size in enumerate(sizes) for s in range(size)]
    same = sum(bool(np.array_equal(a, b)) for a, b in pairs)
    log(f"  loss {gpu['loss']:.6f} / {cpu['loss']:.6f} (relative "
        f"{loss_rel:.2e}, limit {CAPTION_LOSS_RTOL}); n_correct "
        f"{gpu['n_correct']:.0f} / {cpu['n_correct']:.0f} of "
        f"{cpu['n_word']:.0f} words ({correct_diff:.2%}, limit "
        f"{CAPTION_CORRECT_TOL:.1%}); greedy sentences token-identical "
        f"{same} of {len(pairs)} (limit {CAPTION_MIN_SAME:.0%})")
    if loss_rel > CAPTION_LOSS_RTOL or gpu["n_word"] != cpu["n_word"] \
            or correct_diff > CAPTION_CORRECT_TOL \
            or same < CAPTION_MIN_SAME * len(pairs):
        fail("caption serving: the card disagrees with the CPU")

    log(f"(d) the first {TRACE_STEPS} sentence steps of a greedy batch of "
        "50 val videos under torch.profiler (through the graphs)")
    stacked, sizes, _ = dataset.collate_fn(
        [dataset[i] for i in range(cfg.val.batch_size)])
    batch = [torch.from_numpy(stacked[k][:TRACE_STEPS]).cuda() for k in
             ("input_ids", "video_feature", "input_mask", "token_type_ids")]
    translator = Translator(profile_model, profile_cfg)
    translator.translate_batch_greedy(*batch)  # warm
    wall_ms, busy_ms, kernels, events = _busy_ms(
        lambda: translator.translate_batch_greedy(*batch))
    steps = TRACE_STEPS
    positions = steps * cfg.max_t_len
    log(f"  S {steps} sentence steps x {cfg.max_t_len} token positions, "
        f"{translator.forwards} forwards of N {cfg.val.batch_size} x "
        f"L {cfg.max_v_len + cfg.max_t_len} ({translator.cached_tokens} of "
        f"them token steps on the caches): wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}); {kernels} kernel "
        f"launches, {kernels / positions:.1f} per decoded token position, "
        f"{kernels / translator.forwards:.1f} per forward")
    log_families(events, translator.forwards)


# Caption training, one train batch of 8 videos on the card against the
# port on the CPU at the config's dropout 0.1 (B4 and dropout_plain draw the
# same bits, so the masks agree), both float32 without TF32: the loss and
# grad_norm (relative), n_correct (as a share of n_word), every gradient
# (relative to the model's largest gradient), and the parameters and the
# EMA after 1 and after 3 steps at lr 1e-4 (the largest difference of the
# two, over all 24 M entries, as a share of lr per step: BertAdam divides
# by sqrt(v) + 1e-6, so where |g| is under ~3e-5 a gradient's rounding
# error comes out multiplied by up to (1 - beta1) / eps = 1e5).
CAPTION_TRAIN_LR = 1e-4
CAPTION_TRAIN_LOSS_RTOL = 1e-4
CAPTION_TRAIN_GRAD_TOL = 1e-3
CAPTION_TRAIN_UPDATE_TOL = 0.05
# the CLI's cuts of the YouCook2 splits: 20 train steps an epoch of batch
# 16, 1 val batch of 50 (cut from 100 for the time limit, PERF.md §6)
CAPTION_TRAIN_CUTS = {"dataset_train.max_datapoints": 320,
                      "dataset_val.max_datapoints": 50}
CAPTION_DROPOUT_SHAPES = ((16, 25, 768), (16, 12, 25, 25))


def _state_copy(state) -> dict:
    """The parameters and the EMA shadow of a caption train state, on the
    CPU."""
    return {"params": {n: p.detach().cpu().clone()
                       for n, p in state.optimizer.params.items()},
            "ema": {n: s.cpu().clone() for n, s in state.ema.shadow.items()}}


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[n].double() - b[n].double()).abs().max())
               for n in a)


def phase_caption_train(tmp: Path) -> None:
    """Phase 7, caption training at the full width of
    yc2_2d3d_coot_vidclip_mart.yaml: (a) the inputs (_caption_inputs);
    (b) `train_caption` on the card over a cut of the YouCook2 train split,
    2 epochs with validation on a cut of the val split, with the launch
    counts of B1-B5 set to 0 just before and read just after (B4 forward
    and backward must run, nothing else), then resumed to epoch 3 with
    `--load_epoch`, then `--validate --load_epoch 2` (the EMA weights: the
    val loss of the training run's epoch 2); (c) one train batch of 8
    videos on the card against the CPU, 3 steps; (d) one batch of 16 trained
    16 steps at a fixed lr: the loss falls, the warm step's wall and
    device-busy ms, launches per step by family, peak memory; (e) B4 at
    the caption shapes, f32, against its plain version and F.dropout."""
    import torch
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.data.caption_dataset import (
        STACKED_KEYS, RecursiveCaptionDataset)
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    def config():
        return MartConfig(load_yaml_config_file(CAPTION_CONFIG))

    cfg = config()
    log("(a) inputs: the real YouCook2 caption annotations, embeddings "
        "from seed 0")
    emb_dir, pth, _ = _caption_inputs(tmp, cfg)
    exp = tmp / "experiments"
    cut = ",".join(f"{k}={v}" for k, v in CAPTION_TRAIN_CUTS.items())
    common = ["-c", str(CAPTION_CONFIG), "--seed", "0",
              "--annotations_dir", str(ROOT / "annotations"),
              "--coot_feat_dir", str(emb_dir),
              "--cache_dir", str(ROOT / "cache_caption"),
              "--log_dir", str(exp)]

    log(f"(b) the CLI trains on the card: cuts {CAPTION_TRAIN_CUTS}, "
        "2 epochs")
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_caption.main(
        common + ["-o", cut + ",train.num_epochs=2"])[0]
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    log(f"  launches during the run {launches}")
    if launches.get("dropout", 0) <= 0 or launches.get("dropout_bwd", 0) <= 0:
        fail("caption training: B4 forward or backward was not launched")
    others = {k: v for k, v in launches.items()
              if v and k not in ("dropout", "dropout_bwd")}
    if others:
        fail(f"caption training launched kernels off its path: {others}")
    if result["model_device"].type != "cuda" \
            or result["batch_device"].type != "cuda":
        fail(f"caption training ran on {result['model_device']} with "
             f"batches on {result['batch_device']}, not on the card")
    run = result["models_dir"].parent
    steps = json.loads((run / "metrics" / "metrics_step_1.json").read_text(
        encoding="utf8"))
    losses = [v for _, v in steps["train_base/loss"]]
    norms = [v for _, v in steps["train_base/grad_clip_total_norm"]]
    if len(losses) != 2 * result["steps_per_epoch"] or not all(
            math.isfinite(v) for v in losses + norms):
        fail(f"caption training: step losses {losses}, grad norms {norms}")
    for name in ("model_1.pth", "modelema_1.pth", "optimizer_1.pth"):
        if not (result["models_dir"] / name).is_file():
            fail(f"caption training wrote no {name}")
    if not (run / "caption" / "translations_1_val.json").is_file():
        fail("caption training wrote no translations of epoch 1")
    vps = result["train_videos_per_s"]
    log(f"  {len(result['epochs'])} epochs of {result['steps_per_epoch']} "
        f"steps (batch {cfg.train.batch_size}) in {wall:.2f} s (the CLI's "
        f"main(), validations included); train videos/s by epoch "
        f"{[round(v, 2) for v in vps]}; step wall ms median "
        f"{statistics.median(result['step_ms']):.2f} (first "
        f"{result['step_ms'][0]:.1f}); step losses first / last "
        f"{losses[0]:.3f} / {losses[-1]:.3f}, grad norms first / last "
        f"{norms[0]:.3f} / {norms[-1]:.3f}")
    resumed = train_caption.main(common + [
        "-o", cut + ",train.num_epochs=3", "--load_epoch", "1"])[0]
    if resumed["epochs"] != [2] \
            or resumed["total_step"] != 3 * result["steps_per_epoch"]:
        fail(f"caption training: resuming trained epochs "
             f"{resumed['epochs']} to step {resumed['total_step']}")
    trained = json.loads(resumed["metrics_file"].read_text(
        encoding="utf8"))
    val_trained = dict(trained["val/loss_word"])[2]
    check = train_caption.main(common + ["-o", cut, "--validate",
                                         "--load_epoch", "2"])[0]
    val_again = json.loads(check["metrics_file"].read_text(
        encoding="utf8"))["val/loss_word"][-1]
    log(f"  resumed to epoch 3 with --load_epoch 1 (epoch 2's videos/s "
        f"{resumed['train_videos_per_s'][0]:.2f}); val loss per word "
        f"by epoch {trained['val/loss_word']}; --validate --load_epoch 2 "
        f"(EMA weights): {val_again}")
    if val_again[0] != 2 or abs(val_again[1] - val_trained) > \
            1e-6 * abs(val_trained):
        fail("caption training: --validate --load_epoch 2 did not evaluate "
             "the EMA weights of the training run's epoch 2")

    log("(c) one train batch of 8 videos: the card against the CPU, "
        f"float32, dropout {cfg.hidden_dropout_prob}, 3 steps at lr "
        f"{CAPTION_TRAIN_LR}")
    dataset = RecursiveCaptionDataset(
        "youcook2", cfg.max_t_len, cfg.max_v_len, cfg.max_n_sen,
        mode="train", coot_model_name=cfg.coot_model_name,
        coot_mode=cfg.coot_mode, coot_dim_vid=cfg.coot_dim_vid,
        coot_dim_clip=cfg.coot_dim_clip,
        annotations_dir=str(ROOT / "annotations"),
        coot_feat_dir=str(emb_dir))
    weights = torch.load(pth, map_location="cpu", weights_only=True)

    def build(device):
        mgr = build_mart_model_manager(config(), len(dataset.word2idx),
                                       device, seed=1)
        mgr.load_state(weights)
        return mgr

    stacked, _, _ = dataset.collate_fn([dataset[i] for i in range(8)])
    hold_train_steps("caption training", build,
                     {k: stacked[k] for k in STACKED_KEYS}, single=False)

    log("(d) one train batch of 16 videos trained 16 steps at lr "
        f"{CAPTION_TRAIN_LR} on the card, timed and traced")
    stacked, _, _ = dataset.collate_fn(
        [dataset[i] for i in range(cfg.train.batch_size)])
    log(f"  S {len(stacked['input_ids'])} sentence steps x N "
        f"{cfg.train.batch_size} x L {cfg.max_v_len + cfg.max_t_len}")
    time_train_step("caption training", build,
                    {k: stacked[k] for k in STACKED_KEYS}, single=False,
                    examples=cfg.train.batch_size, unit="videos")

    log("(e) B4 at the caption shapes, float32, rate "
        f"{cfg.hidden_dropout_prob}")
    caption_dropout_timing(cfg.hidden_dropout_prob, CAPTION_DROPOUT_SHAPES)


RAW_CONFIG = (ROOT / "config" / "caption" / "paper2020" / "yc2_mart.yaml")
MTRANS_CONFIG = (ROOT / "config" / "caption" / "paper2020" /
                 "yc2_100m_coot_vidclip_mtrans.yaml")
# phase 8's cuts of the YouCook2 caption splits: raw-feature MART trains one
# epoch on the first 160 train videos (10 steps of 16) and validates on the
# first 50 val videos (1 batch of 50); the MTransformer trains on the
# sentences of the first 320 train videos and validates on those of the
# first 50 val videos (both cut from 100 for the time limit, PERF.md §6)
RAW_VIDEOS = {"train": 160, "val": 50}
MTRANS_CUTS = {"dataset_train.max_datapoints": 320,
               "dataset_val.max_datapoints": 50}
# raw-feature MART's greedy decode card against CPU takes the first 2 val
# videos (cut from 4 for the time limit): the CPU's decode of a batch of
# 50 at L = 122 would take minutes; its train steps card against CPU take
# RAW_TRAIN_VIDEOS (cut from 8: 3 CPU steps at L = 122 took ~100 s beside
# the other phases)
RAW_DECODE_VIDEOS = 2
RAW_TRAIN_VIDEOS = 4
# B4 in float32 at the new paths' dropout shapes: raw-feature MART's hidden
# rows and attention probabilities (L = 122), the MTransformer's video rows
# (1152 in, 768 out), text rows and self-, cross- and video-attention
# probabilities; and two element counts that are no multiple of 4
VARIANT_DROPOUT_SHAPES = ((16, 122, 768), (16, 12, 122, 122),
                          (16, 3, 1152), (16, 3, 768), (16, 12, 3, 3),
                          (16, 22, 768), (16, 12, 22, 22), (16, 12, 22, 3),
                          (15, 1, 3, 3), (15, 22, 767))


def _raw_inputs(tmp: Path) -> tuple:
    """The cut of the real YouCook2 caption annotations (RAW_VIDEOS, plus
    captioning_val_para.json and mart_word2idx.json) under
    tmp/annotations/youcook2, and the port's generate_caption_video_features
    there at yc2_mart.yaml's widths (resnet 2048 + bn 1024, 2 rows a second
    of each video's duration, seed 0). Returns the annotations dir and the
    generator's result."""
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_caption_video_features)
    src = ROOT / "annotations" / "youcook2"
    ann = tmp / "annotations" / "youcook2"
    ann.mkdir(parents=True)
    for split, n in RAW_VIDEOS.items():
        name = f"captioning_{split}.json"
        data = json.loads((src / name).read_text(encoding="utf8"))
        (ann / name).write_text(json.dumps(dict(list(data.items())[:n])),
                                encoding="utf8")
    for name in ("captioning_val_para.json", "mart_word2idx.json"):
        shutil.copy(src / name, ann / name)
    t0 = time.perf_counter()
    info = generate_caption_video_features(tmp, dim_resnet=2048,
                                           dim_bn=1024, seed=0)
    files = list((Path(info["video_feature_dir"]) / "youcook2").iterdir())
    rows = [int(line.split(",")[2]) for line in (
        ann / "captioning_video_feat_duration.csv").read_text().splitlines()]
    log(f"  {RAW_VIDEOS['train']} train + {RAW_VIDEOS['val']} val videos: "
        f"{len(files)} .npy files, {sum(f.stat().st_size for f in files) / 1e9:.2f} "
        f"GB, {statistics.mean(rows):.0f} rows a video (max {max(rows)}), "
        f"{info['video_feature_size']}-d, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return tmp / "annotations", info


def _variant_cli(tag: str, common: list, cuts: str, n_val: int,
                 unit: str) -> Path:
    """`train_caption` on the card with the `-o` overrides `cuts` (or
    none): one epoch of training with validation,
    the launch counts of B1-B5 set to 0 just before and read just after
    (B4 forward and backward must run, nothing else), then `--validate
    --load_epoch 0` (the EMA weights: the training run's val loss);
    timings and peak memory logged. Returns the trained weights' file,
    model_0.pth."""
    import torch
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = train_caption.main(common + [
        "-o", ",".join(filter(None, (cuts, "train.num_epochs=1")))])[0]
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    launches = dict(cuda_build.launch_counts)
    log(f"  launches during the run {launches}")
    if launches.get("dropout", 0) <= 0 or launches.get("dropout_bwd", 0) <= 0:
        fail(f"{tag}: B4 forward or backward was not launched")
    others = {k: v for k, v in launches.items()
              if v and k not in ("dropout", "dropout_bwd")}
    if others:
        fail(f"{tag} launched kernels off its path: {others}")
    if result["model_device"].type != "cuda" \
            or result["batch_device"].type != "cuda":
        fail(f"{tag} ran on {result['model_device']} with batches on "
             f"{result['batch_device']}, not on the card")
    run = result["models_dir"].parent
    steps = json.loads((run / "metrics" / "metrics_step_0.json").read_text(
        encoding="utf8"))
    losses = [v for _, v in steps["train_base/loss"]]
    if len(losses) != result["steps_per_epoch"] \
            or not all(math.isfinite(v) for v in losses) \
            or result["train_unit"] != unit:
        fail(f"{tag}: step losses {losses} ({result['train_unit']})")
    for name in ("model_0.pth", "modelema_0.pth", "optimizer_0.pth"):
        if not (result["models_dir"] / name).is_file():
            fail(f"{tag} wrote no {name}")
    if not (run / "caption" / "translations_0_val.json").is_file():
        fail(f"{tag} wrote no translations of epoch 0")
    trained = dict(json.loads(result["metrics_file"].read_text(
        encoding="utf8"))["val/loss_word"])[0]
    log(f"  1 epoch of {result['steps_per_epoch']} steps in {wall:.2f} s "
        f"(the CLI's main(), validation included): "
        f"{result['train_videos_per_s'][0]:.2f} train {unit}/s; step wall "
        f"ms median {statistics.median(result['step_ms']):.2f} (first "
        f"{result['step_ms'][0]:.1f}); step losses first / last "
        f"{losses[0]:.3f} / {losses[-1]:.3f}; peak device memory "
        f"{peak:.3f} GB above the {held / 1e9:.3f} GB held before")
    val = train_caption.main(common + (["-o", cuts] if cuts else []) + [
        "--validate", "--load_epoch", "0"])[0]
    metrics = json.loads(val["metrics_file"].read_text(encoding="utf8"))
    (epoch, again), = metrics["val/loss_word"][-1:]
    if epoch != 0 or abs(again - trained) > 1e-6 * abs(trained):
        fail(f"{tag}: --validate --load_epoch 0 gave val loss {again}, the "
             f"training run {trained}")
    for key in ("cap/b4", "cap/met", "cap/rol", "cap/cid"):
        value = metrics[key][-1][1]
        if not math.isfinite(value) or value < 0:
            fail(f"{tag}: {key} = {value}")
    log(f"  --validate --load_epoch 0 (EMA weights): val loss per word "
        f"{again:.5f} (the training run's {trained:.5f}); "
        f"{val['num_batches']} val batches: {n_val / val['val_seconds']:.2f} "
        f"val videos/s over the validation pass ({val['val_seconds']:.2f} "
        f"s: eval step, decode and metrics); median per batch: eval step "
        f"{statistics.median(val['eval_ms']):.2f} ms, greedy decode "
        f"{statistics.median(val['decode_ms']):.2f} ms; forwards per "
        f"decode {val['forwards']}")
    log(f"  eval ms by batch {[round(v, 2) for v in val['eval_ms']]}; "
        f"decode ms {[round(v, 1) for v in val['decode_ms']]}; metrics "
        f"(1 epoch from random weights): " + json.dumps(
            {k: metrics[k][-1][1] for k in ("cap/b4", "cap/met", "cap/rol",
                                             "cap/cid", "val/acc")}))
    return result["models_dir"] / "model_0.pth"


def hold_decode(tag: str, build, arrays: dict, single: bool) -> None:
    """One val batch (numpy `arrays`) on the card against the port on the
    CPU, float32: the eval step's loss (CAPTION_LOSS_RTOL), n_word, n_correct
    (CAPTION_CORRECT_TOL of n_word), and the greedy decode token-identical."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_eval_step, caption_eval_step_single)
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    eval_step = caption_eval_step_single if single else caption_eval_step
    outs, decs = {}, {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        mgr = build(device)
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        t0 = time.perf_counter()
        outs[name] = {k: float(v) for k, v in
                      eval_step(mgr.model, batch).items()}
        translator = Translator(mgr.model, mgr.cfg)
        decs[name] = np.asarray(translator.translate_batch(batch))
        log(f"  {name}: eval step and greedy decode "
            f"({translator.forwards} forwards) {time.perf_counter() - t0:.2f}"
            " s")
        del mgr, batch
    gpu, cpu = outs["cuda"], outs["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    correct_diff = abs(gpu["n_correct"] - cpu["n_correct"]) / cpu["n_word"]
    same = decs["cuda"] == decs["cpu"]
    rows = same.reshape(-1, same.shape[-1]).all(axis=1)
    log(f"  loss {gpu['loss']:.6f} / {cpu['loss']:.6f} (relative "
        f"{loss_rel:.2e}, limit {CAPTION_LOSS_RTOL}); n_correct "
        f"{gpu['n_correct']:.0f} / {cpu['n_correct']:.0f} of "
        f"{cpu['n_word']:.0f} words ({correct_diff:.2%}, limit "
        f"{CAPTION_CORRECT_TOL:.1%}); greedy sentences token-identical "
        f"{int(rows.sum())} of {rows.size} (every one required), "
        f"{len(np.unique(decs['cuda']))} distinct tokens")
    if loss_rel > CAPTION_LOSS_RTOL or gpu["n_word"] != cpu["n_word"] \
            or correct_diff > CAPTION_CORRECT_TOL or not rows.all():
        fail(f"{tag}: the card disagrees with the CPU")


def phase_caption_variants(tmp: Path) -> None:
    """Phase 8, the caption variants at the full width of their shipped
    configs. (a) Raw-feature MART, yc2_mart.yaml (3072-d features, L = 100
    + 22): the inputs (_raw_inputs), the CLI trains one epoch and validates
    (_variant_cli), one train batch of RAW_TRAIN_VIDEOS videos card against
    CPU over 3 steps (hold_train_steps), one val batch of RAW_DECODE_VIDEOS videos
    card against CPU (hold_decode), one batch of 16 trained 16 steps, timed
    and traced (time_train_step), each from the weights the CLI trained
    (model_0.pth: from random weights the second step's gradient norm
    jumps twentyfold, 2.8e3 to 5.6e4, and the third step's grad_norm
    carries the two devices' rounding past the 1e-4 gate: 1.5e-4 on an
    H100 80GB HBM3).
    (b) The MTransformer,
    yc2_100m_coot_vidclip_mtrans.yaml (COOT vid+clip 1152-d, single
    sentences): embeddings from seed 0 (_coot_embeddings), the same checks
    on batches of 16 train and 50 val sentences. (c) B4 at the new shapes
    (caption_dropout_timing)."""
    import torch
    from coot_videotext_tpu_torch.data.caption_dataset import (
        STACKED_KEYS, UNTIED_KEYS, RecursiveCaptionDataset)
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cache = str(ROOT / "cache_caption")

    def from_trained(config_file, vocab, pth):
        """The model of the CLI's epoch (`pth`) on a device."""
        weights = torch.load(pth, map_location="cpu", weights_only=True)

        def build(device):
            mgr = build_mart_model_manager(
                MartConfig(load_yaml_config_file(config_file)), vocab,
                device, seed=1, cache_dir=cache)
            mgr.load_state(weights)
            return mgr
        return build

    log("(a) raw-feature MART at yc2_mart.yaml: inputs")
    cfg = MartConfig(load_yaml_config_file(RAW_CONFIG))
    ann_dir, info = _raw_inputs(tmp / "raw")
    common = ["-c", str(RAW_CONFIG), "--seed", "0",
              "--annotations_dir", str(ann_dir),
              "--video_feature_dir", info["video_feature_dir"],
              "--cache_dir", cache, "--log_dir", str(tmp / "raw" / "exp")]
    log("  the CLI trains one epoch on the card and validates")
    pth = _variant_cli("raw-feature MART", common, "", RAW_VIDEOS["val"],
                       "videos")

    def dataset(mode, max_n_sen):
        return RecursiveCaptionDataset(
            "youcook2", cfg.max_t_len, cfg.max_v_len, max_n_sen, mode=mode,
            coot_model_name=None, video_feature_dir=info["video_feature_dir"],
            annotations_dir=str(ann_dir))

    train = dataset("train", cfg.max_n_sen)
    build = from_trained(RAW_CONFIG, len(train.word2idx), pth)
    log(f"  one train batch of {RAW_TRAIN_VIDEOS} videos: the card against "
        f"the CPU, float32, dropout {cfg.hidden_dropout_prob}, 3 steps at lr "
        f"{CAPTION_TRAIN_LR}")
    stacked, _, _ = train.collate_fn([train[i] for i in
                                      range(RAW_TRAIN_VIDEOS)])
    hold_train_steps("raw-feature MART", build,
                     {k: stacked[k] for k in STACKED_KEYS}, single=False)
    val = dataset("val", cfg.max_n_sen + cfg.max_n_sen_add_val)
    log(f"  one val batch of {RAW_DECODE_VIDEOS} videos: the card against "
        "the CPU")
    stacked, _, _ = val.collate_fn([val[i] for i in
                                    range(RAW_DECODE_VIDEOS)])
    hold_decode("raw-feature MART", build,
                {k: stacked[k] for k in STACKED_KEYS}, single=False)
    stacked, _, _ = train.collate_fn(
        [train[i] for i in range(cfg.train.batch_size)])
    log(f"  one train batch of {cfg.train.batch_size} videos (S "
        f"{len(stacked['input_ids'])} x N {cfg.train.batch_size} x L "
        f"{cfg.max_v_len + cfg.max_t_len}) trained 16 steps at lr "
        f"{CAPTION_TRAIN_LR}, timed and traced")
    time_train_step("raw-feature MART", build,
                    {k: stacked[k] for k in STACKED_KEYS}, single=False,
                    examples=cfg.train.batch_size, unit="videos")
    del train, val, stacked
    shutil.rmtree(tmp / "raw")  # ~2 GB of features

    log("(b) the MTransformer at yc2_100m_coot_vidclip_mtrans.yaml: inputs")
    cfg = MartConfig(load_yaml_config_file(MTRANS_CONFIG))
    emb_dir = _coot_embeddings(tmp / "mtrans", cfg)
    cut = ",".join(f"{k}={v}" for k, v in MTRANS_CUTS.items())
    common = ["-c", str(MTRANS_CONFIG), "--seed", "0",
              "--annotations_dir", str(ROOT / "annotations"),
              "--coot_feat_dir", str(emb_dir), "--cache_dir", cache,
              "--log_dir", str(tmp / "mtrans" / "exp")]
    log(f"  the CLI trains one epoch on the card and validates, cuts "
        f"{MTRANS_CUTS}")
    pth = _variant_cli("MTransformer", common, cut,
                       MTRANS_CUTS["dataset_val.max_datapoints"],
                       "sentences")

    def sentences(mode, max_n_sen):
        return RecursiveCaptionDataset(
            "youcook2", cfg.max_t_len, cfg.max_v_len, max_n_sen, mode=mode,
            recurrent=False, untied=True,
            coot_model_name=cfg.coot_model_name, coot_mode=cfg.coot_mode,
            coot_dim_vid=cfg.coot_dim_vid, coot_dim_clip=cfg.coot_dim_clip,
            annotations_dir=str(ROOT / "annotations"),
            coot_feat_dir=str(emb_dir))

    train = sentences("train", cfg.max_n_sen)
    build = from_trained(MTRANS_CONFIG, len(train.word2idx), pth)
    n = cfg.train.batch_size
    log(f"  one train batch of {n} sentences: the card against the CPU, "
        f"float32, dropout {cfg.hidden_dropout_prob}, 3 steps at lr "
        f"{CAPTION_TRAIN_LR}")
    batch, _, _ = train.collate_fn([train[i] for i in range(n)])
    arrays = {k: batch[k] for k in UNTIED_KEYS}
    hold_train_steps("MTransformer", build, arrays, single=True)
    val = sentences("val", cfg.max_n_sen + cfg.max_n_sen_add_val)
    log(f"  one val batch of {cfg.val.batch_size} sentences: the card "
        "against the CPU")
    vbatch, _, _ = val.collate_fn([val[i] for i in
                                   range(cfg.val.batch_size)])
    hold_decode("MTransformer", build, {k: vbatch[k] for k in UNTIED_KEYS},
                single=True)
    log(f"  one train batch of {n} sentences (video {cfg.max_v_len} x "
        f"{cfg.video_feature_size}, text {cfg.max_t_len}) trained 16 steps "
        f"at lr {CAPTION_TRAIN_LR}, timed and traced")
    time_train_step("MTransformer", build, arrays, single=True,
                    examples=n, unit="sentences")
    torch.cuda.empty_cache()

    log(f"(c) B4 at the new shapes, float32, rate {cfg.hidden_dropout_prob}")
    caption_dropout_timing(cfg.hidden_dropout_prob, VARIANT_DROPOUT_SHAPES)


def hold_train_steps(tag: str, build, arrays: dict, single: bool) -> None:
    """One train batch (numpy `arrays`) on the card against the port on
    the CPU, same weights (`build(device)` gives the model manager) and
    seed state, 3 steps at CAPTION_TRAIN_LR: loss, grad_norm, n_correct,
    every gradient of step 1, the parameters and the EMA after 1 and 3
    steps, to the CAPTION_TRAIN_* tolerances. `single`: an untied sentence
    batch."""
    import torch
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_loss_and_grads, caption_update, init_caption_train_state)
    seen, took = {}, {}
    for name in ("cuda", "cpu"):
        t0 = time.perf_counter()
        device = torch.device(name)
        mgr = build(device)
        state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        rec = {"metrics": [], "states": []}
        for step in range(3):
            metrics, grads = caption_loss_and_grads(state, batch,
                                                    single=single)
            if step == 0:
                rec["grads"] = {n: g.detach().cpu().clone()
                                for n, g in grads.items()}
            metrics["grad_norm"] = caption_update(state, grads,
                                                  CAPTION_TRAIN_LR)
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
            if step in (0, 2):
                rec["states"].append(_state_copy(state))
        seen[name] = rec
        del mgr, state, batch, grads
        took[name] = time.perf_counter() - t0
    log(f"  3 steps on the card in {took['cuda']:.1f} s, on the CPU in "
        f"{took['cpu']:.1f} s")
    gpu, cpu = seen["cuda"], seen["cpu"]
    for step, (g, c) in enumerate(zip(gpu["metrics"], cpu["metrics"])):
        loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        norm_rel = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        correct = abs(g["n_correct"] - c["n_correct"]) / c["n_word"]
        log(f"  step {step}: loss {g['loss']:.6f} / {c['loss']:.6f} "
            f"(relative {loss_rel:.2e}), grad_norm {g['grad_norm']:.6f} / "
            f"{c['grad_norm']:.6f} ({norm_rel:.2e}), n_correct "
            f"{g['n_correct']:.0f} / {c['n_correct']:.0f} of "
            f"{c['n_word']:.0f} words ({correct:.2%})")
        if loss_rel > CAPTION_TRAIN_LOSS_RTOL \
                or norm_rel > CAPTION_TRAIN_LOSS_RTOL \
                or g["n_word"] != c["n_word"] \
                or correct > CAPTION_CORRECT_TOL:
            fail(f"{tag}: step {step} on the card disagrees with the CPU")
    scale = max(float(v.abs().max()) for v in cpu["grads"].values())
    grad_err = _max_diff(gpu["grads"], cpu["grads"]) / scale
    worst = max(cpu["grads"], key=lambda n: float(
        (gpu["grads"][n] - cpu["grads"][n]).abs().max()))
    log(f"  gradients: max |card - CPU| {grad_err:.2e} of the largest "
        f"gradient {scale:.4f} (limit {CAPTION_TRAIN_GRAD_TOL}; worst "
        f"{worst}) over {len(cpu['grads'])} tensors")
    if grad_err > CAPTION_TRAIN_GRAD_TOL:
        fail(f"{tag}: the card's gradients disagree with the CPU's")
    for i, k in enumerate((1, 3)):
        for what in ("params", "ema"):
            err = _max_diff(gpu["states"][i][what], cpu["states"][i][what])
            share = err / CAPTION_TRAIN_LR / k
            log(f"  after {k} step(s): {what} max |card - CPU| {err:.3e} "
                f"= {share:.2%} of lr per step (limit "
                f"{CAPTION_TRAIN_UPDATE_TOL:.0%})")
            if share > CAPTION_TRAIN_UPDATE_TOL:
                fail(f"{tag}: the card's {what} after {k} steps disagree "
                     "with the CPU's")
    del seen, gpu, cpu
    torch.cuda.empty_cache()


def _train_state_snapshot(state) -> dict:
    """Everything a caption train step reads, on the CPU: the parameters,
    BertAdam's step and moments, the EMA shadow, the step and the seed
    state."""
    opt = state.optimizer.state_dict()
    return {"params": {n: p.detach().cpu().clone()
                       for n, p in state.optimizer.params.items()},
            "opt": {"step": opt["step"].cpu().clone(),
                    "mu": {n: v.cpu().clone() for n, v in opt["mu"].items()},
                    "nu": {n: v.cpu().clone() for n, v in opt["nu"].items()}},
            "ema": {n: s.cpu().clone() for n, s in state.ema.shadow.items()},
            "step": state.step.cpu().clone(), "seed": state.seed.cpu().clone()}


def _load_train_state(state, snap: dict) -> None:
    import torch
    with torch.no_grad():
        for n, p in state.optimizer.params.items():
            p.copy_(snap["params"][n])
        for n, s in state.ema.shadow.items():
            s.copy_(snap["ema"][n])
    state.optimizer.load_state_dict(snap["opt"])
    state.step.copy_(snap["step"])
    state.seed.copy_(snap["seed"])


def hold_train_steps_synced(tag: str, build, arrays: dict,
                            single: bool) -> None:
    """hold_train_steps for a train trajectory too ill-conditioned to run
    free on two devices (the TransformerXL: on the CPU alone, weights moved
    by 1e-6 relative move the third step's grad_norm by ~3e-4): the CPU
    runs 3 steps at CAPTION_TRAIN_LR from the CLI's weights; the card runs
    each of them from the CPU's state before it (parameters, BertAdam's
    moments, the EMA, step and seed state). Each step to the CAPTION_TRAIN_*
    tolerances: loss, grad_norm, n_correct, every gradient, and the
    parameters and the EMA after it."""
    import torch
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_loss_and_grads, caption_update, init_caption_train_state)

    def run_step(state, batch):
        metrics, grads = caption_loss_and_grads(state, batch, single=single)
        seen = {n: g.detach().cpu().clone() for n, g in grads.items()}
        metrics["grad_norm"] = caption_update(state, grads, CAPTION_TRAIN_LR)
        return ({k: float(v) for k, v in metrics.items()}, seen,
                _train_state_snapshot(state))

    mgr = build(torch.device("cpu"))
    state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    cpu = []
    for _ in range(3):
        before = _train_state_snapshot(state)
        cpu.append((before,) + run_step(state, batch))
    del mgr, state, batch
    mgr = build(torch.device("cuda"))
    state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    for step, (before, c, c_grads, c_after) in enumerate(cpu):
        _load_train_state(state, before)
        g, g_grads, g_after = run_step(state, batch)
        loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        norm_rel = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        correct = abs(g["n_correct"] - c["n_correct"]) / c["n_word"]
        scale = max(float(v.abs().max()) for v in c_grads.values())
        grad_err = _max_diff(g_grads, c_grads) / scale
        shares = {what: _max_diff(g_after[what], c_after[what])
                  / CAPTION_TRAIN_LR for what in ("params", "ema")}
        log(f"  step {step} from the CPU's state: loss {g['loss']:.6f} / "
            f"{c['loss']:.6f} (relative {loss_rel:.2e}), grad_norm "
            f"{g['grad_norm']:.6f} / {c['grad_norm']:.6f} ({norm_rel:.2e}), "
            f"n_correct {g['n_correct']:.0f} / {c['n_correct']:.0f} of "
            f"{c['n_word']:.0f} words ({correct:.2%}); gradients "
            f"{grad_err:.2e} of the largest {scale:.4f} (limit "
            f"{CAPTION_TRAIN_GRAD_TOL}); after it params "
            f"{shares['params']:.2%} and EMA {shares['ema']:.2%} of lr (limit "
            f"{CAPTION_TRAIN_UPDATE_TOL:.0%})")
        if loss_rel > CAPTION_TRAIN_LOSS_RTOL \
                or norm_rel > CAPTION_TRAIN_LOSS_RTOL \
                or g["n_word"] != c["n_word"] \
                or correct > CAPTION_CORRECT_TOL \
                or grad_err > CAPTION_TRAIN_GRAD_TOL \
                or max(shares.values()) > CAPTION_TRAIN_UPDATE_TOL:
            fail(f"{tag}: step {step} on the card disagrees with the CPU")
    del mgr, state, batch, cpu
    torch.cuda.empty_cache()


def time_train_step(tag: str, build, arrays: dict, single: bool,
                    examples: int, unit: str) -> dict:
    """One train batch (numpy `arrays` of `examples` videos or sentences)
    trained 16 eager steps (`eager=True`; phase 14 holds the captured
    programs against them) at CAPTION_TRAIN_LR on the card: the loss must
    fall; the warm step's median wall ms, one traced step's device-busy ms
    and launches by family, B4's launches and device time, peak memory.
    Returns those numbers."""
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, caption_train_step_single,
        init_caption_train_state)
    step_fn = caption_train_step_single if single else caption_train_step
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mgr = build(torch.device("cuda"))
    state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    step_losses, step_ms = [], []
    for _ in range(16):
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, CAPTION_TRAIN_LR, eager=True)
        step_losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in step_losses) \
            or step_losses[-1] >= step_losses[0]:
        fail(f"{tag}: a fixed batch's loss did not fall: {step_losses}")
    warm = statistics.median(step_ms[4:])
    log(f"  losses {', '.join(f'{v:.2f}' for v in step_losses)}")
    log(f"  warm train step: median wall {warm:.2f} ms over steps 5-16 "
        f"({', '.join(f'{v:.1f}' for v in step_ms)}); "
        f"{examples / warm * 1e3:.1f} train {unit}/s")
    cuda_build.reset_launch_counts()
    wall_ms, busy_ms, kernels, events = _busy_ms(
        lambda: step_fn(state, batch, CAPTION_TRAIN_LR, eager=True))
    traced = dict(cuda_build.launch_counts)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    b4 = [e for e in events if "dropout" in e.key]
    b4_ms = sum(_dev_us(e) for e in b4) / 1e3
    log(f"  one traced step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); {kernels} kernel "
        f"launches; B4 {traced.get('dropout', 0)} forward + "
        f"{traced.get('dropout_bwd', 0)} backward launches, "
        f"{b4_ms:.3f} ms of device time over "
        f"{sum(e.count for e in b4)} launches; peak device memory "
        f"{peak:.3f} GB above the {held / 1e9:.3f} GB held before")
    others = {k: v for k, v in traced.items()
              if v and k not in ("dropout", "dropout_bwd")}
    if others or not traced.get("dropout") or not traced.get("dropout_bwd"):
        fail(f"{tag}: a train step launched {traced}, not B4 alone")
    log_families(events, 1)
    del mgr, state, batch
    torch.cuda.empty_cache()
    return {"warm_ms": warm, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "b4_launches": traced.get("dropout", 0)
            + traced.get("dropout_bwd", 0), "b4_ms": b4_ms,
            "peak_gb": peak}


def caption_dropout_timing(rate: float, shapes) -> None:
    """B4 in float32 at `shapes` (the hidden rows and the attention
    probabilities of a caption train step): held bit-equal to dropout_plain
    forward and backward, then timed forward and backward (CUDA events),
    bare and through the wrapper / autograd, beside F.dropout, and its
    bound."""
    import torch
    import torch.nn.functional as F
    from coot_videotext_tpu_torch.ops import cuda_build, philox
    from coot_videotext_tpu_torch.ops import dropout as b4
    gen = torch.Generator(device="cuda").manual_seed(7)
    seed = device_seed()
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        xl = x.clone().requires_grad_()
        y = b4.dropout(xl, seed, rate)
        dx, = torch.autograd.grad(y, xl, g, retain_graph=True)
        if not torch.equal(y, b4.dropout_plain(x, seed, rate)) \
                or not torch.equal(dx, b4.dropout_plain(g, seed, rate)):
            fail(f"dropout {shape} f32: kernel and plain differ")
        numel = x.numel()
        args = b4.launch_args(x, seed, rate, philox.SITE_DROPOUT,
                              cuda_build.stream(x))
        kernel = cuda_build.load_library().coot_dropout
        out = torch.empty_like(x)
        xp, yp = x.data_ptr(), out.data_ptr()
        xl_lib = x.clone().requires_grad_()
        y_lib = F.dropout(xl_lib, rate, training=True)
        with torch.inference_mode():
            bare = time_ms(lambda: kernel(xp, yp, numel, *args), 100)
            bare_dev = device_ms_per_call(
                lambda: kernel(xp, yp, numel, *args))
            fwd = time_ms(lambda: b4.dropout(x, seed, rate), 100)
            lib = time_ms(lambda: F.dropout(x, rate, training=True), 100)
            plain = time_ms(lambda: b4.dropout_plain(x, seed, rate))
        bwd, lib_bwd, _, _ = paired_bwd_ms((y, [xl], g),
                                           (y_lib, [xl_lib], g), 9)
        bms, by = bound_ms(8.0 * numel, 1.0 * numel, "float32")
        log(f"  dropout {str(shape):16s} f32 ({numel} elements): bit-equal "
            f"to plain forward and backward; bare launch {bare:.4f} ms "
            f"(CUDA events, 100 back to back), device {bare_dev:.4f} ms "
            f"(profiler); forward through the wrapper {fwd:.4f} ms, "
            f"F.dropout {lib:.4f} ms; backward through autograd.grad "
            f"{bwd:.4f} ms, F.dropout's {lib_bwd:.4f} ms (medians of 9 "
            f"rounds in turns); plain {plain:.3f} ms; bound {bms:.5f} ms "
            f"({by})")


# Phase 9, the rest of the caption family at the full width of
# yc2_2d3d_coot_vidclip_mart.yaml, each reached by `-o` overrides of it. The
# CLI of each trains one epoch on the first 160 videos of the YouCook2 train
# split (10 steps of 16 videos, or the sentences of those videos in batches
# of 16) and validates on the first 50 val videos (cut from 100 for the
# time limit, PERF.md §6). (The XL's card-vs-CPU steps start from these
# trained weights; 96 videos gave weights whose third step's update missed
# by 6.6% of lr.)
FAMILY_CUTS = {"dataset_train.max_datapoints": 160,
               "dataset_val.max_datapoints": 50}
FAMILY_VARIANTS = (
    # (tag, -o overrides, the step check's extra overrides, train unit,
    # whether the card runs each checked step from the CPU's state:
    # hold_train_steps_synced)
    ("TransformerXL", {"xl": True}, {"xl_grad": True}, "videos", True),
    ("untied", {"recurrent": False, "untied": True}, {}, "sentences",
     False),
    ("joint single-sentence", {"recurrent": False}, {}, "sentences", False),
    ("tied decoder", {"share_wd_cls_weight": True, "word_vec_size": 768,
                      "use_glove": False}, {}, "videos", False),
)
# the recurrent variants' greedy decode card against CPU takes the first 2
# val videos (cut from 8, then 4, for the time limit, PERF.md §6): the CPU
# decodes a batch of 50 in ~45 s
FAMILY_DECODE_VIDEOS = 2
# the beam check's CPU decode takes the first 4 videos of the card's batch
# of 50 (cut from 16, then 8, for the time limit, PERF.md §6; the card's
# rows of them are compared, and a row's decode does not depend on the
# others)
BEAM_CPU_VIDEOS = 4
# B4 in float32 at the shapes these paths add: XL's (klen, 768) position
# table at klen 25 and 50 and a (16, 50, 768) block, the untied text
# embedding at word_vec_size 300, and a short batch whose element count is
# no multiple of 4
FAMILY_DROPOUT_SHAPES = ((25, 768), (50, 768), (16, 50, 768), (16, 22, 300),
                         (13, 22, 301))


def _overrides(over: dict) -> str:
    """An `-o` string of a dict of overrides."""
    return ",".join(f"{k}={str(v).lower() if isinstance(v, bool) else v}"
                    for k, v in over.items())


def _family_build(over: dict, vocab: int, pth: Path):
    """build(device): the model manager of CAPTION_CONFIG with `over`,
    loaded with the weights of `pth`."""
    import torch
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    weights = torch.load(pth, map_location="cpu", weights_only=True)

    def build(device):
        config = load_yaml_config_file(CAPTION_CONFIG)
        config.update(over)
        mgr = build_mart_model_manager(MartConfig(config), vocab, device,
                                       seed=1,
                                       cache_dir=str(ROOT / "cache_caption"))
        mgr.load_state(weights)
        return mgr
    return build


def _family_dataset(cfg, emb_dir: Path, mode: str):
    from coot_videotext_tpu_torch.data.caption_dataset import (
        RecursiveCaptionDataset)
    max_n_sen = cfg.max_n_sen + (cfg.max_n_sen_add_val if mode == "val"
                                 else 0)
    return RecursiveCaptionDataset(
        "youcook2", cfg.max_t_len, cfg.max_v_len, max_n_sen, mode=mode,
        recurrent=cfg.recurrent, untied=cfg.untied or cfg.mtrans,
        coot_model_name=cfg.coot_model_name, coot_mode=cfg.coot_mode,
        coot_dim_vid=cfg.coot_dim_vid, coot_dim_clip=cfg.coot_dim_clip,
        annotations_dir=str(ROOT / "annotations"),
        coot_feat_dir=str(emb_dir))


def phase_caption_family(tmp: Path) -> None:
    """Phase 9, the rest of the caption family at the full width of
    yc2_2d3d_coot_vidclip_mart.yaml (COOT vid+clip embeddings from seed 0,
    _coot_embeddings). (a) Beam search (use_beam, beam 2) on MART trained
    one epoch by the CLI (_variant_cli): one val batch of 50 videos
    decoded by beam search on the card, its first BEAM_CPU_VIDEOS on the
    CPU too, in the fixed and the reference_compat mode (at least
    CAPTION_MIN_SAME of those sentences token-identical), beam against
    greedy on the card on the batch of 50 (ms, forwards, host reads), one
    traced beam decode of the batch's first TRACE_STEPS sentence steps (no
    port kernel may launch), the CLI's `--validate --load_epoch 0 -o
    use_beam=true` over the 50 val videos. (b-e) The TransformerXL, the
    untied model, the joint single-sentence model and the decoder tied to
    the word embeddings: the CLI trains one epoch and validates (_variant_cli),
    then from its weights one train batch card against CPU over 3 steps
    (hold_train_steps; XL's with xl_grad), one val batch's eval step and
    greedy tokens card against CPU (hold_decode), one train batch trained
    16 steps, timed and traced (time_train_step). (f) B4 at the new shapes
    (caption_dropout_timing)."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.data.caption_dataset import (
        STACKED_KEYS, UNTIED_KEYS)
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    def config(over: dict):
        cfg = load_yaml_config_file(CAPTION_CONFIG)
        cfg.update(over)
        return MartConfig(cfg)

    cfg = config({})
    emb_dir = _coot_embeddings(tmp, cfg)
    cut = _overrides(FAMILY_CUTS)
    n_val = FAMILY_CUTS["dataset_val.max_datapoints"]

    def common(tag):
        return ["-c", str(CAPTION_CONFIG), "--seed", "0",
                "--annotations_dir", str(ROOT / "annotations"),
                "--coot_feat_dir", str(emb_dir),
                "--cache_dir", str(ROOT / "cache_caption"),
                "--log_dir", str(tmp / tag.replace(" ", "_"))]

    log(f"(a) beam search (beam {cfg.beam_size}, n_best {cfg.n_best}, "
        f"min_sen_len {cfg.min_sen_len}, max_sen_len {cfg.max_sen_len}, "
        f"block_ngram_repeat {cfg.block_ngram_repeat}, length penalty "
        f"{cfg.length_penalty_name}) on MART: the CLI trains one epoch, "
        f"cuts {FAMILY_CUTS}")
    pth = _variant_cli("MART for beam search", common("beam"), cut, n_val,
                       "videos")
    val = _family_dataset(cfg, emb_dir, "val")
    build = _family_build({}, len(val.word2idx), pth)
    inputs, sizes = {}, None
    for name, n in (("cuda", cfg.val.batch_size), ("cpu", BEAM_CPU_VIDEOS)):
        stacked, sizes, _ = val.collate_fn([val[i] for i in range(n)])
        inputs[name] = [stacked[k] for k in ("input_ids", "video_feature",
                                             "input_mask", "token_type_ids")]
    # `sizes`: the sentences of the CPU's videos, the rows compared
    log(f"  one val batch of {cfg.val.batch_size} videos beam decoded on "
        f"the card, its first {BEAM_CPU_VIDEOS} (S {len(inputs['cpu'][0])}, "
        f"{sum(sizes)} sentences) on the CPU too")
    decs = {}
    for name in ("cuda", "cpu"):
        mgr = build(torch.device(name))
        translator = Translator(mgr.model, mgr.cfg)
        batch = [torch.from_numpy(a).to(name) for a in inputs[name]]
        for compat in (False, True):
            t0 = time.perf_counter()
            decs[name, compat] = translator.translate_batch_beam(
                *batch, reference_compat=compat)
            log(f"  {name} {'reference_compat' if compat else 'fixed'}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
                f"{translator.forwards} forwards, {translator.host_reads} "
                "host reads")
        if name == "cuda":
            card = mgr, translator, batch
        else:
            del mgr, translator, batch
    for compat in (False, True):
        pairs = [(decs["cuda", compat][s][i], decs["cpu", compat][s][i])
                 for i, size in enumerate(sizes) for s in range(size)]
        same = sum(bool(np.array_equal(a, b)) for a, b in pairs)
        empty = sum(int((a[1:] == 0).all()) for a, _ in pairs)
        log(f"  {'reference_compat' if compat else 'fixed'}: beam sentences "
            f"token-identical card against CPU {same} of {len(pairs)} "
            f"(limit {CAPTION_MIN_SAME:.0%}); {empty} decode to nothing "
            f"but [BOS]; {len(np.unique(np.stack(decs['cuda', compat])))} "
            "distinct tokens")
        if same < CAPTION_MIN_SAME * len(pairs):
            fail(f"beam search ({'compat' if compat else 'fixed'}): the card "
                 "disagrees with the CPU")
    mgr, translator, batch = card
    times = {}
    for what, fn in (("greedy", translator.translate_batch_greedy),
                     ("beam", translator.translate_batch_beam)):
        fn(*batch)  # warm
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(*batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[what] = (statistics.median(ms), translator.forwards,
                       translator.host_reads)
    log(f"  on the card, the same batch (median of 3): greedy "
        f"{times['greedy'][0]:.1f} ms ({times['greedy'][1]} forwards, "
        f"{times['greedy'][2]} host reads), beam {times['beam'][0]:.1f} ms "
        f"({times['beam'][1]} forwards of {cfg.beam_size}x the rows, "
        f"{times['beam'][2]} host reads): beam / greedy "
        f"{times['beam'][0] / times['greedy'][0]:.2f}")
    cuda_build.reset_launch_counts()
    wall_ms, busy_ms, kernels, events = _busy_ms(
        lambda: translator.translate_batch_beam(
            *(b[:TRACE_STEPS] for b in batch)))
    launches = dict(cuda_build.launch_counts)
    log(f"  one traced beam decode of {TRACE_STEPS} sentence steps: wall "
        f"{wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}); {kernels} kernel "
        f"launches, {kernels / translator.forwards:.1f} per forward; port "
        f"kernel launches {launches}")
    if any(launches.values()):
        fail(f"beam search launched the port's kernels: {launches}")
    log_families(events, translator.forwards)
    del mgr, translator, batch, card, decs
    torch.cuda.empty_cache()
    cuda_build.reset_launch_counts()
    result = train_caption.main(common("beam") + [
        "-o", cut + ",use_beam=true", "--validate", "--load_epoch", "0"])[0]
    launches = dict(cuda_build.launch_counts)
    metrics = json.loads(result["metrics_file"].read_text(encoding="utf8"))
    for key in ("cap/b4", "cap/met", "cap/rol", "cap/cid"):
        value = metrics[key][-1][1]
        if not math.isfinite(value) or value < 0:
            fail(f"beam search CLI: {key} = {value}")
    if any(launches.values()) or result["model_device"].type != "cuda":
        fail(f"beam search CLI: on {result['model_device']}, launches "
             f"{launches}")
    log(f"  the CLI, --validate --load_epoch 0 -o use_beam=true (EMA "
        f"weights): {n_val / result['val_seconds']:.2f} val videos/s over "
        f"the validation pass ({result['val_seconds']:.2f} s); per batch "
        f"decode ms {[round(v, 1) for v in result['decode_ms']]}, eval ms "
        f"{[round(v, 2) for v in result['eval_ms']]}, forwards "
        f"{result['forwards']}, host reads {result['host_reads']}; "
        f"launches {launches}; metrics " + json.dumps(
            {k: metrics[k][-1][1] for k in ("cap/b4", "cap/met", "cap/rol",
                                             "cap/cid", "val/acc")}))

    for i, (tag, over, step_over, unit, synced) in enumerate(
            FAMILY_VARIANTS):
        cfg = config(over)
        single = not cfg.recurrent
        keys = UNTIED_KEYS if cfg.untied else STACKED_KEYS
        log(f"({'bcde'[i]}) {tag} ({_overrides(over)}): the CLI trains one "
            "epoch on the card and validates")
        pth = _variant_cli(tag, common(tag), ",".join((cut, _overrides(over))),
                           n_val, unit)
        train = _family_dataset(cfg, emb_dir, "train")
        n = 8 if not single else cfg.train.batch_size
        log(f"  one train batch of {n} {unit}: the card against the CPU, "
            f"float32, dropout {cfg.hidden_dropout_prob}, 3 steps at lr "
            f"{CAPTION_TRAIN_LR}" + (f", with {_overrides(step_over)}"
                                     if step_over else ""))
        batch, _, _ = train.collate_fn([train[j] for j in range(n)])
        hold = hold_train_steps_synced if synced else hold_train_steps
        hold(tag, _family_build({**over, **step_over}, len(train.word2idx),
                                pth), {k: batch[k] for k in keys},
             single=single)
        build = _family_build(over, len(train.word2idx), pth)
        val = _family_dataset(cfg, emb_dir, "val")
        n = cfg.val.batch_size if single else FAMILY_DECODE_VIDEOS
        vbatch, _, _ = val.collate_fn([val[j] for j in range(n)])
        log(f"  one val batch of {n} {unit}: the card against the CPU")
        hold_decode(tag, build, {k: vbatch[k] for k in keys}, single=single)
        n = cfg.train.batch_size
        batch, _, _ = train.collate_fn([train[j] for j in range(n)])
        log(f"  one train batch of {n} {unit} trained 16 steps at lr "
            f"{CAPTION_TRAIN_LR}, timed and traced")
        time_train_step(tag, build, {k: batch[k] for k in keys},
                        single=single, examples=n, unit=unit)
        del train, val, batch, vbatch
        torch.cuda.empty_cache()

    log(f"(f) B4 at the new shapes, float32, rate {cfg.hidden_dropout_prob}")
    caption_dropout_timing(cfg.hidden_dropout_prob, FAMILY_DROPOUT_SHAPES)


def _busy_ms(fn, require_complete: bool = False,
             host: bool = False) -> tuple:
    """(traced wall ms, device-busy ms, kernels seen, the kernels' profiler
    events) of fn() under torch.profiler, synchronised: the busy time sums
    the kernels' device time, graph replays' kernels included. The trace
    opens with `warm_trace` (utils/profiling.py), left out of the counts;
    fewer device records than the host's kernel launches are logged, and
    where `require_complete` fn() is traced again, up to 3 times in all,
    before the run fails. With `host`, a fifth entry counts the host's
    calls: {"kernel_launches": cudaLaunchKernel and the like, outside the
    warm-up, "graph_launches": cudaGraphLaunch}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from coot_videotext_tpu_torch.utils.profiling import (
        TRACE_WARMUP_LAUNCHES, warm_trace)
    for attempt in range(3 if require_complete else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_trace()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        events = _device_events(averages)
        kernels = sum(e.count for e in events)
        launches = sum(e.count for e in averages if "LaunchKernel" in e.key
                       ) - TRACE_WARMUP_LAUNCHES
        if kernels >= launches:
            break
        lost = (f"the trace holds {kernels} device records for {launches} "
                "kernel launches on the host")
        log(f"  ({lost}: its busy time is short"
            f"{'; traced again' if attempt < 2 and require_complete else ''}"
            ")")
    else:
        if require_complete:
            fail(lost)
    out = (wall, sum(_dev_us(e) for e in events) / 1e3, kernels, events)
    if host:
        graphs = sum(e.count for e in averages if "GraphLaunch" in e.key)
        out += ({"kernel_launches": launches, "graph_launches": graphs},)
    return out


def _device_events(averages) -> list:
    """The profiler's device entries with device time, without the trace's
    warm-up (utils/profiling.py `warm_trace`: its kernels and the device
    span of its range)."""
    from coot_videotext_tpu_torch.utils.profiling import (
        WARMUP_KERNEL, WARMUP_RANGE)
    return [e for e in averages if str(e.device_type).endswith("CUDA")
            and _dev_us(e) > 0 and WARMUP_KERNEL not in e.key
            and e.key != WARMUP_RANGE]


def _port_kernel_counts(events) -> dict:
    """The port's kernels among a trace's device events (graph replays'
    nodes included), counted by the name of each `__global__` function
    and summed by the source that defines it: {"input_fc", "genpool",
    "attention", "gather", "dropout", "coot_norm"} (csrc/<name>.cu; the
    shared TN kernels of csrc/*.cuh are not counted)."""
    owner = {}
    for src in sorted((PACKAGE / "csrc").glob("*.cu")):
        for name in re.findall(
                r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", src.read_text(encoding="utf8")):
            owner[name] = src.stem
    counts = {}
    for e in events:
        m = re.search(r"coot::(?:\(anonymous namespace\)::)?(\w+)", e.key)
        if m and m.group(1) in owner:
            stem = owner[m.group(1)]
            counts[stem] = counts.get(stem, 0) + e.count
    return counts


EVAL_KERNELS = ("input_fc", "genpool", "attention", "gather", "coot_norm")


# kernel families of a train step by name, first match wins
KERNEL_FAMILIES = (
    ("the port's kernels B1-B5", ("coot::",)),
    ("matrix products (cuBLAS, CUTLASS)",
     ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("multi-tensor (_foreach: optimizer, clipping)",
     ("multi_tensor", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise on int64 by name (Philox draws, index math)",
     ("<long>", "<long,", "long, long", "<int>", "<int,")),
    ("other elementwise (float; shifts and lambdas unnamed)",
     ("elementwise",)),
)


def log_families(events, steps: int) -> None:
    """Device ms and launches per step of each kernel family, then the
    heaviest kernels."""
    per = {}
    for e in events:
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in e.key for k in keys)), "other")
        ms, n = per.get(fam, (0.0, 0))
        per[fam] = (ms + _dev_us(e) / 1e3, n + e.count)
    for fam, (ms, n) in sorted(per.items(), key=lambda x: -x[1][0]):
        log(f"    {ms / steps:7.3f} ms  {n / steps:7.1f} launches per step  "
            f"{fam}")
    for e in sorted(events, key=_dev_us, reverse=True)[:12]:
        log(f"      {_dev_us(e) / 1e3 / steps:7.3f} ms  "
            f"x{e.count / steps:<6.1f} {e.key[:110]}")


def phase_group(tmp: Path) -> dict:
    """Phase 4c, the group step (train.steps_per_dispatch = K): the CLI
    trains one epoch of a 640-video split (10 steps: groups of 4, 4 and
    a tail of 2) on the device-resident path, each group a replay of the
    captured train step, with the launch counts set to 0 just before and
    read just after; one fixed id batch trains 16 steps per step and as 2
    groups of 8 replays from the same state (the graph captured first, the
    state then restored in place): losses, parameters and seed states
    held against each other after 8 steps and after 16, the loss falling;
    then, per K in (1, 4, 8), the warm wall ms per step, the device-busy
    ms per step, train videos/s and peak device memory."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.ops import cuda_build, philox
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        TrainState, retrieval_train_group, retrieval_train_step)
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    cuda = torch.device("cuda")
    made = _take_data("group", tmp / "data")
    log(f"a yc2-like train split (640 videos, 64 val): {made}")
    config = _config(tmp / "group")
    result, launches, wall = _train_cli(
        config, tmp, ["--preload_device", "--fixed_shapes"],
        overrides=",train.steps_per_dispatch=4")
    losses, state = result["step_losses"], result["state"]
    log(f"CLI (store, device sampling + packing, steps_per_dispatch=4): 1 "
        f"epoch of {len(losses)} steps in dispatches "
        f"{result['dispatches']} (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}) and its validation in "
        f"{wall:.1f} s; epoch time {state['time_total']:.2f} s of which "
        f"validation {state['time_val']:.2f} s; "
        f"{640 / (state['time_total'] - state['time_val']):.2f} train "
        f"videos/s end to end (the capture included); launches (the eager "
        f"first step and the capture; replays run no Python) {launches}")
    if (len(losses) != 10 or result["layout"] != "ids"
            or result["dispatches"] != {"group": 3}):
        fail(f"group CLI: {len(losses)} steps on {result['layout']} "
             f"batches in dispatches {result['dispatches']} (expected 10 "
             "steps on ids in 3 groups, none per step)")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the group path")
    # end to end past the capture: the same run resumed to 3 epochs, and
    # the per-step CLI on the same split, epochs 1-2 of each
    for k, cfg_path, extra in (
            (4, config, ",train.steps_per_dispatch=4"),
            (1, _config(tmp / "per_step"), "")):
        result, _, wall = _train_cli(
            cfg_path, tmp, ["--preload_device", "--fixed_shapes"],
            epochs=3, overrides=extra + ",saving.keep_freq=1")
        per_epoch = _epoch_train_s(result["path_base"] / "models", (1, 2))
        expect = {"group": 6} if k == 4 else {"step": 30}
        if result["dispatches"] != expect or len(result["step_losses"]) \
                != 30 or not np.isfinite(result["step_losses"]).all():
            fail(f"CLI K={k}, 3 epochs: dispatches {result['dispatches']}, "
                 f"{len(result['step_losses'])} steps")
        log(f"CLI K={k}: epochs 1-2 (20 steps) train seconds per epoch "
            f"{', '.join(f'{t:.3f}' for t in per_epoch)}; "
            f"{2 * 640 / sum(per_epoch):.2f} train videos/s end to end "
            f"(run of {wall:.1f} s, dispatches {result['dispatches']})")
    held_after_cli(cuda)

    cfg = RetrievalConfig(load_yaml_config_file(config))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=cuda, fixed_shapes=True,
        device_preload=True)
    source = FeatureSource.of(loader, cfg.dataset_train.frames_noise,
                              cfg.dataset_train.words_noise)
    batches = list(loader)
    b = len(batches[0]["dp_idx"])
    kw = dict(lr=cfg.optimizer.lr, clip_gradient=cfg.train.clip_gradient,
              source=source, loss_cycle_cons=cfg.train.loss_cycle_cons,
              loss_weights=cfg.train.contrastive_loss_config.as_dict(),
              margin=cfg.train.contrastive_loss_config.margin)

    def new_state():
        mgr = RetrievalModelManager(cfg, cuda, seed=0)
        kw["compute_dtype"] = mgr.train_dtype
        return TrainState(mgr.model, make_optimizer(
            cfg.optimizer, dict(mgr.model.named_parameters())),
            philox.seed_state(0, cuda))

    def group_arrays(group):
        return (np.stack([g["dp_idx"] for g in group]),
                np.stack([g["batch_valid"] for g in group]))

    # one fixed id batch, 16 steps: per step, and as 2 groups of 8 replays
    fixed = batches[0]
    eager, graph = new_state(), new_state()
    snapshot = {n: p.detach().clone()
                for n, p in graph.optimizer.params.items()}
    ids, valid = group_arrays([fixed] * 8)
    retrieval_train_group(graph, ids, valid, 1, **kw)  # step 1, capture
    opt = graph.optimizer
    with torch.no_grad():  # back to the start, in place
        for n, p in opt.params.items():
            p.copy_(snapshot[n])
            opt.mu[n].zero_()
            opt.nu[n].zero_()
        opt.step_count.zero_()
        graph.seed.fill_(0)
    graph.step = 0
    dev_batch = to_device(fixed, cuda)
    per_step, grouped = [], []
    tol = TOL[str(kw["compute_dtype"]).split(".")[-1]]
    for half in range(2):
        per_step += [float(retrieval_train_step(eager, dev_batch, **kw)
                           ["loss_total"]) for _ in range(8)]
        before = dict(cuda_build.launch_counts)
        out = retrieval_train_group(graph, ids, valid, 8, **kw)
        grouped += out["loss_total"].tolist()
        if dict(cuda_build.launch_counts) != before:
            fail("group step: a replay ran a kernel wrapper (Python)")
        worst = max(errors(g_, e_)[1] for g_, e_ in zip(
            graph.optimizer.params.values(),
            eager.optimizer.params.values()))
        loss_err = max(abs(a - b_) / max(1.0, abs(b_)) for a, b_ in
                       zip(grouped, per_step))
        seeds = (int(graph.seed), int(eager.seed))
        log(f"  after {8 * (half + 1)} steps on one batch: seed states "
            f"{seeds[0]} (graph) / {seeds[1]} (per step); largest loss "
            f"difference {loss_err:.3e}, parameters {worst:.3e}, relative "
            f"to max(1, |per step|) (tol {tol})")
        if seeds[0] != seeds[1] or seeds[0] != 8 * (half + 1):
            fail(f"group step: seed states {seeds} after "
                 f"{8 * (half + 1)} steps")
        if not (loss_err <= tol and worst <= tol):
            fail(f"group step: 8 replays differ from 8 per-step calls "
                 f"(loss {loss_err}, parameters {worst})")
    log("fixed id batch, 16 steps: per step " + " ".join(
        f"{v:.4f}" for v in per_step) + "; replayed " + " ".join(
        f"{v:.4f}" for v in grouped))
    for name, ls in (("per step", per_step), ("replayed", grouped)):
        if not (np.isfinite(ls).all()
                and np.mean(ls[-3:]) < np.mean(ls[:3])):
            fail(f"the fixed batch's loss did not fall ({name})")
    del eager, graph, snapshot, dev_batch
    torch.cuda.empty_cache()

    # warm steps per K: 16 steps over the epoch's batches, 3 rounds after
    # one round of warm-up (the capture included), then max(K, 2) steps
    # traced (the profiler's processing of an eager step takes seconds)
    timing = {}
    for k in (1, 4, 8):
        n_traced = max(k, 2)
        ts = new_state()
        order = [batches[i % len(batches)] for i in range(16)]
        dev = [to_device(x, cuda) for x in order] if k == 1 else None

        def steps(n, ts=ts, k=k, order=order, dev=dev):
            if k == 1:
                for i in range(n):
                    float(retrieval_train_step(ts, dev[i], **kw)
                          ["loss_total"])  # the trainer's sync per step
                return
            for g0 in range(0, n, k):
                ids, valid = group_arrays(order[g0:g0 + k])
                out = retrieval_train_group(ts, ids, valid, len(ids), **kw)
                torch.stack(list(out.values())).cpu()  # one sync a group

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(16)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(16)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / 16)
        traced, busy, kernels, events = _busy_ms(lambda: steps(n_traced))
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(walls)
        traced, busy = traced / n_traced, busy / n_traced
        timing[k] = dict(wall_ms=med, busy_ms=busy, traced_ms=traced,
                         videos_s=b / med * 1e3, peak_gb=peak)
        log(f"K={k}: warm wall per step {med:.2f} ms (rounds of 16: "
            f"{', '.join(f'{w:.2f}' for w in walls)}), {b / med * 1e3:.1f} "
            f"train videos/s; traced {n_traced} steps: {traced:.2f} ms per "
            f"step wall, device busy {busy:.2f} ms per step "
            f"({kernels} kernels, {100 * busy / traced:.1f}% busy); peak "
            f"device memory {peak:.2f} GB")
        if busy <= 0:
            fail(f"K={k}: the profiler saw no device time")
        if k == 4:
            log("  K=4, device time per step by kernel family:")
            log_families(events, n_traced)
        del ts, dev, events
        torch.cuda.empty_cache()
    return timing


def held_after_cli(device) -> dict:
    """The device memory the in-process CLI runs left allocated (GB): as
    they left it, after a garbage collection (what reference cycles held),
    and after utils/graphs.py `release_all` (what the captured graphs of
    live objects held). Logged and returned."""
    import gc
    import torch
    from coot_videotext_tpu_torch.utils.graphs import release_all
    torch.cuda.synchronize(device)
    held = {"as_left": torch.cuda.memory_allocated(device) / 1e9}
    gc.collect()
    held["after_gc"] = torch.cuda.memory_allocated(device) / 1e9
    dropped = release_all()
    gc.collect()
    held["after_release_all"] = torch.cuda.memory_allocated(device) / 1e9
    log(f"  device memory the CLI runs left allocated: "
        f"{held['as_left']:.3f} GB as they left it, {held['after_gc']:.3f} "
        f"GB after gc.collect(), {held['after_release_all']:.3f} GB after "
        f"release_all() dropped {dropped} more graphs")
    return held


def profile_step(step_fn, what: str) -> list:
    """One warm step under torch.profiler: the device's busy share of the
    step and the device time by kernel. Returns the trace's device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from coot_videotext_tpu_torch.utils.profiling import warm_trace

    def step():
        step_fn()
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm_trace()
        t0 = time.perf_counter()
        step()
        traced_ms = (time.perf_counter() - t0) * 1e3

    # kernel entries only: CPU ops also carry their kernels' device time
    events = _device_events(prof.key_averages())
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    log(f"traced {what} step: {traced_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%); top device "
        "time:")
    for e in sorted(events, key=_dev_us, reverse=True)[:16]:
        log(f"    {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    for family, pattern in (
            ("B1 forward", ("row_stats", "input_fc_fwd_mma")),
            ("B1 backward (without its sum_splits)",
             ("dpre_colsum", "tn_mma<true>", "param_grads")),
            ("B2 forward", ("genpool_fwd", "genpool_pool")),
            ("B2 backward (without its sum_splits)",
             ("genpool_bwd_tiles", "tn_mma<false>")),
            ("B3 forward", ("masked_attention_fwd",)),
            ("B3 backward", ("masked_attention_bwd",)),
            ("B4", ("dropout_kernel",))):
        mine = [e for e in events if any(p in e.key for p in pattern)]
        log(f"  {family} ({'*, '.join(pattern)}*): "
            f"{sum(_dev_us(e) for e in mine) / 1e3:.3f} ms device time over "
            f"{sum(e.count for e in mine)} launches in the step")
    return events


def device_ms_per_call(fn, calls: int = 100) -> float:
    """The profiler's device ms per call of fn, over all its kernels."""
    return sum(kernel_ms(fn, calls).values())


def kernel_ms(fn, calls: int = 20) -> dict:
    """The profiler's device ms per call of fn, by kernel (the name up to
    its argument list, without the namespace): for each kernel its mean
    time per launch, times its launches per call (at least 1). Means per
    launch hold when the trace misses some of a thread's launches (seen for
    backwards run by autograd's device thread)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from coot_videotext_tpu_torch.utils.profiling import warm_trace
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm_trace()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in _device_events(prof.key_averages()):
        name = e.key.replace("(anonymous namespace)::", "").split(
            "(")[0].split("::")[-1]
        per_call = _dev_us(e) / e.count * max(1, round(e.count / calls))
        out[name] = out.get(name, 0.0) + per_call / 1e3
    return out


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host microseconds per call of fn (the launches are queued, not
    waited for)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def paired_bwd_ms(ours, lib, rounds: int = 5):
    """Medians of two backwards through autograd.grad (`_bwd_ms` on
    (out, inputs, g)), timed in turns so that the host's load falls on both
    alike, and each round's times."""
    a, b = [], []
    for _ in range(rounds):
        a.append(_bwd_ms(*ours))
        b.append(_bwd_ms(*lib))
    return statistics.median(a), statistics.median(b), a, b


def dropout_host_device(x, seed, fwd_ms, bwd_ms, lib_bwd_ms):
    """B4 forward, B4 backward and F.dropout's backward on x, four ways:
    (i) CUDA events over 100 back-to-back bare launches, (ii) the
    profiler's device time per launch, (iii) host microseconds per wrapper
    call, (iv) the wrapper as phase 5 times it (forward in inference mode,
    backwards through torch.autograd.grad, median of rounds in turns)."""
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build, philox
    from coot_videotext_tpu_torch.ops import dropout as b4
    rate, numel = 0.01, x.numel()
    args = b4.launch_args(x, seed, rate, philox.SITE_DROPOUT,
                          cuda_build.stream(x))
    kernel = cuda_build.load_library().coot_dropout
    y = torch.empty_like(x)
    xp, yp = x.data_ptr(), y.data_ptr()
    _, mask = torch.ops.aten.native_dropout(x, rate, True)
    calls = {
        "B4 forward": (lambda: kernel(xp, yp, numel, *args),
                       lambda: b4.dropout(x, seed, rate), fwd_ms),
        "B4 backward": (lambda: kernel(xp, yp, numel, *args),
                        lambda: b4.launch(x, args, "dropout_bwd"), bwd_ms),
        "F.dropout backward": (
            lambda: torch.ops.aten.native_dropout_backward(
                x, mask, 1.0 / (1.0 - rate)),
            lambda: torch.ops.aten.native_dropout_backward(
                x, mask, 1.0 / (1.0 - rate)), lib_bwd_ms),
    }
    with torch.inference_mode():
        for name, (bare, wrapper, through) in calls.items():
            log(f"  {name:18s} {numel} bf16: (i) {time_ms(bare, 100):.4f} ms "
                f"per bare launch (CUDA events, 100 back to back), (ii) "
                f"{device_ms_per_call(bare):.4f} ms device time per launch "
                f"(profiler), (iii) {host_us_per_call(wrapper):.1f} us host "
                f"per wrapper call, (iv) {through:.4f} ms through the "
                "wrapper" + (" (forward)" if name == "B4 forward" else
                             " (torch.autograd.grad)"))


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _bwd_ms(out, inputs, g) -> float:
    """The backward alone: autograd.grad over a kept graph."""
    import torch
    return time_ms(lambda: torch.autograd.grad(out, inputs, g,
                                               retain_graph=True))


def norm_timing(shapes, gen, max_errors) -> list:
    """B6 (the residual add and CootLayerNorm) in bf16 at the four post-LN
    norm calls of a train step's local nets (width 384) and the global
    nets' input norm (768, no residual): checked against the plain version
    forward and backward, the backward repeated bit for bit, then timed
    with the plain path (the unfused composition through autograd, as the
    port ran it before B6) and the profiler's device time by kernel.
    Returns the kernels-line entries of the clips call."""
    import torch
    from coot_videotext_tpu_torch.ops.coot_norm import (
        coot_norm, coot_norm_backward_plain, coot_norm_plain)
    bf = torch.bfloat16
    calls = (("clips", shapes.get("pack_clips", shapes["b"]
                                  * shapes["n_parts"]) * shapes["lc"], 384),
             ("video ctx", shapes["b"] * shapes["lv"], 384),
             ("paragraph", shapes["b"] * shapes["lp"], 384),
             ("sentences", shapes.get("pack_sents", shapes["b"]
                                      * shapes["n_parts"]) * shapes["ls"],
              384),
             ("global input", shapes["b"] * shapes["n_parts"], 768))
    out = []
    for what, rows, width in calls:
        residual = what != "global input"
        y = (2 * torch.randn(rows, width, generator=gen, device="cuda")
             + 0.5).to(bf)
        r = (torch.randn(rows, width, generator=gen, device="cuda").to(bf)
             if residual else None)
        y[:3] = 3.0  # constant rows, as zeroed padded slots
        if residual:
            r[:3] = -1.0
        gain = 1 + 0.1 * torch.randn(width, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(width, generator=gen, device="cuda")
        dout = torch.randn(rows, width, generator=gen, device="cuda").to(bf)
        shape = f"{rows}x{width} bf16" + (" + residual" if residual else "")
        leaves = [t.clone().requires_grad_() for t in (y, r, gain, bias)
                  if t is not None]

        def fused(*a, res=residual):
            return coot_norm(a[0], a[1] if res else None, *a[-2:], 1e-6)

        def plain(*a, res=residual):
            return coot_norm_plain(a[0], a[1] if res else None, *a[-2:],
                                   1e-6)

        with torch.inference_mode():
            args = [t for t in (y, r, gain, bias) if t is not None]
            err = errors(fused(*args), plain(*args))
            check_tol("coot_norm", "bfloat16", f"{what} {shape}", *err)
            eval_ms = time_ms(lambda: fused(*args), 20)
            eval_split = kernel_ms(lambda: fused(*args))
            plain_eval = time_ms(lambda: plain(*args), 5)
        o = fused(*leaves)

        def backward():
            return torch.autograd.grad(o, leaves, dout, retain_graph=True)

        grads = backward()
        dx, dgain, dbias = coot_norm_backward_plain(
            y if r is None else y + r, gain, 1e-6, dout)
        ref = [dx, dx, dgain, dbias] if residual else [dx, dgain, dbias]
        # dx of the constant rows (1 / eps times the rest) apart
        errs = [errors(grads[0][:3], dx[:3]), errors(grads[0][3:], dx[3:])]
        errs += [errors(a, b) for a, b in zip(grads[1:], ref[1:])]
        err_b = (max(e[0] for e in errs), max(e[1] for e in errs))
        check_tol("coot_norm_bwd", "bfloat16", f"{what} {shape}", *err_b)
        if not all(torch.equal(a, b) for a, b in zip(grads, backward())):
            fail(f"coot_norm_bwd {what} {shape}: two backward calls on the "
                 "same inputs differ")
        del grads, ref, dx
        train_ms = time_ms(lambda: fused(*leaves), 20)
        bwd_ms = _bwd_ms(o, leaves, dout)
        bwd_split = kernel_ms(backward)
        o_plain = plain(*leaves)
        plain_train = time_ms(lambda: plain(*leaves), 5)
        plain_bwd = _bwd_ms(o_plain, leaves, dout)
        plain_bwd_split = kernel_ms(lambda: torch.autograd.grad(
            o_plain, leaves, dout, retain_graph=True), 5)
        n = rows * width
        # each element read once and written once, the row stats, gain
        # and bias; the backward's partial column sums left out (small)
        fwd_bytes = (2 * (2 if residual else 1) * n + 2 * n
                     + (2 * n if residual else 0) + 8 * rows + 8 * width)
        eval_bytes = 2 * (2 if residual else 1) * n + 2 * n + 8 * width
        bwd_bytes = 3 * 2 * n + 8 * rows + 4 * width + 8 * width
        bf_ms, by = bound_ms(fwd_bytes, 10.0 * n, "bfloat16")
        be_ms, _ = bound_ms(eval_bytes, 10.0 * n, "bfloat16")
        bb_ms, _ = bound_ms(bwd_bytes, 12.0 * n, "bfloat16")
        log(f"  coot_norm     {what:12s} {shape:30s} train {train_ms:.4f} ms"
            f" (bound {bf_ms:.4f}), eval {eval_ms:.4f} ms (bound "
            f"{be_ms:.4f}; device by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in eval_split.items())
            + f"), {by}-bound; plain {plain_train:.3f} ms train, "
            f"{plain_eval:.3f} ms eval")
        log(f"  coot_norm_bwd {what:12s} {shape:30s} autograd.grad "
            f"{bwd_ms:.4f} ms (bound {bb_ms:.4f}; device by kernel: "
            + ", ".join(f"{k} {v:.4f}" for k, v in bwd_split.items())
            + f"); plain (autograd of the unfused norm) {plain_bwd:.3f} ms, "
            f"device {sum(plain_bwd_split.values()):.3f} ms over "
            f"{len(plain_bwd_split)} kernel names")
        for name, e in (("coot_norm", err), ("coot_norm_bwd", err_b)):
            max_errors[name] = max(max_errors.get(name, 0.0), e[0])
        if what == "clips":
            for name, ms, plain_ms, nbytes, bms in (
                    ("coot_norm", train_ms, plain_train, fwd_bytes, bf_ms),
                    ("coot_norm_bwd", bwd_ms, plain_bwd, bwd_bytes, bb_ms)):
                out.append(dict(
                    name=name, shape=shape,
                    source="coot_videotext_tpu_torch/csrc/coot_norm.cu",
                    replaces="none: XLA fused CootLayerNorm on the TPU",
                    ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                    bound_by="bytes", product_ms=None))
        del y, r, gain, bias, dout, leaves, o, o_plain
        torch.cuda.empty_cache()
    return out


def phase_timing(launches, shapes, max_errors):
    """Kernel, plain version and library yardstick at the main path's
    largest call of each kernel (the video clips through the local net),
    forward and backward."""
    import torch
    import torch.nn.functional as F
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_backward_plain,
        masked_attention_plain)
    from coot_videotext_tpu_torch.ops.dropout import dropout, dropout_plain
    from coot_videotext_tpu_torch.ops.genpool import (
        genpool, genpool_backward_plain, genpool_plain)
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_backward_plain, fused_input_fc_plain)
    from coot_videotext_tpu_torch.typext import INF
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    # the largest local-net call: the packed clips (P of them)
    rows = shapes.get("pack_clips", shapes["b"] * shapes["n_parts"])
    lc, din, d, h, heads, dh = shapes["lc"], shapes["din"], 384, 768, 2, 48
    dho = d // heads
    entries = []

    def entry(name, shape, src, replaces, ms, plain_ms, library_ms,
              nbytes, flops):
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        entries.append(dict(
            name=name, shape=shape,
            source=f"coot_videotext_tpu_torch/csrc/{src}",
            replaces=f"coot_videotext_tpu/ops/{replaces}", ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
            bound_by=by, product_ms=None))

    # B1 at the four calls of a train step: the packed clips (the kernels
    # line), the video global net, the paragraph and the packed sentences
    b1_calls = (
        ("clips", rows * lc, din),
        ("video global", shapes["b"] * shapes["lv"], din),
        ("paragraph", shapes["b"] * shapes["lp"], shapes["dtext"]),
        ("sentences", shapes.get("pack_sents", shapes["b"]
                                 * shapes["n_parts"]) * shapes["ls"],
         shapes["dtext"]))
    for what, s, width in b1_calls:
        x, *params = input_fc_inputs(s, width, d, bf, gen)
        params = [p.float() for p in params]
        w_t = params[2].to(bf).t()
        shape = f"S={s} {width}->{d} bf16"
        with torch.inference_mode():
            check_tol("input_fc", "bfloat16", f"{what} {shape}", *errors(
                fused_input_fc(x, *params, 1e-6, "gelu"),
                fused_input_fc_plain(x, *params, 1e-6, "gelu")))
            fwd = time_ms(lambda: fused_input_fc(x, *params, 1e-6, "gelu"))
            plain = time_ms(lambda: fused_input_fc_plain(x, *params, 1e-6,
                                                         "gelu"))
            # yardstick, not a port of B1: the product alone
            product = time_ms(lambda: torch.matmul(x, w_t))
            fwd_split = kernel_ms(lambda: fused_input_fc(x, *params, 1e-6,
                                                         "gelu"))
        leaves = [p.clone().requires_grad_() for p in params]
        y = fused_input_fc(x, *leaves, 1e-6, "gelu")
        dy = torch.randn(s, d, generator=gen, device="cuda").to(bf)

        def backward():
            return torch.autograd.grad(y, leaves, dy, retain_graph=True)

        # at this call's row splits: each gradient against the plain one,
        # and a second call bit for bit
        grads = backward()
        ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu", dy)
        errs = [errors(a, r) for a, r in zip(grads, ref)]
        check_tol("input_fc_bwd", "bfloat16", f"{what} {shape}",
                  max(e[0] for e in errs), max(e[1] for e in errs))
        if not all(torch.equal(a, b) for a, b in zip(grads, backward())):
            fail(f"input_fc_bwd {what} {shape}: two backward calls on the "
                 "same inputs differ")
        del grads, ref
        bwd = _bwd_ms(y, leaves, dy)
        bwd_host = host_us_per_call(backward, 50)
        bwd_plain = time_ms(lambda: fused_input_fc_backward_plain(
            x, *params, 1e-6, "gelu", dy))
        bwd_split = kernel_ms(backward)
        # the backward's one product G = xhat^T dpre: (din x S)(S x dout)
        bwd_product = time_ms(lambda: torch.matmul(x.t(), dy))
        fwd_bytes = (2 * s * width + 8 * width + 2 * d * width + 4 * d
                     + 2 * s * d)
        bwd_bytes = (2 * s * width + 2 * s * d + 4 * s * d + 2 * width * d
                     + 8 * s + 4 * (width * d + d + 2 * width))
        flops = 2.0 * s * width * d
        for name, ms, plain_ms, prod, split, nbytes in (
                ("input_fc", fwd, plain, product, fwd_split, fwd_bytes),
                ("input_fc_bwd", bwd, bwd_plain, bwd_product, bwd_split,
                 bwd_bytes)):
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            log(f"  {name:13s} {what:12s} {shape:26s} kernel {ms:.4f} ms, "
                f"bound {bms:.4f} ({by}), plain {plain_ms:.3f}, product "
                f"alone (torch.matmul) {prod:.4f}; device by kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + (f"; host {bwd_host:.1f} us per autograd.grad call"
                   if name == "input_fc_bwd" else ""))
            if what == "clips":
                entry(name, shape, "input_fc.cu", "pallas_input_fc.py:"
                      + ("207" if name == "input_fc" else "284"), ms,
                      plain_ms, None, nbytes, flops)
                entries[-1]["product_ms"] = prod
        del x, params, leaves, y, dy, w_t
        torch.cuda.empty_cache()
    # B2 at the four calls of a train step (the clips in the kernels line)
    b2_calls = (("clips", rows, lc),
                ("video ctx", shapes["b"], shapes["lv"]),
                ("paragraph", shapes["b"], shapes["lp"]),
                ("sentences", shapes.get("pack_sents", shapes["b"]
                                         * shapes["n_parts"]), shapes["ls"]))
    rate, seed = 0.01, device_seed()
    weights = 2 * d * h + 2 * h * dho + 4 * (h + d)
    # B2 forward: held against its plain version and repeated bit for bit,
    # then timed with the stats (train) and without (eval), with the
    # profiler's device time of the tile pass and the pooling pass apart
    for what, s_, length in b2_calls:
        f, mask, *params = genpool_inputs(s_, length, d, h, heads, bf, gen)
        params = [p.float() for p in params]
        leaves = [p.clone().requires_grad_() for p in params]
        r = s_ * length
        shape = f"S={s_} L={length} D={d} H={h} bf16 drop {rate}"
        nbytes = 2 * r * d + r + weights + 2 * s_ * d
        flops = 2.0 * r * (d * h + h * dho)
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        with torch.inference_mode():
            plain_out = genpool_plain(f, mask, *params, "gelu", rate, seed)
        times = {}
        for mode, ps in (("train", leaves), ("eval", params)):
            def fwd():
                return genpool(f, mask, *ps, "gelu", rate, seed)

            with torch.inference_mode(mode == "eval"):
                out = fwd()
                check_tol("genpool", "bfloat16", f"{what} {mode} {shape}",
                          *errors(out, plain_out))
                if not torch.equal(out, fwd()):
                    fail(f"genpool {what} {mode} {shape}: two forward calls "
                         "on the same inputs differ")
                times[mode] = (time_ms(fwd), kernel_ms(fwd))
            del out
        with torch.inference_mode():
            plain = time_ms(lambda: genpool_plain(f, mask, *params, "gelu",
                                                  rate, seed), 3, 1)
        log(f"  genpool       {what:10s} {shape:36s} " + "; ".join(
            f"{mode} {ms:.4f} ms (device by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()) + ")"
            for mode, (ms, split) in times.items())
            + f"; bound {bms:.4f} ({by}), plain {plain:.3f} ms")
        if what == "clips":
            entry("genpool", shape, "genpool.cu", "pallas_genpool.py:284",
                  times["train"][0], plain, None, nbytes, flops)
        del f, mask, params, leaves, plain_out
        torch.cuda.empty_cache()
    # B2 backward at the same calls: held against its plain version and
    # repeated bit for bit, then through autograd, with the profiler's
    # device time of the tile pass (genpool_bwd_tiles), the weight-gradient
    # products (tn_mma<false>) and the split sums apart
    for what, s_, length in b2_calls:
        f, mask, *params = genpool_inputs(s_, length, d, h, heads, bf, gen)
        params = [p.float() for p in params]
        fl = f.clone().requires_grad_()
        leaves = [p.clone().requires_grad_() for p in params]
        y = genpool(fl, mask, *leaves, "gelu", rate, seed)
        dout = torch.randn(s_, d, generator=gen, device="cuda").to(bf)

        def backward():
            return torch.autograd.grad(y, [fl] + leaves, dout,
                                       retain_graph=True)

        shape = f"S={s_} L={length} D={d} H={h} bf16 drop {rate}"
        grads = backward()
        ref = genpool_backward_plain(f, mask, *params, "gelu", dout, rate,
                                     seed)
        errs = [errors(a, r_) for a, r_ in zip(grads, ref)]
        check_tol("genpool_bwd", "bfloat16", f"{what} {shape}",
                  max(e[0] for e in errs), max(e[1] for e in errs))
        if not all(torch.equal(a, b) for a, b in zip(grads, backward())):
            fail(f"genpool_bwd {what} {shape}: two backward calls on the "
                 "same inputs differ")
        del grads, ref
        bwd = _bwd_ms(y, [fl] + leaves, dout)
        bwd_plain = time_ms(lambda: genpool_backward_plain(
            f, mask, *params, "gelu", dout, rate, seed))
        split = kernel_ms(backward)
        r = s_ * length
        nbytes = (2 * r * d + r + weights + 2 * s_ * d + 12 * s_ * d
                  + 2 * r * d + 2 * weights)
        flops = 2.0 * r * (3 * d * h + 3 * h * dho)
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        log(f"  genpool_bwd   {what:10s} {shape:36s} autograd {bwd:.4f} ms, "
            f"bound {bms:.4f} ({by}), plain {bwd_plain:.3f} ms; "
            "device by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()))
        if what == "clips":
            entry("genpool_bwd", shape, "genpool.cu",
                  "pallas_genpool.py:358", bwd, bwd_plain, None, nbytes,
                  flops)
        del f, mask, params, fl, leaves, y, dout
        torch.cuda.empty_cache()
    # B3 forward at the six shapes of a train step (the clips in the
    # kernels line): held against its plain version and repeated bit for
    # bit, then timed with the stats (train) and without (eval) in turns
    # with SDPA (additive mask, the same dropout), with the profiler's
    # device time
    b3_calls = (("clips", rows, lc, lc),
                ("video ctx", shapes["b"], shapes["lv"], shapes["lv"]),
                ("paragraph", shapes["b"], shapes["lp"], shapes["lp"]),
                ("sentences", shapes.get("pack_sents", shapes["b"]
                                         * shapes["n_parts"]), shapes["ls"],
                 shapes["ls"]),
                ("global", shapes["b"], shapes["n_parts"],
                 shapes["n_parts"]),
                ("cross", shapes["b"], 1, shapes["n_parts"]))
    for what, b_, lq, lk in b3_calls:
        q, k, v, kv = attention_inputs(b_, 8, lq, lk, dh, bf, gen)
        n = b_ * 8
        add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        qkv = [q, k, v]
        leaves = [a.clone().requires_grad_() for a in qkv]
        shape = f"N={n} Lq={lq} Lk={lk} Dh={dh} bf16 drop {rate}"
        nbytes = 2 * n * (2 * lq + 2 * lk) * dh + b_ * lk
        flops = 4.0 * n * lq * lk * dh
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        with torch.inference_mode():
            plain_out = masked_attention_plain(q, k, v, kv, 8, dh ** -0.5,
                                               rate, seed)
        times = {}
        for mode, ts in (("train", leaves), ("eval", qkv)):
            def fwd():
                return masked_attention(*ts, kv, 8, dh ** -0.5, rate, seed)

            def sdpa():
                return F.scaled_dot_product_attention(
                    *ts, attn_mask=add_mask, dropout_p=rate,
                    scale=dh ** -0.5)

            with torch.inference_mode(mode == "eval"):
                out = fwd()
                check_tol("attention", "bfloat16", f"{what} {mode} {shape}",
                          *errors(out, plain_out))
                if not torch.equal(out, fwd()):
                    fail(f"attention {what} {mode} {shape}: two forward "
                         "calls on the same inputs differ")
                ms, lib = [], []
                for _ in range(2):  # kernel, SDPA, kernel, SDPA
                    ms.append(time_ms(fwd))
                    lib.append(time_ms(sdpa))
                times[mode] = (statistics.mean(ms), statistics.mean(lib),
                               device_ms_per_call(fwd, 20),
                               device_ms_per_call(sdpa, 20))
            del out
        with torch.inference_mode():
            plain = time_ms(lambda: masked_attention_plain(
                q, k, v, kv, 8, dh ** -0.5, rate, seed), 3, 1)
        log(f"  attention     {what:10s} {shape:36s} " + "; ".join(
            f"{mode} {t[0]:.4f} ms (device {t[2]:.4f}), SDPA {t[1]:.4f} "
            f"(device {t[3]:.4f})" for mode, t in times.items())
            + f"; bound {bms:.4f} ({by}), plain {plain:.3f} ms")
        if what == "clips":
            entry("attention", shape, "attention.cu",
                  "pallas_attention.py:114", times["train"][0], plain,
                  times["train"][1], nbytes, flops)
        del q, k, v, kv, add_mask, qkv, leaves, plain_out
        torch.cuda.empty_cache()
    # B3 backward at the clips (the kernels line), the video context, the
    # paragraph local net's call (L = lp, 320: more than one key block,
    # so the D pass runs) and the sentences: through autograd in turns with
    # SDPA's backward, and the profiler's device time per backward call
    for what, b_, length in (
            ("clips", rows, lc),
            ("video ctx", shapes["b"], shapes["lv"]),
            ("paragraph", shapes["b"], shapes["lp"]),
            ("sentences", shapes.get("pack_sents", shapes["b"]
                                     * shapes["n_parts"]), shapes["ls"])):
        q, k, v, kv = attention_inputs(b_, 8, length, length, dh, bf, gen)
        n_ = b_ * 8
        add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        y = masked_attention(*qkv, kv, 8, dh ** -0.5, rate, seed)
        g = torch.randn(n_, length, dh, generator=gen, device="cuda").to(bf)
        qkv_lib = [a.clone().requires_grad_() for a in (q, k, v)]
        y_lib = F.scaled_dot_product_attention(
            *qkv_lib, attn_mask=add_mask, dropout_p=rate, scale=dh ** -0.5)
        ms, lib, rounds, lib_rounds = paired_bwd_ms((y, qkv, g),
                                                    (y_lib, qkv_lib, g))
        dev = device_ms_per_call(lambda: torch.autograd.grad(
            y, qkv, g, retain_graph=True), 10)
        dev_lib = device_ms_per_call(lambda: torch.autograd.grad(
            y_lib, qkv_lib, g, retain_graph=True), 10)
        plain = time_ms(lambda: masked_attention_backward_plain(
            q, k, v, kv, g, 8, dh ** -0.5, rate, seed))
        nbytes = 2 * 8 * n_ * length * dh + b_ * length + 8 * n_ * length
        flops = 10.0 * n_ * length * length * dh
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        log(f"  attention_bwd {what} N={n_} L={length} Dh={dh} bf16 drop "
            f"{rate}: autograd.grad {ms:.4f} ms (rounds "
            f"{', '.join(f'{t:.4f}' for t in rounds)}), device "
            f"{dev:.4f} ms per call; SDPA backward {lib:.4f} ms (rounds "
            f"{', '.join(f'{t:.4f}' for t in lib_rounds)}), device "
            f"{dev_lib:.4f} ms per call; plain {plain:.3f} ms; bound "
            f"{bms:.4f} ms ({by})")
        if what == "clips":
            entry("attention_bwd", f"N={n_} L={length} Dh={dh} bf16 drop "
                  f"{rate}", "attention.cu", "pallas_attention.py:158", ms,
                  plain, lib, nbytes, flops)
        del q, k, v, qkv, qkv_lib, y, y_lib, g, add_mask
    # B4: the FFN / sublayer activations of the video clips
    x = torch.randn(rows * lc, d, generator=gen, device="cuda").to(bf)
    numel = x.numel()
    with torch.inference_mode():
        fwd = time_ms(lambda: dropout(x, seed, 0.01))
        plain = time_ms(lambda: dropout_plain(x, seed, 0.01))
        lib = time_ms(lambda: F.dropout(x, 0.01, training=True))
    entry("dropout", f"{rows * lc}x{d} bf16 rate 0.01", "dropout.cu",
          "pallas_dropout.py:98", fwd, plain, lib, 4 * numel, 1.0 * numel)
    xl = x.clone().requires_grad_()
    y = dropout(xl, seed, 0.01)
    xl_lib = x.clone().requires_grad_()
    y_lib = F.dropout(xl_lib, 0.01, training=True)
    ms, lib, rounds, lib_rounds = paired_bwd_ms((y, [xl], x),
                                                (y_lib, [xl_lib], x), 9)
    log(f"  dropout_bwd through autograd.grad, 9 rounds in turns: ours "
        f"median {ms:.4f} min {min(rounds):.4f} ms ("
        f"{', '.join(f'{t:.4f}' for t in rounds)}), F.dropout median "
        f"{lib:.4f} min {min(lib_rounds):.4f} ms ("
        f"{', '.join(f'{t:.4f}' for t in lib_rounds)})")
    entry("dropout_bwd", f"{rows * lc}x{d} bf16 rate 0.01", "dropout.cu",
          "pallas_dropout.py:121", ms,
          time_ms(lambda: dropout_plain(x, seed, 0.01)), lib, 4 * numel,
          1.0 * numel)
    dropout_host_device(x, seed, fwd, entries[-1]["ms"],
                        entries[-1]["library_ms"])
    del x, xl, xl_lib, y, y_lib
    torch.cuda.empty_cache()
    # B5: the store gathers of one step (a store of the 256-video train
    # split's size), without and with the fused noise
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.ops.gather import (
        GatherNoise, gather_rows, gather_rows_plain)
    calls = (("video", shapes["b"] * shapes["lv"], din),
             ("clips", rows * lc, din),
             ("paragraphs", shapes["b"] * shapes["lp"], shapes["dtext"]))
    for what, n, width in calls:
        table = torch.randn(82000, width, generator=gen,
                            device="cuda").to(bf)
        idx = torch.randint(0, 82000, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        nbytes = 2 * 2 * n * width + 4 * n
        with torch.inference_mode():
            lib = time_ms(lambda: torch.index_select(table, 0, idx))
            for noise in (None, GatherNoise(0.01, seed,
                                            philox.SITE_NOISE_CLIP)):
                tag = f"{what} {n}x{width} bf16" + (
                    " noise 0.01" if noise else "")
                if not torch.equal(gather_rows(table, idx, noise),
                                   gather_rows_plain(table, idx, noise)):
                    fail(f"gather {tag}: kernel and plain differ")
                ms = time_ms(lambda: gather_rows(table, idx, noise))
                plain = time_ms(lambda: gather_rows_plain(table, idx, noise))
                bms, by = bound_ms(nbytes, 0.0, "bfloat16")
                log(f"  gather        {tag:38s} kernel {ms:.4f} ms, plain "
                    f"{plain:.3f} ms, library {lib:.4f} ms (index_select), "
                    f"bound {bms:.4f} ms ({by})")
                if what == "clips" and noise is None:
                    entry("gather", tag, "gather.cu", "pallas_gather.py:64",
                          ms, plain, lib, nbytes, 0.0)
        del table, idx
        torch.cuda.empty_cache()
    entries += norm_timing(shapes, gen, max_errors)
    for e in entries:
        e["route"] = "cuda"
        e["launches"] = int(launches.get(e["name"], 0))
        e["max_abs_err"] = max_errors[e["name"]]
        lib = ("-" if e["library_ms"] is None
               else f"{e['library_ms']:.3f} ms")
        log(f"  {e['name']:13s} {e['shape']:38s} kernel {e['ms']:.3f} ms, "
            f"plain {e['plain_ms']:.3f} ms, library {lib}, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    # product_ms (B1 only): torch.matmul of B1's product alone, a yardstick
    # (no single PyTorch call computes B1, and the port never calls it)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "product_ms")
    return [{k: e[k] for k in keys} for e in entries]


# ---------- phase 10: the prefetch pipeline and the tail ----------

# the equality check: this many batches of 16 of each loader
EQUAL_BATCH, EQUAL_BATCHES = 16, 1
# the traced dense run and the slab run: one train step and one val batch
SHORT_VIDEOS = 64
# 10a's host dense CLI: 1 train step of 64 (tools/host_path.py's own
# runs, which parent and change are compared on, train 5)
HOST_VIDEOS = 64
# S3D at the extractor's defaults: windows of 32 frames every 16 of 256 x
# 256 (extract_frames_from_videos.py:112-113), batches of 16: a video of
# 256 frames is 16 windows, one batch
S3D_KERNEL, S3D_STRIDE, S3D_BATCH, S3D_SIZE, S3D_FRAMES = 32, 16, 16, 256, 256
S3D_VIDEOS = 2


def _equal_to_sequential(data: Path, layout: str) -> int:
    """Two loaders from one seed on the card, batches of EQUAL_BATCH: the
    first EQUAL_BATCHES train batches (host frame noise drawn in the
    producer) and val batches through `prefetch` against `to_device`,
    torch.equal on the card. Returns the tensors compared."""
    import torch
    from coot_videotext_tpu_torch.data.pipeline import prefetch
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        HOST_KEYS, create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tools.host_path import host_config
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cuda = torch.device("cuda")
    cfg_file = host_config(ROOT, data.parent / f"equal_{layout}", layout,
                           -1)
    loaders = []
    for _ in range(2):
        cfg = load_yaml_config_file(cfg_file)
        cfg["train"]["batch_size"] = cfg["val"]["batch_size"] = EQUAL_BATCH
        _, _, train, val = create_retrieval_datasets_and_loaders(
            RetrievalConfig(cfg), data, seed=0, device=cuda)
        if train.layout != layout:
            fail(f"equality check: {train.layout} batches, not {layout}")
        loaders.append((train, val))
    compared = 0
    for which in (0, 1):
        ours = prefetch(loaders[0][which], cuda)
        theirs = iter(loaders[1][which])
        for _ in range(EQUAL_BATCHES):
            tensors, host = next(ours)
            want = to_device(next(theirs), cuda)
            got = {**host, **tensors}
            if set(got) != set(want):
                fail(f"{layout}: prefetched keys {sorted(got)}")
            for key, value in want.items():
                if key in HOST_KEYS:
                    same = got[key] == value
                else:
                    same = (got[key].is_cuda and
                            torch.equal(got[key], value))
                if not same:
                    fail(f"{layout}: prefetched {key} differs from the "
                         "sequential copy")
                compared += 1
        ours.close()
    torch.cuda.synchronize()
    return compared


def phase_host_prefetch(tmp: Path) -> None:
    """10a: the host dense and slab paths behind the prefetch pipeline at
    yc2_2d3d_coot width."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tools import host_path

    data = tmp / "data"
    made = _take_data("host", data)
    log(f"a yc2-like split ({HOST_VIDEOS} train, {host_path.VAL_VIDEOS} val "
        f"videos): {made}")
    for layout in ("dense", "slab"):
        n = _equal_to_sequential(data, layout)
        log(f"  {layout}: {EQUAL_BATCHES} train and {EQUAL_BATCHES} val "
            f"batches of {EQUAL_BATCH} through prefetch equal to_device's "
            f"on the card ({n} fields, torch.equal)")
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.time()
    record = host_path.measure(ROOT, data, "dense", HOST_VIDEOS,
                               host_path.VAL_VIDEOS, SHORT_VIDEOS,
                               tmp / "dense")
    launches = dict(cuda_build.launch_counts)
    log(f"  host dense CLI ({time.time() - t0:.1f} s, timed and traced "
        f"runs): {json.dumps(record)}")
    log(f"  launches {launches}")
    if record["layout"] != "dense" or record["steps"] != \
            HOST_VIDEOS // 64 or not np.isfinite(record["step_ms"]):
        fail(f"host dense CLI: {record}")
    for name in ("input_fc", "input_fc_bwd", "genpool", "genpool_bwd",
                 "attention", "attention_bwd", "dropout", "dropout_bwd"):
        if launches.get(name, 0) <= 0:
            fail(f"host dense CLI: kernel {name} was not launched")
    if launches.get("gather", 0):
        fail("host dense CLI launched B5")
    if not record["copy_ms"] > 0 or set(record["copy_streams"]) & set(
            record["kernel_streams"]):
        fail("the host-to-device copies are not on a stream of their own: "
             f"{record}")
    log(f"  host dense: {record['train_videos_per_s']:.2f} train videos/s, "
        f"{record['val_videos_per_s']:.2f} val videos/s; step "
        f"{record['step_ms']:.1f} ms, {record['step_other_share']:.1%} of it "
        f"outside the step; traced copies {record['copy_ms']:.2f} ms on "
        f"streams {record['copy_streams']}, "
        f"{record['copy_overlapped_ms']:.2f} ms of them under a kernel")
    cuda_build.reset_launch_counts()
    slab = host_path.train_once(
        host_path.host_config(ROOT, tmp / "slab", "slab", SHORT_VIDEOS),
        data, tmp / "slab" / "experiments")
    launches = dict(cuda_build.launch_counts)
    if slab["layout"] != "slab" or slab["steps"] != 1 or \
            launches.get("gather", 0) <= 0:
        fail(f"host slab CLI: {slab}, launches {launches}")
    log(f"  host slab CLI: {SHORT_VIDEOS / slab['train_s']:.2f} train "
        "videos/s, "
        f"{host_path.VAL_VIDEOS / slab['val_s']:.2f} val videos/s; step "
        f"{slab['step_ms']:.1f} ms, {slab['step_other_share']:.1%} outside "
        f"the step; launches {launches}")
    torch.cuda.empty_cache()


def _s3d_flops(model, batch) -> float:
    """Operations of one forward (2 per multiply-add of every convolution
    and linear), counted from the shapes by forward hooks."""
    import torch
    from coot_videotext_tpu_torch.models import s3d
    total = [0]

    def hook(mod, _inp, out):
        w = mod.weight
        total[0] += 2 * out.numel() * (w[0].numel() if w.dim() == 5
                                       else w.shape[1])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (s3d.Conv3d, s3d.Linear))]
    with torch.no_grad():
        model(batch)
    for h in handles:
        h.remove()
    return float(total[0])


def _s3d_frames(seed: int):
    """One video's frames, uint8 (S3D_FRAMES, 256, 256, 3): smooth
    gradients plus noise, so that the jpgs are not pure noise."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(S3D_FRAMES)[:, None, None, None]
    y = np.arange(S3D_SIZE)[None, :, None, None]
    x = np.arange(S3D_SIZE)[None, None, :, None]
    base = (128 + 60 * np.sin(0.05 * (x + 2 * t) + rng.rand(1, 1, 1, 3) * 6)
            + 40 * np.cos(0.03 * y + rng.rand(1, 1, 1, 3) * 6))
    noise = rng.randint(-20, 21, (S3D_FRAMES, S3D_SIZE, S3D_SIZE, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def phase_s3d(tmp: Path) -> None:
    """10b: S3D at full width through the extractor, float32 and
    bfloat16."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import extract_100m_features as tool
    from coot_videotext_tpu_torch.ops import cuda_build

    try:
        from PIL import Image
    except ImportError:
        Image = None
    videos = {f"video{i}": _s3d_frames(i) for i in range(S3D_VIDEOS)}
    frames_dir = tmp / "frames"
    if Image is not None:
        for key, frames in videos.items():
            (frames_dir / key).mkdir(parents=True)
            for i, frame in enumerate(frames):
                Image.fromarray(frame).save(
                    frames_dir / key / f"frame_{i + 1:010d}.jpg")
        log(f"  the extractor's CLI on {S3D_VIDEOS} videos of {S3D_FRAMES} "
            f"jpg frames of {S3D_SIZE} x {S3D_SIZE} (PIL is installed)")
    else:
        log("  PIL is missing: extract_video on the frames arrays, not the "
            "CLI")
    windows = len(tool.video_windows(videos["video0"], S3D_KERNEL,
                                     S3D_STRIDE))
    if windows != S3D_BATCH:
        fail(f"S3D: {windows} windows a video, expected {S3D_BATCH}")
    loaders = {}
    for bf16 in (False, True):
        dn = "bfloat16" if bf16 else "float32"
        cuda_build.reset_launch_counts()
        t0 = time.time()
        if Image is not None:
            out = tmp / f"features_{dn}"
            flags = [str(frames_dir), str(out), "--kernel", str(S3D_KERNEL),
                     "--stride", str(S3D_STRIDE), "--batch_size",
                     str(S3D_BATCH), "--output_format", "npy",
                     "--checkpoint", str(tmp / "no_checkpoint.pth"),
                     "--layer", "video_embedding,mixed_5c"]
            result = tool.main(flags + (["--bf16"] if bf16 else []))
            if result["device"].type != "cuda" or \
                    sorted(result["written"]) != sorted(videos):
                fail(f"S3D CLI ({dn}): {result}")
            feats = {k: np.load(out / f"{k}.npy") for k in videos}
        else:
            model = tool.build_model(None, bf16=bf16,
                                     device=torch.device("cuda"))
            feats = {k: tool.extract_video(
                model, v.astype(np.float32) / 255.0, kernel=S3D_KERNEL,
                stride=S3D_STRIDE, batch_size=S3D_BATCH,
                layers=("video_embedding", "mixed_5c"),
                device=torch.device("cuda")) for k, v in videos.items()}
        wall = time.time() - t0
        launches = dict(cuda_build.launch_counts)
        if any(launches.values()):
            fail(f"S3D launched the port's kernels: {launches}")
        for k, f in feats.items():
            if f.shape != (S3D_BATCH, 512 + 1024) or not \
                    np.isfinite(f).all():
                fail(f"S3D features of {k} ({dn}): {f.shape}")
        loaders[dn] = feats
        log(f"  {dn}: {S3D_VIDEOS} videos -> {S3D_VIDEOS} x "
            f"{S3D_BATCH} windows of (512 + 1024) features in {wall:.1f} s "
            "(jpg reads included); no port kernel launched")
    cos = min(float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))
              for k in videos
              for a, b in [(loaders["float32"][k], loaders["bfloat16"][k])])
    log(f"  bfloat16 against float32 features: cosine {cos:.5f}")
    if not cos >= MIN_COSINE:
        fail(f"S3D bf16 against f32 features: cosine {cos}")

    cuda = torch.device("cuda")
    frames = videos["video0"].astype(np.float32) / 255.0
    wins = tool.video_windows(frames, S3D_KERNEL, S3D_STRIDE)
    batch = torch.from_numpy(np.stack(wins)).to(cuda).permute(0, 4, 1, 2, 3)
    one = batch[:1].contiguous()
    for bf16 in (False, True):
        dn = "bfloat16" if bf16 else "float32"
        model = tool.build_model(None, bf16=bf16, device=cuda)
        cpu = tool.build_model(None, bf16=bf16,
                               device=torch.device("cpu"))
        with torch.no_grad():
            ref = cpu(one.cpu())
            out = model(one)
        for name in ("video_embedding", "mixed_5c"):
            a, b = out[name].float().cpu(), ref[name].float()
            err = float((a - b).abs().max())
            rel = err / float(b.abs().max())
            cosine = float(torch.nn.functional.cosine_similarity(
                a.flatten(), b.flatten(), dim=0))
            log(f"  {dn} one window, card against CPU, {name}: max abs err "
                f"{err:.3e}, relative to max|CPU| {rel:.3e}, cosine "
                f"{cosine:.6f}")
            if (not bf16 and not rel <= TOL["float32"]) or \
                    (bf16 and not cosine >= MIN_COSINE):
                fail(f"S3D {dn} card against CPU ({name}): relative "
                     f"{rel}, cosine {cosine}")
        flops = _s3d_flops(model, one)

        def forward():
            with torch.no_grad():
                model(batch)

        forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = time_ms(forward, iters=5, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        wall_ms, busy_ms, kernels, events = _busy_ms(
            forward, require_complete=True)
        ours = [e.key for e in events if "coot::" in e.key]
        if ours:
            fail(f"S3D ran the port's kernels: {ours}")
        rate = flops * S3D_BATCH / (ms / 1e3)
        log(f"  {dn} S3D, batch {S3D_BATCH} x {S3D_KERNEL} x {S3D_SIZE} x "
            f"{S3D_SIZE}: {ms:.2f} ms a batch (CUDA events, 5 batches), "
            f"{S3D_BATCH / ms * 1e3:.1f} windows/s; {flops / 1e9:.2f} GFLOP "
            f"a window (from the conv and linear shapes), "
            f"{rate / 1e12:.2f} TFLOP/s, {rate / PEAK_FLOPS[dn]:.1%} of the "
            f"card's {PEAK_FLOPS[dn] / 1e12:.0f} TFLOP/s {dn} peak; traced "
            f"batch {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
            f"({busy_ms / wall_ms:.1%}), {kernels} kernels; peak "
            f"{peak:.2f} GB above the {held / 1e9:.2f} GB held")
        log_families(events, 1)
        if bf16:  # the layout build_model chose against NCDHW weights
            model = model.to(memory_format=torch.contiguous_format)
            ncdhw = time_ms(forward, iters=5, warmup=1)
            log(f"  bfloat16 with NCDHW weights: {ncdhw:.2f} ms a batch "
                f"against {ms:.2f} with channels-last-3d weights")
        del model, cpu
        torch.cuda.empty_cache()


def phase_mlp(tmp: Path) -> None:
    """10c: the MLP example trained, resumed and reloaded on the card."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import run_mlp_mnist
    from coot_videotext_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    argv = ["-g", "default", "-e", "mnist", "--log_dir",
            str(tmp / "experiments"), "--config_dir", str(ROOT / "config")]
    t0 = time.time()
    first = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=2"])[0]
    resumed = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=3"])[0]
    val = run_mlp_mnist.main(argv + ["--validate", "--load_epoch", "2"])[0]
    wall = time.time() - t0
    if any(r["device"].type != "cuda" for r in (first, resumed, val)):
        fail("the MLP example did not run on the card")
    if resumed["state"]["current_epoch"] != 3 or \
            len(resumed["val_loss"]) != 3 or \
            not resumed["val_accuracy"][-1] > 0.5:
        fail(f"the MLP example: {resumed}")
    if not np.isclose(val["val_loss"], resumed["val_loss"][2], rtol=1e-6,
                      atol=0):
        fail(f"the reloaded MLP gives val loss {val['val_loss']}, training "
             f"gave {resumed['val_loss'][2]}")
    if any(cuda_build.launch_counts.values()):
        fail(f"the MLP example launched {dict(cuda_build.launch_counts)}")
    log(f"  trained 2 epochs, resumed to 3, reloaded epoch 2 on the card in "
        f"{wall:.1f} s: val accuracy {resumed['val_accuracy']}, val loss "
        f"{resumed['val_loss'][2]:.6f} (reloaded {val['val_loss']:.6f})")
    torch.cuda.empty_cache()


def phase_profiling(tmp: Path) -> None:
    """10d: the profiling utilities on the card."""
    import torch
    from coot_videotext_tpu_torch.utils import profiling

    before = profiling.profile_device_and_ram()
    block = torch.empty(2 * 1024 ** 3, dtype=torch.uint8, device="cuda")
    after = profiling.profile_device_and_ram(torch.device("cuda"))
    del block
    grew = after["device_mem_used"] - before["device_mem_used"]
    log(f"  profile_device_and_ram: {json.dumps(after)}; a 2 GiB block "
        f"adds {grew:.3f} GB")
    if abs(grew - 2.0) > 0.01 or not 70 < after["device_mem_limit"] < 100 \
            or not after["ram_total"] > 0:
        fail(f"profile_device_and_ram on the card: {before} -> {after}")
    x = torch.randn(4096, 4096, device="cuda")
    for attempt in range(3):
        torch.cuda.synchronize()
        with profiling.trace(tmp / "profiles") as prof:
            for _ in range(20):
                x = torch.tanh(x @ x / 64.0)
            x.sum().item()
        trace = json.loads(prof.trace_file.read_text())["traceEvents"]
        warm = next(e for e in trace
                    if e.get("name") == profiling.WARMUP_RANGE
                    and e.get("cat") == "user_annotation")
        kernels = [e for e in trace if e.get("cat") == "kernel" and
                   profiling.WARMUP_KERNEL not in e.get("name", "")]
        launches = {e["args"].get("correlation"): e["ts"] for e in trace
                    if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")
                    and not warm["ts"] <= e["ts"] <= warm["ts"] + warm["dur"]}
        # the first kernel starts some microseconds after its launch; where
        # the trace lost the first kernels, the first it holds starts later
        lag = [e["ts"] - launches[e["args"].get("correlation")]
               for e in kernels if e["args"].get("correlation") in launches]
        log(f"  trace(): {prof.trace_file.name}, {len(trace)} events, "
            f"{len(launches)} kernel launches traced on the host after "
            f"{profiling.TRACE_WARMUP_LAUNCHES} warm-up launches, "
            f"{len(kernels)} kernels on the card; the first kernel's start "
            f"{min(lag, default=float('nan')) / 1e3:.3f} ms after its "
            f"launch, {time.time() - STARTED:.0f} s into the process")
        if len(launches) >= 40 and len(kernels) >= len(launches):
            return
    fail(f"three traces lost kernels: the last holds {len(kernels)} kernels "
         f"on the card for {len(launches)} launches")


# ---------------- phase 11: data parallelism ----------------

DP_TRAIN_VIDEOS, DP_VAL_VIDEOS = 128, 64  # 2 global batches of 64 a epoch
DP_STEPS = 3
DP_LR = 1e-3
DP_LOSS_RTOL = 1e-4          # loss and grad_norm, W = 2 against W = 1
DP_UPDATE_TOL = 0.05         # parameters: a share of lr a step (phase 7's)
DP_MASK_RATE = 0.01
DP_CAPTION_SHAPE = (4, 16)   # MART: S sentence steps, N videos (global)


def _dp_cfg(tmp: Path, *, dropout: Optional[float], dtype: str):
    """yc2_2d3d_coot.yaml with npy features (phase 4's _config) at
    `dropout` on every site (None: the yaml's) and the frame noise off
    where dropout is 0; float32 or the yaml's bfloat16."""
    import yaml
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    path = _config(tmp)
    raw = load_yaml_config_file(path)
    if dropout is not None:
        for net in ("net_video_local", "net_video_global", "net_text_local",
                    "net_text_global"):
            for group in ("selfatn_config", "crossatn_config",
                          "pooler_config"):
                if isinstance(raw[net].get(group), dict) and \
                        "dropout" in raw[net][group]:
                    raw[net][group]["dropout"] = dropout
        if not dropout:
            raw["dataset_train"]["frames_noise"] = 0
            raw["dataset_train"]["words_noise"] = 0
    if dtype == "float32":
        raw["fp16_train"] = raw["fp16_val"] = False
    path.write_text(yaml.safe_dump(raw, sort_keys=False), encoding="utf8")
    return path, RetrievalConfig(load_yaml_config_file(path))


def _dp_retrieval(cfg, data: Path, mesh):
    """(train state from seed 0, id batches, step kwargs) of `cfg` on the
    device store with device sampling, the batches the rank's rows of
    each global batch under `mesh`."""
    import torch
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders)
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import TrainState
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    device = mesh.device if mesh is not None else torch.device("cuda")
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, data, seed=0, device=device, fixed_shapes=True,
        device_preload=True, mesh=mesh)
    if loader.layout != "ids":
        fail(f"phase 11: the loader gives {loader.layout} batches, not ids")
    mgr = RetrievalModelManager(cfg, device, seed=0)
    pmesh.broadcast_params(mesh, mgr.model.parameters())
    state = TrainState(mgr.model, make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0, device), mesh=mesh)
    kw = dict(lr=DP_LR, clip_gradient=1.0,
              source=FeatureSource.of(loader, cfg.dataset_train.frames_noise,
                                      cfg.dataset_train.words_noise),
              loss_cycle_cons=cfg.train.loss_cycle_cons,
              loss_weights=cfg.train.contrastive_loss_config.as_dict(),
              margin=cfg.train.contrastive_loss_config.margin,
              compute_dtype=mgr.train_dtype)
    return state, list(loader), kw


def _dp_train(state, batches, kw, group: bool) -> dict:
    """DP_STEPS per-step train steps on batches 0, 1, 0 (and with `group` a
    group of 4 on 0, 1, 0, 1): the losses, grad_norms and parameters."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.data.retrieval_dataset import to_device
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        retrieval_train_group, retrieval_train_step)
    device = state.seed.device
    out = {"loss": [], "grad_norm": []}
    for i in range(DP_STEPS):
        m = retrieval_train_step(state, to_device(batches[i % 2], device),
                                 **kw)
        out["loss"].append(m["loss_total"].float().reshape(1))
        out["grad_norm"].append(m["grad_norm"].float().reshape(1))
    if group:
        order = [batches[i % 2] for i in range(4)]
        m = retrieval_train_group(
            state, np.stack([b["dp_idx"] for b in order]),
            np.stack([b["batch_valid"] for b in order]), 4, **kw)
        out["loss"].append(m["loss_total"].float().clone())
        out["grad_norm"].append(m["grad_norm"].float().clone())
    torch.cuda.synchronize(device)
    return {"loss": torch.cat(out["loss"]).cpu(),
            "grad_norm": torch.cat(out["grad_norm"]).cpu(),
            "params": {n: p.detach().cpu().clone()
                       for n, p in state.optimizer.params.items()}}


def _first_dropout_mask(model, run):
    """Runs `run()` with a forward hook on every Dropout module of `model`:
    where the first dropout call at a rate in (0, 1) (kernel B4) zeroed a
    nonzero input, a bool tensor on the CPU."""
    from coot_videotext_tpu_torch.models.layers import Dropout
    seen = []

    def hook(module, inputs, output):
        if module.training and 0 < module.rate < 1 and not seen:
            seen.append(((inputs[0] != 0) & (output == 0)).cpu())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Dropout)]
    try:
        run()
    finally:
        for handle in handles:
            handle.remove()
    if not seen:
        fail("phase 11: no dropout call at a rate in (0, 1) in the step")
    return seen[0]


def _dp_caption_build(device, vocab: int):
    """MART at yc2_2d3d_coot_vidclip_mart.yaml width from seed 1 (GloVe
    applied), every dropout rate 0."""
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    config = load_yaml_config_file(CAPTION_CONFIG)
    config.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  memory_dropout_prob=0.0)
    return build_mart_model_manager(MartConfig(config), vocab, device,
                                    seed=1,
                                    cache_dir=str(ROOT / "cache_caption"))


def _dp_caption_inputs(cfg, vocab: int) -> dict:
    """A stacked MART batch (S, N, L) from seed 0: padded video and text
    slots, about a third of the labels IGNORE."""
    import numpy as np
    s, n = DP_CAPTION_SHAPE
    rng = np.random.RandomState(0)
    length = cfg.max_v_len + cfg.max_t_len
    ids = rng.randint(7, vocab, (s, n, length)).astype(np.int64)
    mask = (np.arange(length)[None, None, :]
            < rng.randint(cfg.max_v_len // 2, length, (s, n, 1)))
    labels = np.where(rng.rand(s, n, length) < 0.3, -1,
                      rng.randint(0, vocab, (s, n, length)))
    labels[:, :, :cfg.max_v_len] = -1
    labels = np.where(mask, labels, -1)
    ttys = np.concatenate([np.zeros((s, n, cfg.max_v_len)),
                           np.ones((s, n, cfg.max_t_len))], -1)
    return {"input_ids": ids,
            "video_feature": rng.randn(s, n, length, cfg.video_feature_size
                                       ).astype(np.float32),
            "input_mask": mask.astype(np.float32),
            "token_type_ids": ttys.astype(np.int64),
            "input_labels": labels.astype(np.int64)}


def _dp_caption_train(mgr, arrays: dict, mesh) -> dict:
    """DP_STEPS MART train steps at CAPTION_TRAIN_LR on `arrays` (the
    rank's rows along N under `mesh`): the metrics of each step, the
    parameters and the EMA after them."""
    import torch
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, init_caption_train_state)
    device = next(mgr.model.parameters()).device
    state = init_caption_train_state(mgr.model, mgr.cfg, 0, mesh)
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    metrics = [{k: float(v) for k, v in caption_train_step(
        state, batch, CAPTION_TRAIN_LR).items()} for _ in range(DP_STEPS)]
    return {"metrics": metrics, **_state_copy(state)}


def _dp_rank(rank: int, world: int, init_file: str, spec_file: str,
             out_dir: str) -> None:
    """Phase 11b/11c, rank `rank` of `world` on the one card over gloo:
    the retrieval steps at dropout 0 (float32), steps at dropout 0.01 with
    the launch counts set to 0 just before and read just after and the
    first B4 mask of the first step, and the MART steps; saves
    out_dir/rank<rank>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        spec = torch.load(spec_file, weights_only=False)
        mesh = pmesh.get_mesh({"data": world}, device=torch.device("cuda", 0))
        out = {"rank": rank, "backend": mesh.backend}
        t0 = time.time()
        cfg, cfg_drop = (RetrievalConfig(load_yaml_config_file(spec[k]))
                         for k in ("cfg", "cfg_drop"))
        state, batches, kw = _dp_retrieval(cfg, spec["data"], mesh)
        out["local_batch"] = len(batches[0]["dp_idx"])
        out["retrieval"] = _dp_train(state, batches, kw, group=True)
        out["retrieval_s"] = time.time() - t0
        del state
        state, batches, kw = _dp_retrieval(cfg_drop, spec["data"], mesh)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        out["mask"] = _first_dropout_mask(state.model, lambda: _dp_train(
            state, batches[:1] * 2, dict(kw), group=False))
        out["launches"] = dict(cuda_build.launch_counts)
        del state
        t0 = time.time()
        mgr = _dp_caption_build(torch.device("cuda", 0), spec["vocab"])
        local = DP_CAPTION_SHAPE[1] // world
        rows = slice(rank * local, (rank + 1) * local)
        out["caption"] = _dp_caption_train(
            mgr, {k: v[:, rows].copy() for k, v in spec["caption"].items()},
            mesh)
        out["caption_s"] = time.time() - t0
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _nccl_probe(rank: int, init_file: str, out_dir: str) -> None:
    """Two ranks on the one card over NCCL: one all-reduce; what NCCL
    says goes to out_dir/nccl<rank>.txt."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    said = Path(out_dir) / f"nccl{rank}.txt"
    said.write_text("started; no answer (the process ended first)",
                    encoding="utf8")
    text = "all-reduce completed"
    try:
        dist.init_process_group("nccl", init_method=f"file://{init_file}",
                                rank=rank, world_size=2)
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        text += f": {x.tolist()}"
    except Exception as exc:  # the refusal is what this probe records
        text = f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"
    said.write_text(text, encoding="utf8")
    if dist.is_initialized():
        dist.destroy_process_group()


def _hold_dp(tag: str, ref: dict, ranks: list) -> None:
    """W ranks' retrieval runs against W = 1: loss and grad_norm within
    DP_LOSS_RTOL relative, the parameters within DP_UPDATE_TOL of lr a
    step, and every rank's parameters equal to rank 0's."""
    steps = len(ref["loss"])
    for rank in ranks:
        got = rank["retrieval"]
        rel = {k: float(((got[k] - ref[k]).abs() / ref[k].abs()).max())
               for k in ("loss", "grad_norm")}
        share = _max_diff(got["params"], ref["params"]) / DP_LR / steps
        log(f"  rank {rank['rank']}: {steps} steps, loss relative "
            f"{rel['loss']:.2e}, grad_norm {rel['grad_norm']:.2e} (limit "
            f"{DP_LOSS_RTOL}); parameters {share:.2%} of lr a step (limit "
            f"{DP_UPDATE_TOL:.0%})")
        if max(rel.values()) > DP_LOSS_RTOL or share > DP_UPDATE_TOL:
            fail(f"{tag}: rank {rank['rank']} disagrees with W = 1")
        if _max_diff(got["params"], ranks[0]["retrieval"]["params"]) != 0:
            fail(f"{tag}: rank {rank['rank']}'s parameters differ from rank "
                 "0's")


def _file_layout(base: Path) -> set:
    """The files of an experiment directory, relative, with the log files'
    timestamps masked."""
    out = set()
    for path in base.rglob("*"):
        if path.is_file():
            rel = path.relative_to(base)
            if rel.parts[0] == "logs":
                rel = Path("logs") / "run_<time>.log"
            out.add(str(rel))
    return out


def phase_dp(tmp: Path) -> dict:
    """Phase 11, data parallelism (parallel/mesh.py) at yc2_2d3d_coot.yaml
    width, global batch 64, on a generated 128 + 64-video split, the device
    store with device sampling and packing. (a) W = 1 over NCCL (a
    process group of one rank, this process) against no process group:
    3 per-step steps and a group of K = 4 (the graph captured), bfloat16
    and the yaml's dropout 0.01 and frame noise, bit for bit (losses,
    grad_norms, every parameter), with the launch counts set to 0 just
    before the W = 1 run and read just after. (b) W = 2 rank processes
    sharing the card over gloo (NCCL refuses two ranks on one device: a
    probe of two NCCL ranks logs what it says): the same steps in float32
    at dropout 0 and noise 0 against W = 1 in this process (loss and
    grad_norm within DP_LOSS_RTOL, parameters within DP_UPDATE_TOL of lr a
    step, the ranks equal), then 3 steps at dropout 0.01 with each rank's
    launch counts set to 0 just before and read just after (B1-B5 on every
    rank) and the first B4 mask of the first step taken by a forward hook
    (the ranks' masks differ; rank 0's equals this process's on the first
    32 rows of the global batch). (c) MART at yc2_2d3d_coot_vidclip_mart.yaml
    width (f32, dropout 0), a stacked batch of S = 4, N = 16 from seed 0,
    3 steps on each rank's 8 rows against W = 1 on the 16 (phase 7's
    tolerances), the EMA equal on both ranks. (d) `torchrun --standalone
    --nproc_per_node=1 -m coot_videotext_tpu_torch.train_retrieval` (NCCL,
    world 1) trains one epoch and validates; rank 0's experiment files
    have the single-process CLI's layout and model keys. Phase 12's ranks
    start beside (b)'s; returns the references and inputs phase 12
    shares."""
    import multiprocessing
    import socket
    import torch
    import torch.distributed as dist
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    t0 = time.time()
    data = tmp / "data"
    made = _take_data("dp", data)
    log(f"a yc2-like split ({DP_TRAIN_VIDEOS} train, {DP_VAL_VIDEOS} val "
        f"videos): {made}")
    _, cfg_yaml = _dp_cfg(tmp / "yaml", dropout=None, dtype="bfloat16")
    path32, cfg32 = _dp_cfg(tmp / "f32", dropout=0.0, dtype="float32")
    path_drop, cfg_drop = _dp_cfg(tmp / "drop", dropout=DP_MASK_RATE,
                                  dtype="float32")
    vocab = len(json.loads((ROOT / "annotations" / "youcook2" /
                            "mart_word2idx.json").read_text(encoding="utf8")))
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    caption_arrays = _dp_caption_inputs(
        MartConfig(load_yaml_config_file(CAPTION_CONFIG)), vocab)

    # (b), (c) start first: the ranks and the NCCL probe run while this
    # process works through (a)
    ctx = multiprocessing.get_context("spawn")
    spec_file = tmp / "dp_spec.pt"
    torch.save({"cfg": str(path32), "cfg_drop": str(path_drop),
                "data": data,
                "vocab": vocab, "caption": caption_arrays}, spec_file)
    ranks = [ctx.Process(target=_dp_rank, args=(
        r, 2, str(tmp / "gloo_init"), str(spec_file), str(tmp)))
        for r in range(2)]
    probes = [ctx.Process(target=_nccl_probe, args=(
        r, str(tmp / "nccl_init"), str(tmp))) for r in range(2)]
    t_spawn = time.time()
    for p in ranks + probes:
        p.start()
    # phase 12's ranks ({data: 1, model: 2}) run beside phase 11's
    tp_ranks = _tp_spawn(tmp, path32, path_drop, data, vocab, caption_arrays)

    log("(a) W = 1 over NCCL against no process group, bf16, dropout 0.01, "
        "frame noise 0.01: 3 steps and a group of 4")
    t0 = time.time()
    state, batches, kw = _dp_retrieval(cfg_yaml, data, None)
    alone = _dp_train(state, batches, kw, group=True)
    del state
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = pmesh.get_mesh({"data": 1}, "cuda")
        if mesh.backend != "nccl" or mesh.world != 1:
            fail(f"(a) mesh {mesh}")
        state, batches, kw = _dp_retrieval(cfg_yaml, data, mesh)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        grouped = _dp_train(state, batches, kw, group=True)
        launches_a = dict(cuda_build.launch_counts)
        del state
    finally:
        dist.destroy_process_group()
    same = (torch.equal(alone["loss"], grouped["loss"])
            and torch.equal(alone["grad_norm"], grouped["grad_norm"])
            and all(torch.equal(alone["params"][n], grouped["params"][n])
                    for n in alone["params"]))
    log(f"  losses {[round(v, 6) for v in grouped['loss'].tolist()]}, "
        f"bit-equal to no process group: {same}; launches {launches_a} "
        f"({time.time() - t0:.1f} s)")
    if not same:
        fail("(a) W = 1 over NCCL differs from the run without a process "
             "group")
    for name in KERNELS:
        if launches_a.get(name, 0) <= 0:
            fail(f"(a) kernel {name} was not launched on the DP path")

    log("(b) W = 1 reference in this process: float32, dropout 0, noise 0")
    state, batches, kw = _dp_retrieval(cfg32, data, None)
    ref = _dp_train(state, batches, kw, group=True)
    del state
    state, batches, kw = _dp_retrieval(cfg_drop, data, None)
    mask_alone = _first_dropout_mask(state.model, lambda: _dp_train(
        state, batches[:1] * 2, dict(kw), group=False))
    del state
    log("(c) W = 1 reference: MART, 3 steps on the 16 videos")
    mgr = _dp_caption_build(torch.device("cuda"), vocab)
    cap_ref = _dp_caption_train(mgr, caption_arrays, None)
    del mgr
    torch.cuda.empty_cache()
    for p in ranks + probes:
        p.join(timeout=600 if p in ranks else 60)
    for p in probes:
        if p.is_alive():
            p.kill()
            p.join()
    for r, p in enumerate(ranks):
        if p.exitcode != 0:
            fail(f"(b) rank {r} exited with {p.exitcode}")
    log(f"  the two ranks and the probe took {time.time() - t_spawn:.1f} s "
        "from their start")
    for r in range(2):
        probe = tmp / f"nccl{r}.txt"
        said = (probe.read_text(encoding="utf8") if probe.is_file()
                else "no answer within 60 s (killed)")
        log(f"  NCCL, two ranks on one card, rank {r}: {said}")
    seen = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]
    log(f"(b) W = 2 over {seen[0]['backend']} on one card, "
        f"{seen[0]['local_batch']} rows a rank: "
        f"{[round(v, 6) for v in seen[0]['retrieval']['loss'].tolist()]} "
        f"(W = 1: {[round(v, 6) for v in ref['loss'].tolist()]}); "
        f"{seen[0]['retrieval_s']:.1f} s a rank (both on one card over "
        "gloo: not a speed measurement)")
    _hold_dp("(b)", ref, seen)
    for rank in seen:
        log(f"  rank {rank['rank']}, 3 steps at dropout {DP_MASK_RATE}: "
            f"launches {rank['launches']}")
        for name in KERNELS:
            if rank["launches"].get(name, 0) <= 0:
                fail(f"(b) kernel {name} was not launched on rank "
                     f"{rank['rank']}")
    masks = [rank["mask"] for rank in seen]
    rows = masks[0].shape[0]
    dropped = [float(m.float().mean()) for m in masks]
    differ = float((masks[0] != masks[1]).float().mean())
    same0 = bool(torch.equal(masks[0], mask_alone[:rows]))
    other1 = float((masks[1] != mask_alone[rows:2 * rows]).float().mean())
    log(f"  the step's first B4 mask at rate {DP_MASK_RATE}, shape "
        f"{tuple(masks[0].shape)} a rank: dropped {dropped[0]:.3%} / "
        f"{dropped[1]:.3%}; ranks 0 and 1 differ at {differ:.3%} of "
        f"elements; rank 0 equals one process's first {rows} rows: {same0}; "
        f"rank 1 differs from one process's next {rows} rows at "
        f"{other1:.3%}")
    if mask_alone.shape[0] != 2 * rows or masks[1].shape != masks[0].shape:
        fail(f"(b) mask shapes {[tuple(m.shape) for m in masks]}, one "
             f"process {tuple(mask_alone.shape)}")
    if min(dropped) == 0 or differ == 0 or other1 == 0:
        fail("(b) the two ranks' train steps drew the same dropout mask")
    if not same0:
        fail("(b) rank 0's dropout mask differs from one process's on the "
             "same rows")

    log("(c) MART, W = 2 over gloo against W = 1")
    for rank in seen:
        got = rank["caption"]
        for step, (g, c) in enumerate(zip(got["metrics"],
                                          cap_ref["metrics"])):
            loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
            norm_rel = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
            correct = abs(g["n_correct"] - c["n_correct"]) / c["n_word"]
            log(f"  rank {rank['rank']} step {step}: loss {g['loss']:.6f} / "
                f"{c['loss']:.6f} ({loss_rel:.2e}), grad_norm "
                f"{g['grad_norm']:.6f} / {c['grad_norm']:.6f} "
                f"({norm_rel:.2e}), n_word {g['n_word']:.0f} / "
                f"{c['n_word']:.0f}")
            if loss_rel > CAPTION_TRAIN_LOSS_RTOL \
                    or norm_rel > CAPTION_TRAIN_LOSS_RTOL \
                    or g["n_word"] != c["n_word"] \
                    or correct > CAPTION_CORRECT_TOL:
                fail(f"(c) rank {rank['rank']} step {step} disagrees with "
                     "W = 1")
        for what in ("params", "ema"):
            share = _max_diff(got[what], cap_ref[what]) / CAPTION_TRAIN_LR \
                / DP_STEPS
            log(f"  rank {rank['rank']}: {what} {share:.2%} of lr a step "
                f"(limit {CAPTION_TRAIN_UPDATE_TOL:.0%})")
            if share > CAPTION_TRAIN_UPDATE_TOL:
                fail(f"(c) rank {rank['rank']}'s {what} disagree with W = 1")
    if _max_diff(seen[0]["caption"]["ema"], seen[1]["caption"]["ema"]) != 0:
        fail("(c) the two ranks' EMA differ")
    log(f"  the EMA is equal on both ranks ({seen[0]['caption_s']:.1f} s a "
        "rank)")

    log("(d) torchrun --standalone --nproc_per_node=1 train_retrieval "
        "(NCCL) against the single-process CLI")
    config = _config(tmp / "cli")
    runs = {}
    for name in ("torchrun", "single"):
        log_dir = tmp / f"exp_{name}"
        args = ["-m", "coot_videotext_tpu_torch.train_retrieval", "-c",
                str(config), "--data_path", str(data), "--log_dir",
                str(log_dir), "-o", "train.num_epochs=1,val.val_start=0",
                "--preload_device", "--fixed_shapes"]
        t0 = time.time()
        if name == "torchrun":
            done = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node=1"] + args, cwd=ROOT,
                capture_output=True, text=True, timeout=600)
            if done.returncode != 0:
                print(done.stdout[-4000:], done.stderr[-4000:], flush=True)
                fail(f"(d) torchrun exited with {done.returncode}")
            said = [ln for ln in done.stdout.splitlines()
                    if "rank 0 of 1" in ln]
            log(f"  torchrun: {time.time() - t0:.1f} s; {said[:1]}")
        else:
            from coot_videotext_tpu_torch import train_retrieval
            train_retrieval.main(args[2:])
            log(f"  single process: {time.time() - t0:.1f} s")
        bases = list((log_dir / "retrieval").rglob("models"))
        if len(bases) != 1:
            fail(f"(d) {name}: {len(bases)} experiment directories")
        runs[name] = bases[0].parent
    layouts = {k: _file_layout(v) for k, v in runs.items()}
    if layouts["torchrun"] != layouts["single"]:
        fail(f"(d) files differ: {layouts['torchrun'] ^ layouts['single']}")
    keys = {k: {net: sorted(sd) for net, sd in torch.load(
        v / "models" / "model_0.pth", weights_only=True).items()}
        for k, v in runs.items()}
    if keys["torchrun"] != keys["single"] or any(
            k.startswith("module.") for sd in keys["torchrun"].values()
            for k in sd):
        fail("(d) the torchrun checkpoint's keys differ")
    log(f"  the same {len(layouts['single'])} files and model keys "
        f"({sum(len(v) for v in keys['single'].values())} tensors)")
    torch.cuda.empty_cache()
    return {"ref": ref, "cap_ref": cap_ref, "cfg32": cfg32, "data": data,
            "vocab": vocab, "caption_arrays": caption_arrays,
            "tp_ranks": tp_ranks}


# ---------------- phase 12: tensor parallelism ----------------

TP_SHAPE = {"data": 1, "model": 2}
TP_EVAL_RTOL = 1e-4      # eval loss parts: the TP checkpoint in one process
TP_LIMIT_S = 90.0        # the phase's time budget (logged against)


def _tp_eval(model, cfg, data: Path, mesh) -> dict:
    """The loss parts (floats) and vid_emb of the eval step on the first
    val batch of `cfg`'s split, float32 (the data rank's rows under
    `mesh`)."""
    import torch
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        retrieval_eval_step)
    device = next(model.parameters()).device
    _, _, _, val = create_retrieval_datasets_and_loaders(
        cfg, data, seed=0, device=device, fixed_shapes=True,
        device_preload=True, mesh=mesh)
    w = cfg.train.contrastive_loss_config
    embs, parts = retrieval_eval_step(
        model, to_device(next(iter(val)), device), loss_weights=w.as_dict(),
        margin=w.margin, loss_cycle_cons=cfg.train.loss_cycle_cons,
        source=FeatureSource.of(val), mesh=mesh)
    torch.cuda.synchronize(device)
    return {"parts": {k: float(v) for k, v in parts.items()},
            "vid_emb": embs["vid_emb"].float().cpu()}


def _record_calls(calls: dict):
    """Wraps the models' calls of B1 and B3 to record B1's output widths,
    B3's heads and the keep mask of B3's first call that drops (its
    philox bits, drawn as the kernel draws them); returns an undo
    function."""
    from coot_videotext_tpu_torch.models import attention, transformer
    from coot_videotext_tpu_torch.ops import philox
    fc, attn = transformer.fused_input_fc, attention.masked_attention

    def fc_rec(x, gain, bias, weight, b, eps, act):
        calls.setdefault("input_fc_dout", set()).add(weight.shape[0])
        return fc(x, gain, bias, weight, b, eps, act)

    def attn_rec(q, k, v, key_valid, num_heads, scale, rate, seed):
        calls.setdefault("attention_heads", set()).add(num_heads)
        if rate > 0 and "attention_keep" not in calls:
            calls["attention_keep"] = philox.keep_factor(
                (q.shape[0], q.shape[1], k.shape[1]), seed,
                philox.SITE_ATTENTION, rate, q.device).bool().cpu()
        return attn(q, k, v, key_valid, num_heads, scale, rate, seed)

    transformer.fused_input_fc, attention.masked_attention = fc_rec, attn_rec

    def undo():
        transformer.fused_input_fc, attention.masked_attention = fc, attn
    return undo


# phase 12 (d): caption models that run replicated under a `model` axis
TP_REPLICATED = (("TransformerXL", {"xl": True}),
                 ("joint single-sentence", {"recurrent": False}))


def _tp_replicated_step(over: dict, vocab: int, arrays: dict, mesh,
                        eager: bool) -> dict:
    """One train step at CAPTION_TRAIN_LR of the caption model of `over`
    at yc2_2d3d_coot_vidclip_mart.yaml width (seed 1, dropout 0) on the
    card under `mesh` (None: one process) and the layout
    `shard_model_for_tp` gives it: its sharded tensors, the metrics, the
    parameters and the EMA. The joint model takes the first sentence step
    of the stacked `arrays`."""
    import torch
    from coot_videotext_tpu_torch.parallel.tp import shard_model_for_tp
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, caption_train_step_single,
        init_caption_train_state)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    config = load_yaml_config_file(CAPTION_CONFIG)
    config.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  memory_dropout_prob=0.0, **over)
    cfg = MartConfig(config)
    device = torch.device("cuda", 0)
    mgr = build_mart_model_manager(cfg, vocab, device, seed=1,
                                   cache_dir=str(ROOT / "cache_caption"))
    state = init_caption_train_state(mgr.model, cfg, 0, mesh)
    shards = -1
    if mesh is not None:
        state.tp = shard_model_for_tp(mgr.model, state.optimizer, state.ema,
                                      mesh)
        shards = len(state.tp.shards)
    single = not cfg.recurrent
    batch = {k: torch.from_numpy(v[0] if single else v).to(device)
             for k, v in arrays.items()}
    step = caption_train_step_single if single else caption_train_step
    metrics = {k: float(v) for k, v in step(
        state, batch, CAPTION_TRAIN_LR, eager=eager).items()}
    return {"shards": shards, "type": type(mgr.model).__name__,
            "metrics": metrics, **_state_copy(state)}


def _tp_rank(rank: int, world: int, init_file: str, spec_file: str,
             out_dir: str) -> None:
    """Phase 12, rank `rank` of {data: 1, model: 2} on the one card over
    gloo: (a) the retrieval steps of phase 11b on the sharded model, then
    the eval batch, and rank 0 saves the whole checkpoint; (b) 3 steps at
    dropout 0.01 with the launch counts set to 0 just before and read just
    after, B1's widths and B3's heads recorded, the first B4 mask and B3's
    first keep mask; (c) the MART steps of phase 11c on the sharded model,
    the whole parameters and EMA, and a greedy decode of the batch (rank 0
    saves the weights it decoded with); (d) one step of each caption model
    of TP_REPLICATED, which the mesh runs replicated. Saves
    out_dir/tp<rank>.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    from coot_videotext_tpu_torch.parallel.tp import shard_model_for_tp
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, init_caption_train_state)
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        spec = torch.load(spec_file, weights_only=False)
        mesh = pmesh.get_mesh(TP_SHAPE, device=torch.device("cuda", 0))
        out = {"rank": rank, "model_rank": mesh.model_rank}
        t0 = time.time()
        cfg, cfg_drop = (RetrievalConfig(load_yaml_config_file(spec[k]))
                         for k in ("cfg", "cfg_drop"))
        state, batches, kw = _dp_retrieval(cfg, spec["data"], mesh)
        state.tp = shard_model_for_tp(state.model, state.optimizer, None,
                                      mesh)
        out["shards"] = len(state.tp.shards)
        run = _dp_train(state, batches, kw, group=True)
        run["params"] = state.tp.gather(run["params"])
        out["retrieval"] = run
        out["eval"] = _tp_eval(state.model, cfg, spec["data"], mesh)
        whole = {net: state.tp.gather(sd, f"{net}.")
                 for net, sd in ((n, m.state_dict()) for n, m in
                                 state.model.nets().items())}
        if mesh.is_writer:
            torch.save(whole, Path(out_dir) / "tp_model.pth")
        out["retrieval_s"] = time.time() - t0
        del state
        state, batches, kw = _dp_retrieval(cfg_drop, spec["data"], mesh)
        state.tp = shard_model_for_tp(state.model, state.optimizer, None,
                                      mesh)
        calls: dict = {}
        undo = _record_calls(calls)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        try:
            out["mask"] = _first_dropout_mask(state.model, lambda: _dp_train(
                state, batches[:1] * 2, dict(kw), group=False))
        finally:
            undo()
        out["launches"] = dict(cuda_build.launch_counts)
        out["attention_keep"] = calls.pop("attention_keep")
        out["calls"] = calls
        del state
        t0 = time.time()
        mgr = _dp_caption_build(torch.device("cuda", 0), spec["vocab"])
        cstate = init_caption_train_state(mgr.model, mgr.cfg, 0, mesh)
        cstate.tp = shard_model_for_tp(mgr.model, cstate.optimizer,
                                       cstate.ema, mesh)
        device = torch.device("cuda", 0)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in spec["caption"].items()}
        metrics = [{k: float(v) for k, v in caption_train_step(
            cstate, batch, CAPTION_TRAIN_LR).items()}
            for _ in range(DP_STEPS)]
        snap = _state_copy(cstate)
        out["caption"] = {"metrics": metrics,
                          "params": cstate.tp.gather(snap["params"]),
                          "ema": cstate.tp.gather(snap["ema"]),
                          "shards": len(cstate.tp.shards)}
        # eagerly: the model group's gloo collectives run on the host
        tokens = Translator(mgr.model, mgr.cfg,
                            eager=True).translate_batch_greedy(
            batch["input_ids"], batch["video_feature"], batch["input_mask"],
            batch["token_type_ids"])
        out["tokens"] = [np.asarray(t) for t in tokens]
        if mesh.is_writer:
            torch.save(out["caption"]["params"], Path(out_dir) / "tp_mart.pt")
        del mgr, cstate
        out["replicated"] = {tag: _tp_replicated_step(
            over, spec["vocab"], spec["caption"], mesh, eager=False)
            for tag, over in TP_REPLICATED}
        out["caption_s"] = time.time() - t0
        torch.save(out, Path(out_dir) / f"tp{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_spawn(tmp: Path, path32: Path, path_drop: Path, data: Path,
              vocab: int, caption_arrays: dict) -> list:
    """Starts phase 12's two rank processes (_tp_rank); returns them."""
    import multiprocessing
    import torch
    out = tmp / "tp"
    out.mkdir()
    spec_file = out / "spec.pt"
    torch.save({"cfg": str(path32), "cfg_drop": str(path_drop),
                "data": data, "vocab": vocab, "caption": caption_arrays},
               spec_file)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_tp_rank, args=(
        r, 2, str(out / "gloo_init"), str(spec_file), str(out)))
        for r in range(2)]
    for p in ranks:
        p.start()
    return ranks


def phase_tp(tmp: Path, shared: dict) -> None:
    """Phase 12, tensor parallelism (parallel/tp.py) at yc2_2d3d_coot.yaml
    and yc2_2d3d_coot_vidclip_mart.yaml width: {data: 1, model: 2}, two
    rank processes sharing the card over gloo (NCCL refuses two ranks on
    one device, phase 11), each holding half of every sharded kernel,
    started beside phase 11's ranks (`shared`: phase 11's one-process
    references, inputs and these ranks). (a) Phase 11b's retrieval run
    (float32, dropout 0 and noise 0, 3 steps and a group of 4 on the
    generated split, global batch 64) against one process (DP_LOSS_RTOL,
    DP_UPDATE_TOL), the two ranks' whole parameters equal; the eval batch
    on the sharded model against the checkpoint rank 0 saved (whole
    tensors) loaded into one process, loss parts within TP_EVAL_RTOL. (b)
    3 steps at dropout 0.01: B1-B5 launched on both ranks, B1 at dout 192
    and B3 at 4 heads; the first B4 mask (a replicated site) equal on both
    ranks, B3's first keep mask (the rank's heads) different. (c) MART
    (f32, dropout 0, S = 4, N = 16) 3 steps against one process (phase
    7's tolerances), 22 kernels sharded, the EMA equal on both ranks, and a
    greedy decode of the batch equal, token for token, to one process's
    with the weights rank 0 saved. (d) The TransformerXL and the joint
    model (TP_REPLICATED: replicated under the `model` axis, as JAX runs
    them; f32, dropout 0): one step on each rank (eagerly: gloo) equal, bit
    for bit, to one process's eager step on the card."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.models.retrieval import (
        RetrievalNetworksConst)
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    t_phase = time.time()
    ref, cap_ref, cfg32 = shared["ref"], shared["cap_ref"], shared["cfg32"]
    data, vocab = shared["data"], shared["vocab"]
    caption_arrays = shared["caption_arrays"]
    ranks = shared["tp_ranks"]
    out = tmp / "tp"
    for p in ranks:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
            p.join()
    for r, p in enumerate(ranks):
        if p.exitcode != 0:
            fail(f"phase 12: rank {r} exited with {p.exitcode}")
    seen = [torch.load(out / f"tp{r}.pt", weights_only=False)
            for r in range(2)]
    log(f"(a) {{data: 1, model: 2}} over gloo on one card, "
        f"{seen[0]['shards']} retrieval kernels sharded: "
        f"{[round(v, 6) for v in seen[0]['retrieval']['loss'].tolist()]} "
        f"(one process: {[round(v, 6) for v in ref['loss'].tolist()]}); "
        f"{seen[0]['retrieval_s']:.1f} s a rank (both on one card over "
        "gloo: not a speed measurement)")
    if seen[0]["shards"] != 26:
        fail(f"phase 12: {seen[0]['shards']} retrieval kernels sharded, "
             "not 26")
    _hold_dp("phase 12 (a)", ref, seen)
    mgr = RetrievalModelManager(cfg32, torch.device("cuda"))
    mgr.load_file(str(out / "tp_model.pth"))
    if set(torch.load(out / "tp_model.pth", weights_only=True)) != set(
            RetrievalNetworksConst.values()):
        fail("phase 12 (a): the TP checkpoint's nets")
    alone = _tp_eval(mgr.model, cfg32, data, None)
    del mgr
    for rank in seen:
        rel = max(abs(rank["eval"]["parts"][k] - v) / max(abs(v), 1e-12)
                  for k, v in alone["parts"].items())
        emb = float((rank["eval"]["vid_emb"] - alone["vid_emb"]).abs().max())
        loss = rank["eval"]["parts"]["loss_total"]
        log(f"  rank {rank['rank']}: eval loss {loss:.6f} / the TP "
            f"checkpoint in one process "
            f"{alone['parts']['loss_total']:.6f}, parts relative {rel:.2e} "
            f"(limit {TP_EVAL_RTOL}); vid_emb max diff {emb:.2e}")
        if rel > TP_EVAL_RTOL:
            fail(f"phase 12 (a): rank {rank['rank']}'s eval loss disagrees "
                 "with its checkpoint in one process")
    log("(b) 3 steps at dropout 0.01 on the sharded model")
    for rank in seen:
        log(f"  rank {rank['rank']}: launches {rank['launches']}; B1 dout "
            f"{sorted(rank['calls']['input_fc_dout'])}, B3 heads "
            f"{sorted(rank['calls']['attention_heads'])}")
        for name in KERNELS:
            if rank["launches"].get(name, 0) <= 0:
                fail(f"phase 12 (b): kernel {name} was not launched on rank "
                     f"{rank['rank']}")
        if rank["calls"]["input_fc_dout"] != {192} \
                or rank["calls"]["attention_heads"] != {4}:
            fail("phase 12 (b): B1 or B3 ran at unsharded widths")
    masks = [rank["mask"] for rank in seen]
    keeps = [rank["attention_keep"] for rank in seen]
    same_b4 = bool(torch.equal(masks[0], masks[1]))
    b3_differ = float((keeps[0] != keeps[1]).float().mean())
    log(f"  the first B4 mask, shape {tuple(masks[0].shape)}: dropped "
        f"{float(masks[0].float().mean()):.3%}, equal on both ranks: "
        f"{same_b4}; B3's first keep mask (the rank's 4 heads), shape "
        f"{tuple(keeps[0].shape)}: the ranks differ at {b3_differ:.3%}")
    if not same_b4 or not masks[0].any():
        fail("phase 12 (b): the replicated B4 site drew different masks")
    if b3_differ == 0:
        fail("phase 12 (b): the ranks' heads drew the same B3 mask")
    log("(c) MART on {data: 1, model: 2} against one process")
    for rank in seen:
        got = rank["caption"]
        if got["shards"] != 22:
            fail(f"phase 12 (c): {got['shards']} MART kernels sharded")
        for step, (g, c) in enumerate(zip(got["metrics"],
                                          cap_ref["metrics"])):
            loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
            norm_rel = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
            log(f"  rank {rank['rank']} step {step}: loss {g['loss']:.6f} / "
                f"{c['loss']:.6f} ({loss_rel:.2e}), grad_norm "
                f"{g['grad_norm']:.6f} / {c['grad_norm']:.6f} "
                f"({norm_rel:.2e})")
            if loss_rel > CAPTION_TRAIN_LOSS_RTOL \
                    or norm_rel > CAPTION_TRAIN_LOSS_RTOL \
                    or g["n_word"] != c["n_word"]:
                fail(f"phase 12 (c): rank {rank['rank']} step {step} "
                     "disagrees with one process")
        for what in ("params", "ema"):
            share = _max_diff(got[what], cap_ref[what]) / CAPTION_TRAIN_LR \
                / DP_STEPS
            log(f"  rank {rank['rank']}: {what} {share:.2%} of lr a step "
                f"(limit {CAPTION_TRAIN_UPDATE_TOL:.0%})")
            if share > CAPTION_TRAIN_UPDATE_TOL:
                fail(f"phase 12 (c): rank {rank['rank']}'s {what} disagree "
                     "with one process")
    if _max_diff(seen[0]["caption"]["ema"], seen[1]["caption"]["ema"]) != 0:
        fail("phase 12 (c): the two ranks' EMA differ")
    mgr = _dp_caption_build(torch.device("cuda"), vocab)
    saved = torch.load(out / "tp_mart.pt", weights_only=True)
    with torch.no_grad():
        for n, p in mgr.model.named_parameters():
            p.copy_(saved[n])
    batch = {k: torch.from_numpy(v).cuda() for k, v in caption_arrays.items()}
    tokens = Translator(mgr.model, mgr.cfg).translate_batch_greedy(
        batch["input_ids"], batch["video_feature"], batch["input_mask"],
        batch["token_type_ids"])
    same = [all(np.array_equal(a, b) for a, b in zip(rank["tokens"], tokens))
            for rank in seen]
    log(f"  greedy decode of the {DP_CAPTION_SHAPE[1]} videos x "
        f"{DP_CAPTION_SHAPE[0]} sentences: each rank's tokens equal one "
        f"process's with the same weights: {same}")
    if not all(same):
        fail("phase 12 (c): the greedy tokens differ from one process's")
    del mgr
    torch.cuda.empty_cache()
    log("(d) the caption models that run replicated under a `model` axis")
    for tag, over in TP_REPLICATED:
        alone = _tp_replicated_step(over, vocab, caption_arrays, None,
                                    eager=True)
        for rank in seen:
            got = rank["replicated"][tag]
            equal = (got["metrics"] == alone["metrics"]
                     and _max_diff(got["params"], alone["params"]) == 0
                     and _max_diff(got["ema"], alone["ema"]) == 0)
            log(f"  {tag} ({got['type']}), rank {rank['rank']}: "
                f"{got['shards']} tensors sharded; loss "
                f"{got['metrics']['loss']:.6f} / one process "
                f"{alone['metrics']['loss']:.6f}, grad_norm "
                f"{got['metrics']['grad_norm']:.6f} / "
                f"{alone['metrics']['grad_norm']:.6f}; metrics, parameters "
                f"and EMA bit for bit equal: {equal}")
            if got["shards"] != 0 or not equal:
                fail(f"phase 12 (d): {tag} on rank {rank['rank']} differs "
                     "from one process")
        del alone
        torch.cuda.empty_cache()
    log(f"  phase 12 took {time.time() - t_phase:.1f} s after phase 11 "
        f"(budget {TP_LIMIT_S:.0f} s); its ranks ran "
        f"{seen[0]['retrieval_s'] + seen[0]['caption_s']:.1f} s of work "
        "beside phase 11's")



# ---------- phase 13: the serving programs as CUDA graphs ----------

SERVING_LIMIT_S = 180.0  # the phase's time budget (logged against)
# the captured retrieval eval step against the eager one: bit for bit is
# expected; if cuBLAS took another algorithm under capture, at most this
# far apart (relative to the largest |value| of each output)
SERVING_EVAL_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the retrieval configs that never ran on the card before: one val batch
# each of synthetic features at their widths
SERVING_RETRIEVAL_CONFIGS = ("anet_coot.yaml", "yc2_100m_coot.yaml")
SERVING_VAL_VIDEOS = 64
DECODE_KEYS = ("input_ids", "video_feature", "input_mask", "token_type_ids")
# the traced decodes (phases 6d, 9a, 13a) take this many sentence steps of
# a batch of 50 videos (a whole batch is ~80,000 kernels to process)
TRACE_STEPS = 2


def _outputs_apart(graph: dict, eager: dict) -> float:
    """The largest difference of two dicts of arrays or tensors, relative
    to max(1, the largest |eager| value) of each."""
    import numpy as np
    worst = 0.0
    for key, ref in eager.items():
        a = np.asarray(graph[key].float().cpu() if hasattr(graph[key], "cpu")
                       else graph[key], np.float64)
        b = np.asarray(ref.float().cpu() if hasattr(ref, "cpu") else ref,
                       np.float64)
        if a.shape != b.shape:
            fail(f"{key}: shape {a.shape} against {b.shape}")
        if b.size:
            worst = max(worst, float(np.abs(a - b).max())
                        / max(1.0, float(np.abs(b).max())))
    return worst


def _hold_ranks(embs: dict) -> None:
    """Ranks on the card equal ranks on the host from the same
    similarities (vid/par, clip/sent), and the similarities agree."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.tasks.retrieval.eval import _ranks_both
    for k1, k2 in (("vid_emb", "par_emb"), ("clip_emb", "sent_emb")):
        e1 = torch.from_numpy(embs[k1]).cuda()
        e2 = torch.from_numpy(embs[k2]).cuda()
        r12, _, r21, _ = _ranks_both(e1, e2)
        sim = (e1 @ e2.t()).cpu().numpy()
        diag = np.diagonal(sim)
        h12 = (sim > diag[:, None]).sum(1)
        h21 = (sim > diag[None, :]).sum(0)
        if not (np.array_equal(h12, r12.cpu().numpy())
                and np.array_equal(h21, r21.cpu().numpy())):
            fail(f"device ranks differ from host ranks for {k1}/{k2}")
        host_sim = embs[k1] @ embs[k2].T
        if np.abs(host_sim - sim).max() > 1e-4:
            fail(f"device similarities differ from host for {k1}/{k2}")


def _decode_pass(translator, batches, beam: bool, compat: bool = False):
    """Every batch decoded: (tokens per batch, wall ms per batch, forwards,
    host reads and program runs per batch)."""
    import numpy as np
    import torch
    tokens, ms, counts = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if beam:
            out = translator.translate_batch_beam(*batch,
                                                  reference_compat=compat)
        else:
            out = translator.translate_batch_greedy(*batch)
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(np.stack(out))
        counts.append((translator.forwards, translator.host_reads,
                       translator.replays))
    return tokens, ms, counts


def _serving_eval(tag: str, step, model, batch: dict) -> None:
    """A caption eval step (`step`) on `batch` through its graph against
    eagerly: the capture, then warm replays, equal to the eager step
    (SERVING_EVAL_RTOL in f32); warm ms each way."""
    import torch
    out, ms = {}, {}
    for name, eager in (("eager", True), ("graph", False)):
        out[name] = {k: float(v) for k, v in
                     step(model, batch, eager=eager).items()}
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = {k: float(v) for k, v in
                   step(model, batch, eager=eager).items()}
            walls.append((time.perf_counter() - t0) * 1e3)
            if got != out[name]:
                fail(f"{tag} eval step ({name}): two calls differ")
        ms[name] = statistics.median(walls)
    apart = max(abs(out["graph"][k] - v) / max(1.0, abs(v))
                for k, v in out["eager"].items())
    log(f"  {tag} eval step: {out['graph']} through its graph, "
        f"{apart:.3e} apart from eager (limit "
        f"{SERVING_EVAL_RTOL['float32']:.0e}); warm {ms['graph']:.2f} ms "
        f"against {ms['eager']:.2f} ms eagerly")
    if not apart <= SERVING_EVAL_RTOL["float32"]:
        fail(f"{tag}: the captured eval step disagrees with the eager one")


def _serving_decode(tag: str, mgr, batches, beam: bool) -> None:
    """One decode mode over `batches` eagerly, then through the programs
    (CUDA graphs): the tokens of every batch identical; median ms per
    batch, forwards, host reads and replays per batch, the graphs' extra
    peak memory, and one warm batch traced each way (wall, device busy,
    the host's kernel launches per forward)."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.utils.graphs import cache_of
    runs = {}
    for name, eager in (("eager", True), ("graph", False)):
        translator = Translator(mgr.model, mgr.cfg, eager=eager)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        built = cache_of(mgr.model).captures
        tokens, ms, counts = _decode_pass(translator, batches, beam)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        kept = torch.cuda.memory_allocated() - held
        runs[name] = dict(tokens=tokens, ms=ms, counts=counts, peak=peak,
                          kept=kept, translator=translator,
                          captures=cache_of(mgr.model).captures - built)
    for i, (a, b) in enumerate(zip(runs["graph"]["tokens"],
                                   runs["eager"]["tokens"])):
        if not np.array_equal(a, b):
            rows = (a == b).reshape(-1, a.shape[-1]).all(axis=1)
            fail(f"{tag}: batch {i} decoded through the graphs differs "
                 f"from the eager decode ({int(rows.sum())} of {rows.size} "
                 "sentences identical)")
    sentences = sum(int(t.shape[0] * t.shape[1]) for t in
                    runs["eager"]["tokens"])
    for name, run in runs.items():
        f, h, r = (statistics.median(c[j] for c in run["counts"])
                   for j in range(3))
        # the graph pass's first batches of each shape include captures
        ms = run["ms"][1:] if name == "graph" else run["ms"]
        log(f"  {tag} {name:5s}: median {statistics.median(ms):.2f} ms a "
            f"batch (all {[round(v, 1) for v in run['ms']]}), {f:.0f} "
            f"forwards, {h:.0f} host reads, {r:.0f} program runs a batch; "
            f"{run['captures']} programs built; peak device memory "
            f"{run['peak'] / 1e9:.3f} GB above the model and batches, "
            f"{run['kept'] / 1e9:.3f} GB kept after the pass")
    log(f"  {tag}: {len(batches)} batches, {sentences} sentences, every one "
        f"token-identical through the graphs; the graphs' extra peak "
        f"memory {(runs['graph']['peak'] - runs['eager']['peak']) / 1e9:.3f}"
        " GB")
    # the trace takes the first TRACE_STEPS sentence steps of batch 0: the
    # profiler's processing of a whole eager batch (~80,000 kernels and
    # launches) takes a minute
    batch = [x[:TRACE_STEPS] for x in batches[0]]
    t0 = time.time()
    for name, run in runs.items():
        translator = run["translator"]

        def decode():
            if beam:
                translator.translate_batch_beam(*batch)
            else:
                translator.translate_batch_greedy(*batch)
        wall, busy, kernels, _, host = _busy_ms(decode, host=True)
        log(f"  {tag} {name:5s} traced (batch 0, {TRACE_STEPS} sentence "
            f"steps): wall {wall:.1f} ms, device "
            f"busy {busy:.1f} ms ({busy / wall:.1%}); {kernels} kernels on "
            f"the device; the host launched {host['kernel_launches']} "
            f"kernels ({host['kernel_launches'] / translator.forwards:.2f} "
            f"a forward) and {host['graph_launches']} graphs for "
            f"{translator.forwards} forwards ({time.time() - t0:.1f} s of "
            "tracing so far)")


def _retrieval_serving(tmp: Path, source_yaml: Path,
                       cpu_check: bool) -> dict:
    """A val split of synthetic videos at the widths of `source_yaml` (npy
    features, DATA_SPLITS' `serving_<stem>`) on the device store with device sampling
    (id batches, fixed shapes). validate_retrieval through the captured
    eval step against the eager one (embeddings, losses, metrics), device
    ranks against host ranks; the warm eval step's ms and device-busy ms
    each way and the port's kernel launches in a step (a replay launches
    none); with `cpu_check` one batch on the card in f32 against the CPU
    (the kernels' plain versions) and B1-B3 against their plain versions
    at the batch's shapes. Returns the launches of one eager step."""
    import numpy as np
    import torch
    import yaml
    from coot_videotext_tpu_torch.data.device_store import (
        FeatureSource, assemble_batch)
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain)
    from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_plain)
    from coot_videotext_tpu_torch.tasks.retrieval import validate
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        retrieval_eval_step)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cuda = torch.device("cuda")
    raw = load_yaml_config_file(source_yaml)
    ds = raw["dataset_train"]
    made = _take_data(f"serving_{source_yaml.stem}", tmp / "data")
    num_val, seed = DATA_SPLITS[f"serving_{source_yaml.stem}"][1:3]
    ds.update(vid_feat_source="npy", text_feat_source="npy", frames_noise=0)
    raw["dataset_val"]["split"] = "val"  # the generator's split
    path = tmp / source_yaml.name
    path.write_text(yaml.safe_dump(raw, sort_keys=False), encoding="utf8")
    cfg = RetrievalConfig(load_yaml_config_file(path), is_train=False)
    _, _, _, loader = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=cuda, fixed_shapes=True,
        device_preload=True)
    if loader.layout != "ids":
        fail(f"{source_yaml.name}: the val loader's layout is "
             f"{loader.layout}, not ids")
    mgr = RetrievalModelManager(cfg, cuda, seed=0)
    dn = str(mgr.val_dtype).split(".")[-1]
    log(f"  {source_yaml.name}: {num_val} val videos at {ds['vid_feat_dim']}"
        f"-d video / {ds['text_feat_dim']}-d text ({made}), val batch {cfg.val.batch_size}, "
        f"{dn}, val_clips {cfg.val.val_clips}")
    kw = dict(compute_dtype=mgr.val_dtype, val_clips=cfg.val.val_clips,
              cc_seed=42)
    results = {}
    # the first graph pass captures the step (a program per batch shape),
    # the second replays only
    for name in ("graph, capturing", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = validate.validate_retrieval(
            mgr.model, cfg, loader, cuda, eager=name == "eager", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = results[name]
        log(f"  validation, eval step {res['eval_step']}: "
            f"{res['num_videos']} videos in {res['num_batches']} batches, "
            f"{res['num_videos'] / wall:.2f} val videos/s ({wall:.3f} s, "
            f"forward {res['forward_s']:.3f} s)")
    if results["graph"]["eval_step"] != "CUDA graph" \
            or results["eager"]["eval_step"] != "eager":
        fail(f"{source_yaml.name}: the eval steps ran as "
             f"{results['graph']['eval_step']} / "
             f"{results['eager']['eval_step']}")
    apart = _outputs_apart(results["graph"]["embeddings"],
                           results["eager"]["embeddings"])
    losses = max(abs(results["graph"][k] - results["eager"][k])
                 / max(1.0, abs(results["eager"][k]))
                 for k in ("loss_total", "loss_contrastive", "loss_cc"))
    metric_keys = [k for k in ("v2p", "p2v", "c2s", "s2c")
                   if k in results["eager"]]
    same = all(results["graph"][k] == results["eager"][k]
               for k in metric_keys)
    log(f"  graph against eager: embeddings {apart:.3e} apart, losses "
        f"{losses:.3e} (limit {SERVING_EVAL_RTOL[dn]:.0e}; 0 is bit for "
        f"bit), metrics {metric_keys} equal: {same}")
    if not (apart <= SERVING_EVAL_RTOL[dn] and losses <= SERVING_EVAL_RTOL[dn]
            and same):
        fail(f"{source_yaml.name}: the captured eval step disagrees with "
             "the eager one")
    if cfg.val.val_clips:
        _hold_ranks(results["graph"]["embeddings"])
        log("  device ranks == host ranks (vid/par, clip/sent) on the "
            "graph's embeddings")

    batch = to_device(next(iter(loader)), cuda)
    source = FeatureSource.of(loader)
    step_kw = dict(loss_weights=cfg.train.contrastive_loss_config.as_dict(),
                   margin=cfg.train.contrastive_loss_config.margin,
                   loss_cycle_cons=cfg.train.loss_cycle_cons,
                   compute_dtype=mgr.val_dtype, source=source)
    launches, traced = {}, {}
    for name, eager in (("eager", True), ("graph", False)):
        def step():
            retrieval_eval_step(mgr.model, batch, eager=eager, **step_kw)
            torch.cuda.synchronize()
        step()
        cuda_build.reset_launch_counts()
        step()
        launches[name] = dict(cuda_build.launch_counts)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, busy, kernels, events, host = _busy_ms(step, host=True)
        traced[name] = _port_kernel_counts(events)
        log(f"  eval step {name:5s} (batch 0, warm, median of 5): "
            f"{statistics.median(walls):.2f} ms (min {min(walls):.2f}); "
            f"traced {wall:.2f} ms, device busy {busy:.2f} ms "
            f"({busy / wall:.1%}), {kernels} kernels, the host launched "
            f"{host['kernel_launches']} kernels and {host['graph_launches']}"
            f" graphs; wrapper launches in one step {launches[name]}; the "
            f"port's kernels on the device in the traced step "
            f"{traced[name]}")
    if any(launches["graph"].values()):
        fail(f"{source_yaml.name}: a replay of the eval step ran the "
             f"wrappers: {launches['graph']}")
    for kernel in EVAL_KERNELS:
        if launches["eager"].get(kernel, 0) <= 0:
            fail(f"{source_yaml.name}: {kernel} did not run in the eval "
                 "step")
        if traced["graph"].get(kernel, 0) <= 0:
            fail(f"{source_yaml.name}: the trace of a graph replay holds "
                 f"no {kernel} kernel: {traced['graph']}")
    if traced["graph"] != traced["eager"]:
        fail(f"{source_yaml.name}: the replay ran other kernels of the port "
             f"({traced['graph']}) than the eager step ({traced['eager']})")
    if not cpu_check:
        return traced["graph"]

    log("  one batch on the card in f32 (the kernels) against the CPU "
        "(their plain versions)")
    dense = assemble_batch(batch, source)
    gpu_kw = dict(step_kw, compute_dtype=torch.float32)
    e_gpu, p_gpu = retrieval_eval_step(mgr.model, batch, eager=True,
                                       **gpu_kw)
    cpu = RetrievalModelManager(cfg, torch.device("cpu"), seed=0)
    host_batch = {k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in dense.items()}
    t0 = time.time()
    e_cpu, p_cpu = retrieval_eval_step(cpu.model, host_batch, eager=True,
                                       **dict(step_kw, source=None,
                                              compute_dtype=torch.float32))
    apart = _outputs_apart(e_gpu, e_cpu)
    log(f"  card f32 against the CPU ({time.time() - t0:.1f} s on the CPU):"
        f" embeddings {apart:.3e} apart (limit {TOL['float32']:.0e})")
    if not apart <= TOL["float32"]:
        fail(f"{source_yaml.name}: the card disagrees with the CPU")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    clips = dense["clip_feat"]
    rows, length = clips.shape[0], clips.shape[1]
    din = clips.shape[2]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        args = input_fc_inputs(rows * length, din, 384, dt, gen, 5)
        with torch.inference_mode():
            check_tol("input_fc", name, f"clips S={rows * length} "
                      f"{din}->384", *errors(
                          fused_input_fc(*args, 1e-6, "gelu"),
                          fused_input_fc_plain(*args, 1e-6, "gelu")))
            args = genpool_inputs(rows, length, 384, 768, 2, dt, gen)
            check_tol("genpool", name, f"clips S={rows} L={length}", *errors(
                genpool(*args, "gelu", 0.0, None),
                genpool_plain(*args, "gelu", 0.0, None)))
            args = attention_inputs(rows, 8, length, length, 48, dt, gen)
            check_tol("attention", name, f"clips N={rows * 8} L={length}",
                      *errors(masked_attention(*args, 8, 48 ** -0.5),
                              masked_attention_plain(*args, 8, 48 ** -0.5)))
    del mgr, cpu, loader, batch, dense
    torch.cuda.empty_cache()
    return traced["graph"]


def phase_serving_graphs(tmp: Path) -> dict:
    """Phase 13, the serving programs as CUDA graphs (utils/graphs.py),
    each against the eager path on the same weights and inputs. (a) MART
    at yc2_2d3d_coot_vidclip_mart width over the 457-video YouCook2 val
    split (phase 6's inputs, seed 0): greedy and beam (fixed) decoded
    eagerly and through the graphs, every sentence token-identical, beam
    reference_compat on the first batch; ms, forwards, host reads and
    program runs a batch, the graphs' extra peak memory, one traced batch
    each way. (b) The TransformerXL, the untied and joint models (phase
    9's widths) and the MTransformer (yc2_100m_coot_vidclip_mtrans) from
    seed 0: one val batch each, token-identical. (c) Retrieval on
    yc2_2d3d_coot.yaml id batches (128 val videos): validation through the
    graph against the eager step, ranks against host ranks, the warm eval
    step each way, the port's launches in a step. (d) anet_coot.yaml and
    yc2_100m_coot.yaml, which no earlier phase runs: one val batch each at
    their widths through the graph against eager, the card against the
    CPU in f32, B1-B3 against their plain versions at the batch's shapes.
    Returns the port's kernels on the device in one traced replay of the
    captured yc2_2d3d_coot eval step, counted by name
    (`_port_kernel_counts`), each of B1, B2, B3 and B5 required there."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.data.caption_dataset import STACKED_KEYS
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_eval_step, caption_eval_step_single)
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    t_phase = time.time()
    cuda = torch.device("cuda")

    def config(path, over):
        cfg = load_yaml_config_file(path)
        cfg.update(over)
        return MartConfig(cfg)

    cfg = config(CAPTION_CONFIG, {})
    def mark(what: str) -> None:
        log(f"  [{time.time() - t_phase:.1f} s into phase 13] {what}")

    log("(a) MART over the YouCook2 val split, greedy and beam, eager "
        "against the graphs")
    emb_dir, pth, _ = _caption_inputs(tmp / "mart", cfg)
    val = _family_dataset(cfg, emb_dir, "val")
    mgr = _family_build({}, len(val.word2idx), pth)(cuda)
    n = cfg.val.batch_size
    batches = []
    for start in range(0, len(val), n):
        stacked, _, _ = val.collate_fn(
            [val[i] for i in range(start, min(start + n, len(val)))])
        if not batches:
            first = {k: torch.from_numpy(stacked[k]).cuda()
                     for k in STACKED_KEYS}
        batches.append([torch.from_numpy(stacked[k]).cuda()
                        for k in DECODE_KEYS])
    mark(f"{len(val)} videos in {len(batches)} batches of {n}")
    _serving_eval("MART", caption_eval_step, mgr.model, first)
    _serving_decode("greedy", mgr, batches, beam=False)
    mark("greedy done")
    _serving_decode(f"beam {cfg.beam_size}", mgr, batches, beam=True)
    mark("beam done")
    decs = [np.stack(Translator(mgr.model, mgr.cfg, eager=eager)
                     .translate_batch_beam(*batches[0],
                                           reference_compat=True))
            for eager in (True, False)]
    if not np.array_equal(*decs):
        fail("beam reference_compat: the graphs' tokens differ from eager")
    log("  beam reference_compat, batch 0: token-identical through the "
        "graphs")
    del mgr, batches, decs
    torch.cuda.empty_cache()

    log("(b) the rest of the family, one val batch each, seed 0")
    family = [(tag, CAPTION_CONFIG, over, emb_dir)
              for tag, over, _, _, _ in FAMILY_VARIANTS
              if tag != "tied decoder"]
    mcfg = config(MTRANS_CONFIG, {})
    family.append(("MTransformer", MTRANS_CONFIG, {},
                   _coot_embeddings(tmp / "mtrans", mcfg)))
    for tag, path, over, emb in family:
        cfg = config(path, over)
        val = _family_dataset(cfg, emb, "val")
        mgr = build_mart_model_manager(cfg, len(val.word2idx), cuda, seed=0,
                                       cache_dir=str(ROOT / "cache_caption"))
        stacked, _, _ = val.collate_fn([val[j] for j in range(
            cfg.val.batch_size)])
        batch = {k: torch.from_numpy(v).cuda() for k, v in stacked.items()
                 if isinstance(v, np.ndarray)}
        _serving_eval(tag, caption_eval_step if cfg.recurrent
                      else caption_eval_step_single, mgr.model, batch)
        out, ms = {}, {}
        for name, eager in (("eager", True), ("graph", False), ("replay",
                                                                False)):
            translator = Translator(mgr.model, mgr.cfg, eager=eager)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = np.asarray(translator.translate_batch(batch))
            ms[name] = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(out["graph"], out["eager"])
                and np.array_equal(out["replay"], out["eager"])):
            fail(f"{tag}: the graphs' tokens differ from the eager decode")
        mark(f"{tag} done")
        log(f"  {tag}: {out['eager'].size // out['eager'].shape[-1]} "
            f"sentences token-identical; eager {ms['eager']:.1f} ms, first "
            f"graph call (captures) {ms['graph']:.1f} ms, replays "
            f"{ms['replay']:.1f} ms; {translator.forwards} forwards, "
            f"{translator.replays} program runs, "
            f"{len(np.unique(out['eager']))} distinct tokens")
        del mgr, batch, translator
        torch.cuda.empty_cache()

    mark("(b) done")
    log("(c) the retrieval eval step on yc2_2d3d_coot.yaml id batches")
    launches = _retrieval_serving(tmp / "yc2", CONFIG, cpu_check=False)
    for i, name in enumerate(SERVING_RETRIEVAL_CONFIGS):
        mark(f"({'de'[i]}) starts")
        log(f"({'de'[i]}) {name}: one val batch at its widths")
        _retrieval_serving(tmp / name.split(".")[0], CONFIG.parent / name,
                           cpu_check=True)
    log(f"  phase 13 took {time.time() - t_phase:.1f} s (budget "
        f"{SERVING_LIMIT_S:.0f} s)")
    return launches


# ---------- phase 14: the caption train programs ----------

TRAIN_PROGRAMS_LIMIT_S = 240.0  # the phase's time budget (logged against)
# (tag, config, -o overrides, the stacked batches' sentence steps S, or
# None for a sentence batch); MART over two buckets of COUNT_LADDER
TRAIN_PROGRAM_MODELS = (
    ("MART", CAPTION_CONFIG, {}, (4, 12)),
    ("raw-feature MART", RAW_CONFIG, {}, (6,)),
    ("TransformerXL", CAPTION_CONFIG, {"xl": True}, (6,)),
    ("TransformerXL xl_grad", CAPTION_CONFIG, {"xl": True, "xl_grad": True},
     (6,)),
    ("tied decoder", CAPTION_CONFIG, {"share_wd_cls_weight": True,
                                      "word_vec_size": 768,
                                      "use_glove": False}, (6,)),
    ("untied", CAPTION_CONFIG, {"recurrent": False, "untied": True}, None),
    ("joint single-sentence", CAPTION_CONFIG, {"recurrent": False}, None),
    ("MTransformer", MTRANS_CONFIG, {}, None),
)
TRAIN_PROGRAM_STEPS = 8
TRAIN_PROGRAM_LRS = (1e-4, 3e-5, 2e-4)


def _train_batch(cfg, vocab: int, s, n: int, seed: int) -> dict:
    """A caption train batch from `seed` at the config's shapes: stacked
    (S, N, L) for the recurrent models (S = `s`), untied (N, ...) for the
    untied model and the MTransformer, joint (N, L) for the joint model;
    padded slots and about a third of the labels IGNORE."""
    import numpy as np
    rng = np.random.RandomState(seed)
    v, t = cfg.max_v_len, cfg.max_t_len
    if cfg.untied or cfg.mtrans:
        tmask = (np.arange(t)[None] < rng.randint(4, t + 1, (n, 1)))
        ids = np.where(tmask, rng.randint(7, vocab, (n, t)), 0)
        labels = np.where(tmask, np.roll(ids, -1, axis=1), -1)
        labels[:, -1] = -1
        vmask = (np.arange(v)[None] < rng.randint(1, v + 1, (n, 1)))
        return {"video_feature": rng.randn(n, v, cfg.video_feature_size
                                           ).astype(np.float32),
                "video_mask": vmask.astype(np.float32),
                "text_ids": ids.astype(np.int64),
                "text_mask": tmask.astype(np.float32),
                "text_labels": labels.astype(np.int64)}
    lead = (s, n) if cfg.recurrent else (n,)
    length = v + t
    ids = rng.randint(7, vocab, lead + (length,))
    mask = (np.arange(length) < rng.randint(v + 3, length + 1, lead + (1,)))
    labels = np.where(rng.rand(*lead, length) < 0.3, -1,
                      rng.randint(0, vocab, lead + (length,)))
    labels[..., :v] = -1
    labels = np.where(mask, labels, -1)
    ttys = np.concatenate([np.zeros(lead + (v,)), np.ones(lead + (t,))], -1)
    return {"input_ids": ids.astype(np.int64),
            "video_feature": rng.randn(*lead, length, cfg.video_feature_size
                                       ).astype(np.float32),
            "input_mask": mask.astype(np.float32),
            "token_type_ids": ttys.astype(np.int64),
            "input_labels": labels.astype(np.int64)}


def _caption_state_tensors(state) -> list:
    """Every tensor of a caption train state, in one order."""
    opt = state.optimizer
    return (list(opt.params.values()) + list(opt.mu.values())
            + list(opt.nu.values()) + list(state.ema.shadow.values())
            + [opt.step_count, opt.lr, state.step, state.seed])


def train_program_check(tag: str, cfg, vocab: int, sizes) -> dict:
    """One caption model on the card from seed 0 at its config's dropout:
    TRAIN_PROGRAM_STEPS steps through the captured programs and as many
    eager steps from an equal state, on the same batches (S cycling over
    `sizes`; None: a sentence batch) at lrs cycling over
    TRAIN_PROGRAM_LRS, each path alone (its wall ms a step, the trainer's
    one read included, and its peak memory). Every step's metrics and the
    whole state after them must be equal bit for bit, and each key's first
    call one step; the warm wall ms of each key apart. Then one warm step
    of each path on the last key traced: wall and device-busy ms, the
    host's kernel launches and graph launches, the port's kernels by name
    (B4 alone in both). Returns the record."""
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, caption_train_step_single,
        init_caption_train_state, train_programs)
    cuda = torch.device("cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    states = {}
    for eager in (True, False):
        mgr = build_mart_model_manager(cfg, vocab, cuda, seed=0,
                                       cache_dir=str(ROOT / "cache_caption"))
        states[eager] = init_caption_train_state(mgr.model, cfg, 0)
    step = caption_train_step if cfg.recurrent else caption_train_step_single
    keys = list(sizes) if sizes else [None]
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in _train_batch(
        cfg, vocab, s, cfg.train.batch_size, seed=i).items()}
        for i, s in enumerate(keys)]
    order = [(batches[i % len(batches)], TRAIN_PROGRAM_LRS[
        i % len(TRAIN_PROGRAM_LRS)]) for i in range(TRAIN_PROGRAM_STEPS)]
    run = {}
    for eager, state in states.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        rows, ms = [], []
        for i, (batch, lr) in enumerate(order):
            t0 = time.perf_counter()
            out = step(state, batch, lr, eager=eager)
            rows.append(torch.stack([out["loss"], out["n_word"],
                                     out["n_correct"],
                                     out["grad_norm"]]).tolist())
            ms.append((time.perf_counter() - t0) * 1e3)
            if not eager and i < len(batches) and int(state.step) != i + 1:
                fail(f"{tag}: the first call of key {i} took "
                     f"{int(state.step) - i} steps")
        run[eager] = {"rows": rows, "ms": ms,
                      "peak_gb": (torch.cuda.max_memory_allocated() - held)
                      / 1e9}
    same = run[True]["rows"] == run[False]["rows"] and all(
        torch.equal(a, b) for a, b in zip(
            _caption_state_tensors(states[True]),
            _caption_state_tensors(states[False])))
    cache = train_programs(states[False])
    warm = len(batches)  # steps past each key's first call
    rec = {"tag": tag, "keys": len(cache.programs),
           "captures": cache.captures, "equal": same, "sizes": keys}
    for eager, name in ((True, "eager"), (False, "program")):
        # the warm steps of each key (every len(batches)-th, past its first)
        rec[f"{name}_wall_ms"] = [statistics.median(
            run[eager]["ms"][warm + i::warm]) for i in range(warm)]
        rec[f"{name}_first_ms"] = run[eager]["ms"][:warm]
        rec[f"{name}_peak_gb"] = run[eager]["peak_gb"]
    for eager, name in ((True, "eager"), (False, "program")):
        batch, lr = order[warm - 1]  # the last (largest) key
        cuda_build.reset_launch_counts()
        wall, busy, kernels, events, host = _busy_ms(
            lambda: step(states[eager], batch, lr, eager=eager)[
                "loss"].item(), host=True)
        ports = _port_kernel_counts(events)
        rec.update({f"{name}_traced_ms": wall, f"{name}_busy_ms": busy,
                    f"{name}_kernels": kernels,
                    f"{name}_host_launches": host["kernel_launches"],
                    f"{name}_graph_launches": host["graph_launches"],
                    f"{name}_b4": ports.get("dropout", 0)})
        if set(ports) != {"dropout"}:
            fail(f"{tag}: a traced {name} step ran the port's kernels "
                 f"{ports}, not B4 alone")
        if eager:
            # the wrappers' counts of the eager step, by direction (a
            # replay runs no wrapper; by name the two are one kernel)
            rec["eager_b4_fwd"] = cuda_build.launch_counts["dropout"]
            rec["eager_b4_bwd"] = cuda_build.launch_counts["dropout_bwd"]
    rec["extra_peak_gb"] = rec["program_peak_gb"] - rec["eager_peak_gb"]
    def by_key(values):
        return ", ".join(f"{v:.2f}" for v in values)
    log(f"  {tag}: {len(order)} steps a path, {rec['keys']} program(s) "
        f"(S {list(keys)}), bit for bit equal to eager: {same}; warm step "
        f"wall by key {by_key(rec['program_wall_ms'])} ms through the "
        f"program / {by_key(rec['eager_wall_ms'])} eager (first calls "
        f"{', '.join(f'{v:.1f}' for v in rec['program_first_ms'])} / "
        f"{', '.join(f'{v:.1f}' for v in rec['eager_first_ms'])}); traced "
        f"step (S {keys[-1]}): wall {rec['program_traced_ms']:.2f} / "
        f"{rec['eager_traced_ms']:.2f} ms, device busy "
        f"{rec['program_busy_ms']:.2f} / {rec['eager_busy_ms']:.2f} ms "
        f"({rec['program_busy_ms'] / rec['program_traced_ms']:.1%} / "
        f"{rec['eager_busy_ms'] / rec['eager_traced_ms']:.1%} busy), "
        f"{rec['program_kernels']} / {rec['eager_kernels']} kernels on the "
        f"device, host kernel launches {rec['program_host_launches']} / "
        f"{rec['eager_host_launches']}, graph launches "
        f"{rec['program_graph_launches']} / {rec['eager_graph_launches']}, "
        f"B4 by name {rec['program_b4']} / {rec['eager_b4']} (the eager "
        f"step's wrappers: {rec['eager_b4_fwd']} forward + "
        f"{rec['eager_b4_bwd']} backward); peak memory "
        f"above the two states' {(torch.cuda.memory_allocated() - base) / 1e9:.3f} "
        f"GB: {rec['program_peak_gb']:.3f} / {rec['eager_peak_gb']:.3f} GB "
        f"(the programs' extra {rec['extra_peak_gb']:+.3f} GB)")
    if not same:
        fail(f"{tag}: the captured train steps differ from the eager ones")
    if rec["keys"] != len(batches) or rec["captures"] != len(batches):
        fail(f"{tag}: {rec['captures']} captures for {len(batches)} keys")
    if rec["program_b4"] != rec["eager_b4"] or rec["program_b4"] <= 0 \
            or rec["eager_b4_fwd"] + rec["eager_b4_bwd"] != rec["eager_b4"]:
        fail(f"{tag}: B4 ran {rec['program_b4']} times in a replay, "
             f"{rec['eager_b4']} eagerly by name, {rec['eager_b4_fwd']} + "
             f"{rec['eager_b4_bwd']} by the eager step's wrappers")
    del states, batches, order
    torch.cuda.empty_cache()
    return rec


def phase_train_programs() -> dict:
    """Phase 14, the caption train step as a captured program
    (tasks/caption/steps.py `train_programs`) for every caption model the
    CLI trains, each against the eager step from an equal state on the
    same batches (train_program_check): MART at
    yc2_2d3d_coot_vidclip_mart.yaml width over two sentence-step buckets
    (S = 4 and 12), raw-feature MART at yc2_mart.yaml, the TransformerXL
    (with and without xl_grad), the tied decoder, the untied and the joint
    models at phase 9's widths and the MTransformer at
    yc2_100m_coot_vidclip_mtrans.yaml, each from seed 0 at its yaml's
    dropout and batch size. Logs the phase's time against
    TRAIN_PROGRAMS_LIMIT_S. Returns {tag: record}; MART's record holds
    B4's launches by kernel name in a traced warm replay."""
    import json as _json
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    t_phase = time.time()
    vocab = len(_json.loads((ROOT / "annotations" / "youcook2" /
                             "mart_word2idx.json").read_text(
        encoding="utf8")))
    records = {}
    for tag, path, over, sizes in TRAIN_PROGRAM_MODELS:
        config = load_yaml_config_file(path)
        config.update(over)
        cfg = MartConfig(config)
        records[tag] = train_program_check(tag, cfg, vocab, sizes)
    log(f"  phase 14 took {time.time() - t_phase:.1f} s (budget "
        f"{TRAIN_PROGRAMS_LIMIT_S:.0f} s)")
    return records


# the synthetic retrieval splits, in the order the phases need them:
# split -> _yc2_dataset's (train videos, val videos, seed[, config])
DATA_SPLITS = {
    "val": (4, 128, 0),                                     # phase 3
    "train": (256, 64, 1),                                  # phase 4
    # tools/host_path.py's `generate`: VAL_VIDEOS 64, seed 2
    "host": (HOST_VIDEOS, 64, 2),                           # phase 10a
    "dp": (DP_TRAIN_VIDEOS, DP_VAL_VIDEOS, 5),              # phase 11
    "group": (640, 64, 2),                                  # phase 4c
    "serving_yc2_2d3d_coot": (4, 128, 0),                   # phase 13c
    **{f"serving_{name.split('.')[0]}": (                   # 13d, 13e
        4, SERVING_VAL_VIDEOS, i + 1, CONFIG.parent / name)
       for i, name in enumerate(SERVING_RETRIEVAL_CONFIGS)},
}

# The caption family shares nothing with the other phases: phases 6-8 and
# phase 9 run in two processes of their own (`--side-phases`), beside
# phases 2-4b and 10-12 of the main one. Phases 4c, 5 and 13, which time
# the card, run after them, alone on it.
SIDE_PHASES = (("6", "7", "8"), ("9",))
SIDE_THREADS = 4  # each side process's intra-op threads on the host
SIDE_PHASE = {
    "6": (phase_caption, "caption serving: MART at "
          "yc2_2d3d_coot_vidclip_mart width, greedy, over the YouCook2 val "
          "split"),
    "7": (phase_caption_train, "caption training: MART at "
          "yc2_2d3d_coot_vidclip_mart width on cuts of the YouCook2 train "
          "and val splits"),
    "8": (phase_caption_variants, "the caption variants of the shipped "
          "configs: raw-feature MART (yc2_mart) and the MTransformer "
          "(yc2_100m_coot_vidclip_mtrans), trained and served"),
    "9": (phase_caption_family, "the rest of the caption family at "
          "yc2_2d3d_coot_vidclip_mart width: beam search, the "
          "TransformerXL, the untied and joint single-sentence models and "
          "the tied decoder, trained and served"),
}


def side_main(numbers: str, start: float) -> None:
    """The side phases `numbers` ("6,7,8"), each in a temporary directory
    of its own; times are logged from `start`, the main process's."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.ops import cuda_build
    # two side processes and the main one share the host's cores
    torch.set_num_threads(SIDE_THREADS)
    phase_environment()
    cuda_build.build_library()
    cuda_build.load_library()
    for number in numbers.split(","):
        run, title = SIDE_PHASE[number]
        with tempfile.TemporaryDirectory(
                prefix=f"coot_chip_phase{number}_") as tmp:
            log(f"[{time.time() - start:.0f} s] == {number}. {title}")
            run(Path(tmp))


def _spawn_side(numbers, start: float, logs: Path) -> tuple:
    """Starts the side phases `numbers` in a process of their own, its
    output to a file under `logs`."""
    out = logs / f"phases_{'_'.join(numbers)}.log"
    with open(out, "w", encoding="utf8") as fh:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--side-phases",
             ",".join(numbers), repr(start)], cwd=ROOT, stdout=fh,
            stderr=subprocess.STDOUT)
    proc.log_path = out
    _CHILDREN.append(proc)
    return numbers, proc, out


def _join_side(side) -> None:
    """Waits for a side process, prints its log and fails with it."""
    numbers, proc, out = side
    t0 = time.time()
    rc = proc.wait()
    log(f"== phases {', '.join(numbers)}, which ran in a process of their "
        f"own beside phases 2-4b and 10-12 (waited {time.time() - t0:.1f} s "
        "more for them), logged:")
    text = out.read_text(encoding="utf8", errors="replace")
    sys.stdout.write(text if text.endswith("\n") else text + "\n")
    sys.stdout.flush()
    if rc != 0:
        failed = [line for line in text.splitlines() if "FAILED" in line]
        fail(f"phases {', '.join(numbers)} exited with {rc}: "
             f"{failed[-1] if failed else 'see their log above'}")


def main() -> None:
    if not (PACKAGE / "ops" / "cuda_build.py").is_file() \
            or not CONFIG.is_file():
        fail("run from a checkout of the repository (the port package and "
             "config/ are missing beside chip_smoke.py)")
    if sys.argv[1:2] == ["--side-phases"]:
        side_main(sys.argv[2], float(sys.argv[3]))
        return
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    start = time.time()
    atexit.register(_stop_children)
    # a stop from outside (SIGTERM) stops the workers and side phases too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    def phase(title: str) -> None:
        log(f"[{time.time() - start:.0f} s] == {title}")

    work = Path(tempfile.mkdtemp(prefix="coot_chip_work_"))
    _start_data(work)
    phase("1. environment")
    phase_environment()
    phase("2. kernels against their plain versions, forward and backward "
          f"(tolerance f32 {TOL['float32']}, bf16 {TOL['bfloat16']}, "
          "relative to max(1, max|plain|))")
    phase_build()
    log(f"phases {' and '.join(', '.join(n) for n in SIDE_PHASES)} start "
        "in processes of their own (their logs follow phase 12)")
    sides = [_spawn_side(numbers, start, work) for numbers in SIDE_PHASES]
    max_errors = phase_kernel_checks()
    max_errors["gather"] = phase_gather_checks()
    phase(f"2b. B3's bf16 backward over {B3_SEEDS} draws at each of its "
          "phase-2 shapes: rounding or a fault")
    phase_b3_seeds()
    with tempfile.TemporaryDirectory(prefix="coot_chip_smoke_") as tmp:
        phase("3. validation + embedding export at yc2_2d3d_coot width, "
              "four ways")
        phase_slice(Path(tmp) / "val")
        phase("4. training at yc2_2d3d_coot width")
        launches, shapes = phase_train(Path(tmp) / "train")
        phase("4b. synthetic_smoke.yaml trained on the card (ragged input "
              "FC widths, small GenPool)")
        phase_synthetic_smoke(Path(tmp) / "smoke")
    with tempfile.TemporaryDirectory(prefix="coot_chip_tail_") as tmp:
        phase("10. the prefetch pipeline and the tail: (a) the retrieval "
              "host path with prefetch at yc2_2d3d_coot width")
        phase_host_prefetch(Path(tmp) / "host")
        phase("10b. S3D at full width through the extractor, float32 "
              "and bfloat16")
        phase_s3d(Path(tmp) / "s3d")
        phase("10c. the MLP example")
        phase_mlp(Path(tmp) / "mlp")
        phase("10d. profiling")
        phase_profiling(Path(tmp) / "profiling")
    with tempfile.TemporaryDirectory(prefix="coot_chip_dp_") as tmp:
        phase("11. data parallelism at yc2_2d3d_coot width: W = 1 over "
              "NCCL, W = 2 over gloo on the card (retrieval and MART), "
              "torchrun")
        shared = phase_dp(Path(tmp))
        phase("12. tensor parallelism at yc2_2d3d_coot and "
              "yc2_2d3d_coot_vidclip_mart width: {data: 1, model: 2} over "
              "gloo on the card (retrieval, eval, checkpoint, MART, greedy)")
        phase_tp(Path(tmp), shared)
    for side in sides:
        _join_side(side)
    phase("the card is the main process's alone from here on")
    with tempfile.TemporaryDirectory(prefix="coot_chip_group_") as tmp:
        phase("4c. the group step: K train steps a dispatch, each a replay "
              "of the captured train step")
        phase_group(Path(tmp) / "group")
    phase(f"5. kernel timing at the training path's shapes {shapes}")
    kernels = phase_timing(launches, shapes, max_errors)
    with tempfile.TemporaryDirectory(prefix="coot_chip_serving_") as tmp:
        phase("13. serving graphs: the caption decodes and the retrieval "
              "and caption eval steps as CUDA graphs against eager, at full "
              "width")
        graph_launches = phase_serving_graphs(Path(tmp))
    phase("14. the caption train programs: every caption model's train "
          "step captured, against the eager step, at full width")
    programs = phase_train_programs()
    mart = programs["MART"]
    for entry in kernels:
        # the port's kernels on the device in a traced replay of the
        # captured yc2_2d3d_coot eval step, by name
        entry["eval_graph_launches"] = int(graph_launches.get(entry["name"],
                                                              0))
        # B4 in a traced warm replay of MART's captured train step, by
        # name: its forward and backward are one kernel function, so the
        # count (both directions) stands on `dropout` alone
        entry["caption_train_graph_launches"] = (
            mart["program_b4"] if entry["name"] == "dropout" else 0)
        # the same step run eagerly, by its wrappers' counts per direction
        entry["caption_train_eager_launches"] = {
            "dropout": mart["eager_b4_fwd"],
            "dropout_bwd": mart["eager_b4_bwd"]}.get(entry["name"], 0)
    _stop_children()
    log(f"chip_smoke took {time.time() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
