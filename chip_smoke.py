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
   ranks, and one batch against the port on the CPU in float32.
4. Training at full width (bf16 compute, f32 master weights, dropout 0.01
   at every site, frame noise 0.01): on a generated 256-video train split
   the CLI trains one epoch from the device store with on-device sampling
   and packing, validates and checkpoints, with every launch count set to
   0 just before and read just after; `--validate --load_epoch 0` reads
   the checkpoint back; the run resumes for 4 more epochs (16 steps),
   which time training end to end; the store with host-sampled index
   batches (the config's default, no --fixed_shapes) trains one epoch; the
   host dense path trains one epoch of 128 videos; one fixed id batch
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
   per step, train videos/s and peak device memory, and for K = 4 the
   device time per step by kernel family.
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
   train and eval, in turns with SDPA; B3's backward also at the
   paragraph's L = 320;
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
   least 98% of the greedy sentences token-identical); one greedy batch
   of 50 traced (wall and device-busy ms, launches per decoded token,
   device time by kernel family).

7. Caption training at the full width of yc2_2d3d_coot_vidclip_mart.yaml
   (batch 16, S up to 12 sentence steps, dropout 0.1 at every site, the
   EMA, BertAdam with warmup_linear): `python -m
   coot_videotext_tpu_torch.train_caption -c <yaml> --seed 0` in-process
   on the card over the first 320 videos of the YouCook2 train split (20
   steps an epoch) for 2 epochs, validating on the first 100 val videos,
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

Prints `{"kernels": [...]}` on the line before the last and
`{"ok": true, "device": {...}}` as the last line; exits non-zero (and
prints no result) on any failure, without a CUDA device, or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
            ("attention", dn, "local N=8192 L=80", 0.0,
             lambda dt=dtype: attention_inputs(1024, 8, 80, 80, 48, dt, gen,
                                               16)),
            ("attention", dn, "local N=8192 L=80 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(1024, 8, 80, 80, 48, dt, gen,
                                               16)),
            ("attention", dn, "global Lq=Lk=16", 0.0,
             lambda dt=dtype: attention_inputs(64, 8, 16, 16, 48, dt, gen,
                                               4)),
            ("attention", dn, "cross Lq=1 Lk=16", 0.0,
             lambda dt=dtype: attention_inputs(64, 8, 1, 16, 48, dt, gen, 4)),
            ("attention", dn, "paragraph Lq=Lk=300", 0.0,
             lambda dt=dtype: attention_inputs(64, 8, 300, 300, 48, dt, gen,
                                               2)),
            ("attention", dn, "sentences N=8192 L=24 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(1024, 8, 24, 24, 48, dt, gen,
                                               16)),
            ("attention", dn, "paragraph N=512 L=320 dropout 0.01", 0.01,
             lambda dt=dtype: attention_inputs(64, 8, 320, 320, 48, dt, gen,
                                               2)),
            ("attention", dn, "ragged Lq=37 Lk=130 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(64, 8, 37, 130, 48, dt, gen,
                                               2)),
            ("attention", dn, "video ctx N=512 L=80 dropout 0.01", 0.01,
             lambda dt=dtype: attention_inputs(64, 8, 80, 80, 48, dt, gen,
                                               2)),
            ("attention", dn, "Dh=16 Lq=37 Lk=130 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(64, 8, 37, 130, 16, dt, gen,
                                               2)),
            ("attention", dn, "Dh=64 Lq=37 Lk=130 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(64, 8, 37, 130, 64, dt, gen,
                                               2)),
            ("attention", dn, "cross Lq=1 Lk=130 dropout 0.1", 0.1,
             lambda dt=dtype: attention_inputs(64, 8, 1, 130, 48, dt, gen,
                                               2)),
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

    t0 = time.time()
    _yc2_dataset(tmp / "data", 4, 128, seed=0)
    log(f"generated the synthetic yc2-like set (128 val videos) in "
        f"{time.time() - t0:.1f} s")
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
            f"the eval step, peak device memory {peak_gb:.2f} GB")
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

    # ranks on the card == ranks on the host from the same similarities
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
        compute_dtype=gpu.val_dtype, **kw)
    t0 = time.time()
    e_cpu, _ = retrieval_eval_step(
        cpu.model, to_device(host_batch, torch.device("cpu")),
        compute_dtype=torch.float32, **kw)
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

    for what, batch, src in (("host dense", dev_batch, None),
                             ("id batch, store", id_batch, source)):
        def eval_step():
            retrieval_eval_step(gpu.model, batch, source=src,
                                compute_dtype=gpu.val_dtype, **kw)
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
        profile_step(eval_step, f"eval ({what})")
    del gpu, e_gpu, dev_batch, id_batch, source, id_loader
    torch.cuda.empty_cache()
    return [launches for launches, _ in runs]


KERNELS = ("input_fc", "input_fc_bwd", "genpool", "genpool_bwd",
           "attention", "attention_bwd", "dropout", "dropout_bwd", "gather")


def _yc2_dataset(root: Path, num_videos: int, num_val_videos: int,
                 seed: int) -> None:
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    ds = load_yaml_config_file(CONFIG)["dataset_train"]
    generate_retrieval_dataset(
        root, dataset_name=ds["name"], metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=num_videos,
        num_val_videos=num_val_videos, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=seed,
        feat_format="npy")


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
    (the config's default, without --fixed_shapes) trains one epoch; the
    host dense path trains one epoch of 128 videos; one fixed id
    batch trains 16 steps through B5."""
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

    t0 = time.time()
    _yc2_dataset(tmp / "data", 256, 64, seed=1)
    log(f"generated a yc2-like train split (256 videos, 64 val) in "
        f"{time.time() - t0:.1f} s")
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

    # the host dense path, at its earlier size: 128 train videos, 2 steps
    host_cfg = _config(tmp / "host", preload_device=False,
                       pack_transfer=False, max_datapoints=128)
    result, host_launches, wall = _train_cli(host_cfg, tmp, [])
    losses, state = result["step_losses"], result["state"]
    if len(losses) != 2 or host_launches.get("gather", 0) or \
            result["layout"] != "dense":
        fail(f"host path: losses {losses}, launches {host_launches}")
    log(f"CLI (host dense): 1 epoch of {len(losses)} steps in {wall:.1f} s; "
        f"epoch time {state['time_total']:.2f} s of which validation "
        f"{state['time_val']:.2f} s; "
        f"{128 / (state['time_total'] - state['time_val']):.2f} train "
        f"videos/s end to end; launches {host_launches}")

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


def _caption_inputs(tmp: Path, cfg) -> tuple:
    """COOT embeddings from a seed for every video and clip of the real
    YouCook2 caption splits, as `yc2_2d3d_coot_{train,val}.npz` in the
    export schema (rows of unit length, the config's widths), and the
    port's model at the config's width from seed 0 with GloVe applied,
    saved as a reference-layout `{"model": state_dict}`. Returns the
    embedding dir, the checkpoint and the val annotations."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager, load_glove_matrix)
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
    videos on the card against the port on the CPU; (d) one greedy batch
    of 50 videos traced with torch.profiler."""
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
        f"{statistics.median(result['decode_ms']):.2f} ms; full forwards "
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

    log("(d) one greedy batch of 50 val videos under torch.profiler")
    stacked, sizes, _ = dataset.collate_fn(
        [dataset[i] for i in range(cfg.val.batch_size)])
    batch = [torch.from_numpy(stacked[k]).cuda() for k in
             ("input_ids", "video_feature", "input_mask", "token_type_ids")]
    translator = Translator(profile_model, profile_cfg)
    translator.translate_batch_greedy(*batch)  # warm
    wall_ms, busy_ms, kernels, events = _busy_ms(
        lambda: translator.translate_batch_greedy(*batch))
    steps = len(stacked["input_ids"])
    positions = steps * cfg.max_t_len
    log(f"  S {steps} sentence steps x {cfg.max_t_len} token positions, "
        f"{translator.forwards} full forwards of N {cfg.val.batch_size} x "
        f"L {cfg.max_v_len + cfg.max_t_len}: wall {wall_ms:.1f} ms, device "
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
# 16, 2 val batches of 50
CAPTION_TRAIN_CUTS = {"dataset_train.max_datapoints": 320,
                      "dataset_val.max_datapoints": 100}
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
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_loss_and_grads, caption_train_step, caption_update,
        init_caption_train_state)
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
    stacked, _, _ = dataset.collate_fn([dataset[i] for i in range(8)])
    seen = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        mgr = build_mart_model_manager(config(), len(dataset.word2idx),
                                       device, seed=1)
        mgr.load_state(weights)
        state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
        batch = {k: torch.from_numpy(stacked[k]).to(device)
                 for k in STACKED_KEYS}
        rec = {"metrics": [], "states": []}
        for step in range(3):
            metrics, grads = caption_loss_and_grads(state, batch)
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
            fail(f"caption training: step {step} on the card disagrees with "
                 "the CPU")
    scale = max(float(v.abs().max()) for v in cpu["grads"].values())
    grad_err = _max_diff(gpu["grads"], cpu["grads"]) / scale
    worst = max(cpu["grads"], key=lambda n: float(
        (gpu["grads"][n] - cpu["grads"][n]).abs().max()))
    log(f"  gradients: max |card - CPU| {grad_err:.2e} of the largest "
        f"gradient {scale:.4f} (limit {CAPTION_TRAIN_GRAD_TOL}; worst "
        f"{worst}) over {len(cpu['grads'])} tensors")
    if grad_err > CAPTION_TRAIN_GRAD_TOL:
        fail("caption training: the card's gradients disagree with the "
             "CPU's")
    for i, k in enumerate((1, 3)):
        for what in ("params", "ema"):
            err = _max_diff(gpu["states"][i][what], cpu["states"][i][what])
            share = err / CAPTION_TRAIN_LR / k
            log(f"  after {k} step(s): {what} max |card - CPU| {err:.3e} "
                f"= {share:.2%} of lr per step (limit "
                f"{CAPTION_TRAIN_UPDATE_TOL:.0%})")
            if share > CAPTION_TRAIN_UPDATE_TOL:
                fail(f"caption training: the card's {what} after {k} steps "
                     "disagree with the CPU's")
    del seen, gpu, cpu
    torch.cuda.empty_cache()

    log("(d) one train batch of 16 videos trained 16 steps at lr "
        f"{CAPTION_TRAIN_LR} on the card, timed and traced")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mgr = build_mart_model_manager(config(), len(dataset.word2idx),
                                   torch.device("cuda"), seed=1)
    mgr.load_state(weights)
    state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
    stacked, _, _ = dataset.collate_fn(
        [dataset[i] for i in range(cfg.train.batch_size)])
    batch = {k: torch.from_numpy(stacked[k]).cuda() for k in STACKED_KEYS}
    step_losses, step_ms = [], []
    for _ in range(16):
        t0 = time.perf_counter()
        metrics = caption_train_step(state, batch, CAPTION_TRAIN_LR)
        step_losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in step_losses) \
            or step_losses[-1] >= step_losses[0]:
        fail(f"caption training: a fixed batch's loss did not fall: "
             f"{step_losses}")
    warm = statistics.median(step_ms[4:])
    sentences = len(stacked["input_ids"])
    log(f"  S {sentences} sentence steps x N {cfg.train.batch_size} x L "
        f"{cfg.max_v_len + cfg.max_t_len}; losses "
        f"{', '.join(f'{v:.2f}' for v in step_losses)}")
    log(f"  warm train step: median wall {warm:.2f} ms over steps 5-16 "
        f"({', '.join(f'{v:.1f}' for v in step_ms)}); "
        f"{cfg.train.batch_size / warm * 1e3:.1f} train videos/s")
    cuda_build.reset_launch_counts()
    wall_ms, busy_ms, kernels, events = _busy_ms(
        lambda: caption_train_step(state, batch, CAPTION_TRAIN_LR))
    traced = dict(cuda_build.launch_counts)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    b4 = [e for e in events if "dropout" in e.key]
    log(f"  one traced step: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); {kernels} kernel "
        f"launches; B4 {traced.get('dropout', 0)} forward + "
        f"{traced.get('dropout_bwd', 0)} backward launches, "
        f"{sum(_dev_us(e) for e in b4) / 1e3:.3f} ms of device time over "
        f"{sum(e.count for e in b4)} launches; peak device memory "
        f"{peak:.3f} GB above the {held / 1e9:.3f} GB held before")
    log_families(events, 1)
    del mgr, state, batch
    torch.cuda.empty_cache()

    log("(e) B4 at the caption shapes, float32, rate "
        f"{cfg.hidden_dropout_prob}")
    caption_dropout_timing(cfg.hidden_dropout_prob)


def caption_dropout_timing(rate: float) -> None:
    """B4 in float32 at the hidden rows and the attention probabilities of
    a caption train step: held bit-equal to dropout_plain forward and
    backward, then timed forward and backward (CUDA events), bare and
    through the wrapper / autograd, beside F.dropout, and its bound."""
    import torch
    import torch.nn.functional as F
    from coot_videotext_tpu_torch.ops import cuda_build, philox
    from coot_videotext_tpu_torch.ops import dropout as b4
    gen = torch.Generator(device="cuda").manual_seed(7)
    seed = device_seed()
    for shape in CAPTION_DROPOUT_SHAPES:
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


def _busy_ms(fn) -> tuple:
    """(traced wall ms, device-busy ms, kernels seen, the kernels' profiler
    events) of fn() under torch.profiler, synchronised: the busy time sums
    the kernels' device time, graph replays' kernels included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    return (wall, sum(_dev_us(e) for e in events) / 1e3,
            sum(e.count for e in events), events)


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
    t0 = time.time()
    _yc2_dataset(tmp / "data", 640, 64, seed=2)
    log(f"generated a yc2-like train split (640 videos, 64 val) in "
        f"{time.time() - t0:.1f} s")
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
    # one round of warm-up (the capture included), then 8 steps traced
    timing = {}
    for k in (1, 4, 8):
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
        traced, busy, kernels, events = _busy_ms(lambda: steps(8))
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(walls)
        timing[k] = dict(wall_ms=med, busy_ms=busy / 8, traced_ms=traced / 8,
                         videos_s=b / med * 1e3, peak_gb=peak)
        log(f"K={k}: warm wall per step {med:.2f} ms (rounds of 16: "
            f"{', '.join(f'{w:.2f}' for w in walls)}), {b / med * 1e3:.1f} "
            f"train videos/s; traced 8 steps: {traced / 8:.2f} ms per step "
            f"wall, device busy {busy / 8:.2f} ms per step "
            f"({kernels} kernels, {100 * busy / traced:.1f}% busy); peak "
            f"device memory {peak:.2f} GB")
        if busy <= 0:
            fail(f"K={k}: the profiler saw no device time")
        if k == 4:
            log("  K=4, device time per step by kernel family:")
            log_families(events, 8)
        del ts, dev, events
        torch.cuda.empty_cache()
    return timing


def profile_step(step_fn, what: str) -> None:
    """One warm step under torch.profiler: the device's busy share of the
    step and the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        step_fn()
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        traced_ms = (time.perf_counter() - t0) * 1e3

    # kernel entries only: CPU ops also carry their kernels' device time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
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
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0:
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
    # B3 backward at the clips (the kernels line) and at the paragraph
    # local net's call (L = lp, 320): through autograd in turns with SDPA's
    # backward, and the profiler's device time per backward call
    for what, b_, length in (("clips", rows, lc),
                             ("paragraph", shapes["b"], shapes["lp"])):
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


def main() -> None:
    if not (PACKAGE / "ops" / "cuda_build.py").is_file() \
            or not CONFIG.is_file():
        fail("run from a checkout of the repository (the port package and "
             "config/ are missing beside chip_smoke.py)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    start = time.time()
    log("== 1. environment")
    phase_environment()
    log("== 2. kernels against their plain versions, forward and backward "
        f"(tolerance f32 {TOL['float32']}, bf16 {TOL['bfloat16']}, "
        "relative to max(1, max|plain|))")
    phase_build()
    max_errors = phase_kernel_checks()
    max_errors["gather"] = phase_gather_checks()
    with tempfile.TemporaryDirectory(prefix="coot_chip_smoke_") as tmp:
        log("== 3. validation + embedding export at yc2_2d3d_coot width, "
            "four ways")
        phase_slice(Path(tmp) / "val")
        log("== 4. training at yc2_2d3d_coot width")
        launches, shapes = phase_train(Path(tmp) / "train")
        log("== 4b. synthetic_smoke.yaml trained on the card (ragged input "
            "FC widths, small GenPool)")
        phase_synthetic_smoke(Path(tmp) / "smoke")
        log("== 4c. the group step: K train steps a dispatch, each a replay "
            "of the captured train step")
        phase_group(Path(tmp) / "group")
    log(f"== 5. kernel timing at the training path's shapes {shapes}")
    kernels = phase_timing(launches, shapes, max_errors)
    with tempfile.TemporaryDirectory(prefix="coot_chip_caption_") as tmp:
        log("== 6. caption serving: MART at yc2_2d3d_coot_vidclip_mart "
            "width, greedy, over the YouCook2 val split")
        phase_caption(Path(tmp))
    with tempfile.TemporaryDirectory(prefix="coot_chip_caption_train_") \
            as tmp:
        log("== 7. caption training: MART at yc2_2d3d_coot_vidclip_mart "
            "width on cuts of the YouCook2 train and val splits")
        phase_caption_train(Path(tmp))
    log(f"chip_smoke took {time.time() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
