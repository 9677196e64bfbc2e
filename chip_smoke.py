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
   Lq = 1, dropout on with one seed: the masks must agree exactly; B5
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
5. Times each kernel, forward and backward, at the main path's shapes (CUDA
   events) beside its plain version, its library yardstick where one
   exists, and its bound; B5 at each store gather of a step, with and
   without noise.

Prints `{"kernels": [...]}` on the line before the last and
`{"ok": true, "device": {...}}` as the last line; exits non-zero (and
prints no result) on any failure, without a CUDA device, or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "coot_videotext_tpu_torch"
CONFIG = ROOT / "config" / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"

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
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        return math.inf, math.inf
    err = float((out - ref).abs().max())
    return err, err / max(1.0, float(ref.abs().max()))


# ---------------- kernel inputs ----------------

def input_fc_inputs(s, din, dout, dtype, gen, constant_rows=0):
    import torch
    dev = "cuda"
    x = torch.randn(s, din, generator=gen, device=dev) * 2.0 + 0.5
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


def _grads(fn, inputs, dout):
    """Gradients of fn's output against dout through the autograd
    Function (the backward kernel on CUDA tensors)."""
    import torch
    inputs = [a.detach().clone().requires_grad_() for a in inputs]
    out = fn(*inputs)
    torch.autograd.backward(out, dout.to(out.dtype))
    return [a.grad for a in inputs]


def backward_case(name, args, rate, gen):
    """(kernel gradients, plain gradients) of one backward case; the
    differentiable inputs are f32 parameters (and f / q, k, v in the
    compute dtype), as on the main path."""
    import torch
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_backward_plain)
    from coot_videotext_tpu_torch.ops.genpool import (
        genpool, genpool_backward_plain)
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_backward_plain)
    seed = 20261016
    if name == "input_fc":
        x, *params = args
        params = [p.float() for p in params]
        dy = torch.randn(x.shape[0], params[2].shape[0], generator=gen,
                         device="cuda")
        ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"),
                      params, dy)
        ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                            dy.to(x.dtype))
    elif name == "genpool":
        f, mask, *params = args
        params = [p.float() for p in params]
        dout = torch.randn(f.shape[0], f.shape[2], generator=gen,
                           device="cuda")
        ours = _grads(lambda f_, *p: genpool(f_, mask, *p, "gelu", rate,
                                             seed), [f] + params, dout)
        ref = genpool_backward_plain(f, mask, *params, "gelu",
                                     dout.to(f.dtype), rate, seed)
    else:
        q, k, v, kv = args
        g = torch.randn(q.shape, generator=gen, device="cuda")
        ours = _grads(lambda *a: masked_attention(*a, kv, 8, 48 ** -0.5,
                                                  rate, seed), [q, k, v], g)
        ref = masked_attention_backward_plain(q, k, v, kv, g.to(q.dtype), 8,
                                              48 ** -0.5, rate, seed)
    return ours, list(ref)


def phase_kernel_checks():
    """Each kernel, forward and backward, against its plain version on the
    card; B4 and the dropout of B2/B3 with one seed, where the masks must
    agree exactly."""
    import torch
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
        ]
    seed = 20261016
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
        tol = TOL[dn]
        log(f"  {name:13s} {dn:8s} {desc:34s} max abs err {err:.3e}, "
            f"relative {rel:.3e} (tol {tol:.0e})")
        if not rel <= tol:
            fail(f"{name} {dn} {desc}: error {rel} > {tol}")
        if dn == "bfloat16":
            worst[name] = max(worst.get(name, 0.0), err)

    for name, dn, desc, rate, make in cases:
        args = make()
        kern, plain = funcs[name]
        with torch.inference_mode():
            out = kern(args, rate)
            torch.cuda.synchronize()
            record(name, dn, desc, *errors(out, plain(args, rate)))
        ours, ref = backward_case(name, args, rate, gen)
        torch.cuda.synchronize()
        errs = [errors(a, r) for a, r in zip(ours, ref)]
        record(name + "_bwd", dn, desc, max(e[0] for e in errs),
               max(e[1] for e in errs))
        if name == "attention" and desc.startswith("local"):
            # all-masked batch rows: no score gradient, so dq = dk = 0
            if float(ours[0][:16 * 8].abs().max()) != 0.0:
                fail("attention_bwd: dq is not 0 on all-masked rows")
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
            record("dropout", dn, desc, *errors(y, y_ref))
            record("dropout_bwd", dn, desc, *errors(gx, g_ref))
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
                noise = GatherNoise(0.01, 20261016, philox.SITE_NOISE_CLIP)
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
    noise = GatherNoise(1.0, 7, philox.SITE_NOISE_VIDEO)
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
        torch.Generator().manual_seed(0),
        torch.Generator("cuda").manual_seed(0),
        sample=torch.Generator("cuda").manual_seed(0))
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernel entries only: CPU ops also carry their kernels' device time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"traced {what} step: {traced_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%); top device "
        "time:")
    for e in sorted(events, key=dev_us, reverse=True)[:16]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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
            bound_by=by))

    # B1
    s = rows * lc
    x, *params = input_fc_inputs(s, din, d, bf, gen)
    params = [p.float() for p in params]
    with torch.inference_mode():
        fwd = time_ms(lambda: fused_input_fc(x, *params, 1e-6, "gelu"))
        plain = time_ms(lambda: fused_input_fc_plain(x, *params, 1e-6,
                                                     "gelu"))
    entry("input_fc", f"S={s} {din}->{d} bf16", "input_fc.cu",
          "pallas_input_fc.py:207", fwd, plain, None,
          2 * s * din + 8 * din + 2 * d * din + 4 * d + 2 * s * d,
          2.0 * s * din * d)
    leaves = [p.clone().requires_grad_() for p in params]
    y = fused_input_fc(x, *leaves, 1e-6, "gelu")
    dy = torch.randn(s, d, generator=gen, device="cuda").to(bf)
    entry("input_fc_bwd", f"S={s} {din}->{d} bf16", "input_fc.cu",
          "pallas_input_fc.py:284", _bwd_ms(y, leaves, dy),
          time_ms(lambda: fused_input_fc_backward_plain(
              x, *params, 1e-6, "gelu", dy)), None,
          2 * s * din + 2 * s * d + 4 * s * d + 2 * din * d + 8 * s
          + 4 * (din * d + d + 2 * din), 4.0 * s * din * d)
    del x, params, leaves, y, dy
    # B2
    f, mask, *params = genpool_inputs(rows, lc, d, h, heads, bf, gen)
    params = [p.float() for p in params]
    rate, seed = 0.01, 20261016
    with torch.inference_mode():
        fwd = time_ms(lambda: genpool(f, mask, *params, "gelu", rate, seed))
        plain = time_ms(lambda: genpool_plain(f, mask, *params, "gelu",
                                              rate, seed))
    r = rows * lc
    weights = 2 * d * h + 2 * h * dho + 4 * (h + d)
    entry("genpool", f"S={rows} L={lc} D={d} H={h} bf16 drop {rate}",
          "genpool.cu", "pallas_genpool.py:284", fwd, plain, None,
          2 * r * d + r + weights + 2 * rows * d,
          2.0 * r * (d * h + h * dho))
    fl = f.clone().requires_grad_()
    leaves = [p.clone().requires_grad_() for p in params]
    y = genpool(fl, mask, *leaves, "gelu", rate, seed)
    dout = torch.randn(rows, d, generator=gen, device="cuda").to(bf)
    entry("genpool_bwd", f"S={rows} L={lc} D={d} H={h} bf16 drop {rate}",
          "genpool.cu", "pallas_genpool.py:358",
          _bwd_ms(y, [fl] + leaves, dout),
          time_ms(lambda: genpool_backward_plain(f, mask, *params, "gelu",
                                                 dout, rate, seed)), None,
          2 * r * d + r + weights + 2 * rows * d + 12 * rows * d
          + 2 * r * d + 2 * weights,
          2.0 * r * (3 * d * h + 3 * h * dho))
    del f, fl, mask, params, leaves, y, dout
    # B3
    q, k, v, kv = attention_inputs(rows, 8, lc, lc, dh, bf, gen)
    n = rows * 8
    rate = 0.01
    add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
        8, dim=0)[:, None, :]
    with torch.inference_mode():
        fwd = time_ms(lambda: masked_attention(q, k, v, kv, 8, dh ** -0.5,
                                               rate, seed))
        plain = time_ms(lambda: masked_attention_plain(
            q, k, v, kv, 8, dh ** -0.5, rate, seed))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=add_mask, dropout_p=rate, scale=dh ** -0.5))
    entry("attention", f"N={n} L={lc} Dh={dh} bf16 drop {rate}",
          "attention.cu", "pallas_attention.py:114", fwd, plain, lib,
          2 * 4 * n * lc * dh + rows * lc, 4.0 * n * lc * lc * dh)
    qkv = [a.clone().requires_grad_() for a in (q, k, v)]
    y = masked_attention(*qkv, kv, 8, dh ** -0.5, rate, seed)
    g = torch.randn(n, lc, dh, generator=gen, device="cuda").to(bf)
    qkv_lib = [a.clone().requires_grad_() for a in (q, k, v)]
    y_lib = F.scaled_dot_product_attention(
        *qkv_lib, attn_mask=add_mask, dropout_p=rate, scale=dh ** -0.5)
    entry("attention_bwd", f"N={n} L={lc} Dh={dh} bf16 drop {rate}",
          "attention.cu", "pallas_attention.py:158", _bwd_ms(y, qkv, g),
          time_ms(lambda: masked_attention_backward_plain(
              q, k, v, kv, g, 8, dh ** -0.5, rate, seed)),
          _bwd_ms(y_lib, qkv_lib, g),
          2 * 8 * n * lc * dh + rows * lc + 8 * n * lc,
          10.0 * n * lc * lc * dh)
    del q, k, v, qkv, qkv_lib, y, y_lib, g
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
    entry("dropout_bwd", f"{rows * lc}x{d} bf16 rate 0.01", "dropout.cu",
          "pallas_dropout.py:121", _bwd_ms(y, [xl], x),
          time_ms(lambda: dropout_plain(x, seed, 0.01)),
          _bwd_ms(y_lib, [xl_lib], x), 4 * numel, 1.0 * numel)
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
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
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
    log(f"== 5. kernel timing at the training path's shapes {shapes}")
    kernels = phase_timing(launches, shapes, max_errors)
    log(f"chip_smoke took {time.time() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
