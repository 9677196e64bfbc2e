#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port on one NVIDIA H100:

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch/CUDA versions,
   compute capability (sm_90 required); TF32 is switched off so every
   float32 reference is full float32.
2. Kernels: builds the CUDA sources of coot_videotext_tpu_torch/csrc with
   nvcc (sm_90a) and holds each kernel (B1 input FC, B2 GenPool, B3 masked
   attention) against its plain PyTorch version on the card, in bfloat16
   and float32, at the slice's shapes and edge cases.
3. The slice at full width: generates a synthetic YouCook2-like val set
   (4096-d video / 1536-d text features, 128 val videos) in a temporary
   directory and runs `python -m coot_videotext_tpu_torch.train_retrieval
   -c config/retrieval/paper2020/yc2_2d3d_coot.yaml --validate
   --ignore_untrained --save_embeddings` in-process, with every kernel's
   launch count set to 0 just before and read just after; checks finite
   embeddings, device ranks against host ranks, and one batch against the
   port on the CPU in float32.
4. Times each kernel at the main path's shapes (CUDA events) beside its
   plain version, its library yardstick where one exists, and its bound.

Prints `{"kernels": [...]}` on the line before the last and
`{"ok": true, "device": {...}}` as the last line; exits non-zero (and
prints no result) on any failure, without a CUDA device, or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
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
NPY_SOURCES = ("dataset_train.vid_feat_source=npy,"
               "dataset_train.text_feat_source=npy")
# One batch on the card in bfloat16 against the CPU in float32: cosine
# of each embedding row.
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
    for line in report.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log("  ptxas: " + line.strip()[:160])


def phase_kernel_checks():
    """Each kernel against its plain version on the card."""
    import torch
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain)
    from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"input_fc": 0.0, "genpool": 0.0, "attention": 0.0}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases += [
            ("input_fc", dn, "video clips S=81920 4096->384",
             lambda dt=dtype: input_fc_inputs(81920, 4096, 384, dt, gen, 5)),
            ("input_fc", dn, "text, ragged S=1001 1536->384",
             lambda dt=dtype: input_fc_inputs(1001, 1536, 384, dt, gen, 3)),
            ("genpool", dn, "clips S=1024 L=80",
             lambda dt=dtype: genpool_inputs(1024, 80, 384, 768, 2, dt, gen,
                                             16)),
            ("genpool", dn, "paragraph S=37 L=300",
             lambda dt=dtype: genpool_inputs(37, 300, 384, 768, 2, dt, gen,
                                             2)),
            ("genpool", dn, "L=1",
             lambda dt=dtype: genpool_inputs(64, 1, 384, 768, 2, dt, gen)),
            ("attention", dn, "local N=8192 L=80",
             lambda dt=dtype: attention_inputs(1024, 8, 80, 80, 48, dt, gen,
                                               16)),
            ("attention", dn, "global Lq=Lk=16",
             lambda dt=dtype: attention_inputs(64, 8, 16, 16, 48, dt, gen,
                                               4)),
            ("attention", dn, "cross Lq=1 Lk=16",
             lambda dt=dtype: attention_inputs(64, 8, 1, 16, 48, dt, gen, 4)),
            ("attention", dn, "paragraph Lq=Lk=300",
             lambda dt=dtype: attention_inputs(64, 8, 300, 300, 48, dt, gen,
                                               2)),
        ]
    funcs = {
        "input_fc": (lambda a: fused_input_fc(*a, 1e-6, "gelu"),
                     lambda a: fused_input_fc_plain(*a, 1e-6, "gelu")),
        "genpool": (lambda a: genpool(*a, "gelu"),
                    lambda a: genpool_plain(*a, "gelu")),
        "attention": (lambda a: masked_attention(*a, 8, 48 ** -0.5),
                      lambda a: masked_attention_plain(*a, 8, 48 ** -0.5)),
    }
    with torch.inference_mode():
        for name, dn, desc, make in cases:
            args = make()
            kern, plain = funcs[name]
            out = kern(args)
            torch.cuda.synchronize()
            ref = plain(args)
            err, rel = errors(out, ref)
            tol = TOL[dn]
            log(f"  {name:9s} {dn:8s} {desc:32s} max abs err {err:.3e}, "
                f"relative {rel:.3e} (tol {tol:.0e})")
            if not rel <= tol:
                fail(f"{name} {dn} {desc}: error {rel} > {tol}")
            if dn == "bfloat16":
                worst[name] = max(worst[name], err)
            del args, out, ref
    torch.cuda.empty_cache()
    return worst


def phase_slice(tmp: Path):
    """The validation + embedding export path at full width."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch import train_retrieval
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)

    cfg_dict = load_yaml_config_file(CONFIG)
    ds = cfg_dict["dataset_train"]
    t0 = time.time()
    generate_retrieval_dataset(
        tmp / "data", dataset_name=ds["name"],
        metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=4,
        num_val_videos=128, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=0,
        feat_format="npy")
    log(f"generated the synthetic yc2-like set (128 val videos) in "
        f"{time.time() - t0:.1f} s")

    # the features as .npy files and the embeddings as .npz: the card's
    # machine has no h5py; the arrays and their names are the h5 schema's
    argv = ["-c", str(CONFIG), "--validate", "--ignore_untrained",
            "--save_embeddings", "--data_path", str(tmp / "data"),
            "--log_dir", str(tmp / "experiments"), "-o", NPY_SOURCES,
            "--embeddings_format", "npz"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.time()
    results = train_retrieval.main(argv)[0]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path launches: {launches}")
    for name in ("input_fc", "genpool", "attention"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")

    embs = results["embeddings"]
    for key, arr in embs.items():
        if not np.isfinite(arr).all():
            fail(f"non-finite values in {key}")
    n_vid = results["num_videos"]
    if n_vid != 128 or embs["vid_emb"].shape != (128, 768):
        fail(f"unexpected embeddings {embs['vid_emb'].shape}")
    with np.load(results["emb_file"]) as saved:
        expect = {"clip_num", "sent_num", "key"} | {
            f"{k}{s}" for k in embs for s in ("", "_before_norm")}
        if set(saved.files) != expect or len(saved["key"]) != n_vid:
            fail(f"embedding file {results['emb_file']} lacks the schema")
    log(f"v2p {results['v2p']} c2s {results['c2s']}")
    batches = results["num_batches"]
    log(f"validation: {n_vid} videos in {batches} batches, "
        f"{n_vid / results['total_s']:.2f} videos/s end to end "
        f"(pass {results['total_s']:.2f} s, main() {wall:.2f} s), "
        f"{results['forward_s'] / batches * 1e3:.2f} ms per batch on the "
        f"device (eval step), peak device memory {peak_gb:.2f} GB")

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
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        EMB_KEYS, retrieval_eval_step)
    cfg_dict = load_yaml_config_file(CONFIG)
    for key in ("vid_feat_source", "text_feat_source"):
        cfg_dict["dataset_train"][key] = "npy"
    cfg = RetrievalConfig(cfg_dict, is_train=False)
    _, _, _, loader = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0)
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
    profile_eval_step(gpu, to_device(host_batch, torch.device("cuda")), kw)
    shapes = {
        "b": host_batch["clip_feat"].shape[0],
        "n_parts": host_batch["clip_feat"].shape[1],
        "lc": host_batch["clip_feat"].shape[2],
        "din": host_batch["clip_feat"].shape[3],
    }
    del gpu, e_gpu
    torch.cuda.empty_cache()
    return launches, shapes


def profile_eval_step(mgr, batch, kw) -> None:
    """The eval step on a warm card: wall time of 5 runs, then one run
    under torch.profiler for the device time by kernel and the device's
    busy share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        retrieval_eval_step)

    def step():
        retrieval_eval_step(mgr.model, batch, compute_dtype=mgr.val_dtype,
                            **kw)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    log(f"eval step on a warm card (batch 0, 5 runs): median "
        f"{walls[2]:.2f} ms, min {walls[0]:.2f}, max {walls[-1]:.2f}")
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
    log(f"traced eval step: {traced_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%); top device "
        "time:")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_timing(launches, shapes, max_errors):
    """Kernel, plain version and library yardstick at the main path's
    largest call of each kernel (the video clips through the local net)."""
    import torch
    import torch.nn.functional as F
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain)
    from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_plain)
    from coot_videotext_tpu_torch.typext import INF
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    rows = shapes["b"] * shapes["n_parts"]
    lc, din, d, h, heads, dh = shapes["lc"], shapes["din"], 384, 768, 2, 48
    entries = []
    with torch.inference_mode():
        # B1
        s = rows * lc
        a = input_fc_inputs(s, din, d, bf, gen)
        nbytes = 2 * s * din + 8 * din + 2 * d * din + 4 * d + 2 * s * d
        bms, by = bound_ms(nbytes, 2.0 * s * din * d, "bfloat16")
        entries.append(dict(
            name="input_fc", shape=f"S={s} {din}->{d} bf16",
            source="coot_videotext_tpu_torch/csrc/input_fc.cu",
            replaces="coot_videotext_tpu/ops/pallas_input_fc.py:207",
            ms=time_ms(lambda: fused_input_fc(*a, 1e-6, "gelu")),
            plain_ms=time_ms(lambda: fused_input_fc_plain(*a, 1e-6, "gelu")),
            library_ms=None, bound_ms=bms, bound_by=by))
        del a
        # B2
        a = genpool_inputs(rows, lc, d, h, heads, bf, gen)
        dho = d // heads
        nbytes = (2 * rows * lc * d + rows * lc + 2 * d * h + 2 * h * dho
                  + 4 * (h + d) + 2 * rows * d)
        flops = 2.0 * rows * lc * (d * h + h * dho)
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        entries.append(dict(
            name="genpool", shape=f"S={rows} L={lc} D={d} H={h} bf16",
            source="coot_videotext_tpu_torch/csrc/genpool.cu",
            replaces="coot_videotext_tpu/ops/pallas_genpool.py:284",
            ms=time_ms(lambda: genpool(*a, "gelu")),
            plain_ms=time_ms(lambda: genpool_plain(*a, "gelu")),
            library_ms=None, bound_ms=bms, bound_by=by))
        del a
        # B3
        q, k, v, kv = attention_inputs(rows, 8, lc, lc, dh, bf, gen)
        n = rows * 8
        nbytes = 2 * 2 * n * lc * dh + 2 * 2 * n * lc * dh + rows * lc
        bms, by = bound_ms(nbytes, 4.0 * n * lc * lc * dh, "bfloat16")
        add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        entries.append(dict(
            name="attention", shape=f"N={n} L={lc} Dh={dh} bf16",
            source="coot_videotext_tpu_torch/csrc/attention.cu",
            replaces="coot_videotext_tpu/ops/pallas_attention.py:114",
            ms=time_ms(lambda: masked_attention(q, k, v, kv, 8,
                                                dh ** -0.5)),
            plain_ms=time_ms(lambda: masked_attention_plain(
                q, k, v, kv, 8, dh ** -0.5)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add_mask, scale=dh ** -0.5)),
            bound_ms=bms, bound_by=by))
    for e in entries:
        e["route"] = "cuda"
        e["launches"] = int(launches.get(e["name"], 0))
        e["max_abs_err"] = max_errors[e["name"]]
        log(f"  {e['name']:9s} {e['shape']:34s} kernel {e['ms']:.3f} ms, "
            f"plain {e['plain_ms']:.3f} ms, library {e['library_ms']}, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
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
    log("== 1. environment")
    phase_environment()
    log("== 2. kernels against their plain versions "
        f"(tolerance f32 {TOL['float32']}, bf16 {TOL['bfloat16']}, "
        "relative to max(1, max|plain|))")
    phase_build()
    max_errors = phase_kernel_checks()
    log("== 3. validation + embedding export at yc2_2d3d_coot width")
    with tempfile.TemporaryDirectory(prefix="coot_chip_smoke_") as tmp:
        launches, shapes = phase_slice(Path(tmp))
    log(f"== 4. kernel timing at the main path's shapes {shapes}")
    kernels = phase_timing(launches, shapes, max_errors)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
