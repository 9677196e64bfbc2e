"""
Smoke test of the PyTorch/CUDA port on one NVIDIA H100: every kernel and
program of the port run on the card and held against its plain version,
the CPU or its eager path, then the kernels timed:

    python3 chip_smoke.py

Each kind of evidence has one home: the kernels against their plain
versions in tests/test_torch_cuda_kernels.py (phase 2 runs it), the
kernels' times here (phase 5, on portbench/work.py's and
portbench/trace.py's arithmetic), and the programs' speed in portbench/
(BENCHMARK.json), which no phase here times.

1. Environment: the card's name and power limit, torch/CUDA versions,
   compute capability (sm_90 required); TF32 is switched off so every
   float32 reference is full float32.
2. Kernels: builds the CUDA sources of coot_videotext_tpu_torch/csrc with
   nvcc (sm_90a), logs each kernel's registers, shared memory and spills,
   then runs `python -m pytest --noconftest -p no:cacheprovider -q
   tests/test_torch_cuda_kernels.py` in a process of its own beside the
   phases below (B1-B6 forward and backward against their plain versions
   at the calls of `kernel_call_work` that phase 5 times and at edge
   cases, bit-for-bit repeats, masks and seeds); the run fails unless
   pytest's summary counts passes only (a failure or a skip fails it).
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
   replay, where B1, B2, B3, B5 and B6 must each appear by kernel name.
4. Training at full width (bf16 compute, f32 master weights, dropout 0.01
   at every site, frame noise 0.01): on a generated 256-video train split
   the CLI trains one epoch from the device store with on-device sampling
   and packing, validates and checkpoints, with every launch count set to
   0 just before and read just after; `--validate --load_epoch 0` reads
   the checkpoint back; the run resumes for 4 more epochs (16 steps); the
   store with host-sampled index batches (the config's default, no
   --fixed_shapes) trains one epoch (the host dense path trains in phase
   10a); one fixed id batch trained 16 steps must lower its loss.
4b. synthetic_smoke.yaml trains one epoch through the CLI from the device
   store, in float32 as shipped and in bfloat16: its text input FC (48 ->
   32) runs B1's backward on padded widths, its GenPool (D 32, H 64) B2's.
4c. The group step: on a generated 640-video train split (10 steps an
   epoch) the CLI trains one epoch with `-o train.steps_per_dispatch=4
   --preload_device --fixed_shapes` in groups of 4, 4 and 2, each step
   after the first a replay of the captured train step, with every launch
   count set to 0 just before and read just after (the wrappers count at
   the eager first step and at the capture); the run resumed to 3 epochs
   (6 groups) and the per-step CLI on the same split (30 steps); one
   fixed id batch trains 16 steps per step and as 2 groups of 8 replays
   from the same state (no wrapper runs during them): seed states equal,
   losses and parameters within the bf16 tolerance, the loss falling.
5. Times every call of `kernel_call_work` (B1-B6 at the four to six calls
   of a train step at phase 4's shapes, forward and backward; B4 also in
   float32 at the caption steps' shapes): the kernel through its wrapper
   (CUDA events; backwards through autograd), its device-busy ms and
   device ms by kernel (portbench/trace.py `traced`: the union of the
   kernels' intervals), its plain version, the library's call where one
   computes the same (SDPA in turns, F.dropout, index_select; B1's product
   alone as `product_ms`), and its least time (portbench/work.py
   `bound_s`). B2's and B3's forwards train and eval, B6's eval and train,
   B1's backward's host us a call, B5 with and without noise. Alone on the
   card, after every other phase. `python -c "import chip_smoke;
   chip_smoke.time_kernels()"` runs it alone.
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
   the split, finite BLEU-4 / METEOR / ROUGE-L / CIDEr. One batch of 8
   videos on the card against the port on the CPU (loss within 1e-4
   relative, n_correct within 0.5% of n_word, at least 98% of the greedy
   sentences token-identical). The decodes and eval steps run as CUDA
   graphs (phase 13 holds them against the eager path).

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
   of 16 trained 16 eager steps at a fixed lr (the loss falls; a step
   launches B4 and no other kernel of the port).

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
   falls, B4 the only port kernel of a step. (b) The MTransformer at
   yc2_100m_coot_vidclip_mtrans.yaml (COOT vid+clip embeddings from seed
   0, 1152-d, single sentences, batches of 16 and 50): the same checks,
   the CLI over the sentences of the first 320 train and 50 val videos,
   a train batch of 16 and a val batch of 50 sentences card against CPU.

9. The rest of the caption family at the full width of
   yc2_2d3d_coot_vidclip_mart.yaml (COOT vid+clip embeddings from seed 0),
   each reached by `-o` overrides of it and each CLI run with the launch
   counts set to 0 just before and read just after. (a) Beam search
   (use_beam=true; beam 2, n_best 1, min_sen_len 5, max_sen_len 30 from
   the yaml) on MART trained one epoch by the CLI on the first 160 train
   videos: one val batch of 50 videos beam-decoded on the card, its first
   4 on the CPU too, in the fixed and the reference_compat mode (at
   least 98% of those sentences token-identical), `--validate
   --load_epoch 0 -o use_beam=true` over 50 val videos (no port kernel).
   (b-e) The TransformerXL (xl=true), the untied model
   (recurrent=false,untied=true), the joint single-sentence model
   (recurrent=false) and the decoder tied to the word embeddings
   (share_wd_cls_weight=true,word_vec_size=768,use_glove=false): the CLI
   trains one epoch on the first 160 train videos and validates on 50
   (B4 forward and backward, nothing else), `--validate --load_epoch 0`
   gives its val loss; from its weights a train batch card against CPU
   over 3 steps (phase 7's tolerances; XL's with xl_grad=true), a val
   batch's eval step and greedy tokens card against CPU (identical), a
   train batch of 16 trained 16 steps (the loss falls, B4 the only port
   kernel).

10. The prefetch pipeline and the tail. (a) On a generated 64 + 64-video
   split at yc2_2d3d_coot width with `preload_device: false`: a train and
   a val batch of 16 of the dense and the slab layout through
   data/pipeline.py `prefetch` equal to `to_device`'s on the card
   (torch.equal, host frame noise on); the dense CLI trains 1 step of 64
   and validates, then 1 step and a val batch under torch.profiler (the
   pinned copies must run on streams of their own; tools/host_path.py);
   B1-B4 must run, B5 not; the slab CLI trains 1 step and validates (B5
   runs). (b) S3D at full width, 2 generated videos of 256 frames of 256
   x 256 (16 windows of 32 each, one batch of 16) through the extractor's
   CLI where PIL is installed (else its `extract_video` on the arrays,
   and it says so), float32 and bfloat16, no port kernel launched; bf16
   against f32 features (cosine >= 0.99); one window card against CPU
   (f32 within 1e-4 of max |CPU|, bf16 cosine >= 0.99). (c) The MLP
   example trained 2 epochs, resumed to 3 and epoch 2 reloaded on the
   card (the reloaded val loss equals training's). (d)
   profile_device_and_ram (a 2 GiB block shows) and a trace() file
   holding each of its 61 launches as a kernel on the card (traced again,
   up to 3 times, where it lost some; the first kernel's start after its
   launch is logged).

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
   (b) the TransformerXL, the untied and joint models (phase 9's widths)
   and the MTransformer (yc2_100m_coot_vidclip_mtrans) from seed 0: the
   eval step and the greedy decode of one val batch, identical; (c)
   retrieval on yc2_2d3d_coot.yaml id batches (128 generated val videos):
   validation through the graph (capturing, then warm) and eagerly,
   embeddings, losses and metrics equal (bf16 within 1e-2 allowed; bit
   for bit expected), device ranks equal host ranks, the wrappers'
   launches in a warm step each way (a replay runs none) and the port's
   kernels on the device by name in a traced warm step, B1, B2, B3, B5
   and B6 each present in the traced replay and as many as in the eager
   step; (d, e) anet_coot.yaml (2048-d video) and yc2_100m_coot.yaml
   (512-d video), one batch of 64 generated val videos each: the same, and
   the card in f32 against the CPU (1e-4). The phase logs its time
   against SERVING_LIMIT_S.

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
   one traced warm step each way: the port's kernels by name, B4 alone,
   as many in the replay as eagerly. The phase logs its time against
   TRAIN_PROGRAMS_LIMIT_S. Phases 7-9 train the eager step
   (`eager=True`); their CLI runs train through the programs.

The order of a run: phase 1 and the build of phase 2; then phase 2's
tests, phases 6-8 and phase 9 (the caption family, which shares nothing
with the rest) in three processes of their own (the caption phases
`--side-phases`, each with SIDE_THREADS intra-op threads on the host),
beside phases 3-4c and 10-14 in the main one, whose host and device times
they share; their logs are printed after phase 14; then, with the card
the main process's alone, phase 5, which times it. Phase 4c also logs
what the in-process CLI runs left allocated on the card (as left, after a
garbage collection, after utils/graphs.py `release_all`). The synthetic
retrieval splits (DATA_SPLITS) are written by DATA_WORKERS worker
processes from the start, each moved into its phase's directory when the
phase needs it. Every worker and side process is stopped at exit.

Prints `{"kernels": [...]}` on the line before the last (phase 5's clips
call of each kernel: its times, bound and launches per train step, and
`eval_graph_launches`: the port's kernels of its source on the device in
the traced replay of 13 (c)'s captured eval step, by name;
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

# Tolerances, max |card - reference| / max(1, max |reference|) (phase 4c's
# replays against per-step calls, 10b's S3D and 13's card against the CPU):
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
    from portbench.trace import traced
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
        cuda_build.reset_launch_counts()
        results = train_retrieval.main(argv)[0]
        launches = dict(cuda_build.launch_counts)
        n_vid, batches = results["num_videos"], results["num_batches"]
        log(f"validation mode {i + 1} ({name}): launches {launches}; "
            f"{n_vid} videos in {batches} batches, the eval step "
            f"{results['eval_step']}")
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
    # the same videos as an id batch: sampled, packed and gathered on the
    # device
    _, _, _, id_loader = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=torch.device("cuda"),
        fixed_shapes=True, device_preload=True)
    id_batch = to_device(next(iter(id_loader)), torch.device("cuda"))
    source = FeatureSource.of(id_loader)

    # as validation runs them: an id batch through the captured step, whose
    # traced warm replay holds B1, B2, B3, B5 and B6 by name
    def eval_step():
        retrieval_eval_step(gpu.model, id_batch, source=source,
                            compute_dtype=gpu.val_dtype, **kw)

    eval_step()
    counts = _port_kernel_counts(traced(eval_step))
    log(f"the port's kernels on the device in a traced replay of the "
        f"captured eval step (id batch, store): {counts}")
    missing = [k for k in EVAL_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        fail(f"the traced replay of the captured eval step on an id batch "
             f"holds no {missing} kernels: {counts}")
    del gpu, e_gpu, id_batch, source, id_loader
    torch.cuda.empty_cache()
    return [launches for launches, _ in runs]


# the kernel wrappers' launch counts, the kernels line's rows: (the CUDA
# source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "input_fc": ("input_fc.cu",
                 "coot_videotext_tpu/ops/pallas_input_fc.py:207"),
    "input_fc_bwd": ("input_fc.cu",
                     "coot_videotext_tpu/ops/pallas_input_fc.py:284"),
    "genpool": ("genpool.cu", "coot_videotext_tpu/ops/pallas_genpool.py:284"),
    "genpool_bwd": ("genpool.cu",
                    "coot_videotext_tpu/ops/pallas_genpool.py:358"),
    "attention": ("attention.cu",
                  "coot_videotext_tpu/ops/pallas_attention.py:114"),
    "attention_bwd": ("attention.cu",
                      "coot_videotext_tpu/ops/pallas_attention.py:158"),
    "dropout": ("dropout.cu", "coot_videotext_tpu/ops/pallas_dropout.py:98"),
    "dropout_bwd": ("dropout.cu",
                    "coot_videotext_tpu/ops/pallas_dropout.py:121"),
    "gather": ("gather.cu", "coot_videotext_tpu/ops/pallas_gather.py:64"),
    "coot_norm": ("coot_norm.cu",
                  "none: XLA fused CootLayerNorm on the TPU"),
    "coot_norm_bwd": ("coot_norm.cu",
                      "none: XLA fused CootLayerNorm on the TPU"),
}
KERNELS = tuple(KERNEL_SOURCES)


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
            log(f"== stopped the process of {child.log_path.name}; the "
                "end of its log:\n" + "\n".join(lines[-40:]))
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
    from coot_videotext_tpu_torch import train_retrieval
    from coot_videotext_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    result = train_retrieval.main(
        ["-c", str(config), "--data_path", str(tmp / "data"), "--log_dir",
         str(config.parent / "experiments"), "-o",
         f"train.num_epochs={epochs},val.val_start=0{overrides}"] + extra)[0]
    launches = dict(cuda_build.launch_counts)
    if not np.isfinite(result["step_losses"]).all():
        fail(f"training losses {result['step_losses']}")
    return result, launches


def phase_train(tmp: Path):
    """The training path at full width: the CLI trains one epoch from the
    device store with on-device sampling and packing (256 train videos, 4
    steps), validates and checkpoints; the checkpoint is validated back;
    the run resumes for 4 more epochs (16 steps); the store with
    host-sampled index batches (the config's default, without
    --fixed_shapes) trains one epoch (the host dense path trains in phase
    10a); one fixed id batch trains 16 steps through B5. Returns the first
    run's launch counts and the step's shapes."""
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
    result, launches = _train_cli(config, tmp, ["--fixed_shapes"])
    log(f"training path launches (store, device sampling + packing): "
        f"{launches}")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the training path")
    losses = result["step_losses"]
    if len(losses) != 4 or result["layout"] != "ids":
        fail(f"expected 4 training steps on id batches, got {losses} on "
             f"{result['layout']} batches")
    log(f"CLI (store): 1 epoch of {len(losses)} steps (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}) and its validation")
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
        f"v2p r1 {val['v2p']['r1']:.4f}, c2s r1 {val['c2s']['r1']:.4f}")

    # the same run resumed to 5 epochs: 16 steps past the first epoch
    result, _ = _train_cli(config, tmp, ["--fixed_shapes"], epochs=5,
                           overrides=",saving.keep_freq=1")
    if len(result["step_losses"]) != 20:
        fail(f"the resumed run has {len(result['step_losses'])} steps")
    log("CLI (store, device sampling + packing) resumed for epochs 1-4 "
        "(16 steps)")

    # the config's default on the card: the store with host-sampled index
    # batches and the frame noise fused into the gathers
    result, idx_launches = _train_cli(_config(tmp / "store_idx"), tmp, [])
    losses = result["step_losses"]
    if len(losses) != 4 or result["layout"] != "indices":
        fail(f"store, host indices: losses {losses} on {result['layout']} "
             "batches")
    for name in KERNELS:
        if idx_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the store path with "
                 "host indices")
    log(f"CLI (store, host indices): 1 epoch of {len(losses)} steps (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}); launches {idx_launches}")

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
    fixed = [float(retrieval_train_step(ts, batch, **kw)["loss_total"])
             for _ in range(16)]
    log("fixed id batch, 16 steps: loss " +
        " ".join(f"{v:.4f}" for v in fixed))
    if not (np.isfinite(fixed).all()
            and np.mean(fixed[-3:]) < np.mean(fixed[:3])):
        fail("the loss of the fixed batch did not fall")
    shapes = dict(loader.device_meta.shapes, b=batch["dp_idx"].shape[0],
                  din=cfg.dataset_train.vid_feat_dim,
                  dtext=cfg.dataset_train.text_feat_dim)
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
        result, launches = _train_cli(
            config, tmp, ["--preload_device", "--fixed_shapes"],
            overrides=flags)
        for name in ("input_fc_bwd", "genpool_bwd"):
            if launches.get(name, 0) <= 0:
                fail(f"synthetic_smoke {dtype}: {name} was not launched")
        log(f"CLI synthetic_smoke ({dtype}, store): 1 epoch of "
            f"{len(result['step_losses'])} steps (losses "
            f"{', '.join(f'{v:.5f}' for v in result['step_losses'])}) and "
            f"its validation; launches {launches}")


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
    videos on the card against the port on the CPU."""
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
    result = train_caption.main([
        "-c", str(CAPTION_CONFIG), "--validate", "--load_model", str(pth),
        "--annotations_dir", str(ROOT / "annotations"),
        "--coot_feat_dir", str(emb_dir),
        "--cache_dir", str(ROOT / "cache_caption"),
        "--log_dir", str(tmp / "experiments")])[0]
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
        f"{result['num_batches']} batches of {cfg.val.batch_size}; forwards "
        f"per batch {result['forwards']}; metrics (random weights): "
        f"{json.dumps(scores)}")

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
    16 steps at a fixed lr: the loss falls, B4 the only kernel of the port
    a step launches."""
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
    result = train_caption.main(
        common + ["-o", cut + ",train.num_epochs=2"])[0]
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
    log(f"  {len(result['epochs'])} epochs of {result['steps_per_epoch']} "
        f"steps (batch {cfg.train.batch_size}); step losses first / last "
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
    log(f"  resumed to epoch 3 with --load_epoch 1; val loss per word "
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
        f"{CAPTION_TRAIN_LR} on the card")
    stacked, _, _ = dataset.collate_fn(
        [dataset[i] for i in range(cfg.train.batch_size)])
    log(f"  S {len(stacked['input_ids'])} sentence steps x N "
        f"{cfg.train.batch_size} x L {cfg.max_v_len + cfg.max_t_len}")
    fixed_batch_falls("caption training", build,
                      {k: stacked[k] for k in STACKED_KEYS}, single=False)


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
    --load_epoch 0` (the EMA weights: the training run's val loss). Returns
    the trained weights' file, model_0.pth."""
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    result = train_caption.main(common + [
        "-o", ",".join(filter(None, (cuts, "train.num_epochs=1")))])[0]
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
    log(f"  1 epoch of {result['steps_per_epoch']} steps of {unit}; step "
        f"losses first / last {losses[0]:.3f} / {losses[-1]:.3f}")
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
        f"{val['num_batches']} val batches of {n_val} videos; forwards per "
        f"decode {val['forwards']}; metrics (1 epoch from random "
        f"weights): " + json.dumps(
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
        outs[name] = {k: float(v) for k, v in
                      eval_step(mgr.model, batch).items()}
        decs[name] = np.asarray(Translator(mgr.model, mgr.cfg)
                                .translate_batch(batch))
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
    card against CPU (hold_decode), one batch of 16 trained 16 steps
    (fixed_batch_falls), each from the weights the CLI trained
    (model_0.pth: from random weights the second step's gradient norm
    jumps twentyfold, 2.8e3 to 5.6e4, and the third step's grad_norm
    carries the two devices' rounding past the 1e-4 gate: 1.5e-4 on an
    H100 80GB HBM3).
    (b) The MTransformer,
    yc2_100m_coot_vidclip_mtrans.yaml (COOT vid+clip 1152-d, single
    sentences): embeddings from seed 0 (_coot_embeddings), the same checks
    on batches of 16 train and 50 val sentences."""
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
        f"{CAPTION_TRAIN_LR}")
    fixed_batch_falls("raw-feature MART", build,
                      {k: stacked[k] for k in STACKED_KEYS}, single=False)
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
        f"at lr {CAPTION_TRAIN_LR}")
    fixed_batch_falls("MTransformer", build, arrays, single=True)
    torch.cuda.empty_cache()


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
    seen = {}
    for name in ("cuda", "cpu"):
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


def fixed_batch_falls(tag: str, build, arrays: dict, single: bool) -> None:
    """One train batch (numpy `arrays`) trained 16 eager steps
    (`eager=True`; phase 14 holds the captured programs against them) at
    CAPTION_TRAIN_LR on the card: the loss must fall, and a step launches
    B4's forward and backward and no other kernel of the port."""
    import torch
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, caption_train_step_single,
        init_caption_train_state)
    step_fn = caption_train_step_single if single else caption_train_step
    mgr = build(torch.device("cuda"))
    state = init_caption_train_state(mgr.model, mgr.cfg, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    losses = []
    for _ in range(16):
        cuda_build.reset_launch_counts()
        losses.append(float(step_fn(state, batch, CAPTION_TRAIN_LR,
                                    eager=True)["loss"]))
    launches = dict(cuda_build.launch_counts)
    log(f"  losses {', '.join(f'{v:.2f}' for v in losses)}; a step's "
        f"launches {launches}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"{tag}: a fixed batch's loss did not fall: {losses}")
    others = {k: v for k, v in launches.items()
              if v and k not in ("dropout", "dropout_bwd")}
    if others or not launches.get("dropout") \
            or not launches.get("dropout_bwd"):
        fail(f"{tag}: a train step launched {launches}, not B4 alone")
    del mgr, state, batch
    torch.cuda.empty_cache()


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
    CAPTION_MIN_SAME of those sentences token-identical), the CLI's
    `--validate --load_epoch 0 -o use_beam=true` over the 50 val videos (no
    port kernel may launch). (b-e) The TransformerXL, the
    untied model, the joint single-sentence model and the decoder tied to
    the word embeddings: the CLI trains one epoch and validates (_variant_cli),
    then from its weights one train batch card against CPU over 3 steps
    (hold_train_steps; XL's with xl_grad), one val batch's eval step and
    greedy tokens card against CPU (hold_decode), one train batch trained
    16 steps (fixed_batch_falls)."""
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
            decs[name, compat] = translator.translate_batch_beam(
                *batch, reference_compat=compat)
            log(f"  {name} {'reference_compat' if compat else 'fixed'}: "
                f"{translator.forwards} forwards, {translator.host_reads} "
                "host reads")
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
    del decs
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
        f"weights) over {n_val} val videos: forwards {result['forwards']}, "
        f"host reads {result['host_reads']}; launches {launches}; "
        "metrics " + json.dumps(
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
            f"{CAPTION_TRAIN_LR}")
        fixed_batch_falls(tag, build, {k: batch[k] for k in keys},
                          single=single)
        del train, val, batch, vbatch
        torch.cuda.empty_cache()


def _port_kernel_counts(trace) -> dict:
    """The port's kernels in a trace (portbench/trace.py `traced`; graph
    replays' nodes included), counted by the name of each `__global__`
    function and summed by the source that defines it: {"input_fc",
    "genpool", "attention", "gather", "dropout", "coot_norm"}
    (csrc/<name>.cu; the shared TN kernels of csrc/*.cuh are not
    counted)."""
    owner = {}
    for src in sorted((PACKAGE / "csrc").glob("*.cu")):
        for name in re.findall(
                r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", src.read_text(encoding="utf8")):
            owner[name] = src.stem
    counts = {}
    for name, _, _ in trace.kernels:
        m = re.search(r"coot::(?:\(anonymous namespace\)::)?(\w+)", name)
        if m and m.group(1) in owner:
            stem = owner[m.group(1)]
            counts[stem] = counts.get(stem, 0) + 1
    return counts


EVAL_KERNELS = ("input_fc", "genpool", "attention", "gather", "coot_norm")


def phase_group(tmp: Path) -> None:
    """Phase 4c, the group step (train.steps_per_dispatch = K): the CLI
    trains one epoch of a 640-video split (10 steps: groups of 4, 4 and
    a tail of 2) on the device-resident path, each group a replay of the
    captured train step, with the launch counts set to 0 just before and
    read just after; the run resumed to 3 epochs in groups and the
    per-step CLI on the same split (their dispatches); one fixed id batch
    trains 16 steps per step and as 2 groups of 8 replays from the same
    state (the graph captured first, the state then restored in place):
    losses, parameters and seed states held against each other after 8
    steps and after 16, the loss falling."""
    import numpy as np
    import torch
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
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
    result, launches = _train_cli(
        config, tmp, ["--preload_device", "--fixed_shapes"],
        overrides=",train.steps_per_dispatch=4")
    losses = result["step_losses"]
    log(f"CLI (store, device sampling + packing, steps_per_dispatch=4): 1 "
        f"epoch of {len(losses)} steps in dispatches "
        f"{result['dispatches']} (losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}); launches (the eager "
        f"first step and the capture; replays run no Python) {launches}")
    if (len(losses) != 10 or result["layout"] != "ids"
            or result["dispatches"] != {"group": 3}):
        fail(f"group CLI: {len(losses)} steps on {result['layout']} "
             f"batches in dispatches {result['dispatches']} (expected 10 "
             "steps on ids in 3 groups, none per step)")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the group path")
    # the same run resumed to 3 epochs, and the per-step CLI on the split
    for k, cfg_path, extra in (
            (4, config, ",train.steps_per_dispatch=4"),
            (1, _config(tmp / "per_step"), "")):
        result, _ = _train_cli(
            cfg_path, tmp, ["--preload_device", "--fixed_shapes"],
            epochs=3, overrides=extra + ",saving.keep_freq=1")
        expect = {"group": 6} if k == 4 else {"step": 30}
        if result["dispatches"] != expect or len(result["step_losses"]) \
                != 30 or not np.isfinite(result["step_losses"]).all():
            fail(f"CLI K={k}, 3 epochs: dispatches {result['dispatches']}, "
                 f"{len(result['step_losses'])} steps")
        log(f"CLI K={k}: 3 epochs, dispatches {result['dispatches']}")
    held_after_cli(cuda)

    cfg = RetrievalConfig(load_yaml_config_file(config))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, tmp / "data", seed=0, device=cuda, fixed_shapes=True,
        device_preload=True)
    source = FeatureSource.of(loader, cfg.dataset_train.frames_noise,
                              cfg.dataset_train.words_noise)
    fixed = next(iter(loader))
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

    # one fixed id batch, 16 steps: per step, and as 2 groups of 8 replays
    eager, graph = new_state(), new_state()
    snapshot = {n: p.detach().clone()
                for n, p in graph.optimizer.params.items()}
    ids = np.stack([fixed["dp_idx"]] * 8)
    valid = np.stack([fixed["batch_valid"]] * 8)
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
    del eager, graph, snapshot, dev_batch, source, loader
    torch.cuda.empty_cache()


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


# ---------------- phase 5: kernel timing ----------------

# the step shapes of phase 4's id batches at yc2_2d3d_coot width (batch 64
# of the 256-video train split, clips and sentences packed): the calls of
# PERF.md's kernel table; time_kernels runs at them
STEP_SHAPES = {"b": 64, "n_parts": 16, "lv": 80, "lc": 80, "lp": 320,
               "ls": 24, "pack_clips": 832, "pack_sents": 832, "din": 4096,
               "dtext": 1536}
# the rows of B5's table in phase 5: a store of the 256-video train
# split's size
STORE_ROWS = 82000
# B4 in float32 at the caption train steps' dropout shapes, rate 0.1:
# MART at yc2_2d3d_coot_vidclip_mart (L = 25: hidden rows, attention
# probabilities), raw-feature MART (L = 122), the MTransformer (video rows
# 1152 / 768, text rows, self-, cross- and video-attention
# probabilities), the TransformerXL's position tables at klen 25 and 50
# and a (16, 50, 768) block, the untied text embedding (300)
CAPTION_DROPOUT_SHAPES = ((16, 25, 768), (16, 12, 25, 25), (16, 122, 768),
                          (16, 12, 122, 122), (16, 3, 1152), (16, 3, 768),
                          (16, 12, 3, 3), (16, 22, 768), (16, 12, 22, 22),
                          (16, 12, 22, 3), (25, 768), (50, 768),
                          (16, 50, 768), (16, 22, 300))


def kernel_call_work(shapes: dict) -> dict:
    """Every call phase 5 times, by the name of its row in the kernels
    line (B6's eval forward apart, as `coot_norm_eval`), the clips call
    first: {"call": its place in a step, "dims": its inputs' sizes,
    "bytes", "flops", "dtype"}. `bytes` reads each input once and writes
    each output once; `flops` counts the products (a backward's the
    gradients', B1's only G = xhat^T dpre, as its input gets none); their
    least time is portbench/work.py `bound_s`. A pure function of a step's
    `shapes` (STEP_SHAPES' keys; phase 4 reads them from its batch)."""
    b, parts = shapes["b"], shapes["n_parts"]
    clips = shapes.get("pack_clips", b * parts)
    sents = shapes.get("pack_sents", b * parts)
    lc, lv, lp, ls = (shapes[k] for k in ("lc", "lv", "lp", "ls"))
    din, dtext = shapes["din"], shapes["dtext"]
    # the local nets' width, GenPool's hidden width and heads, B3's heads
    # and head width
    d, h, pool_heads, heads, dh = 384, 768, 2, 8, 48

    def call(what, nbytes, flops, dtype="bfloat16", **dims):
        return {"call": what, "dims": dims, "bytes": nbytes,
                "flops": float(flops), "dtype": dtype}

    fc = (("clips", clips * lc, din), ("video global", b * lv, din),
          ("paragraph", b * lp, dtext), ("sentences", sents * ls, dtext))
    pool = (("clips", clips, lc), ("video ctx", b, lv),
            ("paragraph", b, lp), ("sentences", sents, ls))
    dho = d // pool_heads
    weights = 2 * d * h + 2 * h * dho + 4 * (h + d)
    attention = [(what, s, n, n) for what, s, n in pool] + [
        ("global", b, parts, parts), ("cross", b, 1, parts)]
    norms = (("clips", clips * lc, d, True), ("video ctx", b * lv, d, True),
             ("paragraph", b * lp, d, True),
             ("sentences", sents * ls, d, True),
             ("global input", b * parts, 2 * d, False))
    dropouts = [call("clips", 4 * clips * lc * d, clips * lc * d,
                     shape=(clips * lc, d), rate=0.01)] + [
        call("caption", 8 * math.prod(shape), math.prod(shape), "float32",
             shape=shape, rate=0.1) for shape in CAPTION_DROPOUT_SHAPES]
    gathers = (("clips", clips * lc, din), ("video", b * lv, din),
               ("paragraphs", b * lp, dtext))
    return {
        "input_fc": [call(
            what, 2 * s * w + 8 * w + 2 * d * w + 4 * d + 2 * s * d,
            2 * s * w * d, s=s, width=w) for what, s, w in fc],
        "input_fc_bwd": [call(
            what, 2 * s * w + 2 * s * d + 4 * s * d + 2 * w * d + 8 * s
            + 4 * (w * d + d + 2 * w), 2 * s * w * d, s=s, width=w)
            for what, s, w in fc],
        "genpool": [call(
            what, 2 * s * n * d + s * n + weights + 2 * s * d,
            2 * s * n * (d * h + h * dho), s=s, length=n)
            for what, s, n in pool],
        "genpool_bwd": [call(
            what, 4 * s * n * d + s * n + 3 * weights + 14 * s * d,
            2 * s * n * (3 * d * h + 3 * h * dho), s=s, length=n)
            for what, s, n in pool],
        "attention": [call(
            what, 2 * s * heads * (2 * lq + 2 * lk) * dh + s * lk,
            4 * s * heads * lq * lk * dh, b=s, lq=lq, lk=lk)
            for what, s, lq, lk in attention],
        "attention_bwd": [call(
            what, 16 * s * heads * n * dh + s * n + 8 * s * heads * n,
            10 * s * heads * n * n * dh, b=s, length=n)
            for what, s, n in pool],
        "dropout": dropouts,
        "dropout_bwd": dropouts,
        "gather": [call(what, 4 * n * w + 4 * n, 0, n=n, width=w)
                   for what, n, w in gathers],
        "coot_norm": [call(
            what, (8 if res else 4) * rows * w + 8 * rows + 8 * w,
            10 * rows * w, rows=rows, width=w, residual=res)
            for what, rows, w, res in norms],
        "coot_norm_eval": [call(
            what, (6 if res else 4) * rows * w + 8 * w, 10 * rows * w,
            rows=rows, width=w, residual=res)
            for what, rows, w, res in norms],
        "coot_norm_bwd": [call(
            what, 6 * rows * w + 8 * rows + 12 * w, 12 * rows * w,
            rows=rows, width=w, residual=res)
            for what, rows, w, res in norms],
    }


def input_fc_inputs(s, din, dout, dtype, gen):
    """x ~ 2 N + 0.5, the norm's gain and bias, W and b."""
    import torch
    dev = "cuda"
    x = torch.randn(s, din, generator=gen, device=dev) * 2.0 + 0.5
    gain = 1.0 + 0.1 * torch.randn(din, generator=gen, device=dev)
    bias = 0.1 * torch.randn(din, generator=gen, device=dev)
    w = torch.randn(dout, din, generator=gen, device=dev) / math.sqrt(din)
    b = 0.1 * torch.randn(dout, generator=gen, device=dev)
    return x.to(dtype), gain, bias, w.to(dtype), b


def genpool_inputs(s, length, d, h, heads, dtype, gen):
    import torch
    dev = "cuda"
    dh, dho = h // heads, d // heads
    f = torch.randn(s, length, d, generator=gen, device=dev)
    lens = torch.randint(1, length + 1, (s,), generator=gen, device=dev)
    mask = torch.arange(length, device=dev)[None] < lens[:, None]
    w1 = torch.randn(heads, d, dh, generator=gen, device=dev) / math.sqrt(d)
    b1 = 0.1 * torch.randn(heads, dh, generator=gen, device=dev)
    w2 = torch.randn(heads, dh, dho, generator=gen, device=dev) / math.sqrt(dh)
    b2 = 0.1 * torch.randn(heads, dho, generator=gen, device=dev)
    return f.to(dtype), mask, w1.to(dtype), b1, w2.to(dtype), b2


def attention_inputs(b, heads, lq, lk, dh, dtype, gen):
    import torch
    dev = "cuda"
    n = b * heads
    q = torch.randn(n, lq, dh, generator=gen, device=dev)
    k = torch.randn(n, lk, dh, generator=gen, device=dev)
    v = torch.randn(n, lk, dh, generator=gen, device=dev)
    lens = torch.randint(1, lk + 1, (b,), generator=gen, device=dev)
    key_valid = torch.arange(lk, device=dev)[None] < lens[:, None]
    return q.to(dtype), k.to(dtype), v.to(dtype), key_valid


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """CUDA events over `iters` back-to-back calls of fn, ms per call."""
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


def device_ms(fn, calls: int = 20) -> tuple:
    """(device-busy ms per call of fn, {kernel: ms per call}): `calls`
    warm calls in one traced window (portbench/trace.py: busy is the union
    of the kernels' intervals); kernels by name without namespace and
    arguments."""
    import torch
    from portbench.trace import traced
    def run():
        for _ in range(calls):
            fn()

    fn()
    torch.cuda.synchronize()
    trace = traced(run)
    split = {}
    for name, start, end in trace.kernels:
        key = name.replace("(anonymous namespace)::", "").split("(")[0]
        key = key.split("::")[-1]
        split[key] = split.get(key, 0.0) + (end - start) * 1e3 / calls
    return trace.busy_s * 1e3 / calls, split


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


def _bwd_ms(out, inputs, g) -> float:
    """The backward alone: autograd.grad over a kept graph."""
    import torch
    return time_ms(lambda: torch.autograd.grad(out, inputs, g,
                                               retain_graph=True))


def paired_bwd_ms(ours, lib, rounds: int = 5) -> tuple:
    """Medians of two backwards (`_bwd_ms` on (out, inputs, g)), timed in
    turns so that the host's load falls on both alike."""
    a, b = [], []
    for _ in range(rounds):
        a.append(_bwd_ms(*ours))
        b.append(_bwd_ms(*lib))
    return statistics.median(a), statistics.median(b)


def phase_timing(launches: dict, shapes: dict) -> list:
    """Phase 5: every call of kernel_call_work(shapes), forward and
    backward, in bf16 (B4 also in f32 at the caption shapes): the kernel
    through its wrapper (CUDA events; backwards through autograd.grad),
    its device-busy ms and device ms by kernel (portbench/trace.py), its
    plain version, the library's call where one computes the same (SDPA,
    F.dropout, index_select) or B1's product alone, and its least time
    (portbench/work.py `bound_s`). B2's and B3's forwards train (with the
    stats) and eval; B3 in turns with SDPA; B1's backward's host us per
    call; B5 with and without noise; B6 train and eval. Returns the kernels
    line: each kernel's clips call, `launches` (phase 4's counts) beside
    it."""
    import torch
    import torch.nn.functional as F
    from portbench.work import bound_s
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.ops.attention import (
        masked_attention, masked_attention_backward_plain,
        masked_attention_plain)
    from coot_videotext_tpu_torch.ops.coot_norm import (
        coot_norm, coot_norm_plain)
    from coot_videotext_tpu_torch.ops.dropout import dropout, dropout_plain
    from coot_videotext_tpu_torch.ops.gather import (
        GatherNoise, gather_rows, gather_rows_plain)
    from coot_videotext_tpu_torch.ops.genpool import (
        genpool, genpool_backward_plain, genpool_plain)
    from coot_videotext_tpu_torch.ops.input_fc import (
        fused_input_fc, fused_input_fc_backward_plain, fused_input_fc_plain)
    from coot_videotext_tpu_torch.typext import INF
    work = kernel_call_work(shapes)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, rate, seed = torch.bfloat16, 0.01, device_seed()
    rows = []

    def record(name, i, ms, device, plain_ms, library_ms=None, **extra):
        w = work[name][i]
        bound = bound_s(w["bytes"], w["flops"], w["dtype"]) * 1e3
        by = ("bytes" if bound_s(w["bytes"], 0.0, w["dtype"])
              >= bound_s(0.0, w["flops"], w["dtype"]) else "operations")
        dev, split = device
        rows.append(dict(name=name, ms=ms, device_ms=dev, plain_ms=plain_ms,
                         library_ms=library_ms, roofline_ms=bound, bound_by=by,
                         **extra))
        dims = " ".join(f"{k}={v}" for k, v in w["dims"].items())
        log(f"  {name:14s} {w['call']:12s} {dims} {w['dtype']}: kernel "
            f"{ms:.4f} ms, device {dev:.4f} (" + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items())
            + f"), bound {bound:.4f} ({by}), plain {plain_ms:.3f}"
            + ("" if library_ms is None else f", library {library_ms:.4f}")
            + "".join(f", {k} {v:.4f}" for k, v in extra.items()))

    # B1: the forward, and its product alone (a yardstick: no PyTorch call
    # computes B1, and the port never calls the product); the backward's
    # one product G = xhat^T dpre alone
    for i, c in enumerate(work["input_fc"]):
        s, width = c["dims"]["s"], c["dims"]["width"]
        x, *params = input_fc_inputs(s, width, 384, bf, gen)
        params = [p.float() for p in params]
        w_t = params[2].to(bf).t()

        def fc():
            return fused_input_fc(x, *params, 1e-6, "gelu")

        with torch.inference_mode():
            record("input_fc", i, time_ms(fc), device_ms(fc), time_ms(
                lambda: fused_input_fc_plain(x, *params, 1e-6, "gelu")),
                product_ms=time_ms(lambda: torch.matmul(x, w_t)))
        leaves = [p.clone().requires_grad_() for p in params]
        y = fused_input_fc(x, *leaves, 1e-6, "gelu")
        dy = torch.randn(s, 384, generator=gen, device="cuda").to(bf)

        def fc_bwd():
            return torch.autograd.grad(y, leaves, dy, retain_graph=True)

        record("input_fc_bwd", i, _bwd_ms(y, leaves, dy), device_ms(fc_bwd),
               time_ms(lambda: fused_input_fc_backward_plain(
                   x, *params, 1e-6, "gelu", dy)),
               product_ms=time_ms(lambda: torch.matmul(x.t(), dy)),
               host_us=host_us_per_call(fc_bwd, 50))
        del x, params, w_t, leaves, y, dy
        torch.cuda.empty_cache()
    # B2: the forward with the stats (train) and without (eval)
    for i, c in enumerate(work["genpool"]):
        s, length = c["dims"]["s"], c["dims"]["length"]
        f, mask, *params = genpool_inputs(s, length, 384, 768, 2, bf, gen)
        params = [p.float() for p in params]
        leaves = [p.clone().requires_grad_() for p in params]

        def pool(ps):
            return lambda: genpool(f, mask, *ps, "gelu", rate, seed)

        with torch.inference_mode():
            eval_ms = time_ms(pool(params))
            eval_dev = device_ms(pool(params))[0]
            plain = time_ms(lambda: genpool_plain(f, mask, *params, "gelu",
                                                  rate, seed), 3, 1)
        record("genpool", i, time_ms(pool(leaves)), device_ms(pool(leaves)),
               plain, eval_ms=eval_ms, eval_device_ms=eval_dev)
        fl = f.clone().requires_grad_()
        y = genpool(fl, mask, *leaves, "gelu", rate, seed)
        dout = torch.randn(s, 384, generator=gen, device="cuda").to(bf)

        def pool_bwd():
            return torch.autograd.grad(y, [fl] + leaves, dout,
                                       retain_graph=True)

        record("genpool_bwd", i, _bwd_ms(y, [fl] + leaves, dout),
               device_ms(pool_bwd), time_ms(lambda: genpool_backward_plain(
                   f, mask, *params, "gelu", dout, rate, seed)))
        del f, mask, params, leaves, fl, y, dout
        torch.cuda.empty_cache()
    # B3: train and eval forwards in turns with SDPA (additive mask, the
    # same dropout); the backward in turns with SDPA's
    for i, c in enumerate(work["attention"]):
        b_, lq, lk = c["dims"]["b"], c["dims"]["lq"], c["dims"]["lk"]
        q, k, v, kv = attention_inputs(b_, 8, lq, lk, 48, bf, gen)
        add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        times = {}
        for mode, ts in (("train", leaves), ("eval", [q, k, v])):
            def ours(ts=ts):
                return masked_attention(*ts, kv, 8, 48 ** -0.5, rate, seed)

            def sdpa(ts=ts):
                return F.scaled_dot_product_attention(
                    *ts, attn_mask=add_mask, dropout_p=rate,
                    scale=48 ** -0.5)

            with torch.inference_mode(mode == "eval"):
                ms, lib = [], []
                for _ in range(2):  # kernel, SDPA, kernel, SDPA
                    ms.append(time_ms(ours))
                    lib.append(time_ms(sdpa))
                times[mode] = (statistics.mean(ms), device_ms(ours),
                               statistics.mean(lib))
        with torch.inference_mode():
            plain = time_ms(lambda: masked_attention_plain(
                q, k, v, kv, 8, 48 ** -0.5, rate, seed), 3, 1)
        record("attention", i, *times["train"][:2], plain, times["train"][2],
               eval_ms=times["eval"][0], eval_device_ms=times["eval"][1][0],
               eval_library_ms=times["eval"][2])
        del q, k, v, kv, add_mask, leaves
    for i, c in enumerate(work["attention_bwd"]):
        b_, length = c["dims"]["b"], c["dims"]["length"]
        q, k, v, kv = attention_inputs(b_, 8, length, length, 48, bf, gen)
        add_mask = torch.where(kv, 0.0, -INF).to(bf).repeat_interleave(
            8, dim=0)[:, None, :]
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        y = masked_attention(*qkv, kv, 8, 48 ** -0.5, rate, seed)
        g = torch.randn(b_ * 8, length, 48, generator=gen,
                        device="cuda").to(bf)
        qkv_lib = [a.clone().requires_grad_() for a in (q, k, v)]
        y_lib = F.scaled_dot_product_attention(
            *qkv_lib, attn_mask=add_mask, dropout_p=rate, scale=48 ** -0.5)
        ms, lib = paired_bwd_ms((y, qkv, g), (y_lib, qkv_lib, g))
        record("attention_bwd", i, ms, device_ms(
            lambda: torch.autograd.grad(y, qkv, g, retain_graph=True), 10),
            time_ms(lambda: masked_attention_backward_plain(
                q, k, v, kv, g, 8, 48 ** -0.5, rate, seed)), lib,
            library_device_ms=device_ms(lambda: torch.autograd.grad(
                y_lib, qkv_lib, g, retain_graph=True), 10)[0])
        del q, k, v, kv, add_mask, qkv, y, g, qkv_lib, y_lib
        torch.cuda.empty_cache()
    # B4 beside F.dropout: the clips' sublayer rows, then the caption
    # shapes; the backwards in turns
    for i, c in enumerate(work["dropout"]):
        p = c["dims"]["rate"]
        x = torch.randn(c["dims"]["shape"], generator=gen, device="cuda").to(
            getattr(torch, c["dtype"]))

        def drop():
            return dropout(x, seed, p)

        with torch.inference_mode():
            plain = time_ms(lambda: dropout_plain(x, seed, p))
            record("dropout", i, time_ms(drop), device_ms(drop), plain,
                   time_ms(lambda: F.dropout(x, p, training=True)))
        xl, xl_lib = x.clone().requires_grad_(), x.clone().requires_grad_()
        y, y_lib = dropout(xl, seed, p), F.dropout(xl_lib, p, training=True)
        ms, lib = paired_bwd_ms((y, [xl], x), (y_lib, [xl_lib], x), 9)
        record("dropout_bwd", i, ms, device_ms(lambda: torch.autograd.grad(
            y, [xl], x, retain_graph=True)), plain, lib)
        del x, xl, xl_lib, y, y_lib
    torch.cuda.empty_cache()
    # B5: a store of the 256-video train split's size, with and without
    # the fused noise
    for i, c in enumerate(work["gather"]):
        n, width = c["dims"]["n"], c["dims"]["width"]
        table = torch.randn(STORE_ROWS, width, generator=gen,
                            device="cuda").to(bf)
        idx = torch.randint(0, STORE_ROWS, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        noise = GatherNoise(0.01, seed, philox.SITE_NOISE_CLIP)
        with torch.inference_mode():
            record("gather", i, time_ms(lambda: gather_rows(table, idx)),
                   device_ms(lambda: gather_rows(table, idx)),
                   time_ms(lambda: gather_rows_plain(table, idx)),
                   time_ms(lambda: torch.index_select(table, 0, idx)),
                   noise_ms=time_ms(lambda: gather_rows(table, idx, noise)),
                   plain_noise_ms=time_ms(
                       lambda: gather_rows_plain(table, idx, noise)))
        del table, idx
        torch.cuda.empty_cache()
    # B6 beside the plain path (the unfused composition through autograd):
    # eval, train (the sum stored for the backward) and the backward
    for i, c in enumerate(work["coot_norm"]):
        n, width = c["dims"]["rows"], c["dims"]["width"]
        res = c["dims"]["residual"]
        args = [(2 * torch.randn(n, width, generator=gen, device="cuda")
                 + 0.5).to(bf)]
        if res:
            args.append(torch.randn(n, width, generator=gen,
                                    device="cuda").to(bf))
        args += [1 + 0.1 * torch.randn(width, generator=gen, device="cuda"),
                 0.1 * torch.randn(width, generator=gen, device="cuda")]
        dout = torch.randn(n, width, generator=gen, device="cuda").to(bf)
        leaves = [t.clone().requires_grad_() for t in args]

        def norm(a, fn=coot_norm):
            return lambda: fn(a[0], a[1] if res else None, *a[-2:], 1e-6)

        with torch.inference_mode():
            record("coot_norm_eval", i, time_ms(norm(args), 20),
                   device_ms(norm(args)),
                   time_ms(norm(args, coot_norm_plain), 5))
        record("coot_norm", i, time_ms(norm(leaves), 20),
               device_ms(norm(leaves)),
               time_ms(norm(leaves, coot_norm_plain), 5))
        o, o_plain = norm(leaves)(), norm(leaves, coot_norm_plain)()
        record("coot_norm_bwd", i, _bwd_ms(o, leaves, dout),
               device_ms(lambda: torch.autograd.grad(
                   o, leaves, dout, retain_graph=True)),
               _bwd_ms(o_plain, leaves, dout))
        del args, dout, leaves, o, o_plain
        torch.cuda.empty_cache()
    entries = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = next(r for r in rows if r["name"] == name)
        evaluated = next((r for r in rows if r["name"] == name + "_eval"),
                         dict(row, ms=row.get("eval_ms")))
        entries.append(dict(
            name=name, route="cuda",
            source=f"coot_videotext_tpu_torch/csrc/{source}",
            replaces=replaces, launches=int(launches.get(name, 0)),
            **{k: row.get(k) for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "roofline_ms",
                "bound_by", "product_ms")},
            eval_ms=evaluated["ms"],
            eval_roofline_ms=(None if evaluated["ms"] is None
                              else evaluated["roofline_ms"])))
    return entries


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
    record = host_path.measure(ROOT, data, "dense", HOST_VIDEOS,
                               host_path.VAL_VIDEOS, SHORT_VIDEOS,
                               tmp / "dense")
    launches = dict(cuda_build.launch_counts)
    log(f"  host dense CLI: {record['steps']} step(s) on {record['layout']} "
        f"batches; launches {launches}")
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
    log(f"  traced: the pinned copies on streams {record['copy_streams']}, "
        f"the kernels on {record['kernel_streams']}")
    cuda_build.reset_launch_counts()
    slab = host_path.train_once(
        host_path.host_config(ROOT, tmp / "slab", "slab", SHORT_VIDEOS),
        data, tmp / "slab" / "experiments")
    launches = dict(cuda_build.launch_counts)
    if slab["layout"] != "slab" or slab["steps"] != 1 or \
            launches.get("gather", 0) <= 0:
        fail(f"host slab CLI: {slab}, launches {launches}")
    log(f"  host slab CLI: {slab['steps']} step; launches {launches}")
    torch.cuda.empty_cache()


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
        launches = dict(cuda_build.launch_counts)
        if any(launches.values()):
            fail(f"S3D launched the port's kernels: {launches}")
        for k, f in feats.items():
            if f.shape != (S3D_BATCH, 512 + 1024) or not \
                    np.isfinite(f).all():
                fail(f"S3D features of {k} ({dn}): {f.shape}")
        loaders[dn] = feats
        log(f"  {dn}: {S3D_VIDEOS} videos -> {S3D_VIDEOS} x "
            f"{S3D_BATCH} windows of (512 + 1024) features; no port kernel "
            "launched")
    cos = min(float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))
              for k in videos
              for a, b in [(loaders["float32"][k], loaders["bfloat16"][k])])
    log(f"  bfloat16 against float32 features: cosine {cos:.5f}")
    if not cos >= MIN_COSINE:
        fail(f"S3D bf16 against f32 features: cosine {cos}")

    cuda = torch.device("cuda")
    frames = videos["video0"].astype(np.float32) / 255.0
    one = torch.from_numpy(np.stack(tool.video_windows(
        frames, S3D_KERNEL, S3D_STRIDE)[:1])).to(cuda).permute(
            0, 4, 1, 2, 3).contiguous()
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
    first = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=2"])[0]
    resumed = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=3"])[0]
    val = run_mlp_mnist.main(argv + ["--validate", "--load_epoch", "2"])[0]
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
    log(f"  trained 2 epochs, resumed to 3, reloaded epoch 2 on the card: "
        f"val accuracy {resumed['val_accuracy']}, val loss "
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


def _decode_pass(translator, batches, beam: bool) -> list:
    """Every batch decoded: the tokens of each."""
    import numpy as np
    tokens = []
    for batch in batches:
        if beam:
            out = translator.translate_batch_beam(*batch)
        else:
            out = translator.translate_batch_greedy(*batch)
        tokens.append(np.stack(out))
    return tokens


def _serving_eval(tag: str, step, model, batch: dict) -> None:
    """A caption eval step (`step`) on `batch` through its graph against
    eagerly: the capture, then a warm replay, equal to the eager step
    (SERVING_EVAL_RTOL in f32); a second call of each way equal to its
    first."""
    out = {}
    for name, eager in (("eager", True), ("graph", False)):
        out[name] = {k: float(v) for k, v in
                     step(model, batch, eager=eager).items()}
        again = {k: float(v) for k, v in
                 step(model, batch, eager=eager).items()}
        if again != out[name]:
            fail(f"{tag} eval step ({name}): two calls differ")
    apart = max(abs(out["graph"][k] - v) / max(1.0, abs(v))
                for k, v in out["eager"].items())
    log(f"  {tag} eval step: {out['graph']} through its graph, "
        f"{apart:.3e} apart from eager (limit "
        f"{SERVING_EVAL_RTOL['float32']:.0e})")
    if not apart <= SERVING_EVAL_RTOL["float32"]:
        fail(f"{tag}: the captured eval step disagrees with the eager one")


def _serving_decode(tag: str, mgr, batches, beam: bool) -> None:
    """One decode mode over `batches` eagerly, then through the programs
    (CUDA graphs): the tokens of every batch identical."""
    import numpy as np
    from coot_videotext_tpu_torch.tasks.caption.translator import Translator
    from coot_videotext_tpu_torch.utils.graphs import cache_of
    runs = {}
    for name, eager in (("eager", True), ("graph", False)):
        translator = Translator(mgr.model, mgr.cfg, eager=eager)
        built = cache_of(mgr.model).captures
        runs[name] = _decode_pass(translator, batches, beam)
        log(f"  {tag} {name:5s}: {translator.forwards} forwards, "
            f"{translator.host_reads} host reads, {translator.replays} "
            f"program runs in the last batch; "
            f"{cache_of(mgr.model).captures - built} programs built")
    for i, (a, b) in enumerate(zip(runs["graph"], runs["eager"])):
        if not np.array_equal(a, b):
            rows = (a == b).reshape(-1, a.shape[-1]).all(axis=1)
            fail(f"{tag}: batch {i} decoded through the graphs differs "
                 f"from the eager decode ({int(rows.sum())} of {rows.size} "
                 "sentences identical)")
    sentences = sum(int(t.shape[0] * t.shape[1]) for t in runs["eager"])
    log(f"  {tag}: {len(batches)} batches, {sentences} sentences, every one "
        "token-identical through the graphs")


def _retrieval_serving(tmp: Path, source_yaml: Path,
                       cpu_check: bool) -> dict:
    """A val split of synthetic videos at the widths of `source_yaml` (npy
    features, DATA_SPLITS' `serving_<stem>`) on the device store with device sampling
    (id batches, fixed shapes). validate_retrieval through the captured
    eval step against the eager one (embeddings, losses, metrics), device
    ranks against host ranks; the port's kernel launches in a warm step
    each way (a replay launches none) and its kernels by name in a traced
    warm step (as many in a replay as eagerly); with `cpu_check` one batch
    on the card in f32 against the CPU (the kernels' plain versions).
    Returns the port's kernels by name in the traced replay."""
    import torch
    import yaml
    from portbench.trace import traced
    from coot_videotext_tpu_torch.data.device_store import (
        FeatureSource, assemble_batch)
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.ops import cuda_build
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
        results[name] = res = validate.validate_retrieval(
            mgr.model, cfg, loader, cuda, eager=name == "eager", **kw)
        log(f"  validation, eval step {res['eval_step']}: "
            f"{res['num_videos']} videos in {res['num_batches']} batches")
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
    launches, ports = {}, {}
    for name, eager in (("eager", True), ("graph", False)):
        def step():
            retrieval_eval_step(mgr.model, batch, eager=eager, **step_kw)
            torch.cuda.synchronize()
        step()
        cuda_build.reset_launch_counts()
        step()
        launches[name] = dict(cuda_build.launch_counts)
        ports[name] = _port_kernel_counts(traced(step))
        log(f"  eval step {name:5s} (batch 0, warm): wrapper launches in "
            f"one step {launches[name]}; the port's kernels on the device "
            f"in a traced step {ports[name]}")
    if any(launches["graph"].values()):
        fail(f"{source_yaml.name}: a replay of the eval step ran the "
             f"wrappers: {launches['graph']}")
    for kernel in EVAL_KERNELS:
        if launches["eager"].get(kernel, 0) <= 0:
            fail(f"{source_yaml.name}: {kernel} did not run in the eval "
                 "step")
        if ports["graph"].get(kernel, 0) <= 0:
            fail(f"{source_yaml.name}: the trace of a graph replay holds "
                 f"no {kernel} kernel: {ports['graph']}")
    if ports["graph"] != ports["eager"]:
        fail(f"{source_yaml.name}: the replay ran other kernels of the port "
             f"({ports['graph']}) than the eager step ({ports['eager']})")
    if not cpu_check:
        return ports["graph"]

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
    del mgr, cpu, loader, batch, dense
    torch.cuda.empty_cache()
    return ports["graph"]


def phase_serving_graphs(tmp: Path) -> dict:
    """Phase 13, the serving programs as CUDA graphs (utils/graphs.py),
    each against the eager path on the same weights and inputs. (a) MART
    at yc2_2d3d_coot_vidclip_mart width over the 457-video YouCook2 val
    split (phase 6's inputs, seed 0): greedy and beam (fixed) decoded
    eagerly and through the graphs, every sentence token-identical, beam
    reference_compat on the first batch. (b) The TransformerXL, the untied
    and joint models (phase 9's widths) and the MTransformer
    (yc2_100m_coot_vidclip_mtrans) from seed 0: one val batch each,
    token-identical. (c) Retrieval on yc2_2d3d_coot.yaml id batches (128
    val videos): validation through the graph against the eager step,
    ranks against host ranks, the port's launches and kernels in a warm
    step each way. (d) anet_coot.yaml and yc2_100m_coot.yaml, which no
    earlier phase runs: one val batch each at their widths through the
    graph against eager, the card against the CPU in f32. Returns the
    port's kernels on the device in one traced replay of the captured
    yc2_2d3d_coot eval step, counted by name (`_port_kernel_counts`), each
    of B1, B2, B3, B5 and B6 required there."""
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
        out = {}
        for name, eager in (("eager", True), ("graph", False), ("replay",
                                                                False)):
            translator = Translator(mgr.model, mgr.cfg, eager=eager)
            out[name] = np.asarray(translator.translate_batch(batch))
        if not (np.array_equal(out["graph"], out["eager"])
                and np.array_equal(out["replay"], out["eager"])):
            fail(f"{tag}: the graphs' tokens differ from the eager decode")
        mark(f"{tag} done")
        log(f"  {tag}: {out['eager'].size // out['eager'].shape[-1]} "
            f"sentences token-identical (eager, the graphs' first call and "
            f"their replays); {translator.forwards} forwards, "
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
    TRAIN_PROGRAM_LRS. Every step's metrics and the whole state after them
    must be equal bit for bit, and each key's first call one step. Then one
    warm step of each path on the last key traced: the port's kernels by
    name (B4 alone in both, as many in the replay as eagerly, and the
    eager step's wrappers' counts adding up to them). Returns the record."""
    import torch
    from portbench.trace import traced
    from coot_videotext_tpu_torch.ops import cuda_build
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        build_mart_model_manager)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, caption_train_step_single,
        init_caption_train_state, train_programs)
    cuda = torch.device("cuda")
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
    rows = {}
    for eager, state in states.items():
        rows[eager] = []
        for i, (batch, lr) in enumerate(order):
            out = step(state, batch, lr, eager=eager)
            rows[eager].append(torch.stack([out["loss"], out["n_word"],
                                            out["n_correct"],
                                            out["grad_norm"]]).tolist())
            if not eager and i < len(batches) and int(state.step) != i + 1:
                fail(f"{tag}: the first call of key {i} took "
                     f"{int(state.step) - i} steps")
    same = rows[True] == rows[False] and all(
        torch.equal(a, b) for a, b in zip(
            _caption_state_tensors(states[True]),
            _caption_state_tensors(states[False])))
    cache = train_programs(states[False])
    rec = {"tag": tag, "keys": len(cache.programs),
           "captures": cache.captures, "equal": same, "sizes": keys}
    batch, lr = order[len(batches) - 1]  # the last (largest) key, warm
    for eager, name in ((True, "eager"), (False, "program")):
        cuda_build.reset_launch_counts()
        ports = _port_kernel_counts(traced(
            lambda: step(states[eager], batch, lr, eager=eager)[
                "loss"].item()))
        rec[f"{name}_b4"] = ports.get("dropout", 0)
        if set(ports) != {"dropout"}:
            fail(f"{tag}: a traced {name} step ran the port's kernels "
                 f"{ports}, not B4 alone")
        if eager:
            # the wrappers' counts of the eager step, by direction (a
            # replay runs no wrapper; by name the two are one kernel)
            rec["eager_b4_fwd"] = cuda_build.launch_counts["dropout"]
            rec["eager_b4_bwd"] = cuda_build.launch_counts["dropout_bwd"]
    log(f"  {tag}: {len(order)} steps a path, {rec['keys']} program(s) "
        f"(S {list(keys)}), bit for bit equal to eager: {same}; traced "
        f"step (S {keys[-1]}): B4 by name {rec['program_b4']} / "
        f"{rec['eager_b4']} (the eager step's wrappers: "
        f"{rec['eager_b4_fwd']} forward + {rec['eager_b4_bwd']} backward)")
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
    "group": (640, 64, 2),                                  # phase 4c
    # tools/host_path.py's `generate`: VAL_VIDEOS 64, seed 2
    "host": (HOST_VIDEOS, 64, 2),                           # phase 10a
    "dp": (DP_TRAIN_VIDEOS, DP_VAL_VIDEOS, 5),              # phase 11
    "serving_yc2_2d3d_coot": (4, 128, 0),                   # phase 13c
    **{f"serving_{name.split('.')[0]}": (                   # 13d, 13e
        4, SERVING_VAL_VIDEOS, i + 1, CONFIG.parent / name)
       for i, name in enumerate(SERVING_RETRIEVAL_CONFIGS)},
}

# The caption family shares nothing with the other phases: phases 6-8 and
# phase 9 run in two processes of their own (`--side-phases`), beside the
# kernel tests (phase 2) and phases 3-4c and 10-14 of the main one. Phase
# 5, which times the card, runs after them, alone on it.
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
# phase 2's tests of every kernel against its plain version on the card
CUDA_TESTS = [sys.executable, "-m", "pytest", "--noconftest", "-p",
              "no:cacheprovider", "-q", "tests/test_torch_cuda_kernels.py"]


def kernel_tests_summary(output: str) -> str:
    """The summary line of phase 2's pytest `output`, which must count
    passes and nothing else but warnings: a case that skips (as every case
    does where the process sees no CUDA device) fails the run, as a case
    that fails does."""
    lines = [line.strip("= ") for line in output.splitlines()
             if re.search(r" in [\d.]+s\b", line)]
    summary = lines[-1] if lines else ""
    counts = {word: int(n) for n, word in re.findall(
        r"(\d+) ([a-z]+)", summary.split(" in ")[0])}
    if not counts.get("passed") or set(counts) - {"passed", "warning",
                                                  "warnings"}:
        fail(f"phase 2, the kernel tests: every case must pass, got "
             f"{summary or 'no summary line'!r}")
    return summary


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


def _spawn(what: str, argv: list, logs: Path) -> tuple:
    """Starts `argv` in a process of its own (`what` names it), its output
    to a file under `logs`."""
    name = re.sub(r"\W+", "_", what)
    out = logs / f"{name}.log"
    with open(out, "w", encoding="utf8") as fh:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=fh,
                                stderr=subprocess.STDOUT)
    proc.log_path = out
    _CHILDREN.append(proc)
    return what, proc, out


def _join(child) -> str:
    """Waits for a process of _spawn, prints its log and fails with it;
    returns the log."""
    what, proc, out = child
    t0 = time.time()
    rc = proc.wait()
    log(f"== {what}, which ran in a process of its own beside the main "
        f"one (waited {time.time() - t0:.1f} s more for it), logged:")
    text = out.read_text(encoding="utf8", errors="replace")
    sys.stdout.write(text if text.endswith("\n") else text + "\n")
    sys.stdout.flush()
    if rc != 0:
        failed = [line for line in text.splitlines() if "FAILED" in line]
        fail(f"{what} exited with {rc}: "
             f"{failed[-1] if failed else 'see its log above'}")
    return text


def time_kernels() -> None:
    """Phase 5 alone at STEP_SHAPES: builds this checkout's kernels, times
    them and prints the kernels line (without launch counts). Run in each
    of two checkouts in one call, `python -c "import chip_smoke;
    chip_smoke.time_kernels()"` compares them kernel by kernel on one
    card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    phase_environment()
    phase_build()
    print(json.dumps({"kernels": phase_timing({}, STEP_SHAPES)}),
          flush=True)


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
    phase("2. the kernels: built, then held against their plain versions "
          f"by {CUDA_TESTS[-1]} in a process of its own")
    phase_build()
    children = [_spawn("phase 2, the kernel tests", CUDA_TESTS, work)]
    children += [_spawn(
        f"phases {', '.join(numbers)}",
        [sys.executable, str(Path(__file__).resolve()), "--side-phases",
         ",".join(numbers), repr(start)], work) for numbers in SIDE_PHASES]
    log(f"phases {' and '.join(', '.join(n) for n in SIDE_PHASES)} start "
        "in processes of their own (their logs follow phase 14)")
    with tempfile.TemporaryDirectory(prefix="coot_chip_smoke_") as tmp:
        phase("3. validation + embedding export at yc2_2d3d_coot width, "
              "four ways")
        phase_slice(Path(tmp) / "val")
        phase("4. training at yc2_2d3d_coot width")
        launches, shapes = phase_train(Path(tmp) / "train")
        phase("4b. synthetic_smoke.yaml trained on the card (ragged input "
              "FC widths, small GenPool)")
        phase_synthetic_smoke(Path(tmp) / "smoke")
        phase("4c. the group step: K train steps a dispatch, each a replay "
              "of the captured train step")
        phase_group(Path(tmp) / "group")
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
    with tempfile.TemporaryDirectory(prefix="coot_chip_serving_") as tmp:
        phase("13. serving graphs: the caption decodes and the retrieval "
              "and caption eval steps as CUDA graphs against eager, at full "
              "width")
        graph_launches = phase_serving_graphs(Path(tmp))
    phase("14. the caption train programs: every caption model's train "
          "step captured, against the eager step, at full width")
    programs = phase_train_programs()
    log("phase 2, the kernel tests: "
        + kernel_tests_summary(_join(children[0])))
    for child in children[1:]:
        _join(child)
    phase("the card is the main process's alone from here on")
    phase(f"5. kernel timing at the training path's shapes {shapes}")
    kernels = phase_timing(launches, shapes)
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
