"""
Data- and tensor-parallel retrieval training on one host: the CLI under
torchrun over NCCL, on the device-resident path in groups of K = 4 steps,
at each mesh first held against the first mesh, then timed.

    python3 coot_videotext_tpu_torch/tools/dp_scaling.py [--meshes 1,2,4]
    python3 coot_videotext_tpu_torch/tools/dp_scaling.py --meshes 4,2x2,1x4

generates a yc2-like split at yc2_2d3d_coot.yaml width (VIDEOS train and
VAL_VIDEOS val videos, npy features), then for each mesh runs `torchrun
--standalone --nproc_per_node=W -m coot_videotext_tpu_torch.train_retrieval
-c <yaml> --preload_device --fixed_shapes` (the yaml's global batch, 64,
split over the data ranks). `--meshes` gives D (W = D data ranks) or DxM
({data: D, model: M}, W = D x M: tensor parallelism, parallel/tp.py,
over each group of M ranks, written to the yaml's mesh_shape):

- the check: float32, every dropout and the feature noise at 0, one epoch
  on the first CHECK_VIDEOS train videos and validation. Each mesh after
  the first is held against the first: every step's loss, the val loss
  and the val score within CHECK_RTOL relative, and rank 0's saved
  parameters within CHECK_UPDATE_TOL of lr a step (the tolerances of
  chip_smoke.py phase 11b). The tool exits non-zero where a mesh
  disagrees.
- the eval step: each check and speed record lists how the run's
  validations ran it on every rank (`eval_steps`, the `(eval step: ...)`
  of the ranks' logs in torchrun's output): through its CUDA graph, also
  over NCCL (parallel/mesh.py `capturable`); the tool fails where one ran
  eagerly.
- every torchrun must exit with 0 within RUN_LIMIT_S: a run that hangs
  (at the process group's end, say) is killed with its ranks and fails
  the tool, instead of waiting for NCCL's watchdog.
- the speed: the yaml as it is (bfloat16, dropout 0.01), EPOCHS epochs of
  the VIDEOS videos; train videos/s and wall ms per step over epochs 1 ..
  EPOCHS-1 (epoch 0 holds the graph's capture) from the trainer's own
  epoch times (validation excluded), the run's wall seconds and the
  losses of the last epoch.
- the NCCL share: each mesh's ranks (torchrun of this file with
  `--trace_rank`) train per step on the same split in bfloat16,
  WARM_STEPS steps untraced, then TRACED_STEPS steps under torch.profiler:
  rank 0's wall ms per step, and the time its kernels cover on the card
  (the union of their spans: kernels of other streams overlap), that of
  its NCCL kernels (a kernel name with "nccl"; the profiler's `nccl:*`
  ranges, which enclose them, are not kernels) and that share of the wall
  time. An NCCL kernel runs from its launch until every rank of its group
  has joined, so its span holds the wait for the slowest rank.
  `--trace_only` runs this part alone.
- the caption meshes, CAPTION_MESHES ({data: 4} and {data: 2, model: 2}),
  first, on every call but `--trace_only`: MART at
  yc2_2d3d_coot_vidclip_mart.yaml width (the real YouCook2 annotations,
  COOT embeddings from seed 0, dropout 0) trains one epoch on the first
  CAPTION_VIDEOS train videos at the yaml's global batch of 16 and
  validates on CAPTION_VAL_VIDEOS val videos, under torchrun at each mesh
  and in one process without one. Each mesh is held against the one
  process at chip_smoke.py phase 11's tolerances: the epoch's train and
  val loss per word and accuracy and every step's grad norm within
  CHECK_RTOL relative, rank 0's saved parameters and EMA within
  CHECK_UPDATE_TOL of lr a step, at least CAPTION_MIN_SAME of the greedy
  val sentences identical. Every rank must log its train steps, eval
  steps and decodes as CUDA graphs, as counted by the programs' caches
  (`train step: CUDA graph`, `eval step and decode: CUDA graph`).

Prints the cards' names and power limits (nvidia-smi), then one JSON line
per mesh and run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "config" / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"
VIDEOS, VAL_VIDEOS = 640, 64
EPOCHS = 3
K = 4
CHECK_VIDEOS = 192           # 3 global batches of 64
WARM_STEPS, TRACED_STEPS = 3, 5
CHECK_RTOL = 1e-4
CHECK_UPDATE_TOL = 0.05      # a share of lr a step
NETS = ("net_video_local", "net_video_global", "net_text_local",
        "net_text_global")
RUN_LIMIT_S = 300            # one torchrun, ranks' start and exit included
CAPTION_CONFIG = (ROOT / "config" / "caption" / "paper2020" /
                  "yc2_2d3d_coot_vidclip_mart.yaml")
CAPTION_MESHES = ({"data": 4}, {"data": 2, "model": 2})
CAPTION_VIDEOS, CAPTION_VAL_VIDEOS = 64, 32
CAPTION_MIN_SAME = 0.98      # greedy val sentences identical (phase 6's)


def _config(work: Path, name: str, *, check: bool,
            mesh_shape: Optional[Dict[str, int]] = None) -> Path:
    """yc2_2d3d_coot.yaml with npy features and train.steps_per_dispatch
    K, written to work/<name>.yaml; for the check in float32, without
    dropout or noise, on the first CHECK_VIDEOS videos; `mesh_shape` the
    yaml's mesh (None: every rank on `data`)."""
    import yaml
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(CONFIG)
    cfg["dataset_train"].update(vid_feat_source="npy",
                                text_feat_source="npy")
    cfg["train"]["steps_per_dispatch"] = K
    if check:
        cfg["fp16_train"] = cfg["fp16_val"] = False
        cfg["dataset_train"].update(frames_noise=0, words_noise=0,
                                    max_datapoints=CHECK_VIDEOS)
        for net in NETS:
            for group in ("selfatn_config", "crossatn_config",
                          "pooler_config"):
                if isinstance(cfg[net].get(group), dict) and \
                        "dropout" in cfg[net][group]:
                    cfg[net][group]["dropout"] = 0.0
    if mesh_shape is not None:
        cfg["mesh_shape"] = dict(mesh_shape)
    path = work / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf8")
    return path


def _generate(data: Path) -> None:
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    ds = load_yaml_config_file(CONFIG)["dataset_train"]
    generate_retrieval_dataset(
        data, dataset_name=ds["name"], metadata_name=ds["metadata_name"],
        vid_feat_name=ds["vid_feat_name"],
        text_feat_name=ds["text_feat_name"], num_videos=VIDEOS,
        num_val_videos=VAL_VIDEOS, vid_feat_dim=ds["vid_feat_dim"],
        text_feat_dim=ds["text_feat_dim"], mean_clips=7.7, max_clips=16,
        fps=1.0, mean_duration_sec=320.0, tokens_per_sentence=18, seed=3,
        feat_format="npy")


def _run(world: Optional[int], args: list) -> subprocess.CompletedProcess:
    """`torchrun --standalone --nproc_per_node=world` of `args` (world
    None: one python process), in a session of its own: past RUN_LIMIT_S
    the whole session (torchrun and its ranks) is killed and the run
    fails."""
    cmd = ([sys.executable] + args if world is None else
           [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={world}"] + args)
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    t0 = time.time()
    try:
        out, err = proc.communicate(timeout=RUN_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        print(out[-3000:], err[-3000:], flush=True)
        raise RuntimeError(f"{' '.join(cmd[1:6])}: no exit within "
                           f"{RUN_LIMIT_S} s (hung); killed with its ranks")
    done = subprocess.CompletedProcess(cmd, proc.returncode, out, err)
    done.seconds = time.time() - t0
    if done.returncode != 0:
        print(done.stdout[-3000:], done.stderr[-3000:], flush=True)
        raise RuntimeError(f"the run at {world or 1} rank(s) exited with "
                           f"{done.returncode}")
    return done


def _torchrun(world: int, config: Path, data: Path, log_dir: Path,
              epochs: int) -> tuple:
    """One torchrun of the CLI at `world` ranks: (its experiment dir, how
    every rank's validations ran the eval step, in the order logged)."""
    done = _run(world, [
        "-m", "coot_videotext_tpu_torch.train_retrieval", "-c",
        str(config), "--data_path", str(data), "--log_dir", str(log_dir),
        "--preload_device", "--fixed_shapes", "-o",
        f"train.num_epochs={epochs},val.val_start=0,saving.keep_freq=1"])
    (models,) = list(log_dir.rglob("models"))
    return models.parent, _labels(done, "eval step")


def _labels(done, what: str) -> List[str]:
    """Every `(...what: <label>)` of the ranks' logs in a run's output."""
    return re.findall(rf"{what}: ([^)]*)\)", done.stdout + done.stderr)


def _all_captured(labels: List[str], world: int, what: str) -> None:
    """Fails unless every rank logged and every label is `CUDA graph`."""
    if not labels or len(labels) % world \
            or any(label != "CUDA graph" for label in labels):
        raise RuntimeError(f"{what} at {world} rank(s): {labels} (every "
                           f"rank must run it as a CUDA graph)")


def _metrics(exp: Path, kind: str, epoch: int) -> dict:
    """The metrics file of `kind` ("step" or "epoch") after `epoch`."""
    return json.loads((exp / "metrics" / f"metrics_{kind}_{epoch}.json"
                       ).read_text(encoding="utf8"))


def _series(metrics: dict, key: str) -> list:
    return [v for _, v in metrics.get(key, [])]


def _name(mesh: Dict[str, int]) -> str:
    return "x".join(str(mesh[a]) for a in ("data", "model") if a in mesh)


def _world(mesh: Dict[str, int]) -> int:
    return mesh["data"] * mesh.get("model", 1)


def check(mesh: Dict[str, int], config: Path, data: Path,
          work: Path) -> dict:
    """The check run under `mesh`: its per-step losses, val loss and
    score, and rank 0's parameters."""
    import torch
    exp, labels = _torchrun(_world(mesh), config, data,
                            work / f"check_{_name(mesh)}", 1)
    _all_captured(labels, _world(mesh), "the eval step")
    epoch = _metrics(exp, "epoch", 0)
    return {"world": _name(mesh),
            "loss": _series(_metrics(exp, "step", 0), "train_base/loss"),
            "val": _series(epoch, "val_base/loss")
            + _series(epoch, "val_base/best_field"),
            "eval_steps": labels,
            "params": torch.load(exp / "models" / "model_0.pth",
                                 weights_only=True)}


def hold(got: dict, ref: dict, lr: float) -> dict:
    """`got` against `ref`: the largest relative difference of the losses
    and val numbers, and the largest parameter difference as a share of lr
    a step; raises past the tolerances."""
    rel = 0.0
    for key in ("loss", "val"):
        if len(got[key]) != len(ref[key]) or not ref[key]:
            raise RuntimeError(f"W = {got['world']}: {len(got[key])} {key} "
                               f"values, W = {ref['world']} {len(ref[key])}")
        rel = max([rel] + [abs(a - b) / max(abs(b), 1e-12)
                           for a, b in zip(got[key], ref[key])])
    steps = len(ref["loss"])
    diff = max(float((got["params"][net][k].float()
                      - ref["params"][net][k].float()).abs().max())
               for net in ref["params"] for k in ref["params"][net])
    share = diff / lr / steps
    record = {"world": got["world"], "against": ref["world"],
              "steps": steps,
              "max_rel": rel, "params_share_of_lr": share,
              "eval_steps": got["eval_steps"],
              "ref_eval_steps": ref["eval_steps"],
              "val": got["val"], "ref_val": ref["val"],
              "loss": got["loss"], "ref_loss": ref["loss"]}
    print(json.dumps({"check": record}), flush=True)
    if rel > CHECK_RTOL or share > CHECK_UPDATE_TOL:
        raise RuntimeError(
            f"W = {got['world']} disagrees with W = {ref['world']}: "
            f"{rel:.3e} relative (limit {CHECK_RTOL}), parameters "
            f"{share:.3%} of lr a step (limit {CHECK_UPDATE_TOL:.0%})")
    return record


def speed(mesh: Dict[str, int], config: Path, data: Path,
          work: Path) -> dict:
    """The timed run under `mesh`; its record."""
    t0 = time.time()
    exp, labels = _torchrun(_world(mesh), config, data,
                            work / f"w{_name(mesh)}", EPOCHS)
    wall = time.time() - t0
    _all_captured(labels, _world(mesh), "the eval step")

    def state(ep):
        return json.loads((exp / "models" / f"trainerstate_{ep}.json"
                           ).read_text(encoding="utf8"))
    train_s = [(state(ep)["time_total"] - state(ep)["time_val"])
               - (state(ep - 1)["time_total"] - state(ep - 1)["time_val"])
               for ep in range(1, EPOCHS)]
    steps = state(EPOCHS - 1)["total_step"] // EPOCHS
    losses = _series(_metrics(exp, "step", EPOCHS - 1),
                     "train_base/loss")[-steps:]
    return {"world": _name(mesh), "mesh_shape": mesh,
            "steps_per_epoch": steps,
            "train_videos_per_s": (EPOCHS - 1) * VIDEOS / sum(train_s),
            "ms_per_step": 1e3 * sum(train_s) / ((EPOCHS - 1) * steps),
            "epoch_train_s": train_s, "run_wall_s": wall,
            "eval_steps": labels,
            "last_epoch_losses": losses}


def trace_rank(config: Path, data: Path) -> None:
    """One rank of the traced run (started by torchrun): the train state
    of the yaml's mesh, sharded by the rules under a `model` axis, trains
    per step on id batches; rank 0 prints the record of TRACED_STEPS
    traced steps after WARM_STEPS."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders, to_device)
    from coot_videotext_tpu_torch.ops import philox
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    from coot_videotext_tpu_torch.parallel.tp import shard_model_for_tp
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        TrainState, retrieval_train_step)
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    from coot_videotext_tpu_torch.utils.profiling import (
        WARMUP_KERNEL, warm_trace)
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = RetrievalConfig(load_yaml_config_file(config))
    mesh = pmesh.get_mesh(cfg.mesh_shape, "cuda")
    try:
        device = mesh.device
        _, _, loader, _ = create_retrieval_datasets_and_loaders(
            cfg, data, seed=0, device=device, fixed_shapes=True,
            device_preload=True, mesh=mesh)
        mgr = RetrievalModelManager(cfg, device, seed=0)
        pmesh.broadcast_params(mesh, mgr.model.parameters())
        state = TrainState(mgr.model, make_optimizer(
            cfg.optimizer, dict(mgr.model.named_parameters())),
            philox.seed_state(0, device), mesh=mesh)
        state.tp = shard_model_for_tp(state.model, state.optimizer, None,
                                      mesh)
        w = cfg.train.contrastive_loss_config
        kw = dict(lr=cfg.optimizer.lr, clip_gradient=cfg.train.clip_gradient,
                  loss_weights=w.as_dict(), margin=w.margin,
                  loss_cycle_cons=cfg.train.loss_cycle_cons,
                  compute_dtype=mgr.train_dtype,
                  source=FeatureSource.of(
                      loader, cfg.dataset_train.frames_noise,
                      cfg.dataset_train.words_noise))
        batches = [to_device(b, device) for b in loader]

        def steps(n, first):
            for i in range(n):
                retrieval_train_step(state, batches[(first + i)
                                                    % len(batches)], **kw)
        steps(WARM_STEPS, 0)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_trace()
            t0 = time.perf_counter()
            steps(TRACED_STEPS, WARM_STEPS)
            torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED_STEPS
        if mesh.is_writer:
            with tempfile.TemporaryDirectory(prefix="dp_trace_") as tmp:
                path = Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(path))
                events = json.loads(path.read_text())["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"
                       and WARMUP_KERNEL not in e["name"]]
            nccl = [e for e in kernels if "nccl" in e["name"].lower()]
            print("TRACE " + json.dumps({
                "mesh_shape": cfg.mesh_shape, "ranks": mesh.world,
                "traced_steps": TRACED_STEPS, "wall_ms_per_step": wall_ms,
                "kernels_per_step": len(kernels) / TRACED_STEPS,
                "device_busy_ms_per_step": _union_ms(kernels) / TRACED_STEPS,
                "nccl_kernels_per_step": len(nccl) / TRACED_STEPS,
                "nccl_ms_per_step": _union_ms(nccl) / TRACED_STEPS,
                "nccl_share_of_wall": _union_ms(nccl) / TRACED_STEPS
                / wall_ms,
                "nccl_kernels": sorted({e["name"][:80] for e in nccl})}),
                flush=True)
    finally:
        pmesh.destroy(mesh)


def _union_ms(events: list) -> float:
    """The time (ms) covered by the trace events' [ts, ts + dur) spans, a
    span that overlaps another counted once (kernels on other streams)."""
    total, end = 0.0, -float("inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def trace(mesh: Dict[str, int], config: Path, data: Path) -> dict:
    """The traced run under `mesh` (`config` names it); rank 0's record."""
    done = _run(_world(mesh), [str(Path(__file__).resolve()),
                               "--trace_rank", str(config), "--data",
                               str(data)])
    (line,) = [ln for ln in done.stdout.splitlines()
               if ln.startswith("TRACE ")]
    return json.loads(line[len("TRACE "):])


# ---------- the caption meshes ----------

def _caption_embeddings(emb_dir: Path, config: Path) -> None:
    """COOT embeddings from seed 0 for every video and clip of the real
    YouCook2 caption splits, `<coot_model_name>_{train,val}.npz` in the
    export schema (unit rows at the config's widths)."""
    import numpy as np
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(config)
    ann = ROOT / "annotations" / "youcook2"
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
        np.savez(emb_dir / f"{cfg['coot_model_name']}_{split}.npz",
                 key=np.asarray(list(data)), clip_num=clip_num,
                 vid_emb=unit_rows(len(data), cfg["coot_dim_vid"]),
                 vid_context=unit_rows(len(data), cfg["coot_dim_vid"]),
                 clip_emb=unit_rows(int(clip_num.sum()),
                                    cfg["coot_dim_clip"]))


def _caption_config(work: Path, name: str,
                    mesh: Optional[Dict[str, int]]) -> Path:
    """CAPTION_CONFIG at dropout 0 for one epoch on the first
    CAPTION_VIDEOS train and CAPTION_VAL_VIDEOS val videos (val batches of
    half of them), validating after it; a `model` axis written as its
    mesh_shape."""
    import yaml
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    cfg = load_yaml_config_file(CAPTION_CONFIG)
    cfg.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               memory_dropout_prob=0.0)
    cfg["dataset_train"]["max_datapoints"] = CAPTION_VIDEOS
    cfg["dataset_val"]["max_datapoints"] = CAPTION_VAL_VIDEOS
    cfg["train"]["num_epochs"] = 1
    # a global val batch that splits over 4 data ranks
    cfg["val"].update(val_start=0, val_freq=1,
                      batch_size=CAPTION_VAL_VIDEOS // 2)
    if mesh is not None and mesh.get("model", 1) > 1:
        cfg["mesh_shape"] = dict(mesh)
    path = work / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False), encoding="utf8")
    return path


def caption_check(mesh: Optional[Dict[str, int]], work: Path) -> dict:
    """The caption CLI's epoch under `mesh` (torchrun; None: one process
    without one): its record, rank 0's parameters and EMA, and the greedy
    val sentences. Fails unless every rank ran its train steps, eval steps
    and decodes as CUDA graphs."""
    import torch
    name = "one" if mesh is None else _name(mesh)
    world = None if mesh is None else _world(mesh)
    config = _caption_config(work, f"caption_{name}", mesh)
    log_dir = work / f"caption_{name}"
    done = _run(world, [
        "-m", "coot_videotext_tpu_torch.train_caption", "-c", str(config),
        "--log_dir", str(log_dir), "--coot_feat_dir",
        str(work / "caption_embeddings"), "--seed", "0"])
    labels = {what: _labels(done, what)
              for what in ("train step", "eval step and decode")}
    for what, found in labels.items():
        _all_captured(found, world or 1, what)
    (models,) = list(log_dir.rglob("models"))
    exp = models.parent
    epoch = _metrics(exp, "epoch", 0)
    (translations,) = list(exp.rglob("translations_0_val.json"))
    results = json.loads(translations.read_text(encoding="utf8"))["results"]
    return {"world": name, "run_s": done.seconds, "labels": labels,
            "values": [_series(epoch, k)[-1] for k in (
                "train/loss_word", "train/acc", "val/loss_word", "val/acc")]
            + _series(_metrics(exp, "step", 0), "train/grad"),
            "cider": _series(epoch, "val/cider") or _series(epoch, "CIDEr"),
            "params": torch.load(models / "model_0.pth",
                                 weights_only=True)["model"],
            "ema": torch.load(models / "modelema_0.pth",
                              weights_only=True)["model"],
            "sentences": [s["sentence"] for v in sorted(results)
                          for s in results[v]]}


def caption_hold(got: dict, ref: dict, lr: float) -> dict:
    """A caption mesh's record against the one process: the relative
    differences of its values, the parameters' and the EMA's largest
    difference as a share of lr a step, the share of identical greedy
    sentences; raises past the tolerances."""
    if len(got["values"]) != len(ref["values"]):
        raise RuntimeError(f"caption {got['world']}: {len(got['values'])} "
                           f"values against {len(ref['values'])}")
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(got["values"], ref["values"]))
    steps = len(ref["values"]) - 4
    shares = {what: max(float((got[what][k].float()
                               - ref[what][k].float()).abs().max())
                        for k in ref[what]) / lr / steps
              for what in ("params", "ema")}
    same = (sum(a == b for a, b in zip(got["sentences"], ref["sentences"]))
            / max(len(ref["sentences"]), 1))
    record = {"caption_world": got["world"], "against": ref["world"],
              "steps": steps, "max_rel": rel,
              "params_share_of_lr": shares["params"],
              "ema_share_of_lr": shares["ema"],
              "sentences": len(ref["sentences"]),
              "same_sentences": same, "labels": got["labels"],
              "run_s": got["run_s"], "ref_run_s": ref["run_s"],
              "values": got["values"], "ref_values": ref["values"]}
    print(json.dumps({"caption_check": record}), flush=True)
    if rel > CHECK_RTOL or max(shares.values()) > CHECK_UPDATE_TOL \
            or len(got["sentences"]) != len(ref["sentences"]) \
            or same < CAPTION_MIN_SAME:
        raise RuntimeError(
            f"caption {got['world']} disagrees with one process: {rel:.3e} "
            f"relative (limit {CHECK_RTOL}), parameters / EMA "
            f"{shares['params']:.3%} / {shares['ema']:.3%} of lr a step "
            f"(limit {CHECK_UPDATE_TOL:.0%}), {same:.1%} sentences "
            f"identical (at least {CAPTION_MIN_SAME:.0%})")
    return record


def captions(work: Path) -> None:
    """The caption meshes, each against one process."""
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    _caption_embeddings(work / "caption_embeddings", CAPTION_CONFIG)
    ref = caption_check(None, work)
    print(json.dumps({"caption_one_process": {
        k: ref[k] for k in ("run_s", "labels", "values")}}), flush=True)
    lr = float(load_yaml_config_file(CAPTION_CONFIG)["lr"])
    for mesh in CAPTION_MESHES:
        caption_hold(caption_check(mesh, work), ref, lr)


def _meshes(spec: str) -> List[Dict[str, int]]:
    out = []
    for item in spec.split(","):
        d, _, m = item.partition("x")
        out.append({"data": int(d), "model": int(m)} if m
                   else {"data": int(d)})
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--meshes", default="1,2,4",
                        help="D or DxM ({data: D, model: M}), comma "
                             "separated; the first is the check's reference")
    parser.add_argument("--trace_only", action="store_true",
                        help="only the traced runs (no check, no timed CLI "
                             "runs, no caption meshes)")
    parser.add_argument("--trace_rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--data", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.trace_rank is not None:
        trace_rank(Path(args.trace_rank), Path(args.data))
        return
    meshes = _meshes(args.meshes)
    sys.path.insert(0, str(ROOT))
    from coot_videotext_tpu_torch.utils.yaml_utils import (
        load_yaml_config_file)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from coot_videotext_tpu_torch.ops import cuda_build
    t0 = time.time()  # built once, before the ranks load it
    print(f"kernels {cuda_build.build_library()} in "
          f"{time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_scaling_") as tmp:
        work = Path(tmp)
        if not args.trace_only:
            t0 = time.time()
            captions(work)
            print(f"caption meshes in {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        _generate(work / "data")
        print(f"generated {VIDEOS} + {VAL_VIDEOS} videos in "
              f"{time.time() - t0:.1f} s", flush=True)
        ref = None
        for mesh in [] if args.trace_only else meshes:
            tp = mesh.get("model", 1) > 1
            check_cfg = _config(work, f"check_{_name(mesh)}", check=True,
                                mesh_shape=mesh if tp else None)
            lr = load_yaml_config_file(check_cfg)["optimizer"]["lr"]
            got = check(mesh, check_cfg, work / "data", work)
            if ref is None:
                ref = got
            else:
                hold(got, ref, lr)
        for mesh in meshes:
            tp = mesh.get("model", 1) > 1
            speed_cfg = _config(work, f"speed_{_name(mesh)}", check=False,
                                mesh_shape=mesh if tp else None)
            if not args.trace_only:
                print(json.dumps(speed(mesh, speed_cfg, work / "data",
                                       work)), flush=True)
            trace_cfg = _config(work, f"trace_{_name(mesh)}", check=False,
                                mesh_shape=mesh)
            print(json.dumps({"trace": trace(mesh, trace_cfg,
                                             work / "data")}), flush=True)


if __name__ == "__main__":
    main()
