"""
Retrieval validation and embedding export.

Counterpart of coot_videotext_tpu/tasks/retrieval/trainer.py::
RetrievalTrainer.validate_epoch :317-400 (reference
trainer_retrieval.py:312): every val batch goes through the eval step, the
valid clip/sentence rows and the real videos are collected (:352-367), the
val loss is averaged over batches, the retrieval ranks are computed on the
device, and with `emb_file` the embeddings are written in the h5 schema of
:374-385 (what test_embeddings_retrieval.py and the caption task read); an
`.npz` emb_file holds the same arrays under the same names, for machines
without h5py.
Every loader mode of the JAX trainer runs, each behind the prefetch
pipeline (data/pipeline.py, JAX :339): dense and slab batches from the
host (copied pinned and non-blocking on a side stream), index batches over
the device store and id batches sampled on the device (center sampling,
no noise); keys and sentences come from the host part of the batch. On CUDA the kernels B1-B3 and B5
always run. Under a data-parallel mesh each rank runs the eval step on its
rows of every val batch; the batch's embeddings, validity and keys are
gathered in the global batch's order, so every rank collects the whole
split and computes the same val loss and ranks (JAX :339-400 on its
`data` axis).
The eval step runs as a captured program (tasks/retrieval/steps.py
`retrieval_eval_step`, a CUDA graph on the card) on the layouts whose
shapes are fixed: id batches, and index and slab batches under fixed
shapes; host dense batches, whose shapes vary per batch, and any batch
under a mesh of more than one rank (parallel/mesh.py `serves_captured`)
run it eagerly. The log line and the results say which ran
(`eval_step`). The step's outputs are views of the program's outputs, so
every batch is read to the host before the next batch's step.
"""

from __future__ import annotations

import logging
from pathlib import Path
from timeit import default_timer as timer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from coot_videotext_tpu_torch.data.device_store import FeatureSource
from coot_videotext_tpu_torch.data.pipeline import prefetch
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    RetrievalBatchLoader)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.models.retrieval import RetrievalModel
from coot_videotext_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, gather_objects, serves_captured)
from coot_videotext_tpu_torch.tasks.retrieval import eval as retrieval
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    EMB_KEYS, retrieval_eval_step)


def write_embeddings(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """The export schema as h5 (`.h5`, the JAX trainer's format) or as a
    numpy archive (`.npz`)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".npz":
        np.savez(path, **arrays)
        return
    if path.suffix != ".h5":
        raise ValueError(f"embedding file must be .h5 or .npz: {path}")
    import h5py
    with h5py.File(path, "w") as h5:
        for name, value in arrays.items():
            h5[name] = [str(k) for k in value] if name == "key" else value


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate_retrieval(model: RetrievalModel, cfg,
                       val_loader: RetrievalBatchLoader,
                       device: torch.device, *,
                       compute_dtype: torch.dtype,
                       val_clips: bool,
                       emb_file: Optional[Path] = None,
                       cc_seed: Optional[int] = None,
                       logger: Optional[logging.Logger] = None,
                       mesh: Optional[Mesh] = None,
                       eager: bool = False) -> Dict[str, Any]:
    """One validation pass. With `cc_seed` the val loss subsamples the
    cycle consistency from a seed state of that value, advanced once per
    batch (ops/philox.py); without it takes the full mean. Returns the
    losses, the metrics per modality
    (`v2p`, `p2v`, and with val_clips `c2s`, `s2c`), `val_score` from
    `cfg.val.det_best_field`, timings (`forward_s` is the device time of
    the eval steps, `total_s` the whole pass) and the collected
    L2-normalized embeddings (`embeddings`, numpy). The eval step runs
    eagerly with `eager`, on host dense batches and under a mesh of more
    than one rank, else as a captured program; `eval_step` says which."""
    log = logger.info if logger is not None else print
    loss_w = cfg.train.contrastive_loss_config.as_dict()
    margin = cfg.train.contrastive_loss_config.margin
    start = timer()
    collected: Dict[str, List[np.ndarray]] = {k: [] for k in EMB_KEYS}
    collected_raw: Dict[str, List[np.ndarray]] = {k: [] for k in EMB_KEYS}
    clip_nums: List[int] = []
    sent_nums: List[int] = []
    keys: List[str] = []
    loss_sums = {"loss_total": 0.0, "loss_contrastive": 0.0, "loss_cc": 0.0}
    forward_s = 0.0
    num_steps = 0
    source = FeatureSource.of(val_loader)
    seed_state = (None if cc_seed is None
                  else philox.seed_state(cc_seed, device))
    eager = eager or not serves_captured(mesh) or not (
        val_loader.layout == "ids" or (val_loader.layout != "dense"
                                       and val_loader.fixed_shapes))
    eval_mode = ("eager" if eager else
                 "CUDA graph" if device.type == "cuda" else
                 "program body, eagerly on the cpu")
    for tensors, host in prefetch(val_loader, device):
        batch = {**host, **tensors}
        _sync(device)
        t0 = timer()
        embs, parts = retrieval_eval_step(
            model, batch, loss_weights=loss_w, margin=margin,
            loss_cycle_cons=cfg.train.loss_cycle_cons,
            compute_dtype=compute_dtype, seed_state=seed_state,
            source=source, mesh=mesh, eager=eager)
        embs = {k: all_gather_rows(mesh, v) for k, v in embs.items()}
        batch_valid = all_gather_rows(mesh, tensors["batch_valid"])
        if seed_state is not None:
            seed_state.add_(1)
        _sync(device)
        forward_s += timer() - t0
        num_steps += 1
        for name in loss_sums:
            loss_sums[name] += float(parts[name])
        embs = {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in embs.items()}
        bv = batch_valid.cpu().numpy()
        valid = {"clip_emb": embs["clip_valid"].astype(bool) & bv[:, None],
                 "sent_emb": embs["sent_valid"].astype(bool) & bv[:, None]}
        for key in EMB_KEYS:
            sel = valid.get(key, bv)
            collected[key].append(embs[key][sel])
            collected_raw[key].append(embs[f"{key}_before_norm"][sel])
        clip_nums += list(embs["clip_num"][bv])
        sent_nums += list(embs["sent_num"][bv])
        for rank_keys in gather_objects(mesh, list(host["key"])):
            keys += rank_keys  # only the real datapoints

    data_norm = {k: np.concatenate(v, axis=0) for k, v in collected.items()}
    data_raw = {k: np.concatenate(v, axis=0)
                for k, v in collected_raw.items()}
    if emb_file is not None:
        arrays = {"clip_num": np.asarray(clip_nums, np.int64),
                  "sent_num": np.asarray(sent_nums, np.int64),
                  "key": np.asarray([str(k) for k in keys])}
        for key in EMB_KEYS:
            arrays[key] = data_norm[key]
            arrays[f"{key}_before_norm"] = data_raw[key]
        write_embeddings(emb_file, arrays)
        log(f"Saved embeddings to {emb_file}")

    losses = {k: v / max(num_steps, 1) for k, v in loss_sums.items()}
    log(retrieval.VALHEADER)
    results: Dict[str, Any] = dict(losses)
    res_v2p, res_p2v, sum_vp_at_1, str_vp = retrieval.compute_retrieval(
        data_norm, "vid_emb", "par_emb", device, print_fn=log)
    results.update(v2p=res_v2p, p2v=res_p2v)
    sum_cs_at_1 = None
    str_cs = ""
    if val_clips:
        res_c2s, res_s2c, sum_cs_at_1, str_cs = retrieval.compute_retrieval(
            data_norm, "clip_emb", "sent_emb", device, print_fn=log)
        results.update(c2s=res_c2s, s2c=res_s2c)
    total_s = timer() - start
    log(f"Loss {losses['loss_total']:.5f} (Contr: "
        f"{losses['loss_contrastive']:.5f}, CC: {losses['loss_cc']:.5f}) "
        f"Retrieval: {str_vp}{str_cs}total {total_s:.3f}s, forward "
        f"{forward_s:.3f}s (eval step: {eval_mode})")

    best_field = cfg.val.det_best_field
    if best_field == "val_score_at_1":
        val_score = sum_vp_at_1
    elif best_field == "val_loss":
        val_score = losses["loss_total"]
    elif best_field == "val_clip_sent_score_at_1":
        if sum_cs_at_1 is None:
            raise ValueError("det_best_field val_clip_sent_score_at_1 "
                             "needs val_clips")
        val_score = sum_cs_at_1
    else:
        raise NotImplementedError(f"best field {best_field} not known")
    results.update(
        val_score=val_score, num_videos=len(keys), num_batches=num_steps,
        forward_s=forward_s, total_s=total_s, embeddings=data_norm,
        eval_step=eval_mode)
    return results
