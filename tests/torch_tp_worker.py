"""
The rank processes of tests/test_torch_tp.py: each joins a gloo process
group through a file, takes its place in the spec's {data, model} mesh,
shards the model by the tensor-parallel rules (parallel/tp.py) and runs
the port's steps on its data rank's rows of the global batch; it saves the
whole tensors (gathered over its model group) for the test to hold against
JAX. Imports torch and the port only, so that a rank starts quickly.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from coot_videotext_tpu_torch.data.device_store import FeatureSource
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.models.attention import MultiHeadAttention
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.parallel.tp import shard_model_for_tp
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_train_step, caption_train_step_single, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    EMB_KEYS, retrieval_eval_step, retrieval_train_step)
from coot_videotext_tpu_torch.utils.param_bridge import load_mart_checkpoint
from tests.torch_parallel_worker import (
    CPU, LR, _np, _torch, loss_kw, retrieval_state)


def _whole(tp, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return _np(tp.gather(tensors) if tp is not None else tensors)


def attention_modes(model) -> Dict[str, str]:
    """{module name: "heads" | "gathered" | "whole"} of every attention
    block of the retrieval model."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            out[name] = ("heads" if m.tp is not None else "gathered"
                         if m.query_projection.tp is not None else "whole")
    return out


def retrieval_runs(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One train step on the first global id batch (clipping 1.0) and the
    eval step on the first val batch, each from the bridged weights on the
    sharded model."""
    cfg = RetrievalConfig(copy.deepcopy(spec["cfg"]))
    _, _, loader, val_loader = create_retrieval_datasets_and_loaders(
        cfg, spec["root"], seed=0, fixed_shapes=True, device_preload=True,
        mesh=mesh)
    state = retrieval_state(cfg, spec["weights"], mesh)
    state.tp = shard_model_for_tp(state.model, state.optimizer, None, mesh)
    batch = _torch(next(iter(loader)))
    metrics = retrieval_train_step(state, batch, lr=LR, clip_gradient=1.0,
                                   source=FeatureSource.of(loader),
                                   **loss_kw(cfg))
    out: Dict[str, Any] = {
        "step": {"metrics": _np(metrics),
                 "params": _whole(state.tp, dict(
                     state.model.named_parameters())),
                 "mu": _whole(state.tp, state.optimizer.mu),
                 "dp_idx": pmesh.all_gather_rows(
                     mesh, batch["dp_idx"]).numpy()},
        "shards": dict(state.tp.shards) if state.tp else {},
        "partial": state.tp.partial if state.tp else (),
        "modes": attention_modes(state.model)}
    state = retrieval_state(cfg, spec["weights"], mesh)
    shard_model_for_tp(state.model, None, None, mesh)
    vbatch = _torch(next(iter(val_loader)))
    embs, parts = retrieval_eval_step(
        state.model, vbatch, source=FeatureSource.of(val_loader),
        mesh=mesh, **loss_kw(cfg))
    out["eval"] = {"parts": _np(parts), "embs": _np(
        {k: pmesh.all_gather_rows(mesh, embs[k]) for k in EMB_KEYS})}
    return out


def decodes(model, cfg, inputs: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Greedy and beam tokens of `model` (eval mode) on the stacked
    inputs: [(N, max_t_len)] * S each, and the greedy decode's token steps
    on key / value caches."""
    args = [torch.from_numpy(np.asarray(inputs[k])) for k in
            ("input_ids", "video_feature", "input_mask", "token_type_ids")]
    translator = Translator(model, cfg)
    out = {"greedy": translator.translate_batch_greedy(*args),
           "cached_tokens": translator.cached_tokens}
    out["beam"] = translator.translate_batch_beam(*args)
    return out


def caption_run(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One MART step on the data rank's rows (dim 1) of the stacked batch,
    on the sharded model, BertAdam and EMA; then the greedy and beam
    decodes of the whole batch on the sharded model."""
    inputs = spec["caption_inputs"]
    rows = pmesh.batch_rows(mesh, inputs["input_ids"].shape[1])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:, rows]))
             for k, v in inputs.items()}
    cfg = MartConfig(copy.deepcopy(spec["caption_cfg"]))
    model = create_mart_model(cfg, spec["vocab"], CPU)
    load_mart_checkpoint(model, {"model": copy.deepcopy(
        spec["caption_weights"])})
    state = init_caption_train_state(model, cfg, 0, mesh)
    state.tp = shard_model_for_tp(model, state.optimizer, state.ema, mesh)
    metrics = caption_train_step(state, batch, LR)
    return {"metrics": _np(metrics),
            "params": _whole(state.tp, dict(model.named_parameters())),
            "ema": _whole(state.tp, state.ema.shadow),
            "shards": dict(state.tp.shards) if state.tp else {},
            "decodes": decodes(model, cfg, inputs)}


def replicated_runs(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One train step of each caption model of spec["replicated"] (the
    TransformerXL, the untied, joint and MTransformer models) from its
    weights on its whole batch (the mesh has one data rank), under the
    layout that `shard_model_for_tp` gives it: its type, the shards, the
    metrics, the parameters and the EMA."""
    out = {}
    for name, run in spec["replicated"].items():
        cfg = MartConfig(copy.deepcopy(run["cfg"]))
        model = create_mart_model(cfg, spec["vocab"], CPU)
        model.load_state_dict(run["weights"])
        state = init_caption_train_state(model, cfg, 0, mesh)
        state.tp = shard_model_for_tp(model, state.optimizer, state.ema,
                                      mesh)
        step = caption_train_step if cfg.recurrent else \
            caption_train_step_single
        metrics = step(state, _torch(run["inputs"]), LR)
        out[name] = {"type": type(model).__name__,
                     "shards": dict(state.tp.shards),
                     "metrics": _np(metrics),
                     "params": _np(dict(model.named_parameters())),
                     "ema": _np(state.ema.shadow)}
    return out


def run(rank: int, world: int, init_file: str, spec_file: str,
        out_dir: str) -> None:
    """Rank `rank` of `world`: joins the group, takes its place in
    spec["mesh_shape"], runs the spec's runs and saves them to
    out_dir/rank<rank>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        spec = torch.load(spec_file, weights_only=False)
        mesh = pmesh.get_mesh(spec["mesh_shape"], "cpu")
        out: Dict[str, Any] = {"rank": mesh.rank,
                               "data_rank": mesh.data_rank,
                               "model_rank": mesh.model_rank}
        if spec.get("cfg"):
            out["retrieval"] = retrieval_runs(spec, mesh)
        if spec.get("caption_cfg"):
            out["caption"] = caption_run(spec, mesh)
        if spec.get("replicated"):
            out["replicated"] = replicated_runs(spec, mesh)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
