"""
The rank processes of tests/test_torch_parallel.py: each joins a gloo
process group through a file, runs the port's data-parallel steps on its
rows of the global batch and saves what it saw (numpy arrays) for the test
to hold against JAX and against one process. Imports torch and the port
only, so that a rank starts quickly.
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
from coot_videotext_tpu_torch.examples.mlp_mnist import (
    MLPMNISTDataLoader, MLPModel, make_synthetic_mnist, mlp_train_step)
from coot_videotext_tpu_torch.models.layers import Dropout
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_train_step, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    EMB_KEYS, TrainState, retrieval_eval_step, retrieval_train_group,
    retrieval_train_step)
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.utils.param_bridge import load_mart_checkpoint

CPU = torch.device("cpu")
LR = 1e-3


def _np(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().numpy() if v.is_floating_point()
            else v.detach().numpy() for k, v in tensors.items()}


def loss_kw(cfg) -> Dict[str, Any]:
    w = cfg.train.contrastive_loss_config
    return dict(loss_weights=w.as_dict(), margin=w.margin,
                loss_cycle_cons=cfg.train.loss_cycle_cons)


def retrieval_state(cfg, weights, mesh) -> TrainState:
    """The train state of the bridged `weights` ({net: state_dict})."""
    mgr = RetrievalModelManager(cfg, CPU, seed=1)
    mgr.load_state(copy.deepcopy(weights))
    return TrainState(mgr.model, optim.make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0), mesh=mesh)


def _snapshot(state: TrainState, metrics) -> Dict[str, Any]:
    opt = state.optimizer
    return {"metrics": _np(metrics),
            "params": _np(dict(state.model.named_parameters())),
            "mu": _np(opt.mu)}


def _torch(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


def with_dropout(cfg_dict: Dict[str, Any], rate: float) -> Dict[str, Any]:
    """`cfg_dict` with every net's self-attention dropout at `rate`."""
    cfg_dict = copy.deepcopy(cfg_dict)
    for net in ("net_video_local", "net_video_global", "net_text_local",
                "net_text_global"):
        cfg_dict[net]["selfatn_config"]["dropout"] = rate
    return cfg_dict


def first_dropout_mask(model, run) -> torch.Tensor:
    """Runs `run()` with a forward hook on every Dropout of `model`: where
    the first dropout call at a rate in (0, 1) zeroed a nonzero input, as
    a bool tensor."""
    seen = []

    def hook(module, inputs, output):
        if module.training and 0 < module.rate < 1 and not seen:
            seen.append(((inputs[0] != 0) & (output == 0)).detach())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Dropout)]
    try:
        run()
    finally:
        for handle in handles:
            handle.remove()
    return seen[0]


def step_mask(spec: Dict[str, Any], mesh) -> np.ndarray:
    """The first dropout mask of one train step on the rank's rows of the
    first global id batch, at self-attention dropout 0.01."""
    cfg = RetrievalConfig(with_dropout(spec["cfg"], 0.01))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, spec["root"], seed=0, fixed_shapes=True, device_preload=True,
        mesh=mesh)
    state = retrieval_state(cfg, spec["weights"], mesh)
    batch = _torch(next(iter(loader)))
    return first_dropout_mask(state.model, lambda: retrieval_train_step(
        state, batch, lr=LR, clip_gradient=1.0,
        source=FeatureSource.of(loader), **loss_kw(cfg))).numpy()


def retrieval_runs(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The runs that `spec["retrieval"]` names, each from the bridged
    weights: a step on index batches (store, host sampling), a step on id
    batches (device sampling and packing), the ragged last id batch, a
    group of 2 id batches, the eval step, and with `masks` the first
    dropout mask of a train step at dropout 0.01."""
    cfg_dict = spec["cfg"]
    runs = spec["retrieval"]
    out: Dict[str, Any] = {}
    cfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    kw = dict(lr=LR, clip_gradient=1.0, **loss_kw(cfg))
    if "indices" in runs:
        _, _, loader, _ = create_retrieval_datasets_and_loaders(
            cfg, spec["root"], seed=0, device_preload=True, mesh=mesh)
        batch = next(iter(loader))
        state = retrieval_state(cfg, spec["weights"], mesh)
        metrics = retrieval_train_step(state, _torch(batch),
                                       source=FeatureSource.of(loader), **kw)
        out["indices"] = _snapshot(state, metrics)
        out["indices"]["keys"] = list(batch["key"])
    _, _, loader, val_loader = create_retrieval_datasets_and_loaders(
        cfg, spec["root"], seed=0, fixed_shapes=True, device_preload=True,
        mesh=mesh)
    source = FeatureSource.of(loader)
    batches = list(loader)
    if "ids" in runs:
        state = retrieval_state(cfg, spec["weights"], mesh)
        metrics = retrieval_train_step(state, _torch(batches[0]),
                                       source=source, **kw)
        out["ids"] = _snapshot(state, metrics)
        out["ids"]["dp_idx"] = batches[0]["dp_idx"]
        out["pack_clips"] = loader.device_meta.shapes.get("pack_clips")
    if "ragged" in runs:
        state = retrieval_state(cfg, spec["weights"], mesh)
        metrics = retrieval_train_step(state, _torch(batches[-1]),
                                       source=source, **kw)
        out["ragged"] = _snapshot(state, metrics)
        out["ragged"]["batch_valid"] = batches[-1]["batch_valid"]
    if "group" in runs:
        state = retrieval_state(cfg, spec["weights"], mesh)
        ids = np.stack([b["dp_idx"] for b in batches[:2]])
        valid = np.stack([b["batch_valid"] for b in batches[:2]])
        metrics = retrieval_train_group(state, ids, valid, 2, source=source,
                                        **kw)
        out["group"] = _snapshot(state, metrics)
    if "eval" in runs:
        state = retrieval_state(cfg, spec["weights"], mesh)
        batch = _torch(next(iter(val_loader)))
        embs, parts = retrieval_eval_step(
            state.model, batch, source=FeatureSource.of(val_loader),
            mesh=mesh, **loss_kw(cfg))
        embs = {k: pmesh.all_gather_rows(mesh, embs[k]) for k in EMB_KEYS}
        out["eval"] = {"parts": _np(parts), "embs": _np(embs),
                       "batch_valid": pmesh.all_gather_rows(
                           mesh, batch["batch_valid"]).numpy()}
    if "draws" in runs:
        dcfg = RetrievalConfig(copy.deepcopy(spec["draws_cfg"]))
        _, _, dloader, _ = create_retrieval_datasets_and_loaders(
            dcfg, spec["root"], seed=0, fixed_shapes=True,
            device_preload=True, mesh=mesh)
        state = retrieval_state(dcfg, spec["weights"], mesh)
        metrics = retrieval_train_step(
            state, _torch(next(iter(dloader))), lr=LR, clip_gradient=1.0,
            source=FeatureSource.of(dloader), **loss_kw(dcfg))
        out["draws"] = _snapshot(state, metrics)
    if "mlp" in runs:
        out["mlp"] = mlp_step(mesh, spec["mlp_weights"])
    if "masks" in runs:
        out["masks"] = step_mask(spec, mesh)
    return out


def mlp_global_batch() -> Dict[str, np.ndarray]:
    """The first global batch of 64 of the MLP example's loader."""
    images, labels = make_synthetic_mnist(num_train=64, num_val=8)[0]
    return next(iter(MLPMNISTDataLoader(images, labels, 64, shuffle=True,
                                        seed=0)))


def mlp_step(mesh, weights: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """One step of the MLP example from `weights` (hidden width 16) on the
    rank's rows of the first global batch of 64 (the trainer's
    `train_step` body)."""
    images, labels = make_synthetic_mnist(num_train=64, num_val=8)[0]
    loader = MLPMNISTDataLoader(images, labels, 64, shuffle=True, seed=0,
                                mesh=mesh)
    model = MLPModel(hidden_dim=16)
    model.load_state_dict(weights)
    adam = optim.Adam(dict(model.named_parameters()), 0.9, 0.999, 1e-8, 0.0)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(loader)).items()}
    loss = mlp_train_step(model, adam, batch, LR, mesh)
    return {"loss": float(loss),
            "params": _np(dict(model.named_parameters()))}


def caption_runs(spec: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One step of MART on the rank's rows (dim 1) of the stacked batch,
    for each config of `spec["caption"]` (name -> config dict)."""
    out: Dict[str, Any] = {}
    inputs = spec["caption_inputs"]
    local = inputs["input_ids"].shape[1] // mesh.world
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:, rows]))
             for k, v in inputs.items()}
    for name, cfg_dict in spec["caption"].items():
        cfg = MartConfig(copy.deepcopy(cfg_dict))
        model = create_mart_model(cfg, spec["vocab"], CPU)
        load_mart_checkpoint(model, {"model": copy.deepcopy(
            spec["caption_weights"])})
        state = init_caption_train_state(model, cfg, 0, mesh)
        metrics = caption_train_step(state, batch, LR)
        out[name] = {"metrics": _np(metrics),
                     "params": _np(dict(model.named_parameters())),
                     "ema": _np(state.ema.shadow)}
    return out


def run(rank: int, world: int, init_file: str, spec_file: str,
        out_dir: str) -> None:
    """Rank `rank` of `world`: joins the group, runs the spec's runs and
    saves them to out_dir/rank<rank>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = pmesh.get_mesh({"data": world}, "cpu")
        spec = torch.load(spec_file, weights_only=False)
        out: Dict[str, Any] = {"rank": mesh.rank, "world": mesh.world}
        if spec.get("retrieval"):
            out.update(retrieval_runs(spec, mesh))
        if spec.get("caption"):
            out["caption"] = caption_runs(spec, mesh)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def cli_rank(rank: int, world: int, ports, argvs, out_dir: str,
             cli: str = "train_retrieval",
             keys=("path_base", "state", "step_losses", "rank",
                   "world")) -> None:
    """Rank `rank` of `world` as torchrun starts it (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): the port's `cli`.main once per
    argv, each on its own port; saves the results' `keys` to
    out_dir/cli<rank>.pt."""
    import importlib
    import os
    main = importlib.import_module(f"coot_videotext_tpu_torch.{cli}").main
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost")
    results = []
    for port, argv in zip(ports, argvs):
        os.environ["MASTER_PORT"] = str(port)
        result = main(argv)[0]
        assert not dist.is_initialized()  # the CLI ended its group
        results.append({k: result[k] for k in keys if k in result})
    torch.save(results, Path(out_dir) / f"cli{rank}.pt")
