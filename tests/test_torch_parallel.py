"""
Data parallelism in the port (coot_videotext_tpu_torch/parallel/mesh.py and
the steps, loaders and trainers that take a mesh) against the JAX package
on its `data` mesh axis, on the CPU. The DP cases of tests/test_parallel.py
mirrored: W rank processes (torch.multiprocessing, gloo, a file to meet)
run the port's steps on their rows of a global batch
(tests/torch_parallel_worker.py); JAX runs the same global batch at
get_mesh({"data": W}) on bridged weights. Tiny shapes of tests/helpers.py
(64-d video, 48-d text, batch 8, float32, dropout 0); RAdam falls back to
SGD on its first step, so one step's update is lr x gradient.

- retrieval train steps against JAX's meshed step: index batches from the
  store at W = 2, id batches (device sampling, parts packed) at W = 2 and
  4, the ragged last batch at W = 4 (two ranks hold padded rows only), a
  group of K = 2 at W = 4 against two of JAX's steps: loss parts 1e-5
  relative, RAdam's first moment (the gradient x 0.44) 1e-4 of JAX's
  largest, the updates within 1% of lr, every rank's parameters equal;
- the same step with the frame jitter and the cycle consistency
  subsampling on, at W = 2 against one process (the draws are the global
  batch's);
- the eval step at W = 2 against JAX's (the parts, the gathered
  embeddings, equal ranks);
- a MART step at W = 2 against JAX's meshed caption step, the EMA equal
  on both ranks; with label smoothing 0 (a mean over the global batch's
  tokens) against JAX's meshed step and one process;
- W = 1 in a process group bit-equal to no process group;
- the MLP example's step at W = 2 against JAX's trainer step on its
  `data` mesh and against one process;
- rank-folded dropout seeds: the first dropout mask of a train step at
  dropout 0.01 differs between the ranks, and rank 0's is one process's
  on the same rows;
- in the test's own process: the loaders' rank rows (every layout, the
  ragged tail, the caption loader's global S) put together give one
  process's batch; the refusals of get_mesh and batch_rows.
"""

from __future__ import annotations

import copy
import multiprocessing
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders as j_loaders)
from coot_videotext_tpu.examples import mlp_mnist as jmlp
from coot_videotext_tpu.parallel.mesh import batch_sharding
from coot_videotext_tpu.parallel.mesh import get_mesh as j_get_mesh
from coot_videotext_tpu.parallel.mesh import replicated_sharding
from coot_videotext_tpu.tasks.caption.config import MartConfig as JMartCfg
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate_mart)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JCapState, make_caption_train_step,
    stacked_batch_sharding)
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.tasks.retrieval.steps import (
    TrainState as JTrainState, make_retrieval_eval_step,
    make_retrieval_train_step)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu_torch.data.caption_dataset import (
    create_mart_datasets_and_loaders)
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_caption_dataset, generate_retrieval_dataset)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_train_step, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.retrieval import eval as tret
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    retrieval_train_step)
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mart_params_to_state_dict, jax_mlp_params_to_state_dict,
    jax_params_to_state_dict, load_mart_checkpoint)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file
from tests import torch_parallel_worker as worker
from tests.helpers import caption_config_dict, retrieval_config_dict
from tests.test_torch_caption_model import _inputs
from tests.test_torch_train import _flat_torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
LR = worker.LR
VOCAB = 50
NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0,
              "memory_dropout_prob": 0.0, "num_hidden_layers": 1}
MLP_HIDDEN = 16
CAPTION_KEYS = ("input_ids", "video_feature", "input_mask",
                "token_type_ids", "input_labels")
# the runs of each world size (W = 1 with a process group)
RUNS = {1: ("ids", "group"),
        2: ("indices", "ids", "eval", "masks", "draws", "mlp"),
        4: ("ids", "ragged", "group")}


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def _cfg_dict(root_overrides, *, jitter: bool = False) -> dict:
    cfg = retrieval_config_dict(root_overrides, batch_size=8)
    for split in ("dataset_train", "dataset_val"):
        cfg[split]["shuffle"] = split == "dataset_train"
        if not jitter:  # every video and clip fits its slots
            cfg[split]["max_frames"] = 1000
    if not jitter:  # JAX's draws are another stream than the port's
        cfg["train"]["loss_cycle_cons"] = 0.0
    cfg["train"]["steps_per_dispatch"] = 1
    cfg["optimizer"]["radam_degentosgd"] = True
    return cfg


def _spawn(world: int, spec: dict, tmp) -> list:
    """Rank processes of `world` running `spec`; their saved results."""
    spec_file = tmp / f"spec{world}.pt"
    torch.save(spec, spec_file)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(
        r, world, str(tmp / f"init{world}"), str(spec_file), str(tmp)))
        for r in range(world)]
    return procs


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every rank process of W = 1, 2 and 4 run at once, and what they
    saved, with the bridged weights and the inputs they ran on."""
    root = tmp_path_factory.mktemp("dp_data")
    overrides = generate_retrieval_dataset(
        root, num_videos=12, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0)
    cfg_dict = _cfg_dict(overrides)
    jcfg = JRetrievalConfig(copy.deepcopy(cfg_dict))
    jmgr = JModelManager(jcfg)
    params = jmgr.init_params(0)
    weights = {net: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
               for net, sd in jax_params_to_state_dict(
                   jax.tree_util.tree_map(np.asarray, params)).items()}
    ccfg = caption_config_dict(NO_DROPOUT, batch_size=4)
    jmart = jcreate_mart(JMartCfg(copy.deepcopy(ccfg)), VOCAB,
                         verbose=False)
    cinputs = _inputs(MartConfig(copy.deepcopy(ccfg)))
    cparams = jmart.init({"params": jax.random.PRNGKey(1)}, *cinputs,
                         deterministic=True)["params"]
    cweights = {k: torch.from_numpy(np.array(v)) for k, v in
                jax_mart_params_to_state_dict(
                    jax.device_get(cparams)).items()}
    ce_cfg = dict(ccfg, label_smoothing=0.0)
    mlp_params = jmlp.MLPModel(hidden_dim=MLP_HIDDEN).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 28 * 28)))["params"]
    common = {"root": str(root), "cfg": cfg_dict, "weights": weights,
              "mlp_weights": {
                  k: torch.from_numpy(np.array(v)) for k, v in
                  jax_mlp_params_to_state_dict(mlp_params).items()},
              "draws_cfg": _cfg_dict(overrides, jitter=True),
              "vocab": VOCAB, "caption_weights": cweights,
              "caption_inputs": dict(zip(CAPTION_KEYS, cinputs))}
    out = tmp_path_factory.mktemp("dp_out")
    procs = {}
    for world, runs in RUNS.items():
        spec = dict(common, retrieval=runs)
        if world == 2:
            spec["caption"] = {"smoothing": ccfg, "mean": ce_cfg}
        (out / str(world)).mkdir()
        procs[world] = _spawn(world, spec, out / str(world))
    every = sum(procs.values(), [])
    for p in every:
        p.start()
    for p in every:
        p.join(timeout=600)
    for p in every:
        if p.is_alive():  # hung: end it before failing
            p.kill()
            p.join()
    assert [p.exitcode for p in every] == [0] * len(every)
    results = {w: [torch.load(out / str(w) / f"rank{r}.pt",
                              weights_only=False) for r in range(w)]
               for w in RUNS}
    return {"root": root, "cfg": cfg_dict, "jcfg": jcfg, "jmgr": jmgr,
            "params": params, "weights": weights, "results": results,
            "common": common, "jmart": jmart, "cparams": cparams,
            "ccfg": ccfg, "ce_cfg": ce_cfg, "mlp_params": mlp_params}


# ---------------- JAX's meshed steps ----------------

_JAX_STEPS: dict = {}


def _jax_step(dp, world: int, batch: dict, *, ids: bool, state=None):
    """JAX's meshed step (compiled once a world and layout) on `batch`
    from `state` (default: the bridged weights): (state, metrics)."""
    key = (world, ids, id(dp))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _make_jax_step(dp, world, ids=ids)
    step, args, state0, mesh = _JAX_STEPS[key]
    b = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
         for k, v in batch.items()}
    return step(state0 if state is None else state, b, jnp.float32(LR),
                jax.random.PRNGKey(0), *args)


def _make_jax_step(dp, world: int, *, ids: bool):
    jcfg, jmgr = dp["jcfg"], dp["jmgr"]
    _, _, jloader, _ = j_loaders(jcfg, dp["root"], seed=0, fixed_shapes=ids,
                                 device_preload=True)
    store, meta = jloader.device_store, jloader.device_meta
    w = jcfg.train.contrastive_loss_config
    jopt = joptim.make_optimizer(jcfg.optimizer)
    mesh = j_get_mesh({"data": world})
    kw = dict(loss_weights=w.as_dict(), margin=w.margin,
              loss_cycle_cons=jcfg.train.loss_cycle_cons, clip_gradient=1.0,
              mesh=mesh, use_store=True)
    args = [store.vid_store, store.text_store]
    if ids:
        kw["device_sampling"] = {"shapes": meta.shapes,
                                 "max_frames": meta.max_frames}
        args.append(meta.tables)
    step = make_retrieval_train_step(jmgr.model_train, jopt, **kw)
    params = dp["params"]
    state = jax.device_put(JTrainState(params, jopt.init(params),
                                       jnp.int32(0)),
                           replicated_sharding(mesh))
    return step, args, state, mesh


def _jax_index_batch(dp) -> dict:
    _, _, jloader, _ = j_loaders(dp["jcfg"], dp["root"], seed=0,
                                 fixed_shapes=False, device_preload=True)
    batch = next(iter(jloader))
    return batch, {k: v for k, v in batch.items()
                   if isinstance(v, np.ndarray)}


def _check_ranks_equal(ranks, run: str) -> None:
    """Every rank's parameters after the run are rank 0's, bit for bit."""
    for other in ranks[1:]:
        for name, value in ranks[0][run]["params"].items():
            assert np.array_equal(value, other[run]["params"][name]), \
                (run, name)


def _check_against_jax(ours: dict, jstate, jmetrics, run: str) -> None:
    """Loss parts 1e-5 relative; the first moment (0.44 x the gradient)
    1e-4 of JAX's largest; the update within 1% of lr."""
    for name, ref in jmetrics.items():
        ref = np.asarray(ref).reshape(-1)
        got = np.asarray(ours["metrics"][name]).reshape(-1)
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-5 or abs(a - b) <= 1e-7, (run, name)
    mu = _flat_torch(jax.tree_util.tree_map(np.asarray, jstate.opt_state.mu))
    scale = max(1.0, max(np.abs(v).max() for v in mu.values()))
    for name, value in ours["mu"].items():
        assert np.abs(value - mu[name]).max() <= 1e-4 * scale, (run, name)
    params = _flat_torch(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, value in ours["params"].items():
        assert np.abs(value - params[name]).max() <= 0.01 * LR, (run, name)


def test_index_batch_step_at_w2_matches_jax(dp):
    """The store with host-sampled index batches: each rank collates its
    rows of the global batch at the global batch's dims."""
    ranks = dp["results"][2]
    jbatch, arrays = _jax_index_batch(dp)
    assert ranks[0]["indices"]["keys"] + ranks[1]["indices"]["keys"] == \
        list(jbatch["key"])
    jstate, jm = _jax_step(dp, 2, arrays, ids=False)
    for rank in ranks:
        _check_against_jax(rank["indices"], jstate, jm, "indices")
    _check_ranks_equal(ranks, "indices")


@pytest.mark.parametrize("world", [2, 4])
def test_id_batch_step_matches_jax(dp, world):
    """Device sampling with packed parts (the budget of a rank's rows)."""
    ranks = dp["results"][world]
    dp_idx = np.concatenate([r["ids"]["dp_idx"] for r in ranks])
    assert ranks[0]["pack_clips"] is not None
    jstate, jm = _jax_step(dp, world, {
        "dp_idx": dp_idx.astype(np.int32),
        "batch_valid": np.ones(8, bool)}, ids=True)
    for rank in ranks:
        _check_against_jax(rank["ids"], jstate, jm, "ids")
    _check_ranks_equal(ranks, "ids")


def test_ragged_last_batch_at_w4_matches_jax(dp):
    """12 videos in batches of 8: the last global batch holds 4, so ranks
    2 and 3 hold padded rows only; JAX pads the global batch at its end."""
    ranks = dp["results"][4]
    valid = np.concatenate([r["ragged"]["batch_valid"] for r in ranks])
    assert valid.tolist() == [True] * 4 + [False] * 4
    _, _, jloader, _ = j_loaders(dp["jcfg"], dp["root"], seed=0,
                                 fixed_shapes=True, device_preload=True)
    last = list(jloader)[-1]
    jstate, jm = _jax_step(dp, 4, {"dp_idx": last["dp_idx"],
                                   "batch_valid": last["batch_valid"]},
                           ids=True)
    for rank in ranks:
        _check_against_jax(rank["ragged"], jstate, jm, "ragged")
    _check_ranks_equal(ranks, "ragged")


def test_group_of_two_at_w4_matches_jax(dp):
    """A group of K = 2 at W = 4 against JAX's meshed step run twice (no
    random draw reaches either, so JAX's scan of the two gives the same;
    tests/test_torch_group.py holds the group against the scan)."""
    ranks = dp["results"][4]
    _, _, jloader, _ = j_loaders(dp["jcfg"], dp["root"], seed=0,
                                 fixed_shapes=True, device_preload=True)
    jstate, metrics = None, []
    for b in list(jloader)[:2]:
        jstate, m = _jax_step(dp, 4, {"dp_idx": b["dp_idx"],
                                      "batch_valid": b["batch_valid"]},
                              ids=True, state=jstate)
        metrics.append(m)
    jm = {k: np.stack([np.asarray(m[k]) for m in metrics])
          for k in metrics[0]}
    for rank in ranks:
        _check_against_jax(rank["group"], jstate, jm, "group")
    _check_ranks_equal(ranks, "group")


def _one_process(dp, cfg_dict, run: str) -> dict:
    """`run` of the worker in this process, without a process group."""
    spec = dict(dp["common"], cfg=cfg_dict, retrieval=(run,))
    return worker.retrieval_runs(spec, pmesh.single())[run]


def test_world_one_group_is_bit_equal_to_no_group(dp):
    """A process group of one rank changes nothing: the id step and the
    group, bit for bit."""
    (rank,) = dp["results"][1]
    assert rank["world"] == 1
    for run in RUNS[1]:
        alone = _one_process(dp, dp["cfg"], run)
        for part in ("metrics", "params", "mu"):
            for name, value in alone[part].items():
                assert np.array_equal(value, rank[run][part][name]), \
                    (run, part, name)


def test_draws_are_the_global_batch_s(dp):
    """Frame jitter and cycle-consistency subsampling on: W = 2 against
    one process on the same global batch (1e-5 relative, the gradient
    1e-4 of its largest)."""
    cfg = RetrievalConfig(copy.deepcopy(dp["common"]["draws_cfg"]))
    assert cfg.train.loss_cycle_cons > 0
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, dp["root"], seed=0, fixed_shapes=True, device_preload=True)
    state = worker.retrieval_state(cfg, dp["weights"], None)
    batch = next(iter(loader))
    metrics = retrieval_train_step(
        state, worker._torch(batch), lr=LR, clip_gradient=1.0,
        source=worker.FeatureSource.of(loader), **worker.loss_kw(cfg))
    assert worker.FeatureSource.of(loader).meta.max_frames == 16
    for rank in dp["results"][2]:
        got = rank["draws"]
        for name, value in metrics.items():
            assert _rel(got["metrics"][name], value) <= 1e-5, name
        mu = state.optimizer.mu
        scale = max(1.0, max(float(v.abs().max()) for v in mu.values()))
        for name, value in mu.items():
            assert np.abs(got["mu"][name] - value.numpy()).max() <= \
                1e-4 * scale, name


def test_eval_step_at_w2_matches_jax(dp):
    """JAX's test_eval_step_dp8_matches_single_device at W = 2: loss parts,
    the gathered embeddings and the ranks computed from them."""
    ranks = dp["results"][2]
    jcfg, jmgr = dp["jcfg"], dp["jmgr"]
    _, _, _, jval = j_loaders(jcfg, dp["root"], seed=0, fixed_shapes=True,
                              device_preload=True)
    meta = jval.device_meta
    w = jcfg.train.contrastive_loss_config
    mesh = j_get_mesh({"data": 2})
    step = make_retrieval_eval_step(
        jmgr.model_train, loss_weights=w.as_dict(), margin=w.margin,
        loss_cycle_cons=0.0, use_store=True, mesh=mesh,
        device_sampling={"shapes": meta.shapes,
                         "max_frames": meta.max_frames})
    jb = next(iter(jval))
    batch = {k: jax.device_put(jnp.asarray(jb[k]), batch_sharding(mesh))
             for k in ("dp_idx", "batch_valid")}
    jembs, jparts = jax.device_get(step(
        jax.device_put(dp["params"], replicated_sharding(mesh)), batch,
        jax.random.PRNGKey(7), jval.device_store.vid_store,
        jval.device_store.text_store, meta.tables))
    for rank in ranks:
        got = rank["eval"]
        for name in jparts:
            assert _rel(got["parts"][name], jparts[name]) <= 1e-5, name
        for name, value in got["embs"].items():
            np.testing.assert_allclose(value, jembs[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert np.array_equal(ranks[0]["eval"]["embs"]["vid_emb"],
                          ranks[1]["eval"]["embs"]["vid_emb"])
    results = []
    for embs in (ranks[0]["eval"]["embs"], jembs):
        results.append(tret.compute_retrieval(
            {k: np.asarray(embs[k]) for k in ("vid_emb", "par_emb")},
            "vid_emb", "par_emb", CPU, print_fn=lambda *_: None)[:3])
    assert results[0] == results[1]


def _jax_caption_step(dp, cfg_dict: dict):
    """JAX's meshed MART step at W = 2 from the bridged weights on the
    global stacked batch: (metrics, params, EMA) as state dicts."""
    jmart = jcreate_mart(JMartCfg(copy.deepcopy(cfg_dict)), VOCAB,
                         verbose=False)
    jopt = joptim.make_bertadam(eps=1e-6)
    mesh = j_get_mesh({"data": 2})
    step = make_caption_train_step(jmart, jopt, ema_decay=0.9999,
                                   clip_gradient=1.0, mesh=mesh)
    params = dp["cparams"]
    jstate = jax.device_put(JCapState(params, jopt.init(params),
                                      joptim.ema_init(params), jnp.int32(0)),
                            replicated_sharding(mesh))
    batch = {k: jax.device_put(jnp.asarray(v), stacked_batch_sharding(mesh))
             for k, v in dp["common"]["caption_inputs"].items()}
    jstate, jm = step(jstate, batch, jnp.float32(LR), jax.random.PRNGKey(1))
    return (jm, jax_mart_params_to_state_dict(jax.device_get(jstate.params)),
            jax_mart_params_to_state_dict(jax.device_get(jstate.ema.shadow)))


def _check_caption_against_jax(dp, run: str, cfg_dict: dict) -> None:
    """Each rank's `run` against JAX's meshed step: loss, grad_norm and
    n_correct 1e-5 relative, n_word equal, the updates and the EMA within
    1% of lr, the EMA equal on both ranks."""
    ranks = dp["results"][2]
    jm, jparams, jema = _jax_caption_step(dp, cfg_dict)
    before = dp["common"]["caption_weights"]
    for rank in ranks:
        got = rank["caption"][run]
        for name in ("loss", "grad_norm", "n_correct"):
            assert _rel(got["metrics"][name], jm[name]) <= 1e-5, name
        assert float(got["metrics"]["n_word"]) == float(jm["n_word"]) > 0
        for name, value in got["params"].items():
            ours = value - before[name].numpy()
            ref = jparams[name] - before[name].numpy()
            assert np.abs(ours - ref).max() <= 0.01 * LR, name
        for name, value in got["ema"].items():
            assert np.abs(value - jema[name]).max() <= 0.01 * LR, name
    for name, value in ranks[0]["caption"][run]["ema"].items():
        assert np.array_equal(value, ranks[1]["caption"][run]["ema"][name])


def test_caption_step_at_w2_matches_jax(dp):
    """JAX's test_caption_step_mesh_matches_unmeshed at W = 2 (N = 4
    videos, 2 a rank), label smoothing on (a sum over tokens)."""
    _check_caption_against_jax(dp, "smoothing", dp["ccfg"])


def test_caption_mean_cross_entropy_at_w2_matches_jax(dp):
    """label_smoothing 0: each sentence step's loss is a mean over the
    valid tokens of the global batch; W = 2 against JAX's meshed step."""
    _check_caption_against_jax(dp, "mean", dp["ce_cfg"])


def test_caption_mean_cross_entropy_at_w2_is_the_global_mean(dp):
    """label_smoothing 0 takes the mean over the valid tokens of the
    global batch: W = 2 against one process (loss and grad_norm 1e-5
    relative, parameters 1e-6 of lr)."""
    cfg = MartConfig(copy.deepcopy(dp["ce_cfg"]))
    model = create_mart_model(cfg, VOCAB, CPU)
    load_mart_checkpoint(model, {"model": copy.deepcopy(
        dp["common"]["caption_weights"])})
    state = init_caption_train_state(model, cfg, 0)
    batch = {k: torch.from_numpy(v) for k, v in
             dp["common"]["caption_inputs"].items()}
    metrics = caption_train_step(state, batch, LR)
    for rank in dp["results"][2]:
        got = rank["caption"]["mean"]
        for name in ("loss", "grad_norm"):
            assert _rel(got["metrics"][name], metrics[name]) <= 1e-5, name
        for name, p in model.named_parameters():
            assert np.abs(got["params"][name] - p.detach().numpy()).max() \
                <= 1e-6 * LR + 1e-7, name


def test_mlp_step_at_w2_matches_jax(dp, tmp_path):
    """JAX's MLP trainer step (examples/mlp_mnist.py, jitted with the
    batch over `data`) on a mesh of 2 from the same weights and global
    batch: the loss 1e-5 relative, every parameter within 1e-5, the ranks
    equal."""
    config = load_yaml_config_file("config/mlp/default/mnist.yaml")
    config.update(mlp_hidden_dim=MLP_HIDDEN, mesh_shape={"data": 2})
    cfg = jmlp.MLPMNISTExperimentConfig(config)
    trainer = jmlp.MLPMNISTTrainer(cfg, jmlp.MLPModelManager(cfg), "default",
                                   "mnist", "dp", 1, log_dir=str(tmp_path))
    try:
        params = dp["mlp_params"]
        batch = jax.device_put(worker.mlp_global_batch(),
                               trainer._data_sharding)
        new_params, _, loss = trainer._train_step(
            params, trainer.optimizer.init(params), batch, jnp.float32(LR))
    finally:
        trainer.close()
    ref = jax_mlp_params_to_state_dict(jax.device_get(new_params))
    ranks = [r["mlp"] for r in dp["results"][2]]
    for got in ranks:
        assert _rel(got["loss"], loss) <= 1e-5
        for name, value in ref.items():
            np.testing.assert_allclose(got["params"][name], value, atol=1e-5,
                                       rtol=0, err_msg=name)
    for name, value in ranks[0]["params"].items():
        assert np.array_equal(value, ranks[1]["params"][name])


def test_mlp_step_at_w2_is_one_process_s(dp):
    """The MLP example's step on each rank's rows equals one process's
    step on the global batch (weighted mean over the global batch)."""
    got = [r["mlp"] for r in dp["results"][2]]
    ref = worker.mlp_step(None, dp["common"]["mlp_weights"])
    assert _rel(got[0]["loss"], ref["loss"]) <= 1e-5
    for name, value in ref["params"].items():
        np.testing.assert_allclose(got[0]["params"][name], value, rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert np.array_equal(got[0]["params"][name],
                              got[1]["params"][name])


def test_rank_folded_dropout_masks_differ(dp):
    """The first dropout mask of a train step at dropout 0.01 (a forward
    hook on the model's Dropout modules): the two ranks' masks of their 4
    rows differ, and rank 0's is one process's on the same rows of the
    global batch."""
    masks = [r["masks"] for r in dp["results"][2]]
    alone = worker.step_mask(dp["common"], pmesh.single())
    assert alone.shape[0] == 8 and masks[0].shape == masks[1].shape
    assert masks[0].shape[0] == 4 and alone[:4].any()
    assert np.array_equal(masks[0], alone[:4])
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], alone[4:])


# ---------------- in this process ----------------

def test_get_mesh_refusals():
    """A mesh_shape that asks for more ranks than the group has (also
    --single_gpu's {data: 1} under more ranks), a `model` axis, an unknown
    axis, and a global batch that does not split."""
    assert pmesh.get_mesh(None, "cpu").world == 1
    assert pmesh.get_mesh({"data": 1}, "cpu").world == 1
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.get_mesh({"data": 2}, "cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        pmesh.get_mesh({"data": 1, "model": 2}, "cpu")
    with pytest.raises(ValueError, match="unknown axis"):
        pmesh.get_mesh({"data": 1, "pipe": 2}, "cpu")
    with pytest.raises(ValueError, match="--single_gpu"):
        pmesh._check_shape({"data": 1}, 2)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.batch_rows(pmesh.Mesh(0, 4, CPU), 6)
    assert pmesh.batch_rows(pmesh.Mesh(2, 4, CPU), 8) == slice(4, 6)
    with pytest.raises(ValueError, match="rank"):
        with philox.dropout_seeds(philox.seed_state(0), 1 << 12):
            pass


def _fake_mesh(rank: int, world: int) -> pmesh.Mesh:
    """A rank's place without a process group: what the loaders read."""
    return pmesh.Mesh(rank=rank, world=world, device=CPU)


@pytest.mark.parametrize("layout,fixed", [("dense", False), ("dense", True),
                                          ("indices", False),
                                          ("ids", True)])
def test_loader_rank_rows_make_one_process_s_batch(tmp_path, layout, fixed):
    """Each rank's rows of every global batch (the ragged tail too), put
    together in rank order, are one process's batch; per-batch bucketing
    takes the global batch's dims."""
    overrides = generate_retrieval_dataset(
        tmp_path, num_videos=12, num_val_videos=4, vid_feat_dim=16,
        text_feat_dim=8, mean_clips=3.0, max_clips=5, seed=2)
    cfg = RetrievalConfig(retrieval_config_dict(overrides, batch_size=8))
    kw = dict(seed=0, fixed_shapes=fixed,
              device_preload=layout in ("indices", "ids"))
    _, _, whole, _ = create_retrieval_datasets_and_loaders(cfg, tmp_path,
                                                           **kw)
    assert whole.layout == layout
    ranks = [create_retrieval_datasets_and_loaders(
        cfg, tmp_path, mesh=_fake_mesh(r, 4), **kw)[2] for r in range(4)]
    assert [ld.local_batch for ld in ranks] == [2] * 4
    for ld in [whole] + ranks:
        ld.set_epoch(1)
    for ref, *parts in zip(whole, *ranks):
        assert sum((p["key"] for p in parts), []) == ref["key"]
        for name, value in ref.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(
                    np.concatenate([p[name] for p in parts]), value,
                    err_msg=name)


def test_caption_loader_rank_rows(tmp_path):
    """The caption loader at W = 2: the ranks' rows along N, put together,
    are one process's stacked batch at the global S; a rank without a real
    row gets IGNORE-labelled dummy rows and no metas."""
    overrides = generate_caption_dataset(
        tmp_path, num_videos=6, num_val_videos=2, mean_sentences=2.0,
        max_sentences=3, seed=1)
    cfg = MartConfig(caption_config_dict({}, batch_size=4))
    args = (cfg, overrides["coot_feat_dir"], overrides["annotations_dir"])
    _, _, whole, _ = create_mart_datasets_and_loaders(*args, seed=0)
    ranks = [create_mart_datasets_and_loaders(
        *args, seed=0, mesh=_fake_mesh(r, 2))[2] for r in range(2)]
    seen = 0
    for ref, *parts in zip(whole, *ranks):
        stacked, sizes, metas = ref
        n_real = len(sizes)
        assert sum((p[1] for p in parts), []) == sizes
        assert sum((p[2] for p in parts), []) == metas
        for name in CAPTION_KEYS:
            got = np.concatenate([p[0][name] for p in parts], axis=1)
            if n_real <= 2 and name == "input_labels":
                assert (got[:, n_real:] == -1).all()
                got, want = got[:, :n_real], stacked[name][:, :n_real]
            else:
                want = stacked[name]
            np.testing.assert_array_equal(got, want, err_msg=name)
        seen += 1
    assert seen == 2  # 6 videos: a full batch and the ragged tail of 2


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
