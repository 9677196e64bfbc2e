"""
Tensor parallelism in the port (coot_videotext_tpu_torch/parallel/tp.py, the
`model` axis of parallel/mesh.py, and the layers, steps and trainers that
take it) against the JAX package's coot_videotext_tpu/parallel/tp.py, on
the CPU. The TP cases of tests/test_parallel.py mirrored: D x M rank
processes (torch.multiprocessing, gloo, a file to meet;
tests/torch_tp_worker.py) shard the model by the rules and run the port's
steps on their data rank's rows of a global batch; JAX runs the same
global batch at get_mesh({"data": D, "model": M}) (the first D x M of the
8 CPU devices) with `shard_state_for_tp` on bridged weights. Tiny shapes of
tests/helpers.py (hidden 32, 4 heads, float32, dropout 0). Tolerances are
tests/test_parallel.py's: loss 1e-4 relative, parameters rtol 1e-3 and atol
1e-4 (the caption EMA rtol 1e-3, atol 1e-5).

- the layout names the tensors that JAX `infer_param_shardings` shards,
  by JAX path and dim, on the tiny models and at the shipped widths
  (yc2_2d3d_coot: 26 kernels; yc2_2d3d_coot_vidclip_mart: 22);
- a retrieval step with clipping at {data: 2, model: 2} and {data: 1,
  model: 4} against JAX's TP step; at M = 4 the cross-attention has 2
  heads (heads % M != 0): its Linears gather the whole weights;
- the eval step under {data: 2, model: 2}: parts, embeddings, ranks;
- a MART step at {data: 2, model: 2}: loss, parameters and EMA; then
  greedy and beam decoding on the sharded model, token for token one
  process's;
- B1's column-parallel plain version (dout / M, dgain and dbias summed)
  against the whole one, in this process;
- the CLI under {data: 2, model: 2}: a checkpoint round trip (one epoch,
  then a fresh sharded resume) equal to the unbroken run, and a model
  file with the keys and shapes that one process writes;
- the TransformerXL, the untied and joint models and the MTransformer at
  {data: 1, model: 2}: replicated (nothing sharded), each rank's step
  against JAX's at that mesh and equal to one process's.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from coot_videotext_tpu.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders as j_loaders)
from coot_videotext_tpu.parallel.mesh import batch_sharding
from coot_videotext_tpu.parallel.mesh import get_mesh as j_get_mesh
from coot_videotext_tpu.parallel.mesh import replicated_sharding
from coot_videotext_tpu.parallel.tp import (
    infer_param_shardings as j_infer_shardings, shard_state_for_tp)
from coot_videotext_tpu.tasks.caption.config import MartConfig as JMartCfg
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate_mart)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JCapState, make_caption_train_step,
    single_batch_sharding, stacked_batch_sharding)
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.tasks.retrieval.steps import (
    TrainState as JTrainState, make_retrieval_eval_step,
    make_retrieval_train_step)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.ops.input_fc import fused_input_fc
from coot_videotext_tpu_torch.parallel.tp import (
    infer_param_shardings, jax_paths)
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    init_caption_train_state)
from coot_videotext_tpu_torch.tasks.retrieval import eval as tret
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mart_params_to_state_dict, jax_params_to_state_dict)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file
from tests import torch_parallel_worker as pworker
from tests import torch_tp_worker as worker
from tests.helpers import caption_config_dict
from tests.test_torch_caption_model import _inputs
from tests.test_torch_parallel import CAPTION_KEYS, NO_DROPOUT, _cfg_dict
from tests.test_torch_train import _flat_torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
LR = worker.LR
VOCAB = 50
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
EMA_TOL = dict(rtol=1e-3, atol=1e-5)
# the meshes of the spawned runs: (mesh_shape, retrieval config, caption)
MESHES = {"d2m2": ({"data": 2, "model": 2}, "base", True),
          "d1m4": ({"data": 1, "model": 4}, "two_heads", False)}


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def _two_head_context(cfg_dict: dict) -> dict:
    """`cfg_dict` with 2 cross-attention heads in the global nets: under
    a model axis of 4 they do not split (the width, 32, does)."""
    cfg_dict = copy.deepcopy(cfg_dict)
    for net in ("net_video_global", "net_text_global"):
        cfg_dict[net]["crossatn_config"]["num_heads"] = 2
    return cfg_dict


def _spawn(world: int, spec: dict, tmp: Path) -> list:
    spec_file = tmp / "spec.pt"
    torch.save(spec, spec_file)
    ctx = multiprocessing.get_context("spawn")
    return [ctx.Process(target=worker.run, args=(
        r, world, str(tmp / "init"), str(spec_file), str(tmp)))
        for r in range(world)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every rank process of the meshes of MESHES run at once, and what
    they saved, with the bridged weights and the inputs they ran on."""
    root = tmp_path_factory.mktemp("tp_data")
    overrides = generate_retrieval_dataset(
        root, num_videos=12, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0)
    cfgs = {"base": _cfg_dict(overrides)}
    cfgs["two_heads"] = _two_head_context(cfgs["base"])
    jmgrs = {k: JModelManager(JRetrievalConfig(copy.deepcopy(v)))
             for k, v in cfgs.items()}
    params = jmgrs["base"].init_params(0)
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
    out = tmp_path_factory.mktemp("tp_out")
    procs = {}
    for name, (shape, cfg_name, caption) in MESHES.items():
        spec = {"mesh_shape": shape, "root": str(root),
                "cfg": cfgs[cfg_name], "weights": weights}
        if caption:
            spec.update(caption_cfg=ccfg, vocab=VOCAB,
                        caption_weights=cweights,
                        caption_inputs=dict(zip(CAPTION_KEYS, cinputs)))
        (out / name).mkdir()
        procs[name] = _spawn(int(np.prod(list(shape.values()))), spec,
                             out / name)
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
    results = {name: [torch.load(out / name / f"rank{r}.pt",
                                 weights_only=False)
                      for r in range(len(procs[name]))] for name in MESHES}
    return {"root": root, "cfgs": cfgs, "jmgrs": jmgrs, "params": params,
            "results": results, "jmart": jmart, "cparams": cparams,
            "ccfg": ccfg, "cinputs": cinputs}


# ---------------- the rules ----------------

def _jax_sharded(params, model_world: int) -> dict:
    """{JAX path: the sharded dim of the torch weight} of what JAX
    `infer_param_shardings` shards at {data: 8 / M, model: M}."""
    mesh = j_get_mesh({"data": 8 // model_world, "model": model_world})
    shardings = j_infer_shardings(params, mesh)
    out = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        spec = tuple(sharding.spec)
        if any(ax is not None for ax in spec):
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            # a kernel (din, dout) is the torch weight (dout, din)
            out[name] = 1 - spec.index("model")
    return out


def _port_sharded(model, model_world: int) -> dict:
    paths = jax_paths(model)
    return {paths[n]: d for n, d in
            infer_param_shardings(model, model_world).items()
            if d is not None}


def _shipped_retrieval():
    path = ROOT / "config" / "retrieval" / "paper2020" / "yc2_2d3d_coot.yaml"
    config = load_yaml_config_file(path)
    jmgr = JModelManager(JRetrievalConfig(copy.deepcopy(config)))
    params = jax.eval_shape(lambda: jmgr.init_params(0))
    model = RetrievalModelManager(RetrievalConfig(config), CPU).model
    return params, model


def _shipped_mart():
    path = (ROOT / "config" / "caption" / "paper2020" /
            "yc2_2d3d_coot_vidclip_mart.yaml")
    config = load_yaml_config_file(path)
    vocab = 1000
    jmart = jcreate_mart(JMartCfg(copy.deepcopy(config)), vocab,
                         verbose=False)
    cfg = MartConfig(copy.deepcopy(config))
    inputs = [jnp.asarray(a[:, :2]) for a in _inputs(cfg)]
    params = jax.eval_shape(lambda: jmart.init(
        {"params": jax.random.PRNGKey(0)}, *inputs,
        deterministic=True)["params"])
    return params, create_mart_model(cfg, vocab, CPU)


@pytest.mark.parametrize("model_world", [2, 4])
@pytest.mark.parametrize("which,count", [("coot_tiny", 26),
                                         ("mart_tiny", 22),
                                         ("coot_yc2_2d3d", 26),
                                         ("mart_yc2_2d3d_vidclip", 22)])
def test_tp_sharding_rules(tp, which, count, model_world):
    """The port's layout shards the tensors that JAX's rules shard, by
    JAX path and dim: the 6 attention blocks' q, k, v (column) and final
    projections (row) and both input FCs of COOT; 11 kernels a layer of
    MART (q, k, v of the three attentions and hidden_intermediate column,
    attention/output row; output/dense replicated)."""
    if which == "coot_tiny":
        params = tp["params"]
        model = RetrievalModelManager(RetrievalConfig(copy.deepcopy(
            tp["cfgs"]["base"])), CPU).model
    elif which == "mart_tiny":  # two layers
        config = dict(tp["ccfg"], num_hidden_layers=2)
        model = create_mart_model(MartConfig(copy.deepcopy(config)), VOCAB,
                                  CPU)
        jmart = jcreate_mart(JMartCfg(copy.deepcopy(config)), VOCAB,
                             verbose=False)
        params = jmart.init({"params": jax.random.PRNGKey(1)},
                            *tp["cinputs"], deterministic=True)["params"]
    elif which == "coot_yc2_2d3d":
        params, model = _shipped_retrieval()
    else:
        params, model = _shipped_mart()
    ours = _port_sharded(model, model_world)
    ref = _jax_sharded(params, model_world)
    assert ours == ref
    assert len(ours) == count
    if which.startswith("mart"):
        assert not any(p.endswith("/output/dense/kernel")
                       and "attention" not in p for p in ours)
        assert sum("hidden_intermediate" in p for p in ours) == count // 11


# ---------------- the spawned steps against JAX ----------------

def _jax_tp_step(tp, mesh_shape: dict, cfg_name: str, dp_idx):
    """JAX's retrieval step under `mesh_shape` with shard_state_for_tp on
    the bridged weights, clipping 1.0: (state, metrics)."""
    jmgr = tp["jmgrs"][cfg_name]
    jcfg = jmgr.cfg
    _, _, jloader, _ = j_loaders(jcfg, tp["root"], seed=0, fixed_shapes=True,
                                 device_preload=True)
    store, meta = jloader.device_store, jloader.device_meta
    w = jcfg.train.contrastive_loss_config
    jopt = joptim.make_optimizer(jcfg.optimizer)
    mesh = j_get_mesh(mesh_shape)
    params = tp["params"]
    state, state_sh = shard_state_for_tp(
        JTrainState(params, jopt.init(params), jnp.int32(0)), mesh)
    step = make_retrieval_train_step(
        jmgr.model_train, jopt, loss_weights=w.as_dict(), margin=w.margin,
        loss_cycle_cons=jcfg.train.loss_cycle_cons, clip_gradient=1.0,
        mesh=mesh, use_store=True, state_shardings=state_sh,
        device_sampling={"shapes": meta.shapes,
                         "max_frames": meta.max_frames})
    batch = {"dp_idx": jax.device_put(jnp.asarray(dp_idx, jnp.int32),
                                      batch_sharding(mesh)),
             "batch_valid": jax.device_put(jnp.ones(len(dp_idx), bool),
                                           batch_sharding(mesh))}
    return step(state, batch, jnp.float32(LR), jax.random.PRNGKey(0),
                store.vid_store, store.text_store, meta.tables)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_retrieval_step_matches_jax(tp, mesh_name):
    """JAX's test_tp_train_step_matches_dp at the same mesh: every rank's
    loss parts and grad_norm (1e-4 relative) and its whole parameters
    (gathered over the model group) against JAX's TP step."""
    shape, cfg_name, _ = MESHES[mesh_name]
    ranks = tp["results"][mesh_name]
    dp_idx = ranks[0]["retrieval"]["step"]["dp_idx"]
    assert len(dp_idx) == 8
    jstate, jm = _jax_tp_step(tp, shape, cfg_name, dp_idx)
    jparams = _flat_torch(jax.tree_util.tree_map(np.asarray,
                                                 jstate.params))
    for rank in ranks:
        got = rank["retrieval"]["step"]
        assert np.array_equal(got["dp_idx"], dp_idx)
        for name, ref in jm.items():
            assert _rel(got["metrics"][name], ref) <= LOSS_RTOL \
                or abs(float(got["metrics"][name]) - float(ref)) <= 1e-7, \
                (mesh_name, name)
        assert set(got["params"]) == set(jparams)
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, jparams[name], **PARAM_TOL,
                                       err_msg=name)
        assert len(rank["retrieval"]["shards"]) == 26
    for other in ranks[1:]:
        for name, value in ranks[0]["retrieval"]["step"]["params"].items():
            assert np.array_equal(
                value, other["retrieval"]["step"]["params"][name]), name


def test_heads_that_do_not_split_gather_the_whole_weights(tp):
    """{data: 1, model: 4} with 2 cross-attention heads: JAX shards their
    q, k, v and final projections all the same (GSPMD ignores head
    boundaries); the port's cross-attentions gather the whole weights and
    run both heads with their whole biases (no partial gradient to sum),
    the other blocks run their rank's heads, and the step matched JAX's
    (test_tp_retrieval_step_matches_jax[d1m4])."""
    modes = tp["results"]["d1m4"][0]["retrieval"]["modes"]
    for name, mode in modes.items():
        assert mode == ("gathered" if ".tf_context." in name else "heads"), \
            name
    shards = tp["results"]["d1m4"][0]["retrieval"]["shards"]
    ctx = [n for n in shards if ".tf_context." in n]
    assert len(ctx) == 8 and all(
        shards[n] == (1 if "final_projection" in n else 0) for n in ctx)
    partial = tp["results"]["d1m4"][0]["retrieval"]["partial"]
    assert not any(n.replace(".weight", ".bias") in partial for n in ctx)
    assert any(".tf.encoder_layers." in n and n.endswith(
        "query_projection.bias") for n in partial)


def test_tp_eval_step_matches_jax(tp):
    """The eval step on the sharded model at {data: 2, model: 2} against
    JAX's eval step at {data: 2}: the loss parts, the gathered embeddings
    and the ranks computed from them."""
    ranks = tp["results"]["d2m2"]
    jmgr = tp["jmgrs"]["base"]
    jcfg = jmgr.cfg
    _, _, _, jval = j_loaders(jcfg, tp["root"], seed=0, fixed_shapes=True,
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
        jax.device_put(tp["params"], replicated_sharding(mesh)), batch,
        jax.random.PRNGKey(7), jval.device_store.vid_store,
        jval.device_store.text_store, meta.tables))
    for rank in ranks:
        got = rank["retrieval"]["eval"]
        for name in jparts:
            assert _rel(got["parts"][name], jparts[name]) <= LOSS_RTOL, name
        for name, value in got["embs"].items():
            np.testing.assert_allclose(value, jembs[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    results = []
    for embs in (ranks[0]["retrieval"]["eval"]["embs"], jembs):
        results.append(tret.compute_retrieval(
            {k: np.asarray(embs[k]) for k in ("vid_emb", "par_emb")},
            "vid_emb", "par_emb", CPU, print_fn=lambda *_: None)[:3])
    assert results[0] == results[1]


def test_tp_caption_step_matches_jax(tp):
    """JAX's test_caption_tp_step_matches_dp at {data: 2, model: 2} from
    the bridged weights: loss, grad_norm and n_correct 1e-4 relative,
    n_word equal, parameters and EMA as that test holds them, 11 sharded
    kernels a layer, every rank equal."""
    ranks = tp["results"]["d2m2"]
    jmart = tp["jmart"]
    jopt = joptim.make_bertadam(eps=1e-6)
    mesh = j_get_mesh({"data": 2, "model": 2})
    params = tp["cparams"]
    state, state_sh = shard_state_for_tp(
        JCapState(params, jopt.init(params), joptim.ema_init(params),
                  jnp.int32(0)), mesh)
    step = make_caption_train_step(jmart, jopt, ema_decay=0.9999,
                                   clip_gradient=1.0, mesh=mesh,
                                   state_shardings=state_sh)
    batch = {k: jax.device_put(jnp.asarray(v), stacked_batch_sharding(mesh))
             for k, v in zip(CAPTION_KEYS, tp["cinputs"])}
    state, jm = step(state, batch, jnp.float32(LR), jax.random.PRNGKey(1))
    jparams = jax_mart_params_to_state_dict(jax.device_get(state.params))
    jema = jax_mart_params_to_state_dict(jax.device_get(state.ema.shadow))
    for rank in ranks:
        got = rank["caption"]
        assert len(got["shards"]) == 11
        for name in ("loss", "grad_norm", "n_correct"):
            assert _rel(got["metrics"][name], jm[name]) <= LOSS_RTOL, name
        assert float(got["metrics"]["n_word"]) == float(jm["n_word"]) > 0
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, jparams[name], **EMA_TOL,
                                       err_msg=name)
        for name, value in got["ema"].items():
            np.testing.assert_allclose(value, jema[name], **EMA_TOL,
                                       err_msg=name)
    for other in ranks[1:]:
        for what in ("params", "ema"):
            for name, value in ranks[0]["caption"][what].items():
                assert np.array_equal(value, other["caption"][what][name])



def test_tp_caption_decodes_match_one_process(tp):
    """Greedy and beam decoding of the stacked batch on the sharded MART
    (after its step) at {data: 2, model: 2}: every rank's tokens equal one
    process's with the same (gathered) weights. The sharded model's greedy
    decode runs the full forward a token, one process's the key / value
    caches."""
    ranks = tp["results"]["d2m2"]
    cfg = MartConfig(copy.deepcopy(tp["ccfg"]))
    model = create_mart_model(cfg, VOCAB, CPU)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           ranks[0]["caption"]["params"].items()})
    ref = worker.decodes(model, cfg, dict(zip(CAPTION_KEYS, tp["cinputs"])))
    assert ref["cached_tokens"] == 3 * cfg.max_t_len
    for rank in ranks:
        got = rank["caption"]["decodes"]
        assert got["cached_tokens"] == 0
        for mode in ("greedy", "beam"):
            assert len(got[mode]) == len(ref[mode]) == 3
            for a, b in zip(got[mode], ref[mode]):
                assert np.array_equal(a, b), mode

# ---------------- B1 column-parallel, in this process ----------------

@pytest.mark.parametrize("model_world", [2, 4])
def test_input_fc_column_parallel_plain(model_world):
    """B1's plain version at dout / M on each rank's rows of the weight and
    slice of the bias: the columns put together are the whole output, the
    weight and bias gradients the whole ones' rows, and dgain and dbias
    summed over the ranks the whole ones (float32, 1e-5 of the largest)."""
    g = torch.Generator().manual_seed(0)
    s, din, dout = 37, 48, 32
    x = torch.randn(s, din, generator=g) * 2 + 0.5
    params = [1 + 0.1 * torch.randn(din, generator=g),
              0.1 * torch.randn(din, generator=g),
              torch.randn(dout, din, generator=g) / din ** 0.5,
              0.1 * torch.randn(dout, generator=g)]
    dy = torch.randn(s, dout, generator=g)

    def run(weight, bias, cols):
        leaves = [params[0].clone().requires_grad_(),
                  params[1].clone().requires_grad_(),
                  weight.clone().requires_grad_(),
                  bias.clone().requires_grad_()]
        y = fused_input_fc(x, *leaves, 1e-6, "gelu")
        y.backward(dy[:, cols])
        return y.detach(), [t.grad for t in leaves]

    whole, grads = run(params[2], params[3], slice(None))
    n = dout // model_world
    parts = [run(params[2][r * n:(r + 1) * n], params[3][r * n:(r + 1) * n],
                 slice(r * n, (r + 1) * n)) for r in range(model_world)]
    scale = float(whole.abs().max())
    assert float((torch.cat([p[0] for p in parts], 1) - whole).abs().max()) \
        <= 1e-5 * scale
    for i in (0, 1):  # dgain, dbias: partial sums over the rank's columns
        total = sum(p[1][i] for p in parts)
        assert float((total - grads[i]).abs().max()) <= \
            1e-5 * float(grads[i].abs().max())
    for i in (2, 3):  # dW, db: the rank's rows
        got = torch.cat([p[1][i] for p in parts], 0)
        assert float((got - grads[i]).abs().max()) <= \
            1e-5 * float(grads[i].abs().max())


# ---------------- the CLI: checkpoint round trip ----------------

def _cli_spawn(argvs, tmp: Path, world: int) -> list:
    ports = []
    for _ in argvs:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            ports.append(sock.getsockname()[1])
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=pworker.cli_rank, args=(
        r, world, ports, argvs, str(tmp), "train_retrieval",
        ("path_base", "state", "step_losses", "rank", "world")))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _cli_join(procs, tmp: Path) -> list:
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(tmp / f"cli{r}.pt", weights_only=False)
            for r in range(len(procs))]


def test_cli_checkpoint_round_trip_under_tp(tmp_path):
    """train_retrieval under {data: 2, model: 2} (4 gloo ranks, started as
    torchrun starts them) on the device store with device sampling: 2
    epochs unbroken, and 1 epoch then a resume (a fresh process group,
    the whole checkpoint loaded, then sharded) to 2. The resumed run's
    losses and its epoch-1 model file equal the unbroken run's bit for
    bit (the same sums in the same order); the TP model file has the keys
    and shapes of one process's, loads into one process, and the losses
    agree with one process's (1e-4 relative)."""
    root = tmp_path / "data"
    overrides = generate_retrieval_dataset(
        root, num_videos=16, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=1)
    cfg = _cfg_dict(overrides)
    cfg["train"]["num_epochs"] = 2
    for name, shape in (("tp", {"data": 2, "model": 2}),
                        ("one", {"data": 1})):
        (tmp_path / f"{name}.yaml").write_text(
            yaml.safe_dump(dict(cfg, mesh_shape=shape)), encoding="utf8")

    def argv(name, log_dir, epochs):
        return ["-c", str(tmp_path / f"{name}.yaml"), "--data_path",
                str(root), "--log_dir", str(tmp_path / log_dir), "--device",
                "cpu", "--preload_device", "--fixed_shapes", "-o",
                f"train.num_epochs={epochs}"]

    (tmp_path / "ranks").mkdir()
    procs = _cli_spawn([argv("tp", "unbroken", 2), argv("tp", "broken", 1),
                        argv("tp", "broken", 2)], tmp_path / "ranks", 4)
    alone = train_retrieval.main(argv("one", "one", 2))[0]
    ranks = _cli_join(procs, tmp_path / "ranks")
    unbroken, first, resumed = ranks[0]
    assert resumed["state"]["current_epoch"] == 2
    assert len(unbroken["step_losses"]) == 4
    assert resumed["step_losses"] == unbroken["step_losses"]
    assert first["step_losses"] == unbroken["step_losses"][:2]
    for rank in ranks[1:]:
        assert rank[2]["step_losses"] == resumed["step_losses"]
    np.testing.assert_allclose(unbroken["step_losses"],
                               alone["step_losses"], rtol=1e-4)
    files = {k: torch.load(v["path_base"] / "models" / "model_1.pth",
                           weights_only=True)
             for k, v in (("unbroken", unbroken), ("resumed", resumed),
                          ("one", alone))}
    for net, sd in files["one"].items():
        assert files["unbroken"][net].keys() == sd.keys()
        for key, value in sd.items():
            assert files["unbroken"][net][key].shape == value.shape, key
            assert torch.equal(files["resumed"][net][key],
                               files["unbroken"][net][key]), key
    mgr = RetrievalModelManager(RetrievalConfig(copy.deepcopy(cfg)), CPU)
    mgr.load_file(str(unbroken["path_base"] / "models" / "model_1.pth"))
    assert mgr.was_loaded



def test_caption_cli_trains_validates_and_resumes_under_tp(tmp_path):
    """train_caption (synthetic_smoke.yaml at dropout 0) under {data: 1,
    model: 2}: one epoch with its validation (the model group decodes
    together), then resumed to two, and one process run the same way (the
    warmup_linear schedule spans each run's num_epochs). Every epoch meter
    but the timings equals one process's within 1e-4 relative, and rank
    0's model, EMA and optimizer files hold whole tensors with one
    process's keys and shapes."""
    from coot_videotext_tpu_torch import train_caption
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_caption_dataset)
    info = generate_caption_dataset(tmp_path / "data", num_videos=16,
                                    num_val_videos=8, seed=1)
    smoke = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"
    config = load_yaml_config_file(smoke)
    for name, shape in (("tp", {"data": 1, "model": 2}),
                        ("one", {"data": 1})):
        (tmp_path / f"{name}.yaml").write_text(
            yaml.safe_dump(dict(config, mesh_shape=shape)), encoding="utf8")

    def argv(name, log_dir, epochs):
        return ["-c", str(tmp_path / f"{name}.yaml"), "--device", "cpu",
                "--log_dir", str(tmp_path / log_dir), "--annotations_dir",
                info["annotations_dir"], "--coot_feat_dir",
                info["coot_feat_dir"], "--cache_dir", str(tmp_path),
                "-o", f"train.num_epochs={epochs},hidden_dropout_prob=0,"
                "attention_probs_dropout_prob=0,memory_dropout_prob=0"]

    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            ports.append(sock.getsockname()[1])
    (tmp_path / "ranks").mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=pworker.cli_rank, args=(
        r, 2, ports, [argv("tp", "tp", 1), argv("tp", "tp", 2)],
        str(tmp_path / "ranks"), "train_caption",
        ("metrics_file", "total_step"))) for r in range(2)]
    for p in procs:
        p.start()
    train_caption.main(argv("one", "one", 1))
    one = train_caption.main(argv("one", "one", 2))[0]
    ranks = _cli_join(procs, tmp_path / "ranks")

    def meters(path):
        data = json.loads(Path(path).read_text())
        return {k: [v for _, v in vals] for k, vals in data.items()
                if "time" not in k and "profile" not in k}

    ref = meters(one["metrics_file"])
    assert "cap/b4" in ref
    for first, resumed in ranks:
        assert resumed["total_step"] == one["total_step"]
        got = meters(resumed["metrics_file"])
        assert got.keys() == ref.keys()
        for key, values in ref.items():
            np.testing.assert_allclose(got[key], values, rtol=1e-4,
                                       err_msg=key)
    models = {k: Path(v["metrics_file"]).parents[1] / "models"
              for k, v in (("tp", ranks[0][1]), ("one", one))}
    for name in ("model_1.pth", "modelema_1.pth", "optimizer_1.pth"):
        tp_file, one_file = (torch.load(models[k] / name, weights_only=True)
                             for k in ("tp", "one"))
        flat = {k: v for k, v in (tp_file.get("model") or
                                  tp_file["optimizer"]["mu"]).items()}
        ref_flat = (one_file.get("model") or one_file["optimizer"]["mu"])
        assert flat.keys() == ref_flat.keys()
        for key, value in ref_flat.items():
            assert flat[key].shape == value.shape, (name, key)


REPLICATED = {"xl": "TransformerXL", "untied": "NonRecurTransformerUntied",
              "joint": "NonRecurTransformer", "mtrans": "MTransformer"}
REPLICATED_SHAPE = {"data": 1, "model": 2}


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    """Two rank processes at {data: 1, model: 2} over gloo, each running
    one step of the four caption models of REPLICATED from the bridged
    weights (tests/test_torch_caption_graphs.py `caption_pair`), and the
    pairs."""
    from tests.test_torch_caption_graphs import (
        MODELS, NO_DROPOUT as NO_DROP, caption_pair, keys)
    pairs = {n: caption_pair(n) for n in REPLICATED}
    spec = {"mesh_shape": REPLICATED_SHAPE, "vocab": VOCAB, "replicated": {
        n: {"cfg": caption_config_dict({**NO_DROP, **MODELS[n][0]}),
            "weights": pair[2].state_dict(),
            "inputs": dict(zip(keys(n), pair[4]))}
        for n, pair in pairs.items()}}
    out = tmp_path_factory.mktemp("tp_replicated")
    procs = _spawn(2, spec, out)
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():  # hung: end it before failing
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    return pairs, [torch.load(out / f"rank{r}.pt", weights_only=False)
                   for r in range(2)]


@pytest.mark.parametrize("name", list(REPLICATED))
def test_other_caption_models_run_replicated_under_a_model_axis(replicated,
                                                                name):
    """The TransformerXL, the untied and joint models and the MTransformer
    under {data: 1, model: 2}: replicated, as JAX runs them (its caption
    steps take no state shardings; none of the XL's kernels matches a
    rule). Each rank's step against JAX's step under get_mesh({data: 1,
    model: 2}) (loss, grad_norm and n_correct 1e-4 relative, n_word equal,
    parameters and EMA as test_tp_caption_step_matches_jax holds them) and
    against one process bit for bit."""
    from tests.test_torch_caption_graphs import (
        MODELS, batch_of, by_name, copy_model, jax_step, keys, step_fn)
    pairs, ranks = replicated
    jmodel, params, model, cfg, inputs = pairs[name]
    mesh = j_get_mesh(REPLICATED_SHAPE)
    jopt, jstep = jax_step(name, jmodel, mesh=mesh)
    sharding = (stacked_batch_sharding(mesh) if MODELS[name][1] == "stacked"
                else single_batch_sharding(mesh))
    jbatch = {k: jax.device_put(jnp.asarray(v), sharding)
              for k, v in zip(keys(name), inputs)}
    state, jm = jstep(JCapState(params, jopt.init(params),
                                joptim.ema_init(params), jnp.int32(0)),
                      jbatch, jnp.float32(LR), jax.random.PRNGKey(1))
    jparams = by_name(name, state.params)
    jema = by_name(name, state.ema.shadow)
    one = init_caption_train_state(copy_model(name, model), cfg, 0)
    ref = {k: v.numpy() for k, v in
           step_fn(name)(one, batch_of(name, inputs), LR).items()}
    for rank in ranks:
        got = rank["replicated"][name]
        assert got["type"] == REPLICATED[name]
        assert got["shards"] == {}
        for key in ("loss", "grad_norm", "n_correct"):
            assert _rel(got["metrics"][key], jm[key]) <= LOSS_RTOL, key
        assert float(got["metrics"]["n_word"]) == float(jm["n_word"]) > 0
        for n, value in got["params"].items():
            np.testing.assert_allclose(value, jparams[n], **EMA_TOL,
                                       err_msg=n)
        for n, value in got["ema"].items():
            np.testing.assert_allclose(value, jema[n], **EMA_TOL,
                                       err_msg=n)
        for key, value in ref.items():
            assert np.array_equal(got["metrics"][key], value), key
        for n, p in one.model.named_parameters():
            assert np.array_equal(got["params"][n], p.detach().numpy()), n
        for n, v in one.ema.shadow.items():
            assert np.array_equal(got["ema"][n], v.numpy()), n


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
