"""
The PyTorch port's training slice held against the JAX package on the CPU.

- Philox dropout bits (ops/philox.py, the bits of csrc/philox.cuh): the
  Random123 known-answer vectors, the keep rate within 4 sigma, identical
  masks in the forward and the backward, and identity in eval mode or at
  rate 0 as the JAX module's Dropout.
- The whole 4-net loss and every parameter's gradient against
  jax.value_and_grad on the same weights (bridged with
  utils/param_bridge.py) and the same batch, f32, dropout rates 0 and the
  full-mean cycle consistency (rng=None / generator=None): tolerance
  1e-4 x max(1, max |g|) per tensor (the frameworks sum in different
  orders; observed errors are ~1e-6 relative).
- RAdam and Adam updates against make_radam / make_adam, the scheduler
  against the JAX scheduler, clipping against clip_by_global_norm.
- synthetic_smoke.yaml trains through the CLI on --device cpu: the loss is
  finite, a checkpoint is written, --validate --load_epoch reads it, and
  resuming continues the same run.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coot_videotext_tpu.config.base import SchedulerConfig as JSchedCfg
from coot_videotext_tpu.models.layers import Dropout as JDropout
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.train import losses as jlosses
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu.train import schedule as jschedule
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.config.base import SchedulerConfig
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.models.layers import Dropout
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_loss_and_grads, retrieval_train_step)
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.train.schedule import make_lr_scheduler
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_params_to_state_dict)
from tests.helpers import retrieval_config_dict
from tests.test_torch_model import _ragged_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "config" / "retrieval" / "default" / "synthetic_smoke.yaml"
GRAD_TOL = 1e-4
TOL = dict(atol=2e-5, rtol=2e-5)


def _close_grad(ours, ref, name=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(ref).max()), (name, err)


# ---------------- Philox dropout ----------------

@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
], ids=["zeros", "ones"])
def test_philox_known_answers(counter, key, expect):
    words = philox.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in words) == expect


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_dropout_keep_rate_within_4_sigma(rate):
    n = 1_000_003
    keep = philox.keep_factor((n,), seed=2 ** 40 + 17, site=3, rate=rate)
    dropped = float((keep == 0).sum())
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs(dropped - n * rate) <= 4 * sigma
    assert torch.all((keep == 0) | (keep == np.float32(1 / (1 - rate))))


def test_dropout_bits_depend_on_seed_site_and_element_only():
    a = philox.dropout_bits(99, 1, 1000)
    assert torch.equal(philox.dropout_bits(99, 1, 37), a[:37])
    assert not torch.equal(philox.dropout_bits(99, 2, 1000), a)
    assert not torch.equal(philox.dropout_bits(98, 1, 1000), a)


def test_dropout_module_masks_match_in_forward_and_backward():
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()
    drop = Dropout(0.25).train()
    with philox.dropout_seeds(torch.Generator().manual_seed(1)):
        y = drop(x)
    y.backward(torch.ones_like(y))
    assert torch.equal(y == 0, x.grad == 0)
    assert torch.allclose(y[y != 0], x[y != 0] / 0.75)
    with pytest.raises(RuntimeError, match="dropout_seeds"):
        drop(x)


@pytest.mark.parametrize("rate,train", [(0.0, True), (0.3, False)])
def test_dropout_rate0_or_eval_equals_jax(rate, train):
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    ref = JDropout(rate=rate).apply({}, jnp.asarray(x),
                                   deterministic=not train)
    drop = Dropout(rate).train(train)
    np.testing.assert_array_equal(drop(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref))


# ---------------- the whole slice against JAX ----------------

@pytest.fixture(scope="module")
def bridged():
    cfg_dict = retrieval_config_dict({"vid_feat_dim": 64,
                                      "text_feat_dim": 48})
    jcfg = JRetrievalConfig(copy.deepcopy(cfg_dict))
    jmgr = JModelManager(jcfg)
    batch = _ragged_batch(seed=3)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmgr.init_params(2, batch))
    tcfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    tmgr = RetrievalModelManager(tcfg, torch.device("cpu"), seed=1)
    tmgr.load_state({net: {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}
                     for net, sd in jax_params_to_state_dict(params).items()})
    return jcfg, jmgr, params, tcfg, tmgr, batch


def _flat_torch(tree):
    return {f"{net}.{k}": v for net, sd in
            jax_params_to_state_dict(tree).items() for k, v in sd.items()}


def _jax_loss_and_grads(jcfg, jmgr, params, batch):
    w = jcfg.train.contrastive_loss_config

    def loss_fn(p):
        out = jmgr.model_train.apply({"params": p}, batch,
                                     deterministic=True)
        visual = {k: out[k] for k in ("vid_emb", "clip_emb", "vid_context",
                                      "clip_valid", "clip_num")}
        text = {k: out[k] for k in ("par_emb", "sent_emb", "par_context",
                                    "sent_valid", "sent_num")}
        return jlosses.compute_total_retrieval_loss(
            visual, text, w.as_dict(), w.margin, jcfg.train.loss_cycle_cons,
            rng=None, batch_valid=batch["batch_valid"])

    (_, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return parts, grads


def _train_state(tcfg, tmgr):
    return TrainState(tmgr.model, optim.make_optimizer(
        tcfg.optimizer, dict(tmgr.model.named_parameters())), None, None)


def _loss_kw(cfg):
    w = cfg.train.contrastive_loss_config
    return dict(loss_weights=w.as_dict(), margin=w.margin,
                loss_cycle_cons=cfg.train.loss_cycle_cons)


def test_loss_and_every_gradient_match_jax(bridged):
    jcfg, jmgr, params, tcfg, tmgr, batch = bridged
    jparts, jgrads = _jax_loss_and_grads(jcfg, jmgr, params, batch)
    state = _train_state(tcfg, tmgr)
    parts, grads = retrieval_loss_and_grads(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        **_loss_kw(tcfg))
    for key in jparts:
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]),
                                   err_msg=key, **TOL)
    assert float(parts["loss_cc"]) != 0.0
    ref = _flat_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    nonzero = 0
    for name, g in grads.items():
        _close_grad(g.numpy(), ref[name], name)
        nonzero += bool(np.abs(ref[name]).max() > 0)
    assert nonzero > len(ref) // 2


def test_train_step_radam_update_matches_jax(bridged):
    """One train step from fresh state: the port's in-place RAdam update
    against make_radam(...).update on the JAX gradients."""
    jcfg, jmgr, params, tcfg, tmgr, batch = bridged
    _, jgrads = _jax_loss_and_grads(jcfg, jmgr, params, batch)
    jopt = joptim.make_optimizer(jcfg.optimizer)
    new_params, jstate = jopt.update(jgrads, jopt.init(params), params,
                                     jnp.float32(3e-3))
    model = copy.deepcopy(tmgr.model)
    state = TrainState(model, optim.make_optimizer(
        tcfg.optimizer, dict(model.named_parameters())), None, None)
    retrieval_train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, lr=3e-3,
        **_loss_kw(tcfg))
    assert state.step == 1 and state.optimizer.step_count == 1
    for tree, ours in ((new_params, dict(model.named_parameters())),
                       (jstate.mu, state.optimizer.mu),
                       (jstate.nu, state.optimizer.nu)):
        ref = _flat_torch(jax.tree_util.tree_map(np.asarray, tree))
        for name, value in ours.items():
            _close_grad(value.detach().numpy(), ref[name], name)


def _random_tree(seed):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(6, 4).astype(np.float32),
                      "bias": rng.randn(4).astype(np.float32)},
            "norm": {"gain": rng.randn(4).astype(np.float32)}}


@pytest.mark.parametrize("name", ["radam", "adam"])
def test_optimizer_update_matches_jax(name):
    """The 10th update (RAdam's rectified branch is live), weight decay on,
    bias exempt (weight_decay_for_bias)."""
    params, grads = _random_tree(0), _random_tree(1)
    mu, nu = _random_tree(2), jax.tree_util.tree_map(np.abs,
                                                     _random_tree(3))
    beta1, beta2, eps, wd, lr = 0.56, 0.98, 1.5e-9, 0.01, 3.6e-4
    if name == "radam":
        jopt = joptim.make_radam(beta1, beta2, eps, wd)
        topt = optim.RAdam
    else:
        jopt = joptim.make_adam(beta1, beta2, eps, wd)
        topt = optim.Adam
    jstate = joptim.AdamState(step=jnp.int32(9), mu=mu, nu=nu)
    new_params, _ = jopt.update(grads, jstate, params, jnp.float32(lr))

    def flat(tree):
        return {f"{a}.{b}": torch.from_numpy(v.copy())
                for a, sub in tree.items() for b, v in sub.items()}

    tparams = flat(params)
    opt = topt(tparams, beta1, beta2, eps, wd)
    opt.load_state_dict({"step": 9, "mu": flat(mu), "nu": flat(nu)})
    opt.step(flat(grads), lr)
    for key, value in flat(jax.tree_util.tree_map(np.asarray,
                                                  new_params)).items():
        np.testing.assert_allclose(tparams[key].numpy(), value.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
        moved = np.abs(tparams[key].numpy() - flat(params)[key].numpy())
        assert moved.max() > 0, key


def test_clip_by_global_norm_matches_jax():
    grads = _random_tree(4)
    ref, ref_norm = joptim.clip_by_global_norm(grads, 1.5)
    tg = {f"{a}.{b}": torch.from_numpy(v.copy())
          for a, sub in grads.items() for b, v in sub.items()}
    norm = optim.clip_by_global_norm(tg, 1.5)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    for a, sub in ref.items():
        for b, v in sub.items():
            np.testing.assert_allclose(tg[f"{a}.{b}"].numpy(),
                                       np.asarray(v), rtol=1e-6)


@pytest.mark.parametrize("warmup_type", ["none", "epoch", "step"])
def test_scheduler_matches_jax(warmup_type):
    """reduce_opw: the lr of every step over 12 epochs of 3 steps with a
    fixed improved/not-improved pattern."""
    cfg = {"name": "reduce_opw", "warmup_type": warmup_type,
           "warmup_epochs": 2, "rop_factor": 0.1, "rop_patience": 1,
           "rop_cooldown": 1, "rop_min_lr_factor": 0.001}
    ours = make_lr_scheduler(SchedulerConfig(dict(cfg)), 1e-3, 12, 3)
    ref = jschedule.make_lr_scheduler(JSchedCfg(dict(cfg)), 1e-3, 12, 3)
    pattern = [True, False, False, False, True, False, False, False, False,
               True, False, False]
    for improved in pattern:
        for _ in range(3):
            assert ours.current_lr == ref.current_lr
            ours.step()
            ref.step()
        ours.step_epoch(True, improved)
        ref.step_epoch(True, improved)
        assert ours.current_lr == ref.current_lr
    assert ours.state_dict() == ref.state_dict()


# ---------------- training through the CLI on the CPU ----------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """synthetic_smoke.yaml trained 2 epochs through the CLI."""
    root = tmp_path_factory.mktemp("torch_train")
    generate_retrieval_dataset(root / "data", num_videos=16,
                               num_val_videos=8, seed=0)
    argv = ["-c", str(SMOKE), "--data_path", str(root / "data"),
            "--log_dir", str(root / "exp"), "--device", "cpu"]
    result = train_retrieval.main(argv + ["-o", "train.num_epochs=2"])[0]
    return argv, result


def test_cli_trains_and_writes_the_experiment_tree(smoke):
    _, result = smoke
    losses = result["step_losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert result["state"]["current_epoch"] == 2
    assert result["state"]["infos_val_epochs"] == [0, 1]
    models = result["path_base"] / "models"
    for ep in (0, 1):
        for name in (f"model_{ep}.pth", f"optimizer_{ep}.pth",
                     f"trainerstate_{ep}.json", f"scheduler_{ep}.json"):
            assert (models / name).is_file(), name
        assert (result["path_base"] / "metrics" /
                f"metrics_step_{ep}.json").is_file()
    state = torch.load(models / "model_1.pth", weights_only=True)
    assert set(state) == {"net_video_local", "net_video_global",
                          "net_text_local", "net_text_global"}
    steps = json.loads((result["path_base"] / "metrics" /
                        "metrics_step_1.json").read_text())
    assert [s for s, _ in steps["train_base/loss"]] == [1, 2, 3, 4]
    opt = torch.load(models / "optimizer_1.pth", weights_only=True)
    assert opt["step"] == 4 and opt["optimizer"]["step"] == 4


def test_cli_validates_a_trained_checkpoint(smoke):
    argv, result = smoke
    val = train_retrieval.main(argv + ["--validate", "--load_epoch",
                                       "1"])[0]
    assert np.isfinite(val["loss_total"])
    weights = torch.load(result["path_base"] / "models" / "model_1.pth",
                         weights_only=True)
    mgr = RetrievalModelManager(
        RetrievalConfig(train_retrieval.load_yaml_config_file(SMOKE)),
        torch.device("cpu"))
    mgr.load_state(weights)
    assert mgr.was_loaded


def test_cli_resumes_the_same_run(smoke):
    argv, result = smoke
    resumed = train_retrieval.main(argv + ["-o", "train.num_epochs=3"])[0]
    assert resumed["path_base"] == result["path_base"]
    assert resumed["state"]["current_epoch"] == 3
    assert resumed["step_losses"][:4] == result["step_losses"]
    assert len(resumed["step_losses"]) == 6
    assert np.isfinite(resumed["step_losses"]).all()


def test_training_with_dropout_is_seeded(tmp_path):
    """Dropout on at every site (the plain versions on the CPU): finite,
    and the same seed gives the same losses."""
    generate_retrieval_dataset(tmp_path / "data", num_videos=8,
                               num_val_videos=4, seed=1)
    # the other nets take the local video net's settings (same_as)
    drop = ",".join(f"net_video_local.{key}=0.1" for key in (
        "selfatn_config.dropout", "pooler_config.dropout"))
    runs = []
    for run in ("a", "b"):
        runs.append(train_retrieval.main(
            ["-c", str(SMOKE), "--data_path", str(tmp_path / "data"),
             "--log_dir", str(tmp_path / "exp"), "--device", "cpu", "-r",
             run, "-o", "train.num_epochs=1,val.val_start=5," + drop]
        )[0]["step_losses"])
    assert np.isfinite(runs[0]).all() and runs[0] == runs[1]
