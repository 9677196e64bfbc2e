"""
MART caption training in the port against the JAX package on the CPU, on
the same numpy inputs and bridged weights (hidden 32, 4 heads, 2 layers,
S = 3, tests/helpers.caption_config_dict), with every dropout rate 0 (the
masks of the two frameworks differ and are not part of the contract):

- the train loss (1e-5 relative) and every parameter gradient (1e-4 of
  the largest gradient of the model) against jax.value_and_grad;
- warmup_linear and the trainer's current_lr: equal to JAX's, both in
  float32;
- BertAdam and the EMA over 5 steps fed identical gradients against
  make_bertadam / ema_update (parameters, moments and shadow 1e-6
  relative to their largest value);
- the masks: each parameter's JAX path (the bridge's names inverted), and
  a step with all-zero gradients moves exactly the parameters JAX decays,
  the LayerNorm gains inside nn.Sequential staying put; with freeze_glove
  the word embeddings stay put while their gradient counts in grad_norm;
- 3 steps of caption_train_step against make_caption_train_step: loss,
  grad_norm and n_correct 1e-5 relative, n_word equal, the parameter
  updates within 1% of lr (BertAdam's first steps divide by
  sqrt(v) + eps, eps = 1e-6: where |g| is under ~3e-5 a gradient's error
  of float32 rounding comes out multiplied by up to (1 - beta1) / eps =
  1e5, so an update is held to a share of lr, not to float precision),
  the moments 1e-4 of the model's largest moment (the key biases'
  gradients are rounding noise, ~1e-14) and the EMA shadow
  within 1% of lr of JAX's (measured: updates 0.13%, shadow 0.11%);
- the CLI on config/caption/default/synthetic_smoke.yaml with `--device
  cpu` on the port's synthetic caption set: 3 epochs unbroken against a
  run stopped after 2 epochs and resumed (parameters, EMA, moments, seed
  state and metrics bit for bit), the cleanup keeping the best and the
  last epoch, `--validate --load_epoch` evaluating the EMA and
  `--load_model` the file's weights, and the METEOR -999 patch-up of the
  best epoch's metrics file after a run trained with COOT_METEOR_LITE=0.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JState, make_caption_train_step)
from coot_videotext_tpu.tasks.caption.trainer import (
    MartTrainer as JMartTrainer)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu_torch import train_caption
from coot_videotext_tpu_torch.data.synthetic import generate_caption_dataset
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_loss_and_grads, caption_train_step, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.trainer import MartTrainer
from coot_videotext_tpu_torch.train import checkpoint as ckpt
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.utils.param_bridge import (
    flatten, jax_mart_params_to_state_dict, load_mart_checkpoint,
    mart_jax_paths)
from tests.helpers import caption_config_dict
from tests.test_torch_caption_model import _inputs, _rel

torch.set_num_threads(1)

VOCAB = 50
LR = 1e-3
NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0,
              "memory_dropout_prob": 0.0}
KEYS = ("input_ids", "video_feature", "input_mask", "token_type_ids",
        "input_labels")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, inputs) at dropout 0:
    JAX-initialised weights bridged into the port's model."""
    jmodel = jcreate(JConfig(caption_config_dict(NO_DROPOUT)), VOCAB,
                     verbose=False)
    cfg = MartConfig(caption_config_dict(NO_DROPOUT))
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"))
    inputs = _inputs(cfg)
    params = jmodel.init({"params": jax.random.PRNGKey(1)}, *inputs,
                         deterministic=True)["params"]
    load_mart_checkpoint(model, {"model": jax_mart_params_to_state_dict(
        params)})
    return jmodel, params, model, inputs


def _state(model, **overrides):
    """The trainer's train state of `model` (seed 0) under the test config
    with `overrides`."""
    cfg = MartConfig(caption_config_dict({**NO_DROPOUT, **overrides}))
    return init_caption_train_state(model, cfg, 0)


def _copy(model):
    """A fresh port model holding `model`'s weights."""
    cfg = MartConfig(caption_config_dict(NO_DROPOUT))
    other = create_mart_model(cfg, VOCAB, torch.device("cpu"))
    other.load_state_dict(model.state_dict())
    return other


def _torch_batch(inputs):
    return dict(zip(KEYS, (torch.from_numpy(np.asarray(a)) for a in inputs)))


def _by_torch_name(tree):
    """A JAX params-shaped tree as {torch name: numpy array in the torch
    layout}."""
    return jax_mart_params_to_state_dict(jax.device_get(tree))


def test_jax_paths_invert_the_bridge(pair):
    """Every parameter's JAX path maps back to its own name: the paths the
    masks read are the ones JAX's rule reads."""
    _, params, model, _ = pair
    paths = mart_jax_paths(model)
    flat = flatten(jax.device_get(params))
    expect = {next(iter(jax_mart_params_to_state_dict({p: v}))):
              "/".join(p) for p, v in flat.items()}
    assert paths == expect
    assert paths["embeddings.word_fc.0.weight"] == \
        "embeddings/word_ln_in/scale"
    assert paths["encoder.layer.1.memory_initilizer.init_memory_fc.1."
                 "weight"] == \
        "encoder/layer_1/memory_initilizer/init_memory_ln/scale"


def test_loss_and_grads_match_jax(pair):
    jmodel, params, model, inputs = pair

    def loss_fn(p):
        return jmodel.apply({"params": p}, *inputs, deterministic=True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    metrics, grads = caption_loss_and_grads(_state(_copy(model)),
                                            _torch_batch(inputs))
    assert _rel(jloss, metrics["loss"].numpy()) <= 1e-5
    ref = _by_torch_name(jgrads)
    assert set(ref) == set(grads)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        err = np.abs(g.numpy() - ref[name]).max() / scale
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("progress", [0.0, 0.03, 0.1, 0.37, 1.0, 1.25])
def test_warmup_linear_matches_jax(progress):
    for warmup in (0.1, 0.3):
        ref = float(joptim.warmup_linear(jnp.float32(progress), warmup))
        assert optim.warmup_linear(progress, warmup) == ref


@pytest.mark.parametrize("total_step", [0, 1, 7, 40, 399])
def test_current_lr_matches_jax(total_step):
    class Fake:
        cfg = MartConfig(caption_config_dict({}))
        t_total = 400

        class state:  # noqa: N801
            pass

    Fake.state.total_step = total_step
    assert MartTrainer.current_lr(Fake) == JMartTrainer.current_lr(Fake)


def _random_tree(params, seed, scale=1.0):
    """A tree shaped like params: normal values with magnitudes spread
    over four decades per leaf (some gradients tiny, as real ones are)."""
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for i, leaf in enumerate(leaves):
        mag = 10.0 ** -(i % 5)
        out.append(jnp.asarray(
            (rng.randn(*leaf.shape) * mag * scale).astype(np.float32)))
    return jax.tree_util.tree_unflatten(treedef, out)


def test_bertadam_and_ema_match_jax(pair):
    """5 steps fed the same gradients (not computed, so only the updates
    are compared): parameters, moments and the EMA shadow."""
    _, params, model, _ = pair
    model = _copy(model)
    state = _state(model)
    jopt = joptim.make_bertadam(eps=1e-6)
    jstate = jopt.init(params)
    jema = joptim.ema_init(params)
    jparams = params
    for step in range(5):
        g = _random_tree(params, step, scale=0.3)
        jparams, jstate = jopt.update(g, jstate, jparams, jnp.float32(LR))
        jema = joptim.ema_update(jema, jparams, 0.9999, jnp.int32(step))
        state.optimizer.step({n: torch.from_numpy(np.array(v)) for n, v in
                              _by_torch_name(g).items()}, LR)
        state.ema.update(torch.tensor(step, dtype=torch.int32))
    for ours, ref in ((dict(model.named_parameters()), jparams),
                      (state.optimizer.mu, jstate.mu),
                      (state.optimizer.nu, jstate.nu),
                      (state.ema.shadow, jema.shadow)):
        ref = _by_torch_name(ref)
        for name, v in ours.items():
            assert _rel(ref[name], v.detach().numpy()) <= 1e-6, name
    assert int(state.optimizer.step_count) == int(jstate.step) == 5


def test_zero_gradients_move_what_jax_decays(pair):
    """With zero gradients the update is weight_decay * p on the decayed
    parameters alone (all set non-zero first): the same set as JAX's,
    without the LayerNorm gains inside nn.Sequential."""
    _, params, model, _ = pair
    model = _copy(model)
    nonzero = _random_tree(params, 11)
    load_mart_checkpoint(model, {"model": _by_torch_name(nonzero)})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = _state(model)
    state.optimizer.step({n: torch.zeros_like(p)
                          for n, p in before.items()}, LR)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    jparams, _ = joptim.make_bertadam().update(
        jax.tree.map(jnp.zeros_like, nonzero),
        joptim.make_bertadam().init(nonzero), nonzero, jnp.float32(LR))
    ref = _by_torch_name(jparams)
    jmoved = {n for n, v in _by_torch_name(nonzero).items()
              if not np.array_equal(v, ref[n])}
    assert moved == jmoved
    for gain in ("embeddings.word_fc.0.weight", "embeddings.word_fc.4.weight",
                 "embeddings.video_embeddings.0.weight",
                 "embeddings.video_embeddings.4.weight",
                 "encoder.layer.0.memory_initilizer.init_memory_fc.1.weight",
                 "encoder.layer.0.memory_initilizer.init_memory_bias",
                 "decoder.bias"):
        assert gain not in moved, gain
    assert "encoder.layer.0.memory_initilizer.init_memory_fc.0.weight" \
        in moved
    assert len(moved) == sum(1 for p in state.optimizer.decay.values() if p)


def test_freeze_glove_keeps_embeddings_and_counts_their_gradient(pair):
    _, _, model, inputs = pair
    batch = _torch_batch(inputs)
    model = _copy(model)
    _, grads = caption_loss_and_grads(_state(_copy(model)), batch)
    word = "embeddings.word_embeddings.weight"
    assert grads[word].abs().max() > 0
    state = _state(model, use_glove=True, freeze_glove=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = caption_train_step(state, batch, LR)
    assert torch.equal(dict(model.named_parameters())[word], before[word])
    assert state.optimizer.mu[word].abs().max() > 0
    assert not torch.equal(
        dict(model.named_parameters())["embeddings.word_fc.2.weight"],
        before["embeddings.word_fc.2.weight"])
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    without = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for n, g in grads.items()
         if n != word]))
    assert float(metrics["grad_norm"]) == pytest.approx(float(norm),
                                                        rel=1e-6)
    assert float(norm) > float(without) * (1 + 1e-4)


def test_train_step_matches_jax(pair):
    """3 steps from the same weights, dropout 0, lr 1e-3."""
    jmodel, params, model, inputs = pair
    model = _copy(model)
    state = _state(model)
    jopt = joptim.make_bertadam(eps=1e-6)
    jstep = make_caption_train_step(jmodel, jopt, ema_decay=0.9999)
    jstate = JState(params, jopt.init(params), joptim.ema_init(params),
                    jnp.int32(0))
    jbatch = {k: jnp.asarray(v) for k, v in zip(KEYS, inputs)}
    batch = _torch_batch(inputs)
    for step in range(3):
        jbefore = _by_torch_name(jstate.params)
        before = {n: p.detach().clone().numpy()
                  for n, p in model.named_parameters()}
        jstate, jm = jstep(jstate, jbatch, jnp.float32(LR),
                           jax.random.PRNGKey(step))
        m = caption_train_step(state, batch, LR)
        for name in ("loss", "grad_norm", "n_correct"):
            assert _rel(jm[name], m[name].numpy()) <= 1e-5, (step, name)
        assert float(jm["n_word"]) == float(m["n_word"]) > 0
        jafter = _by_torch_name(jstate.params)
        for name, p in model.named_parameters():
            ours = p.detach().numpy() - before[name]
            ref = jafter[name] - jbefore[name]
            err = np.abs(ours - ref).max()
            assert err <= 0.01 * LR, (step, name, err)
        for ours, ref in ((state.optimizer.mu, jstate.opt_state.mu),
                          (state.optimizer.nu, jstate.opt_state.nu)):
            ref = _by_torch_name(ref)
            scale = max(np.abs(r).max() for r in ref.values())
            for name, v in ours.items():
                err = np.abs(v.numpy() - ref[name]).max() / scale
                assert err <= 1e-4, (step, name, err)
        ref = _by_torch_name(jstate.ema.shadow)
        for name, v in state.ema.shadow.items():
            err = np.abs(v.numpy() - ref[name]).max()
            assert err <= 0.01 * LR, (step, name, err)
    assert int(state.step) == int(jstate.step) == 3
    assert int(state.seed) == 3  # seed state: the run seed 0 + 3 steps


# ---------- the CLI on the CPU ----------

SMOKE = (Path(__file__).resolve().parents[1] / "config" / "caption" /
         "default" / "synthetic_smoke.yaml")
RUN = Path("caption") / "default" / "synthetic_smoke_run1"


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_train")
    info = generate_caption_dataset(root / "data", num_videos=16,
                                    num_val_videos=8, seed=1)
    return root, info


def _cli(info, log_dir, *extra):
    return train_caption.main([
        "-c", str(SMOKE), "--device", "cpu", "--log_dir", str(log_dir),
        "--annotations_dir", info["annotations_dir"],
        "--coot_feat_dir", info["coot_feat_dir"], *extra])[0]


@pytest.fixture(scope="module")
def unbroken(smoke_data):
    """3 epochs of synthetic_smoke.yaml in one run (2 steps an epoch)."""
    root, info = smoke_data
    result = _cli(info, root / "unbroken", "-o", "train.num_epochs=3")
    return root / "unbroken" / RUN, result


def _metrics(run, epoch):
    data = json.loads((run / "metrics" / f"metrics_epoch_{epoch}.json")
                      .read_text())
    return {k: v for k, v in data.items() if not k.startswith("ztime")}


def test_cli_trains_and_keeps_best_and_last(unbroken):
    run, result = unbroken
    assert result["model_device"].type == "cpu"
    assert result["batch_device"].type == "cpu"
    assert result["epochs"] == [0, 1, 2]
    assert result["total_step"] == 3 * result["steps_per_epoch"] == 6
    assert len(result["step_ms"]) == 6
    assert len(result["train_videos_per_s"]) == 3
    metrics = _metrics(run, 2)
    losses = [v for _, v in metrics["train/loss_word"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    best = max(metrics["cap/cid"], key=lambda e: e[1])[0]
    kept = sorted({best, 2})
    models = run / "models"
    for prefix in ("model", "modelema", "optimizer", "trainerstate"):
        found = sorted(int(f.stem.split("_")[-1])
                       for f in models.glob(f"{prefix}_*"))
        assert found == kept, prefix
    translations = sorted(int(f.stem.split("_")[1]) for f in
                          (run / "caption").glob("translations_*_val.json"))
    assert translations == kept


def test_cli_resume_equals_unbroken(smoke_data, unbroken, monkeypatch):
    """A 3-epoch run stopped after epoch 1 (its checkpoint written, as a
    killed run leaves it) and run again: epoch 2 equals the unbroken
    run's bit for bit (the lr schedule spans the configured 3 epochs, so
    the first part must be configured for 3 as well)."""
    root, info = smoke_data
    run_a, _ = unbroken
    stop = MartTrainer.check_early_stop
    monkeypatch.setattr(MartTrainer, "check_early_stop",
                        lambda self: self.state.current_epoch == 2
                        or stop(self))
    first = _cli(info, root / "resumed", "-o", "train.num_epochs=3")
    assert first["epochs"] == [0, 1]
    monkeypatch.setattr(MartTrainer, "check_early_stop", stop)
    second = _cli(info, root / "resumed", "-o", "train.num_epochs=3")
    assert second["epochs"] == [2] and second["total_step"] == 6
    run_b = root / "resumed" / RUN
    for name in ("model_2.pth", "modelema_2.pth"):
        a, b = (ckpt.load(r / "models" / name)["model"]
                for r in (run_a, run_b))
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), (name, key)
    a, b = (ckpt.load(r / "models" / "optimizer_2.pth")
            for r in (run_a, run_b))
    assert torch.equal(a["step"], b["step"]) and int(a["step"]) == 6
    assert torch.equal(a["seed"], b["seed"])
    assert torch.equal(a["optimizer"]["step"], b["optimizer"]["step"])
    for moment in ("mu", "nu"):
        for key in a["optimizer"][moment]:
            assert torch.equal(a["optimizer"][moment][key],
                               b["optimizer"][moment][key]), (moment, key)
    assert _metrics(run_a, 2) == _metrics(run_b, 2)


def test_cli_validate_evaluates_the_ema(smoke_data, unbroken):
    """`--validate --load_epoch 2` gives epoch 2's validation of the
    training run (EMA weights); `--load_model` of the epoch's model file
    evaluates those weights as they are, which differ."""
    root, info = smoke_data
    run, _ = unbroken
    trained = dict(_metrics(run, 2)["val/loss_word"])[2]
    result = _cli(info, root / "unbroken", "--validate", "--load_epoch",
                  "2")
    ours = json.loads(result["metrics_file"].read_text())
    assert ours["val/loss_word"][-1] == [2, trained]
    raw = _cli(info, root / "raw", "--validate", "--load_model",
               str(run / "models" / "model_2.pth"))
    assert raw["val_loss"] != result["val_loss"]


def test_cli_patches_meteor_of_the_best_epoch(smoke_data, monkeypatch):
    """Trained without a METEOR scorer (COOT_METEOR_LITE=0: -999), the best
    epoch's metrics file gets the score of its later validation."""
    root, info = smoke_data
    monkeypatch.setenv("COOT_METEOR_LITE", "0")
    _cli(info, root / "meteor", "-o", "train.num_epochs=1")
    metrics_file = root / "meteor" / RUN / "metrics" / "metrics_epoch_0.json"
    assert json.loads(metrics_file.read_text())["cap/met"] == [[0, -999]]
    monkeypatch.setenv("COOT_METEOR_LITE", "1")
    result = _cli(info, root / "meteor", "--validate")
    (epoch, meteor), = json.loads(metrics_file.read_text())["cap/met"]
    assert epoch == 0 and meteor == result["metrics"]["METEOR"]
    assert 0 < meteor < 1
