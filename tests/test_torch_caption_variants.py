"""
The port's untied model (`recurrent: false, untied: true`), the joint
single-sentence NonRecurTransformer (`recurrent: false`) and the decoder
tied to the word embeddings (`share_wd_cls_weight: true`, word_vec_size =
hidden_size) against the JAX package on the CPU, on the same numpy inputs
and bridged weights (hidden 32, 4 heads, 2 layers, max_v_len 3, max_t_len
10, vocabulary 50: tests/helpers.caption_config_dict). The harness here
is shared with tests/test_torch_caption_xl.py:

- the weight bridge: the port's state dict (without its tied alias)
  through the JAX package's convert_mart_model_state and apply_converted
  (strict), back through the family's jax_*_params_to_state_dict
  unchanged; the family's *_jax_paths inverts it;
- the forward (dropout 0): loss and scores 1e-5 relative; the eval step
  1e-5 relative;
- every gradient 1e-4 of JAX's largest against jax.value_and_grad;
- BertAdam's masks: a step with zero gradients from non-zero weights
  moves exactly what JAX's name rule moves, under use_glove +
  freeze_glove (the tied decoder frozen with the word embeddings);
- 3 steps of the train step against JAX's, dropout 0, lr 1e-3: loss,
  grad_norm and n_correct 1e-5 relative, the updates and the EMA within
  1% of lr;
- the greedy decode of the family: token-identical to JAX's Translator;
- the joint single-sentence collation with a padded short batch: every
  array equal to JAX's;
- the CLI on config/caption/default/synthetic_smoke.yaml with the
  variant's `-o` overrides and `--device cpu`: one epoch of training and
  validation, translations free of special tokens; `--validate
  --load_model` of one `.pth` through both CLIs (`ema_decay=0`) gives the
  same val loss and translations. Not for the tied decoder: the JAX CLI
  refuses a tied reference checkpoint (its converter maps
  `decoder.decoder.weight` onto a `decoder/decoder/kernel` the tied head
  does not have; held below), so the port's tied `.pth` is checked
  against JAX's trainer-free decode instead.
"""

import copy
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.data.caption_dataset import (
    RecursiveCaptionDataset as JDataset)
from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JState, make_caption_eval_step,
    make_caption_eval_step_single, make_caption_train_step,
    make_caption_train_step_single)
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu.utils import torch_convert
from coot_videotext_tpu_torch import train_caption
from coot_videotext_tpu_torch.data.caption_dataset import (
    RecursiveCaptionDataset)
from coot_videotext_tpu_torch.data.synthetic import generate_caption_dataset
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_eval_step, caption_eval_step_single, caption_loss_and_grads,
    caption_train_step, caption_train_step_single, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.utils.param_bridge import (
    flatten, jax_mart_params_to_state_dict, jax_untied_params_to_state_dict,
    jax_xl_params_to_state_dict, load_mart_checkpoint, mart_jax_paths,
    state_dict_for_jax, untied_jax_paths, xl_jax_paths)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file
from tests.helpers import caption_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 50
S, N = 3, 4
LR = 1e-3
NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0,
              "memory_dropout_prob": 0.0}
# each variant's `-o` overrides of a caption config
VARIANTS = {
    "mart": {},
    "xl": {"xl": True},
    "xl_grad": {"xl": True, "xl_grad": True},
    "untied": {"recurrent": False, "untied": True},
    "joint": {"recurrent": False},
    "tied": {"share_wd_cls_weight": True, "word_vec_size": 32},
}
STACKED = ("input_ids", "video_feature", "input_mask", "token_type_ids",
           "input_labels")
UNTIED = ("video_feature", "video_mask", "text_ids", "text_mask",
          "text_labels")
SPECIALS = ("[VID]", "[CLS]", "[SEP]", "[BOS]", "[PAD]")


def layout(variant: str) -> str:
    """stacked (S, N, ...) recurrent batches, or untied or joint (N, ...)
    sentence batches."""
    if not VARIANTS[variant].get("recurrent", True):
        return "untied" if VARIANTS[variant].get("untied") else "joint"
    return "stacked"


def family(variant: str) -> str:
    """The JAX converter's family."""
    return {"xl": "xl", "xl_grad": "xl", "untied": "untied"}.get(variant,
                                                                 "mart")


def by_torch_name(variant: str, tree):
    """A JAX param-shaped tree as the port's {state-dict key: array}."""
    fn = {"xl": jax_xl_params_to_state_dict,
          "untied": jax_untied_params_to_state_dict}.get(
        family(variant), jax_mart_params_to_state_dict)
    return fn(jax.device_get(tree))


def jax_paths(variant: str, model):
    return {"xl": xl_jax_paths, "untied": untied_jax_paths}.get(
        family(variant), mart_jax_paths)(model)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def make_inputs(variant: str, cfg, seed: int = 0):
    """The batch arrays in the layout's key order (STACKED or UNTIED):
    some padded video and text, [BOS]-led text, shifted labels with
    IGNORE."""
    rng = np.random.RandomState(seed)
    v, t = cfg.max_v_len, cfg.max_t_len
    if layout(variant) == "untied":
        n = N + 1
        feats = rng.randn(n, v, cfg.video_feature_size).astype(np.float32)
        vmask = np.ones((n, v), np.float32)
        vmask[0, 1:] = 0
        vmask[3, 2] = 0
        ids = rng.randint(7, VOCAB, (n, t)).astype(np.int64)
        ids[:, 0] = 4  # [BOS]
        tmask = np.ones((n, t), np.float32)
        tmask[0, 6:] = 0
        tmask[3, 4:] = 0
        ids[tmask == 0] = 0
        labels = np.where(tmask > 0, np.roll(ids, -1, axis=1), -1)
        labels[:, -1] = -1
        labels[0, 5] = labels[3, 3] = -1
        return feats, vmask, ids, tmask, labels.astype(np.int64)
    lead = (S, N) if layout(variant) == "stacked" else (N + 1,)
    length = v + t
    ids = rng.randint(7, VOCAB, lead + (length,)).astype(np.int64)
    feats = rng.randn(*lead, length,
                      cfg.video_feature_size).astype(np.float32)
    masks = np.ones(lead + (length,), np.float32)
    masks[..., 0, v - 1] = 0
    masks[..., 1, -4:] = 0
    ttys = np.concatenate([np.zeros(lead + (v,)), np.ones(lead + (t,))],
                          -1).astype(np.int64)
    labels = np.where(rng.rand(*lead, length) < 0.3, -1,
                      rng.randint(0, VOCAB, lead + (length,)))
    labels[..., :v] = -1
    return ids, feats, masks, ttys, labels.astype(np.int64)


def keys(variant: str):
    return UNTIED if layout(variant) == "untied" else STACKED


def batch_of(variant: str, inputs):
    return dict(zip(keys(variant),
                    (torch.from_numpy(np.asarray(a)) for a in inputs)))


def configs(variant: str, **overrides):
    over = {**NO_DROPOUT, **VARIANTS[variant], **overrides}
    return JConfig(caption_config_dict(over)), MartConfig(
        caption_config_dict(over))


def to_jax(variant: str, model, jmodel, inputs):
    """The port model's weights as JAX params, through the JAX package's
    own converter (strict), the tied alias dropped."""
    template = jmodel.init({"params": jax.random.PRNGKey(0)}, *inputs,
                           deterministic=True)["params"]
    flat = torch_convert.convert_mart_model_state(
        state_dict_for_jax(model), family=family(variant))
    return torch_convert.apply_converted(template, flat)


def make_pair(variant: str):
    """(JAX model, JAX params, JAX cfg, port model, port cfg, inputs) at
    dropout 0: the port's seeded weights, their matrices scaled up so the
    decodes vary, converted into JAX's."""
    jcfg, cfg = configs(variant)
    jmodel = jcreate(jcfg, VOCAB, verbose=False)
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(3.0)
    inputs = make_inputs(variant, cfg)
    jcfg.vocab_size = VOCAB
    return (jmodel, to_jax(variant, model, jmodel, inputs), jcfg, model,
            cfg, inputs)


def copy_model(variant: str, model):
    _, cfg = configs(variant)
    other = create_mart_model(cfg, VOCAB, torch.device("cpu"))
    other.load_state_dict(model.state_dict())
    return other


def train_state(variant: str, model, **overrides):
    return init_caption_train_state(model, configs(variant, **overrides)[1],
                                    0)


# ---------- the checks, each taking a variant's pair ----------

def check_bridge(variant, pair):
    """Port state dict -> JAX (strict) -> back: unchanged; each
    parameter's JAX path is the one the converter gives its key."""
    _, params, _, model, _, _ = pair
    back = by_torch_name(variant, params)
    ours = state_dict_for_jax(model)
    assert back.keys() == ours.keys()
    for key, value in ours.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    expect = {next(iter(by_torch_name(variant, {p: v}))): "/".join(p)
              for p, v in flatten(jax.device_get(params)).items()}
    assert jax_paths(variant, model) == expect


def check_forward(variant, pair):
    jmodel, params, _, model, _, inputs = pair
    jloss, jscores = jmodel.apply({"params": params}, *inputs,
                                  deterministic=True)
    with torch.no_grad():
        loss, scores = model.eval()(*batch_of(variant, inputs).values())
    assert _rel(jloss, loss.numpy()) <= 1e-5
    if layout(variant) == "stacked":
        assert len(scores) == len(jscores) == S
        scores, jscores = torch.stack(scores), np.stack(jscores)
    assert _rel(jscores, scores.numpy()) <= 1e-5
    jbatch = {k: jnp.asarray(v) for k, v in zip(keys(variant), inputs)}
    if layout(variant) == "stacked":
        ref = make_caption_eval_step(jmodel)(params, jbatch)
        ours = caption_eval_step(model, batch_of(variant, inputs))
    else:
        ref = make_caption_eval_step_single(
            jmodel, untied=layout(variant) == "untied")(params, jbatch)
        ours = caption_eval_step_single(model, batch_of(variant, inputs))
    assert _rel(ref["loss"], ours["loss"].numpy()) <= 1e-5
    for name in ("n_correct", "n_word"):
        assert float(ref[name]) == float(ours[name]), name
    assert float(ours["n_word"]) > 0


def check_grads(variant, pair, inputs=None):
    """Every gradient within 1e-4 of JAX's largest; returns the port's
    gradients."""
    jmodel, params, _, model, _, pair_inputs = pair
    inputs = pair_inputs if inputs is None else inputs

    def loss_fn(p):
        return jmodel.apply({"params": p}, *inputs, deterministic=True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    metrics, grads = caption_loss_and_grads(
        train_state(variant, copy_model(variant, model)),
        batch_of(variant, inputs), single=layout(variant) != "stacked")
    assert _rel(jloss, metrics["loss"].numpy()) <= 1e-5
    ref = by_torch_name(variant, jgrads)
    assert set(ref) == set(grads)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        err = np.abs(g.numpy() - ref[name]).max() / scale
        assert err <= 1e-4, (name, err)
    return grads


def _random_tree(params, seed):
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.randn(*leaf.shape).astype(np.float32))
        for leaf in leaves])


def check_masks(variant, pair):
    """A BertAdam step with zero gradients from non-zero weights, under
    use_glove + freeze_glove, moves exactly the parameters JAX moves.
    Returns the moved names."""
    _, params, _, model, _, _ = pair
    model = copy_model(variant, model)
    nonzero = _random_tree(params, 11)
    load_mart_checkpoint(model, {"model": by_torch_name(variant, nonzero)})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = train_state(variant, model, use_glove=True, freeze_glove=True)
    assert state.optimizer.frozen == {"embeddings.word_embeddings.weight"}
    state.optimizer.step({n: torch.zeros_like(p)
                          for n, p in before.items()}, LR)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    jopt = joptim.make_bertadam(frozen_names=("word_embeddings",))
    jparams, _ = jopt.update(jax.tree.map(jnp.zeros_like, nonzero),
                             jopt.init(nonzero), nonzero, jnp.float32(LR))
    ref = by_torch_name(variant, jparams)
    jmoved = {n for n, v in by_torch_name(variant, nonzero).items()
              if not np.array_equal(v, ref[n])}
    assert moved == jmoved
    assert "embeddings.word_embeddings.weight" not in moved
    return moved


def check_train_steps(variant, pair):
    """3 steps from the same weights, dropout 0, lr 1e-3."""
    jmodel, params, _, model, _, inputs = pair
    model = copy_model(variant, model)
    state = train_state(variant, model)
    jopt = joptim.make_bertadam(eps=1e-6)
    if layout(variant) == "stacked":
        jstep = make_caption_train_step(jmodel, jopt, ema_decay=0.9999)
        step_fn = caption_train_step
    else:
        jstep = make_caption_train_step_single(
            jmodel, jopt, ema_decay=0.9999,
            untied=layout(variant) == "untied")
        step_fn = caption_train_step_single
    jstate = JState(params, jopt.init(params), joptim.ema_init(params),
                    jnp.int32(0))
    jbatch = {k: jnp.asarray(v) for k, v in zip(keys(variant), inputs)}
    batch = batch_of(variant, inputs)
    for step in range(3):
        jbefore = by_torch_name(variant, jstate.params)
        before = {n: p.detach().clone().numpy()
                  for n, p in model.named_parameters()}
        jstate, jm = jstep(jstate, jbatch, jnp.float32(LR),
                           jax.random.PRNGKey(step))
        m = step_fn(state, batch, LR)
        for name in ("loss", "grad_norm", "n_correct"):
            assert _rel(jm[name], m[name].numpy()) <= 1e-5, (step, name)
        assert float(jm["n_word"]) == float(m["n_word"]) > 0
        jafter = by_torch_name(variant, jstate.params)
        for name, p in model.named_parameters():
            err = np.abs((p.detach().numpy() - before[name])
                         - (jafter[name] - jbefore[name])).max()
            assert err <= 0.01 * LR, (step, name, err)
        ref = by_torch_name(variant, jstate.ema.shadow)
        for name, v in state.ema.shadow.items():
            err = np.abs(v.numpy() - ref[name]).max()
            assert err <= 0.01 * LR, (step, name, err)
    assert int(state.step) == int(jstate.step) == 3


def check_greedy(variant, pair):
    """The family's greedy decode, token for token; returns the port's
    (stacked for the recurrent models)."""
    jmodel, params, jcfg, model, cfg, inputs = pair
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch(
        inputs[:4], recurrent=cfg.recurrent, untied=cfg.untied,
        xl=cfg.xl, mtrans=cfg.mtrans)
    translator = Translator(model, cfg)
    ours = translator.translate_batch(batch_of(variant, inputs))
    if layout(variant) == "stacked":
        assert len(ours) == len(ref) == S
        ours, ref = np.stack(ours), np.stack([np.asarray(r) for r in ref])
        assert translator.forwards == S * (cfg.max_t_len + 1)
    else:
        assert translator.forwards == cfg.max_t_len + (
            layout(variant) == "untied")
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert ours.shape[-1] == cfg.max_t_len
    assert (ours[..., 0] == 4).all()  # [BOS] first: the text region
    assert len({tuple(r) for r in ours.reshape(-1, ours.shape[-1])
                [:, 1:].tolist()}) > 1
    return ours


# ---------- the CLI ----------

SMOKE = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"
RUN = Path("caption") / "default" / "synthetic_smoke_run1"
# the variants' overrides of synthetic_smoke.yaml (hidden 32)
CLI_OVERRIDES = {
    "xl": "xl=true", "xl_grad": "xl=true,xl_grad=true",
    "untied": "recurrent=false,untied=true", "joint": "recurrent=false",
    "tied": "share_wd_cls_weight=true,word_vec_size=32",
    "beam": "use_beam=true", "beam_compat":
        "use_beam=true,beam_reference_compat=true",
}


def make_synth(root):
    return generate_caption_dataset(root / "data", num_videos=10,
                                    num_val_videos=6, seed=2)


def cli_argv(info, log_dir, *extra, config: Path = SMOKE):
    return ["-c", str(config), "--log_dir", str(log_dir),
            "--annotations_dir", info["annotations_dir"],
            "--coot_feat_dir", info["coot_feat_dir"], *extra]


def check_cli_trains(variant, root, info):
    """One epoch of training with validation on the CPU: the checkpoint
    files, translations of every val video free of special tokens, a
    finite val loss."""
    result = train_caption.main(cli_argv(
        info, root / variant, "--device", "cpu", "-o",
        f"{CLI_OVERRIDES[variant]},train.num_epochs=1"))[0]
    assert result["model_device"].type == "cpu"
    single = layout(variant) != "stacked"
    assert result["train_unit"] == ("sentences" if single else "videos")
    assert result["epochs"] == [0] and result["total_step"] >= 2
    run = root / variant / RUN
    for name in ("model_0.pth", "modelema_0.pth", "optimizer_0.pth"):
        assert (run / "models" / name).is_file(), name
    ann = json.loads((Path(info["annotations_dir"]) / "youcook2" /
                      "captioning_val.json").read_text())
    res = json.loads((run / "caption" / "translations_0_val.json")
                     .read_text())["results"]
    assert set(res) == set(ann)
    for name, sents in res.items():
        assert len(sents) == min(len(ann[name]["sentences"]), 7)
        for s in sents:
            for special in SPECIALS:
                assert special not in s["sentence"], s["sentence"]
    metrics = json.loads((run / "metrics" / "metrics_epoch_0.json")
                         .read_text())
    assert np.isfinite(metrics["val/loss_word"][0][1])
    return result


def check_cli_matches_jax(variant, root, info, monkeypatch,
                          model_overrides, config_file: Path = SMOKE,
                          eos_bias: float = 0.0):
    """One `.pth` of the port's model (synthetic_smoke.yaml with
    `model_overrides`, seed 7, matrices scaled up, `eos_bias` added to the
    head's [EOS] bias) validated by both CLIs on `config_file` with the
    variant's `-o` overrides and `ema_decay=0` (the JAX CLI's
    `--load_model` needs it): the same translations and val loss. Returns
    the port's result."""
    config = load_yaml_config_file(SMOKE)
    config.update(model_overrides)
    model = create_mart_model(MartConfig(config), info["vocab_size"],
                              torch.device("cpu"), seed=7)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
        if eos_bias:  # the recurrent model's head
            model.decoder.bias[5] += eos_bias
    pth = root / f"{variant}.pth"
    torch.save({"model": model.state_dict()}, pth)
    flags = ["--validate", "--load_model", str(pth), "-o",
             f"{CLI_OVERRIDES[variant]},ema_decay=0"]
    result = train_caption.main(cli_argv(info, root / f"port_{variant}",
                                         *flags, "--device", "cpu",
                                         config=config_file))[0]
    monkeypatch.syspath_prepend(str(ROOT))
    import train_caption as jax_cli
    monkeypatch.setattr(sys, "argv", ["train_caption.py"] + cli_argv(
        info, root / f"jax_{variant}", *flags, config=config_file))
    jax_cli.main()
    translations = RUN / "caption" / "translations_0_val.json"
    ref = json.loads((root / f"jax_{variant}" / translations).read_text())
    ours = json.loads(result["translation_file"].read_text())
    assert ours == ref
    sentences = [e["sentence"] for v in ours["results"].values() for e in v]
    assert len(set(sentences)) > 1
    (_, r), = json.loads((root / f"jax_{variant}" / RUN / "val_ep_0.json")
                         .read_text())["val/loss_word"]
    (_, o), = json.loads(result["metrics_file"].read_text())[
        "val/loss_word"]
    assert o == pytest.approx(r, rel=1e-5)
    return result


# ---------- the tests of this file: untied, joint, tied ----------

MINE = ("untied", "joint", "tied")


@pytest.fixture(scope="module", params=MINE)
def pair(request):
    return request.param, make_pair(request.param)


def test_bridge_round_trip_and_paths(pair):
    check_bridge(*pair)


def test_forward_matches_jax(pair):
    check_forward(*pair)


def test_grads_match_jax(pair):
    variant, p = pair
    grads = check_grads(variant, p)
    if variant == "tied":  # one matrix: both uses' gradient
        assert "decoder.decoder.weight" not in grads
        assert grads["embeddings.word_embeddings.weight"].abs().max() > 0


def test_masks_match_jax(pair):
    variant, p = pair
    moved = check_masks(variant, p)
    if variant == "tied":  # the output matrix is frozen with the words
        assert "decoder.bias" not in moved
    for name in moved:
        assert not name.endswith("bias"), name


def test_train_steps_match_jax(pair):
    check_train_steps(*pair)


def test_greedy_matches_jax(pair):
    check_greedy(*pair)


def test_tied_head_shares_the_word_embeddings():
    """One Parameter under both reference keys: the state dict keeps
    both, named_parameters one; a reference `.pth` with both keys loads,
    and so does one without the alias."""
    _, cfg = configs("tied")
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=1)
    assert model.decoder.decoder.weight is \
        model.embeddings.word_embeddings.weight
    sd = model.state_dict()
    assert "decoder.decoder.weight" in sd
    names = dict(model.named_parameters())
    assert "decoder.decoder.weight" not in names
    other = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=2)
    load_mart_checkpoint(other, {"model": sd})
    assert torch.equal(other.decoder.decoder.weight,
                       sd["embeddings.word_embeddings.weight"])
    third = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=2)
    load_mart_checkpoint(third, {"model": state_dict_for_jax(model)})
    assert third.decoder.decoder.weight is \
        third.embeddings.word_embeddings.weight
    assert torch.equal(third.decoder.decoder.weight,
                       sd["embeddings.word_embeddings.weight"])
    # the untied model has no joint word embeddings to tie to: refused,
    # as JAX's head asserts
    with pytest.raises(ValueError, match="share_wd_cls_weight"):
        create_mart_model(configs("untied", share_wd_cls_weight=True)[1],
                          VOCAB, torch.device("cpu"))


def test_jax_converter_refuses_a_tied_reference_checkpoint():
    """The JAX package's convert_model_file path (convert_mart_model_state
    + apply_converted) refuses the reference layout of a tied model, both
    keys present: a fault of the JAX package, logged in ROADMAP §C."""
    jcfg, cfg = configs("tied")
    jmodel = jcreate(jcfg, VOCAB, verbose=False)
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=1)
    inputs = make_inputs("tied", cfg)
    template = jmodel.init({"params": jax.random.PRNGKey(0)}, *inputs,
                           deterministic=True)["params"]
    flat = torch_convert.convert_mart_model_state(
        {k: v.numpy() for k, v in model.state_dict().items()})
    with pytest.raises(ValueError, match="decoder/decoder/kernel"):
        torch_convert.apply_converted(template, flat)


@pytest.fixture(scope="module")
def joint_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_joint")
    info = make_synth(root)
    kwargs = dict(recurrent=False, untied=False,
                  coot_model_name=info["coot_model_name"],
                  coot_dim_vid=info["coot_dim_vid"],
                  coot_dim_clip=info["coot_dim_clip"],
                  annotations_dir=info["annotations_dir"],
                  coot_feat_dir=info["coot_feat_dir"])
    return (RecursiveCaptionDataset("youcook2", 10, 3, 4, "val", **kwargs),
            JDataset("youcook2", 10, 3, 4, "val", **kwargs))


def test_joint_collation_matches_jax(joint_sets):
    """Single joint sentences, COOT vidclip rows, a short last batch
    padded to N with IGNORE-labelled dummies: every array equal."""
    ours, ref = joint_sets
    assert ours.data == ref.data and len(ours) > 8
    for start in (0, 8):
        idx = range(start, min(start + 8, len(ours)))
        a, sizes, meta = ours.collate_fn([ours[i] for i in idx],
                                         batch_size=8)
        b, rsizes, rmeta = ref.collate_fn([ref[i] for i in idx],
                                          batch_size=8)
        assert sizes is rsizes is None and meta == rmeta
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key
        assert a["input_ids"].shape == (8, 13)
        assert a["video_feature"].shape == (8, 13, 96)
    assert (a["input_labels"][len(idx):] == -1).all()  # padded dummies
    assert (a["input_labels"][:len(idx)] >= 0).any()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_variants_cli")
    return root, make_synth(root)


@pytest.mark.parametrize("variant", MINE)
def test_cli_trains_and_validates(synth, variant):
    check_cli_trains(variant, *synth)


@pytest.mark.parametrize("variant", ("untied", "joint"))
def test_cli_validate_matches_jax_trainer(synth, variant, monkeypatch):
    root, info = synth
    result = check_cli_matches_jax(variant, root, info, monkeypatch,
                                   VARIANTS[variant])
    assert all(f == 12 + (variant == "untied") for f in result["forwards"])


def test_cli_tied_validate_matches_jax_decode(synth):
    """The tied model's `.pth` validated by the port's CLI: its
    translations are JAX's greedy decode of the same weights (carried over
    by state_dict_for_jax), sentence for sentence."""
    root, info = synth
    config = load_yaml_config_file(SMOKE)
    config.update(VARIANTS["tied"], ema_decay=0)
    cfg = MartConfig(copy.deepcopy(config))
    model = create_mart_model(cfg, info["vocab_size"], torch.device("cpu"),
                              seed=7)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    pth = root / "tied.pth"
    torch.save({"model": model.state_dict()}, pth)
    result = train_caption.main(cli_argv(
        info, root / "port_tied", "--validate", "--load_model", str(pth),
        "-o", f"{CLI_OVERRIDES['tied']},ema_decay=0", "--device", "cpu"))[0]
    ours = json.loads(result["translation_file"].read_text())["results"]
    jcfg = JConfig(config)
    jmodel = jcreate(jcfg, info["vocab_size"], verbose=False)
    val = RecursiveCaptionDataset(
        "youcook2", cfg.max_t_len, cfg.max_v_len,
        cfg.max_n_sen + cfg.max_n_sen_add_val, "val",
        coot_model_name=info["coot_model_name"],
        coot_dim_vid=info["coot_dim_vid"],
        coot_dim_clip=info["coot_dim_clip"],
        annotations_dir=info["annotations_dir"],
        coot_feat_dir=info["coot_feat_dir"])
    stacked, sizes, metas = val.collate_fn([val[i] for i in range(len(val))])
    inputs = [stacked[k] for k in STACKED]
    params = to_jax("tied", model, jmodel, inputs)
    dec = JTranslator(jmodel, lambda: params, jcfg).translate_batch_greedy(
        *inputs[:4])
    for ex, (size, meta) in enumerate(zip(sizes, metas)):
        ref = [val.convert_ids_to_sentence(np.asarray(dec[s])[ex].tolist())
               for s in range(size)]
        got = sorted(ours[meta["name"]],
                     key=lambda e: float(e["timestamp"][0]))
        assert [e["sentence"] for e in got] == ref, meta["name"]
