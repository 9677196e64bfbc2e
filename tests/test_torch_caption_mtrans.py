"""
The port's MTransformer path (`recurrent: false, mtrans: true`, the
untied single-sentence layout) against the JAX package on the CPU, on the
same numpy inputs and bridged weights (hidden 32, 4 heads, 2 layers,
max_v_len 3, max_t_len 10: tests/helpers.caption_config_dict):

- the building blocks: positional encodings equal, MTLayerNorm and the
  multi-head attention (causal and cross) 1e-5 relative;
- the weight bridge: the port's state dict through the JAX package's
  convert_mart_model_state (family mtrans) and apply_converted (strict),
  back through jax_mtrans_params_to_state_dict unchanged; mtrans_jax_paths
  inverts it;
- the forward (dropout 0): loss and scores 1e-5 relative; every gradient
  1e-4 of the largest gradient against jax.value_and_grad; the eval step
  1e-5 relative;
- BertAdam's masks on the mtrans paths: equal to JAX's name rule (the
  LayerNorm gamma and beta decayed, out_bias and every bias not);
- 3 steps of caption_train_step_single against
  make_caption_train_step_single, dropout 0, lr 1e-3: loss, grad_norm and
  n_correct 1e-5 relative, the updates and the EMA within 1% of lr;
- the untied greedy decode: token-identical to JAX's
  translate_batch_single_sentence_untied_greedy;
- the untied collation (COOT vidclip input) with a padded short batch:
  every array equal to JAX's;
- GloVe on the MTransformer: a warning, the parameters equal to those
  built without it;
- the CLI on config/caption/default/synthetic_smoke.yaml with
  `-o recurrent=false,mtrans=true --device cpu`: one epoch of training and
  validation, translations free of special tokens; `--validate
  --load_model` of one `.pth` through both CLIs (`ema_decay=0`, GloVe off
  for JAX: its apply_glove raises KeyError 'embeddings' on this model)
  gives the same val loss and translations.
"""

import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.data.caption_dataset import (
    RecursiveCaptionDataset as JDataset)
from coot_videotext_tpu.models.caption import mtransformer as jmt
from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JState, make_caption_eval_step_single,
    make_caption_train_step_single)
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu.utils import torch_convert
from coot_videotext_tpu_torch import train_caption
from coot_videotext_tpu_torch.data.caption_dataset import (
    RecursiveCaptionDataset)
from coot_videotext_tpu_torch.data.synthetic import generate_caption_dataset
from coot_videotext_tpu_torch.models.caption import mtransformer as mt
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    build_mart_model_manager, create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_eval_step_single, caption_loss_and_grads,
    caption_train_step_single, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.utils.param_bridge import (
    flatten, jax_mtrans_params_to_state_dict, load_mart_checkpoint,
    mtrans_jax_paths)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file
from tests.helpers import caption_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 50
N = 5
LR = 1e-3
MTRANS = {"recurrent": False, "mtrans": True}
NO_DROPOUT = {**MTRANS, "hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0,
              "memory_dropout_prob": 0.0}
KEYS = ("video_feature", "video_mask", "text_ids", "text_mask",
        "text_labels")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _inputs(cfg, seed=0):
    """An untied batch: COOT-like video rows (only row 0 valid in most
    rows), [BOS]-led text with padding, shifted labels."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, cfg.max_v_len,
                      cfg.video_feature_size).astype(np.float32)
    vmask = np.zeros((N, cfg.max_v_len), np.float32)
    vmask[:, 0] = 1
    vmask[1, :2] = 1
    vmask[2] = 1
    ids = rng.randint(7, VOCAB, (N, cfg.max_t_len)).astype(np.int64)
    ids[:, 0] = 4  # [BOS]
    tmask = np.ones((N, cfg.max_t_len), np.float32)
    tmask[0, 6:] = 0
    tmask[3, 4:] = 0
    ids[tmask == 0] = 0
    labels = np.where(tmask > 0, np.roll(ids, -1, axis=1), -1)
    labels[:, -1] = -1
    labels[0, 5] = labels[3, 3] = -1
    return feats, vmask, ids, tmask, labels.astype(np.int64)


def _jax_params(model, jmodel, inputs):
    """The port model's weights as JAX params (through the JAX package's
    own converter, family mtrans)."""
    template = jmodel.init({"params": jax.random.PRNGKey(0)}, *inputs,
                           deterministic=True)["params"]
    flat = torch_convert.convert_mart_model_state(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        family="mtrans")
    return torch_convert.apply_converted(template, flat)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, inputs) at dropout 0: the
    port's seeded weights converted into JAX's."""
    jmodel = jcreate(JConfig(caption_config_dict(NO_DROPOUT)), VOCAB,
                     verbose=False)
    cfg = MartConfig(caption_config_dict(NO_DROPOUT))
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=3)
    with torch.no_grad():  # larger logits than the init: varied decodes
        model.decoder.out.weight.mul_(3.0)
    inputs = _inputs(cfg)
    return jmodel, _jax_params(model, jmodel, inputs), model, inputs


def _copy(model):
    cfg = MartConfig(caption_config_dict(NO_DROPOUT))
    other = create_mart_model(cfg, VOCAB, torch.device("cpu"))
    other.load_state_dict(model.state_dict())
    return other


def _state(model, **overrides):
    cfg = MartConfig(caption_config_dict({**NO_DROPOUT, **overrides}))
    return init_caption_train_state(model, cfg, 0)


def _batch(inputs):
    return dict(zip(KEYS, (torch.from_numpy(np.asarray(a)) for a in inputs)))


def _by_torch_name(tree):
    return jax_mtrans_params_to_state_dict(jax.device_get(tree))


# ---------- building blocks ----------

@pytest.mark.parametrize("shape", [(3, 1152), (22, 768), (7, 33)])
def test_positional_encodings_equal_jax(shape):
    x = np.zeros((2,) + shape, np.float32)
    ours = mt.positional_encodings_like(torch.from_numpy(x))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jmt.positional_encodings_like(
            jnp.asarray(x))))


def test_layernorm_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 6, 40) * 3 + 1).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(40)).astype(np.float32)
    beta = (0.1 * rng.randn(40)).astype(np.float32)
    ref = jmt.MTLayerNorm(40).apply(
        {"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x))
    ln = mt.MTLayerNorm(40)
    with torch.no_grad():
        ln.gamma.copy_(torch.from_numpy(gamma))
        ln.beta.copy_(torch.from_numpy(beta))
        ours = ln(torch.from_numpy(x))
    assert _rel(ref, ours.numpy()) <= 1e-5
    # not nn.LayerNorm: eps on the std with ddof 1
    plain = torch.nn.functional.layer_norm(torch.from_numpy(x), (40,))
    assert _rel(ref, plain.numpy()) > 1e-3


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "cross"])
def test_multihead_matches_jax(causal):
    rng = np.random.RandomState(2)
    d, heads = 32, 4
    q = rng.randn(3, 7, d).astype(np.float32)
    kv = q if causal else rng.randn(3, 4, d).astype(np.float32)
    jlayer = jmt.MTMultiHead(d, heads, 0.0, causal=causal)
    params = jlayer.init(jax.random.PRNGKey(5), q, kv, kv)["params"]
    ref = jlayer.apply({"params": params}, q, kv, kv)
    layer = mt.MTMultiHead(d, heads, 0.0, causal=causal).eval()
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(layer, name).weight.copy_(torch.from_numpy(
                np.asarray(params[name]["kernel"]).T.copy()))
        ours = layer(*(torch.from_numpy(a) for a in (q, kv, kv)))
    assert _rel(ref, ours.numpy()) <= 1e-5


# ---------- bridge, forward, gradients ----------

def test_bridge_round_trip_and_paths(pair):
    """Port state dict -> JAX (the JAX package's converter, strict) ->
    back: unchanged; each parameter's JAX path is the one the converter
    gives its key."""
    _, params, model, _ = pair
    back = _by_torch_name(params)
    ours = {k: v.numpy() for k, v in model.state_dict().items()}
    assert back.keys() == ours.keys()
    for key, value in ours.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    paths = mtrans_jax_paths(model)
    flat = flatten(jax.device_get(params))
    expect = {next(iter(jax_mtrans_params_to_state_dict({p: v}))):
              "/".join(p) for p, v in flat.items()}
    assert paths == expect
    assert paths["decoder.layers.1.attention.layernorm.gamma"] == \
        "dec_layer_1/res_cross/layernorm/gamma"
    assert paths["encoder.layers.0.selfattn.layernorm.beta"] == \
        "enc_layer_0/res_attn/layernorm/beta"


def test_forward_matches_jax(pair):
    jmodel, params, model, inputs = pair
    jloss, jscores = jmodel.apply({"params": params}, *inputs,
                                  deterministic=True)
    with torch.no_grad():
        loss, scores = model.eval()(*_batch(inputs).values())
    assert _rel(jscores, scores.numpy()) <= 1e-5
    assert _rel(jloss, loss.numpy()) <= 1e-5
    # the eval step: loss and counts of the same forward
    jeval = make_caption_eval_step_single(jmodel, untied=True)
    ref = jeval(params, {k: jnp.asarray(v) for k, v in zip(KEYS, inputs)})
    ours = caption_eval_step_single(model, _batch(inputs))
    assert _rel(ref["loss"], ours["loss"].numpy()) <= 1e-5
    for name in ("n_correct", "n_word"):
        assert float(ref[name]) == float(ours[name])
    assert float(ours["n_word"]) > 0


def test_grads_match_jax(pair):
    jmodel, params, model, inputs = pair

    def loss_fn(p):
        return jmodel.apply({"params": p}, *inputs, deterministic=True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    metrics, grads = caption_loss_and_grads(_state(_copy(model)),
                                            _batch(inputs), single=True)
    assert _rel(jloss, metrics["loss"].numpy()) <= 1e-5
    ref = _by_torch_name(jgrads)
    assert set(ref) == set(grads)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        err = np.abs(g.numpy() - ref[name]).max() / scale
        assert err <= 1e-4, (name, err)
    # the tied output matrix gets both uses' gradient
    assert grads["decoder.out.weight"].abs().max() > 0


def _random_tree(params, seed):
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.randn(*leaf.shape).astype(np.float32))
        for leaf in leaves])


def test_masks_match_jax(pair):
    """A BertAdam step with zero gradients from non-zero weights moves
    exactly the parameters JAX's name rule decays."""
    _, params, model, _ = pair
    model = _copy(model)
    nonzero = _random_tree(params, 11)
    load_mart_checkpoint(model, {"model": _by_torch_name(nonzero)})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = _state(model, use_glove=True, freeze_glove=True)
    assert not state.optimizer.frozen  # no word-embedding table
    state.optimizer.step({n: torch.zeros_like(p)
                          for n, p in before.items()}, LR)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    jopt = joptim.make_bertadam(frozen_names=("word_embeddings",))
    jparams, _ = jopt.update(jax.tree.map(jnp.zeros_like, nonzero),
                             jopt.init(nonzero), nonzero, jnp.float32(LR))
    ref = _by_torch_name(jparams)
    jmoved = {n for n, v in _by_torch_name(nonzero).items()
              if not np.array_equal(v, ref[n])}
    assert moved == jmoved
    assert "encoder.layers.0.selfattn.layernorm.gamma" in moved
    assert "encoder.video_embeddings.0.beta" in moved
    for name in ("decoder.out.bias", "encoder.video_embeddings.2.bias",
                 "decoder.layers.1.feedforward.layer.linear1.bias"):
        assert name not in moved


def test_train_steps_match_jax(pair):
    """3 steps from the same weights, dropout 0, lr 1e-3."""
    jmodel, params, model, inputs = pair
    model = _copy(model)
    state = _state(model)
    jopt = joptim.make_bertadam(eps=1e-6)
    jstep = make_caption_train_step_single(jmodel, jopt, ema_decay=0.9999,
                                           untied=True)
    jstate = JState(params, jopt.init(params), joptim.ema_init(params),
                    jnp.int32(0))
    jbatch = {k: jnp.asarray(v) for k, v in zip(KEYS, inputs)}
    batch = _batch(inputs)
    for step in range(3):
        jbefore = _by_torch_name(jstate.params)
        before = {n: p.detach().clone().numpy()
                  for n, p in model.named_parameters()}
        jstate, jm = jstep(jstate, jbatch, jnp.float32(LR),
                           jax.random.PRNGKey(step))
        m = caption_train_step_single(state, batch, LR)
        for name in ("loss", "grad_norm", "n_correct"):
            assert _rel(jm[name], m[name].numpy()) <= 1e-5, (step, name)
        assert float(jm["n_word"]) == float(m["n_word"]) > 0
        jafter = _by_torch_name(jstate.params)
        for name, p in model.named_parameters():
            err = np.abs((p.detach().numpy() - before[name])
                         - (jafter[name] - jbefore[name])).max()
            assert err <= 0.01 * LR, (step, name, err)
        ref = _by_torch_name(jstate.ema.shadow)
        for name, v in state.ema.shadow.items():
            err = np.abs(v.numpy() - ref[name]).max()
            assert err <= 0.01 * LR, (step, name, err)
    assert int(state.step) == int(jstate.step) == 3


def test_untied_greedy_matches_jax(pair):
    jmodel, params, model, inputs = pair
    jcfg = JConfig(caption_config_dict(NO_DROPOUT))
    jcfg.vocab_size = VOCAB
    ref = JTranslator(jmodel, lambda: params, jcfg) \
        .translate_batch_single_sentence_untied_greedy(*inputs[:4])
    cfg = MartConfig(caption_config_dict(NO_DROPOUT))
    translator = Translator(model, cfg)
    batch = _batch(inputs)
    ours = translator.translate_batch(batch)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == 4).all()  # [BOS] first
    assert len({tuple(r) for r in ours[:, 1:].tolist()}) > 1
    assert translator.forwards == cfg.max_t_len + 1


# ---------- data and CLI ----------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_mtrans")
    info = generate_caption_dataset(root / "data", num_videos=10,
                                    num_val_videos=6, seed=2)
    return root, info


def test_untied_collation_matches_jax(synth):
    """Single sentences, COOT vidclip rows (row 0 valid), a short last
    batch padded to N with IGNORE-labelled dummies: every array equal."""
    _, info = synth
    kwargs = dict(recurrent=False, untied=True,
                  coot_model_name=info["coot_model_name"],
                  coot_dim_vid=info["coot_dim_vid"],
                  coot_dim_clip=info["coot_dim_clip"],
                  annotations_dir=info["annotations_dir"],
                  coot_feat_dir=info["coot_feat_dir"])
    ours = RecursiveCaptionDataset("youcook2", 10, 3, 4, "val", **kwargs)
    ref = JDataset("youcook2", 10, 3, 4, "val", **kwargs)
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
        assert a["video_feature"].shape == (8, 3, 96)
        np.testing.assert_array_equal(a["video_mask"][:, 1:], 0)
    assert (a["text_labels"][len(idx):] == -1).all()  # padded dummies


def test_glove_warns_and_keeps_init(caplog):
    cfg = MartConfig(caption_config_dict(MTRANS))
    base = build_mart_model_manager(cfg, 992, torch.device("cpu"), seed=4,
                                    cache_dir=str(ROOT / "cache_caption"))
    with caplog.at_level(logging.WARNING):
        glove = build_mart_model_manager(
            MartConfig(caption_config_dict({**MTRANS, "use_glove": True})),
            992, torch.device("cpu"), seed=4,
            cache_dir=str(ROOT / "cache_caption"))
    assert "no word-embedding table" in caplog.text
    a, b = base.model.state_dict(), glove.model.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


SMOKE = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"
RUN = Path("caption") / "default" / "synthetic_smoke_run1"
SPECIALS = ("[VID]", "[CLS]", "[SEP]", "[BOS]", "[PAD]")


def _argv(info, log_dir, *extra):
    return ["-c", str(SMOKE), "--log_dir", str(log_dir),
            "--annotations_dir", info["annotations_dir"],
            "--coot_feat_dir", info["coot_feat_dir"], *extra]


def test_cli_trains_and_validates(synth):
    root, info = synth
    result = train_caption.main(_argv(
        info, root / "train", "--device", "cpu", "-o",
        "recurrent=false,mtrans=true,train.num_epochs=1"))[0]
    assert result["model_device"].type == "cpu"
    assert result["train_unit"] == "sentences"
    assert result["epochs"] == [0] and result["total_step"] >= 3
    run = root / "train" / RUN
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


def test_cli_validate_matches_jax_trainer(synth, monkeypatch):
    """One `.pth` of the port's MTransformer validated by both CLIs
    (`-o ema_decay=0`: the JAX CLI's `--load_model` needs it)."""
    root, info = synth
    config = load_yaml_config_file(SMOKE)
    config.update(MTRANS)
    model = create_mart_model(MartConfig(config), info["vocab_size"],
                              torch.device("cpu"), seed=7)
    with torch.no_grad():
        model.decoder.out.weight.mul_(3.0)
    pth = root / "mtrans.pth"
    torch.save({"model": model.state_dict()}, pth)
    flags = ["--validate", "--load_model", str(pth), "-o",
             "recurrent=false,mtrans=true,ema_decay=0"]
    result = train_caption.main(_argv(info, root / "port", *flags,
                                      "--device", "cpu"))[0]
    assert all(f == 13 for f in result["forwards"])
    monkeypatch.syspath_prepend(str(ROOT))
    import train_caption as jax_cli
    monkeypatch.setattr(sys, "argv", ["train_caption.py"] + _argv(
        info, root / "jax", *flags))
    jax_cli.main()
    translations = RUN / "caption" / "translations_0_val.json"
    ref = json.loads((root / "jax" / translations).read_text())
    ours = json.loads(result["translation_file"].read_text())
    assert ours == ref
    ref_metrics = json.loads((root / "jax" / RUN / "val_ep_0.json")
                             .read_text())
    ours_metrics = json.loads(result["metrics_file"].read_text())
    (_, r), = ref_metrics["val/loss_word"]
    (_, o), = ours_metrics["val/loss_word"]
    assert o == pytest.approx(r, rel=1e-5)
