"""
The port's recurrent MART model against the JAX package on the CPU, on the
same numpy inputs and bridged weights (hidden 32, 4 heads, 2 layers, S = 3,
tests/helpers.caption_config_dict):

- the three mask functions: exact;
- the losses and token_accuracy_counts: 1e-6 relative;
- RecursiveTransformer's scores and memories over S steps, f32: 1e-5
  relative to max|x|;
- the eval step: 1e-5 relative;
- greedy decoding: token-identical to JAX's Translator.translate_batch_greedy;
- the weight bridge: the port's state_dict() through the JAX package's
  convert_mart_model_state / apply_converted (strict) and back through
  jax_mart_params_to_state_dict is unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.models.caption import bert as jbert
from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import make_caption_eval_step
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator, mask_tokens_after_eos as jmask_after_eos)
from coot_videotext_tpu.train import loss_caption as jloss
from coot_videotext_tpu.utils import torch_convert
from coot_videotext_tpu_torch.models.caption import bert
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import caption_eval_step
from coot_videotext_tpu_torch.tasks.caption.translator import (
    Translator, mask_tokens_after_eos)
from coot_videotext_tpu_torch.train import loss_caption
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mart_params_to_state_dict, load_mart_checkpoint)
from tests.helpers import caption_config_dict

torch.set_num_threads(1)

VOCAB = 50
S, N = 3, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _inputs(cfg, seed=0):
    """Stacked (S, N, L) joint sequences: some padded video and text."""
    rng = np.random.RandomState(seed)
    length = cfg.max_v_len + cfg.max_t_len
    ids = rng.randint(7, VOCAB, (S, N, length)).astype(np.int64)
    feats = rng.randn(S, N, length,
                      cfg.video_feature_size).astype(np.float32)
    masks = np.ones((S, N, length), np.float32)
    masks[:, 0, cfg.max_v_len - 1] = 0
    masks[:, 1, -4:] = 0
    masks[1, 2, cfg.max_v_len + 2:] = 0
    ttys = np.concatenate([np.zeros((S, N, cfg.max_v_len)),
                           np.ones((S, N, cfg.max_t_len))],
                          -1).astype(np.int64)
    labels = np.where(rng.rand(S, N, length) < 0.3, -1,
                      rng.randint(0, VOCAB, (S, N, length)))
    labels[:, :, :cfg.max_v_len] = -1
    return ids, feats, masks, ttys, labels.astype(np.int64)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, JAX cfg, port model, port cfg, inputs):
    JAX-initialized weights bridged into the port's model."""
    jcfg = JConfig(caption_config_dict({}))
    cfg = MartConfig(caption_config_dict({}))
    jmodel = jcreate(jcfg, VOCAB, verbose=False)
    model = create_mart_model(cfg, VOCAB, torch.device("cpu")).eval()
    inputs = _inputs(cfg)
    params = jmodel.init({"params": jax.random.PRNGKey(1)}, *inputs,
                         deterministic=True)["params"]
    load_mart_checkpoint(model, {"model": jax_mart_params_to_state_dict(
        params)})
    return jmodel, params, jcfg, model, cfg, inputs


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mask_fn", ["shifted", "pad_shifted", "video_only"])
def test_masks_match_jax(mask_fn):
    rng = np.random.RandomState(3)
    max_v, max_t, mem = 3, 5, 2
    mask = (rng.rand(4, max_v + max_t + mem) < 0.7).astype(np.float32)
    if mask_fn == "video_only":
        ours = bert.make_video_only_mask(torch.from_numpy(mask), max_v)
        ref = jbert.make_video_only_mask(jnp.asarray(mask), max_v)
    else:
        fn = {"shifted": "make_shifted_mask",
              "pad_shifted": "make_pad_shifted_mask"}[mask_fn]
        ours = getattr(bert, fn)(torch.from_numpy(mask), max_v, max_t,
                                 memory_len=mem)
        ref = getattr(jbert, fn)(jnp.asarray(mask), max_v, max_t,
                                 memory_len=mem)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("loss", ["label_smoothing", "cross_entropy",
                                  "token_accuracy"])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 7, VOCAB) * 3).astype(np.float32)
    labels = rng.randint(0, VOCAB, (3, 7))
    labels[rng.rand(3, 7) < 0.3] = -1
    # make some predictions right, so the counts are not all zero
    labels[0, :3] = logits[0, :3].argmax(-1)
    t_args = (torch.from_numpy(logits), torch.from_numpy(labels))
    j_args = (jnp.asarray(logits), jnp.asarray(labels))
    if loss == "label_smoothing":
        ours = [loss_caption.label_smoothing_loss(*t_args, 0.1, VOCAB)]
        ref = [jloss.label_smoothing_loss(*j_args, 0.1, VOCAB)]
    elif loss == "cross_entropy":
        ours = [loss_caption.cross_entropy_loss(*t_args)]
        ref = [jloss.cross_entropy_loss(*j_args)]
    else:
        ours = loss_caption.token_accuracy_counts(*t_args)
        ref = jloss.token_accuracy_counts(*j_args)
        assert float(ref[0]) > 0
    for o, r in zip(ours, ref):
        assert _rel(r, o.numpy()) <= 1e-6, (float(o), float(r))


def test_recursive_transformer_matches_jax(pair):
    """Scores and the per-layer memories of every step, and the loss."""
    jmodel, params, _, model, _, inputs = pair
    jloss_, jscores = jmodel.apply({"params": params}, *inputs,
                                   deterministic=True)
    jmem = jmodel.apply({"params": params}, *inputs, deterministic=True,
                        return_memory=True)
    with torch.no_grad():
        loss, scores = model(*_t(inputs))
        mem = model(*_t(inputs), return_memory=True)
    assert _rel(jloss_, loss.numpy()) <= 1e-5
    assert len(scores) == len(mem) == S
    for step in range(S):
        assert _rel(jscores[step], scores[step].numpy()) <= 1e-5, step
        for layer in range(len(mem[step])):
            assert _rel(jmem[step][layer],
                        mem[step][layer].numpy()) <= 1e-5, (step, layer)


def test_eval_step_matches_jax(pair):
    jmodel, params, _, model, _, inputs = pair
    keys = ("input_ids", "video_feature", "input_mask", "token_type_ids",
            "input_labels")
    batch = dict(zip(keys, inputs))
    ref = make_caption_eval_step(jmodel)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = caption_eval_step(model, dict(zip(keys, _t(inputs))))
    for name in ("loss", "n_correct", "n_word"):
        assert _rel(ref[name], ours[name].numpy()) <= 1e-5, name
    assert float(ref["n_word"]) > 0


def test_greedy_tokens_match_jax(pair):
    """Recurrent greedy decoding, token for token, over S sentences
    (memory carried between them), as tests/test_translator_parity.py
    holds JAX against the reference."""
    jmodel, params, jcfg, model, cfg, inputs = pair
    ids, feats, masks, ttys, _ = inputs
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch_greedy(
        ids, feats, masks, ttys)
    translator = Translator(model, cfg)
    ours = translator.translate_batch_greedy(*_t((ids, feats, masks, ttys)))
    assert translator.forwards == S * (cfg.max_t_len + 1)
    assert len(ours) == len(ref) == S
    for step in range(S):
        np.testing.assert_array_equal(ours[step], np.asarray(ref[step]),
                                      err_msg=f"sentence step {step}")
    # the decode is not degenerate: it writes more than one token
    assert len(np.unique(np.stack(ours))) > 2


def test_mask_tokens_after_eos_matches_jax():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 8, (6, 9))
    ids[0] = 3  # no EOS in this row
    masks = np.ones((6, 9), np.float32)
    ours = mask_tokens_after_eos(torch.from_numpy(ids),
                                 torch.from_numpy(masks))
    ref = jmask_after_eos(jnp.asarray(ids), jnp.asarray(masks))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_weight_bridge_round_trip(pair):
    """Port state_dict -> JAX params (strict) -> port state_dict."""
    _, params, _, model, _, _ = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    flat = torch_convert.convert_mart_model_state(sd, family="mart")
    jparams = torch_convert.apply_converted(params, flat)
    back = jax_mart_params_to_state_dict(jparams)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # a reference checkpoint's non-parameter entries are dropped on load
    extra = dict(back, **{
        "embeddings.position_embeddings.pe": np.zeros((1, 3)),
        "encoder.layer.0.memory_intermediate.dense.weight": np.zeros(2)})
    load_mart_checkpoint(model, {"model": extra})
    with pytest.raises(RuntimeError, match="Missing key"):
        load_mart_checkpoint(model, {"model": {
            k: v for k, v in back.items() if k != "decoder.bias"}})
