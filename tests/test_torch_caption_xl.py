"""
The port's TransformerXL caption model (`xl: true`, and `xl_grad: true`)
against the JAX package on the CPU, on the same numpy inputs and bridged
weights (hidden 32, 4 heads, 2 layers, S = 3 sentences of max_v_len 3 +
max_t_len 10, vocabulary 50), through the harness of
tests/test_torch_caption_variants.py:

- rel_shift alone on non-square (Q, K): exact; positional_embedding_xl
  1e-6;
- the weight bridge (jax_xl_params_to_state_dict, xl_jax_paths) against
  the JAX package's convert_mart_model_state (family xl) and
  apply_converted;
- the forward, the eval step, every gradient, BertAdam's masks, 3 train
  steps and the greedy decode (translate_batch_greedy_xl, the previous
  sentence's EOS-masked masks threaded) at the harness's tolerances;
- xl_grad: with the loss on the last sentence only, the gradient that
  reaches the weights through the previous sentences' memories matches
  JAX's and is absent without xl_grad;
- the loader refuses non-finite values, as apply_converted does;
- the CLI trains one epoch and validates on the CPU; `--validate
  --load_model` through both CLIs gives the same translations and val
  loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.models.caption import xl as jxl
from coot_videotext_tpu_torch.models.caption import xl
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.utils.param_bridge import (
    load_mart_checkpoint, state_dict_for_jax, xl_jax_paths)
from tests.test_torch_caption_variants import (
    VARIANTS, VOCAB, check_bridge, check_cli_matches_jax, check_cli_trains,
    check_forward, check_grads, check_greedy, check_masks,
    check_train_steps, configs, make_pair, make_synth)

torch.set_num_threads(1)

MINE = ("xl", "xl_grad")


@pytest.mark.parametrize("q,k", [(3, 5), (5, 10), (4, 4), (7, 2)])
def test_rel_shift_matches_jax(q, k):
    x = np.random.RandomState(q * k).randn(2, 3, q, k).astype(np.float32)
    np.testing.assert_array_equal(
        xl.rel_shift(torch.from_numpy(x)).numpy(),
        np.asarray(jxl.rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("klen", [13, 26])
def test_positional_embedding_matches_jax(klen):
    pos = np.arange(klen - 1, -1, -1.0, dtype=np.float32)
    ours = xl.positional_embedding_xl(torch.from_numpy(pos), 32).numpy()
    ref = np.asarray(jxl.positional_embedding_xl(jnp.asarray(pos), 32))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    # [sin | cos], not interleaved
    np.testing.assert_allclose(ours[:, :16], np.sin(
        pos[:, None] / 10000 ** (np.arange(0, 32, 2) / 32)), atol=1e-5)


@pytest.fixture(scope="module", params=MINE)
def pair(request):
    return request.param, make_pair(request.param)


def test_bridge_round_trip_and_paths(pair):
    variant, p = pair
    check_bridge(variant, p)
    paths = xl_jax_paths(p[3])
    assert paths["encoder.layers.1.pos_ff.CoreNet.3.weight"] == \
        "encoder/layer_1/pos_ff/fc2/kernel"
    assert paths["encoder.layers.0.dec_attn.layer_norm.weight"] == \
        "encoder/layer_0/dec_attn/layer_norm/scale"
    assert paths["encoder.r_w_bias"] == "encoder/r_w_bias"


def test_forward_matches_jax(pair):
    check_forward(*pair)


def test_grads_match_jax(pair):
    check_grads(*pair)


def test_masks_match_jax(pair):
    moved = check_masks(*pair)
    # r_w_bias and r_r_bias carry "bias" in their path: no decay
    assert "encoder.r_w_bias" not in moved
    assert "encoder.layers.0.dec_attn.qkv_net.weight" in moved


def test_train_steps_match_jax(pair):
    check_train_steps(*pair)


def test_greedy_matches_jax(pair):
    check_greedy(*pair)


def test_gradient_crosses_sentence_steps():
    """The loss of the last sentence only: under xl_grad its gradient
    reaches the weights through the earlier sentences' memories too (and
    matches JAX's); without xl_grad the memories are detached and the
    gradients differ."""
    grads = {}
    for variant in MINE:
        jmodel, params, jcfg, model, cfg, inputs = make_pair(variant)
        labels = inputs[4].copy()
        labels[:-1] = -1
        inputs = inputs[:4] + (labels,)
        grads[variant] = check_grads(
            variant, (jmodel, params, jcfg, model, cfg, inputs), inputs)
    diff = max(float((grads["xl"][n] - grads["xl_grad"][n]).abs().max())
               for n in grads["xl"])
    scale = max(float(g.abs().max()) for g in grads["xl_grad"].values())
    assert diff > 1e-3 * scale


def test_loader_refuses_non_finite():
    """A reference XL saved untrained holds uninitialized r_w_bias memory:
    refused, as the JAX package's apply_converted refuses it."""
    _, cfg = configs("xl")
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=1)
    sd = state_dict_for_jax(model)
    sd["encoder.r_w_bias"] = np.full_like(sd["encoder.r_w_bias"], np.nan)
    sd["encoder.pos_emb.inv_freq"] = np.ones(16, np.float32)  # dropped
    with pytest.raises(ValueError, match="non-finite.*r_w_bias"):
        load_mart_checkpoint(model, {"model": sd})
    sd["encoder.r_w_bias"] = np.zeros_like(sd["encoder.r_w_bias"])
    load_mart_checkpoint(model, {"model": sd})


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_xl_cli")
    return root, make_synth(root)


@pytest.mark.parametrize("variant", MINE)
def test_cli_trains_and_validates(synth, variant):
    check_cli_trains(variant, *synth)


def test_cli_validate_matches_jax_trainer(synth, monkeypatch):
    root, info = synth
    result = check_cli_matches_jax("xl", root, info, monkeypatch,
                                   VARIANTS["xl"])
    assert all(f > 0 and f % 13 == 0 for f in result["forwards"])
