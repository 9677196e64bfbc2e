"""
The port's TransformerXL caption train step against the benchmark's plain
float32 reference (`portbench/reference/xl.py`, which imports nothing of
the port) on the CPU, at hidden 64, 4 heads, 2 layers, max_v_len 8 +
max_t_len 6, S = 3 sentence steps of 24-d raw features, batch 3, seeded
weights and dropout on at every site (both sides draw each mask from the
same seed through Philox):

- rel_shift, the position table and make_mask;
- the loss and every gradient of one step;
- the parameters, the first moments and the EMA shadow after 3 BertAdam
  steps;
- the relative attention's phase marks (ops/phase.py `Bracket`, identities
  under autograd) leave the loss and every gradient bit-equal.

Tolerances: both sides run the same float32 operations in another order
(the port's einsums and fused linear layers against the reference's
matmuls), so each value agrees to float32 round-off of its sum: the loss
to 1e-5 relative, each gradient to 1e-4 of its leaf's largest magnitude
(the softmax and LayerNorm backward sum hundreds of terms), the
parameters and the shadow after three steps to 1e-6 absolute (they move
by ~1e-2 from values of 0.02 to 1, whose float32 spacing is 1.2e-7 at
most; read 1.2e-7).
"""

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from coot_videotext_tpu_torch.models.caption import xl
from coot_videotext_tpu_torch.ops import phase
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_loss_and_grads, caption_train_step, init_caption_train_state)
from portbench.reference import mart as ref_mart
from portbench.reference import philox as ref_philox
from portbench.reference import xl as ref

# tests/helpers.py by its path: the card's machine may have another
# top-level `tests` package installed
_spec = importlib.util.spec_from_file_location(
    "coot_test_helpers", Path(__file__).with_name("helpers.py"))
helpers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(helpers)

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB, S, N, V_LEN, T_LEN, FEAT = 40, 3, 3, 8, 6, 24
SEED = 2 ** 31 + 77
LR = 1e-3


def _cfg_dict():
    d = helpers.caption_config_dict({})
    d.update(recurrent=True, xl=True, xl_grad=False, max_v_len=V_LEN,
             max_t_len=T_LEN, hidden_size=64, intermediate_size=64,
             num_attention_heads=4, num_hidden_layers=2,
             video_feature_size=FEAT, word_vec_size=16,
             coot_model_name=None, label_smoothing=0.1, use_glove=False,
             hidden_dropout_prob=0.1, ema_decay=0.9999)
    return d


def _batch():
    """S stacked steps: video rows of varied length (3-6 of the 6 rows
    between [CLS] and [SEP]), texts of varied length, labels shifted."""
    rng = np.random.RandomState(5)
    length = V_LEN + T_LEN
    ids = np.zeros((S, N, length), np.int64)
    mask = np.zeros((S, N, length), np.float32)
    labels = np.full((S, N, length), -1, np.int64)
    feats = np.zeros((S, N, length, FEAT), np.float32)
    for s in range(S):
        for n in range(N):
            rows = rng.randint(3, V_LEN - 1)
            ids[s, n, :rows + 2] = [1] + [3] * rows + [2]
            mask[s, n, :rows + 2] = 1
            feats[s, n, 1:rows + 1] = rng.randn(rows, FEAT)
            words = rng.randint(3, T_LEN + 1)
            text = [4] + list(rng.randint(7, VOCAB, words - 2)) + [5]
            ids[s, n, V_LEN:V_LEN + words] = text
            mask[s, n, V_LEN:V_LEN + words] = 1
            labels[s, n, V_LEN:V_LEN + words - 1] = text[1:]
    types = np.zeros((S, N, length), np.int64)
    types[:, :, V_LEN:] = 1
    return {"input_ids": torch.from_numpy(ids),
            "video_feature": torch.from_numpy(feats),
            "input_mask": torch.from_numpy(mask),
            "token_type_ids": torch.from_numpy(types),
            "input_labels": torch.from_numpy(labels)}


@pytest.fixture(scope="module")
def setup():
    d = _cfg_dict()
    model = create_mart_model(MartConfig(copy.deepcopy(d)), VOCAB, CPU,
                              seed=11)
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    return dict(d, vocab_size=VOCAB), model, weights, _batch()


def _fresh(setup):
    d, model, weights, batch = setup
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    mc = MartConfig({k: copy.deepcopy(v) for k, v in d.items()
                     if k != "vocab_size"})
    return init_caption_train_state(model, mc, SEED)


def _close(a, b, scale_tol):
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) <= scale_tol * scale


@pytest.mark.parametrize("q,k", [(3, 5), (5, 10), (4, 4), (7, 2)])
def test_the_reference_rel_shift_is_the_ports(q, k):
    x = torch.randn(2, 3, q, k, generator=torch.Generator().manual_seed(q))
    assert torch.equal(ref.rel_shift(x), xl.rel_shift(x))


@pytest.mark.parametrize("klen", [14, 28])
def test_the_reference_position_table_is_the_ports(klen):
    """1e-5: the reference code takes the frequencies in float32, the port
    in float64 rounded to float32; a position up to 27 times a frequency
    1 ulp apart moves the angle by 27 x 6e-8."""
    pos = torch.arange(klen - 1, -1, -1.0)
    torch.testing.assert_close(ref.positions(klen, 64, CPU),
                               xl.positional_embedding_xl(pos, 64),
                               rtol=0, atol=1e-5)


def test_the_reference_mask_is_the_ports(setup):
    _, model, _, batch = setup
    masks = batch["input_mask"]
    for prev in (None, masks[0]):
        port = model.make_mask(masks[1], prev) > 0.5
        assert torch.equal(ref.make_mask(masks[1], prev, V_LEN, T_LEN),
                           port)


def test_loss_and_every_gradient_match_the_reference(setup):
    d, _, weights, batch = setup
    state = _fresh(setup)
    metrics, grads = caption_loss_and_grads(state, batch)
    loss, ref_grads = ref.train_step(
        weights, d, batch, ref_philox.seed_state(SEED, CPU))
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    assert set(grads) == set(ref_grads)
    bad = [n for n in grads if not _close(grads[n], ref_grads[n], 1e-4)]
    assert not bad, bad
    # every weight the loss reaches gets a gradient on both sides
    assert all(float(ref_grads[n].abs().max()) > 0 for n in ref_grads)


def test_three_bertadam_steps_and_the_ema_match_the_reference(setup):
    d, _, weights, batch = setup
    state = _fresh(setup)
    for _ in range(3):
        caption_train_step(state, batch, LR, eager=True)
    params, shadow = dict(weights), dict(weights)
    moments = {"m": {}, "v": {}}
    for step in range(3):
        _, grads = ref.train_step(params, d, batch,
                                  ref_philox.seed_state(SEED + step, CPU))
        params, moments = ref.xl_adam(params, grads, moments, LR,
                                      state.optimizer.eps)
        shadow = ref_mart.ema(shadow, params, step, float(d["ema_decay"]))
    for n, p in state.optimizer.params.items():
        assert float((p.detach() - params[n]).abs().max()) <= 1e-6, n
        assert _close(state.optimizer.mu[n], moments["m"][n], 1e-4), n
        assert float((state.ema.shadow[n] - shadow[n]).abs().max()) \
            <= 1e-6, n


def test_the_relattn_marks_leave_every_gradient_bit_equal(setup,
                                                          monkeypatch):
    d, _, weights, batch = setup
    metrics, grads = caption_loss_and_grads(_fresh(setup), batch)
    calls = []
    real = phase.Bracket.apply

    def counted(*args):
        calls.append(args[1:])
        return real(*args)
    monkeypatch.setattr(phase.Bracket, "apply", counted)
    again, grads_again = caption_loss_and_grads(_fresh(setup), batch)
    # two brackets an attention, one attention a layer and a step
    assert calls == [("relattn", "relattn_end"),
                     ("relattn_end", "relattn")] * 2 * S
    monkeypatch.setattr(phase.Bracket, "apply", lambda x, *marks: x)
    bare, grads_bare = caption_loss_and_grads(_fresh(setup), batch)
    for m in (again, bare):
        assert torch.equal(metrics["loss"], m["loss"])
    for g in (grads_again, grads_bare):
        assert all(torch.equal(grads[n], g[n]) for n in grads)


def test_bracket_passes_values_and_gradients_through():
    x = torch.randn(4, 5, requires_grad=True)
    y = phase.Bracket.apply(x, "relattn", "relattn_end")
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * 3).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))
    with torch.inference_mode():
        z = torch.randn(4, 5)
        assert torch.equal(phase.Bracket.apply(z, "relattn", "relattn_end"),
                           z)


# ---------------- on the card: the marks in a replayed step ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the phase marks are CUDA "
                    "kernels; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replayed_xl_step_brackets_each_attention_both_ways(cuda):
    """The captured XL train step draws the four phase marks and, inside
    the forward and again inside the backward, one relattn / relattn_end
    pair an attention (2 layers x S steps)."""
    from torch.profiler import ProfilerActivity, profile
    d = _cfg_dict()
    mc = MartConfig(copy.deepcopy(d))
    state = init_caption_train_state(
        create_mart_model(mc, VOCAB, cuda, seed=11), mc, SEED)
    batch = {k: v.to(cuda) for k, v in _batch().items()}
    caption_train_step(state, batch, LR)  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        caption_train_step(state, batch, LR)
        torch.cuda.synchronize()
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and phase.KERNEL_PREFIX in e.name)
    names = [next(m for m in sorted(phase.MARKS, key=len, reverse=True)
                  if phase.KERNEL_PREFIX + m in name) for _, name in marks]
    pairs = ["relattn", "relattn_end"] * 2 * S
    assert names == (["forward"] + pairs + ["backward"] + pairs
                     + ["optimizer", "end"])
