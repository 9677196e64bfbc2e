"""
The cached greedy decode of recurrent MART against the full forward_step
on the CPU, float32, at the test width (hidden 32, 4 heads, 2 layers,
max_v_len 3 with a padded video row, max_t_len 10, S = 3, vocabulary 50:
tests/test_torch_caption_variants.configs and make_inputs), the matrices
scaled up so the decodes vary and [EOS] favoured so that some rows end
their sentence early and others run to the end:

- at every position of every sentence, RecursiveTransformer.decode_token's
  scores equal forward_step's row there within 1e-5 of the row's largest
  |score|, both fed the same tokens, and pick the same next token; over the
  first sentence's memory (built from the video rows) and two carried
  memories;
- next_memories (forward_step without its head) equals forward_step's
  memories after the [EOS] masking;
- Translator's tokens equal the full-forward decode's, through the
  programs and eagerly, with forwards, replays and host reads as before;
- Translator.cached_tokens is S x max_t_len for MART greedy and 0 for
  every other decode.
"""

import numpy as np
import pytest
import torch

from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.translator import (
    Translator, _best_words, mask_tokens_after_eos,
    prepare_video_only_inputs, runs_cached)
from coot_videotext_tpu_torch.utils.graphs import cache_of
from tests.helpers import caption_config_dict
from tests.test_torch_caption_mtrans import (
    NO_DROPOUT as MTRANS_NO_DROPOUT, _inputs as mtrans_inputs)
from tests.test_torch_caption_variants import (
    S, VOCAB, batch_of, configs, make_inputs)

torch.set_num_threads(1)

BOS, EOS = 4, 5
# on [EOS]'s score: sentence 0 ends rows 0 and 1 at positions 8 and 7,
# sentence 1 rows 0, 1 and 3 at 1, 6 and 8; the rest run to the end
EOS_BIAS = 0.5
ROW_TOL = 1e-5


def _model(variant: str = "mart", eos_bias: float = EOS_BIAS):
    _, cfg = configs(variant)
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(3.0)
        if variant == "mart":
            model.decoder.bias[EOS] += eos_bias
    return model.eval(), cfg


@pytest.fixture(scope="module")
def mart():
    model, cfg = _model()
    return model, cfg, batch_of("mart", make_inputs("mart", cfg))


def _side_by_side(model, cfg, batch):
    """The greedy decode with one full forward_step a token, the cached
    step run beside it on the same tokens. Returns the tokens [(N, L)] *
    S, the worst row gap over the row's largest |score|, the positions
    where the two picked different tokens, the worst memory gap, and how
    many rows the [EOS] masking changed."""
    lo, hi = cfg.max_v_len, cfg.max_v_len + cfg.max_t_len
    ids_st, masks_st = prepare_video_only_inputs(
        batch["input_ids"], batch["input_mask"], batch["token_type_ids"])
    prev = [None] * cfg.num_hidden_layers
    tokens, worst, picks, mem_gap, masked = [], 0.0, [], 0.0, 0
    with torch.inference_mode():
        for s in range(len(ids_st)):
            feats = batch["video_feature"][s]
            ttypes = batch["token_type_ids"][s]
            ids, masks = ids_st[s].clone(), masks_st[s].clone()
            state = model.decode_prefix(prev, ids, feats, masks, ttypes)
            words = torch.full_like(ids[:, 0], BOS)
            for dec_idx in range(lo, hi):
                ids[:, dec_idx] = words
                masks[:, dec_idx] = 1
                full = model.forward_step(prev, ids, feats, masks,
                                          ttypes)[2][:, dec_idx]
                cached = model.decode_token(state, ids[:, dec_idx], dec_idx)
                gap = (cached - full).abs().amax(1) / full.abs().amax(1)
                worst = max(worst, float(gap.max()))
                words = _best_words(full)
                if not torch.equal(_best_words(cached), words):
                    picks.append((s, dec_idx))
            eos_ids, eos_masks = mask_tokens_after_eos(ids, masks)
            masked += int((eos_masks != masks).any(1).sum())
            full_ms = model.forward_step(prev, eos_ids, feats, eos_masks,
                                         ttypes)[0]
            cached_ms = model.next_memories(prev, eos_ids, feats, eos_masks,
                                            ttypes)
            for a, b in zip(full_ms, cached_ms):
                mem_gap = max(mem_gap, float((a - b).abs().max()
                                             / a.abs().max()))
            prev = full_ms
            tokens.append(eos_ids[:, lo:].numpy())
    return tokens, worst, picks, mem_gap, masked


def test_cached_rows_equal_the_full_forward(mart):
    """Every position of three sentences: the first sentence's memory
    from the video rows, then two memories carried, built from sentences
    that [EOS] ended early in some rows."""
    model, cfg, batch = mart
    tokens, worst, picks, mem_gap, masked = _side_by_side(model, cfg, batch)
    assert worst <= ROW_TOL, worst
    assert picks == []
    assert mem_gap <= ROW_TOL, mem_gap
    # [EOS] mid-sentence in some rows changes the memory forward's input,
    # and other rows decode to the end
    assert masked >= 3
    ends = np.stack(tokens) == EOS
    assert (~ends.any(-1)).any()
    assert len(np.unique(np.stack(tokens))) > 3


@pytest.mark.parametrize("eager", [False, True], ids=["programs", "eager"])
def test_cached_translator_tokens_equal_the_full_decode(mart, eager):
    """The translator's cached sentence body, through one program a
    sentence and op by op: tokens, counters and program keys."""
    model, cfg, batch = mart
    ref = _side_by_side(model, cfg, batch)[0]
    assert runs_cached(model)
    translator = Translator(model, cfg, eager=eager)
    ours = translator.translate_batch(batch)
    np.testing.assert_array_equal(np.stack(ours), np.stack(ref))
    assert translator.cached_tokens == S * cfg.max_t_len
    assert translator.forwards == S * (cfg.max_t_len + 1)
    assert translator.host_reads == 1
    assert translator.replays == (0 if eager else S)
    if not eager:
        greedy = {key[1:3] for key in cache_of(model).programs
                  if key[0] == "greedy"}
        assert greedy == {(True, True), (False, True)}


def _mtrans():
    cfg = MartConfig(caption_config_dict(MTRANS_NO_DROPOUT))
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=3)
    feats, vmask, ids, tmask, _ = mtrans_inputs(cfg)
    batch = {"video_feature": feats, "video_mask": vmask, "text_ids": ids,
             "text_mask": tmask}
    return model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("variant", ["xl", "joint", "untied", "tied",
                                     "mtrans", "beam", "beam_compat"])
def test_cached_tokens_count_only_mart_greedy(variant):
    """The other decodes keep the full forward a token and count no
    cached token; the tied decoder is recurrent MART and takes the
    caches."""
    if variant == "mtrans":
        model, cfg, batch = _mtrans()
    else:
        name = "mart" if variant.startswith("beam") else variant
        model, cfg = _model(name)
        batch = batch_of(name, make_inputs(name, cfg))
    translator = Translator(model, cfg, eager=True)
    if variant.startswith("beam"):
        translator.translate_batch_beam(
            *(batch[k] for k in ("input_ids", "video_feature", "input_mask",
                                 "token_type_ids")),
            reference_compat=variant == "beam_compat")
    else:
        translator.translate_batch(batch)
    assert translator.forwards > 0
    if variant == "tied":
        assert translator.cached_tokens == S * cfg.max_t_len
    else:
        assert translator.cached_tokens == 0
        assert not runs_cached(model) or variant.startswith("beam")


def test_cached_tokens_reset_by_the_next_decode(mart):
    """A beam decode after a cached greedy one reads 0."""
    model, cfg, batch = mart
    translator = Translator(model, cfg, eager=True)
    translator.translate_batch(batch)
    assert translator.cached_tokens == S * cfg.max_t_len
    translator.translate_batch_beam(
        *(batch[k] for k in ("input_ids", "video_feature", "input_mask",
                             "token_type_ids")))
    assert translator.cached_tokens == 0
