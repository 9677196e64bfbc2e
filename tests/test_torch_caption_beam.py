"""
The port's beam search (`use_beam: true`, ROADMAP A10b) against the JAX
package on the CPU:

- BeamSearch alone (tasks/caption/beam_search.py, numpy in both
  packages): on the same random log-prob sequences, the predictions, the
  scores, select_indices, the alive sequences and the surviving batches
  equal JAX's at every step, with block_ngram_repeat 0 and 2, the length
  penalties none, wu and avg, min_length forcing and the max-length force
  finish;
- the recurrent beam decode of the MART model (hidden 32, 4 heads, 2
  layers, 3 videos of 3 sentences, beam 2, vocabulary 50, dropout 0):
  token-identical to JAX's Translator.translate_batch_beam in the fixed
  and the reference_compat mode; the per-token log-probabilities 1e-5
  apart at every position, so a token mismatch can be told from a
  numeric one;
- the CLI on config/caption/default/synthetic_smoke.yaml with `-o
  use_beam=true` (and beam_reference_compat=true) `--validate
  --load_model` through both CLIs (`ema_decay=0`): the same translations
  and val loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.tasks.caption import beam_search as jbeam
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator)
from coot_videotext_tpu_torch.tasks.caption import beam_search
from coot_videotext_tpu_torch.tasks.caption.translator import (
    Translator, prepare_video_only_inputs)
from tests.test_torch_caption_variants import (
    SMOKE, check_cli_matches_jax, make_pair, make_synth, to_jax)

torch.set_num_threads(1)

VOCAB = 50
EOS = 5
EOS_BIAS = 2.0


@pytest.mark.parametrize("case", [
    dict(block_ngram_repeat=0, length_penalty_name="none"),
    dict(block_ngram_repeat=0, length_penalty_name="wu",
         length_penalty_alpha=0.7),
    dict(block_ngram_repeat=0, length_penalty_name="avg"),
    dict(block_ngram_repeat=2, length_penalty_name="none"),
    dict(block_ngram_repeat=2, length_penalty_name="wu",
         length_penalty_alpha=0.7),
    dict(block_ngram_repeat=2, length_penalty_name="avg"),
    dict(block_ngram_repeat=0, length_penalty_name="none", min_length=6),
    dict(block_ngram_repeat=0, length_penalty_name="none", max_length=3),
], ids=["none", "wu", "avg", "ngram2-none", "ngram2-wu", "ngram2-avg",
        "min-length", "max-length"])
def test_beam_search_matches_jax(case):
    """Random log-probs (a vocabulary of 9, [EOS] more likely each step)
    through both BeamSearch objects step for step; a max length of 3
    finishes the open beams by force."""
    beam_size, batch_size, vocab = 3, 4, 9
    kwargs = dict(beam_size=beam_size, batch_size=batch_size, pad=0, bos=4,
                  eos=EOS, n_best=2, min_length=case.get("min_length", 1),
                  max_length=case.get("max_length", 12),
                  block_ngram_repeat=case["block_ngram_repeat"],
                  exclusion_tokens=set(),
                  length_penalty_name=case["length_penalty_name"],
                  length_penalty_alpha=case.get("length_penalty_alpha", 0.0))
    ours, ref = beam_search.BeamSearch(**kwargs), jbeam.BeamSearch(**kwargs)
    rng = np.random.RandomState(sum(map(ord, str(case))))
    for step in range(14):
        n = ref.alive_seq.shape[0]
        logits = rng.randn(n, vocab).astype(np.float32) * 2
        logits[:, EOS] += 0.5 + 0.3 * step
        lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        ours.advance(lp)
        ref.advance(lp)
        for name in ("topk_ids", "topk_scores", "select_indices",
                     "alive_seq", "is_finished", "topk_log_probs"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(ref, name),
                                          err_msg=f"{step} {name}")
        if ref.is_finished.any():
            a, b = ours.update_finished(), ref.update_finished()
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)
        assert ours.done == ref.done
        if ref.done:
            break
    assert ref.done, "every batch finishes (EOS grows likely, max length)"
    for b in range(batch_size):
        assert ours.scores[b] == ref.scores[b]
        assert len(ours.predictions[b]) == len(ref.predictions[b]) == 2
        for p, r in zip(ours.predictions[b], ref.predictions[b]):
            np.testing.assert_array_equal(p, r)
    if "max_length" in case:  # force-finished at 3 tokens
        lengths = [len(p) for ps in ours.predictions for p in ps]
        assert max(lengths) == 3 and 3 in lengths


@pytest.fixture(scope="module")
def mart():
    """(JAX model, params, JAX cfg, port model, port cfg, inputs): the
    MART model at dropout 0, its matrices scaled up and [EOS] favoured so
    the beams vary and finish, 3 videos of 3 sentences."""
    jmodel, _, jcfg, model, cfg, inputs = make_pair("mart")
    with torch.no_grad():
        model.decoder.bias[EOS] += EOS_BIAS
    inputs = tuple(a[:, :3] for a in inputs)
    return (jmodel, to_jax("mart", model, jmodel, inputs), jcfg, model, cfg,
            inputs)


@pytest.mark.parametrize("compat", [False, True], ids=["fixed", "compat"])
def test_beam_decode_matches_jax(mart, compat):
    jmodel, params, jcfg, model, cfg, inputs = mart
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch_beam(
        *inputs[:4], reference_compat=compat)
    translator = Translator(model, cfg)
    ours = translator.translate_batch_beam(
        *(torch.from_numpy(a) for a in inputs[:4]), reference_compat=compat)
    assert len(ours) == len(ref) == 3
    np.testing.assert_array_equal(np.stack(ours), np.stack(ref))
    ours = np.stack(ours)
    assert (ours[..., 0] == 4).all()
    assert (ours == EOS).any() and len(np.unique(ours)) > 4
    # one host read of (N * beam, vocab) a token, one forward a token and
    # one a sentence's memory
    assert translator.host_reads == translator.forwards - 3 + 2 + 1


@pytest.mark.parametrize("compat", [False, True], ids=["fixed", "compat"])
def test_beam_logprobs_match_jax(mart, compat):
    """The first sentence's log-probabilities at every text position, the
    rows tiled x beam, against JAX's token function: 1e-5 relative."""
    jmodel, params, jcfg, model, cfg, inputs = mart
    ids, feats, masks, ttys = (np.repeat(a[0], cfg.beam_size, axis=0)
                               for a in inputs[:4])
    ids, masks = (np.asarray(a) for a in prepare_video_only_inputs(
        *(torch.from_numpy(a) for a in (ids, masks, ttys))))
    jfn = JTranslator(jmodel, lambda: params, jcfg)._beam_token_fn(
        True, compat)
    translator = Translator(model.eval(), cfg)
    rng = np.random.RandomState(4)
    jids, jmasks = jnp.asarray(ids), jnp.asarray(masks)
    t_ids, t_masks = torch.from_numpy(ids), torch.from_numpy(masks)
    for dec_idx in range(cfg.max_v_len, cfg.max_v_len + cfg.max_t_len):
        preds = rng.randint(7, VOCAB, len(ids))
        jids, jmasks, ref = jfn(params, None, jids, jnp.asarray(feats),
                                jmasks, jnp.asarray(ttys),
                                jnp.asarray(preds), dec_idx)
        t_ids[:, dec_idx] = torch.from_numpy(preds)
        t_masks[:, dec_idx] = 1
        with torch.inference_mode():
            ours = translator._beam_logprobs(
                [None] * cfg.num_hidden_layers, t_ids,
                torch.from_numpy(feats), t_masks, torch.from_numpy(ttys),
                torch.tensor([dec_idx]), compat)
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        if compat and dec_idx == 6:  # the position-axis bug: uniform
            np.testing.assert_allclose(ours.numpy(), -np.log(VOCAB),
                                       rtol=1e-6)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_caption_beam_cli")
    return root, make_synth(root)


@pytest.mark.parametrize("variant", ["beam", "beam_compat"])
def test_cli_validate_matches_jax_trainer(synth, variant, monkeypatch):
    """beam_reference_compat is no key of the shipped yamls, and `-o`
    sets only the keys a yaml names: its run takes synthetic_smoke.yaml
    with the key added. [EOS] is favoured: the compat mode does not cap
    max_len, so beams that never emit it decode to empty sentences."""
    root, info = synth
    config = root / "with_compat_key" / SMOKE.name  # the same run name
    config.parent.mkdir(exist_ok=True)
    config.write_text(SMOKE.read_text() + "beam_reference_compat: false\n")
    result = check_cli_matches_jax(variant, root, info, monkeypatch, {},
                                   config_file=config, eos_bias=EOS_BIAS)
    # a read of the inputs, one a token, one of the result
    assert all(r > 3 for r in result["host_reads"])
