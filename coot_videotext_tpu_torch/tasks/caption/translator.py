"""
Caption inference: greedy decoding of every caption model and beam search
on the recurrent MART model.

Port of coot_videotext_tpu/tasks/caption/translator.py (reference
mart/translator.py), token for token. Greedy, recurrent
(`translate_batch_greedy`):
    - prepare_video_only_inputs blanks all text ids/masks (:424)
    - per sentence step, the token loop runs dec_idx over the text region
      starting from [BOS] at max_v_len; each token re-runs the FULL
      forward_step with the previous sentence's memory and reads the
      scores at dec_idx; UNK is suppressed (-1e10), argmax picks the next
      token; after the sentence, tokens after the first [EOS] become
      [PAD] and one more forward builds the next sentence's memory
      (:231-234).
The JAX package's `fused=True` (the whole batch as one program) emits the
same tokens; here there is one path, run eagerly. The TransformerXL
(`translate_batch_greedy_xl`, JAX :268-337) runs the same loop with its
forward_step's signature (token types before masks) and threads the
previous sentence's masks, the EOS-masked decoded ones, beside its
memories. Single sentence, joint (`translate_batch_single_sentence_greedy`,
JAX :217-266): one full forward per token from [BOS] at max_v_len, [UNK]
suppressed; only the text region comes back. Untied
(`translate_batch_single_sentence_untied_greedy`, JAX :339-386,
reference :354; the untied model and the MTransformer): the video is
encoded once, then max_t_len decoder passes run from [BOS] over zeroed ids
and masks, each setting its position's mask and writing the next id;
[UNK] is suppressed; the whole text region comes back, with no [EOS]
masking.

Beam search (`translate_batch_beam`, JAX :388-583, reference :79-180) on
the recurrent MART model: the beam bookkeeping is the host's numpy
(beam_search.py); the rows stay at the static N * beam_size, tiled batch
major, and at each token the beam's indices gather the ids, masks,
features, token types and memories (padding rows take row 0). Each token
takes log_softmax in f32 of the row at dec_idx with [UNK] suppressed on
the token axis, read from the device once as (N * beam, vocab); rows are
reordered every step and max_len = min(max_sen_len, max_t_len - 2).
`reference_compat` reproduces the reference instead: -1e10 on the
POSITION axis at index UNK = 6 (with max_v_len 3 the readout at dec_idx 6
turns uniform), log(softmax), rows reordered only on steps where a beam
finished, max_len uncapped. After the tokens the best hypothesis goes into
the untiled ids and masks as [BOS] hyp [EOS] cut to max_t_len (an empty
hypothesis decodes to an empty sentence), the masks after [EOS] are
zeroed and the next sentence's memory is built from them.

`translate_batch` dispatches between them (JAX :585-614); beam search is
refused for a model that is not the recurrent MART one, as JAX asserts.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    BOS, EOS, PAD, UNK)
from coot_videotext_tpu_torch.tasks.caption.beam_search import BeamSearch
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    CaptionModel, check_serving_config)


def mask_tokens_after_eos(input_ids: torch.Tensor,
                          input_masks: torch.Tensor,
                          eos_token_id: int = EOS,
                          pad_token_id: int = PAD):
    """Replace values after the first [EOS] with [PAD] (reference
    translator.py:50), on (N, L) tensors."""
    is_eos = input_ids == eos_token_id
    has_eos = is_eos.any(dim=1)
    first_eos = is_eos.int().argmax(dim=1)  # 0 when none
    col = torch.arange(input_ids.shape[1], device=input_ids.device)
    after = (col[None, :] > first_eos[:, None]) & has_eos[:, None]
    input_ids = torch.where(after, torch.full_like(input_ids, pad_token_id),
                            input_ids)
    input_masks = torch.where(after, torch.zeros_like(input_masks),
                              input_masks)
    return input_ids, input_masks


def prepare_video_only_inputs(input_ids: torch.Tensor,
                              input_masks: torch.Tensor,
                              segment_ids: torch.Tensor):
    """Blank text ids and masks (reference :424), stacked (S, N, L) or
    single (N, L)."""
    text = segment_ids == 1
    return (torch.where(text, torch.full_like(input_ids, PAD), input_ids),
            torch.where(text, torch.zeros_like(input_masks), input_masks))


def _next_words(scores: torch.Tensor, dec_idx: int) -> torch.Tensor:
    """argmax of the scores at dec_idx with [UNK] suppressed."""
    row = scores[:, dec_idx].clone()
    row[:, UNK] = -1e10
    return row.argmax(dim=1)


class Translator:
    """Greedy and beam inference (reference Translator :67) for every
    caption model."""

    def __init__(self, model: CaptionModel, cfg) -> None:
        self.model = model
        self.cfg = cfg
        # forwards run by the last decode: full forwards of the recurrent
        # and joint models, or decoder passes (plus the one encode) of the
        # untied ones; and its reads of results from the device
        self.forwards = 0
        self.host_reads = 0

    def _begin(self) -> None:
        self.model.eval()
        self.forwards = 0
        self.host_reads = 0

    def _greedy_tokens(self, scores_fn: Callable, input_ids: torch.Tensor,
                       input_masks: torch.Tensor, start: int, stop: int):
        """The token loop over positions start..stop-1 from [BOS]:
        scores_fn(ids, masks) gives the scores (N, L, vocab). Returns the
        ids and masks."""
        ids, masks = input_ids.clone(), input_masks.clone()
        next_words = torch.full_like(ids[:, 0], BOS)
        for dec_idx in range(start, stop):
            ids[:, dec_idx] = next_words
            masks[:, dec_idx] = 1
            next_words = _next_words(scores_fn(ids, masks), dec_idx)
        self.forwards += stop - start
        return ids, masks

    def _read(self, out: List[torch.Tensor]) -> List[np.ndarray]:
        """Stacked (S, ...) results read from the device once."""
        out = torch.stack(out).cpu().numpy()
        self.host_reads += 1
        return [out[i] for i in range(len(out))]

    def _greedy_recurrent(self, step: Callable, prev, input_ids_list,
                          video_features_list, input_masks_list,
                          token_type_ids_list) -> List[np.ndarray]:
        """The recurrent greedy loop over stacked (S, N, ...) inputs:
        step(prev, ids, feats, masks, ttypes) -> (the next sentence's prev,
        scores). Returns [(N, max_t_len)] * S, read once at the end."""
        cfg = self.cfg
        self._begin()
        lo, hi = cfg.max_v_len, cfg.max_v_len + cfg.max_t_len
        with torch.inference_mode():
            ids_st, masks_st = prepare_video_only_inputs(
                input_ids_list, input_masks_list, token_type_ids_list)
            out = []
            for idx in range(len(ids_st)):
                feats = video_features_list[idx]
                ttypes = token_type_ids_list[idx]
                ids, masks = self._greedy_tokens(
                    lambda i, m: step(prev, i, feats, m, ttypes)[1],
                    ids_st[idx], masks_st[idx], lo, hi)
                ids, masks = mask_tokens_after_eos(ids, masks)
                prev, _ = step(prev, ids, feats, masks, ttypes)
                self.forwards += 1
                out.append(ids[:, lo:])
            return self._read(out)

    def translate_batch_greedy(self, input_ids_list: torch.Tensor,
                               video_features_list: torch.Tensor,
                               input_masks_list: torch.Tensor,
                               token_type_ids_list: torch.Tensor
                               ) -> List[np.ndarray]:
        """Recurrent greedy (reference :201). Inputs stacked (S, N, ...)
        on the model's device. Returns [(N, max_t_len)] * S decoded text
        ids, read from the device once at the end."""
        model = self.model

        def step(ms, ids, feats, masks, ttypes):
            ms, _, scores = model.forward_step(ms, ids, feats, masks, ttypes)
            return ms, scores
        return self._greedy_recurrent(
            step, [None] * self.cfg.num_hidden_layers, input_ids_list,
            video_features_list, input_masks_list, token_type_ids_list)

    def translate_batch_greedy_xl(self, input_ids_list: torch.Tensor,
                                  video_features_list: torch.Tensor,
                                  input_masks_list: torch.Tensor,
                                  token_type_ids_list: torch.Tensor
                                  ) -> List[np.ndarray]:
        """TransformerXL greedy (JAX :268, reference
        translate_batch_greedy_xl :261): the recurrent loop with the
        previous sentence's EOS-masked masks threaded beside its
        memories."""
        model = self.model

        def step(prev, ids, feats, masks, ttypes):
            ms, _, scores = model.forward_step(prev[0], ids, feats, ttypes,
                                               masks, prev[1])
            return (ms, masks), scores
        return self._greedy_recurrent(
            step, (None, None), input_ids_list, video_features_list,
            input_masks_list, token_type_ids_list)

    def translate_batch_single_sentence_greedy(
            self, input_ids: torch.Tensor, video_features: torch.Tensor,
            input_masks: torch.Tensor, token_type_ids: torch.Tensor
    ) -> np.ndarray:
        """Joint single-sentence greedy (JAX :246) on (N, L) tensors on
        the model's device: the (N, max_t_len) text region, [BOS] first
        (JAX :261-264: returning the joint sequence leaked the video
        tokens into every caption)."""
        cfg, model = self.cfg, self.model
        self._begin()
        lo = cfg.max_v_len
        with torch.inference_mode():
            ids, masks = prepare_video_only_inputs(input_ids, input_masks,
                                                   token_type_ids)
            ids, _ = self._greedy_tokens(
                lambda i, m: model(i, video_features, m, token_type_ids)[1],
                ids, masks, lo, lo + cfg.max_t_len)
            return self._read([ids[:, lo:]])[0]

    def translate_batch_single_sentence_untied_greedy(
            self, video_features: torch.Tensor, video_masks: torch.Tensor,
            text_ids: torch.Tensor, text_masks: torch.Tensor) -> np.ndarray:
        """Untied / masked-transformer greedy (reference :354) on (N, ...)
        tensors on the model's device: the (N, max_t_len) ids, [BOS]
        first, read from the device once at the end."""
        model = self.model
        self._begin()
        with torch.inference_mode():
            encodings = model.encode(video_features, video_masks)
            self.forwards = 1
            ids, _ = self._greedy_tokens(
                lambda i, m: model.decode(i, m, None, encodings,
                                          video_masks)[1],
                torch.zeros_like(text_ids), torch.zeros_like(text_masks),
                0, self.cfg.max_t_len)
            return self._read([ids])[0]

    # ---------- beam (recurrent) ----------

    def _beam_logprobs(self, ms, ids, feats, masks, ttypes,
                       dec_idx: int, reference_compat: bool
                       ) -> torch.Tensor:
        """The (rows, vocab) f32 log-probabilities at dec_idx (JAX
        `_beam_token_fn` :388)."""
        _, _, scores = self.model.forward_step(ms, ids, feats, masks,
                                               ttypes)
        self.forwards += 1
        row = scores[:, dec_idx].float()
        if reference_compat:
            # the reference's `pred_scores[:, UNK] = -1e10`
            # (translator.py:133) writes POSITION UNK (= 6) across the
            # vocabulary: [UNK] is not suppressed, and the readout at
            # dec_idx == 6 is all -1e10 (uniform); then log(softmax)
            if dec_idx == UNK:
                row = torch.full_like(row, -1e10)
            return torch.log(torch.softmax(row, dim=-1))
        row = row.clone()
        row[:, UNK] = -1e10  # the token axis, as the greedy paths do
        return torch.log_softmax(row, dim=-1)

    def translate_batch_beam(self, input_ids_list: torch.Tensor,
                             video_features_list: torch.Tensor,
                             input_masks_list: torch.Tensor,
                             token_type_ids_list: torch.Tensor,
                             reference_compat: bool = False
                             ) -> List[np.ndarray]:
        """Recurrent beam search (reference :79-180). Inputs stacked (S, N,
        ...) on the model's device; returns [(N, max_t_len)] * S decoded
        text ids."""
        cfg, model = self.cfg, self.model
        self._begin()
        beam_size = cfg.beam_size
        lo = cfg.max_v_len
        # cap max_length to the decodable text region (JAX :486-497):
        # beams that never emit [EOS] would otherwise never finish
        max_len = (cfg.max_sen_len if reference_compat
                   else min(cfg.max_sen_len, cfg.max_t_len - 2))
        with torch.inference_mode():
            ids_st, masks_st = prepare_video_only_inputs(
                input_ids_list, input_masks_list, token_type_ids_list)
            host_ids = ids_st.cpu().numpy()
            host_masks = masks_st.cpu().numpy()
            self.host_reads += 2
            device = ids_st.device
            batch_size = ids_st.shape[1]
            total_rows = batch_size * beam_size
            out = []
            prev_ms = [None] * cfg.num_hidden_layers
            for idx in range(len(ids_st)):
                init_ids = host_ids[idx].copy()
                init_masks = host_masks[idx].copy()
                init_feats = video_features_list[idx]
                init_ttypes = token_type_ids_list[idx]
                # tile x beam, batch-major blocks (reference tile :33)
                ids, masks, feats, ttypes = (
                    x.repeat_interleave(beam_size, dim=0) for x in (
                        ids_st[idx], masks_st[idx], init_feats,
                        init_ttypes))
                ms = [None if m is None
                      else m.repeat_interleave(beam_size, dim=0)
                      for m in prev_ms]
                beam = BeamSearch(
                    beam_size, batch_size, PAD, BOS, EOS, cfg.n_best,
                    cfg.min_sen_len, max_len, cfg.block_ngram_repeat,
                    exclusion_tokens=set(),
                    length_penalty_name=cfg.length_penalty_name,
                    length_penalty_alpha=cfg.length_penalty_alpha)
                n_alive = total_rows
                for dec_idx in range(lo, lo + cfg.max_t_len):
                    preds = np.zeros(total_rows, np.int64)
                    preds[:n_alive] = beam.current_predictions
                    ids[:, dec_idx] = torch.from_numpy(preds).to(device)
                    masks[:, dec_idx] = 1
                    logprobs = self._beam_logprobs(
                        ms, ids, feats, masks, ttypes, dec_idx,
                        reference_compat)
                    lp = logprobs.cpu().numpy()[:n_alive]
                    self.host_reads += 1
                    beam.advance(lp)
                    if beam.is_finished.any():
                        beam.update_finished()
                        if beam.done:
                            break
                        sel = beam.select_indices
                    elif reference_compat:
                        # the reference reorders the rows only on steps
                        # where some beam finished (:146-160)
                        continue
                    else:
                        sel = beam.current_origin
                    perm = np.zeros(total_rows, np.int64)
                    perm[:len(sel)] = sel
                    n_alive = len(sel)
                    perm = torch.from_numpy(perm).to(device)
                    ids, masks, feats, ttypes = (
                        x.index_select(0, perm)
                        for x in (ids, masks, feats, ttypes))
                    ms = [None if m is None else m.index_select(0, perm)
                          for m in ms]

                # the top hypotheses into the untiled inputs (reference
                # :163-180)
                for b in range(batch_size):
                    hyp = (beam.predictions[b][0] if beam.predictions[b]
                           else np.asarray([], np.int64))
                    sen_ids = ([BOS] + [int(t) for t in hyp]
                               + [EOS])[:cfg.max_t_len]
                    init_ids[b, lo:lo + len(sen_ids)] = sen_ids
                    init_masks[b, lo:lo + len(sen_ids)] = 1
                dec_ids, dec_masks = mask_tokens_after_eos(
                    torch.from_numpy(init_ids).to(device),
                    torch.from_numpy(init_masks).to(device))
                prev_ms, _, _ = model.forward_step(
                    prev_ms, dec_ids, init_feats, dec_masks, init_ttypes)
                self.forwards += 1
                out.append(dec_ids[:, lo:])
            return self._read(out)

    # ---------- dispatch ----------

    def translate_batch(self, batch: Dict[str, torch.Tensor]):
        """The decode of a collated batch on the model's device that the
        config selects (JAX :585): recurrent (MART greedy or beam,
        TransformerXL greedy), [(N, max_t_len)] * S; single sentence
        (untied, MTransformer or joint), (N, max_t_len)."""
        cfg = self.cfg
        check_serving_config(cfg)
        if cfg.recurrent:
            args = (batch["input_ids"], batch["video_feature"],
                    batch["input_mask"], batch["token_type_ids"])
            if cfg.use_beam:
                return self.translate_batch_beam(
                    *args, reference_compat=cfg.beam_reference_compat)
            if cfg.xl:
                return self.translate_batch_greedy_xl(*args)
            return self.translate_batch_greedy(*args)
        if cfg.untied or cfg.mtrans:
            return self.translate_batch_single_sentence_untied_greedy(
                batch["video_feature"], batch["video_mask"],
                batch["text_ids"], batch["text_mask"])
        return self.translate_batch_single_sentence_greedy(
            batch["input_ids"], batch["video_feature"],
            batch["input_mask"], batch["token_type_ids"])

    @classmethod
    def sort_res(cls, res_dict: Dict[str, list]) -> Dict[str, list]:
        """Sort output sentences by timestamp (reference :450)."""
        return {k: sorted(v, key=lambda x: float(x["timestamp"][0]))
                for k, v in res_dict.items()}
