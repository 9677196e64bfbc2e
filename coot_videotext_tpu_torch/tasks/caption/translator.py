"""
Caption inference: greedy decoding of the recurrent MART model and of the
MTransformer.

Port of the greedy paths of coot_videotext_tpu/tasks/caption/translator.py
(reference mart/translator.py), token for token. Recurrent
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
same tokens; here there is one path, run eagerly. Untied single sentence
(`translate_batch_single_sentence_untied_greedy`, JAX :339-386, reference
:354): the video is encoded once, then max_t_len decoder passes run from
[BOS] over zeroed ids, each writing the next id at its position; [UNK] is
suppressed; the whole text region comes back, with no [EOS] masking.
`translate_batch` dispatches between the two (JAX :585-614). Beam search
(ROADMAP A10b) and the xl, untied and joint single-sentence decoders
(A11b) are not ported yet; model_manager.check_serving_config refuses
their configs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    BOS, EOS, PAD, UNK)
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    CaptionModel)


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


class Translator:
    """Greedy inference (reference Translator :67) for the recurrent
    MART model and the MTransformer."""

    def __init__(self, model: CaptionModel, cfg) -> None:
        self.model = model
        self.cfg = cfg
        # forwards run by the last decode: full forwards of the recurrent
        # model, or decoder passes (plus the one encode) of the untied one
        self.forwards = 0

    def _greedy_sentence(self, prev_ms, input_ids, video_features,
                         input_masks, token_type_ids):
        """One sentence: (next memories, decoded ids (N, L))."""
        cfg = self.cfg
        ids, masks = input_ids.clone(), input_masks.clone()
        next_words = torch.full_like(ids[:, 0], BOS)
        for dec_idx in range(cfg.max_v_len, cfg.max_v_len + cfg.max_t_len):
            ids[:, dec_idx] = next_words
            masks[:, dec_idx] = 1
            _, _, scores = self.model.forward_step(
                prev_ms, ids, video_features, masks, token_type_ids)
            row = scores[:, dec_idx].clone()
            row[:, UNK] = -1e10
            next_words = row.argmax(dim=1)
        ids, masks = mask_tokens_after_eos(ids, masks)
        cur_ms, _, _ = self.model.forward_step(
            prev_ms, ids, video_features, masks, token_type_ids)
        self.forwards += cfg.max_t_len + 1
        return cur_ms, ids

    def translate_batch_greedy(self, input_ids_list: torch.Tensor,
                               video_features_list: torch.Tensor,
                               input_masks_list: torch.Tensor,
                               token_type_ids_list: torch.Tensor
                               ) -> List[np.ndarray]:
        """Recurrent greedy (reference :201). Inputs stacked (S, N, ...)
        on the model's device. Returns [(N, max_t_len)] * S decoded text
        ids, read from the device once at the end."""
        self.model.eval()
        self.forwards = 0
        with torch.inference_mode():
            ids_st, masks_st = prepare_video_only_inputs(
                input_ids_list, input_masks_list, token_type_ids_list)
            prev_ms = [None] * self.cfg.num_hidden_layers
            out = []
            for idx in range(len(ids_st)):
                prev_ms, ids = self._greedy_sentence(
                    prev_ms, ids_st[idx], video_features_list[idx],
                    masks_st[idx], token_type_ids_list[idx])
                out.append(ids[:, self.cfg.max_v_len:])
            out = torch.stack(out).cpu().numpy()
        return [out[i] for i in range(len(out))]

    def translate_batch_single_sentence_untied_greedy(
            self, video_features: torch.Tensor, video_masks: torch.Tensor,
            text_ids: torch.Tensor) -> np.ndarray:
        """Untied / masked-transformer greedy (reference :354) on (N, ...)
        tensors on the model's device: the (N, max_t_len) ids, [BOS]
        first, read from the device once at the end."""
        model = self.model
        model.eval()
        max_t_len = self.cfg.max_t_len
        with torch.inference_mode():
            encodings = model.encode(video_features, video_masks)
            ids = torch.zeros_like(text_ids)
            next_words = torch.full_like(ids[:, 0], BOS)
            for dec_idx in range(max_t_len):
                ids[:, dec_idx] = next_words
                _, scores = model.decode(ids, None, encodings)
                row = scores[:, dec_idx].clone()
                row[:, UNK] = -1e10
                next_words = row.argmax(dim=1)
            self.forwards = max_t_len + 1
            return ids.cpu().numpy()

    def translate_batch(self, batch: Dict[str, torch.Tensor]):
        """Greedy decode of a collated batch on the model's device (JAX
        :585): recurrent, [(N, max_t_len)] * S; untied (mtrans), (N,
        max_t_len)."""
        if self.cfg.recurrent:
            return self.translate_batch_greedy(
                batch["input_ids"], batch["video_feature"],
                batch["input_mask"], batch["token_type_ids"])
        return self.translate_batch_single_sentence_untied_greedy(
            batch["video_feature"], batch["video_mask"], batch["text_ids"])

    @classmethod
    def sort_res(cls, res_dict: Dict[str, list]) -> Dict[str, list]:
        """Sort output sentences by timestamp (reference :450)."""
        return {k: sorted(v, key=lambda x: float(x["timestamp"][0]))
                for k, v in res_dict.items()}
