"""
The MART caption models: the recurrent RecursiveTransformer and the joint
single-sentence NonRecurTransformer.

Port of coot_videotext_tpu/models/caption/mart.py (RecursiveTransformer
:31, reference mart/model.py:1385; NonRecurTransformer :153, reference
:1334). The recurrent forward loops over sentence steps
carrying per-layer memory states; steps arrive stacked as (S, N, L, ...)
tensors (dummy steps carry IGNORE labels and add exactly zero loss). The
JAX package's `recurrent_scan` (an nn.scan of steps 1..S-1, a compile-time
lever with the same math) has no counterpart: the loop here is always the
plain unrolled one. NonRecurTransformer encodes one joint video + text
sequence with the no-memory encoder (the reference's dead
`memory_intermediate` parameters are not built; param_bridge skips them
when loading, JAX torch_convert.py:213-214). Both heads tie their decoder
matrix to the word embeddings under share_wd_cls_weight.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from coot_videotext_tpu_torch.models.caption.bert import (
    BertEmbeddingsWithVideo, BertEncoderNoMemory, BertEncoderWithMemory,
    BertLMPredictionHead, init_bert_weights)
from coot_videotext_tpu_torch.train.loss_caption import (
    cross_entropy_loss, label_smoothing_loss)

Memories = List[Optional[torch.Tensor]]


class RecursiveTransformer(nn.Module):
    """The MART model (reference :1385). `generator` seeds the init."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddingsWithVideo(cfg)
        self.encoder = BertEncoderWithMemory(cfg)
        self.decoder = BertLMPredictionHead(
            cfg, self.embeddings.word_embeddings)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self, cfg.initializer_range, generator)

    def forward_step(self, prev_ms: Memories, input_ids: torch.Tensor,
                     video_features: torch.Tensor,
                     input_masks: torch.Tensor,
                     token_type_ids: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                torch.Tensor]:
        """One sentence step (reference :1415): (memories, encoded,
        prediction scores)."""
        emb = self.embeddings(input_ids, video_features, token_type_ids)
        prev_ms, encoded = self.encoder(prev_ms, emb, input_masks)
        scores = self.decoder(encoded)
        return prev_ms, encoded, scores

    # ---------- the cached greedy decode (inference, whole weights) ----------

    def decode_prefix(self, prev_ms: Memories, input_ids: torch.Tensor,
                      video_features: torch.Tensor,
                      input_masks: torch.Tensor,
                      token_type_ids: torch.Tensor) -> Dict:
        """A sentence's pass once before its token steps, on forward_step's
        (N, L) inputs: the embeddings' word-independent rows and every
        layer's caches after the video rows (the first sentence's memory
        built from them, as forward_step builds it)."""
        n_video = self.cfg.max_v_len
        emb, rest = self.embeddings.decode_prefix(
            input_ids, video_features, token_type_ids, n_video)
        masks = input_masks.clone()
        masks[:, n_video:] = 1
        return {"rest": rest,
                "layers": self.encoder.decode_prefix(prev_ms, emb, masks)}

    def decode_token(self, state: Dict, word_ids: torch.Tensor,
                     pos: int) -> torch.Tensor:
        """forward_step's scores (N, vocab) at position `pos`, given the
        words (N,) at `pos` and the rows before it in `state`; the memory
        update is left out (only the sentence's last forward keeps it)."""
        rest = state["rest"][:, pos - self.cfg.max_v_len][:, None]
        hidden = self.embeddings.decode_word(word_ids[:, None], rest)
        hidden = self.encoder.decode_token(state["layers"], hidden, pos)
        return self.decoder.decode_rows(hidden)[:, 0]

    def next_memories(self, prev_ms: Memories, input_ids: torch.Tensor,
                      video_features: torch.Tensor,
                      input_masks: torch.Tensor,
                      token_type_ids: torch.Tensor) -> List[torch.Tensor]:
        """forward_step's memories, without its prediction head."""
        emb = self.embeddings(input_ids, video_features, token_type_ids)
        return self.encoder(prev_ms, emb, input_masks)[0]

    def forward(self, input_ids_list: torch.Tensor,
                video_features_list: torch.Tensor,
                input_masks_list: torch.Tensor,
                token_type_ids_list: torch.Tensor,
                input_labels_list: Optional[torch.Tensor] = None, *,
                return_memory: bool = False,
                token_counts: Optional[torch.Tensor] = None):
        """
        Args: stacked (S, N, L[, D]) tensors, one entry per sentence step;
        `token_counts` (S,): each step's valid tokens over the global batch
        under data parallelism (the mean cross entropy divides by them).

        Returns (caption_loss, prediction_scores_list), or the list of
        per-step memories when return_memory (reference :1427-1464).
        """
        prev_ms: Memories = [None] * self.cfg.num_hidden_layers
        memory_list = []
        scores_list = []
        for idx in range(len(input_ids_list)):
            prev_ms, _, scores = self.forward_step(
                prev_ms, input_ids_list[idx], video_features_list[idx],
                input_masks_list[idx], token_type_ids_list[idx])
            memory_list.append(prev_ms)
            scores_list.append(scores)
        if return_memory:
            return memory_list
        caption_loss = scores_list[0].new_zeros((), dtype=torch.float32)
        for idx, scores in enumerate(scores_list):
            caption_loss = caption_loss + compute_loss(
                self.cfg, scores, input_labels_list[idx],
                None if token_counts is None else token_counts[idx])
        return caption_loss, scores_list



def compute_loss(cfg, scores: torch.Tensor, labels: torch.Tensor,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The caption loss of `scores` against `labels` (IGNORE = -1):
    label smoothing when the config sets it, else cross entropy (a mean
    over `count` tokens, default the valid ones of `labels`)."""
    if cfg.label_smoothing != 0:
        return label_smoothing_loss(scores, labels, cfg.label_smoothing,
                                    cfg.vocab_size)
    return cross_entropy_loss(scores, labels, count=count)


class NonRecurTransformer(nn.Module):
    """Single joint-sequence encoder model (reference :1334). `generator`
    seeds the init."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddingsWithVideo(cfg)
        self.encoder = BertEncoderNoMemory(cfg)
        self.decoder = BertLMPredictionHead(
            cfg, self.embeddings.word_embeddings)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self, cfg.initializer_range, generator)

    def forward(self, input_ids: torch.Tensor, video_features: torch.Tensor,
                input_masks: torch.Tensor, token_type_ids: torch.Tensor,
                input_labels: Optional[torch.Tensor] = None,
                token_count: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(loss, or None without labels; scores (N, L, vocab)) of (N, L)
        joint sequences; `token_count` as `compute_loss`'s count."""
        emb = self.embeddings(input_ids, video_features, token_type_ids)
        scores = self.decoder(self.encoder(emb, input_masks))
        if input_labels is None:
            return None, scores
        return compute_loss(self.cfg, scores, input_labels,
                            token_count), scores
