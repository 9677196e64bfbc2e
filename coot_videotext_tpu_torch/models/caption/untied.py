"""
The untied encoder-decoder caption model, NonRecurTransformerUntied: a
video encoder and a causal text decoder with cross-attention, one sentence
at a time in the untied layout (video rows apart from the text).

Port of coot_videotext_tpu/models/caption/untied.py (reference
mart/model.py: BertEmbeddingsTextUntied :560, BertEmbeddingsVideoUntied
:567, BertLayerNoMemoryUntied / BertEncoderNoMemoryUntied :600-647,
BertDecoderLayerNoMemoryUntied / BertDecoderNoMemoryUntied :649-722,
NonRecurTransformerUntied :1261). Where it departs from the joint model:
    - the text embedding runs at word_vec_size through LN, dropout, FC to
      hidden, ReLU and LN, the video rows through the same pipeline, and
      both add the sincos table sliced to their length (no LayerNorm or
      dropout after it);
    - the encoder's key mask is the video mask; the decoder's is the text
      mask times tril (causal), its cross-attention reads the video mask;
    - the decoder layer: causal self-attention, norm1 over att + input,
      cross-attention, norm2 over att + cross, then BertOutput(cross,
      cross): the residual onto itself and no intermediate layer
      (reference :679).
Every dropout site is the port's models/layers.Dropout (kernel B4 on the
card). Module and parameter names are the reference torch keys that the
JAX package's utils/torch_convert.py::_convert_untied_key reads
(`embeddings.word_fc.N`, `video_embeddings.video_embeddings.N`,
`encoder.layer.N...`, `decoder.layer.N.{self_attention,dec_enc_attention,
norm1,norm2,output}...`, `decoder_classifier...`). Init as the joint
model's (init_bert_weights).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from coot_videotext_tpu_torch.models.caption.bert import (
    BertAttention, BertIntermediate, BertLMPredictionHead, BertOutput,
    BertSelfAttention, BertSelfOutput, _embedding_stack, bert_layernorm,
    init_bert_weights, positional_encoding_table)
from coot_videotext_tpu_torch.models.caption.mart import compute_loss


def _position_table(cfg) -> torch.Tensor:
    return torch.from_numpy(positional_encoding_table(
        cfg.max_position_embeddings, cfg.hidden_size))


class BertEmbeddingsTextUntied(nn.Module):
    """Word embedding -> LN/dropout/FC/ReLU/LN -> + sincos PE (reference
    :560)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.word_vec_size)
        self.word_fc = _embedding_stack(cfg, cfg.word_vec_size)
        self.register_buffer("position_table", _position_table(cfg),
                             persistent=False)

    def forward(self, text_input_ids: torch.Tensor) -> torch.Tensor:
        w = self.word_fc(self.word_embeddings(text_input_ids))
        return w + self.position_table[:w.shape[-2]][None]


class BertEmbeddingsVideoUntied(nn.Module):
    """Video LN/dropout/FC/ReLU/LN -> + sincos PE (reference :567)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.video_embeddings = _embedding_stack(cfg,
                                                 cfg.video_feature_size)
        self.register_buffer("position_table", _position_table(cfg),
                             persistent=False)

    def forward(self, video_features: torch.Tensor) -> torch.Tensor:
        v = self.video_embeddings(video_features)
        return v + self.position_table[:v.shape[-2]][None]


def _self_mask(attention_mask: torch.Tensor,
               diagonal_mask: bool) -> torch.Tensor:
    """(N, L) -> (N, L, L) key mask, causal when `diagonal_mask`
    (reference :640-645)."""
    n, length = attention_mask.shape
    mask = attention_mask.float()[:, None, :]
    if diagonal_mask:
        mask = mask * torch.tril(torch.ones(
            length, length, device=attention_mask.device))[None]
    return mask.expand(n, length, length)


class BertLayerNoMemoryUntied(nn.Module):
    """Encoder layer (reference :600)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.attention = BertAttention(cfg)
        self.hidden_intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor,
                diagonal_mask: bool = False) -> torch.Tensor:
        att = self.attention(hidden_states,
                             _self_mask(attention_mask, diagonal_mask))
        return self.output(self.hidden_intermediate(att), att)


class BertEncoderNoMemoryUntied(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayerNoMemoryUntied(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor,
                diagonal_mask: bool = False) -> torch.Tensor:
        for layer in self.layer:
            hidden_states = layer(hidden_states, attention_mask,
                                  diagonal_mask)
        return hidden_states


class BertDecoderLayerNoMemoryUntied(nn.Module):
    """Causal self-attention + cross-attention (reference :649)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.self_attention = BertSelfAttention(cfg)
        self.norm1 = bert_layernorm(cfg, cfg.hidden_size)
        self.dec_enc_attention = BertSelfAttention(cfg)
        self.norm2 = bert_layernorm(cfg, cfg.hidden_size)
        self.output = BertSelfOutput(cfg)  # hidden -> hidden

    def forward(self, dec_hidden_states: torch.Tensor,
                dec_mask: torch.Tensor, enc_outputs: torch.Tensor,
                enc_mask: torch.Tensor,
                diagonal_mask: bool = True) -> torch.Tensor:
        self_mask = _self_mask(dec_mask, diagonal_mask)
        att = self.self_attention(dec_hidden_states, dec_hidden_states,
                                  dec_hidden_states, self_mask)
        att = self.norm1(att + dec_hidden_states)
        enc_key_mask = enc_mask.float()[:, None, :].expand(
            dec_mask.shape[0], dec_mask.shape[1], enc_mask.shape[1])
        cross = self.dec_enc_attention(att, enc_outputs, enc_outputs,
                                       enc_key_mask)
        cross = self.norm2(att + cross)
        # reference :679: the output's residual is its own input
        return self.output(cross, cross)


class BertDecoderNoMemoryUntied(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertDecoderLayerNoMemoryUntied(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, dec_hidden_states: torch.Tensor,
                dec_mask: torch.Tensor, enc_outputs: torch.Tensor,
                enc_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            dec_hidden_states = layer(dec_hidden_states, dec_mask,
                                      enc_outputs, enc_mask)
        return dec_hidden_states


class NonRecurTransformerUntied(nn.Module):
    """The untied encoder-decoder model (reference :1261). `generator`
    seeds the init."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddingsTextUntied(cfg)
        self.video_embeddings = BertEmbeddingsVideoUntied(cfg)
        self.encoder = BertEncoderNoMemoryUntied(cfg)
        self.decoder = BertDecoderNoMemoryUntied(cfg)
        self.decoder_classifier = BertLMPredictionHead(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self, cfg.initializer_range, generator)

    def encode(self, video_features: torch.Tensor,
               video_masks: torch.Tensor) -> torch.Tensor:
        """The encoded video rows (N, V, D)."""
        return self.encoder(self.video_embeddings(video_features),
                            video_masks, False)

    def decode(self, text_input_ids: torch.Tensor,
               text_masks: torch.Tensor,
               text_input_labels: Optional[torch.Tensor],
               encoder_outputs: torch.Tensor, encoder_masks: torch.Tensor,
               token_count: Optional[torch.Tensor] = None
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(loss, or None without labels; scores (N, T, vocab));
        `token_count` as mart.py `compute_loss`'s count."""
        dec = self.decoder(self.embeddings(text_input_ids), text_masks,
                           encoder_outputs, encoder_masks)
        scores = self.decoder_classifier(dec)
        if text_input_labels is None:
            return None, scores
        return compute_loss(self.cfg, scores, text_input_labels,
                            token_count), scores

    def forward(self, video_features: torch.Tensor,
                video_masks: torch.Tensor, text_input_ids: torch.Tensor,
                text_masks: torch.Tensor,
                text_input_labels: Optional[torch.Tensor],
                token_count: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """The untied batch (JAX `_single_forward` argument order)."""
        return self.decode(text_input_ids, text_masks, text_input_labels,
                           self.encode(video_features, video_masks),
                           video_masks, token_count)
