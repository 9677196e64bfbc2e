"""
The TransformerXL caption model: relative-position attention over the
previous sentence's hidden states as memory.

Port of coot_videotext_tpu/models/caption/xl.py (reference mart/model.py
:848-1260: PositionwiseFF, RelPartialLearnableMultiHeadAttn with
_rel_shift :914, TransformerXLEncoder :1081, TransformerXL :1147), batch
first (N, L, D). Where a plain PyTorch idiom would give another number:
    - positional_embedding_xl: [sin | cos] concatenated, not interleaved,
      over positions klen-1 down to 0;
    - rel_shift: pad a zero column, view (K + 1, Q), drop the first row,
      view back;
    - the attention's q is the last qlen rows of [mems; w]; the score is
      (AC + rel_shift(BD)) / sqrt(d_head), filled with -INF (typext.INF =
      32752) where masked (1 = masked); qkv_net, r_net and o_net have no
      bias; no dropout on the probabilities (dropatt 0);
    - both LayerNorms (attention, feed-forward) are post-LN with eps 1e-5,
      not the config's layer_norm_eps;
    - the encoder drops the embeddings, the (klen, D) position table and
      the last output with one dropout rate; its memories are all n_layers
      + 1 hidden states, detached unless xl_grad (then the gradient flows
      across sentence steps);
    - the embeddings add no position table; make_mask puts the previous
      segment's padding mask before shifted * padding and returns 1 =
      masked; in training the previous mask is the teacher sentence's.
r_w_bias and r_r_bias start normal(initializer_range) as in the JAX
package (the reference leaves them uninitialized). Every dropout site is
the port's models/layers.Dropout (kernel B4 on the card). Module and
parameter names are the reference torch keys that the JAX package's
utils/torch_convert.py::_convert_xl_key reads (`encoder.r_w_bias`,
`encoder.layers.N.dec_attn.{qkv_net,r_net,o_net,layer_norm}`,
`encoder.layers.N.pos_ff.{CoreNet.0,CoreNet.3,layer_norm}`, the joint
model's `embeddings.*` and `decoder.*`).

Each relative attention is bracketed by the phase marks `relattn` and
`relattn_end` (ops/phase.py `Bracket`): in the forward at its entry and
exit, and in the backward again, so that a device trace of a captured
train step reads the attention's time in both.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from coot_videotext_tpu_torch.models.caption.bert import (
    BertEmbeddingsWithVideo, BertLMPredictionHead, init_bert_weights,
    make_shifted_mask)
from coot_videotext_tpu_torch.models.caption.mart import compute_loss
from coot_videotext_tpu_torch.models.layers import Dropout
from coot_videotext_tpu_torch.ops import phase
from coot_videotext_tpu_torch.typext import INF

XL_LN_EPS = 1e-5


_INV_FREQ: dict = {}


def positional_embedding_xl(pos_seq: torch.Tensor,
                            d_model: int) -> torch.Tensor:
    """(K,) positions -> (K, D) [sin | cos] (reference
    PositionalEmbeddingXL). The frequencies are cached on the device: no
    host-to-device copy per call, so a CUDA graph can capture it after a
    first eager call."""
    key = (d_model, pos_seq.dtype, pos_seq.device)
    if key not in _INV_FREQ:
        inv_freq = 1.0 / (10000 ** (np.arange(0.0, d_model, 2.0) / d_model))
        _INV_FREQ[key] = torch.as_tensor(inv_freq, dtype=pos_seq.dtype,
                                         device=pos_seq.device)
    sinusoid = pos_seq[:, None] * _INV_FREQ[key][None]
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Relative shift along the key axis of (N, H, Q, K) (reference
    _rel_shift :914)."""
    n, h, q, k = x.shape
    x_padded = torch.cat([x.new_zeros(n, h, q, 1), x], dim=-1)
    x_padded = x_padded.view(n, h, k + 1, q)
    return x_padded[:, :, 1:, :].reshape(n, h, q, k)


class PositionwiseFF(nn.Module):
    """FFN with post-LN (reference :855, pre_lnorm false)."""

    def __init__(self, d_model: int, d_inner: int, dropout: float) -> None:
        super().__init__()
        self.CoreNet = nn.Sequential(
            nn.Linear(d_model, d_inner), nn.ReLU(inplace=True),
            Dropout(dropout), nn.Linear(d_inner, d_model), Dropout(dropout))
        self.layer_norm = nn.LayerNorm(d_model, eps=XL_LN_EPS)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(inp + self.CoreNet(inp))


class RelPartialLearnableMultiHeadAttn(nn.Module):
    """Relative-position multi-head attention (reference :936)."""

    def __init__(self, n_head: int, d_model: int, d_head: int,
                 dropout: float) -> None:
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.qkv_net = nn.Linear(d_model, 3 * n_head * d_head, bias=False)
        self.r_net = nn.Linear(d_model, n_head * d_head, bias=False)
        self.o_net = nn.Linear(n_head * d_head, d_model, bias=False)
        self.drop = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=XL_LN_EPS)

    def forward(self, w: torch.Tensor, r: torch.Tensor,
                r_w_bias: torch.Tensor, r_r_bias: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                mems: Optional[torch.Tensor] = None) -> torch.Tensor:
        """w (N, L, D); r (K, D); the biases (H, Dh); attn_mask (N, L, K)
        with 1 = masked; mems (N, M, D) or None."""
        w = phase.Bracket.apply(w, "relattn", "relattn_end")
        n, qlen, _ = w.shape
        cat = w if mems is None else torch.cat([mems, w], dim=1)
        q, k, v = self.qkv_net(cat).chunk(3, dim=-1)
        klen = cat.shape[1]
        q = q[:, -qlen:].reshape(n, qlen, self.n_head, self.d_head)
        k = k.reshape(n, klen, self.n_head, self.d_head)
        v = v.reshape(n, klen, self.n_head, self.d_head)
        r_head_k = self.r_net(r).view(-1, self.n_head, self.d_head)
        ac = torch.einsum("bqhd,bkhd->bhqk", q + r_w_bias, k)
        bd = rel_shift(torch.einsum("bqhd,khd->bhqk", q + r_r_bias,
                                    r_head_k))
        score = (ac + bd) * (1.0 / self.d_head ** 0.5)
        if attn_mask is not None:
            score = score.masked_fill(attn_mask.bool()[:, None], -INF)
        prob = torch.softmax(score, dim=-1)
        vec = torch.einsum("bhqk,bkhd->bqhd", prob, v).reshape(
            n, qlen, self.n_head * self.d_head)
        out = self.layer_norm(w + self.drop(self.o_net(vec)))
        return phase.Bracket.apply(out, "relattn_end", "relattn")


class RelPartialLearnableDecoderLayer(nn.Module):
    """Attention + FFN (reference :1040)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        d_head = cfg.hidden_size // cfg.num_attention_heads
        self.dec_attn = RelPartialLearnableMultiHeadAttn(
            cfg.num_attention_heads, cfg.hidden_size, d_head,
            cfg.hidden_dropout_prob)
        self.pos_ff = PositionwiseFF(cfg.hidden_size, cfg.hidden_size,
                                     cfg.hidden_dropout_prob)

    def forward(self, dec_inp, r, r_w_bias, r_r_bias, dec_attn_mask=None,
                mems=None) -> torch.Tensor:
        return self.pos_ff(self.dec_attn(dec_inp, r, r_w_bias, r_r_bias,
                                         attn_mask=dec_attn_mask,
                                         mems=mems))


class TransformerXLEncoder(nn.Module):
    """Layer stack threading per-layer memory (reference :1081)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.xl_grad = cfg.xl_grad
        self.hidden_size = cfg.hidden_size
        d_head = cfg.hidden_size // cfg.num_attention_heads
        self.r_w_bias = nn.Parameter(torch.zeros(cfg.num_attention_heads,
                                                 d_head))
        self.r_r_bias = nn.Parameter(torch.zeros(cfg.num_attention_heads,
                                                 d_head))
        self.layers = nn.ModuleList(RelPartialLearnableDecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.drop = Dropout(cfg.hidden_dropout_prob)

    def forward(self, mems: Optional[List[torch.Tensor]],
                raw_embeddings: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """mems: [(N, M, D)] * (n_layers + 1) or None (first step);
        attention_mask (N, L, M + L) with 1 = masked. Returns (the last
        layer's output, the new memories)."""
        qlen = raw_embeddings.shape[1]
        klen = qlen + (mems[0].shape[1] if mems is not None else 0)
        pos_seq = torch.arange(klen - 1, -1, -1.0, dtype=torch.float32,
                               device=raw_embeddings.device)
        pos_emb = self.drop(positional_embedding_xl(pos_seq,
                                                    self.hidden_size))
        core_out = self.drop(raw_embeddings)
        hids = [core_out]
        for i, layer in enumerate(self.layers):
            core_out = layer(core_out, pos_emb, self.r_w_bias,
                             self.r_r_bias, dec_attn_mask=attention_mask,
                             mems=None if mems is None else mems[i])
            hids.append(core_out)
        core_out = self.drop(core_out)
        if not self.xl_grad:
            hids = [h.detach() for h in hids]
        return core_out, hids


class TransformerXL(nn.Module):
    """The XL caption model (reference :1147). `generator` seeds the
    init."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        # positions come from the relative attention
        self.embeddings = BertEmbeddingsWithVideo(
            cfg, add_position_embeddings=False)
        self.encoder = TransformerXLEncoder(cfg)
        self.decoder = BertLMPredictionHead(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self, cfg.initializer_range, generator)
        with torch.no_grad():
            for bias in (self.encoder.r_w_bias, self.encoder.r_r_bias):
                bias.normal_(0.0, cfg.initializer_range, generator=generator)

    def make_mask(self, input_mask: torch.Tensor,
                  prev_seg_input_masks: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """(N, L, L) or (N, L, 2L) with 1 = masked (reference :1190)."""
        cfg = self.cfg
        mask = make_shifted_mask(input_mask, cfg.max_v_len, cfg.max_t_len) \
            * input_mask.float()[:, None]
        if prev_seg_input_masks is not None:
            mask = torch.cat([prev_seg_input_masks.float()[:, None, :]
                              .expand_as(mask), mask], dim=2)
        return 1.0 - mask

    def forward_step(self, prev_ms: Optional[List[torch.Tensor]],
                     input_ids: torch.Tensor, video_features: torch.Tensor,
                     token_type_ids: torch.Tensor, input_masks: torch.Tensor,
                     prev_masks: Optional[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                torch.Tensor]:
        """One sentence step, token types before masks (reference
        :1205): (memories, last output, prediction scores)."""
        emb = self.embeddings(input_ids, video_features, token_type_ids)
        last_out, new_ms = self.encoder(
            prev_ms, emb, self.make_mask(input_masks, prev_masks))
        return new_ms, last_out, self.decoder(last_out)

    def forward(self, input_ids_list: torch.Tensor,
                video_features_list: torch.Tensor,
                input_masks_list: torch.Tensor,
                token_type_ids_list: torch.Tensor,
                input_labels_list: torch.Tensor,
                token_counts: Optional[torch.Tensor] = None):
        """Stacked (S, N, L[, D]) steps, the teacher sentence's mask as
        the next step's previous mask: (caption loss, scores list);
        `token_counts` as the recurrent MART's."""
        prev_ms = None
        scores_list = []
        for idx in range(len(input_ids_list)):
            prev_masks = None if idx == 0 else input_masks_list[idx - 1]
            prev_ms, _, scores = self.forward_step(
                prev_ms, input_ids_list[idx], video_features_list[idx],
                token_type_ids_list[idx], input_masks_list[idx], prev_masks)
            scores_list.append(scores)
        loss = scores_list[0].new_zeros((), dtype=torch.float32)
        for idx, scores in enumerate(scores_list):
            loss = loss + compute_loss(
                self.cfg, scores, input_labels_list[idx],
                None if token_counts is None else token_counts[idx])
        return loss, scores_list
