"""
BERT-style building blocks of the MART caption model family.

Port of coot_videotext_tpu/models/caption/bert.py (reference mart/model.py):
    - TF-style LayerNorm (biased variance, eps inside sqrt, :147) ==
      nn.LayerNorm with the same eps.
    - additive attention mask (1-mask)*-10000 (:198), not the -INF fill of
      the COOT side; scores in f32 from torch.matmul (the JAX package's
      einsum_f32), no fused attention kernel, so masked rows match JAX.
    - exact-erf gelu (:97), sincos PositionEncoding added to the summed
      embeddings (:108), video+word+token-type embedding sum (:458),
      prediction head (:802), its decoder matrix tied to the word
      embeddings under share_wd_cls_weight.
    - shifted masks: video prefix fully visible, text suffix causal,
      memory prefix visible (make_shifted_mask :286, make_pad_shifted_mask
      :316).
    - memory: masked mean-pool init with learned bias (:724), GRU-style
      z/c-gated update from attention over states (:751).
    - the joint single-sentence encoder without memory (BertLayerNoMemory,
      BertEncoderNoMemory, reference :334-382).

Module and parameter names are the reference torch MART keys (what the JAX
package's utils/torch_convert.py::_convert_mart_key reads), so a reference
`{"model": state_dict}` loads as it is. Dropout sites use the port's
`models/layers.Dropout` (identity in eval). Init: weights normal(0,
initializer_range), biases zero, LN ones/zeros (reference
init_bert_weights :1401-1413).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.models.layers import Dropout


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf gelu (reference model.py:97)."""
    return F.gelu(x, approximate="none")


def positional_encoding_table(max_len: int, dim: int) -> np.ndarray:
    """Sincos table (reference PositionEncoding :108-131)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def bert_layernorm(cfg, dim: int) -> nn.LayerNorm:
    """TF-style LayerNorm (reference BertLayerNorm :147)."""
    return nn.LayerNorm(dim, eps=cfg.layer_norm_eps)


# ---------- masks ----------

def make_shifted_mask(input_mask: torch.Tensor, max_v_len: int,
                      max_t_len: int, memory_len: int = 0) -> torch.Tensor:
    """(N, L) -> (N, max_v_len+max_t_len, M+L) float mask: memory+video
    columns always visible, text columns causal (reference :286)."""
    bsz, seq_len = input_mask.shape
    assert max_v_len + max_t_len + memory_len == seq_len
    n_rows = max_v_len + max_t_len
    row = torch.arange(n_rows, device=input_mask.device)[:, None]
    col = torch.arange(seq_len, device=input_mask.device)[None, :]
    always = col < memory_len + max_v_len
    # causal among text: row i (i >= max_v_len) sees text cols j with
    # j - (memory_len + max_v_len) <= i - max_v_len
    causal = (row >= max_v_len) & (col - memory_len <= row)
    mask = (always | causal).float()
    return mask[None].expand(bsz, n_rows, seq_len)


def make_pad_shifted_mask(input_mask: torch.Tensor, max_v_len: int,
                          max_t_len: int, memory_len: int = 0
                          ) -> torch.Tensor:
    """Shifted mask * padding mask (reference :316)."""
    shifted = make_shifted_mask(input_mask, max_v_len, max_t_len,
                                memory_len=memory_len)
    return shifted * input_mask.float()[:, None, :]


def make_video_only_mask(input_mask: torch.Tensor,
                         max_v_len: int) -> torch.Tensor:
    """Zero out the text suffix (reference :323)."""
    col = torch.arange(input_mask.shape[1], device=input_mask.device)
    return torch.where(col[None, :] < max_v_len, input_mask,
                       torch.zeros_like(input_mask))


# ---------- attention ----------

class BertSelfAttention(nn.Module):
    """Multi-head attention with additive -10000 mask (reference :164)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        assert cfg.hidden_size % cfg.num_attention_heads == 0
        self.n_heads = cfg.num_attention_heads
        self.d_head = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        return x.view(b, length, self.n_heads, self.d_head).transpose(1, 2)

    def forward(self, query_states: torch.Tensor, key_states: torch.Tensor,
                value_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """query_states (N, Lq, D), key/value_states (N, L, D),
        attention_mask (N, Lq, L) with 1 = attend."""
        add_mask = (1.0 - attention_mask.float()[:, None]) * -10000.0
        q = self._heads(self.query(query_states))
        k = self._heads(self.key(key_states))
        v = self._heads(self.value(value_states))
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores / math.sqrt(self.d_head) + add_mask
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(probs, v).transpose(1, 2)
        return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


class BertSelfOutput(nn.Module):
    """Dense -> dropout -> residual LN (reference :230)."""

    def __init__(self, cfg, in_size: Optional[int] = None) -> None:
        super().__init__()
        self.dense = nn.Linear(in_size or cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden_states: torch.Tensor,
                input_tensor: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.dense(hidden_states))
        return self.LayerNorm(h + input_tensor)


class BertAttention(nn.Module):
    """Self-attention block (reference :240)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, input_tensor: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self_out = self.self(input_tensor, input_tensor, input_tensor,
                             attention_mask)
        return self.output(self_out, input_tensor)


class BertIntermediate(nn.Module):
    """Dense + gelu (reference :259)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return gelu(self.dense(hidden_states))


class BertOutput(BertSelfOutput):
    """Dense -> dropout -> residual LN back to hidden (reference :271)."""

    def __init__(self, cfg) -> None:
        super().__init__(cfg, in_size=cfg.intermediate_size)


# ---------- memory ----------

class MemoryInitializer(nn.Module):
    """Masked mean-pool + learned bias -> FC (reference :724)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.n_memory_cells = cfg.n_memory_cells
        self.init_memory_bias = nn.Parameter(
            torch.zeros(1, cfg.n_memory_cells, 1))
        self.init_memory_fc = nn.Sequential(
            nn.Linear(cfg.hidden_size, cfg.hidden_size),
            bert_layernorm(cfg, cfg.hidden_size),
            Dropout(cfg.memory_dropout_prob))

    def forward(self, input_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        mask = attention_mask.float()
        pooled = (input_states * mask[:, :, None]).sum(dim=1)
        pooled = pooled / mask.sum(dim=1, keepdim=True)
        pooled = pooled[:, None].repeat(1, self.n_memory_cells, 1)
        return self.init_memory_fc(pooled + self.init_memory_bias)


class MemoryUpdater(nn.Module):
    """Attention over states + GRU-style z/c gates (reference :751)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.memory_update_attention = BertSelfAttention(cfg)
        d = cfg.hidden_size
        self.mc = nn.Linear(d, d, bias=False)
        self.sc = nn.Linear(d, d)
        self.mz = nn.Linear(d, d, bias=False)
        self.sz = nn.Linear(d, d)

    def forward(self, prev_m: torch.Tensor, input_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        n_cells = prev_m.shape[1]
        update_mask = attention_mask.float()[:, None].repeat(1, n_cells, 1)
        s_t = self.memory_update_attention(prev_m, input_states,
                                           input_states, update_mask)
        c_t = torch.tanh(self.mc(prev_m) + self.sc(s_t))
        z_t = torch.sigmoid(self.mz(prev_m) + self.sz(s_t))
        return (1 - z_t) * c_t + z_t * prev_m


# ---------- layers / encoders ----------

class BertLayerNoMemory(nn.Module):
    """Plain joint-sequence layer (reference :334)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.max_v_len = cfg.max_v_len
        self.max_t_len = cfg.max_t_len
        self.attention = BertAttention(cfg)
        self.hidden_intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        shifted = make_pad_shifted_mask(attention_mask, self.max_v_len,
                                        self.max_t_len)
        att = self.attention(hidden_states, shifted)
        return self.output(self.hidden_intermediate(att), att)


class BertEncoderNoMemory(nn.Module):
    """Stack of no-memory layers (reference :359)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayerNoMemory(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            hidden_states = layer(hidden_states, attention_mask)
        return hidden_states


class BertLayerWithMemory(nn.Module):
    """Memory-augmented layer (reference :383)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        # the memory attention reads the intermediate states with
        # hidden-wide projections (as the reference does)
        assert cfg.intermediate_size == cfg.hidden_size, (
            "the memory layer needs intermediate_size == hidden_size")
        self.max_v_len = cfg.max_v_len
        self.max_t_len = cfg.max_t_len
        self.attention = BertAttention(cfg)
        self.memory_initilizer = MemoryInitializer(cfg)
        self.memory_updater = MemoryUpdater(cfg)
        self.memory_augmented_attention = BertSelfAttention(cfg)
        self.hidden_intermediate = BertIntermediate(cfg)
        self.memory_projection = nn.Linear(cfg.hidden_size,
                                           cfg.hidden_size)
        self.output = BertOutput(cfg)

    def forward(self, prev_m: Optional[torch.Tensor],
                hidden_states: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        shifted = make_pad_shifted_mask(attention_mask, self.max_v_len,
                                        self.max_t_len)
        att = self.attention(hidden_states, shifted)
        inter = self.hidden_intermediate(att)
        if prev_m is None:
            # first step: init memory from the video part only (:399-402)
            prev_m = self.memory_initilizer(
                inter, make_video_only_mask(attention_mask,
                                            self.max_v_len))
        updated_m = self.memory_updater(prev_m, inter, attention_mask)

        concat_mh = torch.cat([prev_m, inter], dim=1)
        bsz, n_cells = prev_m.shape[:2]
        raw_mask = torch.cat([attention_mask.new_ones(bsz, n_cells),
                              attention_mask], dim=-1)
        mem_mask = make_pad_shifted_mask(raw_mask, self.max_v_len,
                                         self.max_t_len, memory_len=n_cells)
        mem_att = self.memory_augmented_attention(inter, concat_mh,
                                                  concat_mh, mem_mask)
        layer_out = self.output(self.memory_projection(mem_att), att)
        return updated_m, layer_out


class BertEncoderWithMemory(nn.Module):
    """Stack of memory layers threading per-layer memory (reference
    :433)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayerWithMemory(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, prev_ms: List[Optional[torch.Tensor]],
                hidden_states: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        prev_ms = list(prev_ms)
        for i, layer in enumerate(self.layer):
            prev_ms[i], hidden_states = layer(prev_ms[i], hidden_states,
                                              attention_mask)
        return prev_ms, hidden_states


# ---------- embeddings / head ----------

def _embedding_stack(cfg, in_size: int) -> nn.Sequential:
    """LN -> dropout -> Linear -> ReLU -> LN (reference :474-487)."""
    return nn.Sequential(
        bert_layernorm(cfg, in_size), Dropout(cfg.hidden_dropout_prob),
        nn.Linear(in_size, cfg.hidden_size), nn.ReLU(True),
        bert_layernorm(cfg, cfg.hidden_size))


class BertEmbeddingsWithVideo(nn.Module):
    """word + video + token-type embeddings summed, then PE + LN + dropout
    (reference :458); without the PE (`add_position_embeddings` false) for
    the TransformerXL, whose attention is relative."""

    def __init__(self, cfg, add_position_embeddings: bool = True) -> None:
        super().__init__()
        self.add_position_embeddings = add_position_embeddings
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.word_vec_size)
        self.word_fc = _embedding_stack(cfg, cfg.word_vec_size)
        self.video_embeddings = _embedding_stack(cfg,
                                                 cfg.video_feature_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        # the sincos table is not a parameter (the reference's `pe` buffer
        # is dropped when loading)
        self.register_buffer("position_table", torch.from_numpy(
            positional_encoding_table(cfg.max_position_embeddings,
                                      cfg.hidden_size)), persistent=False)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, video_features: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        w = self.word_fc(self.word_embeddings(input_ids))
        v = self.video_embeddings(video_features)
        t = self.token_type_embeddings(token_type_ids)
        emb = w + v + t
        if self.add_position_embeddings:
            emb = emb + self.position_table[:input_ids.shape[-1]][None]
        return self.dropout(self.LayerNorm(emb))


class BertPredictionHeadTransform(nn.Module):
    """Dense -> gelu -> LN (reference :790)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(gelu(self.dense(hidden_states)))


class BertLMPredictionHead(nn.Module):
    """Transform + decoder matrix + bias (reference :802). Under
    share_wd_cls_weight the decoder's weight IS the word-embedding matrix
    `word_embeddings` (one Parameter: it takes the gradient of both uses
    and is decayed and clipped once; the state dict keeps both reference
    keys), logits = transform(h) @ E^T + bias (JAX mart.py:42-46)."""

    def __init__(self, cfg, word_embeddings: Optional[nn.Embedding] = None
                 ) -> None:
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias=False)
        if cfg.share_wd_cls_weight:
            if word_embeddings is None:  # JAX asserts (bert.py:436)
                raise ValueError("share_wd_cls_weight ties the head to the "
                                 "word embeddings of the joint models; this "
                                 "model passes none")
            self.decoder.weight = word_embeddings.weight
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(hidden_states)) + self.bias


def init_bert_weights(module: nn.Module, std: float,
                      generator: torch.Generator) -> None:
    """Weights normal(0, std), biases zero, LN ones/zeros, memory bias
    normal(0, 1) (reference init_bert_weights :1401-1413)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MemoryInitializer):
                m.init_memory_bias.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, BertLMPredictionHead):
                m.bias.zero_()
