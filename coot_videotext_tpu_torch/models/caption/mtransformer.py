"""
The masked ("vanilla") transformer caption model, MTransformer:
Salesforce-densecap style, one sentence at a time in the untied layout
(video rows apart from the text), each encoder layer's output feeding the
matching decoder layer, the word embeddings tied to the output projection
scaled by sqrt(d).

Port of coot_videotext_tpu/models/caption/mtransformer.py (reference
mart/masked_transformer.py:1-281). Where a plain PyTorch idiom would give
another number:
    - MTLayerNorm (:44-60) divides by the Bessel-corrected std (ddof 1)
      plus eps, not by sqrt(var + eps): not nn.LayerNorm.
    - MTMultiHead (:63-95) has no projection bias and splits heads by
      chunking features; the causal form subtracts 1e10 on the strict upper
      triangle BEFORE dividing by sqrt(d_model) (= sqrt(d_head * n_heads),
      not sqrt(d_head)); dropout applies to the probabilities.
    - positional_encodings_like (:31-41): sin on even channels, cos on odd
      ones, the odd channel c at the rate of c - 1; encoder and decoder each
      count positions from 0.
    - the word vectors are `decoder.out.weight * sqrt(d)` (:219-223), so
      `out.weight` gets the gradient of both uses.
    - the encoder has no key mask: it multiplies by the video mask after
      the embedding and after every layer (:200-215).
Every dropout site is the port's models/layers.Dropout (kernel B4 on the
card). Module and parameter names are the reference torch keys
(`encoder.video_embeddings.{0,2}`, `encoder|decoder.layers.N.{selfattn,
attention,feedforward}.{layer,layernorm}...`, `decoder.out`), what the JAX
package's utils/torch_convert.py::_convert_mtrans_key reads. Init as the
JAX modules': lecun-normal weights (normal truncated at 2 std), zero
biases, LayerNorm gamma 1 and beta 0. float32 only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.models.configs import InitTypesConst
from coot_videotext_tpu_torch.models.layers import (
    Dropout, Linear, init_weight_)
from coot_videotext_tpu_torch.train.loss_caption import (
    cross_entropy_loss, label_smoothing_loss)

MT_INF = 1e10

_ENCODINGS: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def positional_encoding_table(length: int, d: int) -> np.ndarray:
    """(length, d) float32 per-channel sin/cos encodings (reference :28),
    the JAX package's numpy arithmetic."""
    positions = np.arange(length, dtype=np.float32)
    channels = np.arange(d)
    rates = 10000 ** (np.where(channels % 2 == 0, channels,
                               channels - 1) / d)
    angles = positions[:, None] / rates[None, :]
    return np.where(channels[None, :] % 2 == 0, np.sin(angles),
                    np.cos(angles)).astype(np.float32)


def positional_encodings_like(x: torch.Tensor) -> torch.Tensor:
    """The (L, D) encodings of x (..., L, D), on x's device (cached: no
    host-to-device copy per call)."""
    key = (x.shape[-2], x.shape[-1], x.device)
    if key not in _ENCODINGS:
        _ENCODINGS[key] = torch.from_numpy(
            positional_encoding_table(*key[:2])).to(x.device)
    return _ENCODINGS[key]


class MTLayerNorm(nn.Module):
    """gamma * (x - mean) / (std + eps) + beta, std with ddof 1 (reference
    :49)."""

    def __init__(self, d_model: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d_model))
        self.beta = nn.Parameter(torch.zeros(d_model))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        std = x.std(dim=-1, keepdim=True, unbiased=True)
        return self.gamma * (x - mean) / (std + self.eps) + self.beta


class MTMultiHead(nn.Module):
    """Multi-head attention by feature chunks, projections without bias
    (reference :94)."""

    def __init__(self, d_model: int, n_heads: int, drop_ratio: float,
                 causal: bool = False) -> None:
        super().__init__()
        self.wq = Linear(d_model, d_model, bias=False)
        self.wk = Linear(d_model, d_model, bias=False)
        self.wv = Linear(d_model, d_model, bias=False)
        self.wo = Linear(d_model, d_model, bias=False)
        self.dropout = Dropout(drop_ratio)
        self.d_model = d_model
        self.n_heads = n_heads
        self.causal = causal

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        b, lq, _ = query.shape
        lk = key.shape[1]
        d_head = self.d_model // self.n_heads

        def heads(x, length):  # (b, length, d) -> (b, h, length, d_head)
            return x.reshape(b, length, self.n_heads, d_head).transpose(1, 2)

        q = heads(self.wq(query), lq)
        k = heads(self.wk(key), lk)
        v = heads(self.wv(value), lk)
        dots = torch.matmul(q, k.transpose(-1, -2))
        if self.causal:
            tri = torch.triu(torch.full((lk, lk), MT_INF,
                                        device=dots.device), diagonal=1)
            dots = dots - tri
        # the reference scales AFTER the causal subtraction (:88-90)
        probs = self.dropout(torch.softmax(
            dots / math.sqrt(d_head * self.n_heads), dim=-1))
        out = torch.matmul(probs, v)
        return self.wo(out.transpose(1, 2).reshape(b, lq, self.d_model))


class MTFeedForward(nn.Module):
    def __init__(self, d_model: int, d_hidden: int) -> None:
        super().__init__()
        self.linear1 = Linear(d_model, d_hidden)
        self.linear2 = Linear(d_hidden, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class MTResidualBlock(nn.Module):
    """LN(x + dropout(layer(x, ...))) (reference :62)."""

    def __init__(self, layer: nn.Module, d_model: int,
                 drop_ratio: float) -> None:
        super().__init__()
        self.layer = layer
        self.dropout = Dropout(drop_ratio)
        self.layernorm = MTLayerNorm(d_model)

    def forward(self, *x: torch.Tensor) -> torch.Tensor:
        return self.layernorm(x[0] + self.dropout(self.layer(*x)))


class MTEncoderLayer(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        d, p = cfg.hidden_size, cfg.hidden_dropout_prob
        self.selfattn = MTResidualBlock(
            MTMultiHead(d, cfg.num_attention_heads, p), d, p)
        self.feedforward = MTResidualBlock(
            MTFeedForward(d, cfg.intermediate_size), d, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feedforward(self.selfattn(x, x, x))


class MTDecoderLayer(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        d, p = cfg.hidden_size, cfg.hidden_dropout_prob
        self.selfattn = MTResidualBlock(
            MTMultiHead(d, cfg.num_attention_heads, p, causal=True), d, p)
        self.attention = MTResidualBlock(
            MTMultiHead(d, cfg.num_attention_heads, p), d, p)
        self.feedforward = MTResidualBlock(
            MTFeedForward(d, cfg.intermediate_size), d, p)

    def forward(self, x: torch.Tensor, encoding: torch.Tensor
                ) -> torch.Tensor:
        x = self.selfattn(x, x, x)
        return self.feedforward(self.attention(x, encoding, encoding))


class MTEncoder(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        d = cfg.hidden_size
        self.video_embeddings = nn.Sequential(
            MTLayerNorm(cfg.video_feature_size),
            Dropout(cfg.hidden_dropout_prob),
            Linear(cfg.video_feature_size, d))
        self.layers = nn.ModuleList(
            [MTEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> List[torch.Tensor]:
        x = self.video_embeddings(x)
        x = self.dropout(x + positional_encodings_like(x))
        mask = mask[..., None]
        x = x * mask
        encodings = []
        for layer in self.layers:
            x = layer(x) * mask
            encodings.append(x)
        return encodings


class MTDecoder(nn.Module):
    def __init__(self, cfg) -> None:
        super().__init__()
        d = cfg.hidden_size
        self.layers = nn.ModuleList(
            [MTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.out = Linear(d, cfg.vocab_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.d_model = d

    def forward(self, ids: torch.Tensor, encodings: List[torch.Tensor]
                ) -> torch.Tensor:
        """The scores (N, T, vocab) of the text ids."""
        x = F.embedding(ids, self.out.weight * math.sqrt(self.d_model))
        x = self.dropout(x + positional_encodings_like(x))
        for layer, enc in zip(self.layers, encodings):
            x = layer(x, enc)
        return self.out(x)


class MTransformer(nn.Module):
    """The masked transformer (reference MTransformer :220). `generator`
    seeds the init."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        self.encoder = MTEncoder(cfg)
        self.decoder = MTDecoder(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, Linear):
                init_weight_(module.weight, InitTypesConst.NONE, 0.0,
                             generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)

    def encode(self, video_features: torch.Tensor,
               video_masks: torch.Tensor) -> List[torch.Tensor]:
        """Each encoder layer's output (N, V, D), masked."""
        return self.encoder(video_features, video_masks)

    def decode(self, text_input_ids: torch.Tensor,
               text_masks: Optional[torch.Tensor],
               text_input_labels: Optional[torch.Tensor],
               encodings: List[torch.Tensor],
               encoder_masks: Optional[torch.Tensor] = None,
               token_count: Optional[torch.Tensor] = None
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(loss or None without labels, scores (N, T, vocab)), in the
        untied model's argument order; the masks are not read: the
        decoder's self-attention is causal and the encodings are masked.
        `token_count`: the mean cross entropy's valid tokens over the
        global batch under data parallelism."""
        del text_masks, encoder_masks
        scores = self.decoder(text_input_ids, encodings)
        loss = None
        if text_input_labels is not None:
            if self.cfg.label_smoothing > 0:
                loss = label_smoothing_loss(scores, text_input_labels,
                                            self.cfg.label_smoothing,
                                            self.cfg.vocab_size)
            else:
                loss = cross_entropy_loss(scores, text_input_labels,
                                          count=token_count)
        return loss, scores

    def forward(self, video_features: torch.Tensor,
                video_masks: torch.Tensor, text_input_ids: torch.Tensor,
                text_masks: torch.Tensor,
                text_input_labels: Optional[torch.Tensor],
                token_count: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """The untied batch (JAX `_single_forward` argument order)."""
        return self.decode(text_input_ids, text_masks, text_input_labels,
                           self.encode(video_features, video_masks),
                           token_count=token_count)
