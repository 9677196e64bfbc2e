"""
Masked multi-head attention and the post-LN transformer encoder/decoder
stacks.

Port of coot_videotext_tpu/models/attention.py (reference
transformer_legacy.py:347-605):
    - explicit q/k/v/final projections (all d_model -> d_model)
    - scores * 1/sqrt(d_head), masked keys filled with -INF (= -32752, the
      fp16-safe constant) before a float32 softmax; the attention core
      always goes through kernel B3 (ops/attention.py), which takes the
      (B, Lk) key mask the COOT stacks use
    - post-LN residual sublayers: LN(residual + sublayer(x)) with the COOT
      layer-norm variant, the add and the norm one kernel on the card (B6,
      ops/coot_norm.py), an extra dropout between the attention and the
      FFN sublayer (JAX :253-254), dropout inside the FFN (:218, :224)
    - in training mode B3 also drops the attention probabilities (JAX
      :187-192), with its own seed per call
    - under tensor parallelism (parallel/tp.py) an attention block runs
      the rank's heads; the FFN and the norms stay replicated
Module names follow the reference state-dict keys
(`encoder_layers.<i>.self_attention_layer.sublayer.query_projection`, ...).
Mask convention: True = valid token.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from coot_videotext_tpu_torch.models.configs import TransformerEncoderConfig
from coot_videotext_tpu_torch.models.layers import (
    CootLayerNorm, Dropout, Linear, make_activation, make_normalization)
from coot_videotext_tpu_torch.ops.attention import masked_attention
from coot_videotext_tpu_torch.ops.philox import next_seed
from coot_videotext_tpu_torch.parallel.mesh import Mesh
from coot_videotext_tpu_torch.parallel.tp import copy_inputs, place_linear
from coot_videotext_tpu_torch.typext import INF


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Float32 softmax with the finite -INF fill on invalid positions
    (JAX masked_softmax :51, reference transformer_legacy.py:544)."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask.bool(), scores,
                             torch.full_like(scores, -INF))
    return torch.softmax(scores, dim=dim)


class MultiHeadAttention(nn.Module):
    """Multi-head attention (reference transformer_legacy.py:470). Under
    tensor parallelism (`place_tp`) it runs the rank's heads: q, k and v
    column-parallel, each distinct input through `copy_to_model`, B3 on
    num_heads / M heads with a seed of the rank's own, the final projection
    row-parallel."""

    def __init__(self, num_heads: int, d_model: int,
                 dropout: float = 0.0) -> None:
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.d_model = d_model
        self.dropout = float(dropout)
        self.query_projection = Linear(d_model, d_model)
        self.key_projection = Linear(d_model, d_model)
        self.value_projection = Linear(d_model, d_model)
        self.final_projection = Linear(d_model, d_model)
        self.tp: Optional[Mesh] = None

    def place_tp(self, mesh: Mesh, shards: Dict[str, int]):
        """Runs the rank's heads where q, k, v are sharded by output and
        the final projection by input and the heads split evenly; else
        leaves the Linears to gather their weights. Returns (the
        parameters placed, their partial gradients)."""
        qkv = [f"{p}_projection.weight" for p in ("query", "key", "value")]
        if (any(shards.get(n) != 0 for n in qkv)
                or shards.get("final_projection.weight") != 1
                or self.num_heads % mesh.model_world):
            return set(), set()
        self.tp = mesh
        partial = set()
        for p in ("query", "key", "value"):
            place_linear(getattr(self, f"{p}_projection"), "column", mesh, 0)
            partial.add(f"{p}_projection.bias")
        place_linear(self.final_projection, "row", mesh, 1)
        return set(qkv) | {"final_projection.weight"}, partial

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        """
        Args:
            query: (B, Lq, D); key/value: (B, Lk, D)
            key_valid: (B, Lk) key validity, True = attend (None: all keys)
        """
        b, lq, _ = query.shape
        lk = key.shape[1]
        h = self.num_heads
        dh = self.d_model // h
        if self.tp is not None:
            h //= self.tp.model_world
            query, key, value = copy_inputs(self.tp, query, key, value)

        def heads_first(x: torch.Tensor, length: int) -> torch.Tensor:
            return x.view(b, length, h, dh).transpose(1, 2).reshape(
                b * h, length, dh)

        q = heads_first(self.query_projection(query), lq)
        k = heads_first(self.key_projection(key), lk)
        v = heads_first(self.value_projection(value), lk)
        if key_valid is None:
            key_valid = torch.ones((b, lk), dtype=torch.bool,
                                   device=query.device)
        rate = self.dropout if self.training else 0.0
        seed = next_seed(self.tp is not None) if rate > 0 else None
        ctx = masked_attention(q, k, v, key_valid, h, 1.0 / math.sqrt(dh),
                               rate, seed)
        ctx = ctx.view(b, h, lq, dh).transpose(1, 2).reshape(b, lq, h * dh)
        return self.final_projection(ctx)


class PointwiseFeedForward(nn.Module):
    """FFN: Linear-Dropout-Act-Linear-Dropout (reference :582); the
    Linears keep the reference indices 0 and 3."""

    def __init__(self, d_model: int, d_ff: int,
                 cfg: TransformerEncoderConfig) -> None:
        super().__init__()
        d_ff = d_ff if d_ff > 0 else d_model
        self.feed_forward = nn.Sequential(
            Linear(d_model, d_ff), Dropout(cfg.dropout),
            make_activation(cfg.activation), Linear(d_ff, d_model),
            Dropout(cfg.dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feed_forward(x)


class _Sublayer(nn.Module):
    """Reference sublayer wrapper: `sublayer` + `layer_normalization`."""

    def __init__(self, sublayer: nn.Module,
                 norm: Optional[nn.Module]) -> None:
        super().__init__()
        self.sublayer = sublayer
        self.layer_normalization = norm

    def norm(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """LN(x + residual); a COOT norm takes the add into its kernel."""
        norm = self.layer_normalization
        if isinstance(norm, CootLayerNorm):
            return norm(x, residual)
        x = x + residual
        return x if norm is None else norm(x)


class TransformerEncoderLayer(nn.Module):
    """
    Post-LN encoder layer (reference :396-438): x = LN(x + attn(x)); then
    an extra dropout; then x = LN(x + ffn(x)).
    """

    def __init__(self, cfg: TransformerEncoderConfig) -> None:
        super().__init__()
        d = cfg.hidden_dim
        self.self_attention_layer = _Sublayer(
            MultiHeadAttention(cfg.num_heads, d, cfg.dropout),
            make_normalization(cfg.norm, cfg.norm.name, d))
        self.dropout = Dropout(cfg.dropout)
        self.pointwise_feedforward_layer = _Sublayer(
            PointwiseFeedForward(d, cfg.pointwise_ff_dim, cfg),
            make_normalization(cfg.norm, cfg.norm.name, d))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        attn = self.self_attention_layer
        x = attn.norm(attn.sublayer(query, key, value, key_valid), query)
        x = self.dropout(x)
        ffn = self.pointwise_feedforward_layer
        return ffn.norm(ffn.sublayer(x), x)


class TransformerEncoder(nn.Module):
    """Self-attention stack (reference :347-367); key-only masking."""

    def __init__(self, cfg: TransformerEncoderConfig) -> None:
        super().__init__()
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        for layer in self.encoder_layers:
            x = layer(x, x, x, key_valid)
        return x


class TransformerDecoder(nn.Module):
    """Cross-attention stack: query attends to key_value (reference
    :369)."""

    def __init__(self, cfg: TransformerEncoderConfig) -> None:
        super().__init__()
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        x = query
        for layer in self.encoder_layers:
            x = layer(x, key_value, key_value, key_valid)
        return x
