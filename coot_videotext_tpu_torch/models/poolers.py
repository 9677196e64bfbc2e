"""
Sequence poolers: generalized attention pooling (GenPool) and the COOT
average pool.

Port of coot_videotext_tpu/models/poolers.py (reference
nntrainer/models/poolers.py):
    - GenPool (:38): per-head 2-layer MLP -> masked softmax over the
      sequence (fill -INF) -> weighted sum, always through kernel B2
      (ops/genpool.py), which in training mode also drops at the three
      sites of JAX GenPool :136-155. The head-stacked parameters keep the reference
      names and shapes (`genpool_w1_head` (heads, D, dh), ...).
    - MultiGenPool: only num_layers=1 is functional in the reference.
    - TemporalAvgPool ("avg_special", :184-215) ignores the mask and sums
      the rows whose index is below max(lengths), then divides by each
      length — the reference quirk, reproduced.
Mask convention: True = valid.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from coot_videotext_tpu_torch.models.configs import (
    ActivationConfig, PoolerConfig, PoolerConst)
from coot_videotext_tpu_torch.models.layers import init_weight_
from coot_videotext_tpu_torch.ops.genpool import genpool
from coot_videotext_tpu_torch.ops.philox import next_seed
from coot_videotext_tpu_torch.typext import INF


class GenPool(nn.Module):
    """Generalized pooling (reference poolers.py:111)."""

    def __init__(self, d_input: int, d_attn: int, num_heads: int,
                 activation_cfg: ActivationConfig,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = float(dropout)
        d_attn = d_attn if d_attn > 0 else d_input
        if d_attn % num_heads or d_input % num_heads:
            raise ValueError("GenPool dims must divide by num_heads")
        d_head = d_attn // num_heads
        d_head_out = d_input // num_heads
        self.act = activation_cfg.name
        self.genpool_w1_head = nn.Parameter(
            torch.zeros(num_heads, d_input, d_head))
        self.genpool_b1_head = nn.Parameter(torch.zeros(num_heads, d_head))
        self.genpool_w2_head = nn.Parameter(
            torch.zeros(num_heads, d_head, d_head_out))
        self.genpool_b2_head = nn.Parameter(
            torch.zeros(num_heads, d_head_out))

    def reset_with(self, init_type: str, init_std: float,
                   generator: Optional[torch.Generator]) -> None:
        for p in self.parameters():
            init_weight_(p, init_type, init_std, generator)

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        return genpool(features, mask, self.genpool_w1_head,
                       self.genpool_b1_head, self.genpool_w2_head,
                       self.genpool_b2_head, self.act, rate,
                       next_seed() if rate > 0 else 0)


class MultiGenPool(nn.Module):
    """Stacked GenPool (reference poolers.py:84). Only 1 layer works."""

    def __init__(self, cfg: PoolerConfig, d_input: int) -> None:
        super().__init__()
        if cfg.num_layers != 1:
            raise ValueError(
                "MultiGenPool >1 layer is nonfunctional in the reference "
                "(each pool output feeds the next pool); all configs use 1.")
        self.pools = nn.ModuleList([GenPool(
            d_input, cfg.hidden_dim, cfg.num_heads, cfg.activation,
            cfg.dropout)])

    def forward(self, features, mask, lengths):
        return self.pools[0](features, mask, lengths)


class TemporalAvgPool(nn.Module):
    """The reference's 'avg_special' pool (poolers.py:232): sums the rows
    with index < max(lengths), padded positions included, and divides by
    the valid length; the mask is deliberately not used."""

    def forward(self, features, mask, lengths):
        batch_max = lengths.max()
        in_ref_rows = torch.arange(features.shape[1],
                                   device=features.device) < batch_max
        summed = (features * in_ref_rows[None, :, None].to(features.dtype)
                  ).sum(dim=1)
        return summed / torch.clamp(
            lengths.to(features.dtype)[:, None], min=1.0)


class TemporalAvgPoolMasked(nn.Module):
    """Masked mean (reference TemporalAvgPoolFixed poolers.py:244)."""

    def forward(self, features, mask, lengths):
        valid = mask.to(features.dtype)[:, :, None]
        summed = (features * valid).sum(dim=1)
        return summed / torch.clamp(
            lengths.to(features.dtype)[:, None], min=1.0)


class TemporalMaxPool(nn.Module):
    """Masked max over the sequence (reference poolers.py:211)."""

    def forward(self, features, mask, lengths):
        filled = torch.where(mask.bool()[:, :, None], features,
                             torch.full_like(features, -INF))
        return filled.max(dim=1).values


class TemporalLastPool(nn.Module):
    """Last valid element (reference poolers.py 'last')."""

    def forward(self, features, mask, lengths):
        idx = torch.clamp(lengths.long() - 1, min=0)
        return features[torch.arange(features.shape[0],
                                     device=features.device), idx]


class TemporalFirstPool(nn.Module):
    """First element, e.g. CLS (reference poolers.py 'first')."""

    def forward(self, features, mask, lengths):
        return features[:, 0]


def make_pooler(cfg: PoolerConfig, d_input: int) -> nn.Module:
    """Pooler factory (reference poolers.py:24 make_pooler_module)."""
    if cfg.name == PoolerConst.ATN:
        return MultiGenPool(cfg, d_input)
    simple = {PoolerConst.AVG_SPECIAL: TemporalAvgPool,
              PoolerConst.MAX: TemporalMaxPool,
              PoolerConst.AVG: TemporalAvgPoolMasked,
              PoolerConst.LAST: TemporalLastPool,
              PoolerConst.FIRST: TemporalFirstPool}
    if cfg.name not in simple:
        raise ValueError(f"Unknown pooler {cfg.name}")
    return simple[cfg.name]()
