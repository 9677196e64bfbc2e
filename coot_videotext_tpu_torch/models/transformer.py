"""
The COOT building block: one configurable transformer network
(input norm + FC -> positional encoding -> self-attention -> optional
cross-attention with a global context query -> pooling), instantiated four
times by the retrieval model.

Port of coot_videotext_tpu/models/transformer.py::CootTransformer :82
(reference transformer_legacy.py:115-288, forward :200). A local net whose
input is pipeline data (`input_is_data`) and whose input stage has the
shape of every shipped config (layernorm_coot, no input dropout, one FC
layer with gelu/none and no residual or output norm; JAX
`_fused_input_act` :105-133) runs norm + FC + activation through kernel B1
(ops/input_fc.py), on the detached input: the kernel forms no input
gradient (JAX :181 `stop_gradient`); under tensor parallelism it runs on
the rank's output columns (`place_tp`). Everything else here is plain
PyTorch: the global nets'
input norm, the positional encoding, the cross-attention with the context
vector as a length-1 query (:219-227) and the output heads; attention and
GenPool go through kernels B3 and B2 inside their modules.
Returns (pooled, seq_features). Mask convention: True = valid.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from coot_videotext_tpu_torch.models.attention import (
    TransformerDecoder, TransformerEncoder)
from coot_videotext_tpu_torch.models.configs import (
    ActivationConst, NormalizationConst, PositionalEncodingConst,
    ResidualsEnum, TransformerConfig, TransformerTypesConst)
from coot_videotext_tpu_torch.models.layers import (
    MLP, CootLayerNorm, Dropout, LearnableClsToken, Linear,
    PositionalEncodingSinCos, init_weight_, make_normalization)
from coot_videotext_tpu_torch.models.poolers import GenPool, make_pooler
from coot_videotext_tpu_torch.ops.input_fc import fused_input_fc
from coot_videotext_tpu_torch.parallel.mesh import Mesh
from coot_videotext_tpu_torch.parallel.tp import (
    gather_from_model, shard_slice)


def fused_input_act(cfg: TransformerConfig) -> Optional[str]:
    """"gelu"/"none" when the input norm + FC has the shape kernel B1
    implements (JAX _fused_input_act :105 without its TPU gates), else
    None."""
    if (cfg.norm_input != NormalizationConst.LAYERNORM_COOT
            or not cfg.use_input_fc or cfg.dropout_input > 0):
        return None
    fc = cfg.input_fc_config
    if (fc.num_layers != 1 or fc.dropout_output > 0
            or fc.residual != ResidualsEnum.NONE
            or fc.norm_output.name != NormalizationConst.NONE
            or fc.activation_output.name not in
            (ActivationConst.GELU, ActivationConst.NONE)):
        return None
    return ("gelu" if fc.activation_output.name == ActivationConst.GELU
            else "none")


class CootTransformer(nn.Module):
    """One COOT network (reference TransformerLegacy).

    input_is_data: the features passed in are pipeline data, never
    differentiated; only then does the input stage take kernel B1. The
    retrieval model sets it for its local nets only.
    """

    def __init__(self, cfg: TransformerConfig, input_dim: int, *,
                 max_len: int = 1024, input_is_data: bool = False) -> None:
        super().__init__()
        if cfg.name != TransformerTypesConst.TRANSFORMER_LEGACY:
            raise ValueError(f"Unsupported network type {cfg.name}")
        self.cfg = cfg
        d_model = cfg.selfatn.hidden_dim
        self.dropout_input = Dropout(cfg.dropout_input)
        self.norm_input = make_normalization(None, cfg.norm_input,
                                             input_dim)
        if cfg.use_input_fc:
            self.input_fc = MLP(cfg.input_fc_config, input_dim)
        self.fused_act = fused_input_act(cfg) if input_is_data else None
        self.tp: Optional[Mesh] = None
        if cfg.add_local_cls_token:
            self.net_cls = LearnableClsToken(d_model)
        if cfg.positional_encoding == PositionalEncodingConst.SINCOS:
            self.embedding = PositionalEncodingSinCos(d_model, max_len,
                                                      cfg.dropout_input)
        elif cfg.positional_encoding != PositionalEncodingConst.NONE:
            raise ValueError(
                f"Unknown positional encoding {cfg.positional_encoding}")
        self.tf = TransformerEncoder(cfg.selfatn)
        pooled_dim = d_model
        if cfg.use_context:
            self.tf_context = TransformerDecoder(cfg.crossatn)
            pooled_dim += cfg.crossatn.hidden_dim
        self.pooler = make_pooler(cfg.pooler_config, d_model)
        if cfg.use_output_fc:
            self.output_fc = MLP(cfg.output_fc_config, pooled_dim)
            pooled_dim = cfg.output_fc_config.output_dim
        if cfg.linear_out:
            self.linear_out = Linear(pooled_dim, pooled_dim)

    def place_tp(self, mesh: Mesh, shards: Dict[str, int]):
        """Under tensor parallelism the fused input stage runs B1
        column-parallel: the rank's rows of the FC weight and its slice of
        the bias, the norm over the whole input on every rank, the output
        columns gathered before the encoder. The kernel's dgain and dbias
        are then sums over the rank's columns. Returns (the parameters
        placed, their partial gradients); an input stage that is not fused
        leaves its Linears to gather their weights."""
        if self.fused_act is None or shards.get("input_fc.mlp.0.weight") != 0:
            return set(), set()
        self.tp = mesh
        return ({"input_fc.mlp.0.weight"},
                {"input_fc.mlp.0.bias", "norm_input.gain", "norm_input.bias"})

    @property
    def output_dim(self) -> int:
        """Pooled output dim incl. cross-attn concat (reference
        :186-198)."""
        out = self.cfg.output_dim
        if self.cfg.use_context:
            out += self.cfg.crossatn.hidden_dim
        return out

    def reset_parameters(self, generator: Optional[torch.Generator]
                         ) -> None:
        """Seeded init mirroring the JAX initializers: every Linear and
        GenPool tensor from the net's weight init, norms 1/0, the CLS token
        from its own init."""
        init_type, init_std = self.cfg.weight_init_type, \
            self.cfg.weight_init_std
        for module in self.modules():
            if isinstance(module, (Linear, GenPool)):
                module.reset_with(init_type, init_std, generator)
            elif isinstance(module, CootLayerNorm):
                nn.init.ones_(module.gain)
                nn.init.zeros_(module.bias)
        if self.cfg.add_local_cls_token:
            init_weight_(self.net_cls.cls_param,
                         self.cfg.local_cls_token_init_type,
                         self.cfg.local_cls_token_init_std, generator)

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                lengths: torch.Tensor,
                hidden_state: Optional[torch.Tensor] = None,
                max_length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        Args:
            features: (B, L, D_in) in the compute dtype
            mask: validity mask (B, L); True = real token
            lengths: (B,)
            hidden_state: optional context vector (B, D_ctx) for cross-attn
            max_length: the longest of `lengths` over the global batch
                under data parallelism (the avg_special pool reads it);
                None: max(lengths)

        Returns:
            (pooled (B, output_dim), seq_features (B, L[+1], hidden))
        """
        cfg = self.cfg
        x = features
        if self.fused_act is not None:
            bsz, seq, din = x.shape
            fc = self.input_fc.mlp[0]
            bias = fc.bias
            if self.tp is not None:  # the rank's output columns
                bias = bias.narrow(0, *shard_slice(self.tp, bias.shape[0]))
            x = fused_input_fc(
                x.detach().reshape(bsz * seq, din), self.norm_input.gain,
                self.norm_input.bias, fc.weight, bias,
                self.norm_input.eps, self.fused_act).view(bsz, seq, -1)
            if self.tp is not None:
                x = gather_from_model(x, self.tp, -1)
        else:
            x = self.dropout_input(x)
            if self.norm_input is not None:
                x = self.norm_input(x)
            if cfg.use_input_fc:
                x = self.input_fc(x)

        if cfg.add_local_cls_token:
            x, mask, lengths = self.net_cls(x, mask, lengths)
            if max_length is not None:
                max_length = max_length + 1
        if cfg.positional_encoding == PositionalEncodingConst.SINCOS:
            x = self.embedding(x)

        x = self.tf(x, mask)

        add_after_pool = None
        if cfg.use_context:
            if hidden_state is None:
                raise ValueError(
                    "use_context network needs a hidden_state query")
            query = hidden_state.to(x.dtype)[:, None, :]
            add_after_pool = self.tf_context(query, x, mask)[:, 0]

        pooled = self.pooler(x, mask, lengths, max_length)
        if add_after_pool is not None:
            pooled = torch.cat([pooled, add_after_pool], dim=-1)
        if cfg.use_output_fc:
            pooled = self.output_fc(pooled)
        if cfg.linear_out:
            pooled = self.linear_out(pooled)
        return pooled, x
