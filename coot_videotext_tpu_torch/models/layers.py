"""
Basic model layers: activations, normalizations (including the COOT
layer-norm variant), the compute-dtype Linear, MLP, sinusoidal positional
encoding, learnable CLS token and the weight initializers.

Port of coot_videotext_tpu/models/layers.py. Parameters are kept in float32;
the compute dtype follows the input (float32, or bfloat16 for the config's
fp16 paths): `Linear` casts its parameters to the input's dtype, and the
norms compute in float32 and return the input's dtype, as the JAX modules do
with `param_dtype=float32, dtype=<compute>`.

Numerical-parity notes (as in the JAX package):
    - `layernorm_coot` normalizes by the Bessel-corrected std (ddof=1) and
      adds eps to the *std*, not the variance; computed in float32 with
      shifted sums and a zero-variance guard (ops/coot_norm.py, with its
      kernel B6).
    - gelu is the exact erf form, not the tanh approximation.
    - sincos positional encoding uses the reference's divisor variant
      `10000 ** (2 * dim_idx / dim)`, not the textbook table.
    - truncnorm init resamples outside +-2 sigma for weights AND biases,
      while layer-norm gain/bias stay 1/0.
Dropout (JAX :38) is identity in eval mode and at rate 0; in training mode
it runs kernel B4 (ops/dropout.py) with the step's next seed
(ops/philox.py: `dropout_seeds`, `next_seed`). Its masks come from another
stream than JAX's; masks are not part of the parity contract (JAX :47-51).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.models.configs import (
    ActivationConfig, ActivationConst, InitTypesConst, MLPConfig,
    NormalizationConfig, NormalizationConst, ResidualsEnum)
from coot_videotext_tpu_torch.ops.coot_norm import coot_norm
from coot_videotext_tpu_torch.ops.dropout import dropout
from coot_videotext_tpu_torch.ops.philox import next_seed


# ---------- Dropout ----------

class Dropout(nn.Module):
    """Dropout with the module semantics of JAX models/layers.py:38:
    identity in eval mode or at rate 0, zeros at rate 1, else
    x * keep / (1 - rate) through kernel B4 with the step's next seed.
    `sharded`: its input is this rank's shard of a tensor split over the
    `model` axis (a rank's attention heads), which takes a seed of its own
    (ops/philox.py `next_seed`)."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = float(rate)
        self.sharded = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        return dropout(x, next_seed(self.sharded), self.rate)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


# ---------- Initializers ----------

def init_weight_(t: torch.Tensor, init_type: str, init_std: float,
                 generator: Optional[torch.Generator]) -> None:
    """Weight init from the reference init-type names (JAX
    make_initializer :85). `t` is a torch Linear weight (out, in)."""
    with torch.no_grad():
        if init_type == InitTypesConst.TRUNCNORM:
            nn.init.trunc_normal_(t, std=init_std, a=-2 * init_std,
                                  b=2 * init_std, generator=generator)
        elif init_type == InitTypesConst.NONE:
            fan_in = t.shape[-1] if t.dim() > 1 else t.shape[0]
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
        elif init_type == InitTypesConst.NORM:
            nn.init.xavier_normal_(t, generator=generator)
        elif init_type == InitTypesConst.UNIFORM:
            nn.init.xavier_uniform_(t, generator=generator)
        else:
            raise ValueError(f"Unknown init type {init_type}")


def init_bias_(t: torch.Tensor, init_type: str, init_std: float,
               generator: Optional[torch.Generator]) -> None:
    """Bias init: truncnorm like the weights for truncnorm, else zeros
    (JAX make_bias_initializer :103)."""
    with torch.no_grad():
        if init_type == InitTypesConst.TRUNCNORM:
            nn.init.trunc_normal_(t, std=init_std, a=-2 * init_std,
                                  b=2 * init_std, generator=generator)
        else:
            t.zero_()


class Linear(nn.Linear):
    """nn.Linear with float32 parameters that computes in the input's
    dtype (JAX nn.Dense with param_dtype=float32). `tp`: its placement
    under tensor parallelism (parallel/tp.py `LinearPlacement`: column,
    row or gathered), None when its weight is whole."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True) -> None:
        super().__init__(in_features, out_features, bias)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.linear(self, x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    def reset_with(self, init_type: str, init_std: float,
                   generator: Optional[torch.Generator]) -> None:
        init_weight_(self.weight, init_type, init_std, generator)
        if self.bias is not None:
            init_bias_(self.bias, init_type, init_std, generator)


# ---------- Activations ----------

def make_activation(cfg: ActivationConfig) -> nn.Module:
    """Activation factory (reference activations.py:13)."""
    name = cfg.name
    if name == ActivationConst.NONE:
        return nn.Identity()
    if name == ActivationConst.RELU:
        return nn.ReLU()
    if name == ActivationConst.GELU:
        return nn.GELU()  # exact erf form
    if name == ActivationConst.LEAKYRELU:
        return nn.LeakyReLU(negative_slope=cfg.negative_slope)
    raise ValueError(f"Unknown activation {name}")


# ---------- Normalizations ----------

class CootLayerNorm(nn.Module):
    """COOT layer normalization (reference normalizations.py:84-101);
    float32 internals, output in the input's dtype. A post-LN sublayer
    passes its residual, which is added to x first (rounded to x's dtype):
    on the card the add and the norm are one kernel, B6
    (ops/coot_norm.py)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.gain = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            residual = residual.contiguous()
        return coot_norm(x.contiguous(), residual, self.gain, self.bias,
                         self.eps)


class TorchLayerNorm(nn.Module):
    """Standard LayerNorm (reference `layernorm_pytorch`), float32
    internals, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 affine: bool = True) -> None:
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias,
                           self.eps)
        return out.to(x.dtype)


def make_normalization(cfg: Optional[NormalizationConfig], name: str,
                       dim: int) -> Optional[nn.Module]:
    """Normalization factory (reference normalizations.py:15)."""
    if cfg is None:
        cfg = NormalizationConfig(name)
    if name == NormalizationConst.NONE:
        return None
    if name == NormalizationConst.LAYERNORM_COOT:
        return CootLayerNorm(dim, eps=cfg.eps)
    if name == NormalizationConst.LAYERNORM_PYTORCH:
        return TorchLayerNorm(dim, eps=cfg.eps, affine=cfg.affine)
    raise NotImplementedError(f"Normalization {name} not found.")


# ---------- Positional encoding ----------

def sincos_positional_encoding(max_len: int, dim: int) -> torch.Tensor:
    """
    Reference-variant sinusoidal table (encoder.py:84-90):
        div = 10000 ** (2 * arange(dim) / dim)
        pe[:, 0::2] = sin(pos / div[0::2]); pe[:, 1::2] = cos(pos / div[1::2])
    """
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    dimension = torch.arange(dim, dtype=torch.float32)
    div_term = torch.pow(torch.tensor(10000.0), 2.0 * dimension / dim)
    angles = position / div_term[None, :]
    pe = torch.zeros((max_len, dim), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angles[:, 0::2])
    pe[:, 1::2] = torch.cos(angles[:, 1::2])
    return pe


class PositionalEncodingSinCos(nn.Module):
    """Additive sincos positional encoding (reference encoder.py:66). The
    table is a non-persistent buffer: it is not a parameter, and the
    reference checkpoints' `embedding.pe` entry is dropped on load."""

    def __init__(self, dim: int, max_len: int = 1000,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.register_buffer("pe", sincos_positional_encoding(max_len, dim),
                             persistent=False)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, :x.shape[1], :].to(x.dtype))


# ---------- MLP ----------

class MLP(nn.Module):
    """
    Configurable FC stack with optional residual (reference mlp.py:46-165),
    the layer order of the JAX MLP :254. `mlp` holds the Linears and norms
    in forward order (the reference checkpoint keys `mlp.<i>.*`; the
    single-layer input FC of every shipped config is `mlp.0`).
    """

    def __init__(self, cfg: MLPConfig, input_dim: int) -> None:
        super().__init__()
        if cfg.num_layers < 1:
            raise ValueError("MLP with 0 layers")
        self.cfg = cfg
        self.act_middle = make_activation(cfg.activation_middle)
        self.act_output = make_activation(cfg.activation_output)
        layers: List[nn.Module] = []
        # (kind, index into `layers`) in forward order
        self._plan: List[Tuple[str, int]] = []

        def add(kind: str, module: nn.Module) -> None:
            self._plan.append((kind, len(layers)))
            layers.append(module)

        self.drop_middle = Dropout(cfg.dropout_middle)
        self.drop_output = Dropout(cfg.dropout_output)
        if cfg.num_layers == 1:
            add("fc", Linear(input_dim, cfg.output_dim))
            self._plan.append(("drop_output", -1))
        else:
            dims = [input_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            for n in range(cfg.num_layers - 1):
                if n > 0:
                    self._plan.append(("act", -1))
                add("fc", Linear(dims[n], cfg.hidden_dim))
                self._plan.append(("drop_middle", -1))
                norm = make_normalization(cfg.norm_middle,
                                          cfg.norm_middle.name,
                                          cfg.hidden_dim)
                if norm is not None:
                    add("norm", norm)
            self._plan.append(("act", -1))
            add("fc", Linear(cfg.hidden_dim, cfg.output_dim))
            self._plan.append(("drop_output", -1))
        norm_out = make_normalization(cfg.norm_output, cfg.norm_output.name,
                                      cfg.output_dim)
        self._norm_out_idx = None
        if norm_out is not None:
            self._norm_out_idx = len(layers)
            layers.append(norm_out)
        self.mlp = nn.Sequential(*layers)
        if cfg.residual == ResidualsEnum.LINEAR:
            self.residual = Linear(input_dim, cfg.output_dim)
        elif cfg.residual not in (ResidualsEnum.NONE,
                                  ResidualsEnum.PASSTHROUGH):
            raise ValueError(f"Unknown residual {cfg.residual}")

    def reset_with(self, init_type: str, init_std: float,
                   generator: Optional[torch.Generator]) -> None:
        for module in self.modules():
            if isinstance(module, Linear):
                module.reset_with(init_type, init_std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for kind, idx in self._plan:
            if kind == "act":
                if self.cfg.activation_middle.name != ActivationConst.NONE:
                    x = self.act_middle(x)
            elif kind in ("drop_middle", "drop_output"):
                x = getattr(self, kind)(x)
            else:
                x = self.mlp[idx](x)
        if self.cfg.residual == ResidualsEnum.PASSTHROUGH:
            x = x + inp
        elif self.cfg.residual == ResidualsEnum.LINEAR:
            x = x + self.residual(inp)
        x = self.act_output(x)
        if self._norm_out_idx is not None:
            x = self.mlp[self._norm_out_idx](x)
        return x


# ---------- CLS token ----------

class LearnableClsToken(nn.Module):
    """
    Prepend a learnable CLS token to the sequence; extends the valid mask
    and lengths accordingly (reference transformer_legacy.py:291).
    Mask convention: True = valid token.
    """

    def __init__(self, d_model: int) -> None:
        super().__init__()
        self.cls_param = nn.Parameter(torch.zeros(d_model))

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        batch = features.shape[0]
        cls = self.cls_param.to(features.dtype)[None, None, :].expand(
            batch, 1, -1)
        features = torch.cat([cls, features], dim=1)
        valid = torch.ones((batch, 1), dtype=mask.dtype, device=mask.device)
        mask = torch.cat([valid, mask], dim=1)
        return features, mask, lengths + 1
