"""
Pop-style config classes for the model modules (copy of
coot_videotext_tpu/models/configs.py). The yaml key
surface is identical to the reference (nntrainer/models/transformer_legacy.py
:26-111, mlp.py:25-44, poolers.py:56-79, activations.py, normalizations.py,
encoder.py) so reference config files parse unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Union

from coot_videotext_tpu_torch.typext import ConfigClass, ConstantHolder

NONE = "none"


class ActivationConst(ConstantHolder):
    NONE = NONE
    RELU = "relu"
    GELU = "gelu"
    LEAKYRELU = "leakyrelu"


class ActivationConfig(ConfigClass):
    """Activation name + hyperparams (reference activations.py)."""

    def __init__(self, name_or_config: Union[str, Dict[str, Any]]) -> None:
        if isinstance(name_or_config, str):
            config: Dict[str, Any] = {}
            self.name = name_or_config
        else:
            config = name_or_config
            self.name = config.pop("name")
        self.negative_slope: float = config.pop("negative_slope", 1e-2)


class NormalizationConst(ConstantHolder):
    NONE = NONE
    LAYERNORM_PYTORCH = "layernorm_pytorch"
    LAYERNORM_COOT = "layernorm_coot"


class NormalizationConfig(ConfigClass):
    """Normalization name + hyperparams (reference normalizations.py:51)."""

    def __init__(self, name_or_config: Union[str, Dict[str, Any]]) -> None:
        if isinstance(name_or_config, str):
            config: Dict[str, Any] = {}
            self.name = name_or_config
        else:
            config = name_or_config
            self.name = config.pop("name")
        self.eps: float = config.pop("eps", 1e-6)
        self.affine: bool = config.pop("affine", True)
        self.momentum: float = config.pop("momentum", 0.1)
        self.track_running_stats: bool = config.pop(
            "track_running_stats", True)


class PositionalEncodingConst(ConstantHolder):
    NONE = NONE
    SINCOS = "sincos"


class ResidualsEnum(ConstantHolder):
    """MLP residual modes (reference mlp.py:12)."""
    NONE = NONE
    PASSTHROUGH = "passthrough"
    LINEAR = "linear"


class MLPConfig(ConfigClass):
    """MLP submodule config (reference mlp.py:25)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        self.output_dim: int = config.pop("output_dim")
        self.num_layers: int = config.pop("num_layers")
        self.hidden_dim: int = config.pop("hidden_dim")
        self.activation_middle = ActivationConfig(
            config.pop("activation_middle"))
        self.activation_output = ActivationConfig(
            config.pop("activation_output"))
        self.dropout_middle: float = config.pop("dropout_middle")
        self.dropout_output: float = config.pop("dropout_output")
        self.norm_middle = NormalizationConfig(config.pop("norm_middle"))
        self.norm_output = NormalizationConfig(config.pop("norm_output"))
        self.residual: str = config.pop("residual")
        if self.hidden_dim == 0:
            self.hidden_dim = self.output_dim


class PoolerConst(ConstantHolder):
    """Pooler types (reference poolers.py:44)."""
    ATN = "atn"
    AVG_SPECIAL = "avg_special"
    MAX = "max"
    AVG = "avg"
    LAST = "last"
    FIRST = "first"


class PoolerConfig(ConfigClass):
    """Pooler config (reference poolers.py:56)."""

    def __init__(self, name_or_config: Union[str, Dict[str, Any]]) -> None:
        if isinstance(name_or_config, str):
            config: Dict[str, Any] = {}
            self.name = name_or_config
        else:
            config = name_or_config
            self.name = config.pop("name")
        self.hidden_dim: int = config.pop("hidden_dim", 0)
        self.num_heads: int = config.pop("num_heads", 1)
        self.num_layers: int = config.pop("num_layers", 1)
        self.dropout: float = config.pop("dropout", 0)
        self.activation = ActivationConfig(config.pop("activation", "relu"))


class TransformerEncoderConfig(ConfigClass):
    """Self/cross-attention stack config (reference transformer_legacy.py:81)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        self.hidden_dim: int = config.pop("hidden_dim")
        self.num_layers: int = config.pop("num_layers")
        self.dropout: float = config.pop("dropout")
        self.num_heads: int = config.pop("num_heads")
        self.pointwise_ff_dim: int = config.pop("pointwise_ff_dim")
        self.activation = ActivationConfig(config.pop("activation"))
        self.norm = NormalizationConfig(config.pop("norm"))


class TransformerTypesConst(ConstantHolder):
    """COOT network types (reference transformer_legacy.py:105)."""
    TRANSFORMER_LEGACY = "transformer"
    TRANSFORMER_TORCH = "transformer_torch"
    RNN_LEGACY = "rnn"


class InitTypesConst(ConstantHolder):
    """Weight init types (reference initialization.py:35)."""
    NONE = NONE
    NORM = "normal"
    UNIFORM = "uniform"
    TRUNCNORM = "truncnorm"


class TransformerConfig(ConfigClass):
    """
    Config for one COOT network (reference transformer_legacy.py:26-78).
    """

    def __init__(self, config: Dict[str, Any]) -> None:
        self.name: str = config.pop("name")
        self.output_dim: int = config.pop("output_dim")
        self.dropout_input: float = config.pop("dropout_input")
        self.norm_input: str = config.pop("norm_input")
        self.positional_encoding: str = config.pop("positional_encoding")

        self.add_local_cls_token: bool = config.pop("add_local_cls_token")
        if self.add_local_cls_token:
            self.local_cls_token_init_type: str = config.pop(
                "local_cls_token_init_type")
            self.local_cls_token_init_std: float = config.pop(
                "local_cls_token_init_std")

        self.use_input_fc: bool = config.pop("use_input_fc")
        self.input_fc_config = None
        if self.use_input_fc:
            self.input_fc_config = MLPConfig(config.pop("input_fc_config"))

        self.selfatn = TransformerEncoderConfig(config.pop("selfatn_config"))

        self.use_output_fc: bool = config.pop("use_output_fc")
        self.output_fc_config = None
        if self.use_output_fc:
            self.output_fc_config = MLPConfig(config.pop("output_fc_config"))

        self.use_context: bool = config.pop("use_context")
        self.crossatn = None
        if self.use_context:
            self.crossatn = TransformerEncoderConfig(
                config.pop("crossatn_config"))

        self.pooler_config = PoolerConfig(config.pop("pooler_config"))

        self.weight_init_type: str = config.pop("weight_init_type")
        self.weight_init_std: float = config.pop("weight_init_std")

        self.linear_out: bool = config.pop("linear_out", False)
