"""
Weight bridge: JAX RetrievalModel parameters -> this package's state dicts.

`jax_params_to_state_dict` is the inverse of the JAX package's
utils/torch_convert.py::convert_coot_net :136 / convert_retrieval_model_state
:186. Because this package's modules use the reference torch state-dict keys
that those functions read (`norm_input.gain`, `input_fc.mlp.0.weight`,
`tf.encoder_layers.0.self_attention_layer.sublayer.query_projection.weight`,
`pooler.pools.0.genpool_w1_head`, ...), the same keys load a reference
`model_<ep>.pth` as it is. Inputs and outputs are numpy arrays; the JAX
package is not imported.

MLP scopes: the Linears map in order onto `mlp.<i>`; a norm inside an MLP
(never used by the shipped configs) is not bridged and raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

FlatParams = Dict[Tuple[str, ...], np.ndarray]

_PROJ = ("query", "key", "value", "final")


def flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> FlatParams:
    """Nested {name: {...: array}} -> {(name, ...): array}."""
    if isinstance(tree, dict):
        out: FlatParams = {}
        for key, value in tree.items():
            out.update(flatten(value, prefix + (str(key),)))
        return out
    return {prefix: np.asarray(tree)}


def _linear(leaf: str, val: np.ndarray) -> Tuple[str, np.ndarray]:
    """flax Dense leaf -> torch Linear leaf (kernel (in,out) -> (out,in))."""
    if leaf == "kernel":
        return "weight", np.ascontiguousarray(val.T)
    return "bias", val


def _net_key(path: Tuple[str, ...], val: np.ndarray
             ) -> Tuple[str, np.ndarray]:
    """One flat path inside a COOT net -> (torch key, value)."""
    head = path[0]
    if head == "CootLayerNorm_0" and len(path) == 2:
        return f"norm_input.{path[1]}", val
    if head in ("input_fc", "output_fc"):
        m = re.fullmatch(r"fc_(\d+)", path[1])
        if m and len(path) == 3:
            name, v = _linear(path[2], val)
            return f"{head}.mlp.{m.group(1)}.{name}", v
        if path[1] == "residual_fc":
            name, v = _linear(path[2], val)
            return f"{head}.residual.{name}", v
        raise NotImplementedError(f"MLP param {'/'.join(path)} is not "
                                  "bridged (norms inside an MLP)")
    if path == ("cls_token", "cls_token"):
        return "net_cls.cls_param", val
    if head == "linear_out":
        name, v = _linear(path[1], val)
        return f"linear_out.{name}", v
    if head in ("tf", "tf_context"):
        layer = int(re.fullmatch(r"layer_(\d+)", path[1]).group(1))
        base = f"{head}.encoder_layers.{layer}"
        rest = path[2:]
        if rest[0] == "self_attention" and rest[1] in {
                f"{p}_projection" for p in _PROJ}:
            name, v = _linear(rest[2], val)
            return (f"{base}.self_attention_layer.sublayer.{rest[1]}."
                    f"{name}", v)
        if rest[0] == "CootLayerNorm_0":
            return f"{base}.self_attention_layer.layer_normalization." \
                f"{rest[1]}", val
        if rest[0] == "pointwise_ff":
            idx = {"fc1": 0, "fc2": 3}[rest[1]]
            name, v = _linear(rest[2], val)
            return (f"{base}.pointwise_feedforward_layer.sublayer."
                    f"feed_forward.{idx}.{name}", v)
        if rest[0] == "CootLayerNorm_1":
            return f"{base}.pointwise_feedforward_layer." \
                f"layer_normalization.{rest[1]}", val
    if head == "pooler" and len(path) == 3:
        m = re.fullmatch(r"pool_(\d+)", path[1])
        if m and path[2].startswith("genpool_"):
            return f"pooler.pools.{m.group(1)}.{path[2]}", val
    raise NotImplementedError(f"unrecognized COOT net param "
                              f"{'/'.join(path)}")


def jax_params_to_state_dict(params: Any
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """JAX RetrievalModel params (nested, or flat {(net, ...): array}) ->
    {net_name: {torch key: array}}."""
    flat = params if (params and isinstance(next(iter(params)), tuple)) \
        else flatten(params)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for path, val in flat.items():
        key, v = _net_key(path[1:], np.asarray(val))
        out.setdefault(path[0], {})[key] = v
    return out
