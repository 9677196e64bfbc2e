"""
Weight bridge: JAX RetrievalModel and RecursiveTransformer parameters ->
this package's state dicts, and the reference MART checkpoint loader.

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

`jax_mart_params_to_state_dict` is the inverse of the JAX package's
torch_convert.convert_mart_model_state :473 for the recurrent MART model
("mart" family, `_convert_mart_key` :209), and `load_mart_checkpoint` reads
the reference caption layout `{"model": state_dict}` (what
torch_convert.convert_model_file :543 reads) into the port's model.
`mart_jax_paths` goes the other way for names: each parameter of the
port's MART model with the flax path JAX gives it, which BertAdam's masks
read.
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


# ---------- MART (RecursiveTransformer) ----------

# flax scope names -> torch module paths of the MART model (the
# Sequential indices of the embedding stacks and the memory init FC)
_MART_SCOPES = {
    "word_ln_in": "word_fc.0", "word_fc": "word_fc.2",
    "word_ln_out": "word_fc.4", "video_ln_in": "video_embeddings.0",
    "video_fc": "video_embeddings.2", "video_ln_out": "video_embeddings.4",
    "init_memory_fc": "init_memory_fc.0",
    "init_memory_ln": "init_memory_fc.1",
    "transform_dense": "transform.dense",
    "transform_ln": "transform.LayerNorm",
}
# flax leaf names -> torch names; a Dense kernel is transposed
_MART_LEAVES = {"kernel": "weight", "scale": "weight",
                "embedding": "weight", "bias": "bias"}
# reference state-dict entries that are not parameters of the model: the
# sincos buffer, the label-smoothing buffer, and the `memory_intermediate`
# the reference builds but never calls (JAX torch_convert.py:49-55, :213)
_MART_SKIP = (re.compile(r"(^|\.)position_embeddings\.pe$"),
              re.compile(r"^loss_func\."),
              re.compile(r"\.memory_intermediate\."))


# torch module scopes (as component pairs) -> flax scope names, and the
# flax leaf of a `weight` by the module that holds it
_MART_SCOPES_INV = {tuple(v.split(".")): k for k, v in _MART_SCOPES.items()}
_MART_WEIGHT_LEAF = {"Linear": "kernel", "LayerNorm": "scale",
                     "Embedding": "embedding"}


def mart_jax_paths(model) -> Dict[str, str]:
    """{parameter name: its JAX path, "encoder/layer_0/output/LayerNorm/
    scale"} for the port's RecursiveTransformer (the inverse of
    jax_mart_params_to_state_dict's names)."""
    out: Dict[str, str] = {}
    for module_name, module in model.named_modules():
        parts = module_name.split(".") if module_name else []
        scope, i = [], 0
        while i < len(parts):
            pair = tuple(parts[i:i + 2])
            if pair in _MART_SCOPES_INV:
                scope.append(_MART_SCOPES_INV[pair])
            elif parts[i] == "layer" and len(pair) == 2 \
                    and pair[1].isdigit():
                scope.append(f"layer_{pair[1]}")
            else:
                scope.append(parts[i])
                i += 1
                continue
            i += 2
        for leaf, _ in module.named_parameters(recurse=False):
            name = ".".join(parts + [leaf])
            if leaf == "weight":
                leaf = _MART_WEIGHT_LEAF[type(module).__name__]
            out[name] = "/".join(scope + [leaf])
    return out


def jax_mart_params_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX RecursiveTransformer params (nested, or flat {path: array}) ->
    the reference torch MART state dict {key: array}."""
    flat = params if (params and isinstance(next(iter(params)), tuple)) \
        else flatten(params)
    out: Dict[str, np.ndarray] = {}
    for path, val in flat.items():
        val = np.asarray(val)
        scope, leaf = list(path[:-1]), path[-1]
        scope = [_MART_SCOPES.get(p, p) for p in scope]
        scope = [f"layer.{p[6:]}" if re.fullmatch(r"layer_\d+", p) else p
                 for p in scope]
        if leaf == "kernel":
            val = np.ascontiguousarray(val.T)
        out[".".join(scope + [_MART_LEAVES.get(leaf, leaf)])] = val
    return out


def load_mart_checkpoint(model, state: Dict[str, Any]) -> None:
    """Load a reference-layout caption checkpoint `{"model": state_dict}`
    (tensors or arrays) into the port's RecursiveTransformer, strictly:
    every parameter must be there with its shape, and nothing else but the
    reference's non-parameter entries."""
    import torch
    if set(state) != {"model"}:
        raise ValueError("a MART checkpoint is {'model': state_dict}, got "
                         f"the models {sorted(state)}")
    sd = {k: torch.from_numpy(np.array(v)) if not torch.is_tensor(v)
          else v for k, v in state["model"].items()
          if not any(p.search(k) for p in _MART_SKIP)}
    model.load_state_dict(sd, strict=True)
