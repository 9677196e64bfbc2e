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

`jax_mtrans_params_to_state_dict` and `mtrans_jax_paths` do the same for
the MTransformer ("mtrans" family, the inverse of `_convert_mtrans_key`
:399): the reference keys `encoder.video_embeddings.{0,2}.*`,
`encoder|decoder.layers.N.{selfattn,attention}.layer.w{q,k,v,o}.weight`,
`...{selfattn,attention,feedforward}.layernorm.{gamma,beta}`,
`...feedforward.layer.linear{1,2}.*`, `decoder.out.{weight,bias}`.
`load_mart_checkpoint` loads either model, MART or MTransformer.

The joint single-sentence NonRecurTransformer and the untied
NonRecurTransformerUntied keep names that the MART rules already map
(`encoder.layer.N...`, `video_embeddings.video_embeddings.N`,
`decoder.layer.N.{self_attention,dec_enc_attention,norm1,norm2}`,
`decoder_classifier...`; the inverse of `_convert_untied_key` :316):
`jax_untied_params_to_state_dict` and `untied_jax_paths` are the MART
functions under the untied family's name. The TransformerXL has its own,
`jax_xl_params_to_state_dict` and `xl_jax_paths` (the inverse of
`_convert_xl_key` :364: `encoder.layers.N`, `pos_ff.CoreNet.{0,3}`).

A decoder tied to the word embeddings (share_wd_cls_weight) is one
Parameter under two state-dict keys (`tied_aliases`): the loader fills a
missing `decoder.decoder.weight` from the embeddings, and
`state_dict_for_jax` drops it, since the JAX package's tied head has no
`decoder/decoder/kernel` for apply_converted to fill. Like apply_converted
(:524-530) the loader refuses non-finite values.
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
_MART_SKIP = (re.compile(r"(^|\.)position_embeddings(_text|_video)?\.pe$"),
              re.compile(r"^loss_func\."),
              re.compile(r"\.memory_intermediate\."),
              re.compile(r"^encoder\.pos_emb\.inv_freq$"))


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
    seen = set()  # a tied parameter is named once, where it is first met
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
        for leaf, param in module.named_parameters(recurse=False):
            if id(param) in seen:
                continue
            seen.add(id(param))
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


# the untied model's reference keys are MART's (see the module docstring)
untied_jax_paths = mart_jax_paths
jax_untied_params_to_state_dict = jax_mart_params_to_state_dict


def tied_aliases(model) -> Dict[str, str]:
    """{state-dict key: the parameter name it shares} for every parameter
    the model holds under a second key (`decoder.decoder.weight` ->
    `embeddings.word_embeddings.weight` under share_wd_cls_weight)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {k: names[id(v)] for k, v in
            model.state_dict(keep_vars=True).items()
            if id(v) in names and names[id(v)] != k}


def state_dict_for_jax(model) -> Dict[str, np.ndarray]:
    """The model's state dict as numpy arrays without its tied aliases:
    what the JAX package's convert_mart_model_state + apply_converted
    take."""
    aliases = tied_aliases(model)
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items() if k not in aliases}


def load_mart_checkpoint(model, state: Dict[str, Any]) -> None:
    """Load a reference-layout caption checkpoint `{"model": state_dict}`
    (tensors or arrays) into any of the port's caption models, strictly:
    every parameter must be there with its shape and finite values, and
    nothing else but the reference's non-parameter entries; a tied alias
    may be left out."""
    import torch
    if set(state) != {"model"}:
        raise ValueError("a MART checkpoint is {'model': state_dict}, got "
                         f"the models {sorted(state)}")
    sd = {k: torch.from_numpy(np.array(v)) if not torch.is_tensor(v)
          else v for k, v in state["model"].items()
          if not any(p.search(k) for p in _MART_SKIP)}
    for key, value in sd.items():
        if value.is_floating_point() and not torch.isfinite(value).all():
            raise ValueError(
                f"non-finite values in checkpoint param {key} — corrupted "
                "or never-initialized (see reference XL r_w_bias); "
                "refusing to import")
    for alias, name in tied_aliases(model).items():
        if alias not in sd and name in sd:
            sd[alias] = sd[name]
    model.load_state_dict(sd, strict=True)


# ---------- TransformerXL ----------

# flax feed-forward scopes -> the reference CoreNet index (JAX
# torch_convert.py:361)
_XL_CORENET = {"fc1": "0", "fc2": "3"}
_XL_CORENET_INV = {v: k for k, v in _XL_CORENET.items()}


def xl_jax_paths(model) -> Dict[str, str]:
    """{parameter name: its JAX path, "encoder/layer_0/pos_ff/fc1/kernel"}
    for the port's TransformerXL (the inverse of
    jax_xl_params_to_state_dict's names)."""
    mart = mart_jax_paths(model)
    out: Dict[str, str] = {}
    for name in mart:
        parts = name.split(".")
        if parts[:2] != ["encoder", "layers"]:
            out[name] = mart[name]
            continue
        path = ["encoder", f"layer_{parts[2]}", parts[3]]
        path.append(_XL_CORENET_INV[parts[5]] if parts[4] == "CoreNet"
                    else parts[4])
        leaf = parts[-1]
        if leaf == "weight":
            leaf = "scale" if parts[4] == "layer_norm" else "kernel"
        out[name] = "/".join(path + [leaf])
    return out


def jax_xl_params_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX TransformerXL params (nested, or flat {path: array}) -> the
    reference torch TransformerXL state dict {key: array}."""
    flat = params if (params and isinstance(next(iter(params)), tuple)) \
        else flatten(params)
    out: Dict[str, np.ndarray] = {}
    rest = {}
    for path, val in flat.items():
        if path[0] != "encoder" or len(path) < 4:
            rest[path] = val  # embeddings, head, r_w_bias, r_r_bias
            continue
        val = np.asarray(val)
        scope = ["encoder", "layers", path[1][6:], path[2]]
        if path[3] in _XL_CORENET:
            scope += ["CoreNet", _XL_CORENET[path[3]]]
        else:
            scope.append(path[3])
        if path[-1] == "kernel":
            val = np.ascontiguousarray(val.T)
        out[".".join(scope + [_MART_LEAVES[path[-1]]])] = val
    out.update(jax_mart_params_to_state_dict(rest))
    return out



# ---------- MTransformer ----------

# flax residual scopes -> the reference block that holds the LayerNorm
# (JAX torch_convert.py:420-428)
_MTRANS_RES = {"res_attn": "selfattn", "res_self": "selfattn",
               "res_cross": "attention", "res_ff": "feedforward"}
_MTRANS_SIDE = {"enc": "encoder", "dec": "decoder"}


def _mtrans_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """A flax MTransformer path -> (its reference torch key, whether the
    value is transposed on the way)."""
    if path[0] == "video_ln":
        return f"encoder.video_embeddings.0.{path[1]}", False
    if path[0] == "video_fc":
        return (f"encoder.video_embeddings.2.{_MART_LEAVES[path[1]]}",
                path[1] == "kernel")
    if path == ("out_kernel",):
        return "decoder.out.weight", True
    if path == ("out_bias",):
        return "decoder.out.bias", False
    m = re.fullmatch(r"(enc|dec)_layer_(\d+)", path[0])
    if m is None:
        raise NotImplementedError(f"unrecognized MTransformer param "
                                  f"{'/'.join(path)}")
    base = f"{_MTRANS_SIDE[m.group(1)]}.layers.{m.group(2)}"
    scope, leaf = path[1], path[-1]
    if scope in ("selfattn", "attention"):
        return f"{base}.{scope}.layer.{path[2]}.weight", True
    if scope in _MTRANS_RES:
        return f"{base}.{_MTRANS_RES[scope]}.layernorm.{leaf}", False
    return (f"{base}.feedforward.layer.{path[2]}.{_MART_LEAVES[leaf]}",
            leaf == "kernel")


def mtrans_jax_paths(model) -> Dict[str, str]:
    """{parameter name: its JAX path, "dec_layer_0/res_cross/layernorm/
    gamma"} for the port's MTransformer (the inverse of
    jax_mtrans_params_to_state_dict's names)."""
    out: Dict[str, str] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[:2] == ["encoder", "video_embeddings"]:
            scope = "video_ln" if parts[3] in ("gamma", "beta") \
                else "video_fc"
            path = [scope, {"weight": "kernel"}.get(parts[3], parts[3])]
        elif parts[:2] == ["decoder", "out"]:
            path = ["out_kernel" if parts[2] == "weight" else "out_bias"]
        else:
            side = parts[0][:3]
            block, kind = parts[3], parts[4]
            path = [f"{side}_layer_{parts[2]}"]
            if kind == "layernorm":
                res = {"selfattn": "res_attn" if side == "enc"
                       else "res_self", "attention": "res_cross",
                       "feedforward": "res_ff"}[block]
                path += [res, "layernorm", parts[5]]
            elif block == "feedforward":
                path += ["feedforward", parts[5],
                         {"weight": "kernel"}.get(parts[6], parts[6])]
            else:
                path += [block, parts[5], "kernel"]
        out[name] = "/".join(path)
    return out


def jax_mtrans_params_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX MTransformer params (nested, or flat {path: array}) -> the
    reference torch MTransformer state dict {key: array}."""
    flat = params if (params and isinstance(next(iter(params)), tuple)) \
        else flatten(params)
    out: Dict[str, np.ndarray] = {}
    for path, val in flat.items():
        key, transpose = _mtrans_key(tuple(path))
        val = np.asarray(val)
        out[key] = np.ascontiguousarray(val.T) if transpose else val
    return out


# ---------- S3D and the MLP example ----------

_S3D_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def jax_s3d_params_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX S3D parameters (models/s3d.py) -> the port's S3D state dict,
    the keys of the released `s3d_howto100m.pth`: the inverse of JAX's
    `load_torch_s3d_weights` :240 (conv kernels DHWIO -> OIDHW, Dense (in,
    out) -> (out, in), BatchNormInference scale / bias / mean / var ->
    weight / bias / running_mean / running_var)."""
    out: Dict[str, np.ndarray] = {}
    for path, val in flatten(params).items():
        prefix, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and val.ndim == 5:
            out[f"{prefix}.weight"] = np.ascontiguousarray(
                np.transpose(val, (4, 3, 0, 1, 2)))
        elif leaf in ("kernel", "bias") and path[-2] == "fc":
            name, v = _linear(leaf, val)
            out[f"{prefix}.{name}"] = v
        elif leaf in _S3D_BN:
            out[f"{prefix}.{_S3D_BN[leaf]}"] = val
        else:
            raise KeyError(f"S3D parameter {'/'.join(path)} has no rule")
    return out


def jax_mlp_params_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX MLPModel parameters (examples/mlp_mnist.py: `Dense_0`,
    `Dense_1`) -> the port's MLPModel state dict (`fc1`, `fc2`)."""
    names = {"Dense_0": "fc1", "Dense_1": "fc2"}
    out: Dict[str, np.ndarray] = {}
    for (layer, leaf), val in flatten(params).items():
        name, v = _linear(leaf, val)
        out[f"{names[layer]}.{name}"] = v
    return out
