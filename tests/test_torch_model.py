"""
The PyTorch port's retrieval model, eval step and metrics held against the
JAX package on the same inputs and the same weights.

The weights are made by the JAX RetrievalModel from a seed and bridged into
the port with utils/param_bridge.py; the inputs are made from a seeded numpy
RNG. Everything runs in float32 on the CPU, where the port's kernel
wrappers take their plain versions. Tolerances: atol = rtol = 2e-5 on every
output (the two frameworks sum in different orders; observed errors are
~1e-6); ranks and retrieval metrics must be equal.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from coot_videotext_tpu.models.layers import (
    CootLayerNorm as JCootLayerNorm, sincos_positional_encoding as jsincos)
from coot_videotext_tpu.tasks.retrieval import eval as jeval
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.tasks.retrieval.steps import make_retrieval_eval_step
from coot_videotext_tpu.utils import torch_convert
from coot_videotext_tpu.utils.yaml_utils import (
    load_yaml_config_file as jload_yaml)
from coot_videotext_tpu_torch.models.layers import (
    CootLayerNorm, sincos_positional_encoding)
from coot_videotext_tpu_torch.tasks.retrieval import eval as teval
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    retrieval_eval_step)
from coot_videotext_tpu_torch.utils.param_bridge import (
    flatten, jax_params_to_state_dict)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file
from tests.helpers import retrieval_config_dict

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
CONFIG_DIR = Path(__file__).resolve().parents[1] / "config" / "retrieval"


@pytest.mark.parametrize("path", sorted(CONFIG_DIR.rglob("*.yaml")),
                         ids=lambda p: p.relative_to(CONFIG_DIR).as_posix())
def test_configs_parse_like_jax(path):
    jcfg = JRetrievalConfig(jload_yaml(path))
    tcfg = RetrievalConfig(load_yaml_config_file(path))
    assert repr(tcfg) == repr(jcfg)


def test_layer_pieces_match_jax():
    """The reference-variant sincos table and CootLayerNorm on rows with a
    large offset and on constant (zero-variance) rows."""
    np.testing.assert_allclose(sincos_positional_encoding(50, 32).numpy(),
                               np.asarray(jsincos(50, 32)), **TOL)
    rng = np.random.RandomState(0)
    x = rng.randn(5, 24).astype(np.float32)
    x[0] += 1000.0
    x[1] = 7.0
    gain = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    ref = JCootLayerNorm().apply(
        {"params": {"gain": gain, "bias": bias}}, x)
    norm = CootLayerNorm(24)
    with torch.no_grad():
        norm.gain.copy_(torch.from_numpy(gain))
        norm.bias.copy_(torch.from_numpy(bias))
        out = norm(torch.from_numpy(x)).numpy()
    # 1e-4: the row offset by 1000 carries f32 rounding of ~6e-5 per input
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out[1], bias)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_mlp_matches_jax(num_layers):
    """MLP layer order (JAX MLP :254): middle norms and activations, a
    linear residual, the output activation and norm; weights copied across
    by name."""
    from coot_videotext_tpu.models.layers import MLP as JMLP
    from coot_videotext_tpu.models.configs import MLPConfig as JMLPConfig
    from coot_videotext_tpu_torch.models.configs import MLPConfig
    from coot_videotext_tpu_torch.models.layers import MLP

    cfg = {"output_dim": 12, "num_layers": num_layers, "hidden_dim": 20,
           "activation_middle": "gelu", "activation_output": "relu",
           "dropout_middle": 0, "dropout_output": 0,
           "norm_middle": "layernorm_coot", "norm_output": "layernorm_coot",
           "residual": "linear"}
    rng = np.random.RandomState(0)
    x = rng.randn(5, 16).astype(np.float32)
    jmlp = JMLP(cfg=JMLPConfig(copy.deepcopy(cfg)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32),
        jmlp.init(jax.random.PRNGKey(0), x)["params"])
    ref = jmlp.apply({"params": params}, x)
    mlp = MLP(MLPConfig(copy.deepcopy(cfg)), 16)
    fcs = [m for m in mlp.mlp if isinstance(m, torch.nn.Linear)]
    norms = [m for m in mlp.mlp if isinstance(m, CootLayerNorm)]
    assert len(fcs) == num_layers and len(norms) == num_layers
    with torch.no_grad():
        for i, fc in enumerate(fcs):
            fc.weight.copy_(torch.from_numpy(params[f"fc_{i}"]["kernel"].T))
            fc.bias.copy_(torch.from_numpy(params[f"fc_{i}"]["bias"]))
        for i, norm in enumerate(norms):
            for leaf in ("gain", "bias"):
                getattr(norm, leaf).copy_(torch.from_numpy(
                    params[f"CootLayerNorm_{i}"][leaf]))
        mlp.residual.weight.copy_(torch.from_numpy(
            params["residual_fc"]["kernel"].T))
        mlp.residual.bias.copy_(torch.from_numpy(
            params["residual_fc"]["bias"]))
        out = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def _ragged_batch(seed=0, b=4, n=3, dv=64, dt=48):
    """Random lengths and part counts, one constant clip row, one
    batch-padding row (batch_valid False) shaped like collate_fn's."""
    rng = np.random.RandomState(seed)
    lv, lc, lp, ls = 10, 8, 12, 6

    def lens(shape, hi):
        return rng.randint(1, hi + 1, size=shape).astype(np.int32)

    vid_len, par_len = lens(b, lv), lens(b, lp)
    clip_len, sent_len = lens((b, n), lc), lens((b, n), ls)
    num = np.array([3, 2, 1, 1], np.int32)
    valid = np.arange(n)[None] < num[:, None]
    batch = {
        "batch_valid": np.array([True, True, True, False]),
        "vid_feat": rng.randn(b, lv, dv).astype(np.float32),
        "vid_mask": np.arange(lv)[None] < vid_len[:, None],
        "vid_len": vid_len,
        "clip_feat": rng.randn(b, n, lc, dv).astype(np.float32),
        "clip_mask": np.arange(lc)[None, None] < clip_len[..., None],
        "clip_len": clip_len, "clip_valid": valid, "clip_num": num,
        "par_feat": rng.randn(b, lp, dt).astype(np.float32),
        "par_mask": np.arange(lp)[None] < par_len[:, None],
        "par_len": par_len,
        "sent_feat": rng.randn(b, n, ls, dt).astype(np.float32),
        "sent_mask": np.arange(ls)[None, None] < sent_len[..., None],
        "sent_len": sent_len, "sent_valid": valid, "sent_num": num,
    }
    batch["clip_feat"][0, 0, 2] = 3.0
    return batch


@pytest.fixture(scope="module")
def bridged():
    """(JAX manager, JAX params, port manager with the same weights,
    batch)."""
    cfg_dict = retrieval_config_dict({"vid_feat_dim": 64,
                                      "text_feat_dim": 48})
    jmgr = JModelManager(JRetrievalConfig(copy.deepcopy(cfg_dict)))
    batch = _ragged_batch()
    params = jmgr.init_params(0, batch)
    tmgr = RetrievalModelManager(RetrievalConfig(copy.deepcopy(cfg_dict)),
                                 torch.device("cpu"), seed=1)
    state = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tmgr.load_state({net: {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}
                     for net, sd in state.items()})
    return jmgr, params, tmgr, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_matches_jax(bridged):
    jmgr, params, tmgr, batch = bridged
    jout = jmgr.model_eval.apply({"params": params}, batch,
                                 deterministic=True)
    with torch.inference_mode():
        tout = tmgr.model(_torch_batch(batch))
    assert set(tout) == set(jout)
    for key in jout:
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   err_msg=key, **TOL)


def test_state_dict_converts_back_to_the_jax_tree(bridged):
    """Port state_dict() -> the JAX converter of reference .pth files ->
    the original JAX tree: the port uses the reference key layout."""
    _, params, tmgr, _ = bridged
    flat = torch_convert.convert_retrieval_model_state(
        {net: {k: v.numpy() for k, v in sd.items()}
         for net, sd in tmgr.state_dict().items()})
    jflat = flatten(jax.tree_util.tree_map(np.asarray, params))
    assert set(flat) == set(jflat)
    for key, val in jflat.items():
        np.testing.assert_array_equal(flat[key], val, err_msg=str(key))


def test_eval_step_matches_jax(bridged):
    """Loss parts (deterministic cycle-consistency branch, rng=None) and
    the raw and normalized embeddings of the eval step."""
    jmgr, params, tmgr, batch = bridged
    cfg = jmgr.cfg
    kw = dict(loss_weights=cfg.train.contrastive_loss_config.as_dict(),
              margin=cfg.train.contrastive_loss_config.margin,
              loss_cycle_cons=cfg.train.loss_cycle_cons)
    jembs, jparts = make_retrieval_eval_step(jmgr.model_eval, **kw)(
        params, batch, None)
    tembs, tparts = retrieval_eval_step(tmgr.model, _torch_batch(batch),
                                        **kw)
    assert set(tparts) == set(jparts)
    for key in jparts:
        np.testing.assert_allclose(float(tparts[key]), float(jparts[key]),
                                   err_msg=key, **TOL)
    assert float(tparts["loss_cc"]) != 0.0
    assert set(tembs) == set(jembs)
    for key in jembs:
        np.testing.assert_allclose(tembs[key].numpy(),
                                   np.asarray(jembs[key]), err_msg=key,
                                   **TOL)


def test_retrieval_metrics_match_jax():
    rng = np.random.RandomState(0)
    data = {"a": rng.randn(60, 16).astype(np.float32)}
    data["b"] = data["a"] + 0.8 * rng.randn(60, 16).astype(np.float32)
    j1, j2, jsum, _ = jeval.compute_retrieval(data, "a", "b",
                                              print_fn=lambda s: None)
    t1, t2, tsum, _ = teval.compute_retrieval(
        data, "a", "b", torch.device("cpu"), print_fn=lambda s: None)
    assert (t1, t2, tsum) == (j1, j2, jsum)
    assert 0.0 < t1["r1"] < 1.0
    assert teval.retrieval_results_to_str(t1, "a") == \
        jeval.retrieval_results_to_str(j1, "a")
