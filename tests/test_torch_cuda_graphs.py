"""
The serving programs (utils/graphs.py) captured and replayed on the card
against the eager path on the same weights and inputs. `cuda`-marked:
they skip without a GPU. They import nothing of JAX, so they also run on
the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_graphs.py

- every greedy decode (MART, the TransformerXL, the joint and the untied
  model, the MTransformer) and beam search (fixed and reference_compat):
  the tokens of the first call (capture) and of a second (replays only)
  equal the eager decode's;
- the caption eval steps: equal to the eager step;
- the caption train programs of every caption model the CLI trains, at
  dropout 0.1 (B4 at every site): a key's first call is exactly one step
  (the state equal to one eager step's), then 8 replays equal 8 eager
  steps from equal states, bit for bit, at lrs that change;
- validation on id and slab batches (fixed shapes): the eval step is a
  CUDA graph, and its embeddings, losses and ranks equal the eager
  step's (bit for bit expected; 1e-5 relative allowed, in case cuBLAS
  takes another algorithm under capture).
Tiny widths (tests/helpers.py), float32, TF32 off.
"""

import copy
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_eval_step, caption_eval_step_single, caption_train_step,
    caption_train_step_single, init_caption_train_state, train_programs)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.tasks.retrieval import validate
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.utils.graphs import cache_of

# tests/helpers.py by its path: the card's machine may have another
# module named `tests` on its path
_spec = importlib.util.spec_from_file_location(
    "coot_test_helpers", Path(__file__).with_name("helpers.py"))
helpers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(helpers)

VOCAB = 50
EOS = 5
S, N = 3, 4
REL_TOL = 1e-5
NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0,
              "memory_dropout_prob": 0.0}
VARIANTS = {
    "mart": {}, "beam": {}, "beam_compat": {},
    "xl": {"xl": True},
    "joint": {"recurrent": False},
    "untied": {"recurrent": False, "untied": True},
    "mtrans": {"recurrent": False, "mtrans": True},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured and "
                    "replayed only there; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _caption(variant: str, device, over=None):
    """(model, cfg, batch on the device) at dropout 0 (or the config of
    `over`), matrices scaled up and [EOS] favoured so decodes vary and
    beams finish."""
    cfg = MartConfig(helpers.caption_config_dict(
        over if over is not None else {**NO_DROPOUT, **VARIANTS[variant]}))
    model = create_mart_model(cfg, VOCAB, device, seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(3.0)
        if variant.startswith("beam"):
            model.decoder.bias[EOS] += 2.0
    rng = np.random.RandomState(0)
    v, t = cfg.max_v_len, cfg.max_t_len
    if cfg.untied or cfg.mtrans:
        batch = {
            "video_feature": rng.randn(N, v, cfg.video_feature_size),
            "video_mask": np.ones((N, v)), "text_ids": np.zeros((N, t)),
            "text_mask": np.ones((N, t)),
            "text_labels": rng.randint(0, VOCAB, (N, t))}
    else:
        lead = (S, N) if cfg.recurrent else (N,)
        batch = {
            "input_ids": rng.randint(7, VOCAB, lead + (v + t,)),
            "video_feature": rng.randn(*lead, v + t,
                                       cfg.video_feature_size),
            "input_mask": np.ones(lead + (v + t,)),
            "token_type_ids": np.concatenate(
                [np.zeros(lead + (v,)), np.ones(lead + (t,))], -1),
            "input_labels": rng.randint(0, VOCAB, lead + (v + t,))}
    ints = ("input_ids", "token_type_ids", "input_labels", "text_ids",
            "text_labels")
    batch = {k: torch.from_numpy(np.asarray(
        a, np.int64 if k in ints else np.float32)).to(device)
        for k, a in batch.items()}
    return model, cfg, batch


def _decode(translator, variant, batch):
    if variant.startswith("beam"):
        return np.asarray(translator.translate_batch_beam(
            batch["input_ids"], batch["video_feature"], batch["input_mask"],
            batch["token_type_ids"],
            reference_compat=variant == "beam_compat"))
    return np.asarray(translator.translate_batch(batch))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_graphs_equal_eager(cuda, variant):
    model, cfg, batch = _caption(variant, cuda)
    eager = Translator(model, cfg, eager=True)
    ref = _decode(eager, variant, batch)
    graphs = Translator(model, cfg)
    first = _decode(graphs, variant, batch)
    built = cache_of(model).captures
    second = _decode(graphs, variant, batch)
    assert cache_of(model).captures == built  # replays only
    np.testing.assert_array_equal(first, ref)
    np.testing.assert_array_equal(second, ref)
    assert graphs.replays > 0 and eager.replays == 0
    assert graphs.forwards == eager.forwards
    assert graphs.host_reads == eager.host_reads


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mart", "joint", "untied"])
def test_caption_eval_graphs_equal_eager(cuda, variant):
    model, cfg, batch = _caption(variant, cuda)
    step = caption_eval_step if cfg.recurrent else caption_eval_step_single
    ref = {k: float(v) for k, v in step(model, batch, eager=True).items()}
    for _ in range(2):  # the capture, then a replay
        got = {k: float(v) for k, v in step(model, batch).items()}
        for key, value in ref.items():
            assert abs(got[key] - value) <= REL_TOL * max(abs(value), 1e-30)
    assert cache_of(model).captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ids", "slab"])
def test_validation_graph_equals_eager(cuda, tmp_path, layout):
    overrides = generate_retrieval_dataset(
        tmp_path, num_videos=12, num_val_videos=20, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0,
        feat_format="npy")
    cfg = RetrievalConfig(copy.deepcopy(helpers.retrieval_config_dict(
        overrides, batch_size=8)))
    mgr = RetrievalModelManager(cfg, cuda, seed=2)
    _, _, _, val = create_retrieval_datasets_and_loaders(
        cfg, tmp_path, device_preload=layout == "ids", fixed_shapes=True,
        device=cuda)
    assert val.layout == layout
    kw = dict(compute_dtype=torch.float32, val_clips=True, cc_seed=3,
              logger=logging.getLogger("test"))
    graph = validate.validate_retrieval(mgr.model, cfg, val, cuda, **kw)
    eager = validate.validate_retrieval(mgr.model, cfg, val, cuda,
                                        eager=True, **kw)
    assert graph["eval_step"] == "CUDA graph"
    assert eager["eval_step"] == "eager"
    for key in ("v2p", "p2v", "c2s", "s2c"):
        assert graph[key] == eager[key], key
    for key, value in eager["embeddings"].items():
        err = np.abs(graph["embeddings"][key] - value).max()
        assert err <= REL_TOL * max(np.abs(value).max(), 1.0), key
    for key in ("loss_total", "loss_contrastive", "loss_cc"):
        assert abs(graph[key] - eager[key]) <= REL_TOL * max(
            abs(eager[key]), 1.0), key


# every caption model the CLI trains: the -o overrides of a caption config
TRAIN_VARIANTS = {
    "mart": {},
    "raw_mart": {"coot_model_name": None, "max_v_len": 8,
                 "video_feature_size": 20},
    "xl": {"xl": True},
    "xl_grad": {"xl": True, "xl_grad": True},
    "tied": {"share_wd_cls_weight": True, "word_vec_size": 32},
    "untied": {"recurrent": False, "untied": True},
    "joint": {"recurrent": False},
    "mtrans": {"recurrent": False, "mtrans": True},
}
TRAIN_LRS = (1e-3, 3e-4, 2e-3)


def _train_state_tensors(state) -> list:
    opt = state.optimizer
    return (list(opt.params.values()) + list(opt.mu.values())
            + list(opt.nu.values()) + list(state.ema.shadow.values())
            + [opt.step_count, state.step, state.seed])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_train_programs_equal_eager(cuda, variant):
    over = {**TRAIN_VARIANTS[variant], "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1,
            "memory_dropout_prob": 0.1}
    states, batch = {}, None
    for eager in (False, True):
        model, cfg, batch = _caption(variant, cuda, over)
        states[eager] = init_caption_train_state(model, cfg, 0)
    step = caption_train_step if cfg.recurrent else caption_train_step_single
    for i in range(9):
        lr = TRAIN_LRS[i % len(TRAIN_LRS)]
        out = {eager: {k: v.clone() for k, v in
                       step(st, batch, lr, eager=eager).items()}
               for eager, st in states.items()}
        for key in ("loss", "n_correct", "n_word", "grad_norm"):
            assert torch.equal(out[False][key], out[True][key]), (i, key)
        if i == 0:  # the first call of the key is one step
            assert int(states[False].step) == 1
        for a, b in zip(_train_state_tensors(states[False]),
                        _train_state_tensors(states[True])):
            assert torch.equal(a, b), i
    assert train_programs(states[False]).captures == 1
    assert int(states[False].step) == 9

