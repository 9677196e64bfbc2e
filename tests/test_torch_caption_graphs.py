"""
The caption train step as a captured program (tasks/caption/steps.py
`train_programs`: one program a batch shape in the train state's graph
cache, utils/graphs.py) against the JAX package on the CPU. Here each
program's body runs eagerly on its static buffers, as it does on the CPU
in every run; on the card the same body is captured as a CUDA graph and
replayed (tests/test_torch_cuda_graphs.py, which imports no JAX, holds the
replays against the eager steps there).

Every caption model the CLI trains (recurrent MART on COOT embeddings and
on raw features, the TransformerXL with and without xl_grad, the tied
decoder, the untied model, the joint single-sentence model, the
MTransformer) at the tiny widths of tests/helpers.py (hidden 32, 4 heads,
2 layers; S = 3 sentences of 4 videos, or 4-5 sentences), dropout 0, the
port's seeded weights carried into JAX by utils/param_bridge.py and the
JAX converter, inputs from numpy seeds:

- 3 steps through the program against JAX's make_caption_train_step (or
  _single) at three different lrs under one key: loss, grad_norm and
  n_correct 1e-5 relative, n_word equal, each step's parameter updates
  within 1% of that step's lr and the EMA within 1% of the largest lr so
  far (the tolerances of
  tests/test_torch_caption_train.py::test_train_step_matches_jax, whose
  lr does not change); one
  program built, the step and the seed state at 3. An lr baked into the
  program would miss at the second step.
- the program equals the eager step (`eager=True`) bit for bit over 3
  steps from equal states;
- the programs are kept across the trainer's `set_opt_state` (BertAdam's
  load_state_dict and the step and seed copied in place) and the EMA swap
  around validation, and dropped when a tensor they read is replaced (a
  moment, an EMA shadow, BertAdam's lr, the seed state).
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import (
    CaptionTrainState as JState, make_caption_train_step,
    make_caption_train_step_single)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_train_step, caption_train_step_single, init_caption_train_state,
    train_programs)
from coot_videotext_tpu_torch.tasks.caption.trainer import MartTrainer
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mtrans_params_to_state_dict)
from tests.helpers import caption_config_dict
from tests.test_torch_caption_mtrans import _jax_params as mtrans_to_jax
from tests.test_torch_caption_rawfeat import RAW
from tests.test_torch_caption_variants import (
    NO_DROPOUT, STACKED, UNTIED, VOCAB, by_torch_name, make_inputs, to_jax)

torch.set_num_threads(1)

CPU = torch.device("cpu")
LRS = (1e-3, 3e-4, 2e-3)
# name: (overrides, batch layout, the JAX converter's family)
MODELS = {
    "mart": ({}, "stacked", "mart"),
    "raw_mart": (RAW, "stacked", "mart"),
    "xl": ({"xl": True}, "stacked", "xl"),
    "xl_grad": ({"xl": True, "xl_grad": True}, "stacked", "xl"),
    "tied": ({"share_wd_cls_weight": True, "word_vec_size": 32},
             "stacked", "mart"),
    "untied": ({"recurrent": False, "untied": True}, "untied", "untied"),
    "joint": ({"recurrent": False}, "joint", "mart"),
    "mtrans": ({"recurrent": False, "mtrans": True}, "untied", "mtrans"),
}
# a variant of tests/test_torch_caption_variants.py with each layout and
# each converter family
_LAYOUT_VARIANT = {"stacked": "mart", "untied": "untied", "joint": "joint"}
_FAMILY_VARIANT = {"mart": "mart", "xl": "xl", "untied": "untied"}


def configs(name: str, **overrides):
    over = {**NO_DROPOUT, **MODELS[name][0], **overrides}
    return JConfig(caption_config_dict(over)), MartConfig(
        caption_config_dict(over))


def keys(name: str):
    return UNTIED if MODELS[name][1] == "untied" else STACKED


def by_name(name: str, tree):
    """A JAX param-shaped tree as the port's {state-dict key: array}."""
    family = MODELS[name][2]
    if family == "mtrans":
        return jax_mtrans_params_to_state_dict(jax.device_get(tree))
    return by_torch_name(_FAMILY_VARIANT[family], tree)


def caption_pair(name: str):
    """(JAX model, JAX params, port model, port cfg, inputs) at dropout 0:
    the port's seeded weights, their matrices scaled up, converted into
    JAX's."""
    jcfg, cfg = configs(name)
    jmodel = jcreate(jcfg, VOCAB, verbose=False)
    model = create_mart_model(cfg, VOCAB, CPU, seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(3.0)
    inputs = make_inputs(_LAYOUT_VARIANT[MODELS[name][1]], cfg)
    family = MODELS[name][2]
    params = (mtrans_to_jax(model, jmodel, inputs) if family == "mtrans"
              else to_jax(_FAMILY_VARIANT[family], model, jmodel, inputs))
    return jmodel, params, model, cfg, inputs


def copy_model(name: str, model):
    other = create_mart_model(configs(name)[1], VOCAB, CPU)
    other.load_state_dict(model.state_dict())
    return other


def batch_of(name: str, inputs):
    return dict(zip(keys(name),
                    (torch.from_numpy(np.asarray(a)) for a in inputs)))


def step_fn(name: str):
    return (caption_train_step if MODELS[name][1] == "stacked"
            else caption_train_step_single)


def jax_step(name: str, jmodel, **kw):
    jopt = joptim.make_bertadam(eps=1e-6)
    if MODELS[name][1] == "stacked":
        step = make_caption_train_step(jmodel, jopt, ema_decay=0.9999, **kw)
    else:
        step = make_caption_train_step_single(
            jmodel, jopt, ema_decay=0.9999,
            untied=MODELS[name][1] == "untied", **kw)
    return jopt, step


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return request.param, caption_pair(request.param)


def test_program_steps_match_jax_at_changing_lrs(pair):
    """3 program steps at LRS under one key against JAX's jitted step,
    each at its lr."""
    name, (jmodel, params, model, cfg, inputs) = pair
    model = copy_model(name, model)
    state = init_caption_train_state(model, cfg, 0)
    jopt, jstep = jax_step(name, jmodel)
    jstate = JState(params, jopt.init(params), joptim.ema_init(params),
                    jnp.int32(0))
    jbatch = {k: jnp.asarray(v) for k, v in zip(keys(name), inputs)}
    batch = batch_of(name, inputs)
    for step, lr in enumerate(LRS):
        jbefore = by_name(name, jstate.params)
        before = {n: p.detach().clone().numpy()
                  for n, p in model.named_parameters()}
        jstate, jm = jstep(jstate, jbatch, jnp.float32(lr),
                           jax.random.PRNGKey(step))
        m = step_fn(name)(state, batch, lr)
        for key in ("loss", "grad_norm", "n_correct"):
            assert _rel(jm[key], m[key].numpy()) <= 1e-5, (step, key)
        assert float(jm["n_word"]) == float(m["n_word"]) > 0
        jafter = by_name(name, jstate.params)
        for n, p in model.named_parameters():
            err = np.abs((p.detach().numpy() - before[n])
                         - (jafter[n] - jbefore[n])).max()
            assert err <= 0.01 * lr, (step, n, err)
        # the shadow holds the parameters of every step so far, each
        # step's rounding amplified at its own lr (BertAdam, see
        # tests/test_torch_caption_train.py): 1% of the largest of them
        ref = by_name(name, jstate.ema.shadow)
        for n, v in state.ema.shadow.items():
            err = np.abs(v.numpy() - ref[n]).max()
            assert err <= 0.01 * max(LRS[:step + 1]), (step, n, err)
    cache = train_programs(state)
    assert cache.captures == 1 and len(cache.programs) == 1
    assert {k[0] for k in cache.programs} == {"caption_train"}
    assert int(state.step) == int(jstate.step) == 3
    assert int(state.seed) == 3


def _snapshot(state) -> dict:
    return {"params": {n: p.detach().clone()
                       for n, p in state.optimizer.params.items()},
            "mu": {n: v.clone() for n, v in state.optimizer.mu.items()},
            "nu": {n: v.clone() for n, v in state.optimizer.nu.items()},
            "ema": {n: v.clone() for n, v in state.ema.shadow.items()},
            "scalars": [t.clone() for t in (state.optimizer.step_count,
                                            state.step, state.seed)]}


def _assert_equal(a: dict, b: dict) -> None:
    for what in ("params", "mu", "nu", "ema"):
        for n, v in a[what].items():
            assert torch.equal(v, b[what][n]), (what, n)
    for x, y in zip(a["scalars"], b["scalars"]):
        assert torch.equal(x, y)


def test_program_equals_the_eager_step(pair):
    """3 steps through the program and 3 eager steps from equal states:
    metrics and every tensor of the state bit for bit; 3 calls are 3
    steps."""
    name, (_, _, model, cfg, inputs) = pair
    states = {eager: init_caption_train_state(copy_model(name, model), cfg,
                                              0)
              for eager in (False, True)}
    batch = batch_of(name, inputs)
    for lr in LRS:
        out = {eager: step_fn(name)(st, batch, lr, eager=eager)
               for eager, st in states.items()}
        for key in ("loss", "n_correct", "n_word", "grad_norm"):
            assert torch.equal(out[False][key], out[True][key]), key
    _assert_equal(_snapshot(states[False]), _snapshot(states[True]))
    assert int(states[False].step) == 3
    assert states[True].programs is None


def _mart_state():
    name = "mart"
    _, _, model, cfg, inputs = caption_pair(name)
    cfg = MartConfig(caption_config_dict({**NO_DROPOUT, "ema_decay": 0.5}))
    return init_caption_train_state(model, cfg, 0), batch_of(name, inputs)


def test_programs_kept_across_set_opt_state_and_the_ema_swap():
    """The trainer's set_opt_state (in place) and its EMA swap around
    validation keep the program; its next call replays with the loaded
    state and gives what the eager step gives from there."""
    state, batch = _mart_state()
    caption_train_step(state, batch, 1e-3)
    cache = train_programs(state)
    program = next(iter(cache.programs.values()))
    saved = {"optimizer": copy.deepcopy(state.optimizer.state_dict()),
             "step": state.step.clone(), "seed": state.seed.clone()}
    caption_train_step(state, batch, 1e-3)
    MartTrainer.set_opt_state(types.SimpleNamespace(train_state=state,
                                                    tp=None), saved)
    assert int(state.step) == 1 and int(state.optimizer.step_count) == 1
    trained = {n: p.detach().clone() for n, p in state.ema.params.items()}
    with torch.no_grad():  # MartTrainer._eval_weights
        for n, p in state.ema.params.items():
            p.copy_(state.ema.shadow[n])
        for n, p in state.ema.params.items():
            p.copy_(trained[n])
    before = _snapshot(state)
    ours = caption_train_step(state, batch, 1e-3)
    cache = train_programs(state)
    assert cache.captures == 1 and next(iter(cache.programs.values())) \
        is program
    other, _ = _mart_state()
    with torch.no_grad():
        for n, p in other.optimizer.params.items():
            p.copy_(before["params"][n])
        for n in other.optimizer.mu:
            other.optimizer.mu[n].copy_(before["mu"][n])
            other.optimizer.nu[n].copy_(before["nu"][n])
            other.ema.shadow[n].copy_(before["ema"][n])
        for dst, src in zip((other.optimizer.step_count, other.step,
                             other.seed), before["scalars"]):
            dst.copy_(src)
    ref = caption_train_step(other, batch, 1e-3, eager=True)
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key
    _assert_equal(_snapshot(state), _snapshot(other))


def _replace(state, what: str) -> None:
    name = next(iter(state.optimizer.mu))
    if what == "moment":
        state.optimizer.mu[name] = state.optimizer.mu[name].clone()
    elif what == "ema":
        state.ema.shadow[name] = state.ema.shadow[name].clone()
    elif what == "lr":
        state.optimizer.lr = state.optimizer.lr.clone()
    else:
        state.seed = state.seed.clone()


@pytest.mark.parametrize("what", ["moment", "ema", "lr", "seed"])
def test_programs_drop_when_a_tensor_they_read_is_replaced(what):
    """A replaced tensor that the program reads (not a parameter) drops
    the program; the new one reads the new tensor, as the eager step
    does."""
    state, batch = _mart_state()
    caption_train_step(state, batch, 1e-3)
    old = next(iter(train_programs(state).programs.values()))
    _replace(state, what)
    caption_train_step(state, batch, 1e-3)
    cache = train_programs(state)
    assert cache.captures == 2
    assert next(iter(cache.programs.values())) is not old
    assert int(state.step) == 2 and int(state.seed) == 2
