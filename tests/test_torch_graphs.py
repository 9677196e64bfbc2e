"""
The port's serving programs (utils/graphs.py: the greedy and beam
decodes of every caption model, the retrieval and caption eval steps)
held against the JAX package on the CPU. Here each program's body runs
eagerly on its static buffers, as it does on the CPU in every run; on the
card the same body is captured as a CUDA graph and replayed
(tests/test_torch_cuda_graphs.py holds the replays against the eager path
there).

- Greedy: recurrent MART over S = 3 sentences against JAX's
  translate_batch_greedy with fused=False (its per-sentence programs)
  and fused=True (the whole batch as one program); the TransformerXL, the
  joint single-sentence model and the untied model and MTransformer
  against their JAX decodes. Tokens identical; one program a sentence,
  first_step in the key, one read from the device a batch.
- Beam: the token program (dec_idx and the host's predictions as device
  tensors in its static buffers, rows reordered in place) and the memory
  program, fixed and reference_compat, against JAX's translate_batch_beam.
  Tokens identical.
- Eval steps: the retrieval eval program on a dense and an id batch (the
  device store, device sampling) against make_retrieval_eval_step, f32,
  rtol 1e-5, atol 1e-6; its seed state reloaded at every call; the caption
  eval programs against make_caption_eval_step{,_single}, rtol 1e-5.
- Every program against the eager path (`eager=True`): equal.
- The cache: it keeps its programs across an in-place load_state_dict and
  the EMA swap and drops them when a parameter is replaced; the outputs
  follow the live weights either way.
- Validation: id batches run the program, host dense batches the eager
  step, and both give the same metrics.
- The mesh: one capture rule for every program (NCCL captures, gloo runs
  eagerly); `destroy` resets every registered graph (the model caches',
  the caption train programs', the retrieval group's) before the group
  ends.
- The caches count their programs' runs, from which the logs say how the
  steps ran (`mode`).

The weights come from the port's seeded init, carried into JAX by
utils/param_bridge.py and the JAX converter; the inputs from numpy seeds
(tests/helpers.py widths).
"""

import copy
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import (
    make_caption_eval_step, make_caption_eval_step_single)
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator)
from coot_videotext_tpu.tasks.retrieval.steps import make_retrieval_eval_step
from coot_videotext_tpu_torch.data.device_store import FeatureSource
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_eval_step, caption_eval_step_single, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    retrieval_eval_step)
from coot_videotext_tpu_torch.tasks.retrieval.validate import (
    validate_retrieval)
from coot_videotext_tpu_torch.utils.graphs import Program, cache_of
from tests.helpers import caption_config_dict
from tests.test_torch_caption_mtrans import (
    NO_DROPOUT as MTRANS_NO_DROPOUT, _inputs as mtrans_inputs,
    _jax_params as mtrans_jax_params)
from tests.test_torch_caption_variants import (
    S, batch_of, make_pair, to_jax)
from tests.test_torch_device_store import (  # noqa: F401 (fixtures)
    DP_IDX, VALID, bridged, stores, synth)

torch.set_num_threads(1)

VOCAB = 50
EOS = 5
EVAL_TOL = dict(rtol=1e-5, atol=1e-6)
CAPTION_EVAL_RTOL = 1e-5


def _keys(model):
    return {key[0] for key in cache_of(model).programs}


# ---------------- greedy ----------------

@pytest.fixture(scope="module")
def mart():
    return make_pair("mart")


@pytest.mark.parametrize("fused", [False, True], ids=["per_sentence",
                                                       "fused"])
def test_mart_greedy_program_matches_jax(mart, fused):
    """S = 3 sentences through one program a sentence (first_step keyed:
    two programs), against JAX's per-sentence and fused programs."""
    jmodel, params, jcfg, model, cfg, inputs = mart
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch_greedy(
        *inputs[:4], fused=fused)
    translator = Translator(model, cfg)
    ours = translator.translate_batch_greedy(
        *(torch.from_numpy(a) for a in inputs[:4]))
    np.testing.assert_array_equal(np.stack(ours),
                                  np.stack([np.asarray(r) for r in ref]))
    assert len({tuple(r) for r in np.stack(ours).reshape(
        -1, cfg.max_t_len)[:, 1:].tolist()}) > 1
    assert translator.replays == S and translator.host_reads == 1
    assert translator.forwards == S * (cfg.max_t_len + 1)
    firsts = {key[1] for key in cache_of(model).programs
              if key[0] == "greedy"}
    assert firsts == {True, False}


@pytest.fixture(scope="module", params=["xl", "joint", "untied"])
def family_pair(request):
    return request.param, make_pair(request.param)


def test_family_greedy_program_matches_jax(family_pair):
    """The XL (memories and the EOS-masked previous masks carried between
    sentence programs), the joint and the untied model (one program of
    the whole loop, the untied encode inside it)."""
    variant, (jmodel, params, jcfg, model, cfg, inputs) = family_pair
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch(
        inputs[:4], recurrent=cfg.recurrent, untied=cfg.untied, xl=cfg.xl,
        mtrans=cfg.mtrans)
    translator = Translator(model, cfg)
    ours = translator.translate_batch(batch_of(variant, inputs))
    if variant == "xl":
        ours, ref = np.stack(ours), np.stack([np.asarray(r) for r in ref])
        assert translator.replays == S
        assert _keys(model) == {"greedy_xl"}
    else:
        assert translator.replays == 1
        assert _keys(model) == {"greedy_single" if variant == "joint"
                                else "greedy_untied"}
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert translator.host_reads == 1


def test_mtrans_greedy_program_matches_jax():
    """The MTransformer through the untied program."""
    jcfg = JConfig(caption_config_dict(MTRANS_NO_DROPOUT))
    jmodel = jcreate(jcfg, VOCAB, verbose=False)
    cfg = MartConfig(caption_config_dict(MTRANS_NO_DROPOUT))
    model = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=3)
    with torch.no_grad():
        model.decoder.out.weight.mul_(3.0)
    inputs = mtrans_inputs(cfg)
    params = mtrans_jax_params(model, jmodel, inputs)
    jcfg.vocab_size = VOCAB
    ref = JTranslator(jmodel, lambda: params, jcfg) \
        .translate_batch_single_sentence_untied_greedy(*inputs[:4])
    translator = Translator(model, cfg)
    ours = translator.translate_batch_single_sentence_untied_greedy(
        *(torch.from_numpy(a) for a in inputs[:4]))
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert translator.replays == 1 and _keys(model) == {"greedy_untied"}
    assert len({tuple(r) for r in ours[:, 1:].tolist()}) > 1


# ---------------- beam ----------------

@pytest.fixture(scope="module")
def beam_pair():
    """MART with [EOS] favoured (beams finish and reorder), 3 videos."""
    jmodel, _, jcfg, model, cfg, inputs = make_pair("mart")
    with torch.no_grad():
        model.decoder.bias[EOS] += 2.0
    inputs = tuple(a[:, :3] for a in inputs)
    return (jmodel, to_jax("mart", model, jmodel, inputs), jcfg, model, cfg,
            inputs)


@pytest.mark.parametrize("compat", [False, True], ids=["fixed", "compat"])
def test_beam_programs_match_jax(beam_pair, compat):
    """One replay of the token program a token (dec_idx a device tensor),
    the rows reordered in its static buffers, the memory program once a
    sentence."""
    jmodel, params, jcfg, model, cfg, inputs = beam_pair
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch_beam(
        *inputs[:4], reference_compat=compat)
    translator = Translator(model, cfg)
    ours = translator.translate_batch_beam(
        *(torch.from_numpy(a) for a in inputs[:4]), reference_compat=compat)
    np.testing.assert_array_equal(np.stack(ours), np.stack(ref))
    tokens = translator.forwards - S
    assert translator.replays == tokens + S
    assert translator.host_reads == 2 + tokens + 1
    keys = {(k[0], k[1]) + ((k[2],) if k[0] == "beam_token" else ())
            for k in cache_of(model).programs if k[0].startswith("beam")}
    assert {("beam_token", True, compat), ("beam_token", False, compat),
            ("beam_memory", True), ("beam_memory", False)} <= keys


# ---------------- programs against the eager path ----------------

@pytest.mark.parametrize("variant", ["mart", "xl", "joint", "untied",
                                     "beam", "beam_compat"])
def test_programs_equal_the_eager_decode(variant):
    name = "mart" if variant.startswith("beam") else variant
    _, _, _, model, cfg, inputs = make_pair(name)
    if name == "mart":  # beams finish and reorder
        with torch.no_grad():
            model.decoder.bias[EOS] += 2.0
    batch = batch_of(name, inputs)
    decs = []
    for eager in (True, False):
        translator = Translator(model, cfg, eager=eager)
        if variant.startswith("beam"):
            out = translator.translate_batch_beam(
                *(batch[k] for k in ("input_ids", "video_feature",
                                     "input_mask", "token_type_ids")),
                reference_compat=variant == "beam_compat")
        else:
            out = translator.translate_batch(batch)
        decs.append((np.asarray(out), translator.forwards,
                     translator.host_reads))
        assert (translator.replays == 0) == eager
    np.testing.assert_array_equal(decs[0][0], decs[1][0])
    assert decs[0][1:] == decs[1][1:]


# ---------------- eval steps ----------------

def _retrieval_kw(cfg):
    return dict(loss_weights=cfg.train.contrastive_loss_config.as_dict(),
                margin=cfg.train.contrastive_loss_config.margin,
                loss_cycle_cons=cfg.train.loss_cycle_cons)


def _assert_eval_matches(ours, ref):
    (tembs, tparts), (jembs, jparts) = ours, ref
    assert set(tparts) == set(jparts) and set(tembs) == set(jembs)
    for key in jparts:
        np.testing.assert_allclose(float(tparts[key]), float(jparts[key]),
                                   err_msg=key, **EVAL_TOL)
    for key in jembs:
        np.testing.assert_allclose(tembs[key].numpy(),
                                   np.asarray(jembs[key]), err_msg=key,
                                   **EVAL_TOL)


@pytest.mark.parametrize("layout", ["dense", "ids"])
def test_retrieval_eval_program_matches_jax(stores, bridged, layout):
    """The dense batch, and the id batch sampled on the device from the
    store (center sampling, B5 gathers) as JAX's eval step with device
    sampling does; cycle consistency in its full mean (no seed)."""
    s = stores
    jmgr, params, tmgr, dense, _ = bridged
    kw = _retrieval_kw(s["jcfg"])
    if layout == "dense":
        batch = {k: v for k, v in dense.items() if torch.is_tensor(v)}
        ref = make_retrieval_eval_step(jmgr.model_eval, **kw)(
            params, {k: v.numpy() for k, v in batch.items()}, None)
        ours = retrieval_eval_step(tmgr.model, batch, **kw)
    else:
        step = make_retrieval_eval_step(
            jmgr.model_eval, use_store=True,
            device_sampling={"shapes": s["tmeta"].shapes,
                             "max_frames": s["tmeta"].max_frames}, **kw)
        ref = step(params, {"dp_idx": jnp.asarray(DP_IDX),
                            "batch_valid": jnp.asarray(VALID)}, None,
                   s["jstore"].vid_store, s["jstore"].text_store,
                   s["jmeta"].tables)
        batch = {"layout": "ids", "dp_idx": torch.from_numpy(DP_IDX),
                 "batch_valid": torch.from_numpy(VALID)}
        ours = retrieval_eval_step(
            tmgr.model, batch, source=FeatureSource(s["tstore"], s["tmeta"]),
            **kw)
    _assert_eval_matches(ours, ref)
    assert ("retrieval_eval", layout) in {
        k[:2] for k in cache_of(tmgr.model).programs}


def test_retrieval_eval_program_reloads_its_seed_state(stores, bridged):
    """The cycle-consistency draw reads the seed state copied into the
    program at every call: each seed gives the eager step's parts, and
    two seeds differ."""
    s = stores
    _, _, tmgr, dense, _ = bridged
    kw = _retrieval_kw(s["tcfg"])
    batch = {k: v for k, v in dense.items() if torch.is_tensor(v)}
    seed = philox.seed_state(7)
    got = []
    for _ in range(2):
        _, parts = retrieval_eval_step(tmgr.model, batch, seed_state=seed,
                                       **kw)
        _, eager = retrieval_eval_step(tmgr.model, batch, seed_state=seed,
                                       eager=True, **kw)
        for key in parts:
            assert float(parts[key]) == float(eager[key]), key
        got.append(float(parts["loss_cc"]))
        seed.add_(1)
    assert got[0] != got[1]


@pytest.mark.parametrize("variant", ["mart", "untied", "joint"])
def test_caption_eval_program_matches_jax(variant):
    jmodel, params, _, model, _, inputs = make_pair(variant)
    if variant == "mart":
        keys = ("input_ids", "video_feature", "input_mask",
                "token_type_ids", "input_labels")
        ref = make_caption_eval_step(jmodel)(params, dict(zip(keys, inputs)))
        ours = caption_eval_step(model, batch_of(variant, inputs))
    else:
        ref = make_caption_eval_step_single(
            jmodel, untied=variant == "untied")(
                params, {k: np.asarray(v.numpy()) for k, v in
                         batch_of(variant, inputs).items()})
        ours = caption_eval_step_single(model, batch_of(variant, inputs))
    for key in ("loss", "n_correct", "n_word"):
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=CAPTION_EVAL_RTOL, err_msg=key)
    assert _keys(model) == {"caption_eval"}
    eager = (caption_eval_step if variant == "mart"
             else caption_eval_step_single)(model, batch_of(variant, inputs),
                                            eager=True)
    for key in eager:
        assert float(eager[key]) == float(ours[key]), key


# ---------------- the cache ----------------

def test_cache_keeps_programs_across_in_place_updates():
    """An in-place load_state_dict and the trainer's EMA swap (copy_ into
    the parameters) keep the programs, which then decode with the new
    weights."""
    _, _, _, model, cfg, inputs = make_pair("mart")
    batch = batch_of("mart", inputs)
    args = [batch[k] for k in ("input_ids", "video_feature", "input_mask",
                               "token_type_ids")]
    translator = Translator(model, cfg)
    translator.translate_batch_greedy(*args)
    cache = cache_of(model)
    built, programs = cache.captures, dict(cache.programs)

    other = create_mart_model(cfg, VOCAB, torch.device("cpu"), seed=11)
    model.load_state_dict(other.state_dict())
    after_load = translator.translate_batch_greedy(*args)
    state = init_caption_train_state(model, MartConfig(caption_config_dict(
        {"ema_decay": 0.5})), 0)
    with torch.no_grad():  # the swap of CaptionTrainer._eval_weights
        for name, p in state.ema.params.items():
            state.ema.shadow[name].mul_(0.5)
            p.copy_(state.ema.shadow[name])
    after_ema = translator.translate_batch_greedy(*args)
    cache = cache_of(model)
    assert cache.captures == built
    assert all(cache.programs[k] is v for k, v in programs.items())
    eager = Translator(model, cfg, eager=True)
    np.testing.assert_array_equal(np.stack(after_ema),
                                  np.stack(eager.translate_batch_greedy(
                                      *args)))
    assert not np.array_equal(np.stack(after_load), np.stack(after_ema))


def test_cache_drops_programs_when_a_parameter_is_replaced():
    _, _, _, model, cfg, inputs = make_pair("joint")
    batch = batch_of("joint", inputs)
    caption_eval_step_single(model, batch)
    before = cache_of(model).captures
    old = dict(cache_of(model).programs)
    with torch.no_grad():
        model.decoder.bias = torch.nn.Parameter(model.decoder.bias * 0 + 1)
    ours = caption_eval_step_single(model, batch)
    cache = cache_of(model)
    assert cache.captures == before + 1
    assert not any(v is old.get(k) for k, v in cache.programs.items())
    eager = caption_eval_step_single(model, batch, eager=True)
    assert float(ours["loss"]) == float(eager["loss"])


def test_program_refuses_inputs_of_another_shape():
    program = Program(lambda x: x["a"] * 2, {"a": torch.zeros(3)})
    np.testing.assert_array_equal(program({"a": torch.ones(3)}).numpy(),
                                  [2.0, 2.0, 2.0])
    with pytest.raises(ValueError, match="shapes"):
        program({"a": torch.ones(1)})


# ---------------- validation ----------------

def test_validation_runs_the_program_on_id_batches(synth):
    """validate_retrieval on the store's id batches runs the eval program,
    on host dense batches the eager step; the metrics agree."""
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    root, cfg_dict = synth
    cfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    mgr = RetrievalModelManager(cfg, torch.device("cpu"), seed=2)
    results = {}
    for name, kw in (("dense", {}), ("ids", dict(device_preload=True,
                                                 fixed_shapes=True))):
        _, _, _, val = create_retrieval_datasets_and_loaders(cfg, root, **kw)
        assert val.layout == name
        results[name] = validate_retrieval(
            mgr.model, cfg, val, torch.device("cpu"),
            compute_dtype=torch.float32, val_clips=True, cc_seed=3,
            logger=logging.getLogger("test"))
    assert results["dense"]["eval_step"] == "eager"
    assert results["ids"]["eval_step"] == "program body, eagerly on the cpu"
    for key in ("v2p", "p2v", "c2s", "s2c"):
        assert results["ids"][key] == results["dense"][key], key
    np.testing.assert_allclose(results["ids"]["loss_contrastive"],
                               results["dense"]["loss_contrastive"],
                               rtol=2e-5)


def test_validation_eager_keyword_runs_id_batches_eagerly(synth):
    """`eager=True` runs the eval step op by op on id batches too; the
    metrics and losses equal the program's."""
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    root, cfg_dict = synth
    cfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    mgr = RetrievalModelManager(cfg, torch.device("cpu"), seed=2)
    _, _, _, val = create_retrieval_datasets_and_loaders(
        cfg, root, device_preload=True, fixed_shapes=True)
    results = {eager: validate_retrieval(
        mgr.model, cfg, val, torch.device("cpu"),
        compute_dtype=torch.float32, val_clips=True, cc_seed=3,
        logger=logging.getLogger("test"), eager=eager)
        for eager in (False, True)}
    assert results[False]["eval_step"] == "program body, eagerly on the cpu"
    assert results[True]["eval_step"] == "eager"
    for key in ("v2p", "p2v", "c2s", "s2c", "loss_total", "loss_contrastive",
                "loss_cc"):
        assert results[True][key] == results[False][key], key


@pytest.mark.parametrize("backend,world,model_world,captured", [
    (None, 1, 1, True), ("gloo", 1, 1, True), ("nccl", 2, 1, True),
    ("gloo", 2, 1, False), ("nccl", 4, 2, True)])
def test_capture_rules_of_a_mesh(backend, world, model_world, captured):
    """One rule for every captured program (the group step, the eval
    steps, the decodes, the caption train programs): NCCL collectives are
    captured, under any mesh; gloo's run on the host, so a gloo mesh of
    more than one rank runs every step eagerly."""
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    assert pmesh.capturable(None)
    assert not hasattr(pmesh, "serves_captured")
    mesh = pmesh.Mesh(rank=0, world=world, device=torch.device("cpu"),
                      backend=backend, model_world=model_world)
    assert pmesh.capturable(mesh) is captured


class _FakeGraph:
    """Stands for a captured torch.cuda.CUDAGraph: logs its reset."""

    def __init__(self, log):
        self.log = log

    def reset(self):
        self.log.append("reset")


def test_destroy_releases_every_graph_before_the_group_ends(monkeypatch,
                                                            synth):
    """parallel/mesh.py `destroy` with a mocked NCCL process group: every
    live graph cache (a model's, a caption train state's and a retrieval
    train state's) holds no graph when destroy_process_group runs, and
    each graph was reset before it."""
    from coot_videotext_tpu_torch.parallel import mesh as pmesh
    from coot_videotext_tpu_torch.tasks.caption.steps import train_programs
    from coot_videotext_tpu_torch.tasks.retrieval import steps as rsteps
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    from coot_videotext_tpu_torch.utils import graphs
    log = []
    _, _, _, model, _, inputs = make_pair("joint")
    caption_eval_step_single(model, batch_of("joint", inputs))
    state = init_caption_train_state(model, MartConfig(caption_config_dict(
        {"recurrent": False})), 0)
    cache = train_programs(state)
    cache.get("k", lambda x: x, {"a": torch.zeros(2)}).graph = \
        _FakeGraph(log)
    for program in cache_of(model).programs.values():
        program.graph = _FakeGraph(log)
    cfg = RetrievalConfig(copy.deepcopy(synth[1]))
    mgr = RetrievalModelManager(cfg, torch.device("cpu"), seed=0)
    rstate = rsteps.TrainState(mgr.model, make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0))
    group = rsteps.train_programs(rstate)
    group.get("g", lambda x: x, {"a": torch.zeros(2)}).graph = \
        _FakeGraph(log)
    holders = (cache_of(model), cache, group)

    def destroy_process_group():
        assert all(h.programs == {} for h in holders)
        log.append("destroy")
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "destroy_process_group",
                        destroy_process_group)
    mesh = pmesh.Mesh(rank=0, world=2, device=torch.device("cpu"),
                      group=object(), backend="nccl", owned=True)
    pmesh.destroy(mesh)
    assert log == ["reset"] * 3 + ["destroy"]
    assert all(h in graphs._LIVE for h in holders)


@pytest.mark.parametrize("runs,calls,device,label", [
    (0, 3, "cuda", "eager"),
    (3, 3, "cuda", "CUDA graph"),
    (3, 3, "cpu", "program body, eagerly on the cpu"),
    (2, 3, "cuda", "2 of 3 through programs"),
])
def test_mode_reads_what_ran(runs, calls, device, label):
    """utils/graphs.py `mode`: the label of `calls` calls from the `runs`
    of them that went through a program."""
    from coot_videotext_tpu_torch.utils.graphs import mode
    assert mode(runs, calls, torch.device(device)) == label


def test_caches_count_their_programs_runs():
    """A cache's `counts` gains a run at each call of one of its programs
    (on the CPU a body run, never a replay) and keeps it across a
    release; `runs_of` reads a module's; validation's `eval_step` label is
    built from it."""
    from coot_videotext_tpu_torch.utils.graphs import GraphCache, runs_of
    cache = GraphCache(lambda: ())
    program = cache.get("k", lambda x: {"y": x["a"] + 1},
                        {"a": torch.zeros(2)})
    program({"a": torch.ones(2)})
    program()
    assert cache.counts == {"runs": 2}
    cache.release()
    cache.get("k", lambda x: x, {"a": torch.zeros(2)})()
    assert cache.counts == {"runs": 3}
    _, _, _, model, _, inputs = make_pair("joint")
    assert runs_of(model) == 0
    caption_eval_step_single(model, batch_of("joint", inputs))
    caption_eval_step_single(model, batch_of("joint", inputs), eager=True)
    assert runs_of(model) == 1
