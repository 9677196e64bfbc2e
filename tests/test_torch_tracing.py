"""
The port's host spans (utils/profiling.py `span`, `last_session`, the
span track of `trace`) and its train steps' device phase marks
(ops/phase.py). The CPU tests run everywhere; the `cuda`-marked one skips
without a GPU. Nothing here imports JAX, so the file also runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_tracing.py

- the profiler flag the spans read, and nothing recorded while it is off;
- spans nest with their parents and share their entry call's id; a new
  session clears the last one; the spans sit on the profiler's clock;
- each of the four entries (the retrieval group and eval steps, the
  caption train step, `translate_batch`) records its entry span and its
  children, the programs' bodies as `graphs.run` on the CPU;
- `trace` writes the spans into its Chrome trace inside their ranges;
- on the card: a replayed retrieval group and a replayed caption train
  step draw the four phase marks a step, in order.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from coot_videotext_tpu_torch.data.device_store import FeatureSource
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.phase import KERNEL_PREFIX, PHASES
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import (
    caption_train_step, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_eval_step, retrieval_train_group)
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.utils import profiling
from coot_videotext_tpu_torch.utils.profiling import last_session, span

# tests/helpers.py by its path: the card's machine may have another
# module named `tests` on its path
_spec = importlib.util.spec_from_file_location(
    "coot_test_helpers", Path(__file__).with_name("helpers.py"))
helpers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(helpers)

CPU = torch.device("cpu")
CLOCK_SLACK_NS = 50_000
VOCAB = 50


def _off_call() -> None:
    """A span with the profiler off: it ends the last session."""
    with span("off"):
        pass


def _names(spans):
    return [s.name for s in spans]


def test_spans_read_the_profilers_enabled_flag():
    """The flag `span` reads is the one a torch profiler sets: a torch
    upgrade that renames it fails here."""
    assert torch_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch_profiler._is_profiler_enabled is True
    assert torch_profiler._is_profiler_enabled is False


def test_nothing_records_with_the_profiler_off():
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("kept"):
            pass
    before = last_session()
    for _ in range(3):
        with span("entry"):
            with span("child"):
                pass
    assert last_session() == before
    assert _names(before.spans) == ["kept"]


def test_spans_nest_and_share_their_entry_calls_id():
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("entry"):
            with span("a"):
                with span("b"):
                    pass
            with span("c"):
                pass
        with span("entry"):
            with span("a"):
                pass
    spans = last_session().spans
    assert _names(spans) == ["entry", "a", "b", "c", "entry", "a"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1, 4]
    assert [s.call for s in spans] == [1, 1, 1, 1, 2, 2]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            outer = spans[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert last_session().dropped == 0


def test_a_new_session_clears_the_last(tmp_path):
    """A span that finds the profiler off ends the session; `trace` opens
    one of its own even straight after another."""
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            pass
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert _names(last_session().spans) == ["second"]
    with profiling.trace(tmp_path):
        with span("traced"):
            pass
    assert _names(last_session().spans) == ["traced"]
    assert last_session().spans[0].call == 1


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 3)
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("entry"):
            for _ in range(4):
                with span("child"):
                    pass
    session = last_session()
    assert len(session.spans) == 3 and session.dropped == 2


def test_spans_sit_on_the_profilers_clock():
    """A span opened inside a profiler range lies inside that range's
    absolute nanoseconds."""
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer range"):
            with span("inner"):
                torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "outer range"]
    assert len(events) == 1
    inner = last_session().spans[0]
    assert inner.start_ns >= events[0].start_ns() - CLOCK_SLACK_NS
    assert inner.end_ns <= events[0].end_ns() + CLOCK_SLACK_NS


def test_the_exported_trace_holds_the_spans_inside_their_ranges(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with record_function("outer range"):
            with span("entry"):
                with span("child"):
                    torch.ones(64).sum()
    data = json.loads(Path(prof.trace_file).read_text())
    events = data["traceEvents"]
    outer = [e for e in events if e.get("name") == "outer range"
             and e.get("ph") == "X"]
    mine = {e["name"]: e for e in events
            if e.get("pid") == profiling.SPAN_TRACK and e.get("ph") == "X"}
    assert len(outer) == 1 and set(mine) == {"entry", "child"}
    lo, hi = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    slack_us = CLOCK_SLACK_NS / 1e3
    for e in mine.values():
        assert e["ts"] >= lo - slack_us
        assert e["ts"] + e["dur"] <= hi + slack_us
    assert mine["child"]["args"]["parent"] == 0


# ---------------- the four entries ----------------

@pytest.fixture(scope="module")
def retrieval(tmp_path_factory):
    """(train state, loss and source kwargs, id batches): a tiny retrieval
    model on id batches of 8 from a device-preloaded synthetic set."""
    root = tmp_path_factory.mktemp("tracing")
    overrides = generate_retrieval_dataset(
        root, num_videos=16, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0,
        feat_format="npy")
    cfg = RetrievalConfig(helpers.retrieval_config_dict(overrides,
                                                        batch_size=8))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, root, seed=0, fixed_shapes=True, device_preload=True)
    assert loader.layout == "ids"
    mgr = RetrievalModelManager(cfg, CPU, seed=0)
    state = TrainState(mgr.model, optim.make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0))
    w = cfg.train.contrastive_loss_config
    kw = dict(loss_weights=w.as_dict(), margin=w.margin,
              loss_cycle_cons=cfg.train.loss_cycle_cons,
              source=FeatureSource.of(loader))
    return state, kw, list(loader)


def _traced(fn):
    _off_call()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, last_session().spans


def _children(spans, entry: int):
    return [s.name for s in spans if s.parent == entry]


def test_the_retrieval_group_records_its_entry_and_children(retrieval):
    state, kw, batches = retrieval
    ids = np.stack([b["dp_idx"] for b in batches[:2]])
    valid = np.stack([b["batch_valid"] for b in batches[:2]])
    _, spans = _traced(lambda: retrieval_train_group(
        state, ids, valid, 2, lr=1e-3, **kw))
    assert spans[0].name == "retrieval.train_group"
    assert {s.call for s in spans} == {1}
    assert _children(spans, 0) == ["prepare", "graphs.check",
                                   "graphs.load", "graphs.run",
                                   "graphs.run"]


def test_the_retrieval_eval_step_records_its_entry_and_children(
        retrieval):
    state, kw, batches = retrieval
    batch = {"layout": "ids",
             "dp_idx": torch.from_numpy(batches[0]["dp_idx"]),
             "batch_valid": torch.from_numpy(batches[0]["batch_valid"])}
    for _ in range(2):  # the second call finds its program
        _, spans = _traced(lambda: retrieval_eval_step(
            state.model, batch, **kw))
        assert spans[0].name == "retrieval.eval_step"
        assert _children(spans, 0) == ["prepare", "graphs.check",
                                       "graphs.load", "graphs.run"]


@pytest.fixture(scope="module")
def mart():
    """(MART at tiny widths, its config, a stacked (S, N) batch)."""
    cfg = MartConfig(helpers.caption_config_dict({}))
    model = create_mart_model(cfg, VOCAB, CPU, seed=3)
    return model, cfg, _caption_batch(cfg, CPU)


def _caption_batch(cfg, device):
    rng = np.random.RandomState(0)
    s, n, v, t = 3, 4, cfg.max_v_len, cfg.max_t_len
    batch = {
        "input_ids": rng.randint(7, VOCAB, (s, n, v + t)),
        "video_feature": rng.randn(s, n, v + t, cfg.video_feature_size),
        "input_mask": np.ones((s, n, v + t)),
        "token_type_ids": np.concatenate(
            [np.zeros((s, n, v)), np.ones((s, n, t))], -1),
        "input_labels": rng.randint(0, VOCAB, (s, n, v + t))}
    ints = ("input_ids", "token_type_ids", "input_labels")
    return {k: torch.from_numpy(np.asarray(
        a, np.int64 if k in ints else np.float32)).to(device)
        for k, a in batch.items()}


def test_the_caption_train_step_records_its_entry_and_children(mart):
    model, cfg, batch = mart
    state = init_caption_train_state(model, cfg, 0)
    _, spans = _traced(lambda: caption_train_step(state, batch, 1e-3))
    assert spans[0].name == "caption.train_step"
    assert _children(spans, 0) == ["prepare", "graphs.check",
                                   "graphs.load", "graphs.run"]


def test_translate_batch_records_its_entry_and_children(mart):
    model, cfg, batch = mart
    _, spans = _traced(lambda: Translator(model, cfg).translate_batch(batch))
    assert spans[0].name == "caption.translate_batch"
    # one program a sentence, then one read of the tokens
    sentence = ["graphs.check", "prepare", "graphs.load", "graphs.run"]
    assert _children(spans, 0) == sentence * 3 + ["read"]
    assert {s.call for s in spans} == {1}


# ---------------- on the card: the phase marks ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the phase marks are CUDA "
                    "kernels; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _marks(run) -> list:
    """The phases of the marks a profiled `run()` drew, in device order."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    marks = sorted((e.time_range.start, e.name) for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and KERNEL_PREFIX in e.name)
    return [next(p for p in PHASES if KERNEL_PREFIX + p in name)
            for _, name in marks]


@pytest.mark.cuda
def test_replayed_train_steps_draw_four_phase_marks_a_step(cuda, tmp_path):
    overrides = generate_retrieval_dataset(
        tmp_path, num_videos=16, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0,
        feat_format="npy")
    cfg = RetrievalConfig(helpers.retrieval_config_dict(overrides,
                                                        batch_size=8))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, tmp_path, seed=0, fixed_shapes=True, device_preload=True,
        device=cuda)
    mgr = RetrievalModelManager(cfg, cuda, seed=0)
    state = TrainState(mgr.model, optim.make_optimizer(
        cfg.optimizer, dict(mgr.model.named_parameters())),
        philox.seed_state(0, cuda))
    w = cfg.train.contrastive_loss_config
    kw = dict(lr=1e-3, loss_weights=w.as_dict(), margin=w.margin,
              loss_cycle_cons=cfg.train.loss_cycle_cons,
              source=FeatureSource.of(loader))
    batches = list(loader)
    ids = np.stack([b["dp_idx"] for b in batches[:2]])
    valid = np.stack([b["batch_valid"] for b in batches[:2]])
    order = list(PHASES)
    retrieval_train_group(state, ids, valid, 2, **kw)  # the capture
    assert _marks(lambda: retrieval_train_group(state, ids, valid, 2,
                                                **kw)) == order * 2

    mcfg = MartConfig(helpers.caption_config_dict(
        {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
         "memory_dropout_prob": 0.1}))
    model = create_mart_model(mcfg, VOCAB, cuda, seed=3)
    cstate = init_caption_train_state(model, mcfg, 0)
    batch = _caption_batch(mcfg, cuda)
    caption_train_step(cstate, batch, 1e-3)  # the capture
    assert _marks(lambda: [caption_train_step(cstate, batch, 1e-3)
                           for _ in range(3)]) == order * 3
