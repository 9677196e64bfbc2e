"""The readers of the program's spans and phase marks
(`portbench/program_spans.py`, `metrics/{forward,backward,optimizer}_ms`,
`stage_ms`, `launch_ms`, `program_idle`, `captures`) on synthetic traces
and sessions, and on a real trace of the program on the CPU."""

import importlib.util

import pytest
import torch

from portbench import program_spans, run
from portbench.trace import Trace, traced
from portbench.trace import span as bench_span
from coot_videotext_tpu_torch.utils.profiling import Session, Span

ABS = 1_790_000_000_000_000_000  # the session's epoch, in ns


def _ns(seconds: float) -> int:
    return ABS + round(seconds * 1e9)


def _session(lag_s: float = 2e-6, extra=()):
    """Two group calls, entry spans at 0.010 and 0.030 s (trace time)
    less the anchoring offset; each holds prepare (0.2 ms), a check (0.1
    ms), a load (0.1 ms) and two replays (0.05 ms each), and the second a
    capture."""
    spans = []
    for call, t in ((1, 0.010), (2, 0.030)):
        t += lag_s
        entry = len(spans)
        spans.append(Span("retrieval.train_group", call, -1, _ns(t),
                          _ns(t + 0.004)))
        parts = [("prepare", 0.0002), ("graphs.check", 0.0001),
                 ("graphs.load", 0.0001), ("graphs.replay", 0.00005),
                 ("graphs.replay", 0.00005)]
        if call == 2:
            parts.insert(2, ("graphs.capture", 0.001))
        at = t + 0.0001
        for name, d in parts:
            spans.append(Span(name, call, entry, _ns(at), _ns(at + d)))
            at += d
    spans += list(extra)
    return Session(spans, 0)


def _marks(step_starts, phase_s=(0.002, 0.003, 0.001)):
    """The four marks of a step starting at each of `step_starts`."""
    kernels = []
    for t in step_starts:
        at = t
        for phase, d in zip(program_spans.PHASES, phase_s + (0.0,)):
            kernels.append((f"phase_mark_{phase}()", at, at + 1e-6))
            at += d
    return kernels


def _trace(kernels=(), spans=None):
    """Benchmark spans around the two calls of `_session` (trace time,
    the offset ABS), a read after each, a window of [0, 0.05] s."""
    spans = spans if spans is not None else [
        ("train_group", 0.010, 0.0145), ("metrics_read", 0.0146, 0.0148),
        ("train_group", 0.030, 0.0345), ("metrics_read", 0.0346, 0.0348)]
    return Trace(list(kernels), spans, 0.0, 0.05)


def _ctx(trace, steps=4):
    return {"trace": trace, "steps": steps}


@pytest.fixture
def session(monkeypatch):
    """Makes `program_spans.session()` return what the test sets."""
    box = {}
    monkeypatch.setattr(program_spans, "session", lambda: box["s"])
    return box


def test_anchoring_places_the_session_on_the_trace(session):
    session["s"] = _session(lag_s=2e-6)
    spans = program_spans.anchored(_trace())
    entries = [s for s in spans if s.parent < 0]
    assert [e.start for e in entries] == pytest.approx([0.010, 0.030],
                                                       abs=1e-9)
    assert entries[0].end == pytest.approx(0.014, abs=1e-9)


def test_host_readers_sum_their_spans_a_step(session):
    session["s"] = _session()
    ctx = _ctx(_trace(_marks([0.011, 0.031])))
    stage = run.reader("stage_ms.train")(ctx)
    launch = run.reader("launch_ms.train")(ctx)
    # (prepare 0.2 + check 0.1 + load 0.1 ms) x 2 calls / 4 steps
    assert stage == pytest.approx(0.2, rel=1e-6)
    assert launch == pytest.approx(4 * 0.05 / 4, rel=1e-6)
    assert run.reader("captures.train")(ctx) == 1


def test_phase_readers_split_each_kept_step(session):
    session["s"] = _session()
    ctx = _ctx(_trace(_marks([0.011, 0.031])))
    assert run.reader("forward_ms.train")(ctx) == pytest.approx(2.0)
    assert run.reader("backward_ms.train")(ctx) == pytest.approx(3.0)
    assert run.reader("optimizer_ms.train")(ctx) == pytest.approx(1.0)


def test_a_step_without_all_four_marks_is_dropped(session):
    session["s"] = _session()
    whole = _marks([0.011])
    cut = _marks([0.031])[1:]  # its forward mark is missing
    ctx = _ctx(_trace(whole + cut))
    steps = program_spans.phase_steps(ctx["trace"])
    assert len(steps) == 1
    assert run.reader("backward_ms.train")(ctx) == pytest.approx(3.0)
    assert run.reader("forward_ms.train")(_ctx(_trace(cut))) is None
    assert run.reader("forward_ms.train")(_ctx(_trace())) is None


def test_program_idle_counts_idle_inside_entry_spans_only(session):
    session["s"] = _session()
    # busy [0, 0.012] and [0.020, 0.050]: idle [0.012, 0.020], of which
    # the first entry span [0.010, 0.014] covers 2 ms
    tr = _trace([("k", 0.0, 0.012), ("k", 0.020, 0.050)])
    assert run.reader("program_idle.train")(_ctx(tr)) == pytest.approx(
        100 * 0.002 / 0.05)
    assert run.reader("device_idle.train")(_ctx(tr)) == pytest.approx(
        100 * 0.008 / 0.05)


@pytest.mark.parametrize("case", ["count", "name", "off_anchor", "dropped",
                                  "absent"])
def test_no_reading_when_the_session_does_not_fit(session, case):
    tr = _trace(_marks([0.011, 0.031]))
    session["s"] = _session()
    if case == "count":
        tr = _trace(spans=tr.spans[:2])
    elif case == "name":
        tr = _trace(spans=[("eval_request", s, e) if n == "train_group"
                           else (n, s, e) for n, s, e in tr.spans])
    elif case == "off_anchor":  # the second entry starts 0.1 ms late
        spans = list(session["s"].spans)
        second = next(i for i, s in enumerate(spans)
                      if s.parent < 0 and s.call == 2)
        spans[second] = spans[second]._replace(
            start_ns=spans[second].start_ns + 100_000,
            end_ns=spans[second].end_ns + 100_000)
        session["s"] = Session(spans, 0)
    elif case == "dropped":
        session["s"] = Session(session["s"].spans, 5)
    else:
        session["s"] = None
    for name in ("stage_ms.train", "launch_ms.train", "program_idle.train",
                 "captures.train"):
        assert run.reader(name)(_ctx(tr)) is None, name


def test_the_parents_session_gives_no_reading(monkeypatch):
    """A program without `last_session` (the parent's) reads as nothing,
    and nothing raises."""
    from coot_videotext_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "last_session")
    assert program_spans.session() is None
    assert run.reader("stage_ms.train")(_ctx(_trace())) is None


def test_a_real_trace_anchors_the_programs_spans():
    """Three MART train steps at tiny widths, each in the benchmark's
    span, traced on the CPU as a cell's window is: the program's spans
    anchor to the profiler's; no capture or replay happens there (the
    bodies run eagerly), so only the staging reads above 0."""
    from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
    from coot_videotext_tpu_torch.tasks.caption.model_manager import (
        create_mart_model)
    from coot_videotext_tpu_torch.tasks.caption.steps import (
        caption_train_step, init_caption_train_state)
    spec = importlib.util.spec_from_file_location(
        "coot_test_helpers", run.ROOT / "tests" / "helpers.py")
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)

    cfg = MartConfig(helpers.caption_config_dict({}))
    model = create_mart_model(cfg, 50, torch.device("cpu"), seed=3)
    state = init_caption_train_state(model, cfg, 0)
    gen = torch.Generator().manual_seed(0)
    s, n, v, t = 2, 4, cfg.max_v_len, cfg.max_t_len
    batch = {"input_ids": torch.randint(7, 50, (s, n, v + t),
                                        generator=gen),
             "video_feature": torch.randn(s, n, v + t,
                                          cfg.video_feature_size,
                                          generator=gen),
             "input_mask": torch.ones(s, n, v + t),
             "token_type_ids": torch.cat([torch.zeros(s, n, v),
                                          torch.ones(s, n, t)],
                                         -1).long(),
             "input_labels": torch.randint(0, 50, (s, n, v + t),
                                           generator=gen)}

    def work():
        for _ in range(3):
            with bench_span("train_step"):
                out = caption_train_step(state, batch, 1e-3)
            with bench_span("metrics_read"):
                float(out["loss"])
    work()  # the program's first call
    with bench_span("untraced"):  # ends the program's last session
        pass
    ctx = _ctx(traced(work), steps=3)
    assert program_spans.anchored(ctx["trace"]) is not None
    assert run.reader("stage_ms.train")(ctx) > 0.0
    assert run.reader("launch_ms.train")(ctx) == 0.0
    assert run.reader("captures.train")(ctx) == 0
    assert 0.0 < run.reader("program_idle.train")(ctx) < 100.0
    assert run.reader("forward_ms.train")(ctx) is None
