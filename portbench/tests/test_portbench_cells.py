"""The cells driven end to end on the CPU at a small size (the harness's
look for a chip skipped): the program agrees with the plain reference;
the control, the reference one precision below in the program's place,
and each fault a cell can have come out not correct."""

import time

import pytest
import torch

from portbench import check, run
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234567


def _run(workload, overrides, seconds=0.3):
    return run.execute(tiny.BENCH, workload, SEED, seconds, False, CPU,
                       time.time(), overrides=overrides)


@pytest.mark.parametrize("workload", ["coot-yc2-2d3d.train",
                                      "coot-yc2-2d3d.embed"])
def test_coot_program_agrees_with_the_reference(workload):
    """In float32: the limits are the card's bfloat16 readings at the
    cell's size, which the CPU's bfloat16 arithmetic at a tiny size does
    not reproduce; in float32 the two sides agree far inside them."""
    res = _run(workload, tiny.coot(workload, f32=True))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", ["mart-yc2-coot.greedy",
                                      "mart-yc2-coot.train"])
def test_mart_program_agrees_with_the_reference(workload):
    res = _run(workload, SMALL[workload](), seconds=0.1)
    assert res["correct"], res["checks"]


SMALL = {"coot-yc2-2d3d.train": lambda: tiny.coot("coot-yc2-2d3d.train"),
         "coot-yc2-2d3d.embed": lambda: tiny.coot("coot-yc2-2d3d.embed"),
         "mart-yc2-coot.greedy": tiny.mart,
         "mart-yc2-coot.train": tiny.mart_train}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_one_precision_below_is_not_correct(workload):
    """The reference in fp8 (bf16 cells) or TF32 (f32 cells) in the
    program's place fails the cell's limits."""
    o = SMALL[workload]()
    kind = __import__(f"portbench.kinds.{o['traffic']['kind']}",
                      fromlist=["Cell"])
    cell = kind.Cell(o["config"], o["traffic"], SEED, CPU)
    cell.free_program()
    ref = cell.reference("float32")
    numbers = cell.compare(cell.reference(cell.control_mode), ref)
    assert not check.verdict(numbers, o["limits"]), numbers


@pytest.mark.parametrize("workload,fault", [
    ("coot-yc2-2d3d.train", "half_batch"),
    ("coot-yc2-2d3d.train", "update_skipped"),
    ("coot-yc2-2d3d.embed", "answer_altered"),
    ("mart-yc2-coot.greedy", "token_altered"),
    ("mart-yc2-coot.train", "half_batch")])
def test_a_planted_fault_is_not_correct(workload, fault):
    res = _run(workload, dict(SMALL[workload](), fault=fault), seconds=0.1)
    assert not res["correct"], res["checks"]


def test_a_train_step_that_leaves_its_state_unchanged_is_not_correct(
        monkeypatch):
    from coot_videotext_tpu_torch.train import optim
    monkeypatch.setattr(optim.RAdam, "step",
                        lambda self, grads, lr=None: None)
    res = _run("coot-yc2-2d3d.train", tiny.coot("coot-yc2-2d3d.train",
                                                f32=True))
    assert not res["correct"]
    assert res["checks"]["change6_leaf_gap"]["value"] == pytest.approx(1.0)


def test_an_ema_left_unchanged_is_not_correct(monkeypatch):
    from coot_videotext_tpu_torch.train import optim
    monkeypatch.setattr(optim.EMA, "update", lambda self, step: None)
    res = _run("mart-yc2-coot.train", tiny.mart_train(), seconds=0.1)
    assert not res["correct"]
    assert res["checks"]["ema3_median_leaf_gap"]["value"] == pytest.approx(
        1.0)


def test_the_harness_refuses_to_run_without_enough_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reached")
    assert run.main(["--workload", "coot-yc2-2d3d.train", "--seed", "1",
                     "--seconds", "1"]) != 0
