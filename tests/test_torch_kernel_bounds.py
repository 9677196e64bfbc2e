"""
The Bound column of PERF.md's kernel table: `portbench.work.bound_s` over
chip_smoke.py's per-call work (`kernel_call_work`) at the clips call of a
yc2_2d3d_coot train step (`STEP_SHAPES`: 66,560 x 4096 for B1 and B5, 832
rows of L = 80 for B2, 6,656 cells of L = 80 for B3, 66,560 x 384 for B4
and B6), to the table's printed precision (ms). And phase 2's verdict on
the output of the kernel tests it runs on the card.
"""

import importlib.util
from pathlib import Path

import pytest

from portbench.work import bound_s

ROOT = Path(__file__).resolve().parents[1]

# (the table's row, the kernels line's name, the clips call's sizes, Bound)
BOUNDS = [
    ("B1 fwd", "input_fc", {"s": 66560, "width": 4096}, 0.2117),
    ("B1 bwd", "input_fc_bwd", {"s": 66560, "width": 4096}, 0.2117),
    ("B2 fwd", "genpool", {"s": 832, "length": 80}, 0.0595),
    ("B2 bwd", "genpool_bwd", {"s": 832, "length": 80}, 0.1786),
    ("B3 fwd", "attention", {"b": 832, "lq": 80, "lk": 80}, 0.0611),
    ("B3 bwd", "attention_bwd", {"b": 832, "length": 80}, 0.1234),
    ("B4 fwd", "dropout", {"shape": (66560, 384), "rate": 0.01}, 0.0305),
    ("B4 bwd", "dropout_bwd", {"shape": (66560, 384), "rate": 0.01},
     0.0305),
    ("B5", "gather", {"n": 66560, "width": 4096}, 0.3256),
    ("B6 fwd train", "coot_norm",
     {"rows": 66560, "width": 384, "residual": True}, 0.0612),
    ("B6 fwd eval", "coot_norm_eval",
     {"rows": 66560, "width": 384, "residual": True}, 0.0458),
    ("B6 bwd", "coot_norm_bwd",
     {"rows": 66560, "width": 384, "residual": True}, 0.0459),
]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("row,name,dims,bound_ms", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_kernel_table_bound(chip_smoke, row, name, dims, bound_ms):
    clips = chip_smoke.kernel_call_work(chip_smoke.STEP_SHAPES)[name][0]
    assert clips["call"] == "clips" and clips["dtype"] == "bfloat16"
    assert clips["dims"] == dims
    got = bound_s(clips["bytes"], clips["flops"], clips["dtype"]) * 1e3
    assert round(got, 4) == bound_ms, (row, got)


# (the end of the kernel tests' output, whether phase 2 takes it)
SUMMARIES = [
    ("........\n350 passed in 37.41s\n", True),
    ("350 passed, 2 warnings in 37.41s (0:00:37)\n", True),
    ("==== 350 passed in 37.41s ====\n", True),
    ("ssssssss\n350 skipped in 1.02s\n", False),
    ("349 passed, 1 skipped in 37.41s\n", False),
    ("1 failed, 349 passed in 40.00s\n", False),
    ("349 passed, 1 error in 40.00s\n", False),
    ("no tests ran in 0.01s\n", False),
    ("", False),
]


@pytest.mark.parametrize("output,taken", SUMMARIES)
def test_kernel_tests_summary(chip_smoke, output, taken, capsys):
    if taken:
        assert chip_smoke.kernel_tests_summary(output) == \
            output.strip().splitlines()[-1].strip("= ")
    else:
        with pytest.raises(SystemExit):
            chip_smoke.kernel_tests_summary(output)
        assert "every case must pass" in capsys.readouterr().err
