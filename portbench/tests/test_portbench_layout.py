"""BENCHMARK.json resolves to its files by name, and nothing under
portbench/ imports JAX, flax or the JAX package."""

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import run

HERE = Path(run.__file__).resolve().parent
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    entry, cfg, traffic, limits = run.load_cell(BENCH, workload)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    assert hasattr(kind, "Cell")
    assert limits and all(v > 0 for v in limits.values())
    reported = {m["name"] for m in run.metrics_of(BENCH, workload,
                                                  "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    layer = run.metrics_of(BENCH, workload, "per_layer", reported)
    assert layer and all(m["moves"] in reported for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(run.reader(metric))


def test_names_units_and_files():
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[s]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (run.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


FORBIDDEN = {"jax", "jaxlib", "flax", "coot_videotext_tpu"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse((HERE / path).read_text(encoding="utf8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(tops), (path, tops)


def test_references_import_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        text = path.read_text(encoding="utf8")
        assert "coot_videotext_tpu_torch" not in text, path
