"""
The port's data-prep, results and profiling tools against the JAX
package's and the repo-root scripts that drive it, on the CPU, on the same
inputs: the text pipelines (goldens and JAX's output), the meta converters
and both `data_read_*` scripts (byte-equal meta_all.json), the vocabulary
on the real YouCook2 captions and the GloVe cache (equal arrays),
`view_results` and the `show_*` tables (equal text, on the reference's
published run files and on trees the port's CLIs write), the offline
embedding retrieval (equal printed metrics, h5 and the legacy keys; the
npz export too) and the profiling keys and units.
"""

import json
import logging
import re
import shutil
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from coot_videotext_tpu.data import meta_convert as jmeta
from coot_videotext_tpu.data import text as jtext
from coot_videotext_tpu.utils import profiling as jprofiling
from coot_videotext_tpu.utils import view_results as jview
from coot_videotext_tpu_torch import (
    data_read_activitynet_meta, data_read_youcook2_meta,
    embeddings_retrieval, mart_build_vocab, show_caption, show_mart,
    show_retrieval, train_caption, train_retrieval)
from coot_videotext_tpu_torch.data import meta_convert, text
from coot_videotext_tpu_torch.data.synthetic import (
    generate_caption_dataset, generate_retrieval_dataset)
from coot_videotext_tpu_torch.examples.mlp_mnist import MLPModel
from coot_videotext_tpu_torch.utils import profiling, view_results

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROVIDED = REPO / "tests" / "fixtures" / "provided_experiments"
PARAGRAPH = [
    "A man and a women introduce themselves to the camera. "
    "They start to talk to each other.",
    " As the conversation ensues another woman approaches the woman "
    "and takes away her water bottle.",
    " Afterwards the man starts to play the bongos and woman starts "
    "to dance.",
    " As the woman dances on a man on a bike passes by and starts to "
    "observe what's going on..."]


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x"] + list(argv))
    return module.main()


# ---------------- text ----------------

@pytest.mark.parametrize("name", sorted(text.TextPreprocessing.values()))
def test_text_pipelines_match_jax(name):
    paragraphs = [PARAGRAPH, ["one  sentence. two", "three..."],
                  ["Hello world", "  spaced \t out  text . "]]
    for paragraph in paragraphs:
        assert text.get_text_preprocessor(name)(paragraph) == \
            jtext.get_text_preprocessor(name)(paragraph)


def test_text_goldens():
    """The reference goldens of tests/test_utils_parity.py."""
    assert text.get_text_preprocessor("bert_paper")(PARAGRAPH) == [
        "[CLS] A man and a women introduce themselves to the camera "
        "[SEP] They start to talk to each other [SEP]",
        "As the conversation ensues another woman approaches the "
        "woman and takes away her water bottle [SEP]",
        "Afterwards the man starts to play the bongos and woman "
        "starts to dance [SEP]",
        "As the woman dances on a man on a bike passes by and starts "
        "to observe what's going on... [SEP]"]
    out = text.preprocess_paragraph(
        PARAGRAPH, begin_sentence_token="[BOS]", end_sentence_token="[EOS]",
        begin_paragraph_token="[BOP]", end_paragraph_token="[EOP]",
        remove_ending_dot=False, replace_inside_dots=True)
    assert out[0] == ("[BOP][BOS] A man and a women introduce themselves "
                      "to the camera. [EOS] [BOS] They start to talk to "
                      "each other. [EOS]")
    assert out[-1].endswith("going on... [EOS] [EOP]")
    with pytest.raises(NotImplementedError):
        text.get_text_preprocessor("nope")
    with pytest.raises(ValueError, match="Empty sentence"):
        text.preprocess_paragraph(["ok", "   "])


# ---------------- meta converters ----------------

def test_meta_converters_match_jax():
    release = json.loads((REPO / "annotations" / "youcook2" /
                          "youcookii_annotations_trainval.json").read_text())
    assert meta_convert.convert_youcook2(release["database"]) == \
        jmeta.convert_youcook2(release["database"])
    splits = {"val_1": {
        "v_abc": {"duration": 10.0, "timestamps": [[5.0, 1.0], [1, 2]],
                  "sentences": ["a\nb", "c\t d"]}}}
    ours = meta_convert.convert_activitynet(splits)
    assert ours == jmeta.convert_activitynet(splits)
    assert ours[1] == ["abc_val_1"]
    with pytest.raises(ValueError, match="non-positive"):
        meta_convert.convert_youcook2({"x": {
            "subset": "training", "duration": 1.0,
            "annotations": [{"segment": [2, 1], "sentence": "s"}]}})


@pytest.mark.parametrize("dataset", ["youcook2", "activitynet"])
def test_data_read_scripts_match_jax(dataset, tmp_path, monkeypatch):
    import data_read_activitynet_meta as jax_anet
    import data_read_youcook2_meta as jax_yc2
    monkeypatch.chdir(REPO)  # both read annotations/ from the cwd
    jax_tool, port_tool = {
        "youcook2": (jax_yc2, data_read_youcook2_meta),
        "activitynet": (jax_anet, data_read_activitynet_meta)}[dataset]
    _run_jax_main(jax_tool, ["--data_path", str(tmp_path / "jax")],
                  monkeypatch)
    out = port_tool.main(["--data_path", str(tmp_path / "port")])
    assert out == tmp_path / "port" / dataset / "meta_all.json"
    ref = tmp_path / "jax" / dataset / "meta_all.json"
    assert out.read_bytes() == ref.read_bytes()
    assert len(json.loads(out.read_text())) > 1000


# ---------------- vocabulary ----------------

def test_vocabulary_matches_jax_on_youcook2():
    from mart_build_vocab import build_vocab_idx
    captions = str(REPO / "annotations" / "youcook2" /
                   "captioning_train.json")
    ours = mart_build_vocab.build_vocab_idx(captions)
    assert ours == build_vocab_idx(captions)
    assert list(ours)[:7] == ["[PAD]", "[CLS]", "[SEP]", "[VID]", "[BOS]",
                              "[EOS]", "[UNK]"]
    shipped = json.loads((REPO / "annotations" / "youcook2" /
                          "mart_word2idx.json").read_text())
    assert len(set(ours) & set(shipped)) / len(shipped) > 0.95


def test_glove_cache_matches_jax(tmp_path, monkeypatch):
    import mart_build_vocab as jax_tool
    word2idx = json.loads((REPO / "annotations" / "youcook2" /
                           "mart_word2idx.json").read_text())
    words = [w for w, _ in sorted(word2idx.items(), key=lambda x: x[1])]
    rng = np.random.RandomState(1)
    glove = tmp_path / "glove.txt"
    glove.write_text("\n".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.randn(300))
        for w in words[7::3]))
    loaded = mart_build_vocab.load_glove(glove)
    assert set(loaded) == set(jax_tool.load_glove(glove))
    cache = {}
    for name, run in (
            ("jax", lambda out: _run_jax_main(jax_tool, [
                "youcook2", "--raw_glove_path", str(glove),
                "--cache_dir", str(out)], monkeypatch)),
            ("port", lambda out: mart_build_vocab.main([
                "youcook2", "--raw_glove_path", str(glove),
                "--cache_dir", str(out)]))):
        np.random.seed(0)  # the missing words' random vectors
        monkeypatch.chdir(REPO)
        run(tmp_path / name)
        cache[name] = np.asarray(torch.load(
            tmp_path / name / "youcook2_vocab_glove.pt",
            weights_only=False))
    assert cache["port"].shape == (len(word2idx), 300)
    np.testing.assert_array_equal(cache["port"], cache["jax"])
    np.testing.assert_allclose(cache["port"][7], loaded[words[7]],
                               rtol=1e-6)


# ---------------- results tables ----------------

def _table_lines(out: str):
    """The printed table, without the log lines (they carry times)."""
    return [line for line in out.splitlines()
            if not re.match(r"^\s*(INFO|DEBUG|WARNING)\b", line)
            and "Matching in" not in line and "Metric groups" not in line]


@pytest.fixture(scope="module")
def port_trees(tmp_path_factory):
    """Experiment trees written by the port's CLIs: two runs of the
    retrieval smoke config and one caption run (also laid out as the
    legacy "mart" type)."""
    root = tmp_path_factory.mktemp("port_trees")
    generate_retrieval_dataset(root / "ret", num_videos=16,
                               num_val_videos=8, seed=0)
    train_retrieval.main([
        "-c", str(REPO / "config" / "retrieval" / "default" /
                  "synthetic_smoke.yaml"), "--data_path", str(root / "ret"),
        "--log_dir", str(root / "exp"), "--device", "cpu", "--num_runs",
        "2", "-o", "train.num_epochs=2"])
    generate_caption_dataset(root / "cap")
    train_caption.main([
        "-c", str(REPO / "config" / "caption" / "default" /
                  "synthetic_smoke.yaml"), "--device", "cpu",
        "--annotations_dir", str(root / "cap" / "annotations"),
        "--coot_feat_dir", str(root / "cap" / "provided_embeddings"),
        "--log_dir", str(root / "exp"), "-o", "train.num_epochs=1"])
    shutil.copytree(root / "exp" / "caption", root / "exp" / "mart")
    logging.getLogger().handlers.clear()
    return root / "exp"


SHOW_ARGS = [[], ["--mean"], ["--mean_all", "-m", "all"],
             ["--last", "--compact", "--sort", "alpha"]]


@pytest.mark.parametrize("args", SHOW_ARGS,
                         ids=["default", "mean", "mean_all", "last"])
@pytest.mark.parametrize("tool", ["show_retrieval", "show_caption",
                                  "show_mart"])
def test_show_tables_match_jax(tool, args, port_trees, capsys,
                               monkeypatch):
    import show_caption as jcap
    import show_mart as jmart
    import show_retrieval as jret
    jax_tool, port_tool = {
        "show_retrieval": (jret, show_retrieval),
        "show_caption": (jcap, show_caption),
        "show_mart": (jmart, show_mart)}[tool]
    dirs = [port_trees] + ([PROVIDED] if tool == "show_retrieval" else [])
    for log_dir in dirs:
        argv = ["--log_dir", str(log_dir)] + args
        _run_jax_main(jax_tool, argv, monkeypatch)
        ref = _table_lines(capsys.readouterr().out)
        port_tool.main(argv)
        ours = _table_lines(capsys.readouterr().out)
        assert ours == ref
        assert any("experiment" in line for line in ours), ours


def test_view_results_reproduces_the_published_table():
    """The reference README numbers from its own run files, equal to
    JAX's collector and averages."""
    groups = view_results.match_folder(PROVIDED, "retrieval")
    assert groups == jview.match_folder(PROVIDED, "retrieval")
    collector = view_results.collect_results_data(
        "retrieval", groups, log_dir=str(PROVIDED))
    assert collector == jview.collect_results_data(
        "retrieval", groups, log_dir=str(PROVIDED))
    mean_c, std_c, num = view_results.average_results_data(
        collector, group_by_names=True)
    assert (mean_c, std_c, num) == jview.average_results_data(
        collector, group_by_names=True)
    np.testing.assert_allclose(
        mean_c["yc2_2d3d_coot_run"]["val_base/vid2par-r1"], 0.4872,
        atol=5e-5)
    lines = {}
    for name, module in (("port", view_results), ("jax", jview)):
        out = []
        module.output_results(collector, mean=True, compact=True,
                              sort="alpha", print_fn=lambda *a: out.append(
                                  " ".join(map(str, a))))
        lines[name] = out
    assert lines["port"] == lines["jax"]
    assert any("anet_coot_run (3)" in line for line in lines["port"])


# ---------------- offline embedding retrieval ----------------

def _retrieval_rows(out: str):
    return [line for line in out.splitlines()
            if line.split(" ")[0] in ("vid", "par", "cli", "sen")]


@pytest.mark.parametrize("schema", ["current", "legacy"])
def test_embeddings_retrieval_matches_jax(schema, tmp_path, capsys,
                                          monkeypatch):
    import test_embeddings_retrieval as jax_tool
    rng = np.random.RandomState(0)
    n, d = 40, 16
    keys = {"current": ("vid_emb", "par_emb", "clip_emb", "sent_emb"),
            "legacy": ("vid_norm", "par_norm", "clip_norm", "sent_norm")}
    arrays = {}
    for i, k in enumerate(keys[schema]):
        base = rng.randn(n + 10 * (i >= 2), d).astype(np.float32)
        if i % 2:  # the second of each pair: the first plus noise
            base = arrays[keys[schema][i - 1]] + 0.8 * base
        arrays[k] = base / np.linalg.norm(base, axis=1, keepdims=True)
    path = tmp_path / "embeddings_0.h5"
    with h5py.File(path, "w") as h5:
        for k, v in arrays.items():
            h5[k] = v
    _run_jax_main(jax_tool, [str(path)], monkeypatch)
    ref = _retrieval_rows(capsys.readouterr().out)
    result = embeddings_retrieval.main([str(path), "--device", "cpu"])
    ours = _retrieval_rows(capsys.readouterr().out)
    assert len(ref) == 4 and ours == ref
    assert 0 < result["v2p"]["r1"] < 1
    # the port's npz export of the same arrays
    np.savez(tmp_path / "embeddings_0.npz", **arrays)
    embeddings_retrieval.main([str(tmp_path / "embeddings_0.npz"),
                               "--device", "cpu"])
    assert _retrieval_rows(capsys.readouterr().out) == ref


# ---------------- profiling ----------------

def test_profiling_keys_and_units(monkeypatch):
    ref = jprofiling.profile_device_and_ram()
    ours = profiling.profile_device_and_ram()
    assert set(ours) == set(ref)
    assert ours["device_mem_used"] == ours["device_mem_limit"] == 0.0
    np.testing.assert_allclose(ours["ram_total"], ref["ram_total"],
                               rtol=1e-9)  # GB (1024^3 bytes) in both
    assert 0 <= ours["ram_percent"] <= 1
    assert 0 < ours["ram_used"] < ours["ram_total"]
    # without psutil: /proc/meminfo gives the same total
    monkeypatch.setitem(sys.modules, "psutil", None)
    meminfo = profiling.profile_device_and_ram()
    np.testing.assert_allclose(meminfo["ram_total"], ref["ram_total"],
                               rtol=1e-3)
    assert 0 <= meminfo["ram_percent"] <= 1


def test_set_seed_and_count_parameters():
    profiling.set_seed(7)
    a = (np.random.randint(0, 1000, 5), torch.rand(3))
    jprofiling.set_seed(7)
    b = np.random.randint(0, 1000, 5)
    profiling.set_seed(7)
    np.testing.assert_array_equal(a[0], b)
    assert torch.equal(torch.rand(3), a[1])
    model = MLPModel(hidden_dim=8)
    model.fc2.bias.requires_grad_(False)
    assert profiling.count_parameters(model) == (
        784 * 8 + 8 + 8 * 10 + 10, 784 * 8 + 8 + 8 * 10)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "profiles") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(Path(prof.trace_file).read_text())
    assert prof.trace_file.parent == tmp_path / "profiles"
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
