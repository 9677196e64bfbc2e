"""
The port's precompute_text (coot_videotext_tpu_torch/precompute_text.py)
against the repo-root precompute_text.py on the cases of
tests/test_precompute_text.py, with the same fake `transformers` module
(no network, no HF weights): paragraph flattening, the back-to-front
sentence cutting, the strided windows and `--layers`: the same feature
arrays and sentence splits, and the `npy` text source holding the h5's
arrays. And the port's dataset presets (data/synthetic.py
RETRIEVAL_PRESETS, data_gen_{yc2like,yc2big}.py): the parameters of the
repo-root scripts, and for seed 0 at a cut size (3 + 2 videos, the
presets' widths and distributions) the JAX generator's arrays.
"""

import ast
import json
import sys
import types
from pathlib import Path

import h5py
import numpy as np
import pytest

from coot_videotext_tpu.data.synthetic import (
    generate_retrieval_dataset as j_generate)
from coot_videotext_tpu_torch import data_gen_yc2big, data_gen_yc2like
from coot_videotext_tpu_torch import precompute_text as port
from coot_videotext_tpu_torch.data.features_loader import TextFeaturesLoader
from coot_videotext_tpu_torch.data.synthetic import (
    RETRIEVAL_PRESETS, generate_preset)
from tests.test_precompute_text import FakeModel, FakeTokenizer, _meta

REPO = Path(__file__).resolve().parent.parent
IDENT = "text_feat_fakeset_meta_all_transformers_bert-base-uncased"


class MovableFakeModel(FakeModel):
    """The fake model with the `to` of a torch module."""

    def to(self, device):
        self.device = device
        return self


@pytest.fixture()
def fake_transformers(monkeypatch):
    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda name, cache_dir=None: FakeTokenizer())
    mod.AutoModel = types.SimpleNamespace(
        from_pretrained=lambda name, cache_dir=None: MovableFakeModel())
    monkeypatch.setitem(sys.modules, "transformers", mod)
    return mod


def _both(monkeypatch, tmp_path, meta, extra=(), layers="-2,-1"):
    """(JAX script's h5 arrays, its splits, the port's h5 arrays, its
    splits, the port's npy arrays) of one dataset."""
    import precompute_text as root_script
    out = {}
    for name in ("root", "port", "npy"):
        dset = tmp_path / name / "fakeset"
        dset.mkdir(parents=True)
        (dset / "meta_all.json").write_text(json.dumps(meta))
        argv = ["fakeset", "--data_path", str(tmp_path / name),
                f"--layers={layers}", *extra]
        if name == "root":
            monkeypatch.setattr(sys, "argv", ["precompute_text.py"] + argv)
            root_script.main()
        else:
            fmt = "h5" if name == "port" else "npy"
            written = port.main(argv + ["--device", "cpu",
                                        "--output_format", fmt])
            assert written.exists() and not list(dset.glob("TEMP_*"))
        ident = f"{IDENT}_{layers}"
        splits = json.loads(
            (dset / f"{ident}_sentence_splits.json").read_text())
        if name == "npy":
            loader = TextFeaturesLoader(dset, ident, "npy", list(meta))
            arrays = {k: loader[k][0] for k in meta}
        else:
            with h5py.File(dset / f"{ident}.h5") as h5:
                arrays = {k: h5[k][:] for k in h5}
        out[name] = (arrays, splits)
    return out


def _equal(out) -> None:
    ref_arrays, ref_splits = out["root"]
    for name in ("port", "npy"):
        arrays, splits = out[name]
        assert splits == ref_splits, name
        assert arrays.keys() == ref_arrays.keys(), name
        for key, value in ref_arrays.items():
            np.testing.assert_array_equal(arrays[key], value,
                                          err_msg=f"{name} {key}")


def test_basic_extraction_matches_the_root_script(fake_transformers,
                                                  monkeypatch, tmp_path):
    meta = _meta({"vidA": ["a small sentence here.",
                           "another one follows now."],
                  "vidB": ["just one sentence."]})
    out = _both(monkeypatch, tmp_path, meta)
    _equal(out)
    arrays, splits = out["port"]
    assert arrays["vidA"].shape == (sum(splits["vidA"]), 16)


def test_layers_choice_matches_the_root_script(fake_transformers,
                                               monkeypatch, tmp_path):
    """--layers picks and concatenates the hidden states it names."""
    meta = _meta({"vidA": ["one two three.", "four five."]})
    out = _both(monkeypatch, tmp_path, meta, layers="0,-1,1")
    _equal(out)
    assert out["port"][0]["vidA"].shape[1] == 24


def test_back_to_front_cut_matches_the_root_script(fake_transformers,
                                                   monkeypatch, tmp_path):
    long_sent = " ".join(f"w{i}" for i in range(400))
    out = _both(monkeypatch, tmp_path, _meta({"vidL": [long_sent,
                                                       long_sent]}))
    _equal(out)
    splits = out["port"][1]["vidL"]
    assert sum(splits) <= 512 and splits[0] > splits[1] >= 5


def test_strided_windows_match_the_root_script(fake_transformers,
                                               monkeypatch, tmp_path):
    long_sent = " ".join(f"tok{i % 37}" for i in range(700))
    out = _both(monkeypatch, tmp_path, _meta({"vidS": [long_sent]}),
                extra=("--token_stride",))
    _equal(out)
    assert out["port"][0]["vidS"].shape[0] > 512


def test_existing_features_are_kept_and_device_is_checked(
        fake_transformers, tmp_path):
    """A second run without -f writes nothing; the default device is
    CUDA, which raises without a GPU."""
    dset = tmp_path / "fakeset"
    dset.mkdir()
    (dset / "meta_all.json").write_text(json.dumps(_meta({"v": ["a b."]})))
    argv = ["fakeset", "--data_path", str(tmp_path), "--device", "cpu"]
    assert port.main(argv) is not None
    assert port.main(argv) is None
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.main(["fakeset", "--data_path", str(tmp_path), "-f"])


def _script_kwargs(path: Path) -> dict:
    """The keyword constants of the generate_retrieval_dataset call of a
    repo-root data_gen script."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf8"))):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "generate_retrieval_dataset":
            return {kw.arg: ast.literal_eval(kw.value)
                    for kw in node.keywords}
    raise AssertionError(f"no generate_retrieval_dataset call in {path}")


@pytest.mark.parametrize("name", ["yc2like", "yc2big"])
def test_presets_are_the_root_scripts(name):
    assert RETRIEVAL_PRESETS[name] == _script_kwargs(
        REPO / f"data_gen_{name}.py")
    module = {"yc2like": data_gen_yc2like, "yc2big": data_gen_yc2big}[name]
    assert "--data_path" in module.__doc__ and callable(module.main)


@pytest.mark.parametrize("name,fmt", [("yc2like", "h5"), ("yc2big", "npy")])
def test_preset_arrays_match_jax_at_a_cut(tmp_path, name, fmt):
    """Seed 0 at 3 + 2 videos: the meta, the splits and every feature
    array equal the JAX generator's (the npy source holding the same
    arrays)."""
    cut = dict(num_videos=3, num_val_videos=2)
    ours = generate_preset(name, tmp_path / "port", feat_format=fmt, **cut)
    theirs = j_generate(tmp_path / "jax", **dict(RETRIEVAL_PRESETS[name],
                                                 **cut))
    assert ours["vid_feat_source"] == fmt
    a, b = tmp_path / "port" / name, tmp_path / "jax" / name
    meta = json.loads((b / "meta_all.json").read_text())
    assert json.loads((a / "meta_all.json").read_text()) == meta
    for field in ("vid_feat_name", "text_feat_name"):
        feat = theirs[field]
        with h5py.File(b / f"{feat}.h5") as h5:
            for key in h5:
                got = (np.load(a / feat / f"{key}.npy") if fmt == "npy"
                       else h5py.File(a / f"{feat}.h5")[key][:])
                np.testing.assert_array_equal(got, h5[key][:], err_msg=key)
    text = theirs["text_feat_name"]
    assert (a / f"{text}_sentence_splits.json").read_text() == \
        (b / f"{text}_sentence_splits.json").read_text()
    with h5py.File(b / f"{theirs['vid_feat_name']}.h5") as h5:
        assert h5[next(iter(h5))].shape[1] == 4096
