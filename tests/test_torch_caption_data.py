"""
The port's caption data path against the JAX package on the CPU:

- the collated (S, N, ...) batches of create_mart_datasets_and_loaders,
  array by array, on one synthetic set (tiny widths), reading the
  COOT embeddings from `.h5` and from `.npz`;
- the port's synthetic caption generator writes the JAX generator's files;
- the port's Treebank tokenizer against JAX's caption_dataset.word_tokenize
  on every sentence of annotations/youcook2/captioning_{train,val}.json;
- the GloVe cache read the same way;
- a port retrieval export (`.npz`) read by the port's caption dataset.
"""

import json
import shutil
from pathlib import Path

import h5py
import nltk
import numpy as np
import pytest
import torch
import yaml

from coot_videotext_tpu.data import caption_dataset as jdata
from coot_videotext_tpu.data.synthetic import (
    generate_caption_dataset as jgenerate)
from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    load_glove_matrix as jload_glove)
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.data import caption_dataset
from coot_videotext_tpu_torch.data.synthetic import (
    generate_caption_dataset, generate_retrieval_dataset)
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    load_glove_matrix)
from tests.helpers import caption_config_dict, retrieval_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REPO_ANN = ROOT / "annotations" / "youcook2"


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The JAX generator's set (h5) and the port's from the same seed
    (npz)."""
    root = tmp_path_factory.mktemp("torch_caption_data")
    jinfo = jgenerate(root / "jax", num_videos=10, num_val_videos=7, seed=3)
    info = generate_caption_dataset(root / "port", num_videos=10,
                                    num_val_videos=7, seed=3,
                                    emb_format="npz")
    return jinfo, info


def test_synthetic_generator_matches_jax(sets):
    jinfo, info = sets
    assert {k: v for k, v in jinfo.items() if not k.endswith("_dir")} == \
        {k: v for k, v in info.items() if not k.endswith("_dir")}
    for name in ("captioning_train.json", "captioning_val.json",
                 "captioning_val_para.json", "mart_word2idx.json"):
        ours = f"{info['annotations_dir']}/youcook2/{name}"
        ref = f"{jinfo['annotations_dir']}/youcook2/{name}"
        assert open(ours).read() == open(ref).read(), name
    for split in ("train", "val"):
        with h5py.File(f"{jinfo['coot_feat_dir']}/synthcoot_{split}.h5",
                       "r") as h5, \
                np.load(f"{info['coot_feat_dir']}/synthcoot_{split}.npz") \
                as npz:
            assert [k.decode() for k in h5["key"][()]] == list(npz["key"])
            for name in ("clip_num", "vid_emb", "vid_context", "clip_emb"):
                np.testing.assert_array_equal(npz[name], h5[name][()])


def _loaders(cfg_cls, create, info):
    cfg = cfg_cls(caption_config_dict({}, batch_size=3))
    return create(cfg, info["coot_feat_dir"], info["annotations_dir"],
                  seed=0)


@pytest.mark.parametrize("emb_format", ["h5", "npz"])
def test_collated_batches_match_jax(sets, emb_format):
    jinfo, info = sets
    ref = _loaders(JConfig, jdata.create_mart_datasets_and_loaders, jinfo)
    ours = _loaders(MartConfig,
                    caption_dataset.create_mart_datasets_and_loaders,
                    jinfo if emb_format == "h5" else info)
    for j_loader, loader in ((ref[2], ours[2]), (ref[3], ours[3])):
        loader.set_epoch(1)
        j_loader.set_epoch(1)
        n = 0
        for (jb, jsizes, jmeta), (b, sizes, meta) in zip(j_loader, loader):
            assert sizes == jsizes and meta == jmeta
            assert set(b) == set(jb)
            for key, value in jb.items():
                assert b[key].dtype == value.dtype, key
                np.testing.assert_array_equal(b[key], value, err_msg=key)
            n += 1
        assert n == len(j_loader) == len(loader) > 1
    # ids back to text, as the translation file gets them
    j_val, val = ref[1], ours[1]
    for i in range(len(val)):
        for step in val[i][0]:
            ids = step["input_ids"][val.max_v_len:].tolist()
            assert val.convert_ids_to_sentence(ids) == \
                j_val.convert_ids_to_sentence(ids)


def test_tokenizer_matches_jax_on_youcook2(monkeypatch):
    """Every train and val sentence, as written and lowercased (what the
    dataset tokenizes). Without punkt data JAX's word_tokenize takes the
    Treebank fallback after nltk's lookup fails; that lookup is replaced
    by the same LookupError up front, to keep the test fast."""
    try:
        nltk.data.find("tokenizers/punkt_tab/english/")
    except LookupError:
        def no_punkt(sentence):
            raise LookupError("punkt")
        monkeypatch.setattr(nltk.tokenize, "word_tokenize", no_punkt)
    sentences = set()
    for split in ("train", "val"):
        data = json.loads((REPO_ANN / f"captioning_{split}.json")
                          .read_text())
        for video in data.values():
            for s in video["sentences"]:
                sentences.update((s, s.lower()))
    assert len(sentences) > 10000
    differ = [s for s in sorted(sentences)
              if caption_dataset.word_tokenize(s) != jdata.word_tokenize(s)]
    assert not differ, differ[:5]


def test_glove_matrix_matches_jax():
    ours = load_glove_matrix(str(ROOT / "cache_caption"), "youcook2")
    ref = jload_glove(str(ROOT / "cache_caption"), "youcook2")
    assert ours.shape == (992, 300)
    np.testing.assert_array_equal(ours, ref)


def test_retrieval_export_read_by_caption_dataset(tmp_path):
    """The port's retrieval validation exports `.npz` embeddings; the
    caption dataset reads them as `<coot_model_name>_val.npz` and packs
    each video's vid + clip vectors (vidclip) into its video slot."""
    generate_retrieval_dataset(tmp_path / "data", num_videos=4,
                               num_val_videos=5, vid_feat_dim=64,
                               text_feat_dim=48, seed=0)
    cfg_dict = retrieval_config_dict({}, batch_size=5)
    path = tmp_path / "synth.yaml"
    path.write_text(yaml.safe_dump(cfg_dict), encoding="utf8")
    result = train_retrieval.main([
        "-c", str(path), "--data_path", str(tmp_path / "data"),
        "--log_dir", str(tmp_path / "exp"), "--validate",
        "--ignore_untrained", "--save_embeddings", "--device", "cpu",
        "--embeddings_format", "npz"])[0]
    emb_dir = tmp_path / "emb"
    emb_dir.mkdir()
    shutil.copy(result["emb_file"], emb_dir / "exported_val.npz")
    with np.load(result["emb_file"]) as npz:
        export = {k: npz[k] for k in npz.files}
    ann = tmp_path / "ann" / "youcook2"
    ann.mkdir(parents=True)
    shutil.copy(REPO_ANN / "mart_word2idx.json", ann)
    videos = {str(k): {"duration": 10.0 * int(n),
                       "timestamps": [[10.0 * i, 10.0 * i + 10]
                                      for i in range(int(n))],
                       "sentences": ["add the oil to the pan ."] * int(n)}
              for k, n in zip(export["key"], export["clip_num"])}
    (ann / "captioning_val.json").write_text(json.dumps(videos))
    dim_vid = export["vid_emb"].shape[1]
    dim_clip = export["clip_emb"].shape[1]
    dataset = caption_dataset.RecursiveCaptionDataset(
        "youcook2", 10, 3, 16, mode="val", coot_model_name="exported",
        coot_mode="vidclip", coot_dim_vid=dim_vid, coot_dim_clip=dim_clip,
        annotations_dir=str(tmp_path / "ann"), coot_feat_dir=str(emb_dir))
    assert len(dataset) == len(export["key"]) == 5
    starts = np.concatenate([[0], np.cumsum(export["clip_num"])])
    for i in range(len(dataset)):
        steps, _ = dataset[i]
        assert len(steps) == export["clip_num"][i]
        for c, step in enumerate(steps):
            slot = step["video_feature"][1]
            np.testing.assert_array_equal(slot[:dim_vid],
                                          export["vid_emb"][i])
            np.testing.assert_array_equal(
                slot[dim_vid:], export["clip_emb"][starts[i] + c])
            assert not step["video_feature"][2:].any()
