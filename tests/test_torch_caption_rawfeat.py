"""
The port's raw-feature MART path (`coot_model_name: null`: rgb+flow
`.npy` features, as config/caption/paper2020/yc2_mart.yaml and
anet_mart.yaml run it) against the JAX package on the CPU:

- the dataset under the YouCook2 and the ActivityNet rules, on hand-made
  annotations and features: a clip longer than the video budget (numpy
  linspace subsampling), short clips (zero padding), a timestamp past the
  video's end (the clamps), a video with a missing `_bn` file, and
  ActivityNet's `v_` prefix and `_0CqozZun3U` override: the
  frame_to_second table, the dropped names, the data and every collated
  array (recurrent and untied layouts) equal to JAX's; `preload` changes
  nothing;
- generate_caption_video_features: the same files as the JAX package's
  generator for the same annotations and seed; it refuses to overwrite a
  duration table it did not write;
- the recurrent MART model on a raw-feature batch (max_v_len 8, 20-d
  features, hidden 32, JAX-initialized weights bridged): the eval step 1e-5
  relative, the greedy decode token-identical to JAX's
  translate_batch_greedy;
- the CLI with `--video_feature_dir --device cpu` on a synthetic caption
  set with generated features: one epoch of training and validation,
  translations free of special tokens; `--validate --load_model` of one
  `.pth` through both CLIs (`ema_decay=0`) gives the same val loss and
  translations.
"""

import csv
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from coot_videotext_tpu.data.caption_dataset import (
    RecursiveCaptionDataset as JDataset)
from coot_videotext_tpu.data.synthetic import (
    generate_caption_video_features as jgenerate_features)
from coot_videotext_tpu.tasks.caption.config import MartConfig as JConfig
from coot_videotext_tpu.tasks.caption.model_manager import (
    create_mart_model as jcreate)
from coot_videotext_tpu.tasks.caption.steps import make_caption_eval_step
from coot_videotext_tpu.tasks.caption.translator import (
    Translator as JTranslator)
from coot_videotext_tpu_torch import train_caption
from coot_videotext_tpu_torch.data.caption_dataset import (
    RecursiveCaptionDataset)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_caption_dataset, generate_caption_video_features)
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.tasks.caption.steps import caption_eval_step
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mart_params_to_state_dict, load_mart_checkpoint)
from tests.helpers import caption_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIM_RESNET, DIM_BN = 12, 8
MAX_V_LEN, MAX_T_LEN = 8, 10
RAW = {"coot_model_name": None, "max_v_len": MAX_V_LEN,
       "max_t_len": MAX_T_LEN, "video_feature_size": DIM_RESNET + DIM_BN}
SPECIALS = ("[VID]", "[CLS]", "[SEP]", "[BOS]", "[PAD]")
# the model's argument order
KEYS = ("input_ids", "video_feature", "input_mask", "token_type_ids",
        "input_labels")

# name: (duration s, frames in the CSV, feature rows, timestamps); a name
# ending in "missing" lacks its _bn file
VIDEOS = {
    "long": (100.0, 200, 200, [[0, 40], [30.5, 99.9], [95, 130]]),
    "short": (10.0, 20, 20, [[1, 2.2], [3, 3.1], [8.6, 10]]),
    "odd": (10.6, 317, 21, [[0.4, 4.3], [2.2, 10.6]]),
    "_0CqozZun3U": (30.0, 900, 60, [[2, 5], [10, 29]]),
    "gone_missing": (20.0, 40, 40, [[1, 3]]),
}
WORDS = ["add", "the", "salt", "to", "pan", "and", "stir", "cut", "onion"]


def _write_raw_set(root: Path, dset: str, seed: int = 0) -> dict:
    """Annotations, a duration CSV and features for VIDEOS under `dset`'s
    naming (ActivityNet: `v_<name>` in the annotations, `<name>` in the
    CSV and the file names)."""
    rng = np.random.RandomState(seed)
    ann = root / "annotations" / dset
    feat = root / "video_features" / dset
    ann.mkdir(parents=True)
    feat.mkdir(parents=True)
    word2idx = {t: i for i, t in enumerate(
        ("[PAD]", "[CLS]", "[SEP]", "[VID]", "[BOS]", "[EOS]", "[UNK]"))}
    for w in WORDS:
        word2idx[w] = len(word2idx)
    (ann / "mart_word2idx.json").write_text(json.dumps(word2idx))
    data, rows = {}, []
    for name, (duration, frames, n_rows, stamps) in VIDEOS.items():
        key = f"v_{name}" if dset == "activitynet" else name
        sentences = [" ".join(rng.choice(WORDS + ["unseen"], 5))
                     for _ in stamps]
        data[key] = {"duration": duration, "timestamps": stamps,
                     "sentences": sentences}
        rows.append([name, duration, frames])
        np.save(feat / f"{name}_resnet.npy",
                rng.randn(n_rows, DIM_RESNET).astype(np.float32))
        if not name.endswith("missing"):
            np.save(feat / f"{name}_bn.npy",
                    rng.randn(n_rows, DIM_BN).astype(np.float32))
    with open(ann / "captioning_video_feat_duration.csv", "w",
              newline="") as f:
        csv.writer(f).writerows(rows)
    names = (("train.json", "captioning_val_1.json")
             if dset == "activitynet"
             else ("captioning_train.json", "captioning_val.json"))
    for file_name in names:
        (ann / file_name).write_text(json.dumps(data))
    return {"annotations_dir": str(root / "annotations"),
            "video_feature_dir": str(root / "video_features")}


def _assert_collated_equal(ours, ref):
    a, sizes, meta = ours
    b, rsizes, rmeta = ref
    assert sizes == rsizes and meta == rmeta
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("dset", ["youcook2", "activitynet"])
@pytest.mark.parametrize("layout", ["recurrent", "untied"])
def test_raw_dataset_matches_jax(tmp_path, dset, layout):
    info = _write_raw_set(tmp_path, dset)
    kwargs = dict(recurrent=layout == "recurrent",
                  untied=layout == "untied", coot_model_name=None,
                  video_feature_dir=info["video_feature_dir"],
                  annotations_dir=info["annotations_dir"])
    for mode in ("train", "val"):
        ref = JDataset(dset, MAX_T_LEN, MAX_V_LEN, 4, mode, **kwargs)
        ours = RecursiveCaptionDataset(dset, MAX_T_LEN, MAX_V_LEN, 4, mode,
                                       **kwargs)
        assert ours.frame_to_second == ref.frame_to_second
        assert ours.missing_video_names == ref.missing_video_names \
            == ["gone_missing"]
        assert ours.data == ref.data
        n = len(ours)
        _assert_collated_equal(
            ours.collate_fn([ours[i] for i in range(n)], batch_size=n + 2),
            ref.collate_fn([ref[i] for i in range(n)], batch_size=n + 2))
    if dset == "activitynet":
        assert ours.frame_to_second["_0CqozZun3U"] == 0.5
    # the long clip is subsampled to the whole budget, a short one padded
    name = "v_long" if dset == "activitynet" else "long"
    if layout == "recurrent":
        (long_ex, _), = [e for e in (ours[i] for i in range(n))
                         if e[1][0]["name"] == name]
        assert long_ex[0]["input_mask"][:MAX_V_LEN].all()
        assert long_ex[0]["video_feature"][MAX_V_LEN - 1:].sum() == 0
    preloaded = RecursiveCaptionDataset(dset, MAX_T_LEN, MAX_V_LEN, 4,
                                        "val", preload=True, **kwargs)
    assert len(preloaded.preloaded_videos) == n if layout == "recurrent" \
        else len(preloaded.preloaded_videos) < n
    for i in range(n):
        a, b = preloaded[i][0], ours[i][0]
        for x, y in zip(a if layout == "recurrent" else [a],
                        b if layout == "recurrent" else [b]):
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])


def test_generated_features_match_jax(tmp_path):
    """The port's generator writes the JAX generator's files."""
    for name in ("jax", "port"):
        generate_caption_dataset(tmp_path / name, num_videos=3,
                                 num_val_videos=2, seed=5)
    jinfo = jgenerate_features(tmp_path / "jax", seed=3)
    info = generate_caption_video_features(tmp_path / "port", seed=3)
    assert info["video_feature_size"] == jinfo["video_feature_size"] == 20
    csv_name = Path("annotations") / "youcook2" / \
        "captioning_video_feat_duration.csv"
    assert (tmp_path / "port" / csv_name).read_text() == \
        (tmp_path / "jax" / csv_name).read_text()
    files = sorted(p.name for p in
                   (Path(info["video_feature_dir"]) / "youcook2").iterdir())
    assert len(files) == 10
    for f in files:
        a = np.load(Path(info["video_feature_dir"]) / "youcook2" / f)
        b = np.load(Path(jinfo["video_feature_dir"]) / "youcook2" / f)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_generator_refuses_a_real_duration_table(tmp_path):
    ann = tmp_path / "annotations" / "youcook2"
    ann.mkdir(parents=True)
    for name in ("captioning_train.json", "captioning_val.json",
                 "captioning_video_feat_duration.csv"):
        shutil.copy(ROOT / "annotations" / "youcook2" / name, ann / name)
    with pytest.raises(RuntimeError, match="refusing to overwrite"):
        generate_caption_video_features(tmp_path)
    assert (ann / "captioning_video_feat_duration.csv").read_bytes() == \
        (ROOT / "annotations" / "youcook2" /
         "captioning_video_feat_duration.csv").read_bytes()


@pytest.fixture(scope="module")
def raw_model(tmp_path_factory):
    """(JAX model, params, JAX cfg, port model, cfg, a stacked raw-feature
    batch of the hand-made set): JAX-initialized weights bridged."""
    root = tmp_path_factory.mktemp("torch_caption_raw_model")
    info = _write_raw_set(root, "youcook2", seed=4)
    dataset = RecursiveCaptionDataset(
        "youcook2", MAX_T_LEN, MAX_V_LEN, 4, "val", coot_model_name=None,
        video_feature_dir=info["video_feature_dir"],
        annotations_dir=info["annotations_dir"])
    stacked, _, _ = dataset.collate_fn([dataset[i]
                                        for i in range(len(dataset))])
    inputs = [stacked[k] for k in KEYS]
    vocab = len(dataset.word2idx)
    jcfg = JConfig(caption_config_dict(RAW))
    jmodel = jcreate(jcfg, vocab, verbose=False)
    params = jmodel.init({"params": jax.random.PRNGKey(2)}, *inputs,
                         deterministic=True)["params"]
    params = jax.tree.map(lambda p: p * 8.0 if p.ndim == 2 else p, params)
    cfg = MartConfig(caption_config_dict(RAW))
    model = create_mart_model(cfg, vocab, torch.device("cpu")).eval()
    load_mart_checkpoint(model, {"model": jax_mart_params_to_state_dict(
        params)})
    return jmodel, params, jcfg, model, cfg, inputs


def test_raw_eval_step_matches_jax(raw_model):
    jmodel, params, _, model, _, inputs = raw_model
    ref = make_caption_eval_step(jmodel)(params, dict(zip(KEYS, inputs)))
    ours = caption_eval_step(model, {k: torch.from_numpy(v) for k, v in
                                     zip(KEYS, inputs)})
    loss = float(ref["loss"])
    assert abs(float(ours["loss"]) - loss) <= 1e-5 * abs(loss)
    for name in ("n_correct", "n_word"):
        assert float(ours[name]) == float(ref[name])


def test_raw_greedy_matches_jax(raw_model):
    """Recurrent greedy decoding over L = max_v_len + max_t_len raw-feature
    sequences, token for token."""
    jmodel, params, jcfg, model, cfg, inputs = raw_model
    ids, feats, masks, ttys, _ = inputs
    ref = JTranslator(jmodel, lambda: params, jcfg).translate_batch_greedy(
        ids, feats, masks, ttys)
    ours = Translator(model, cfg).translate_batch_greedy(
        *(torch.from_numpy(a) for a in (ids, feats, masks, ttys)))
    assert len(ours) == len(ref) == len(ids)
    for step, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"sentence step {step}")
    assert len(np.unique(np.stack(ours))) > 2


# ---------- the CLI ----------

SMOKE = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic caption set with generated raw features and
    synthetic_smoke.yaml turned to them (raw_smoke.yaml)."""
    root = tmp_path_factory.mktemp("torch_caption_raw_cli")
    info = generate_caption_dataset(root / "data", num_videos=10,
                                    num_val_videos=6, seed=3)
    info.update(generate_caption_video_features(root / "data", seed=1))
    config = yaml.safe_load(SMOKE.read_text())
    config.update(RAW)
    config_file = root / "default" / "raw_smoke.yaml"
    config_file.parent.mkdir()
    config_file.write_text(yaml.safe_dump(config))
    return root, info, config_file


def _argv(info, config_file, log_dir, *extra):
    return ["-c", str(config_file), "--log_dir", str(log_dir),
            "--annotations_dir", info["annotations_dir"],
            "--video_feature_dir", info["video_feature_dir"], *extra]


def test_cli_trains_and_validates(synth):
    root, info, config_file = synth
    result = train_caption.main(_argv(
        info, config_file, root / "train", "--device", "cpu", "-o",
        "train.num_epochs=1"))[0]
    assert result["model_device"].type == "cpu"
    assert result["train_unit"] == "videos"
    assert result["epochs"] == [0] and result["total_step"] == 2
    for name in ("model_0.pth", "modelema_0.pth", "optimizer_0.pth"):
        assert (result["models_dir"] / name).is_file(), name
    ann = json.loads((Path(info["annotations_dir"]) / "youcook2" /
                      "captioning_val.json").read_text())
    run = result["models_dir"].parent
    res = json.loads((run / "caption" / "translations_0_val.json")
                     .read_text())["results"]
    assert set(res) == set(ann)
    for name, sents in res.items():
        assert len(sents) == len(ann[name]["sentences"])
        for s in sents:
            for special in SPECIALS:
                assert special not in s["sentence"], s["sentence"]
    metrics = json.loads(result["metrics_file"].read_text())
    assert np.isfinite(metrics["val/loss_word"][0][1])


def test_cli_validate_matches_jax_trainer(synth, monkeypatch):
    """One `.pth` of the port's raw-feature MART model validated by both
    CLIs (`-o ema_decay=0`: the JAX CLI's `--load_model` needs it)."""
    root, info, config_file = synth
    cfg = MartConfig(yaml.safe_load(config_file.read_text()))
    model = create_mart_model(cfg, info["vocab_size"], torch.device("cpu"),
                              seed=7)
    with torch.no_grad():  # larger logits than the init: varied decodes
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    pth = root / "raw_mart.pth"
    torch.save({"model": model.state_dict()}, pth)
    flags = ["--validate", "--load_model", str(pth), "-o", "ema_decay=0"]
    result = train_caption.main(_argv(info, config_file, root / "port",
                                      *flags, "--device", "cpu"))[0]
    monkeypatch.syspath_prepend(str(ROOT))
    import train_caption as jax_cli
    monkeypatch.setattr(sys, "argv", ["train_caption.py"] + _argv(
        info, config_file, root / "jax", *flags))
    jax_cli.main()
    run = result["translation_file"].parents[1].relative_to(root / "port")
    ref = json.loads((root / "jax" / run / "caption" /
                      "translations_0_val.json").read_text())
    ours = json.loads(result["translation_file"].read_text())
    assert ours == ref
    sentences = [e["sentence"] for v in ours["results"].values() for e in v]
    assert len(set(sentences)) > 1
    (_, r), = json.loads((root / "jax" / run / "val_ep_0.json")
                         .read_text())["val/loss_word"]
    (_, o), = json.loads(result["metrics_file"].read_text())[
        "val/loss_word"]
    assert o == pytest.approx(r, rel=1e-5)
