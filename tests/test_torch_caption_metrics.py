"""
The port's caption metrics and its `train_caption --validate` CLI against
the JAX package on the CPU:

- BLEU 1-4, METEOR (METEOR-lite without a JVM), ROUGE-L, CIDEr, the
  sentence statistics and the repetition metrics: equal to JAX's on one
  translation file built from the real YouCook2 val annotations;
- the port's Porter stemmer against nltk's on every word of the YouCook2
  captions;
- the CLI on config/caption/default/synthetic_smoke.yaml with
  `--device cpu --validate --load_model <pth>`: the same `.pth` given to
  the JAX package's train_caption.py (its MartTrainer, through
  torch_convert.convert_model_file) gives the same translation json and
  the same metrics;
- the untied, xl and joint single-sentence models and beam search
  validate through the CLI on the CPU;
- what the CLI refuses, as the JAX package does: beam search on the xl or
  a single-sentence model, the tied decoder narrower than hidden; and the
  card without one, an untrained model without --ignore_untrained.
"""

import json
import re
import sys
from pathlib import Path

import pytest
import torch

from coot_videotext_tpu.data.synthetic import (
    generate_caption_dataset as jgenerate)
from coot_videotext_tpu.tasks.caption import evaluate_language as jlang
from coot_videotext_tpu.tasks.caption import evaluate_repetition as jrep
from coot_videotext_tpu.tasks.caption import evaluate_stats as jstats
from coot_videotext_tpu_torch import train_caption
from coot_videotext_tpu_torch.tasks.caption import (
    evaluate_language, evaluate_repetition, evaluate_stats)
from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
from coot_videotext_tpu_torch.tasks.caption.metrics.porter import (
    PorterStemmer)
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    create_mart_model)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ANN = ROOT / "annotations" / "youcook2"
SMOKE = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"
N_VIDEOS = 60


@pytest.fixture(scope="module")
def scores(tmp_path_factory):
    """(JAX results, port results) of every evaluator on one translation
    file: the first 60 val videos, each sentence cut or word-shuffled from
    the ground truth by a fixed rule, so every metric is off its limits."""
    root = tmp_path_factory.mktemp("torch_caption_metrics")
    gt = json.loads((ANN / "captioning_val.json").read_text())
    results = {}
    for v, (name, video) in enumerate(list(gt.items())[:N_VIDEOS]):
        sents = []
        for i, (ts, s) in enumerate(zip(video["timestamps"],
                                        video["sentences"])):
            words = s.split()
            if (v + i) % 3 == 0:
                words = words[:max(2, len(words) // 2)]
            elif (v + i) % 3 == 1:
                words = words[1:] + words[:1]
            sents.append({"sentence": " ".join(words), "timestamp": ts,
                          "gt_sentence": s})
        results[name] = sents
    submission = root / "translations.json"
    submission.write_text(json.dumps({"version": "VERSION 1.0",
                                      "results": results}))
    refs = [ANN / "captioning_val_para.json"]
    out = []
    for lang, stats, rep in ((jlang, jstats, jrep), (
            evaluate_language, evaluate_stats, evaluate_repetition)):
        out.append({
            **lang.evaluate_language_files(submission, refs,
                                           all_scorer=True),
            **stats.evaluate_stats_files(submission, refs[0]),
            **rep.evaluate_repetition_files(submission, refs[0])})
    return out


@pytest.mark.parametrize("metric", [
    ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"), ("METEOR",), ("ROUGE_L",),
    ("CIDEr",), ("submission", "gt_stat"),
    ("re1", "re2", "re3", "re4", "num_pred", "num_gt", "num_evaluated")],
    ids=["bleu", "meteor", "rouge_l", "cider", "stats", "repetition"])
def test_metric_matches_jax(scores, metric):
    ref, ours = scores
    for name in metric:
        assert ours[name] == ref[name], name
    if metric[0] == "METEOR":
        assert 0 < ours["METEOR"] < 1  # a real score, not the -999 stub


def test_porter_stemmer_matches_nltk():
    from nltk.stem.porter import PorterStemmer as NltkPorter
    words = set(json.loads((ANN / "mart_word2idx.json").read_text()))
    for split in ("train", "val"):
        data = json.loads((ANN / f"captioning_{split}.json").read_text())
        for video in data.values():
            for s in video["sentences"]:
                words.update(re.findall(r"[A-Za-z']+", s))
    assert len(words) > 2000
    ours, ref = PorterStemmer(), NltkPorter()
    differ = [w for w in sorted(words) if ours.stem(w) != ref.stem(w)]
    assert not differ, differ[:10]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """A synthetic caption set and a reference-layout checkpoint of the
    port's model at synthetic_smoke.yaml's widths."""
    root = tmp_path_factory.mktemp("torch_caption_cli")
    info = jgenerate(root / "data", num_videos=8, num_val_videos=10,
                     seed=1)
    cfg = MartConfig(load_yaml_config_file(SMOKE))
    model = create_mart_model(cfg, info["vocab_size"], torch.device("cpu"),
                              seed=7)
    with torch.no_grad():  # larger logits than the init: varied decodes
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    pth = root / "mart.pth"
    torch.save({"model": model.state_dict()}, pth)
    return root, info, pth


def _argv(root, info, log_dir, *extra):
    return ["-c", str(SMOKE), "--validate", "--log_dir", str(log_dir),
            "--annotations_dir", info["annotations_dir"],
            "--coot_feat_dir", info["coot_feat_dir"], *extra]


def test_cli_validate_matches_jax_trainer(smoke, monkeypatch):
    """Both CLIs with `-o ema_decay=0`: the JAX trainer's `--load_model`
    of a `.pth` fails with an EMA (torch_convert.convert_model_file sets
    `ema` to the params tree, MartTrainer._eval_params reads `.shadow`);
    without one it evaluates the loaded params, as the port does."""
    root, info, pth = smoke
    flags = ["--load_model", str(pth), "-o", "ema_decay=0"]
    result = train_caption.main(_argv(root, info, root / "port", *flags,
                                      "--device", "cpu"))[0]
    assert result["model_device"].type == "cpu"
    assert result["batch_device"].type == "cpu"
    assert result["num_batches"] == 2
    # S x (max_t_len + 1) full forwards a batch, S its padded step count
    assert all(f > 0 and f % 13 == 0 for f in result["forwards"])

    monkeypatch.syspath_prepend(str(ROOT))
    import train_caption as jax_cli
    monkeypatch.setattr(sys, "argv", ["train_caption.py"] + _argv(
        root, info, root / "jax", *flags))
    jax_cli.main()

    run = Path("caption") / "default" / "synthetic_smoke_run1"
    translations = run / "caption" / "translations_0_val.json"
    ref = json.loads((root / "jax" / translations).read_text())
    ours = json.loads(result["translation_file"].read_text())
    assert ours == ref
    sentences = [e["sentence"] for v in ours["results"].values() for e in v]
    assert len(set(sentences)) > 1
    ref_metrics = json.loads((root / "jax" / run / "val_ep_0.json")
                             .read_text())
    our_metrics = json.loads(result["metrics_file"].read_text())
    caption_keys = [k for k in ref_metrics
                    if k.startswith(("cap", "val/", "val_base"))]
    assert len(caption_keys) >= 20
    for key in caption_keys:
        (_, r), = ref_metrics[key]
        (_, o), = our_metrics[key]
        if key.startswith("val"):  # the teacher-forced loss and accuracy
            assert o == pytest.approx(r, rel=1e-5), key
        else:
            assert o == r, key


@pytest.mark.parametrize("case", ["untied", "xl", "single", "beam"])
def test_cli_validates_variant(smoke, case):
    """Each caption variant the CLI once refused validates on the CPU (an
    untrained model): translations of every val video."""
    root, info, _ = smoke
    over = {"untied": "recurrent=false,untied=true", "xl": "xl=true",
            "single": "recurrent=false", "beam": "use_beam=true"}[case]
    result = train_caption.main(_argv(
        root, info, root / f"variant_{case}", "--device", "cpu",
        "--ignore_untrained", "-o", over))[0]
    assert result["model_device"].type == "cpu"
    res = json.loads(result["translation_file"].read_text())["results"]
    assert len(res) == 10  # the synthetic val videos


@pytest.mark.parametrize("case", ["beam_xl", "beam_single", "tied_width",
                                  "cuda", "untrained"])
def test_cli_refuses(smoke, case):
    """What the JAX package refuses too: beam search on the xl or a
    single-sentence model (JAX translator.py:592-596), the tied decoder
    with word_vec_size != hidden_size (config.py:138-141); and the card
    without one, an untrained model without --ignore_untrained."""
    root, info, _ = smoke
    extra = {"beam_xl": ["--device", "cpu", "-o", "use_beam=true,xl=true"],
             "beam_single": ["--device", "cpu", "-o",
                             "use_beam=true,recurrent=false"],
             "tied_width": ["--device", "cpu", "-o",
                            "share_wd_cls_weight=true,word_vec_size=16"],
             "cuda": [],
             "untrained": ["--device", "cpu"]}[case]
    argv = _argv(root, info, root / "refused", *extra)
    expect = {"beam_xl": (ValueError, "recurrent MART model"),
              "beam_single": (ValueError, "recurrent MART model"),
              "tied_width": (AssertionError, "word_vec_size == hidden_size"),
              "cuda": (RuntimeError, "--device cpu"),
              "untrained": (ValueError, "ignore_untrained")}[case]
    if case == "cuda" and torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(expect[0], match=expect[1]):
        train_caption.main(argv)
