"""
Copy of coot_videotext_tpu/tasks/caption/evaluate_language.py (pure Python;
the port keeps its own copy so it never imports the JAX package).

Paragraph-level caption evaluation: BLEU1-4 / METEOR / ROUGE-L / CIDEr.

Behavioral port of reference mart/evaluate_language.py:45-233 on top of the
native metric implementations (tasks/caption/metrics): identical
parse_sent/parse_para preprocessing, paragraph joining of submission
sentences, v_-key normalization, and the METEOR crash semantics (scorer
unavailable/crashed -> score -999, evaluation continues).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, Optional, Union

from coot_videotext_tpu_torch.tasks.caption.metrics.bleu import Bleu
from coot_videotext_tpu_torch.tasks.caption.metrics.cider import Cider
from coot_videotext_tpu_torch.tasks.caption.metrics.meteor import (
    Meteor, make_meteor)
from coot_videotext_tpu_torch.tasks.caption.metrics.meteor_lite import (
    MeteorLite)
from coot_videotext_tpu_torch.tasks.caption.metrics.rouge import Rouge


def parse_sent(sent: str) -> List[str]:
    res = re.sub("[^a-zA-Z]", " ", sent)
    return res.strip().lower().split()


def parse_para(para: str) -> List[str]:
    para = para.replace("..", ".")
    para = para.replace(".", " endofsent")
    return parse_sent(para)


class CaptionEvaluator:
    """Evaluate model output against ground truth (reference :45)."""

    def __init__(self, ground_truth_filenames, prediction_filename,
                 verbose: bool = False, all_scorer: bool = False) -> None:
        self.verbose = verbose
        self.all_scorer = all_scorer
        self.ground_truths = self.import_ground_truths(
            ground_truth_filenames)
        self.prediction = self.import_prediction(prediction_filename)

        # Primary: the reference's METEOR 1.5 jar. Fallback when no
        # JVM/jar exists: the hermetic METEOR-lite (metrics/meteor_lite
        # .py). COOT_METEOR_LITE=0 disables the fallback and restores
        # the reference's strict crashed-scorer semantics (-999).
        met = make_meteor()
        if met is None:
            if os.environ.get("COOT_METEOR_LITE", "1") != "0":
                met = MeteorLite()
                print("Meteor jar unavailable; scoring with the "
                      "hermetic METEOR-lite (COOT_METEOR_LITE=0 for "
                      "the reference's -999 semantics).")
            else:
                print("Meteor couldn't start (no java/jar); "
                      "scoring -999.")
        if self.verbose or self.all_scorer:
            self.scorers = [
                (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
                (met, "METEOR"),
                (Rouge(), "ROUGE_L"),
                (Cider(), "CIDEr"),
            ]
        else:
            self.scorers = [(met, "METEOR")]
        self.n_ref_vids = set()
        self.scores = {}

    @staticmethod
    def ensure_caption_key(data):
        if len(data) == 0:
            return data
        if not list(data.keys())[0].startswith("v_"):
            data = {"v_" + k: data[k] for k in data}
        return data

    def import_prediction(self, prediction_filename):
        submission = json.loads(
            Path(prediction_filename).read_text(
                encoding="utf8"))["results"]
        para_submission = {}
        for idx in submission:
            para_submission[idx] = "".join(
                info["sentence"] + ". " for info in submission[idx])
        return self.ensure_caption_key(para_submission)

    def import_ground_truths(self, filenames):
        gts = []
        self.n_ref_vids = set()
        for filename in filenames:
            gt = json.loads(Path(filename).read_text(encoding="utf8"))
            self.n_ref_vids.update(gt.keys())
            gts.append(self.ensure_caption_key(gt))
        return gts

    def get_gt_vid_ids(self):
        return sorted(self.n_ref_vids if not self.ground_truths else
                      {k for gt in self.ground_truths for k in gt})

    def evaluate(self) -> None:
        self.scores = self.evaluate_para()

    def evaluate_para(self):
        """Average metrics across videos (reference :136)."""
        gt_vid_ids = self.get_gt_vid_ids()
        vid2idx = {k: i for i, k in enumerate(gt_vid_ids)}
        gts = {vid2idx[k]: [] for k in gt_vid_ids}
        for gt in self.ground_truths:
            for k in gt_vid_ids:
                if k in gt:
                    gts[vid2idx[k]].append(" ".join(parse_sent(gt[k])))
        res = {vid2idx[k]:
               [" ".join(parse_sent(self.prediction[k]))]
               if k in self.prediction and len(self.prediction[k]) > 0
               else [""] for k in gt_vid_ids}

        output = {}
        for scorer, method in self.scorers:
            if scorer is None:
                score = -999
                scores = [-999] * len(gts)
            else:
                try:
                    score, scores = scorer.compute_score(gts, res)
                except (ValueError, FileNotFoundError, AttributeError,
                        BrokenPipeError) as e:
                    if isinstance(scorer, Meteor):
                        print(f"Scorer {type(scorer)} crashed with {e}.")
                        try:
                            scorer.lock.release()
                        except (AttributeError, RuntimeError):
                            pass
                        score = -999
                        scores = [-999] * len(gts)
                    else:
                        raise
            if isinstance(method, list):
                for m, name in enumerate(method):
                    output[name] = score[m]
            else:
                output[method] = score
        output["num_videos"] = len(res)
        return output


def evaluate_language_files(submission_file, references_files,
                            output_file: Optional[Union[str, Path]] = None,
                            verbose: bool = False,
                            all_scorer: bool = True):
    """(reference :222)."""
    evaluator = CaptionEvaluator(
        ground_truth_filenames=references_files,
        prediction_filename=submission_file, verbose=verbose,
        all_scorer=all_scorer)
    evaluator.evaluate()
    scores = evaluator.scores
    if output_file is not None:
        Path(output_file).write_text(json.dumps(scores),
                                     encoding="utf8")
    return scores
