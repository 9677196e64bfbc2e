"""
The caption eval step (MART, recurrent).

Port of coot_videotext_tpu/tasks/caption/steps.py::make_caption_eval_step
:103 (reference mart/trainer_caption.py:~420): the teacher-forced S-step
forward, the caption loss and the token-accuracy counts, under
torch.inference_mode(). The results stay device tensors, read once per
batch by the caller.
"""

from __future__ import annotations

from typing import Dict

import torch

from coot_videotext_tpu_torch.models.caption.mart import (
    RecursiveTransformer)
from coot_videotext_tpu_torch.train.loss_caption import token_accuracy_counts


def caption_eval_step(model: RecursiveTransformer,
                      batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """{loss (sum over steps), n_correct, n_word} of one stacked batch,
    as 0-d f32 tensors on the batch's device."""
    model.eval()
    with torch.inference_mode():
        loss, scores_list = model(
            batch["input_ids"], batch["video_feature"], batch["input_mask"],
            batch["token_type_ids"], batch["input_labels"])
        n_correct = loss.new_zeros(())
        n_word = loss.new_zeros(())
        for idx, scores in enumerate(scores_list):
            c, w = token_accuracy_counts(scores, batch["input_labels"][idx])
            n_correct = n_correct + c
            n_word = n_word + w
    return {"loss": loss, "n_correct": n_correct, "n_word": n_word}
