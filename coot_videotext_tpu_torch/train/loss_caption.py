"""
Caption losses: label smoothing KL with SUM reduction, the mean cross
entropy, and the token-accuracy counts.

Port of coot_videotext_tpu/train/loss_caption.py (reference
mart/loss_caption.py:10-46): loss = sum over valid tokens of
KL(smoothed_one_hot || softmax(logits)), where the smoothed target puts
`1 - ls` on the gold class and `ls / (V - 1)` elsewhere; tokens with label
== ignore_index (-1) are dropped. The constant sum p*log(p) term is
included (F.kl_div semantics) so logged loss values match the reference.

Under a data-parallel mesh the label-smoothing loss and the counts are
sums, which the ranks' sums add up to; the mean cross entropy divides by
the token count of the global batch, which the step passes as `count`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

IGNORE = -1


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float, vocab_size: int,
                         ignore_index: int = IGNORE) -> torch.Tensor:
    """logits (..., V), labels (...) in [-1, V-1] -> scalar f32 sum."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    confidence = 1.0 - label_smoothing
    smoothing_value = label_smoothing / (vocab_size - 1)
    gold_logq = torch.gather(log_probs, -1, safe.unsqueeze(-1)).squeeze(-1)
    sum_logq = log_probs.sum(dim=-1)
    cross = -(confidence * gold_logq
              + smoothing_value * (sum_logq - gold_logq))
    # constant entropy term of the smoothed target (F.kl_div includes it)
    p_logp = (confidence * math.log(confidence)
              + (vocab_size - 1) * smoothing_value
              * math.log(smoothing_value))
    per_token = cross + p_logp
    return torch.where(valid, per_token, torch.zeros_like(per_token)).sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE,
                       count: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """nn.CrossEntropyLoss(ignore_index=-1): MEAN over valid tokens (used
    when label_smoothing == 0, reference model.py:1397). `count`: the
    valid tokens of the global batch under data parallelism; None: those
    of `labels`."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(log_probs, -1, safe.unsqueeze(-1)).squeeze(-1)
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    if count is None:
        count = valid.float().sum()
    return total / count.clamp(min=1.0)


def token_accuracy_counts(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = IGNORE
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_correct, n_valid) as f32 tensors for the token-accuracy meters
    (reference trainer_caption.py:39 cal_performance)."""
    pred = logits.argmax(dim=-1)
    valid = labels != ignore_index
    correct = (pred == labels) & valid
    return correct.float().sum(), valid.float().sum()
