"""
Retrieval evaluation: rank metrics of a cosine-similarity matrix.

Port of coot_videotext_tpu/tasks/retrieval/eval.py (API parity with
reference nntrainer/retrieval.py:12-98). Ranks are computed on the
embeddings' device in one O(n^2) comparison, rank_i = #{j : sim[i,j] >
sim[i,i]}, instead of the reference's per-row argsort.
"""

from __future__ import annotations

from timeit import default_timer as timer
from typing import Callable, Dict, Tuple

import numpy as np
import torch

VALKEYS = ["r1", "r5", "r10", "r50", "medr", "meanr", "sum"]
VALHEADER = ("Retriev | R@1   | R@5   | R@10  | R@50  | MeanR |  MedR |"
             "    Sum")


def retrieval_results_to_str(results: Dict[str, float], name: str) -> str:
    """One formatted metrics row (reference :16)."""
    return ("{:7s} | {:.3f} | {:.3f} | {:.3f} | {:.3f} | {:5.1f} | "
            "{:5.1f} | {:6.3f}").format(
                name, *[results[key] for key in VALKEYS])


def _ranks_both(emb1: torch.Tensor, emb2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(ranks 1->2, top1 1->2, ranks 2->1, top1 2->1) on the embeddings'
    device, float32 similarities."""
    sim = emb1.float() @ emb2.float().t()
    diag = sim.diagonal()
    ranks12 = (sim > diag[:, None]).sum(dim=1)
    ranks21 = (sim > diag[None, :]).sum(dim=0)
    return ranks12, sim.argmax(dim=1), ranks21, sim.argmax(dim=0)


def _metrics_from_ranks(ranks: np.ndarray) -> Dict[str, float]:
    ranks = np.asarray(ranks, np.float64)
    n = len(ranks)
    r1 = float((ranks < 1).sum() / n)
    r5 = float((ranks < 5).sum() / n)
    r10 = float((ranks < 10).sum() / n)
    r50 = float((ranks < 50).sum() / n)
    medr = float(np.floor(np.median(ranks)) + 1)
    meanr = float(ranks.mean() + 1)
    return {"r1": r1, "r5": r5, "r10": r10, "r50": r50, "medr": medr,
            "meanr": meanr, "sum": r1 + r5 + r50}


def compute_retrieval(data_collector: Dict[str, np.ndarray], key1: str,
                      key2: str, device: torch.device,
                      print_fn: Callable = print
                      ) -> Tuple[Dict[str, float], Dict[str, float], float,
                                 str]:
    """Bidirectional retrieval metrics between two embedding sets
    (reference :31); the ranks are computed on `device`."""
    start_time = timer()
    emb1 = torch.as_tensor(np.asarray(data_collector[key1])).to(device)
    emb2 = torch.as_tensor(np.asarray(data_collector[key2])).to(device)
    ranks12, _, ranks21, _ = _ranks_both(emb1, emb2)
    res1 = _metrics_from_ranks(ranks12.cpu().numpy())
    res2 = _metrics_from_ranks(ranks21.cpu().numpy())
    sum_at_1 = (res1["r1"] + res2["r1"]) / 2
    print_fn(retrieval_results_to_str(res1, key1[:3]))
    print_fn(retrieval_results_to_str(res2, key2[:3]))
    result_str = (f"{key1[:3]}{key2[:3]} ({emb1.shape[0]}) in "
                  f"{timer() - start_time:.3f}s, ")
    return res1, res2, sum_at_1, result_str
