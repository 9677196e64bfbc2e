"""
Retrieval eval step (port of coot_videotext_tpu/tasks/retrieval/steps.py::
make_retrieval_eval_step :144-209): the 4-net forward in the compute dtype,
the val loss parts and the raw and L2-normalized embeddings, all on the
batch's device. The train step comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from coot_videotext_tpu_torch.models.retrieval import RetrievalModel
from coot_videotext_tpu_torch.train.losses import (
    compute_total_retrieval_loss, l2_normalize)

VISUAL_KEYS = ("vid_emb", "clip_emb", "vid_context", "clip_valid",
               "clip_num")
TEXT_KEYS = ("par_emb", "sent_emb", "par_context", "sent_valid", "sent_num")
EMB_KEYS = ("vid_emb", "par_emb", "clip_emb", "sent_emb", "vid_context",
            "par_context")


@torch.inference_mode()
def retrieval_eval_step(model: RetrievalModel,
                        batch: Dict[str, torch.Tensor], *,
                        loss_weights: Dict[str, float], margin: float,
                        loss_cycle_cons: float,
                        compute_dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Returns (embeddings, loss parts). `generator` drives the
    cycle-consistency subsampling; None takes its deterministic full
    mean."""
    out = model(batch, compute_dtype=compute_dtype)
    visual = {k: out[k] for k in VISUAL_KEYS}
    text = {k: out[k] for k in TEXT_KEYS}
    _, parts = compute_total_retrieval_loss(
        visual, text, loss_weights, margin, loss_cycle_cons,
        generator=generator, batch_valid=batch["batch_valid"])
    embs = {f"{k}_before_norm": out[k] for k in EMB_KEYS}
    embs.update({k: l2_normalize(out[k]) for k in EMB_KEYS})
    for k in ("clip_valid", "sent_valid", "clip_num", "sent_num"):
        embs[k] = out[k]
    return embs, parts
