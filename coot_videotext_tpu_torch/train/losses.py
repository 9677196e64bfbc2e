"""
Retrieval losses, forward only: bidirectional max-margin contrastive loss
and the clip<->sentence cycle-consistency loss.

Port of coot_videotext_tpu/train/losses.py (reference coot/loss_fn.py), on
masked static-shape inputs: padded slots carry a validity mask and
contribute exactly zero. All loss math in float32. The cycle-consistency
subsampling takes one uniform per sequence from the Philox bits of a seed
state (ops/philox.py `uniform`, site SITE_CC), on the device and without a
host sync; with `seed_state=None` it takes the deterministic full-mean
branch (JAX :178).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from coot_videotext_tpu_torch.models.attention import masked_softmax
from coot_videotext_tpu_torch.ops import philox


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize parity, x / max(||x||, eps), in float32."""
    x = x.float()
    norm_sq = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(norm_sq, min=eps * eps))


def contrastive_loss(im: torch.Tensor, s: torch.Tensor, margin: float,
                     valid_im: Optional[torch.Tensor] = None,
                     valid_s: Optional[torch.Tensor] = None,
                     max_violation: bool = False,
                     norm: bool = True) -> torch.Tensor:
    """Bidirectional max-margin contrastive loss (JAX :47, reference
    loss_fn.py:51); pair i <-> i is the positive."""
    im = im.float()
    s = s.float()
    n = im.shape[0]
    scores = im @ s.t()
    diagonal = scores.diagonal()
    cost_s = torch.clamp(margin + scores - diagonal[:, None], min=0.0)
    cost_im = torch.clamp(margin + scores - diagonal[None, :], min=0.0)
    eye = torch.eye(n, dtype=torch.bool, device=im.device)
    pair_valid = None
    if valid_im is not None or valid_s is not None:
        ones = torch.ones(n, dtype=torch.bool, device=im.device)
        v_im = (valid_im if valid_im is not None else ones).bool()
        v_s = (valid_s if valid_s is not None else ones).bool()
        pair_valid = v_im[:, None] & v_s[None, :]
        keep = pair_valid & ~eye
    else:
        keep = ~eye
    cost_s = torch.where(keep, cost_s, torch.zeros_like(cost_s))
    cost_im = torch.where(keep, cost_im, torch.zeros_like(cost_im))
    if max_violation:
        cost_s = cost_s.max(dim=1).values
        cost_im = cost_im.max(dim=0).values
    total = cost_s.sum() + cost_im.sum()
    if norm:
        if pair_valid is not None:
            denom = v_im.float().sum() * v_s.float().sum()
            total = total / torch.clamp(denom, min=1.0)
        else:
            total = total / float(n * n)
    return total


def _soft_nn(source_emb: torch.Tensor, source_mask: torch.Tensor,
             target_emb: torch.Tensor, target_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft nearest neighbors (reference loss_fn.py:227 get_soft_nn):
    returns (soft_nn (B, Ls, D), weights (B, Ls, Lt))."""
    total_mask = source_mask[:, :, None] & target_mask[:, None, :]
    distance = -((source_emb[:, :, None, :] - target_emb[:, None, :, :])
                 ** 2).mean(dim=-1)
    weights = masked_softmax(distance, total_mask, dim=-1)
    soft_nn = (target_emb[:, None, :, :] * weights[..., None]).sum(dim=2)
    return soft_nn, weights


def _index_losses(emb_mask: torch.Tensor, beta: torch.Tensor,
                  lambda_gauss: float = 1.0, var_denom_eps: float = 1e-8,
                  var_log_eps: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index-regression losses (reference compute_loss_index_gauss :321)."""
    max_len = emb_mask.shape[1]
    idx_orig = torch.arange(max_len, dtype=torch.float32,
                            device=beta.device)[None, :]
    index_nn = (idx_orig[:, None, :] * beta).sum(dim=-1)
    pair_mask = emb_mask[:, :, None] & emb_mask[:, None, :]
    distance = (index_nn[:, :, None] - idx_orig[:, None, :]) ** 2
    distance = torch.where(pair_mask, distance, torch.zeros_like(distance))
    loss_simple = distance.diagonal(dim1=-2, dim2=-1)
    variance = (distance * beta).sum(dim=-1)
    var_reg = lambda_gauss * 0.5 * torch.log(var_log_eps + variance)
    # reference quirk (loss_fn.py:379): the regularizer is zeroed on VALID
    # positions; reproduced verbatim (the gauss path is off by default)
    var_reg = torch.where(emb_mask, torch.zeros_like(var_reg), var_reg)
    loss_gauss = loss_simple / (variance + var_denom_eps) + var_reg
    return loss_simple, loss_gauss, var_reg


def _subsampled_total(l_seq: torch.Tensor, emb_mask: torch.Tensor,
                      emb_lens: torch.Tensor, num_samples: int,
                      u: Optional[torch.Tensor],
                      batch_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Subsample per-position losses (reference get_total_loss :277-320):
    one draw over the valid positions of each sequence, mean over the
    real batch rows; u=None or num_samples=-1: the full mean. The draw of
    row i is its floor(u_i * n_i)-th valid position (u_i uniform on [0,
    1), n_i valid positions): uniform over them, as torch.multinomial of
    the mask draws in the reference."""
    if batch_valid is None:
        row_w = torch.ones(l_seq.shape[0], device=l_seq.device)
        n_rows = torch.full((), float(l_seq.shape[0]), device=l_seq.device)
    else:
        row_w = batch_valid.float()
        n_rows = torch.clamp(row_w.sum(), min=1.0)
    if num_samples == -1 or u is None:
        total = torch.where(emb_mask, l_seq, torch.zeros_like(l_seq)).sum(-1)
        total = total / torch.clamp(emb_lens.float(), min=1.0)
        return (total * row_w).sum() / n_rows
    if num_samples != 1:
        raise ValueError("only num_samples in {-1, 1} supported")
    rank = emb_mask.long().cumsum(dim=1)
    count = rank[:, -1:]
    k = torch.minimum((u[:, None] * count).long(), count - 1)
    idx = (rank <= k).sum(dim=1, keepdim=True)
    picked = l_seq.gather(1, idx.clamp(max=l_seq.shape[1] - 1))[:, 0]
    return (picked * row_w).sum() / n_rows


def cycle_consistency_loss(
        clip_emb: torch.Tensor, clip_valid: torch.Tensor,
        clip_num: torch.Tensor, sent_emb: torch.Tensor,
        sent_valid: torch.Tensor, sent_num: torch.Tensor, *,
        seed_state: Optional[torch.Tensor] = None,
        num_samples: int = 1, weight_index_simple: float = 1.0,
        weight_index_gauss: float = 0.0,
        batch_valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip<->sentence cycle consistency, full cycles (JAX :189, reference
    CycleConsistencyLoss :111). Returns (clip_clip, sent_sent); the two
    directions subsample with the uniforms (0, i) and (1, i) of
    `seed_state` at SITE_CC."""
    clip_emb = clip_emb.float()
    sent_emb = sent_emb.float()
    clip_mask = clip_valid.bool()
    sent_mask = sent_valid.bool()
    u = (None, None)
    if seed_state is not None:
        u = philox.uniform((2, clip_emb.shape[0]), seed_state,
                           philox.SITE_CC)

    def one_direction(src, src_mask, src_num, tgt, tgt_mask, u_dir):
        nn_fwd, _ = _soft_nn(src, src_mask, tgt, tgt_mask)
        _, beta = _soft_nn(nn_fwd, src_mask, src, src_mask)
        loss_simple, loss_gauss, var_reg = _index_losses(src_mask, beta)
        l_seq = (loss_gauss + var_reg) * weight_index_gauss \
            + loss_simple * weight_index_simple
        return _subsampled_total(l_seq, src_mask, src_num, num_samples,
                                 u_dir, batch_valid)

    clip_clip = one_direction(clip_emb, clip_mask, clip_num, sent_emb,
                              sent_mask, u[0])
    sent_sent = one_direction(sent_emb, sent_mask, sent_num, clip_emb,
                              clip_mask, u[1])
    return clip_clip, sent_sent


def compute_total_retrieval_loss(
        visual: Dict[str, torch.Tensor], text: Dict[str, torch.Tensor],
        cfg_weights: Dict[str, float], margin: float,
        loss_cycle_cons: float,
        seed_state: Optional[torch.Tensor] = None,
        batch_valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """
    Total retrieval loss (JAX :237, reference trainer_retrieval.py:148-233):
    weighted alignment + clustering contrastive terms on L2-normalized
    embeddings, plus cycle consistency on the raw clip/sentence embeddings.
    The context-internal cluster term is gated on weight_context_internal
    but weighted by weight_low_internal (reference quirk :181).
    """
    vid_ctx_n = l2_normalize(visual["vid_context"])
    vid_emb_n = l2_normalize(visual["vid_emb"])
    par_ctx_n = l2_normalize(text["par_context"])
    par_emb_n = l2_normalize(text["par_emb"])

    b, nc, d = visual["clip_emb"].shape
    ns = text["sent_emb"].shape[1]
    if nc != ns:
        raise ValueError("clips and sentences must be aligned 1:1")
    clip_valid = visual["clip_valid"].bool()
    sent_valid = text["sent_valid"].bool()
    bv = None
    if batch_valid is not None:
        bv = batch_valid.bool()
        clip_valid = clip_valid & bv[:, None]
        sent_valid = sent_valid & bv[:, None]
    clip_flat = l2_normalize(visual["clip_emb"].reshape(b * nc, d))
    clip_valid_flat = clip_valid.reshape(b * nc)
    sent_flat = l2_normalize(text["sent_emb"].reshape(b * ns, -1))
    sent_valid_flat = sent_valid.reshape(b * ns)

    w = cfg_weights

    def align(a, ta, va=None, vt=None):
        return contrastive_loss(a, ta, margin, va, vt)

    def cluster(a, ta, va=None, vt=None):
        return (contrastive_loss(a, a, margin, va, va)
                + contrastive_loss(ta, ta, margin, vt, vt)) / 2

    loss = torch.zeros((), device=vid_emb_n.device)
    parts: Dict[str, torch.Tensor] = {}
    if w["weight_high"] != 0:
        parts["align_high"] = align(vid_emb_n, par_emb_n, bv, bv)
        loss = loss + w["weight_high"] * parts["align_high"]
    if w["weight_low"] != 0:
        parts["align_low"] = align(clip_flat, sent_flat, clip_valid_flat,
                                   sent_valid_flat)
        loss = loss + w["weight_low"] * parts["align_low"]
    if w["weight_context"] != 0:
        parts["align_context"] = align(vid_ctx_n, par_ctx_n, bv, bv)
        loss = loss + w["weight_context"] * parts["align_context"]
    if w["weight_high_internal"] != 0:
        parts["cluster_high"] = cluster(vid_emb_n, par_emb_n, bv, bv)
        loss = loss + w["weight_high_internal"] * parts["cluster_high"]
    if w["weight_low_internal"] != 0:
        parts["cluster_low"] = cluster(clip_flat, sent_flat,
                                       clip_valid_flat, sent_valid_flat)
        loss = loss + w["weight_low_internal"] * parts["cluster_low"]
    if w["weight_context_internal"] != 0:
        parts["cluster_context"] = cluster(vid_ctx_n, par_ctx_n, bv, bv)
        loss = loss + w["weight_low_internal"] * parts["cluster_context"]
    parts["loss_contrastive"] = loss

    if loss_cycle_cons != 0:
        cc_clip, cc_sent = cycle_consistency_loss(
            visual["clip_emb"], visual["clip_valid"], visual["clip_num"],
            text["sent_emb"], text["sent_valid"], text["sent_num"],
            seed_state=seed_state, batch_valid=bv)
        parts["loss_cc"] = loss_cycle_cons * (cc_clip + cc_sent)
        loss = loss + parts["loss_cc"]
    else:
        parts["loss_cc"] = torch.zeros((), device=loss.device)
    parts["loss_total"] = loss
    return loss, parts
