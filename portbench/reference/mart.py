"""
Plain PyTorch reference of recurrent MART (Lei et al., ACL 2020; reference
code jayleicn/recurrent-transformer, src/rtransformer/model.py) at
inference, as `configs/mart-yc2-coot.json` states it: word, video and
token-type embeddings with their LN-Linear-ReLU-LN stacks, sincos
positions, and per layer a self-attention block over the shifted
(causal in the text) padding mask, the memory initialiser (first
sentence), the GRU-like memory updater, the memory-augmented attention,
the memory projection and the output block; the prediction head ties
nothing (share_wd_cls_weight false). Float32, or a control's precision
for the products (`precision.py`); no dropout (eval).

`forward_step(params, cfg, memories, ids, feats, masks, types)` returns
(next memories, scores (N, L, vocab)) for one sentence step, memories a
list of (N, cells, hidden) or None per layer. In training (`calls`, the
step's Philox calls) every dropout site draws the program's mask from the
benchmark's seed (`philox.py`), in the order the model makes its calls:
the word and video stacks, the embeddings, then per layer the attention
probabilities, the attention output, the memory initialiser (first
sentence), the memory updater's and the memory-augmented attention's
probabilities, and the output block.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import philox
from portbench.reference.precision import linear, matmul


def _drop(x, rate, calls):
    if calls is None or rate <= 0:
        return x
    return x * philox.keep_factor(x.shape, calls.next(),
                                  philox.SITE_DROPOUT, rate)


def _ln(p, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"],
                        p[name + ".bias"], eps)


def _lin(p, name, x, mode):
    return linear(x, p[name + ".weight"], p.get(name + ".bias"), mode)


def _positions(length: int, dim: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def shifted_mask(mask, v_len: int, t_len: int, memory_len: int = 0):
    """(N, L) -> (N, v_len + t_len, memory_len + L): memory and video
    columns always visible, text columns causal, padding columns off."""
    n, length = mask.shape
    rows = torch.arange(v_len + t_len, device=mask.device)[:, None]
    cols = torch.arange(length, device=mask.device)[None, :]
    visible = (cols < memory_len + v_len) | (
        (rows >= v_len) & (cols - memory_len <= rows))
    return visible.float()[None] * mask.float()[:, None, :]


def _attention(p, name, q_in, kv_in, mask, heads, mode, rate=0.0,
               calls=None):
    n, lq, d = q_in.shape
    dh = d // heads

    def split(x):
        return x.view(n, x.shape[1], heads, dh).transpose(1, 2)
    q = split(_lin(p, name + ".query", q_in, mode))
    k = split(_lin(p, name + ".key", kv_in, mode))
    v = split(_lin(p, name + ".value", kv_in, mode))
    scores = matmul(q, k.transpose(-1, -2), mode) / math.sqrt(dh)
    scores = scores + (1.0 - mask[:, None]) * -10000.0
    probs = _drop(torch.softmax(scores, dim=-1), rate, calls)
    ctx = matmul(probs, v, mode)
    return ctx.transpose(1, 2).reshape(n, lq, d)


def forward_step(p, cfg: dict, memories: List[Optional[torch.Tensor]],
                 ids, feats, masks, types, mode: str = "float32",
                 calls: Optional[philox.Calls] = None):
    hid = float(cfg["hidden_dropout_prob"])
    att_rate = float(cfg["attention_probs_dropout_prob"])
    mem_rate = float(cfg["memory_dropout_prob"])
    eps = float(cfg["layer_norm_eps"])
    heads = int(cfg["num_attention_heads"])
    v_len, t_len = int(cfg["max_v_len"]), int(cfg["max_t_len"])
    masks = masks.float()

    def stack(name, x):
        x = _drop(_ln(p, name + ".0", x, eps), hid, calls)
        x = torch.relu(_lin(p, name + ".2", x, mode))
        return _ln(p, name + ".4", x, eps)
    words = stack("embeddings.word_fc",
                  p["embeddings.word_embeddings.weight"][ids])
    video = stack("embeddings.video_embeddings", feats.float())
    emb = words + video + p["embeddings.token_type_embeddings.weight"][types]
    emb = emb + _positions(ids.shape[-1], emb.shape[-1], emb.device)[None]
    h = _drop(_ln(p, "embeddings.LayerNorm", emb, eps), hid, calls)
    shifted = shifted_mask(masks, v_len, t_len)
    out_memories = []
    for i, prev in enumerate(memories):
        ln = f"encoder.layer.{i}"
        att = _attention(p, ln + ".attention.self", h, h, shifted, heads,
                         mode, att_rate, calls)
        att = _ln(p, ln + ".attention.output.LayerNorm",
                  _drop(_lin(p, ln + ".attention.output.dense", att, mode),
                        hid, calls) + h, eps)
        inter = F.gelu(_lin(p, ln + ".hidden_intermediate.dense", att,
                            mode))
        if prev is None:  # the first sentence: from the video part alone
            cols = torch.arange(masks.shape[1], device=masks.device)
            vmask = torch.where(cols[None] < v_len, masks, 0.0)
            pooled = (inter * vmask[:, :, None]).sum(1) / vmask.sum(
                1, keepdim=True)
            cells = p[ln + ".memory_initilizer.init_memory_bias"].shape[1]
            pooled = pooled[:, None].repeat(1, cells, 1) + p[
                ln + ".memory_initilizer.init_memory_bias"]
            prev = _drop(_ln(
                p, ln + ".memory_initilizer.init_memory_fc.1",
                _lin(p, ln + ".memory_initilizer.init_memory_fc.0", pooled,
                     mode), eps), mem_rate, calls)
        cells = prev.shape[1]
        upd_mask = masks[:, None].repeat(1, cells, 1)
        s_t = _attention(p, ln + ".memory_updater.memory_update_attention",
                         prev, inter, upd_mask, heads, mode, att_rate, calls)
        mu = ln + ".memory_updater"
        c_t = torch.tanh(_lin(p, mu + ".mc", prev, mode)
                         + _lin(p, mu + ".sc", s_t, mode))
        z_t = torch.sigmoid(_lin(p, mu + ".mz", prev, mode)
                            + _lin(p, mu + ".sz", s_t, mode))
        out_memories.append((1 - z_t) * c_t + z_t * prev)
        concat = torch.cat([prev, inter], dim=1)
        raw = torch.cat([masks.new_ones(masks.shape[0], cells), masks], -1)
        mem_mask = shifted_mask(raw, v_len, t_len, memory_len=cells)
        mem_att = _attention(p, ln + ".memory_augmented_attention", inter,
                             concat, mem_mask, heads, mode, att_rate, calls)
        proj = _lin(p, ln + ".memory_projection", mem_att, mode)
        h = _ln(p, ln + ".output.LayerNorm",
                _drop(_lin(p, ln + ".output.dense", proj, mode), hid, calls)
                + att, eps)
    t = _ln(p, "decoder.transform.LayerNorm",
            F.gelu(_lin(p, "decoder.transform.dense", h, mode)), eps)
    scores = matmul(t, p["decoder.decoder.weight"].t(), mode) + p[
        "decoder.bias"]
    return out_memories, scores


IGNORE = -1


def smoothed_loss(scores, labels, smoothing: float, vocab: int):
    """Label-smoothed cross entropy summed over the valid tokens: the KL
    divergence to the target that puts 1 - smoothing on the label and
    the rest evenly on the other words."""
    logq = torch.log_softmax(scores.float(), dim=-1)
    valid = labels != IGNORE
    gold = logq.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    conf, other = 1.0 - smoothing, smoothing / (vocab - 1)
    cross = -(conf * gold + other * (logq.sum(-1) - gold))
    entropy = conf * math.log(conf) + (vocab - 1) * other * math.log(other)
    return torch.where(valid, cross + entropy, 0.0).sum()


def train_step(params, cfg: dict, batch, state: torch.Tensor,
               mode: str = "float32"):
    """The training forward over every sentence step of a stacked batch,
    dropout drawn from the seed state `state`, and its backward: (loss,
    float32 gradient of every parameter)."""
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in params.items()}
    calls = philox.Calls(state)
    memories = [None] * int(cfg["num_hidden_layers"])
    loss = torch.zeros((), device=state.device)
    for s in range(batch["input_ids"].shape[0]):
        memories, scores = forward_step(
            leaves, cfg, memories, batch["input_ids"][s],
            batch["video_feature"][s], batch["input_mask"][s],
            batch["token_type_ids"][s], mode, calls)
        loss = loss + smoothed_loss(scores, batch["input_labels"][s],
                                    float(cfg["label_smoothing"]),
                                    int(cfg["vocab_size"]))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


def bert_adam(params, grads, moments, lr: float, eps: float,
              clip: float = 1.0, beta1: float = 0.9, beta2: float = 0.999,
              decay: float = 0.01):
    """MART's update: the gradients clipped to global norm `clip`, then
    each to norm 1, Adam moments without bias correction, update m /
    (sqrt(v) + eps) plus weight decay on the matrices (not on biases,
    LayerNorm scales or the memory bias), p -= lr * update. Returns the
    new parameters and moments; `grads` as the optimizer got them are in
    moments["grad"]."""
    # float32 throughout, as torch's clip_grad_norm_ takes it: the norm of
    # the per-tensor norms
    norm = torch.linalg.vector_norm(torch.stack(
        [g.float().norm() for g in grads.values()]))
    scale = min(1.0, clip / (float(norm) + 1e-6))
    new_p, new_m = {}, {"m": {}, "v": {}, "grad": {}}
    for n, g in grads.items():
        g = g * scale
        g = g * min(1.0, 1.0 / (float(g.norm()) + 1e-6))
        m = beta1 * moments["m"].get(n, 0.0) + (1 - beta1) * g
        v = beta2 * moments["v"].get(n, 0.0) + (1 - beta2) * g * g
        update = m / (torch.sqrt(v) + eps)
        if params[n].dim() >= 2 and not n.endswith("init_memory_bias"):
            update = update + decay * params[n]
        new_p[n] = params[n] - lr * update
        new_m["m"][n], new_m["v"][n], new_m["grad"][n] = m, v, g
    return new_p, new_m


def ema(shadow, params, step: int, decay: float):
    """MART's EMA after the update of step `step` (counted from 0): shadow
    = d * shadow + (1 - d) * parameter, d = min(decay, (1 + step) / (10 +
    step))."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    return {n: d * shadow[n] + (1.0 - d) * p for n, p in params.items()}
