"""
Plain PyTorch reference of the Transformer-XL caption model that MART
(Lei et al., ACL 2020) trains as its baseline: Dai et al. 2019's relative
attention as the reference code writes it (jayleicn/recurrent-transformer,
src/rtransformer/model.py :848-1260, model type `xl`), at the widths of
`configs/xl-yc2-raw.json`. Float32, or a control's precision for the
products (`precision.py`).

A sentence step: word, video and token-type embeddings with their
LN-Dropout-Linear-ReLU-LN stacks, no position table, LayerNorm and
dropout; then the encoder: the position table [sin | cos] over klen - 1
... 0 (klen = memory + segment rows) and the segment, each dropped; per
layer the relative attention over [memory; segment] (q, k and v from one
product without bias, q the segment's rows; the content score
(q + r_w_bias) . k and the position score (q + r_r_bias) . r_net(table)
aligned by rel_shift (pad a zero column, view, drop the first row); their
sum over sqrt(d_head), masked where `make_mask` says, softmax, no dropout
on the probabilities; o_net without bias, dropped, post-LN at eps 1e-5),
then the feed-forward (Linear-ReLU-Dropout-Linear-Dropout, post-LN at
eps 1e-5); the last output dropped into the prediction head (dense, gelu,
LN, the decoder matrix and its bias). The next step's memories are the
n_layers + 1 hidden states (the dropped segment and every layer's
output), detached. `make_mask`: the previous segment's padding mask
(the teacher sentence's in training) before the shifted mask times the
padding mask. The loss is MART's label-smoothed sum (`mart.py`).

In training (`calls`, the step's Philox calls) every dropout site draws
the program's mask from the benchmark's seed (`philox.py`) in the
program's order: the word stack, the video stack, the embeddings, the
position table, the segment, per layer the attention output and the two
feed-forward drops, then the last output.

Departures from the reference code:
    - r_w_bias and r_r_bias start normal(initializer_range) (the reference
      code leaves them uninitialised; the weights come from the harness);
    - masked scores are filled with -inf as the reference code fills them;
      the program fills -32752 (no row is wholly masked, so both give 0
      after the softmax);
    - BertAdam's decay follows the program's rule (no decay on biases,
      LayerNorm scales and the r-biases); the reference code's name rule
      also keeps the r-biases out (their names hold "bias") but decays the
      XL's `layer_norm.weight`, whose name lacks "LayerNorm.weight".
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import philox
from portbench.reference.mart import (
    _drop, _lin, _ln, bert_adam, shifted_mask, smoothed_loss)
from portbench.reference.precision import matmul

XL_LN_EPS = 1e-5
R_BIASES = ("encoder.r_w_bias", "encoder.r_r_bias")


def positions(klen: int, dim: int, device) -> torch.Tensor:
    """(klen, dim): [sin | cos] of positions klen - 1 down to 0."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, dim, 2.0, device=device)
                                / dim))
    pos = torch.arange(klen - 1, -1, -1.0, device=device)
    sinusoid = torch.outer(pos, inv_freq)
    return torch.cat([sinusoid.sin(), sinusoid.cos()], dim=-1)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(N, H, Q, K): pad a zero column in front, view as (K + 1, Q), drop
    the first row, view back."""
    n, h, q, k = x.shape
    padded = torch.cat([x.new_zeros(n, h, q, 1), x], dim=-1)
    return padded.view(n, h, k + 1, q)[:, :, 1:].reshape(n, h, q, k)


def make_mask(masks, prev_masks, v_len: int, t_len: int) -> torch.Tensor:
    """(N, L, [L +] L) bool, True = masked."""
    visible = shifted_mask(masks, v_len, t_len)
    if prev_masks is not None:
        visible = torch.cat([prev_masks.float()[:, None, :].expand_as(
            visible), visible], dim=2)
    return visible < 0.5


def _rel_attention(p, name, w, r, mem, masked, heads, mode, rate, calls):
    n, qlen, d = w.shape
    dh = d // heads
    cat = w if mem is None else torch.cat([mem, w], dim=1)
    klen = cat.shape[1]
    q, k, v = _lin(p, name + ".qkv_net", cat, mode).chunk(3, dim=-1)
    q = q[:, -qlen:].reshape(n, qlen, heads, dh).transpose(1, 2)
    k = k.reshape(n, klen, heads, dh).transpose(1, 2)
    v = v.reshape(n, klen, heads, dh).transpose(1, 2)
    r_k = _lin(p, name + ".r_net", r, mode).view(klen, heads, dh)
    w_bias = p["encoder.r_w_bias"][None, :, None]
    r_bias = p["encoder.r_r_bias"][None, :, None]
    ac = matmul(q + w_bias, k.transpose(-1, -2), mode)
    bd = rel_shift(matmul(q + r_bias, r_k.permute(1, 2, 0), mode))
    score = (ac + bd) * (1.0 / math.sqrt(dh))
    score = score.masked_fill(masked[:, None], float("-inf"))
    vec = matmul(torch.softmax(score, dim=-1), v, mode)
    vec = vec.transpose(1, 2).reshape(n, qlen, d)
    out = _drop(_lin(p, name + ".o_net", vec, mode), rate, calls)
    return _ln(p, name + ".layer_norm", w + out, XL_LN_EPS)


def _feed_forward(p, name, x, mode, rate, calls):
    h = _drop(torch.relu(_lin(p, name + ".CoreNet.0", x, mode)), rate,
              calls)
    h = _drop(_lin(p, name + ".CoreNet.3", h, mode), rate, calls)
    return _ln(p, name + ".layer_norm", x + h, XL_LN_EPS)


def forward_step(p, cfg: dict, mems: Optional[List[torch.Tensor]],
                 prev_masks, ids, feats, masks, types,
                 mode: str = "float32",
                 calls: Optional[philox.Calls] = None):
    """One sentence step: (the next memories, scores (N, L, vocab)).
    `mems` None on the first step, else the n_layers + 1 hidden states of
    the step before; `prev_masks` that step's padding mask."""
    hid = float(cfg["hidden_dropout_prob"])
    eps = float(cfg["layer_norm_eps"])
    heads = int(cfg["num_attention_heads"])
    masks = masks.float()

    def stack(name, x):
        x = _drop(_ln(p, name + ".0", x, eps), hid, calls)
        x = torch.relu(_lin(p, name + ".2", x, mode))
        return _ln(p, name + ".4", x, eps)
    words = stack("embeddings.word_fc",
                  p["embeddings.word_embeddings.weight"][ids])
    video = stack("embeddings.video_embeddings", feats.float())
    emb = words + video + p["embeddings.token_type_embeddings.weight"][types]
    emb = _drop(_ln(p, "embeddings.LayerNorm", emb, eps), hid, calls)
    masked = make_mask(masks, prev_masks, int(cfg["max_v_len"]),
                       int(cfg["max_t_len"]))
    qlen = emb.shape[1]
    klen = qlen + (0 if mems is None else mems[0].shape[1])
    r = _drop(positions(klen, emb.shape[-1], emb.device), hid, calls)
    h = _drop(emb, hid, calls)
    hids = [h]
    for i in range(int(cfg["num_hidden_layers"])):
        ln = f"encoder.layers.{i}"
        h = _rel_attention(p, ln + ".dec_attn", h, r,
                           None if mems is None else mems[i], masked,
                           heads, mode, hid, calls)
        h = _feed_forward(p, ln + ".pos_ff", h, mode, hid, calls)
        hids.append(h)
    h = _drop(h, hid, calls)
    t = _ln(p, "decoder.transform.LayerNorm",
            F.gelu(_lin(p, "decoder.transform.dense", h, mode)), eps)
    scores = matmul(t, p["decoder.decoder.weight"].t(), mode) + p[
        "decoder.bias"]
    return [x.detach() for x in hids], scores


def train_step(params, cfg: dict, batch, state: torch.Tensor,
               mode: str = "float32"):
    """The training forward over every sentence step of a stacked batch
    (the teacher sentence's mask as the next step's previous mask),
    dropout drawn from the seed state `state`, and its backward: (loss,
    float32 gradient of every parameter)."""
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in params.items()}
    calls = philox.Calls(state)
    mems, prev = None, None
    loss = torch.zeros((), device=state.device)
    for s in range(batch["input_ids"].shape[0]):
        mems, scores = forward_step(
            leaves, cfg, mems, prev, batch["input_ids"][s],
            batch["video_feature"][s], batch["input_mask"][s],
            batch["token_type_ids"][s], mode, calls)
        prev = batch["input_mask"][s]
        loss = loss + smoothed_loss(scores, batch["input_labels"][s],
                                    float(cfg["label_smoothing"]),
                                    int(cfg["vocab_size"]))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


def xl_adam(params, grads, moments, lr: float, eps: float):
    """`mart.bert_adam` with the two (heads, d_head) r-biases handed in
    flat, so that its decay, which takes every matrix, skips them as the
    program's rule does; the same arithmetic otherwise."""
    shapes = {n: params[n].shape for n in R_BIASES}

    def flat(d):
        return {n: (t.reshape(-1) if n in shapes and torch.is_tensor(t)
                    else t) for n, t in d.items()}

    def back(d):
        return {n: (t.view(shapes[n]) if n in shapes else t)
                for n, t in d.items()}
    new_p, new_m = bert_adam(flat(params), flat(grads),
                             {k: flat(v) for k, v in moments.items()},
                             lr, eps)
    return back(new_p), {k: back(v) for k, v in new_m.items()}
