"""
Plain PyTorch reference of COOT retrieval as `configs/coot-yc2-2d3d.json`
states it: the on-device sampling of id batches (centre sampling, or the
train jitter), the feature gathers with their truncated-normal noise, the
four transformer nets, the contrastive and cycle-consistency loss, and
autograd gradients. Float32 throughout (or a control's precision for the
products, `precision.py`), no kernels, no graphs, no packing shortcuts
beyond the packed part layout that the sampler defines.

It follows COOT (Ging et al., NeurIPS 2020; reference code
simon-ging/coot-videotext, models/transformer_legacy.py, poolers.py,
loss_fn.py) as the configuration sets it up: per net an input norm (the
COOT layer norm: Bessel std, eps added to the std), an input FC with GELU
for the local nets, sincos positions, one post-LN encoder layer (8 heads,
FFN 384, GELU, dropout at the attention probabilities, after the
attention block and twice in the FFN), a GenPool pooler (2 heads, hidden
768, dropout at its hidden pre-activation, logits and weights) for the
local nets, and for the global nets a cross-attention layer with the
local context as a length-1 query and the "avg_special" pool.

Random draws: every draw of a train step comes from the benchmark's seed
through the Philox stream (`philox.py`), in the order the step makes its
calls: the store noise's seed first, then each dropout site in forward
order. So dropout masks, the frame jitter, the noise and the
cycle-consistency subsampling are those the program draws from the same
seed, and a comparison sees precision, not sampling.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from portbench.reference import philox
from portbench.reference.precision import linear, matmul

INF = 32752.0  # the finite fill of masked scores
NETS = ("net_video_local", "net_video_global", "net_text_local",
        "net_text_global")


# ---------- sampling and gathers (the step's batch) ----------

def draw_uniforms(state: torch.Tensor, b: int, shapes: Dict[str, int]):
    nv = b * shapes["lv"]
    u = philox.uniform((nv + b * shapes["n_parts"] * shapes["lc"],), state,
                       philox.SITE_JITTER)
    return (u[:nv].view(b, shapes["lv"]),
            u[nv:].view(b, shapes["n_parts"], shapes["lc"]))


def _frames(offset, n_frames, slots, max_frames, u=None):
    t = torch.clamp(n_frames, max=max_frames)
    i = torch.arange(slots, dtype=torch.float32, device=offset.device)
    n_f = n_frames.to(torch.float32)[..., None]
    t_f = torch.clamp(t.to(torch.float32), min=1.0)[..., None]
    if u is None:
        pos = torch.floor(i * n_f / t_f + n_f / t_f / 2.0)
    else:
        pos = torch.floor((i + u) * n_f / t_f)
    pos = torch.minimum(torch.clamp(pos.to(torch.int32), min=0),
                        torch.clamp(n_frames - 1, min=0)[..., None])
    mask = torch.arange(slots, device=offset.device) < t[..., None]
    idx = torch.where(mask, offset[..., None] + pos, offset[..., None])
    return idx, mask, t


def sample_batch(tables: Dict[str, torch.Tensor], dp_idx: torch.Tensor,
                 batch_valid: torch.Tensor, shapes: Dict[str, int],
                 max_frames: int, uniforms=None) -> Dict[str, torch.Tensor]:
    """Datapoint ids -> frame and token indices, masks and lengths, the
    parts packed into the budgets of `shapes` (valid slots first, in
    (video, part) order)."""
    b = dp_idx.shape[0]
    lv, lc, ls, lp = shapes["lv"], shapes["lc"], shapes["ls"], shapes["lp"]
    n_parts = shapes["n_parts"]
    dev = dp_idx.device
    m = {k: v[dp_idx.long()] for k, v in tables.items()}
    u_vid, u_clip = uniforms if uniforms is not None else (None, None)
    vid_idx, vid_mask, vid_len = _frames(m["vid_off"], m["vid_nf"], lv,
                                         max_frames, u_vid)
    clip_idx, clip_mask, clip_len = _frames(m["seg_off"], m["seg_nf"], lc,
                                            max_frames, u_clip)
    clip_valid = m["seg_valid"] & batch_valid[:, None]
    clip_mask = clip_mask & clip_valid[:, :, None]
    clip_len = torch.where(clip_valid, clip_len, 0)
    first = torch.arange(n_parts, device=dev)[None, :] == 0
    pad_first = ~batch_valid[:, None] & first
    clip_valid = clip_valid | pad_first
    clip_mask[:, :, 0] |= pad_first
    clip_len = torch.maximum(clip_len, pad_first.to(torch.int32))
    par_len, sent_len = m["par_len"], m["sent_len"]
    tok = torch.arange(lp, device=dev)[None, :]
    par_idx = m["text_off"][:, None] + torch.minimum(
        tok, torch.clamp(par_len - 1, min=0)[:, None])
    par_mask = tok < par_len[:, None]
    par_mask[:, 0] = True
    stok = torch.arange(ls, device=dev)[None, None, :]
    sent_idx = m["sent_off"][:, :, None] + torch.minimum(
        stok, torch.clamp(sent_len - 1, min=0)[:, :, None])
    sent_valid = (sent_len > 0) & batch_valid[:, None]
    sent_mask = (stok < sent_len[:, :, None]) & sent_valid[:, :, None]
    sent_valid = sent_valid | pad_first
    sent_mask[:, :, 0] |= pad_first
    sent_lens = torch.where(sent_valid, torch.clamp(sent_len, min=1), 0)
    vid_mask[:, 0] = True
    batch = {
        "batch_valid": batch_valid, "vid_idx": vid_idx, "vid_mask": vid_mask,
        "vid_len": torch.clamp(vid_len, min=1), "clip_valid": clip_valid,
        "clip_num": torch.clamp(m["clip_num"], min=1), "par_idx": par_idx,
        "par_mask": par_mask, "par_len": torch.clamp(par_len, min=1),
        "sent_valid": sent_valid,
        "sent_num": torch.clamp(m["sent_num"], min=1)}

    def pack(valid2d, arrs, budget):
        """Valid slots first into `budget` rows; at the dense size every
        slot in (video, part) order, as the dense layout runs them."""
        flat = valid2d.reshape(-1)
        if budget < flat.numel():
            slots = torch.argsort(torch.where(flat, 0, 1),
                                  stable=True)[:budget]
        else:
            slots = torch.arange(flat.numel(), device=dev)
        return (slots // n_parts, slots % n_parts,
                valid2d.reshape(-1)[slots],
                [a.reshape((-1,) + a.shape[2:])[slots] for a in arrs])

    for part, idx, mask, lens, valid, budget in (
            ("clip", clip_idx, clip_mask, clip_len, clip_valid,
             shapes["pack_clips"]),
            ("sent", sent_idx, sent_mask, sent_lens, sent_valid,
             shapes["pack_sents"])):
        owner, pos, sv, (pi, pm, pl) = pack(valid, [idx, mask, lens], budget)
        batch.update({f"{part}_idx": pi, f"{part}_mask": pm,
                      f"{part}_len": pl, f"{part}_owner": owner,
                      f"{part}_pos": pos, f"{part}_slot_valid": sv})
    return batch


def build_tables(meta, vid_off, text_off, shapes: Dict[str, int],
                 batch_size: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, int]]:
    """Per-video tables of the split (`data.split_meta`, frame and token
    offsets into the stores) and the shapes with the part budgets: no
    batch of `batch_size` distinct videos holds more parts than the
    largest `batch_size` counts, plus one live slot a padded row, rounded
    up to 64 and at most the dense size."""
    n, n_parts = len(meta), shapes["n_parts"]
    t = {k: torch.zeros(n, dtype=torch.int64) for k in
         ("vid_off", "vid_nf", "clip_num", "text_off", "sent_num",
          "par_len")}
    for k in ("seg_off", "seg_nf", "sent_len", "sent_off"):
        t[k] = torch.zeros((n, n_parts), dtype=torch.int64)
    t["seg_valid"] = torch.zeros((n, n_parts), dtype=torch.bool)
    for i, v in enumerate(meta):
        t["vid_off"][i], t["vid_nf"][i] = int(vid_off[i]), v["nf"]
        t["clip_num"][i] = len(v["segs"])
        for j, (s, nf) in enumerate(v["segs"]):
            t["seg_off"][i, j] = int(vid_off[i]) + s
            t["seg_nf"][i, j] = nf
            t["seg_valid"][i, j] = True
        t["text_off"][i] = int(text_off[i])
        t["sent_num"][i] = len(v["splits"])
        ptr = 0
        for j, length in enumerate(v["splits"]):
            t["sent_len"][i, j] = length
            t["sent_off"][i, j] = int(text_off[i]) + ptr
            ptr += length
        t["par_len"][i] = ptr

    def budget(counts):
        need = sum(sorted(counts, reverse=True)[:batch_size]) + batch_size
        return min(-(-need // 64) * 64, batch_size * n_parts)
    shapes = dict(shapes, pack_clips=budget([len(v["segs"]) for v in meta]),
                  pack_sents=budget([len(v["splits"]) for v in meta]))
    return {k: v.to(device) for k, v in t.items()}, shapes


_GATHERS = (("vid_idx", "vid_feat", 0, philox.SITE_NOISE_VIDEO),
            ("clip_idx", "clip_feat", 0, philox.SITE_NOISE_CLIP),
            ("par_idx", "par_feat", 1, philox.SITE_NOISE_PARAGRAPH),
            ("sent_idx", "sent_feat", 1, philox.SITE_NOISE_SENTENCE))


def gather(batch, vid_store, text_store, frames_noise=0.0, words_noise=0.0,
           seed: Optional[philox.Seed] = None) -> Dict[str, torch.Tensor]:
    """The feature rows of the batch's indices in float32, plus the
    truncated-normal noise of each gathered slot when `seed` is given."""
    out = dict(batch)
    for idx_key, feat_key, which, site in _GATHERS:
        idx = out.pop(idx_key)
        store = (vid_store, text_store)[which]
        rows = store[idx.reshape(-1).long()].float()
        std = frames_noise if which == 0 else words_noise
        if seed is not None and std:
            rows = rows + std * philox.truncnorm(rows.shape, seed, site)
        out[feat_key] = rows.view(*idx.shape, store.shape[1])
    return out


# ---------- the nets ----------

class Net:
    """The forward of one net over a dict of float32 parameters named as
    the program's state dict, with dropout keyed on `calls` (None: eval)."""

    def __init__(self, params: Dict[str, torch.Tensor], prefix: str,
                 cfg: dict, mode: str, calls: Optional[philox.Calls]):
        self.p = {k[len(prefix) + 1:]: v for k, v in params.items()
                  if k.startswith(prefix + ".")}
        self.cfg = cfg
        self.mode = mode
        self.calls = calls

    def seed(self, rate) -> Optional[philox.Seed]:
        """The next call's seed; None in eval or without dropout."""
        if self.calls is None or rate <= 0:
            return None
        return self.calls.next()

    def drop(self, x, rate, site=philox.SITE_DROPOUT, seed="next"):
        seed = self.seed(rate) if seed == "next" else seed
        if seed is None:
            return x
        return x * philox.keep_factor(x.shape, seed, site, rate)

    def lin(self, x, name):
        return linear(x, self.p[name + ".weight"], self.p.get(name + ".bias"),
                      self.mode)

    @staticmethod
    def coot_norm(x, gain, bias, eps=1e-6):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, unbiased=True)
        return gain * (x - mean) / (std + eps) + bias

    def attention(self, name, query, key, key_valid, rate):
        b, lq, d = query.shape
        lk = key.shape[1]
        h = 8 if self.cfg["num_heads"] is None else self.cfg["num_heads"]
        dh = d // h

        def heads(x, length):
            return x.view(b, length, h, dh).transpose(1, 2).reshape(
                b * h, length, dh)
        q = heads(self.lin(query, name + ".query_projection"), lq)
        k = heads(self.lin(key, name + ".key_projection"), lk)
        v = heads(self.lin(key, name + ".value_projection"), lk)
        scores = matmul(q, k.transpose(1, 2), self.mode) / math.sqrt(dh)
        valid = key_valid.bool().repeat_interleave(h, dim=0)[:, None, :]
        scores = torch.where(valid, scores, torch.full_like(scores, -INF))
        probs = self.drop(torch.softmax(scores, dim=-1), rate,
                          philox.SITE_ATTENTION)
        ctx = matmul(probs, v, self.mode)
        ctx = ctx.view(b, h, lq, dh).transpose(1, 2).reshape(b, lq, d)
        return self.lin(ctx, name + ".final_projection")

    def layer(self, name, query, key, key_valid, rate):
        att = name + ".self_attention_layer"
        ffn = name + ".pointwise_feedforward_layer"
        x = self.attention(att + ".sublayer", query, key, key_valid, rate)
        x = self.coot_norm(x + query, self.p[att + ".layer_normalization.gain"],
                           self.p[att + ".layer_normalization.bias"])
        x = self.drop(x, rate)
        y = self.lin(x, ffn + ".sublayer.feed_forward.0")
        y = torch.nn.functional.gelu(self.drop(y, rate))
        y = self.drop(self.lin(y, ffn + ".sublayer.feed_forward.3"), rate)
        return self.coot_norm(y + x, self.p[ffn + ".layer_normalization.gain"],
                              self.p[ffn + ".layer_normalization.bias"])

    def genpool(self, x, mask, rate):
        w1 = self.p["pooler.pools.0.genpool_w1_head"]  # (H, D, dh)
        b1 = self.p["pooler.pools.0.genpool_b1_head"]
        w2 = self.p["pooler.pools.0.genpool_w2_head"]  # (H, dh, dho)
        b2 = self.p["pooler.pools.0.genpool_b2_head"]
        heads, d, dh = w1.shape
        seed = self.seed(rate)  # one call, three sites
        pre = matmul(x, w1.permute(1, 0, 2).reshape(d, heads * dh),
                     self.mode) + b1.reshape(-1)
        pre = self.drop(pre, rate, philox.SITE_GENPOOL_HIDDEN, seed)
        h1 = torch.nn.functional.gelu(pre)
        logits = torch.cat([matmul(h1[..., i * dh:(i + 1) * dh], w2[i],
                                   self.mode) for i in range(heads)], -1)
        logits = self.drop(logits + b2.reshape(-1), rate,
                           philox.SITE_GENPOOL_LOGITS, seed)
        logits = torch.where(mask.bool()[..., None], logits,
                             torch.full_like(logits, -INF))
        weights = self.drop(torch.softmax(logits, dim=1), rate,
                            philox.SITE_GENPOOL_WEIGHTS, seed)
        return (x * weights).sum(dim=1)

    def forward(self, x, mask, lengths, context=None):
        cfg = self.cfg
        rate = cfg["dropout"]
        if cfg["input_fc"]:
            x = self.coot_norm(x, self.p["norm_input.gain"],
                               self.p["norm_input.bias"])
            x = torch.nn.functional.gelu(self.lin(x, "input_fc.mlp.0"))
        else:
            x = self.coot_norm(x, self.p["norm_input.gain"],
                               self.p["norm_input.bias"])
        x = x + positions(x.shape[1], x.shape[2], x.device)[None]
        x = self.layer("tf.encoder_layers.0", x, x, mask, rate)
        if context is None:
            return self.genpool(x, mask, rate), x
        query = context[:, None, :]
        ctx = self.layer("tf_context.encoder_layers.0", query, x, mask,
                         rate)[:, 0]
        # avg_special: sum over rows below the batch's longest length
        rows = torch.arange(x.shape[1], device=x.device) < lengths.max()
        pooled = (x * rows[None, :, None].float()).sum(1) / torch.clamp(
            lengths.float()[:, None], min=1.0)
        return torch.cat([pooled, ctx], dim=-1), x


def positions(length: int, dim: int, device) -> torch.Tensor:
    """The reference's sincos table: pos / 10000^(2 i / dim), sin on even
    columns, cos on odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.pow(torch.tensor(10000.0, device=device),
                    2.0 * torch.arange(dim, dtype=torch.float32,
                                       device=device) / dim)
    ang = pos / div[None, :]
    pe = torch.zeros((length, dim), device=device)
    pe[:, 0::2] = torch.sin(ang[:, 0::2])
    pe[:, 1::2] = torch.cos(ang[:, 1::2])
    return pe


def net_settings(cfg: dict) -> Dict[str, dict]:
    """Each net's settings as the reference reads them from the
    configuration file, checked against the structure coded here."""
    out = {}
    for name in NETS:
        net = dict(cfg[name])
        while "same_as" in net:
            base = dict(cfg[net.pop("same_as")])
            base.update(net)
            net = base
        local = name.endswith("local")
        if (net["selfatn_config"]["num_layers"] != 1
                or net["positional_encoding"] != "sincos"
                or net["norm_input"] != "layernorm_coot"
                or net.get("add_local_cls_token")
                or bool(net["use_input_fc"]) != local
                or bool(net["use_context"]) == local
                or net["pooler_config"]["name"] != ("atn" if local
                                                    else "avg_special")):
            raise ValueError(f"{name}: a structure this reference does not "
                             "implement")
        out[name] = {"input_fc": local,
                     "num_heads": net["selfatn_config"]["num_heads"],
                     "dropout": float(net["selfatn_config"]["dropout"])}
        if local and float(net["pooler_config"]["dropout"]) != \
                out[name]["dropout"]:
            raise ValueError(f"{name}: pooler and attention dropout differ")
    return out


def forward(params, batch, cfg: dict, mode: str = "float32",
            calls: Optional[philox.Calls] = None) -> Dict[str, torch.Tensor]:
    """The model's outputs for a gathered batch (float32 features)."""
    settings = net_settings(cfg)
    out = {}
    for side, prefix, part in (("video", "vid", "clip"),
                               ("text", "par", "sent")):
        local = Net(params, f"net_{side}_local", settings[f"net_{side}_local"],
                    mode, calls)
        glob = Net(params, f"net_{side}_global",
                   settings[f"net_{side}_global"], mode, calls)
        context, _ = local.forward(batch[f"{prefix}_feat"],
                                   batch[f"{prefix}_mask"],
                                   batch[f"{prefix}_len"])
        part_flat, _ = local.forward(batch[f"{part}_feat"],
                                     batch[f"{part}_mask"],
                                     batch[f"{part}_len"])
        valid = batch[f"{part}_valid"]
        b, n = valid.shape
        contrib = torch.where(batch[f"{part}_slot_valid"][:, None], part_flat,
                              torch.zeros_like(part_flat))
        part_emb = contrib.new_zeros((b, n, contrib.shape[-1])).index_put(
            (batch[f"{part}_owner"].long(), batch[f"{part}_pos"].long()),
            contrib)
        emb, _ = glob.forward(part_emb, valid, batch[f"{part}_num"],
                              context=context)
        out.update({f"{prefix}_emb": emb, f"{part}_emb": part_emb,
                    f"{prefix}_context": context,
                    f"{part}_valid": valid, f"{part}_num": batch[f"{part}_num"]})
    return out


# ---------- the loss ----------

def l2_normalize(x, eps=1e-12):
    x = x.float()
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps * eps))


def contrastive(im, s, margin, v_im, v_s):
    n = im.shape[0]
    scores = im @ s.t()
    diag = scores.diagonal()
    cost_s = torch.clamp(margin + scores - diag[:, None], min=0.0)
    cost_im = torch.clamp(margin + scores - diag[None, :], min=0.0)
    pair = v_im[:, None] & v_s[None, :]
    keep = pair & ~torch.eye(n, dtype=torch.bool, device=im.device)
    total = (torch.where(keep, cost_s, 0.0).sum()
             + torch.where(keep, cost_im, 0.0).sum())
    return total / torch.clamp(v_im.float().sum() * v_s.float().sum(),
                               min=1.0)


def _soft_nn(src, src_mask, tgt, tgt_mask):
    mask = src_mask[:, :, None] & tgt_mask[:, None, :]
    dist = -((src[:, :, None, :] - tgt[:, None, :, :]) ** 2).mean(-1)
    w = torch.softmax(torch.where(mask, dist, torch.full_like(dist, -INF)),
                      dim=-1)
    return (tgt[:, None, :, :] * w[..., None]).sum(2), w


def _cycle(src, src_mask, tgt, tgt_mask, u, batch_valid):
    nn_fwd, _ = _soft_nn(src, src_mask, tgt, tgt_mask)
    _, beta = _soft_nn(nn_fwd, src_mask, src, src_mask)
    idx = torch.arange(src_mask.shape[1], dtype=torch.float32,
                       device=src.device)[None, :]
    index_nn = (idx[:, None, :] * beta).sum(-1)
    pair = src_mask[:, :, None] & src_mask[:, None, :]
    dist = torch.where(pair, (index_nn[:, :, None] - idx[:, None, :]) ** 2,
                       0.0)
    l_seq = dist.diagonal(dim1=-2, dim2=-1)
    # one valid position of each row, drawn by u: its floor(u n)-th
    rank = src_mask.long().cumsum(1)
    count = rank[:, -1:]
    k = torch.minimum((u[:, None] * count).long(), count - 1)
    pick = (rank <= k).sum(1, keepdim=True).clamp(max=l_seq.shape[1] - 1)
    w = batch_valid.float()
    return (l_seq.gather(1, pick)[:, 0] * w).sum() / torch.clamp(w.sum(),
                                                                 min=1.0)


def loss(out, batch_valid, cfg: dict, seed_state) -> Dict[str, torch.Tensor]:
    """The configuration's contrastive terms (alignment and clustering of
    videos/paragraphs, clips/sentences and contexts) plus the weighted
    cycle consistency, subsampled with the uniforms of the seed state."""
    lc = cfg["train"]["contrastive_loss_config"]
    margin = float(lc["margin"])
    bv = batch_valid.bool()
    vid, par = l2_normalize(out["vid_emb"]), l2_normalize(out["par_emb"])
    vctx = l2_normalize(out["vid_context"])
    pctx = l2_normalize(out["par_context"])
    b, n, d = out["clip_emb"].shape
    cv = (out["clip_valid"].bool() & bv[:, None]).reshape(-1)
    sv = (out["sent_valid"].bool() & bv[:, None]).reshape(-1)
    clip = l2_normalize(out["clip_emb"].reshape(b * n, d))
    sent = l2_normalize(out["sent_emb"].reshape(b * n, -1))

    def cluster(a, ta, va, vt):
        return (contrastive(a, a, margin, va, va)
                + contrastive(ta, ta, margin, vt, vt)) / 2
    total = (float(lc["weight_high"]) * contrastive(vid, par, margin, bv, bv)
             + float(lc["weight_low"]) * contrastive(clip, sent, margin, cv, sv)
             + float(lc["weight_context"]) * contrastive(vctx, pctx, margin,
                                                         bv, bv)
             + float(lc["weight_high_internal"]) * cluster(vid, par, bv, bv)
             + float(lc["weight_low_internal"]) * cluster(clip, sent, cv, sv))
    if float(lc["weight_context_internal"]):
        raise ValueError("weight_context_internal is not implemented")
    parts = {"loss_contrastive": total}
    cc = float(cfg["train"]["loss_cycle_cons"])
    u = philox.uniform((2, b), seed_state, philox.SITE_CC)
    cm, sm = out["clip_valid"].bool(), out["sent_valid"].bool()
    ce, se = out["clip_emb"].float(), out["sent_emb"].float()
    parts["loss_cc"] = cc * (_cycle(ce, cm, se, sm, u[0], bv)
                             + _cycle(se, sm, ce, cm, u[1], bv))
    parts["loss_total"] = total + parts["loss_cc"]
    return parts


# ---------- a train step and an eval step ----------

def train_step(params, tables, shapes, max_frames, vid_store, text_store,
               dp_idx, batch_valid, state, cfg: dict, mode: str = "float32"
               ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """One training forward and backward at the seed state `state`:
    (loss parts, float32 gradient of every parameter). The parameters
    are not changed."""
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in params.items()}
    calls = philox.Calls(state)
    noise_seed = calls.next()
    ds = cfg["dataset_train"]
    batch = sample_batch(tables, dp_idx, batch_valid, shapes, max_frames,
                         draw_uniforms(state, dp_idx.shape[0], shapes))
    batch = gather(batch, vid_store, text_store, float(ds["frames_noise"]),
                   float(ds["words_noise"]), noise_seed)
    out = forward(leaves, batch, cfg, mode, calls)
    parts = loss(out, batch_valid, cfg, state)
    grads = torch.autograd.grad(parts["loss_total"], list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return {k: float(v.detach()) for k, v in parts.items()}, grads


@torch.no_grad()
def eval_embeddings(params, tables, shapes, max_frames, vid_store,
                    text_store, dp_idx, batch_valid, cfg: dict,
                    mode: str = "float32") -> Dict[str, torch.Tensor]:
    """The embeddings of an id batch, centre sampling, no noise, no
    dropout: vid, par, clip, sent, and both contexts, L2-normalised and
    before the norm (`<name>_before_norm`), with the clip and sentence
    slots that hold a part."""
    batch = sample_batch(tables, dp_idx, batch_valid, shapes, max_frames)
    batch = gather(batch, vid_store, text_store)
    out = forward(params, batch, cfg, mode, None)
    keys = ("vid_emb", "par_emb", "clip_emb", "sent_emb", "vid_context",
            "par_context")
    embs = {k: l2_normalize(out[k]) for k in keys}
    embs.update({f"{k}_before_norm": out[k].float() for k in keys})
    embs.update(clip_valid=out["clip_valid"].bool(),
                sent_valid=out["sent_valid"].bool())
    return embs


# ---------- the optimizer ----------

def radam(params, grads, moments, step: int, cfg: dict):
    """One RAdam update (Liu et al., ICLR 2020, as COOT's
    optimization.py runs it) of the configuration's `optimizer`: Adam
    moments, the variance rectification from step 5 of the SMA length on,
    no update below it (`radam_degentosgd` false), weight decay added to
    the update of every parameter whose name holds no "bias" (all of them
    where `weight_decay_for_bias` is false). `step` counts from 1.
    Returns the new parameters and moments {"m", "v"}."""
    opt = cfg["optimizer"]
    if opt["name"] != "radam" or opt["radam_degentosgd"]:
        raise ValueError("the reference follows RAdam without SGD steps")
    beta1, beta2 = float(opt["momentum"]), float(opt["adam_beta2"])
    eps, lr = float(opt["adam_eps"]), float(opt["lr"])
    wd = float(opt["weight_decay"])
    rho_inf = 2.0 / (1.0 - beta2) - 1.0
    beta2_t = beta2 ** step
    rho = rho_inf - 2.0 * step * beta2_t / (1.0 - beta2_t)
    rect = None
    if rho >= 5.0:
        rect = math.sqrt((1.0 - beta2_t) * (rho - 4.0) / (rho_inf - 4.0)
                         * (rho - 2.0) / rho * rho_inf / (rho_inf - 2.0)
                         ) / (1.0 - beta1 ** step)
    new_p, new_m = {}, {"m": {}, "v": {}}
    for n, g in grads.items():
        g = g.float()
        m = beta1 * moments["m"].get(n, 0.0) + (1.0 - beta1) * g
        v = beta2 * moments["v"].get(n, 0.0) + (1.0 - beta2) * g * g
        p = params[n].float()
        if rect is not None:
            update = rect * m / (torch.sqrt(v) + eps)
            if wd and not (opt["weight_decay_for_bias"] and "bias" in n):
                update = update + wd * p
            p = p - lr * update
        new_p[n], new_m["m"][n], new_m["v"][n] = p, m, v
    return new_p, new_m
