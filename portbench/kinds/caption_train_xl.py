"""
Transformer-XL caption training on raw YouCook2 features: MART's train
traffic (`caption_train.py`: the split's videos in batches grouped once
from the traffic's fixed seed, taken in an order shuffled from the run's
seed, steps bucketed to the count ladder, warmup_linear lr, one read of
the loss a step, closed loop) with the TransformerXL of
`configs/xl-yc2-raw.json` in MART's place, through the same
`tasks/caption/steps.py::caption_train_step` and its captured programs.

A sentence step's video part is the segment's feature rows at 0.5 s a
row as the caption dataset takes them (`traffic/caption_train_raw.json`:
the segment's row range; more than max_v_len - 2 = 98 rows are taken at
numpy linspace positions), between [CLS] and [SEP] and padded to
max_v_len; the text part the sentence's tokens (the token ids of
`traffic/caption_train.json`) padded to max_t_len. Every train video's
feature rows (3072-d, ~839k rows, 10.3 GB) are drawn from the run's seed
on the device at set-up and gathered into each batch there; the
relative attention then runs the padded 122-row segment against 244 keys
([previous segment; segment]) from the second step on.

Correct: the numbers of MART's train cell, against `reference/xl.py`:
each step's loss, the first gradient as the optimizer got it, the
parameters' and the EMA shadow's change after step 3 by their median
leaf, the first gradient's and the change's leaf at the 90th percentile.
The change's 90th percentile reads up to half of what the TF32 control
reads (a feed-forward ReLU input within rounding of 0 takes its gradient
on one side only, and two updates carry that into a tenth of the leaves
or more), so its limit lies between the program and the half-batch
fault (PERF.md §4).

The traced window's work (`mfu.train`) counts each sentence step's valid
rows (video rows, [CLS] and [SEP], the sentence's tokens) and keys (the
previous step's valid rows and these): the embedding stacks, per layer
q, k and v over the segment and k and v over the memory rows (the
model computes their q too and drops it), r_net over the keys' positions,
the content
and position scores, the probabilities times the values, o_net and the
feed-forward, and the head; a backward counts twice its forward's
products, except the weight gradient alone where the input is data or
detached (the features, the position table, the memory rows). B4's
least time (`kernel_roofline.train`) counts every element of every
dropout site at the padded shapes the kernel is given, forward and
backward, for each real video's sentence steps.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench import work
from portbench.kinds import caption_train
from portbench.kinds.caption_greedy import CLS, PAD, SEP, VID
from portbench.reference import mart as ref_mart
from portbench.reference import xl as ref

HERE = Path(__file__).resolve().parent.parent
IGNORE = caption_train.IGNORE


def _dims(cfg: dict) -> Dict[str, int]:
    return {"d": int(cfg["hidden_size"]), "di": int(cfg["intermediate_size"]),
            "words": int(cfg["word_vec_size"]),
            "video": int(cfg["video_feature_size"]),
            "vocab": int(cfg["vocab_size"]),
            "layers": int(cfg["num_hidden_layers"])}


def xl_step_flops(cfg: dict, q: int, k: int) -> float:
    """Training products (forward and backward) of one sentence step of
    one video with q valid rows against k valid keys (see the module
    docstring)."""
    c = _dims(cfg)
    d = c["d"]
    # forward products whose input takes a gradient (three times in
    # training), and those whose input is data or detached (twice)
    full = (2 * q * c["words"] * d
            + 2 * q * (d * d + d * c["vocab"]))  # the head
    once = 2 * q * c["video"] * d
    full += c["layers"] * (2 * q * d * 3 * d     # q, k, v of the segment
                           + 3 * 2 * q * k * d   # content, position, values
                           + 2 * q * d * d       # o_net
                           + 2 * 2 * q * d * c["di"])  # feed-forward
    once += c["layers"] * (2 * (k - q) * d * 2 * d  # k, v of the memory
                           + 2 * k * d * d)         # r_net
    return float(3 * full + 2 * once)


def xl_dropout_bound_s(cfg: dict, sentences: int) -> float:
    """Least time of the dropout calls (B4, forward and backward, float32:
    each element read and written once) of one video's `sentences`
    sentence steps at the padded shapes: the word and video stacks, the
    embeddings, the position table, the segment, per layer the attention
    output and the two feed-forward drops, and the last output."""
    c = _dims(cfg)
    length = int(cfg["max_v_len"]) + int(cfg["max_t_len"])
    d = c["d"]
    elements = 0
    for s in range(sentences):
        keys = length if s == 0 else 2 * length
        elements += (length * (c["words"] + c["video"] + 3 * d) + keys * d
                     + c["layers"] * length * (2 * d + c["di"]))
    return 2 * work.bound_s(elements * 4 * 2, 0, "float32")


class Cell(caption_train.Cell):
    """MART's train cell with the XL's batches, work and reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, fault: str = None) -> None:
        with open(HERE / "traffic" / f"{traffic['sentences_from']}.json",
                  encoding="utf8") as fh:
            videos = json.load(fh)["videos"]
        self.segments = traffic["segments"]
        self.feature_rows = traffic["feature_rows"]
        super().__init__(cfg, dict(traffic, videos=videos[:len(
            self.segments)]), seed, device, fault)

    def _tables(self, seed: int) -> None:
        """Every video's sentence steps on the device: ids, masks, labels
        (dummy steps repeat step 0 without labels), and the feature-table
        row of each video row (the zero row past the table's end where
        there is none), then the feature table drawn from the seed."""
        n, s = len(self.videos), self.max_steps
        v_rows = self.v_len - 2
        length = self.v_len + self.t_len
        ids = np.full((n, s, length), PAD, np.int64)
        mask = np.zeros((n, s, length), np.float32)
        labels = np.full((n, s, length), IGNORE, np.int64)
        offsets = np.cumsum([0] + list(self.feature_rows))
        total = int(offsets[-1])
        rows = np.full((n, s, v_rows), total, np.int64)
        for i, sents in enumerate(self.videos):
            sents = sents[:s]
            for k in range(s):
                j = k if k < len(sents) else 0
                st, ed = self.segments[i][j]
                if ed - st + 1 > v_rows:
                    idx = np.linspace(st, ed, v_rows, endpoint=True).astype(
                        np.int64)
                else:
                    idx = np.arange(st, ed + 1)
                valid = len(idx)
                rows[i, k, :valid] = offsets[i] + idx
                ids[i, k, :valid + 2] = [CLS] + [VID] * valid + [SEP]
                mask[i, k, :valid + 2] = 1.0
                text = sents[j][:self.t_len]
                ids[i, k, self.v_len:self.v_len + len(text)] = text
                mask[i, k, self.v_len:self.v_len + len(text)] = 1.0
                if k < len(sents):
                    labels[i, k, self.v_len:self.v_len + len(text) - 1] = \
                        text[1:]
        dev = self.device
        self.ids_tab = torch.as_tensor(ids, device=dev)
        self.mask_tab = torch.as_tensor(mask, device=dev)
        self.label_tab = torch.as_tensor(labels, device=dev)
        self.row_tab = torch.as_tensor(rows, device=dev)
        self.valid_rows = mask.sum(-1)  # (n, s) on the host
        gen = torch.Generator(device=dev)
        gen.manual_seed((seed * 69069 + 5) & ((1 << 63) - 1))
        self.features = torch.randn(
            (total + 1, int(self.cfg["video_feature_size"])), generator=gen,
            device=dev)
        self.features[total].zero_()
        self.sentences = [min(len(v), s) for v in self.videos]

    def batch(self, ids) -> dict:
        """The stacked (S, N, ...) batch of the videos `ids`; padding rows
        repeat the first video without labels."""
        n_real = len(ids)
        rows = list(ids) + [ids[0]] * (self.size - n_real)
        steps = self._steps(ids)
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        labels = self.label_tab[r, :steps].transpose(0, 1).clone()
        labels[:, n_real:] = IGNORE
        length = self.v_len + self.t_len
        feats = torch.zeros((steps, self.size, length,
                             self.features.shape[1]), device=self.device)
        feats[:, :, 1:self.v_len - 1] = self.features[
            self.row_tab[r, :steps].transpose(0, 1)]
        types = torch.zeros((steps, self.size, length), dtype=torch.int64,
                            device=self.device)
        types[:, :, self.v_len:] = 1
        return {"n_real": n_real, "steps": steps, "rows": rows,
                "batch": {"input_ids": self.ids_tab[r, :steps].transpose(
                              0, 1).contiguous(),
                          "video_feature": feats,
                          "input_mask": self.mask_tab[r, :steps].transpose(
                              0, 1).contiguous(),
                          "token_type_ids": types, "input_labels": labels}}

    def layer_context(self, trace, chosen, steps) -> dict:
        ctx = super().layer_context(trace, chosen, steps)
        flops, bound = 0.0, 0.0
        for b in chosen:
            for r in b["rows"][:b["n_real"]]:
                r = int(r)
                prev = 0
                for s in range(self.sentences[r]):
                    q = int(self.valid_rows[r, s])
                    flops += xl_step_flops(self.cfg, q, q + prev)
                    prev = q
                bound += xl_dropout_bound_s(self.cfg, self.sentences[r])
        ctx.update(flops=flops, kernel_bound_s=bound)
        return ctx

    def reference(self, mode: str) -> dict:
        params = dict(self.weights)
        shadow = dict(self.weights)
        moments = {"m": {}, "v": {}}
        out = {"losses": []}
        for step, b in enumerate(self.check_batches):
            state = ref.philox.seed_state(self.seed + step, self.device)
            loss, grads = ref.train_step(params, self.cfg, b["batch"], state,
                                         mode)
            out["losses"].append(loss)
            params, moments = ref.xl_adam(params, grads, moments,
                                          self.lr(step), self.eps)
            shadow = ref_mart.ema(shadow, params, step,
                                  float(self.cfg["ema_decay"]))
            if step == 0:
                out["moment1"] = {n: m.cpu() for n, m in moments["m"].items()}
        out["change3"] = {n: (p - self.weights[n]).cpu()
                          for n, p in params.items()}
        out["ema3"] = {n: (s - self.weights[n]).cpu()
                       for n, s in shadow.items()}
        return out
