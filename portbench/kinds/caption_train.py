"""
Recurrent MART training on COOT embeddings: a split's videos (their
sentences' token ids in the traffic file) in batches of the traffic's
size, grouped once from the traffic's fixed seed and taken in an order
shuffled from the run's seed, one epoch after another (every seed trains
the same set of batches, so the work does not change with it); a batch's
sentence
steps stacked to the count-ladder bucket of its longest video (at most
max_n_sen); through `tasks/caption/steps.py::caption_train_step` (one
captured program a bucket), the lr of the trainer's warmup_linear
schedule, one read of the step's loss; closed loop.

Set-up builds the one train state (BertAdam, the EMA, the seed state), runs
its first three steps on the first three batches of a set-up epoch (the
first call of a bucket captures its program), keeps the losses, the first
moments after step 1 and the parameters after step 3, then runs one step
on a batch of every other bucket the window's epochs hold, and hands the
state to the window, which starts at epoch 1.

Correct: the reference (`reference/mart.py`) follows the three steps from
the same weights, batches and seed states, dropout drawn from the same
Philox stream, BertAdam as MART runs it and the EMA. Compared: each
step's loss, the first gradient as the optimizer got it (its first moment
after step 1 over 1 - beta1), the parameters' change and the EMA
shadow's change after step 3, each by its median leaf, and the first
gradient and the parameters' change by the leaf at the 90th percentile:
the worst leaf swings from seed to seed with the ReLU kinks of the
embedding stacks (PERF.md).
"""

from __future__ import annotations

import copy
import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, work
from portbench.data import COUNT_LADDER, bucket
from portbench.kinds.caption_greedy import (
    BENCH_KEYS, CLS, PAD, SEP, VID, _unit_rows, mart_weights)
from portbench.reference import mart as ref
from portbench.trace import span

IGNORE = -1
CHECK_STEPS = 3


class Batches:
    """The split's videos in batches of `size`, grouped once from the
    traffic's fixed `group_seed` so that every run holds the same set of
    batches (and sentence buckets); epoch e takes them in an order drawn
    from (seed, e). The last batch is short."""

    def __init__(self, n: int, size: int, group_seed: int, seed: int):
        order = np.random.default_rng(group_seed).permutation(n)
        self.groups = [order[i:i + size] for i in range(0, n, size)]
        self.seed = seed

    def batches(self, epoch: int) -> List[np.ndarray]:
        order = np.random.default_rng([self.seed, epoch]).permutation(
            len(self.groups))
        return [self.groups[i] for i in order]


def warmup_linear(progress: float, warmup: float) -> float:
    """The schedule factor of MART's BertAdam: a ramp over the warmup
    fraction, then a linear decay to 0 at the end (float32 arithmetic)."""
    f32 = np.float32
    p, w = f32(progress), f32(warmup)
    if p < w:
        return float(p / max(w, f32(1e-9)))
    return float(max((p - f32(1.0)) / (w - f32(1.0)), f32(0.0)))


class Cell:
    control_mode = "tf32"  # one precision below the configuration's f32
    FAULTS = ("half_batch",)

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, fault: str = None) -> None:
        """`fault` (checks of the check only): "half_batch" trains the
        first three steps on the first half of each batch alone."""
        from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
        from coot_videotext_tpu_torch.tasks.caption.model_manager import (
            create_mart_model)
        from coot_videotext_tpu_torch.tasks.caption.steps import (
            caption_train_step, init_caption_train_state)
        if fault not in (None,) + self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self._step = caption_train_step
        self.cfg, self.seed, self.device = cfg, seed, device
        mc = MartConfig(copy.deepcopy({k: v for k, v in cfg.items()
                                       if k not in BENCH_KEYS}))
        model = create_mart_model(mc, int(cfg["vocab_size"]), device)
        named = list(model.named_parameters())
        self.weights = mart_weights(named, float(cfg["initializer_range"]),
                                    seed, device)
        with torch.no_grad():
            for n, p in named:
                p.copy_(self.weights[n])
        self.state = init_caption_train_state(model, mc, seed)
        self.eps = float(mc.eps)
        self.size = int(traffic["batch_size"])
        self.videos = traffic["videos"]
        self.epochs = Batches(len(self.videos), self.size,
                              int(traffic["group_seed"]), seed)
        self.v_len, self.t_len = int(cfg["max_v_len"]), int(cfg["max_t_len"])
        self.max_steps = int(cfg["max_n_sen"])
        self.t_total = len(self.epochs.batches(0)) * int(
            cfg["train"]["num_epochs"])
        self.lr0 = float(cfg["lr"])
        self.warmup = float(cfg["lr_warmup_proportion"])
        self._tables(seed)
        self.spans: List[float] = []
        self.steps_done = 0
        self.window_steps = 0
        # the first steps
        first = self.epochs.batches(0)[:CHECK_STEPS]
        self.check_batches = [self.batch(ids) for ids in first]
        fed = self.check_batches
        if fault == "half_batch":
            fed = [self._halved(b) for b in fed]
        self.losses = [self.train(fed[0])]
        self.moment1 = {n: m.detach().to("cpu", copy=True)
                        for n, m in self.state.optimizer.mu.items()}
        self.losses += [self.train(b) for b in fed[1:]]
        self.params3 = {n: p.detach().to("cpu", copy=True)
                        for n, p in self.state.optimizer.params.items()}
        self.shadow3 = {n: s.detach().to("cpu", copy=True)
                        for n, s in self.state.ema.shadow.items()}
        # every other bucket of the window's epochs, captured
        seen = {b["steps"] for b in self.check_batches}
        for epoch in range(1, 21):
            for ids in self.epochs.batches(epoch):
                steps = self._steps(ids)
                if steps not in seen:
                    seen.add(steps)
                    self.train(self.batch(ids))
        self.sync()

    def _tables(self, seed: int) -> None:
        """Every video's sentence steps on the device: ids, masks, labels
        (dummy steps repeat step 0 without labels) and clip rows."""
        n, s, length = len(self.videos), self.max_steps, \
            self.v_len + self.t_len
        ids = np.full((n, s, length), PAD, np.int64)
        ids[:, :, :self.v_len] = (CLS, VID, SEP)
        mask = np.zeros((n, s, length), np.float32)
        mask[:, :, :self.v_len] = 1.0
        labels = np.full((n, s, length), IGNORE, np.int64)
        clip_row = np.zeros((n, s), np.int64)
        row = 0
        for i, sents in enumerate(self.videos):
            sents = sents[:s]
            for k in range(s):
                src = sents[k] if k < len(sents) else sents[0]
                text = src[:self.t_len]
                ids[i, k, self.v_len:self.v_len + len(text)] = text
                mask[i, k, self.v_len:self.v_len + len(text)] = 1.0
                if k < len(sents):
                    labels[i, k, self.v_len:self.v_len + len(text) - 1] = \
                        text[1:]
                clip_row[i, k] = row + (k if k < len(sents) else 0)
            row += len(sents)
        dev = self.device
        self.ids_tab = torch.as_tensor(ids, device=dev)
        self.mask_tab = torch.as_tensor(mask, device=dev)
        self.label_tab = torch.as_tensor(labels, device=dev)
        self.clip_tab = torch.as_tensor(clip_row, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((seed * 69069 + 5) & ((1 << 63) - 1))
        self.vid = _unit_rows(n, int(self.cfg["coot_dim_vid"]), gen, dev)
        self.clip = _unit_rows(row, int(self.cfg["coot_dim_clip"]), gen, dev)
        self.sentences = [min(len(v), s) for v in self.videos]

    def _steps(self, ids) -> int:
        return bucket(max(self.sentences[int(i)] for i in ids), COUNT_LADDER)

    def batch(self, ids) -> dict:
        """The stacked (S, N, ...) batch of the videos `ids`; padding rows
        repeat the first video without labels."""
        n_real = len(ids)
        rows = list(ids) + [ids[0]] * (self.size - n_real)
        steps = self._steps(ids)
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        labels = self.label_tab[r, :steps].transpose(0, 1).clone()
        labels[:, n_real:] = IGNORE
        dv = self.vid.shape[1]
        length = self.v_len + self.t_len
        feats = torch.zeros((steps, self.size, length,
                             dv + self.clip.shape[1]), device=self.device)
        feats[:, :, 1, :dv] = self.vid[r][None]
        feats[:, :, 1, dv:] = self.clip[self.clip_tab[r, :steps].t()]
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

    def _halved(self, b: dict) -> dict:
        out = dict(b, batch=dict(b["batch"]))
        labels = out["batch"]["input_labels"].clone()
        labels[:, self.size // 2:] = IGNORE
        out["batch"]["input_labels"] = labels
        return out

    def lr(self, step: int) -> float:
        return self.lr0 * warmup_linear(step / max(self.t_total, 1),
                                        self.warmup)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, b: dict) -> float:
        """One step and its one read; the host span covers the call."""
        t = time.perf_counter()
        with span("train_step"):
            metrics = self._step(self.state, b["batch"],
                                 self.lr(self.steps_done))
        self.spans.append(time.perf_counter() - t)
        self.steps_done += 1
        with span("metrics_read"):
            return float(metrics["loss"])

    def window(self, seconds: float) -> Dict[str, float]:
        self.spans.clear()
        videos = steps = 0
        epoch, batches = 1, []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            if not batches:
                batches = self.epochs.batches(epoch)
                epoch += 1
            ids = batches.pop(0)
            self.train(self.batch(ids))
            videos += len(ids)
            steps += 1
        elapsed = time.perf_counter() - start
        self.window_steps = steps
        return {"train_videos_per_s": videos / elapsed}

    def attempted(self) -> int:
        return self.window_steps

    def traced_work(self, steps: int = 4):
        """The first `steps` batches of the window's first epoch."""
        chosen = [self.batch(ids) for ids in self.epochs.batches(1)[:steps]]

        def run():
            for b in chosen:
                self.train(b)
        return run, chosen, steps

    def layer_context(self, trace, chosen, steps) -> dict:
        sentences = sum(self.sentences[int(r)] for b in chosen
                        for r in b["rows"][:b["n_real"]])
        return {"trace": trace, "steps": steps,
                "flops": 3 * sentences * work.mart_sentence_flops(self.cfg),
                "peak_flops": work.PEAK_FLOPS["float32"],
                "kernel_bound_s": sum(
                    work.mart_dropout_bound_s(self.cfg, self.sentences[int(r)])
                    for b in chosen for r in b["rows"][:b["n_real"]]),
                "host_s": sum(self.spans), "host_calls": len(self.spans)}

    # ---------- correctness ----------

    def free_program(self) -> None:
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_outputs(self) -> dict:
        return {"losses": list(self.losses), "moment1": self.moment1,
                "change3": {n: p - self.weights[n].cpu()
                            for n, p in self.params3.items()},
                "ema3": {n: s - self.weights[n].cpu()
                         for n, s in self.shadow3.items()}}

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
            params, moments = ref.bert_adam(params, grads, moments,
                                            self.lr(step), self.eps)
            shadow = ref.ema(shadow, params, step,
                             float(self.cfg["ema_decay"]))
            if step == 0:
                out["moment1"] = {n: m.cpu() for n, m in moments["m"].items()}
        out["change3"] = {n: (p - self.weights[n]).cpu()
                          for n, p in params.items()}
        out["ema3"] = {n: (s - self.weights[n]).cpu()
                       for n, s in shadow.items()}
        return out

    @staticmethod
    def _leaves(prog: dict, refr: dict) -> Dict[str, Dict[str, float]]:
        keep = check.leaves_that_move(refr["moment1"])
        return {"grad1_gap": check.leaf_gaps(prog["moment1"],
                                             refr["moment1"], keep),
                "grad1_error": check.leaf_errors(prog["moment1"],
                                                 refr["moment1"], keep),
                "change3_gap": check.leaf_gaps(prog["change3"],
                                               refr["change3"], keep),
                "ema3_gap": check.leaf_gaps(prog["ema3"], refr["ema3"],
                                            keep)}

    @classmethod
    def diagnostics(cls, prog: dict, refr: dict) -> dict:
        """The worst eight leaves of each leaf-by-leaf number, and the
        count of kept leaves: the ReLUs after the word and video embedding
        stacks put their first leaves there on a few seeds (PERF.md)."""
        leaves = cls._leaves(prog, refr)
        out = {f"worst_{k}": sorted(v.items(), key=lambda x: -x[1])[:8]
               for k, v in leaves.items()}
        out["kept_leaves"] = len(leaves["grad1_gap"])
        return out

    @classmethod
    def compare(cls, prog: dict, refr: dict) -> Dict[str, float]:
        """Each step's loss; the median leaf of the first gradient (gap
        of norms, norm of the difference), of the parameters' change and
        of the EMA shadow's change after step 3; the first gradient's and
        the change's leaf at the 90th percentile."""
        leaves = cls._leaves(prog, refr)
        return {
            "loss_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], refr["losses"])),
            "grad1_median_leaf_gap": statistics.median(
                leaves["grad1_gap"].values()),
            "grad1_median_leaf_error": statistics.median(
                leaves["grad1_error"].values()),
            "change3_median_leaf_gap": statistics.median(
                leaves["change3_gap"].values()),
            "ema3_median_leaf_gap": statistics.median(
                leaves["ema3_gap"].values()),
            "grad1_p90_leaf_gap": check.p90(leaves["grad1_gap"].values()),
            "change3_p90_leaf_gap": check.p90(
                leaves["change3_gap"].values()),
        }
