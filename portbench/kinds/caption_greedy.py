"""
Greedy captioning of a split's videos with recurrent MART: batches of the
traffic's size in order (the last of a pass padded with copies of its
first video), each video with its sentence count from the traffic file
(capped at max_n_sen + max_n_sen_add_val), the sentence steps of a batch
stacked to the count-ladder bucket of its longest video, through
`tasks/caption/translator.py::Translator.translate_batch` (one captured
program a sentence, the tokens read once a batch); closed loop, one batch
in flight. A sentence step's video part is [CLS] [VID] [SEP] with the
video's COOT embedding and the clip's in the [VID] row ("vidclip"), unit
rows drawn from the run's seed on the device.

Correct: the answers of the window's last pass, every real sentence of
every real video: the reference runs each sentence over its video part
and its served tokens (the memory carried from the sentence before, as
the decoder builds it) and reads, at each served position, how far the
served token's score lies below its own best ([UNK] excluded, as the
decoder excludes it).
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import work
from portbench.data import COUNT_LADDER, bucket
from portbench.reference import mart as ref
from portbench.trace import span

CLS, SEP, VID, BOS, EOS, UNK, PAD = 1, 2, 3, 4, 5, 6, 0
BENCH_KEYS = ("assumed", "source_file", "vocab_size")


def _unit_rows(n: int, d: int, gen, device) -> torch.Tensor:
    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def mart_weights(named, std: float, seed: int, device):
    """Every Linear and Embedding weight normal(0, initializer_range),
    the memory initialiser's bias normal(0, 1), biases 0, LayerNorms 1 /
    0 (MART's init), drawn on the device from the seed in one call."""
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 40503 + 7) & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, p in named:
        n = p.numel()
        draw = flat[at:at + n].view(p.shape)
        at += n
        if name.endswith("init_memory_bias"):
            out[name] = draw.clone()
        elif p.dim() >= 2:
            out[name] = draw * std
        elif name.endswith(".weight"):  # every 1-d weight is a LayerNorm's
            out[name] = torch.ones_like(draw)
        else:
            out[name] = torch.zeros_like(draw)
    return out


class Cell:
    control_mode = "tf32"  # one precision below the configuration's f32
    FAULTS = ("token_altered",)

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, fault: str = None) -> None:
        from coot_videotext_tpu_torch.tasks.caption.config import MartConfig
        from coot_videotext_tpu_torch.tasks.caption.model_manager import (
            create_mart_model)
        from coot_videotext_tpu_torch.tasks.caption.translator import (
            Translator)
        if fault not in (None,) + self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
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
        model.eval()
        self.model = model
        self.translator = Translator(model, mc)
        self.v_len, self.t_len = int(cfg["max_v_len"]), int(cfg["max_t_len"])
        cap = int(cfg["max_n_sen"]) + int(cfg["max_n_sen_add_val"])
        self.counts = [min(cap, int(c)) for c in traffic["sentences"]]
        size = int(traffic["batch_size"])
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 69069 + 3) & ((1 << 63) - 1))
        vid = _unit_rows(len(self.counts), int(cfg["coot_dim_vid"]), gen,
                         device)
        clip = _unit_rows(sum(self.counts), int(cfg["coot_dim_clip"]), gen,
                          device)
        starts = np.cumsum([0] + self.counts)[:-1]
        self.batches = []
        for b0 in range(0, len(self.counts), size):
            rows = list(range(b0, min(len(self.counts), b0 + size)))
            self.batches.append(self._batch(rows, size, vid, clip, starts))
        self.answers: Dict[int, List[np.ndarray]] = {}
        self.spans: List[float] = []
        self.decode(0)  # warm: both sentence programs captured
        self.sync()

    def _batch(self, rows, size, vid, clip, starts) -> dict:
        n_real = len(rows)
        rows = rows + [rows[0]] * (size - n_real)
        steps = bucket(max(self.counts[r] for r in rows), COUNT_LADDER)
        length = self.v_len + self.t_len
        dev = self.device
        ids = torch.full((steps, size, length), PAD, dtype=torch.int64,
                         device=dev)
        ids[:, :, :self.v_len] = torch.tensor([CLS, VID, SEP], device=dev)
        mask = torch.zeros((steps, size, length), device=dev)
        mask[:, :, :self.v_len] = 1.0
        types = torch.zeros((steps, size, length), dtype=torch.int64,
                            device=dev)
        types[:, :, self.v_len:] = 1
        dv, dc = vid.shape[1], clip.shape[1]
        feats = torch.zeros((steps, size, length, dv + dc), device=dev)
        # dummy steps repeat step 0
        clip_at = [[int(starts[r]) + (s if s < self.counts[r] else 0)
                    for r in rows] for s in range(steps)]
        feats[:, :, 1, :dv] = vid[torch.as_tensor(rows, device=dev)][None]
        feats[:, :, 1, dv:] = clip[torch.as_tensor(clip_at, device=dev)]
        return {"n_real": n_real, "rows": rows, "steps": steps,
                "batch": {"input_ids": ids, "video_feature": feats,
                          "input_mask": mask, "token_type_ids": types}}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self, b: int) -> None:
        t = time.perf_counter()
        with span("decode_batch"):
            out = self.translator.translate_batch(self.batches[b]["batch"])
        self.spans.append(time.perf_counter() - t)
        if self.fault == "token_altered":
            out[0] = out[0].copy()
            out[0][0, 1] = (out[0][0, 1] + 1) % int(self.cfg["vocab_size"])
        self.answers[b] = out

    def window(self, seconds: float) -> Dict[str, float]:
        self.spans.clear()
        videos, b, done = 0, 0, 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.decode(b)
            videos += self.batches[b]["n_real"]
            done += 1
            b = (b + 1) % len(self.batches)
        elapsed = time.perf_counter() - start
        self.window_batches = done
        return {"caption_videos_per_s": videos / elapsed}

    def attempted(self) -> int:
        return self.window_batches

    def traced_work(self):
        """The first batch of the split."""
        def run():
            self.decode(0)
        return run, self._work([0]), 1

    def _work(self, batches) -> float:
        """Products of the real sentences of `batches`, each position's
        forward once (`work.mart_sentence_flops`)."""
        per = work.mart_sentence_flops(self.cfg)
        return sum(self.counts[r] * per for b in batches
                   for r in self.batches[b]["rows"][:self.batches[b]
                                                    ["n_real"]])

    def layer_context(self, trace, flops, batches) -> dict:
        return {"trace": trace, "steps": batches, "flops": flops,
                "peak_flops": work.PEAK_FLOPS["float32"],
                "kernel_bound_s": 0.0,
                "host_s": sum(self.spans), "host_calls": len(self.spans)}

    # ---------- correctness ----------

    def free_program(self) -> None:
        self.model = None
        self.translator = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_outputs(self) -> dict:
        return {"tokens": {b: [torch.as_tensor(np.asarray(x)) for x in out]
                           for b, out in self.answers.items()}}

    def _served(self, tokens: torch.Tensor):
        """(ids, masks) of a step's text region as the decoder leaves
        them: [PAD] and mask 0 after the first [EOS]."""
        is_eos = tokens == EOS
        first = torch.where(is_eos.any(1), is_eos.int().argmax(1),
                            tokens.shape[1] - 1)
        col = torch.arange(tokens.shape[1], device=tokens.device)
        keep = col[None] <= first[:, None]
        return torch.where(keep, tokens, PAD), keep.float(), first

    def reference(self, mode: str) -> dict:
        """Per answered batch and step: the reference's scores over the
        served tokens (float32 on the device), and the tokens it would
        put first at each position (for a control in the program's
        place)."""
        params = self.weights
        out = {"scores": {}, "tokens": {}}
        for b, answer in self.answers.items():
            data = self.batches[b]["batch"]
            memories = [None] * int(self.cfg["num_hidden_layers"])
            out["scores"][b], out["tokens"][b] = [], []
            for s in range(self.batches[b]["steps"]):
                served = torch.as_tensor(np.asarray(answer[s]),
                                         device=self.device)
                text, text_mask, _ = self._served(served)
                ids = data["input_ids"][s].clone()
                ids[:, self.v_len:] = text
                masks = data["input_mask"][s].clone()
                masks[:, self.v_len:] = text_mask
                with torch.no_grad():
                    memories, scores = ref.forward_step(
                        params, self.cfg, memories, ids,
                        data["video_feature"][s], masks,
                        data["token_type_ids"][s], mode)
                scores = scores[:, self.v_len:].clone()
                scores[..., UNK] = -float("inf")
                out["scores"][b].append(scores)
                first = scores.argmax(-1)  # the token after each position
                tokens = served.clone()
                tokens[:, 1:] = first[:, :-1]
                out["tokens"][b].append(tokens.cpu())
        return out

    def compare(self, prog: dict, refr: dict) -> Dict[str, float]:
        """The widest gap, over every served position of every real
        sentence, between the reference's best score and its score of the
        token served there."""
        worst = 0.0
        for b, steps in refr["scores"].items():
            info = self.batches[b]
            for s, scores in enumerate(steps):
                served = torch.as_tensor(np.asarray(
                    self.answers[b][s])).to(scores.device)
                _, _, last = self._served(served)
                tok = prog["tokens"][b][s].to(scores.device)
                for i in range(info["n_real"]):
                    if s >= self.counts[info["rows"][i]]:
                        continue
                    n = int(last[i])  # positions 0 .. n-1 predict 1 .. n
                    if n < 1:
                        continue
                    rows = scores[i, :n]
                    gap = rows.max(-1).values - rows.gather(
                        1, tok[i, 1:n + 1, None].long())[:, 0]
                    worst = max(worst, float(gap.max()))
        return {"logit_gap": worst}
