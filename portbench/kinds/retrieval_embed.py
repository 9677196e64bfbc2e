"""
Retrieval embedding of a split's videos and paragraphs: id batches of the
traffic's batch size in order (the last of a pass padded as invalid),
each through the model's captured eval program
(`tasks/retrieval/steps.py::retrieval_eval_step`: centre sampling, no
noise, the forward in the validation dtype); closed loop, one request in
flight: a request is one batch issued and its video, clip, paragraph and
sentence embeddings and both contexts read to the host.

Correct: the answers of the window's last pass (one for each batch of the
split) against the reference's embeddings of the same ids from the same
weights and features, row by row over the valid clips and sentences.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import data, work
from portbench.coot_program import CootProgram
from portbench.reference import coot as ref
from portbench.trace import span

OUTPUTS = ("vid_emb", "par_emb", "clip_emb", "sent_emb", "vid_context",
           "par_context")
READ = OUTPUTS + tuple(f"{k}_before_norm" for k in OUTPUTS) + (
    "clip_valid", "sent_valid")


class Cell:
    control_mode = "fp8"  # one precision below the configuration's bf16
    FAULTS = ("answer_altered",)

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, fault: str = None) -> None:
        """`fault` (checks of the check only): "answer_altered" changes
        one row of one answer where it is produced."""
        from coot_videotext_tpu_torch.tasks.retrieval.steps import (
            retrieval_eval_step)
        self._step = retrieval_eval_step
        if fault not in (None,) + self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.cfg, self.seed, self.device = cfg, seed, device
        self.size = int(traffic["batch_size"])
        self.split = data.RetrievalSplit(cfg, traffic["split"], seed, device,
                                         torch.bfloat16)
        self.prog = CootProgram(cfg, self.split, seed, device, self.size,
                                train=False)
        self.prog.model.eval()
        self.dims = work.coot_dims(cfg)
        n = len(self.split)
        self.requests = []
        for start in range(0, n, self.size):
            ids = np.zeros(self.size, np.int32)
            chunk = np.arange(start, min(n, start + self.size))
            ids[:len(chunk)] = chunk
            valid = np.arange(self.size) < len(chunk)
            self.requests.append({
                "ids": ids, "valid": valid,
                "batch": {"layout": "ids",
                          "dp_idx": torch.as_tensor(ids, device=device),
                          "batch_valid": torch.as_tensor(valid,
                                                         device=device)}})
        # the host side of every answer: a pinned buffer set per batch of
        # a pass, filled by asynchronous copies and one wait a request
        self.answers: Dict[int, dict] = {}
        self.latencies: List[float] = []
        self.spans: List[float] = []
        for i in range(len(self.requests)):  # warm: capture, one pass
            self.request(i)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def request(self, i: int) -> float:
        """Issue batch i, read its answer to the host; its latency."""
        p = self.prog
        start = time.perf_counter()
        with span("eval_request"):
            embs, _ = self._step(p.model, self.requests[i]["batch"],
                                 compute_dtype=p.val_dtype,
                                 source=p.source, **p.loss_kw)
            self.spans.append(time.perf_counter() - start)
        with span("answer_read"):
            answer = self.answers.get(i)
            if answer is None:  # the first pass allocates the buffers
                answer = {k: torch.empty(embs[k].shape, dtype=embs[k].dtype,
                                         pin_memory=self.device.type ==
                                         "cuda") for k in READ}
                self.answers[i] = answer
            for k in READ:
                answer[k].copy_(embs[k], non_blocking=True)
            self.sync()
        latency = time.perf_counter() - start
        if self.fault == "answer_altered":
            answer["clip_emb"][0, 0] = -answer["clip_emb"][0, 0]
        return latency

    def window(self, seconds: float) -> Dict[str, float]:
        self.spans.clear()
        self.latencies.clear()
        videos, i = 0, 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.latencies.append(self.request(i))
            videos += int(self.requests[i]["valid"].sum())
            i = (i + 1) % len(self.requests)
        elapsed = time.perf_counter() - start
        lat = sorted(self.latencies)
        p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
        return {"embed_videos_per_s": videos / elapsed,
                "embed_ms_p95": 1e3 * p95}

    def attempted(self) -> int:
        return len(self.latencies)

    def traced_work(self):
        """One pass over the split."""
        counts = self.split.valid_counts(range(len(self.split)))

        def run():
            for i in range(len(self.requests)):
                self.request(i)
        return run, counts, len(self.requests)

    def layer_context(self, trace, counts, requests) -> dict:
        return {"trace": trace, "steps": requests,
                "flops": work.coot_eval_flops(counts, self.dims),
                "peak_flops": work.PEAK_FLOPS["bfloat16"],
                "kernel_bound_s": work.coot_kernel_bound_s(counts, self.dims,
                                                           False),
                "host_s": sum(self.spans), "host_calls": len(self.spans)}

    # ---------- correctness ----------

    def free_program(self) -> None:
        self.prog.model = None
        self.prog.meta = None
        self.prog.source = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_outputs(self) -> dict:
        return {i: {k: v.clone() for k, v in a.items()}
                for i, a in self.answers.items()}

    def reference(self, mode: str) -> dict:
        tables, shapes = ref.build_tables(
            self.split.meta, self.split.vid_off, self.split.text_off,
            self.split.shapes, self.size, self.device)
        out = {}
        for i, r in enumerate(self.requests):
            embs = ref.eval_embeddings(
                self.prog.weights, tables, shapes, self.split.max_frames,
                self.split.vid_store, self.split.text_store,
                torch.as_tensor(r["ids"], device=self.device),
                torch.as_tensor(r["valid"], device=self.device), self.cfg,
                mode)
            out[i] = {k: v.cpu() for k, v in embs.items()}
            out[i]["valid"] = torch.as_tensor(r["valid"])
        return out

    @staticmethod
    def diagnostics(prog: dict, refr: dict) -> Dict[str, float]:
        """Per output, normalised and before the norm, the worst valid row
        of any answer: |answer - reference| / |reference|
        (`<output>_row_error`, `<output>_raw_row_error`)."""
        worst = {}
        for i, r in refr.items():
            p, v = prog[i], r["valid"]
            for k in OUTPUTS:
                rows = v if k not in ("clip_emb", "sent_emb") else (
                    r[k.replace("emb", "valid")] & v[:, None])
                for name, key in ((f"{k}_row_error", k),
                                  (f"{k}_raw_row_error", f"{k}_before_norm")):
                    pr, rr = p[key][rows].double(), r[key][rows].double()
                    err = (pr - rr).norm(dim=-1) / rr.norm(dim=-1).clamp(
                        min=1e-30)
                    if err.numel():
                        worst[name] = max(worst.get(name, 0.0),
                                          float(err.max()))
        return worst

    @classmethod
    def compare(cls, prog: dict, refr: dict) -> Dict[str, float]:
        """The clip and sentence embeddings' worst rows. The video,
        paragraph and context outputs pool over many more rows, and there
        the fp8 control reads only 1.5-2.4x the program (PERF.md): they
        are read by `diagnostics` and left out of the verdict."""
        d = cls.diagnostics(prog, refr)
        return {k: d[k] for k in ("clip_emb_row_error",
                                  "sent_emb_row_error")}
