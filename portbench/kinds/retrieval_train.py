"""
Retrieval training on the device-resident group path: id batches of the
traffic's batch size, shuffled from the seed, one epoch after another;
K steps a group as the trainer forms them (the epoch's batches in groups
of K, its tail in a shorter one), through
`tasks/retrieval/steps.py::retrieval_train_group`, one read of the
group's metrics; closed loop, no validation.

Set-up builds the one train state, runs its first six steps (a group of
one step, which captures the step program, a group of K, then the rest)
on the first six batches of a set-up epoch, keeps the losses, the
optimizer's first moment after step 1, and its second moment and the
parameters after step 6, and hands that state to the window, which
starts at epoch 1.

Correct: the reference (`reference/coot.py`) follows the same six steps
from the same weights, ids and seed states, with RAdam written out
(`reference/coot.py::radam`). RAdam moves no parameter before step 6
(the length of its SMA is under 5 until then at beta2 0.98), so step 6
is the first that writes the parameters. Compared: each step's loss, the
first gradient leaf by leaf as the optimizer got it (its first moment
after step 1 over 1 - beta1), the parameters' change after step 6 and
the second moment after step 6, each by its worst leaf.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, data, work
from portbench.coot_program import CootProgram
from portbench.reference import coot as ref
from portbench.trace import span

CHECK_STEPS = 6


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().float().to("cpu", copy=True)
            for n, t in tensors.items()}


class Epochs:
    """Id batches of `size`: epoch e is a permutation drawn from (seed,
    e); the last batch of an epoch is short and padded as invalid."""

    def __init__(self, n: int, size: int, seed: int) -> None:
        self.n, self.size, self.seed = n, size, seed

    def batches(self, epoch: int) -> List[np.ndarray]:
        order = np.random.default_rng([self.seed, epoch]).permutation(self.n)
        return [order[i:i + self.size] for i in range(0, self.n, self.size)]

    def padded(self, ids: np.ndarray):
        out = np.zeros(self.size, np.int32)
        out[:len(ids)] = ids
        valid = np.zeros(self.size, bool)
        valid[:len(ids)] = True
        return out, valid


class Cell:
    """One run of the cell: set-up, window, traced window, check."""

    control_mode = "fp8"  # one precision below the configuration's bf16
    FAULTS = ("half_batch", "update_skipped")

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, fault: str = None) -> None:
        """`fault` (checks of the check only): "half_batch" gives the
        program's first steps the first half of each batch alone, the
        loss a mean over it; "update_skipped" has the optimizer write its
        updates into copies, so the model's parameters never move."""
        from coot_videotext_tpu_torch.tasks.retrieval.steps import (
            retrieval_train_group)
        self._group = retrieval_train_group
        self.cfg, self.seed = cfg, seed
        self.device = device
        self.k = int(traffic["steps_per_group"])
        self.size = int(traffic["batch_size"])
        self.split = data.RetrievalSplit(cfg, traffic["split"], seed, device,
                                         torch.bfloat16)
        self.prog = CootProgram(cfg, self.split, seed, device, self.size,
                                train=True)
        self.epochs = Epochs(len(self.split), self.size, seed)
        self.lr = float(cfg["optimizer"]["lr"])
        self.dims = work.coot_dims(cfg)
        self.spans: List[float] = []
        self.window_steps = 0
        # the first steps: ids, losses, moments, parameters
        first = self.epochs.batches(0)[:CHECK_STEPS]
        if len(first) < CHECK_STEPS:
            raise ValueError(f"the checked steps need {CHECK_STEPS} batches "
                             "of one epoch")
        self.check_ids = [self.epochs.padded(b) for b in first]
        fed = self.check_ids
        opt = self.prog.state.optimizer
        if fault == "half_batch":
            fed = [(ids, np.arange(self.size) < self.size // 2)
                   for ids, _ in fed]
        elif fault == "update_skipped":  # the update lands in copies
            copies = [p.detach().clone() for p in opt.params.values()]
            lists = opt._lists
            opt._lists = lambda grads: (copies,) + lists(grads)[1:]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        self.losses: List[float] = []
        out = self.group(fed[:1])
        self.losses += out["loss_total"]
        self.moment1 = _host(opt.mu)
        for g in range(1, CHECK_STEPS, self.k):
            self.losses += self.group(fed[g:g + self.k])["loss_total"]
        self.moment2 = _host(opt.nu)
        self.params6 = _host(dict(self.prog.model.named_parameters()))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def group(self, batches) -> Dict[str, list]:
        """One group call and its one read; the host span covers the call
        until it returns."""
        ids = np.zeros((self.k, self.size), np.int32)
        valid = np.zeros((self.k, self.size), bool)
        for i, (b, v) in enumerate(batches):
            ids[i], valid[i] = b, v
        p = self.prog
        with span("train_group"):
            t = time.perf_counter()
            metrics = self._group(
                p.state, ids, valid, len(batches), lr=self.lr,
                clip_gradient=float(self.cfg["train"]["clip_gradient"]),
                compute_dtype=p.train_dtype, source=p.source, **p.loss_kw)
            self.spans.append(time.perf_counter() - t)
        with span("metrics_read"):
            names = list(metrics)
            values = torch.stack([metrics[n] for n in names]).cpu()
        return {n: values[j].tolist() for j, n in enumerate(names)}

    def _groups(self, first_epoch: int = 1):
        epoch = first_epoch
        while True:
            batches = [self.epochs.padded(b)
                       for b in self.epochs.batches(epoch)]
            for g in range(0, len(batches), self.k):
                yield batches[g:g + self.k]
            epoch += 1

    def window(self, seconds: float) -> Dict[str, float]:
        """Closed loop for `seconds`: train videos a second over all the
        window's work and time."""
        self.spans.clear()
        groups = self._groups()
        videos = steps = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            batch = next(groups)
            self.group(batch)
            videos += int(sum(v.sum() for _, v in batch))
            steps += len(batch)
        elapsed = time.perf_counter() - start
        self.window_steps = steps
        return {"train_videos_per_s": videos / elapsed}

    def traced_work(self, groups: int = 2):
        """The work of a traced window: the first `groups` groups of an
        epoch of its own; returns a function that runs them, the valid
        counts they hold and their steps."""
        source = self._groups(first_epoch=10 ** 6)
        chosen = [next(source) for _ in range(groups)]
        counts = self.split.valid_counts(
            np.concatenate([b[v] for g in chosen for b, v in g]))

        def run():
            for g in chosen:
                self.group(g)
        return run, counts, sum(len(g) for g in chosen)

    def layer_context(self, trace, counts, steps) -> dict:
        return {"trace": trace, "steps": steps,
                "flops": work.coot_train_flops(counts, self.dims),
                "peak_flops": work.PEAK_FLOPS["bfloat16"],
                "kernel_bound_s": work.coot_kernel_bound_s(counts, self.dims,
                                                           True),
                "host_s": sum(self.spans), "host_calls": self.window_steps}

    def attempted(self) -> int:
        return self.window_steps

    # ---------- correctness ----------

    def free_program(self) -> None:
        """Drops the program's state; the split and the weights stay."""
        self.prog.state = None
        self.prog.model = None
        self.prog.meta = None
        self.prog.source = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str) -> dict:
        """The reference's six steps: losses, the first moment after step
        1, the second moment and the parameters' change after step 6."""
        tables, shapes = ref.build_tables(
            self.split.meta, self.split.vid_off, self.split.text_off,
            self.split.shapes, self.size, self.device)
        params = dict(self.prog.weights)
        moments = {"m": {}, "v": {}}
        out = {"losses": []}
        for step, (ids, valid) in enumerate(self.check_ids):
            state = ref.philox.seed_state(self.seed + step, self.device)
            parts, grads = ref.train_step(
                params, tables, shapes, self.split.max_frames,
                self.split.vid_store, self.split.text_store,
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(valid, device=self.device), state,
                self.cfg, mode)
            out["losses"].append(parts["loss_total"])
            params, moments = ref.radam(params, grads, moments, step + 1,
                                        self.cfg)
            if step == 0:
                out["moment1"] = _host(moments["m"])
        out["moment2"] = _host(moments["v"])
        out["change6"] = {n: (p - self.prog.weights[n].float()).cpu()
                          for n, p in params.items()}
        return out

    def program_outputs(self) -> dict:
        return {"losses": list(self.losses), "moment1": self.moment1,
                "moment2": self.moment2,
                "change6": {n: p - self.prog.weights[n].float().cpu()
                            for n, p in self.params6.items()}}

    @staticmethod
    def diagnostics(prog: dict, refr: dict) -> dict:
        """The worst three leaves of each leaf-by-leaf number, the count
        of kept leaves, and the median leaf's change gap."""
        keep = check.leaves_that_move(refr["moment1"])
        out = {"kept_leaves": len(keep)}
        for k in ("moment1", "change6", "moment2"):
            gaps = check.leaf_gaps(prog[k], refr[k], keep)
            out[f"worst_{k}"] = sorted(gaps.items(), key=lambda x: -x[1])[:3]
            out[f"median_{k}"] = statistics.median(gaps.values())
        return out

    @staticmethod
    def compare(prog: dict, refr: dict) -> Dict[str, float]:
        """The numbers compared (each a relative gap; 0 is exact)."""
        keep = check.leaves_that_move(refr["moment1"])
        return {
            "loss_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], refr["losses"])),
            "grad1_leaf_gap": check.worst_leaf_gap(
                prog["moment1"], refr["moment1"], keep),
            "grad1_leaf_error": check.worst_leaf_error(
                prog["moment1"], refr["moment1"], keep),
            "change6_leaf_gap": check.worst_leaf_gap(
                prog["change6"], refr["change6"], keep),
            "moment2_leaf_gap": check.worst_leaf_gap(
                prog["moment2"], refr["moment2"], keep),
        }
