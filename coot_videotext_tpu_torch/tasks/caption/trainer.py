"""
MART caption trainer: the validation that `train_caption --validate` runs.

Port of the serving parts of coot_videotext_tpu/tasks/caption/trainer.py
(reference mart/trainer_caption.py:106-693):
    - MartFilesHandler (:52): the caption/ dir and the translation files
    - validate_epoch (:295): teacher-forced loss and accuracy from the
      eval step, free-running greedy translation -> submission json ->
      language / stats / repetition evaluation -> meters; best field =
      CIDEr (:626-630); under is_test the `val_ep_<ep>.json` metrics file
      (the METEOR -999 patch-up of a trained run's best epoch, :643-656,
      comes with training)
    - `prefetch` (JAX `_prefetch` :258): a background thread collates the
      next batches, pins them and copies them to the card on a side CUDA
      stream; the step's stream waits on the copy's event.
The evaluation weights are the model's parameters: the JAX trainer sets its
EMA to the loaded weights of a reference checkpoint
(torch_convert.convert_model_file :561-563). Training (BertAdam, EMA, the
train step) is not ported yet (ROADMAP A9b).
"""

from __future__ import annotations

import json
import queue
import threading
from collections import defaultdict
from pathlib import Path
from timeit import default_timer as timer
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import STACKED_KEYS
from coot_videotext_tpu_torch.tasks.caption.config import (
    MartConfig, MartMetersConst as MMeters)
from coot_videotext_tpu_torch.tasks.caption.eval_tools import (
    get_reference_files)
from coot_videotext_tpu_torch.tasks.caption.evaluate_language import (
    evaluate_language_files)
from coot_videotext_tpu_torch.tasks.caption.evaluate_repetition import (
    evaluate_repetition_files)
from coot_videotext_tpu_torch.tasks.caption.evaluate_stats import (
    evaluate_stats_files)
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    MartModelManager)
from coot_videotext_tpu_torch.tasks.caption.steps import caption_eval_step
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.train.trainer_base import BaseTrainer
from coot_videotext_tpu_torch.utils.experiments import ExperimentFilesHandler
from coot_videotext_tpu_torch.utils.general import (
    ExperimentTypesConst, TrainerPathConst)
from coot_videotext_tpu_torch.utils.metrics import TRANSLATION_METRICS

TRANSLATION_METRICS_LOG = ["Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "re4"]


class MartFilesHandler(ExperimentFilesHandler):
    """Adds the caption/ dir + translation files (reference :52)."""

    def __init__(self, exp_group: str, exp_name: str, run_name: str, *,
                 log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 annotations_dir: str = TrainerPathConst.DIR_ANNOTATIONS
                 ) -> None:
        super().__init__(ExperimentTypesConst.CAPTION, exp_group, exp_name,
                         run_name, log_dir=log_dir)
        self.annotations_dir = annotations_dir
        self.path_caption = self.path_base / TrainerPathConst.DIR_CAPTION

    def get_translation_files(self, epoch, split: str) -> Path:
        return self.path_caption / (
            f"{TrainerPathConst.FILE_PREFIX_TRANSL_RAW}_{epoch}_"
            f"{split}.json")

    def setup_dirs(self, *, reset: bool = False) -> None:
        super().setup_dirs(reset=reset)
        self.path_caption.mkdir(parents=True, exist_ok=True)


def prefetch(loader, device: torch.device, depth: int = 2
             ) -> Iterator[Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
    """(device batch, host part) of each stacked batch of `loader`.

    A background thread collates the batches `depth` ahead. On a CUDA
    device it pins each batch and copies it non_blocking on a side stream,
    recording an event that the consuming stream waits on before the
    batch is used; on the CPU the tensors are the collated arrays."""
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def producer() -> None:
        try:
            if cuda:
                torch.cuda.set_device(device)
            for stacked, step_sizes, metas in loader:
                host = {"step_sizes": step_sizes, "metas": metas}
                tensors = {k: torch.from_numpy(stacked[k])
                           for k in STACKED_KEYS}
                if not cuda:
                    q.put((tensors, host, None))
                    continue
                with torch.cuda.stream(stream):
                    batch = {k: t.pin_memory().to(device, non_blocking=True)
                             for k, t in tensors.items()}
                    event = torch.cuda.Event()
                    event.record(stream)
                q.put((batch, host, event))
        except BaseException as e:  # re-raised in the consumer
            q.put(e)
            return
        q.put(done)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        batch, host, event = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        yield batch, host


class MartTrainer(BaseTrainer):
    """Caption trainer (reference MartTrainer :106), validation only."""

    def __init__(self, cfg: MartConfig, model_mgr: MartModelManager,
                 exp_group: str, exp_name: str, run_name: str,
                 train_loader_length: int, *,
                 log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 annotations_dir: str = TrainerPathConst.DIR_ANNOTATIONS,
                 load_model: Optional[str] = None, load_best: bool = False,
                 load_epoch: Optional[int] = None, reset: bool = False,
                 is_test: bool = False) -> None:
        files_handler = MartFilesHandler(
            exp_group, exp_name, run_name, log_dir=log_dir,
            annotations_dir=annotations_dir)
        super().__init__(cfg, model_mgr, exp_group, exp_name, run_name,
                         train_loader_length, ExperimentTypesConst.CAPTION,
                         load_model=load_model, load_best=load_best,
                         load_epoch=load_epoch, reset=reset,
                         is_test=is_test, log_dir=log_dir,
                         exp_files_handler=files_handler)
        self.cfg: MartConfig = cfg
        self.metrics.add_meter(MMeters.VAL_LOSS_PER_WORD, use_avg=False)
        self.metrics.add_meter(MMeters.VAL_ACC, use_avg=False)
        for meter_name in TRANSLATION_METRICS.values():
            self.metrics.add_meter(meter_name, use_avg=False)
        self.logger.info(f"Model: {model_mgr.count_parameters():,} "
                         f"parameters on {self.device}")
        self.translator = Translator(model_mgr.model, cfg)
        # per val batch: host ms of the eval step (to its read) and of the
        # greedy decode, the decode's forwards; the last batch's device
        self.val_timings: Dict[str, List[float]] = defaultdict(list)
        self.last_batch_device: Optional[torch.device] = None
        self.hook_post_init()

    # ---------- checkpoint state ----------

    def get_model_state(self) -> Dict[str, Any]:
        return self.model_mgr.state_dict()

    def set_model_state(self, state: Dict[str, Any]) -> None:
        self.model_mgr.load_state(state)

    # ---------- validation + translation ----------

    def validate_epoch(self, data_loader
                       ) -> Tuple[float, float, bool, Dict[str, float]]:
        self.hook_pre_val_epoch()
        total_loss = 0.0
        n_word_total = 0
        n_word_correct = 0
        self.val_timings.clear()
        batch_res = {"version": "VERSION 1.0",
                     "results": defaultdict(list),
                     "external_data": {"used": "true", "details": "ay"}}
        dataset = data_loader.dataset

        for batch, host in prefetch(data_loader, self.device):
            self.last_batch_device = batch["input_ids"].device
            t0 = timer()
            out = caption_eval_step(self.model_mgr.model, batch)
            loss, n_word, n_correct = torch.stack(
                [out["loss"], out["n_word"], out["n_correct"]]).tolist()
            t1 = timer()
            total_loss += loss
            n_word_total += int(n_word)
            n_word_correct += int(n_correct)
            dec = self.translator.translate_batch_greedy(
                batch["input_ids"], batch["video_feature"],
                batch["input_mask"], batch["token_type_ids"])
            t2 = timer()
            self.val_timings["eval_ms"].append((t1 - t0) * 1e3)
            self.val_timings["decode_ms"].append((t2 - t1) * 1e3)
            self.val_timings["forwards"].append(self.translator.forwards)

            for ex_idx, (step_size, cur_meta) in enumerate(
                    zip(host["step_sizes"], host["metas"])):
                for step_idx, step_batch in enumerate(dec[:step_size]):
                    batch_res["results"][cur_meta["name"]].append({
                        "sentence": dataset.convert_ids_to_sentence(
                            step_batch[ex_idx].tolist()),
                        "timestamp": cur_meta["timestamp"][step_idx],
                        "gt_sentence": cur_meta["gt_sentence"][step_idx],
                    })

        batch_res["results"] = Translator.sort_res(batch_res["results"])
        eval_mode = self.cfg.dataset_val.split
        file_translation_raw = self.exp.get_translation_files(
            self.state.current_epoch, eval_mode)
        file_translation_raw.write_text(json.dumps(batch_res),
                                        encoding="utf8")

        reference_files = get_reference_files(
            self.cfg.dataset_val.name, self.exp.annotations_dir)[eval_mode]
        res_lang = evaluate_language_files(file_translation_raw,
                                           reference_files, verbose=False,
                                           all_scorer=True)
        res_stats = evaluate_stats_files(file_translation_raw,
                                         reference_files[0], verbose=False)
        res_rep = evaluate_repetition_files(file_translation_raw,
                                            reference_files[0],
                                            verbose=False)
        flat_metrics: Dict[str, float] = {}
        for key, val in {**res_lang, **res_stats, **res_rep}.items():
            if isinstance(val, dict):
                for subkey, subval in val.items():
                    flat_metrics[f"{key}_{subkey}"] = subval
            else:
                flat_metrics[key] = val
        flat_metrics = {k: (float(v) if isinstance(v, np.floating) else v)
                        for k, v in flat_metrics.items()}
        for result_key, meter_name in TRANSLATION_METRICS.items():
            if result_key in flat_metrics:
                self.metrics.update_meter(meter_name,
                                          flat_metrics[result_key])

        self.logger.info(
            f"Done with translation, epoch {self.state.current_epoch} "
            f"split {eval_mode}")
        self.logger.info(", ".join(
            f"{name} {flat_metrics[name]:.2%}"
            for name in TRANSLATION_METRICS_LOG if name in flat_metrics))

        loss_per_word = total_loss / max(n_word_total, 1)
        accuracy = n_word_correct / max(n_word_total, 1)
        self.metrics.update_meter(MMeters.VAL_LOSS_PER_WORD, loss_per_word)
        self.metrics.update_meter(MMeters.VAL_ACC, accuracy)
        self.logger.info(
            f"Loss {loss_per_word:.5f} Acc {accuracy:.3%} total "
            f"{timer() - self.timer_val_epoch:.3f}s, eval step "
            f"{np.median(self.val_timings['eval_ms']):.1f} ms, decode "
            f"{np.median(self.val_timings['decode_ms']):.1f} ms per batch "
            "(median)")

        if self.cfg.val.det_best_field != "cider":
            raise NotImplementedError(
                f"best field {self.cfg.val.det_best_field} not known")
        val_score = flat_metrics["CIDEr"]
        is_best = self.check_is_new_best(val_score)
        self.hook_post_val_epoch(loss_per_word, is_best)

        if self.is_test:
            epoch = self.state.current_epoch
            self.metrics.feed_metrics(False, self.state.total_step, epoch)
            metrics_file = self.exp.path_base / f"val_ep_{epoch}.json"
            self.metrics.save_epoch_to_file(metrics_file)
            self.logger.info(f"Saved validation results to {metrics_file}")
        return total_loss, val_score, is_best, flat_metrics
