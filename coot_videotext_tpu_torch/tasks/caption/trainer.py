"""
Caption trainer (every caption model: MART, the TransformerXL, the untied
and joint single-sentence models, the MTransformer): training and
validation on one torch device.

Port of coot_videotext_tpu/tasks/caption/trainer.py (reference
mart/trainer_caption.py:106-693):
    - MartFilesHandler (:52): the caption/ dir and the translation files
    - BertAdam (no bias correction, per-parameter clip; masks by JAX's
      names, `freeze_glove` freezing the word embeddings) with the host's
      warmup_linear schedule over t_total = steps * epochs (:108-117,
      :177-181), the EMA shadow updated each step
    - train_model (:207-257): per epoch `set_epoch`, the train steps
      (tasks/caption/steps.py `caption_train_step` on stacked video
      batches, or `caption_train_step_single` on sentence batches, untied
      or joint, when `recurrent` is false, :121-163; each keyed on the
      seed state cfg.random_seed + total_step, so a resumed run draws the
      dropout masks of the unbroken one), one read of each step's metrics,
      the GRAD / TRAIN_LOSS_PER_WORD / TRAIN_ACC meters, validation per
      val_start / val_freq, the EMA saved as `modelema_<ep>.pth`
      ({"model": state_dict}), the checkpoint and its cleanup with the
      epoch's translations and EMA (`get_files_for_cleanup` :449)
    - validate_epoch (:295): teacher-forced loss and accuracy from the
      eval step, free-running translation (the decode the config selects:
      greedy, or beam search under use_beam; per video and sentence step,
      or per sentence, :317-357) -> submission json ->
      language / stats / repetition evaluation -> meters; best field =
      CIDEr (:626-630); under is_test the `val_ep_<ep>.json` metrics file
      and the METEOR -999 patch-up of the best epoch's metrics file
      (:429-446)
    - the batches of both loops come through data/pipeline.py `prefetch`
      (JAX `_prefetch` :258): a background thread collates the next
      batches, pins them and copies them to the card on a side CUDA
      stream; the step's stream waits on the copy's event.
The evaluation weights (`_eval_params` :170) are the EMA shadow whenever
the run has one: a training run swaps it into the model for each
validation and swaps the trained weights back; `--validate` of an epoch
evaluates that epoch's `modelema_<ep>.pth` where it exists. A model given
by `--load_model` is evaluated as loaded (the JAX trainer sets its EMA to
the loaded weights of a reference checkpoint,
torch_convert.convert_model_file :561-563). The checkpoint's model file
keeps the reference layout {"model": state_dict}; the optimizer file holds
BertAdam's moments and step, the train state's step and the seed state.
Validation runs build no optimizer and no EMA.

Under a data-parallel mesh (parallel/mesh.py; JAX :147-164, :276) each
rank trains and runs the eval step on its rows of every global batch, the
sums over ranks making the global step (tasks/caption/steps.py); the
parameters are broadcast from rank 0 once they are initialised or
loaded. The decode runs unsharded, as JAX's translator has no mesh: rank
0 decodes and scores the whole split while the others wait, and every
rank takes its scores. Only rank 0 writes files.

Under a `model` axis (parallel/tp.py) the trainer shards recurrent MART,
BertAdam's moments and the EMA by the rules once they are loaded; the
ranks of data rank 0's model group decode together, and the model, EMA
and optimizer files hold whole tensors (gathered by every rank, written
by rank 0). Every other caption model refuses a `model` axis.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from pathlib import Path
from timeit import default_timer as timer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    STACKED_KEYS, UNTIED_KEYS)
from coot_videotext_tpu_torch.data.pipeline import prefetch
from coot_videotext_tpu_torch.parallel import mesh as pmesh
from coot_videotext_tpu_torch.parallel.tp import Layout, shard_model_for_tp
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
from coot_videotext_tpu_torch.tasks.caption.steps import (
    CaptionTrainState, caption_eval_step, caption_eval_step_single,
    caption_train_step, caption_train_step_single, init_caption_train_state)
from coot_videotext_tpu_torch.tasks.caption.translator import Translator
from coot_videotext_tpu_torch.train import checkpoint as ckpt
from coot_videotext_tpu_torch.train.optim import warmup_linear
from coot_videotext_tpu_torch.train.trainer_base import BaseTrainer
from coot_videotext_tpu_torch.utils.experiments import ExperimentFilesHandler
from coot_videotext_tpu_torch.utils.general import (
    ExperimentTypesConst, TrainerPathConst)
from coot_videotext_tpu_torch.utils.metrics import (
    TRANSLATION_METRICS, TextMetricsConst)

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


def split_caption_batch(item) -> Tuple[Dict[str, np.ndarray],
                                       Dict[str, Any]]:
    """(arrays, host part) of a caption loader item (stacked, step_sizes,
    metas): the stacked arrays of a recurrent batch or the untied or joint
    arrays of a sentence batch, for data/pipeline.py `prefetch`."""
    stacked, step_sizes, metas = item
    keys = UNTIED_KEYS if "text_ids" in stacked else STACKED_KEYS
    return ({k: stacked[k] for k in keys},
            {"step_sizes": step_sizes, "metas": metas})


class MartTrainer(BaseTrainer):
    """Caption trainer (reference MartTrainer :106)."""

    def __init__(self, cfg: MartConfig, model_mgr: MartModelManager,
                 exp_group: str, exp_name: str, run_name: str,
                 train_loader_length: int, *,
                 log_dir: str = TrainerPathConst.DIR_EXPERIMENTS,
                 annotations_dir: str = TrainerPathConst.DIR_ANNOTATIONS,
                 load_model: Optional[str] = None, load_best: bool = False,
                 load_epoch: Optional[int] = None, reset: bool = False,
                 is_test: bool = False,
                 mesh: Optional[pmesh.Mesh] = None) -> None:
        files_handler = MartFilesHandler(
            exp_group, exp_name, run_name, log_dir=log_dir,
            annotations_dir=annotations_dir)
        super().__init__(cfg, model_mgr, exp_group, exp_name, run_name,
                         train_loader_length, ExperimentTypesConst.CAPTION,
                         load_model=load_model, load_best=load_best,
                         load_epoch=load_epoch, reset=reset,
                         is_test=is_test, log_dir=log_dir,
                         exp_files_handler=files_handler, mesh=mesh)
        self.cfg: MartConfig = cfg
        self.metrics.add_meter(MMeters.TRAIN_LOSS_PER_WORD, use_avg=False)
        self.metrics.add_meter(MMeters.TRAIN_ACC, use_avg=False)
        self.metrics.add_meter(MMeters.VAL_LOSS_PER_WORD, use_avg=False)
        self.metrics.add_meter(MMeters.VAL_ACC, use_avg=False)
        self.metrics.add_meter(MMeters.GRAD, per_step=True,
                               reset_avg_each_epoch=True)
        for meter_name in TRANSLATION_METRICS.values():
            self.metrics.add_meter(meter_name, use_avg=False)
        self.logger.info(f"Model: {model_mgr.count_parameters():,} "
                         f"parameters on {self.device}")

        # BertAdam + EMA (reference :190-209)
        self.t_total = train_loader_length * cfg.train.num_epochs
        self.train_state: Optional[CaptionTrainState] = None
        # a validation run's layout (it has no train state to hold it)
        self._eval_tp: Optional[Layout] = None
        if not is_test:
            self.train_state = init_caption_train_state(
                model_mgr.model, cfg, cfg.random_seed or 0, self.mesh)
        # the single-sentence layouts, untied or joint (JAX :121-122)
        self.single = not cfg.recurrent
        self._train_step = (caption_train_step_single if self.single
                            else caption_train_step)
        self._eval_step = (caption_eval_step_single if self.single
                           else caption_eval_step)
        # the decodes run as captured programs (CUDA graphs on the card),
        # eagerly under a mesh of more than one rank (serves_captured)
        self.translator = Translator(
            model_mgr.model, cfg, eager=not pmesh.serves_captured(self.mesh))
        # per val batch: host ms of the eval step (to its read) and of the
        # decode, the decode's forwards and host reads; per train step its
        # host ms (to its read), per epoch the train videos/s (sentences/s
        # in the single-sentence layouts); the last batch's device
        self.val_timings: Dict[str, List[float]] = defaultdict(list)
        self.train_timings: Dict[str, List[float]] = defaultdict(list)
        self.last_batch_device: Optional[torch.device] = None
        self.hook_post_init()
        pmesh.broadcast_params(self.mesh, model_mgr.model.parameters())
        # the model, BertAdam's moments and the EMA sharded by the rules
        if self.mesh.tensor_parallel:
            ts = self.train_state
            tp = shard_model_for_tp(
                model_mgr.model, ts.optimizer if ts is not None else None,
                ts.ema if ts is not None else None, self.mesh)
            if ts is None:
                self._eval_tp = tp
            else:
                ts.tp = tp

    @property
    def tp(self) -> Optional[Layout]:
        """The tensor-parallel layout (None without a `model` axis): the
        train state's, or a validation run's."""
        ts = self.train_state
        return self._eval_tp if ts is None else ts.tp

    def current_lr(self) -> float:
        """The host's warmup_linear schedule (JAX current_lr :177)."""
        progress = self.state.total_step / max(self.t_total, 1)
        return float(self.cfg.lr) * warmup_linear(
            progress, self.cfg.lr_warmup_proportion)

    @contextlib.contextmanager
    def _eval_weights(self):
        """The evaluation weights in the model (JAX `_eval_params` :170):
        the EMA shadow when the run has one, the trained weights restored
        afterwards."""
        ema = self.train_state.ema if self.train_state is not None else None
        if ema is None:
            yield
            return
        with torch.no_grad():
            trained = {n: p.detach().clone() for n, p in ema.params.items()}
            for n, p in ema.params.items():
                p.copy_(ema.shadow[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in ema.params.items():
                    p.copy_(trained[n])

    # ---------- checkpoint state ----------

    def get_model_state(self) -> Dict[str, Any]:
        """{"model": state_dict} of whole tensors (gathered over the model
        group under tensor parallelism)."""
        state = self.model_mgr.state_dict()
        if self.tp is None:
            return state
        return {"model": self.tp.gather(state["model"])}

    def set_model_state(self, state: Dict[str, Any]) -> None:
        """Loads the weights; the EMA starts from them (JAX's converter
        does the same, torch_convert.py:561-563) until an EMA file of the
        epoch is loaded over it."""
        if self.tp is not None:
            state = {"model": self.tp.localize(state["model"])}
        self.model_mgr.load_state(state)
        if self.train_state is not None and self.train_state.ema is not None:
            self.train_state.ema.reset()

    def get_opt_state(self) -> Dict[str, Any]:
        ts = self.train_state
        opt = ts.optimizer.state_dict()
        if self.tp is not None:
            opt.update(mu=self.tp.gather(opt["mu"]),
                       nu=self.tp.gather(opt["nu"]))
        return {"optimizer": opt, "step": ts.step.clone(),
                "seed": ts.seed.clone()}

    def ema_state(self) -> Dict[str, torch.Tensor]:
        """The EMA's state dict of whole tensors (gathered over the model
        group under tensor parallelism: every rank calls it)."""
        state = self.train_state.ema.state_dict()
        return state if self.tp is None else self.tp.gather(state)

    def set_opt_state(self, state: Dict[str, Any]) -> None:
        ts = self.train_state
        opt = state["optimizer"]
        if self.tp is not None:
            opt = dict(opt, mu=self.tp.localize(opt["mu"]),
                       nu=self.tp.localize(opt["nu"]))
        ts.optimizer.load_state_dict(opt)
        ts.step.copy_(torch.as_tensor(state["step"]))
        ts.seed.copy_(state["seed"])

    def _load_checkpoint(self, epoch: int) -> None:
        """The epoch's checkpoint, then its EMA file where there is one:
        into the EMA of a training run, into the model itself for a
        validation."""
        super()._load_checkpoint(epoch)
        ema_file = self.exp.get_models_file_ema(epoch)
        if self.cfg.ema_decay <= 0 or not ema_file.is_file():
            return
        state = ckpt.load(ema_file)
        if self.tp is not None:
            state = {"model": self.tp.localize(state["model"])}
        if self.train_state is None:
            self.logger.info(f"Evaluating the EMA weights of {ema_file}")
            self.model_mgr.load_state(state)
        else:
            self.train_state.ema.load_state_dict(state["model"])

    def get_files_for_cleanup(self, epoch: int) -> List[Path]:
        """(reference :683)."""
        return [self.exp.get_translation_files(epoch, split="val"),
                self.exp.get_models_file_ema(epoch)]

    # ---------- training ----------

    def train_model(self, train_loader, val_loader) -> None:
        self.hook_pre_train()
        examples = len(train_loader.dataset)
        for _epoch in range(self.state.current_epoch,
                            self.cfg.train.num_epochs):
            if self.check_early_stop():
                break
            train_loader.set_epoch(self.state.current_epoch)
            self.hook_pre_train_epoch()
            total_loss = 0.0
            n_word_total = 0
            n_word_correct = 0
            for step, (batch, _) in enumerate(prefetch(
                    train_loader, self.device, split=split_caption_batch)):
                self.last_batch_device = batch["video_feature"].device
                self.hook_pre_step_timer()
                lr = self.current_lr()
                out = self._train_step(self.train_state, batch, lr)
                loss, n_word, n_correct, grad_norm = torch.stack(
                    [out["loss"], out["n_word"], out["n_correct"],
                     out["grad_norm"]]).tolist()
                self.hook_post_forward_step_timer()
                self.train_timings["step_ms"].append(
                    self.timedelta_step_forward * 1e3)
                total_loss += loss
                n_word_total += int(n_word)
                n_word_correct += int(n_correct)
                self.metrics.update_meter(MMeters.GRAD, grad_norm)
                self.hook_post_step(step, loss, lr, grad_norm=grad_norm)
            seconds = timer() - self.timer_train_epoch
            self.train_timings["epoch_videos_per_s"].append(
                examples / seconds)
            self.metrics.update_meter(MMeters.TRAIN_LOSS_PER_WORD,
                                      total_loss / max(n_word_total, 1))
            self.metrics.update_meter(MMeters.TRAIN_ACC,
                                      n_word_correct / max(n_word_total, 1))

            is_val = self.check_is_val_epoch()
            has_improved = False
            if is_val:
                _, _, has_improved, _ = self.validate_epoch(val_loader)
            ema = self.train_state.ema
            if ema is not None and (self.is_writer
                                    or self.mesh.tensor_parallel):
                state = self.ema_state()  # reference :391-393
                if self.is_writer:
                    ckpt.save(self.exp.get_models_file_ema(
                        self.state.current_epoch), {"model": state})
            self.hook_post_train_and_val_epoch(is_val, has_improved)
        self.hook_post_train()

    # ---------- validation + translation ----------

    def _eval_and_translate(self, data_loader
                            ) -> Tuple[Dict[str, list], float, int, int]:
        """The eval step and the decode of every val batch with the
        model's current weights: (translations by video, the summed loss,
        the word count, the correct words). Under a data-parallel mesh
        every rank runs the eval step on its rows, then data rank 0 (its
        model group together, under tensor parallelism) decodes the whole
        batches (the other ranks' translations are empty)."""
        if not self.mesh.data_parallel:
            return self._eval_batches(data_loader, decode=True)
        sums = self._eval_batches(data_loader, decode=False)
        results: Dict[str, list] = {}
        if self.mesh.data_rank == 0:
            results = self._eval_batches(data_loader.unsharded(),
                                         evaluate=False, decode=True)[0]
        return (results,) + sums[1:]

    def _eval_batches(self, data_loader, *, evaluate: bool = True,
                      decode: bool = True
                      ) -> Tuple[Dict[str, list], float, int, int]:
        """The eval step (`evaluate`) and the decode (`decode`) of every
        batch of `data_loader`."""
        total_loss = 0.0
        n_word_total = 0
        n_word_correct = 0
        results: Dict[str, list] = defaultdict(list)
        dataset = data_loader.dataset
        for batch, host in prefetch(data_loader, self.device,
                                    split=split_caption_batch):
            self.last_batch_device = batch["video_feature"].device
            t0 = timer()
            if evaluate:
                out = self._eval_step(self.model_mgr.model, batch,
                                      self.mesh)
                loss, n_word, n_correct = torch.stack(
                    [out["loss"], out["n_word"], out["n_correct"]]).tolist()
                total_loss += loss
                n_word_total += int(n_word)
                n_word_correct += int(n_correct)
                self.val_timings["eval_ms"].append((timer() - t0) * 1e3)
            if not decode:
                continue
            t1 = timer()
            dec = self.translator.translate_batch(batch)
            t2 = timer()
            self.val_timings["decode_ms"].append((t2 - t1) * 1e3)
            self.val_timings["forwards"].append(self.translator.forwards)
            self.val_timings["host_reads"].append(
                self.translator.host_reads)

            if self.single:
                for ex_idx, cur_meta in enumerate(host["metas"]):
                    results[cur_meta["name"]].append({
                        "sentence": dataset.convert_ids_to_sentence(
                            dec[ex_idx].tolist()),
                        "timestamp": cur_meta["timestamp"],
                        "gt_sentence": cur_meta["gt_sentence"],
                    })
                continue
            for ex_idx, (step_size, cur_meta) in enumerate(
                    zip(host["step_sizes"], host["metas"])):
                for step_idx, step_batch in enumerate(dec[:step_size]):
                    results[cur_meta["name"]].append({
                        "sentence": dataset.convert_ids_to_sentence(
                            step_batch[ex_idx].tolist()),
                        "timestamp": cur_meta["timestamp"][step_idx],
                        "gt_sentence": cur_meta["gt_sentence"][step_idx],
                    })
        return results, total_loss, n_word_total, n_word_correct

    def validate_epoch(self, data_loader
                       ) -> Tuple[float, float, bool, Dict[str, float]]:
        self.hook_pre_val_epoch()
        self.val_timings.clear()
        with self._eval_weights():
            results, total_loss, n_word_total, n_word_correct = \
                self._eval_and_translate(data_loader)
        eval_mode = self.cfg.dataset_val.split
        flat_metrics = (self._score_translations(results, eval_mode)
                        if self.is_writer else None)
        flat_metrics = pmesh.broadcast_object(self.mesh, flat_metrics)
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
        decode_ms = self.val_timings["decode_ms"]
        self.logger.info(
            f"Loss {loss_per_word:.5f} Acc {accuracy:.3%} total "
            f"{timer() - self.timer_val_epoch:.3f}s, eval step "
            f"{np.median(self.val_timings['eval_ms']):.1f} ms"
            + (f", decode {np.median(decode_ms):.1f} ms" if decode_ms
               else "") + " per batch (median)")

        if self.cfg.val.det_best_field != "cider":
            raise NotImplementedError(
                f"best field {self.cfg.val.det_best_field} not known")
        val_score = flat_metrics["CIDEr"]
        is_best = self.check_is_new_best(val_score)
        self.hook_post_val_epoch(loss_per_word, is_best)

        if self.is_test:
            epoch = self.state.current_epoch
            self.metrics.feed_metrics(False, self.state.total_step, epoch)
            if not self.is_writer:
                return total_loss, val_score, is_best, flat_metrics
            metrics_file = self.exp.path_base / f"val_ep_{epoch}.json"
            self.metrics.save_epoch_to_file(metrics_file)
            self.logger.info(f"Saved validation results to {metrics_file}")
            if self.cfg.dataset_val.split == "val":
                self._patch_meteor(flat_metrics["METEOR"])
        return total_loss, val_score, is_best, flat_metrics

    def _score_translations(self, results: Dict[str, list],
                            eval_mode: str) -> Dict[str, float]:
        """Writes the translations of the epoch and scores them: language
        metrics, sentence statistics and repetition, flattened."""
        batch_res = {"version": "VERSION 1.0",
                     "results": Translator.sort_res(results),
                     "external_data": {"used": "true", "details": "ay"}}
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
        return {k: (float(v) if isinstance(v, np.floating) else v)
                for k, v in flat_metrics.items()}

    def _patch_meteor(self, meteor: float) -> None:
        """Validating the best epoch of a run whose training scored METEOR
        -999 (no scorer then) writes this score into that epoch's metrics
        file (reference :643-656)."""
        best_ep = self.exp.find_best_epoch()
        if not self.load_ep == best_ep == self.state.current_epoch:
            return
        metrics_file = self.exp.get_metrics_epoch_file(best_ep)
        if not metrics_file.is_file():
            return
        data = json.loads(metrics_file.read_text(encoding="utf8"))
        scores = dict(data[TextMetricsConst.METEOR])
        if (scores.get(best_ep, 0) + 999) ** 2 < 1e-4:
            scores[best_ep] = meteor
            data[TextMetricsConst.METEOR] = list(scores.items())
            metrics_file.write_text(json.dumps(data), encoding="utf8")
            self.logger.info(f"METEOR of epoch {best_ep} patched in "
                             f"{metrics_file}")
