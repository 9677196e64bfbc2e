"""
Beam search (OpenNMT-py style) on the host, in numpy: DecodeStrategy
(min/max length enforcement, n-gram repeat blocking) and BeamSearch (top-k
over beam * vocab, length penalties none/wu/avg, finished-hypothesis
bookkeeping, batch shrinking).

Copy of coot_videotext_tpu/tasks/caption/beam_search.py (reference
mart/beam_search.py:37-416), kept numpy so the two packages pick the same
beams: the top-k is np.argpartition then np.argsort of the negated scores,
whose order among ties torch.topk does not keep. Only the model forward
runs on the device (tasks/caption/translator.py).
"""

from __future__ import annotations

from typing import List, Set

import numpy as np


def length_penalty_builder(length_penalty_name: str = "none"):
    """(reference :173)."""
    if length_penalty_name == "none":
        return lambda cur_len, alpha=0.0: 1.0
    if length_penalty_name == "wu":
        return lambda cur_len, alpha=0.0: ((5 + cur_len) / 6.0) ** alpha
    if length_penalty_name == "avg":
        return lambda cur_len, alpha=0.0: cur_len
    raise NotImplementedError(length_penalty_name)


class DecodeStrategy:
    """Base strategy (reference :37)."""

    def __init__(self, pad: int, bos: int, eos: int, batch_size: int,
                 parallel_paths: int, min_length: int,
                 block_ngram_repeat: int, exclusion_tokens: Set[int],
                 max_length: int) -> None:
        self.pad = pad
        self.bos = bos
        self.eos = eos
        self.predictions: List[List[np.ndarray]] = \
            [[] for _ in range(batch_size)]
        self.scores: List[List[float]] = [[] for _ in range(batch_size)]
        self.alive_seq = np.full((batch_size * parallel_paths, 1),
                                 bos, np.int64)
        self.is_finished = np.zeros((batch_size, parallel_paths), bool)
        self.min_length = min_length
        self.max_length = max_length
        self.block_ngram_repeat = block_ngram_repeat
        self.exclusion_tokens = exclusion_tokens
        self.done = False

    def __len__(self) -> int:
        return self.alive_seq.shape[1]

    def ensure_min_length(self, log_probs: np.ndarray) -> None:
        if len(self) <= self.min_length:
            log_probs[:, self.eos] = -1e20

    def ensure_max_length(self) -> None:
        if len(self) == self.max_length + 1:
            self.is_finished[:] = True

    def block_ngram_repeats(self, log_probs: np.ndarray) -> None:
        """Kill paths repeating an n-gram (reference :130)."""
        cur_len = len(self)
        if self.block_ngram_repeat <= 0 or cur_len <= 1:
            return
        for path_idx in range(self.alive_seq.shape[0]):
            hyp = self.alive_seq[path_idx, 1:]
            ngrams = set()
            fail = False
            gram: List[int] = []
            for i in range(cur_len - 1):
                gram = (gram + [int(hyp[i])])[-self.block_ngram_repeat:]
                if set(gram) & self.exclusion_tokens:
                    continue
                if tuple(gram) in ngrams:
                    fail = True
                ngrams.add(tuple(gram))
            if fail:
                log_probs[path_idx] = -10e20


class BeamSearch(DecodeStrategy):
    """Beam search with batch shrinking (reference :207)."""

    def __init__(self, beam_size: int, batch_size: int, pad: int,
                 bos: int, eos: int, n_best: int, min_length: int,
                 max_length: int, block_ngram_repeat: int,
                 exclusion_tokens: Set[int],
                 length_penalty_name: str = "none",
                 length_penalty_alpha: float = 0.0) -> None:
        super().__init__(pad, bos, eos, batch_size, beam_size, min_length,
                         block_ngram_repeat, exclusion_tokens, max_length)
        self.beam_size = beam_size
        self.n_best = n_best
        self.batch_size = batch_size
        self.length_penalty_func = length_penalty_builder(
            length_penalty_name)
        self.length_penalty_alpha = length_penalty_alpha

        self.hypotheses: List[List] = [[] for _ in range(batch_size)]
        self.top_beam_finished = np.zeros(batch_size, bool)
        self.best_scores = np.full(batch_size, -1e10, np.float32)
        self._batch_offset = np.arange(batch_size, dtype=np.int64)
        self._beam_offset = np.arange(0, batch_size * beam_size,
                                      beam_size, dtype=np.int64)
        self.topk_log_probs = np.tile(
            np.array([0.0] + [-np.inf] * (beam_size - 1), np.float32),
            batch_size)
        self.select_indices = None
        self.topk_scores = np.empty((batch_size, beam_size), np.float32)
        self.topk_ids = np.empty((batch_size, beam_size), np.int64)
        self._batch_index = np.empty((batch_size, beam_size), np.int64)

    @property
    def current_predictions(self) -> np.ndarray:
        return self.alive_seq[:, -1]

    @property
    def current_origin(self):
        return self.select_indices

    def advance(self, log_probs: np.ndarray) -> None:
        """One beam step over (alive_B * beam, vocab) log probs
        (reference :312)."""
        log_probs = np.array(log_probs, np.float32, copy=True)
        vocab_size = log_probs.shape[-1]
        _B = log_probs.shape[0] // self.beam_size

        self.ensure_min_length(log_probs)
        log_probs += self.topk_log_probs.reshape(-1, 1)
        self.block_ngram_repeats(log_probs)

        step = len(self)
        length_penalty = self.length_penalty_func(
            step + 1, self.length_penalty_alpha)
        curr_scores = (log_probs / length_penalty).reshape(
            _B, self.beam_size * vocab_size)
        # topk (descending)
        topk_idx = np.argpartition(-curr_scores, self.beam_size - 1,
                                   axis=-1)[:, :self.beam_size]
        topk_val = np.take_along_axis(curr_scores, topk_idx, axis=-1)
        order = np.argsort(-topk_val, axis=-1)
        self.topk_ids = np.take_along_axis(topk_idx, order, axis=-1)
        self.topk_scores = np.take_along_axis(topk_val, order, axis=-1)

        self.topk_log_probs = (self.topk_scores
                               * length_penalty).reshape(-1)
        self._batch_index = (self.topk_ids // vocab_size
                             + self._beam_offset[:_B, None])
        self.select_indices = self._batch_index.reshape(-1)
        self.topk_ids = self.topk_ids % vocab_size

        self.alive_seq = np.concatenate(
            [self.alive_seq[self.select_indices],
             self.topk_ids.reshape(-1, 1)], axis=-1)
        self.is_finished = self.topk_ids == self.eos
        self.ensure_max_length()

    def update_finished(self) -> "Optional[np.ndarray]":
        """Collect finished hypotheses, shrink alive batches
        (reference :366). Returns the indices of surviving batches
        (into the previous alive set), or None when done."""
        _B_old = self.topk_log_probs.shape[0] // self.beam_size
        step = self.alive_seq.shape[-1]
        self.topk_log_probs = np.where(
            self.is_finished.reshape(-1), -1e10, self.topk_log_probs)
        self.top_beam_finished |= self.is_finished[:, 0]
        predictions = self.alive_seq.reshape(_B_old, self.beam_size, step)
        non_finished_batch = []
        for i in range(self.is_finished.shape[0]):
            b = self._batch_offset[i]
            for j in np.nonzero(self.is_finished[i])[0]:
                self.hypotheses[b].append(
                    (float(self.topk_scores[i, j]),
                     predictions[i, j, 1:].copy()))
            finish_flag = bool(self.top_beam_finished[i])
            if finish_flag and len(self.hypotheses[b]) >= self.n_best:
                best_hyp = sorted(self.hypotheses[b],
                                  key=lambda x: x[0], reverse=True)
                for n, (score, pred) in enumerate(best_hyp):
                    if n >= self.n_best:
                        break
                    self.scores[b].append(score)
                    self.predictions[b].append(pred)
            else:
                non_finished_batch.append(i)
        non_finished = np.asarray(non_finished_batch, np.int64)
        if len(non_finished) == 0:
            self.done = True
            return None
        self.top_beam_finished = self.top_beam_finished[non_finished]
        self._batch_offset = self._batch_offset[non_finished]
        self.topk_log_probs = self.topk_log_probs.reshape(
            _B_old, self.beam_size)[non_finished].reshape(-1)
        self._batch_index = self._batch_index[non_finished]
        self.select_indices = self._batch_index.reshape(-1)
        self.alive_seq = predictions[non_finished].reshape(
            -1, self.alive_seq.shape[-1])
        self.topk_scores = self.topk_scores[non_finished]
        self.topk_ids = self.topk_ids[non_finished]
        return non_finished
