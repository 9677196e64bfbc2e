"""
Caption inference: greedy decoding of every caption model and beam search
on the recurrent MART model.

Port of coot_videotext_tpu/tasks/caption/translator.py (reference
mart/translator.py), token for token. Greedy, recurrent
(`translate_batch_greedy`):
    - prepare_video_only_inputs blanks all text ids/masks (:424)
    - per sentence step, the token loop runs dec_idx over the text region
      starting from [BOS] at max_v_len and reads the scores at dec_idx;
      UNK is suppressed (-1e10), argmax picks the next token; after the
      sentence, tokens after the first [EOS] become [PAD] and one more
      forward builds the next sentence's memory (:231-234).
    - JAX and the reference re-run the FULL forward_step a token. Here
      the token loop runs on per-layer key / value caches
      (RecursiveTransformer.decode_prefix / decode_token): one pass over
      the video rows a sentence (the first sentence's memory built from
      them), then one new position a token: its word's embedding row,
      each layer's attention over the cached positions up to dec_idx,
      and the head on that row alone. make_shifted_mask is causal over
      the text and the memory is fixed within a sentence, so the rows
      before dec_idx do not change as tokens are added; masked columns
      add exp(-10000) = 0 in float32, so each row is the full forward's
      row. The memory forward stays one full forward over the
      EOS-masked sentence, without the head (`next_memories`). A model
      placed by parallel/tp.py keeps the full forward a token.
The JAX package's `fused=True` (the whole batch as one program) emits the
same tokens; here a sentence is one program (`Translator`). The
TransformerXL
(`translate_batch_greedy_xl`, JAX :268-337) runs the same loop with its
forward_step's signature (token types before masks) and threads the
previous sentence's masks, the EOS-masked decoded ones, beside its
memories. Single sentence, joint (`translate_batch_single_sentence_greedy`,
JAX :217-266): one full forward per token from [BOS] at max_v_len, [UNK]
suppressed; only the text region comes back. Untied
(`translate_batch_single_sentence_untied_greedy`, JAX :339-386,
reference :354; the untied model and the MTransformer): the video is
encoded once, then max_t_len decoder passes run from [BOS] over zeroed ids
and masks, each setting its position's mask and writing the next id;
[UNK] is suppressed; the whole text region comes back, with no [EOS]
masking.

Beam search (`translate_batch_beam`, JAX :388-583, reference :79-180) on
the recurrent MART model: the beam bookkeeping is the host's numpy
(beam_search.py); the rows stay at the static N * beam_size, tiled batch
major, and at each token the beam's indices gather the ids, masks,
features, token types and memories (padding rows take row 0). Each token
takes log_softmax in f32 of the row at dec_idx with [UNK] suppressed on
the token axis, read from the device once as (N * beam, vocab); rows are
reordered every step and max_len = min(max_sen_len, max_t_len - 2).
`reference_compat` reproduces the reference instead: -1e10 on the
POSITION axis at index UNK = 6 (with max_v_len 3 the readout at dec_idx 6
turns uniform), log(softmax), rows reordered only on steps where a beam
finished, max_len uncapped. After the tokens the best hypothesis goes into
the untiled ids and masks as [BOS] hyp [EOS] cut to max_t_len (an empty
hypothesis decodes to an empty sentence), the masks after [EOS] are
zeroed and the next sentence's memory is built from them.

`translate_batch` dispatches between them (JAX :585-614); beam search is
refused for a model that is not the recurrent MART one, as JAX asserts.
Under a torch profiler each of its calls is a host span
(utils/profiling.py `span`, `caption.translate_batch`) holding `prepare`
(each program's key), the graph layer's spans and `read` (the reads of
results to the host).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from coot_videotext_tpu_torch.data.caption_dataset import (
    BOS, EOS, PAD, UNK)
from coot_videotext_tpu_torch.models.caption.mart import RecursiveTransformer
from coot_videotext_tpu_torch.tasks.caption.beam_search import BeamSearch
from coot_videotext_tpu_torch.tasks.caption.model_manager import (
    CaptionModel, check_serving_config)
from coot_videotext_tpu_torch.utils.graphs import (
    Program, cache_of, signature)
from coot_videotext_tpu_torch.utils.profiling import span


def mask_tokens_after_eos(input_ids: torch.Tensor,
                          input_masks: torch.Tensor,
                          eos_token_id: int = EOS,
                          pad_token_id: int = PAD):
    """Replace values after the first [EOS] with [PAD] (reference
    translator.py:50), on (N, L) tensors."""
    is_eos = input_ids == eos_token_id
    has_eos = is_eos.any(dim=1)
    first_eos = is_eos.int().argmax(dim=1)  # 0 when none
    col = torch.arange(input_ids.shape[1], device=input_ids.device)
    after = (col[None, :] > first_eos[:, None]) & has_eos[:, None]
    input_ids = torch.where(after, torch.full_like(input_ids, pad_token_id),
                            input_ids)
    input_masks = torch.where(after, torch.zeros_like(input_masks),
                              input_masks)
    return input_ids, input_masks


def prepare_video_only_inputs(input_ids: torch.Tensor,
                              input_masks: torch.Tensor,
                              segment_ids: torch.Tensor):
    """Blank text ids and masks (reference :424), stacked (S, N, L) or
    single (N, L)."""
    text = segment_ids == 1
    return (torch.where(text, torch.full_like(input_ids, PAD), input_ids),
            torch.where(text, torch.zeros_like(input_masks), input_masks))


def _best_words(row: torch.Tensor) -> torch.Tensor:
    """argmax of the scores row (N, vocab) with [UNK] suppressed."""
    row = row.clone()
    row[:, UNK] = -1e10
    return row.argmax(dim=1)


def runs_cached(model: CaptionModel) -> bool:
    """Whether greedy decoding runs `model` on key / value caches: a
    recurrent MART model whose layers parallel/tp.py has not placed."""
    return (isinstance(model, RecursiveTransformer)
            and all(getattr(m, "tp", None) is None
                    for m in model.modules()))


class Translator:
    """Greedy and beam inference (reference Translator :67) for every
    caption model. Each decode runs as programs of the model's graph cache
    (utils/graphs.py, keyed as JAX keys its jit cache :190-206, :325, :507:
    the program, `first_step` for the recurrent ones, the input shapes and
    dtypes), CUDA graphs on the card, their bodies run eagerly on the CPU;
    `eager` runs every decode eagerly instead, op by op. Both emit the
    same tokens.

    - Recurrent greedy (MART, the TransformerXL): one program a sentence,
      the whole token loop unrolled at its positions, the [EOS] masking
      and the memory forward, replayed S times a batch with the memories
      carried between replays in its static buffers (JAX
      `_greedy_sentence_fn` :79, `_greedy_xl_fn` :268; JAX's opt-in
      `fused` program emits the same tokens and has no counterpart).
      MART's token loop runs on key / value caches (`runs_cached`): one
      new position a token. The others re-run the full forward a token:
      the XL's relative attention threads the previous sentence's masks,
      beam search reorders its rows every token, the single-sentence
      models are other models, and a model placed by parallel/tp.py
      runs its attention over the model group.
    - Single sentence, joint and untied / MTransformer: one program of
      the whole loop (JAX :217, :339), the untied encode inside it.
    - Beam: one token program a `first_step` (JAX `_beam_token_fn` :388),
      replayed once a token: it writes the host's predictions at
      `dec_idx`, both device tensors in its static buffers, and reads the
      log-probabilities out at `dec_idx`; the rows are reordered in place
      in its static buffers between replays; the memory rebuild is a
      program of its own (`_beam_memory_fn` :568).

    Every decode reads its tokens from the device once a batch (beam:
    its inputs once, one (N x beam, vocab) array a token)."""

    def __init__(self, model: CaptionModel, cfg, eager: bool = False) -> None:
        self.model = model
        self.cfg = cfg
        self.eager = eager
        # forwards run by the last decode: token steps and memory forwards
        # of the recurrent models (one a token, on the caches or full,
        # plus one a sentence), full forwards of the joint model, or
        # decoder passes (plus the one encode) of the untied ones; its
        # reads of results from the device; and its program runs (graph
        # replays on the card; 0 when eager)
        self.forwards = 0
        self.host_reads = 0
        self.replays = 0
        # token steps of the last decode that ran on key / value caches
        # (recurrent MART greedy: S x max_t_len; 0 for every other decode)
        self.cached_tokens = 0

    def _begin(self) -> None:
        self.model.eval()
        self.forwards = 0
        self.host_reads = 0
        self.replays = 0
        self.cached_tokens = 0

    def _run(self, key, body: Callable, inputs: Dict):
        """body(inputs) eagerly, or as the program of `key` of the model's
        graph cache."""
        if self.eager:
            return body(inputs)
        self.replays += 1
        cache = cache_of(self.model)
        with span("prepare"):
            key = key + (signature(inputs),)
        return cache.get(key, body, inputs)(inputs)

    def _greedy_tokens(self, scores_fn: Callable, input_ids: torch.Tensor,
                       input_masks: torch.Tensor, start: int, stop: int):
        """The token loop over positions start..stop-1 from [BOS]:
        scores_fn(ids, masks) gives the scores (N, L, vocab). Returns the
        ids and masks."""
        ids, masks = input_ids.clone(), input_masks.clone()
        next_words = torch.full_like(ids[:, 0], BOS)
        for dec_idx in range(start, stop):
            ids[:, dec_idx] = next_words
            masks[:, dec_idx] = 1
            next_words = _best_words(scores_fn(ids, masks)[:, dec_idx])
        return ids, masks

    def _read(self, out: List[torch.Tensor]) -> List[np.ndarray]:
        """Stacked (S, ...) results read from the device once."""
        out = torch.stack(out)
        with span("read"):
            out = out.cpu().numpy()
        self.host_reads += 1
        return [out[i] for i in range(len(out))]

    def _cached_tokens(self, prev, x) -> tuple:
        """The token loop of a recurrent MART sentence on the layers' key /
        value caches: one pass over the video rows, then one new position
        a token (RecursiveTransformer.decode_prefix / decode_token). The
        ids and masks, as _greedy_tokens leaves them."""
        model, lo = self.model, self.cfg.max_v_len
        ids, masks = x["ids"].clone(), x["masks"].clone()
        state = model.decode_prefix(prev, ids, x["feats"], masks,
                                    x["ttypes"])
        next_words = torch.full_like(ids[:, 0], BOS)
        for dec_idx in range(lo, lo + self.cfg.max_t_len):
            ids[:, dec_idx] = next_words
            masks[:, dec_idx] = 1
            next_words = _best_words(
                model.decode_token(state, ids[:, dec_idx], dec_idx))
        return ids, masks

    def _greedy_recurrent(self, kind: str, step: Callable, first_prev,
                          input_ids_list, video_features_list,
                          input_masks_list, token_type_ids_list,
                          cached: bool = False) -> List[np.ndarray]:
        """The recurrent greedy loop over stacked (S, N, ...) inputs:
        step(prev, ids, feats, masks, ttypes) -> (the next sentence's prev,
        scores), `first_prev` the first sentence's prev. One sentence is
        one program (`kind`, first_step). `cached`: the tokens come from
        _cached_tokens, and `step` builds only the next sentence's prev
        (its scores unused). Returns [(N, max_t_len)] * S, read once at
        the end."""
        cfg = self.cfg
        self._begin()
        lo, hi = cfg.max_v_len, cfg.max_v_len + cfg.max_t_len

        def sentence(x):
            prev = x.get("prev", first_prev)
            if cached:
                ids, masks = self._cached_tokens(prev, x)
            else:
                ids, masks = self._greedy_tokens(
                    lambda i, m: step(prev, i, x["feats"], m,
                                      x["ttypes"])[1],
                    x["ids"], x["masks"], lo, hi)
            ids, masks = mask_tokens_after_eos(ids, masks)
            prev, _ = step(prev, ids, x["feats"], masks, x["ttypes"])
            return prev, ids[:, lo:]

        with torch.inference_mode():
            ids_st, masks_st = prepare_video_only_inputs(
                input_ids_list, input_masks_list, token_type_ids_list)
            out, prev = [], None
            for idx in range(len(ids_st)):
                x = {"ids": ids_st[idx], "masks": masks_st[idx],
                     "feats": video_features_list[idx],
                     "ttypes": token_type_ids_list[idx]}
                if idx:
                    x["prev"] = prev
                prev, ids = self._run((kind, idx == 0, cached), sentence,
                                      x)
                out.append(ids.clone())  # the next run overwrites it
                self.forwards += hi - lo + 1
                self.cached_tokens += (hi - lo) * cached
            return self._read(out)

    def translate_batch_greedy(self, input_ids_list: torch.Tensor,
                               video_features_list: torch.Tensor,
                               input_masks_list: torch.Tensor,
                               token_type_ids_list: torch.Tensor
                               ) -> List[np.ndarray]:
        """Recurrent greedy (reference :201). Inputs stacked (S, N, ...)
        on the model's device. Returns [(N, max_t_len)] * S decoded text
        ids, read from the device once at the end."""
        model = self.model
        cached = runs_cached(model)

        def step(ms, ids, feats, masks, ttypes):
            if cached:
                return model.next_memories(ms, ids, feats, masks,
                                           ttypes), None
            ms, _, scores = model.forward_step(ms, ids, feats, masks, ttypes)
            return ms, scores
        return self._greedy_recurrent(
            "greedy", step, [None] * self.cfg.num_hidden_layers,
            input_ids_list, video_features_list, input_masks_list,
            token_type_ids_list, cached=cached)

    def translate_batch_greedy_xl(self, input_ids_list: torch.Tensor,
                                  video_features_list: torch.Tensor,
                                  input_masks_list: torch.Tensor,
                                  token_type_ids_list: torch.Tensor
                                  ) -> List[np.ndarray]:
        """TransformerXL greedy (JAX :268, reference
        translate_batch_greedy_xl :261): the recurrent loop with the
        previous sentence's EOS-masked masks threaded beside its
        memories."""
        model = self.model

        def step(prev, ids, feats, masks, ttypes):
            ms, _, scores = model.forward_step(prev[0], ids, feats, ttypes,
                                               masks, prev[1])
            return (ms, masks), scores
        return self._greedy_recurrent(
            "greedy_xl", step, (None, None), input_ids_list,
            video_features_list, input_masks_list, token_type_ids_list)

    def translate_batch_single_sentence_greedy(
            self, input_ids: torch.Tensor, video_features: torch.Tensor,
            input_masks: torch.Tensor, token_type_ids: torch.Tensor
    ) -> np.ndarray:
        """Joint single-sentence greedy (JAX :246) on (N, L) tensors on
        the model's device: the (N, max_t_len) text region, [BOS] first
        (JAX :261-264: returning the joint sequence leaked the video
        tokens into every caption)."""
        cfg, model = self.cfg, self.model
        self._begin()
        lo = cfg.max_v_len

        def decode(x):
            ids, _ = self._greedy_tokens(
                lambda i, m: model(i, x["feats"], m, x["ttypes"])[1],
                x["ids"], x["masks"], lo, lo + cfg.max_t_len)
            return ids[:, lo:]

        with torch.inference_mode():
            ids, masks = prepare_video_only_inputs(input_ids, input_masks,
                                                   token_type_ids)
            ids = self._run(("greedy_single",), decode, {
                "ids": ids, "masks": masks, "feats": video_features,
                "ttypes": token_type_ids})
            self.forwards = cfg.max_t_len
            return self._read([ids])[0]

    def translate_batch_single_sentence_untied_greedy(
            self, video_features: torch.Tensor, video_masks: torch.Tensor,
            text_ids: torch.Tensor, text_masks: torch.Tensor) -> np.ndarray:
        """Untied / masked-transformer greedy (reference :354) on (N, ...)
        tensors on the model's device: the (N, max_t_len) ids, [BOS]
        first, read from the device once at the end."""
        model = self.model
        self._begin()

        def decode(x):
            encodings = model.encode(x["feats"], x["vmasks"])
            ids, _ = self._greedy_tokens(
                lambda i, m: model.decode(i, m, None, encodings,
                                          x["vmasks"])[1],
                torch.zeros_like(x["ids"]), torch.zeros_like(x["masks"]),
                0, self.cfg.max_t_len)
            return ids

        with torch.inference_mode():
            ids = self._run(("greedy_untied",), decode, {
                "feats": video_features, "vmasks": video_masks,
                "ids": text_ids, "masks": text_masks})
            self.forwards = 1 + self.cfg.max_t_len
            return self._read([ids])[0]

    # ---------- beam (recurrent) ----------

    def _beam_logprobs(self, ms, ids, feats, masks, ttypes,
                       dec_idx: torch.Tensor, reference_compat: bool
                       ) -> torch.Tensor:
        """The (rows, vocab) f32 log-probabilities at dec_idx, a (1,) int64
        tensor on the model's device as JAX traces it (`_beam_token_fn`
        :388)."""
        _, _, scores = self.model.forward_step(ms, ids, feats, masks,
                                               ttypes)
        row = scores.index_select(1, dec_idx)[:, 0].float()
        if reference_compat:
            # the reference's `pred_scores[:, UNK] = -1e10`
            # (translator.py:133) writes POSITION UNK (= 6) across the
            # vocabulary: [UNK] is not suppressed, and the readout at
            # dec_idx == 6 is all -1e10 (uniform); then log(softmax)
            row = torch.where(dec_idx == UNK, torch.full_like(row, -1e10),
                              row)
            return torch.log(torch.softmax(row, dim=-1))
        row = row.clone()
        row[:, UNK] = -1e10  # the token axis, as the greedy paths do
        return torch.log_softmax(row, dim=-1)

    def _beam_memory(self, x) -> tuple:
        """The next sentence's memories from the best hypotheses (JAX
        `_beam_memory_fn` :568): (memories, the EOS-masked text ids)."""
        ids, masks = mask_tokens_after_eos(x["ids"], x["masks"])
        ms = x.get("ms", [None] * self.cfg.num_hidden_layers)
        ms, _, _ = self.model.forward_step(ms, ids, x["feats"], masks,
                                           x["ttypes"])
        return ms, ids[:, self.cfg.max_v_len:]

    def translate_batch_beam(self, input_ids_list: torch.Tensor,
                             video_features_list: torch.Tensor,
                             input_masks_list: torch.Tensor,
                             token_type_ids_list: torch.Tensor,
                             reference_compat: bool = False
                             ) -> List[np.ndarray]:
        """Recurrent beam search (reference :79-180). Inputs stacked (S, N,
        ...) on the model's device; returns [(N, max_t_len)] * S decoded
        text ids."""
        cfg = self.cfg
        self._begin()
        beam_size = cfg.beam_size
        lo = cfg.max_v_len
        # cap max_length to the decodable text region (JAX :486-497):
        # beams that never emit [EOS] would otherwise never finish
        max_len = (cfg.max_sen_len if reference_compat
                   else min(cfg.max_sen_len, cfg.max_t_len - 2))
        with torch.inference_mode():
            ids_st, masks_st = prepare_video_only_inputs(
                input_ids_list, input_masks_list, token_type_ids_list)
            with span("read"):
                host_ids = ids_st.cpu().numpy()
                host_masks = masks_st.cpu().numpy()
            self.host_reads += 2
            device = ids_st.device
            batch_size = ids_st.shape[1]
            total_rows = batch_size * beam_size
            # the host's predictions and row orders go to the device
            # through pinned buffers; every token's read of the
            # log-probabilities waits for their copies before the host
            # writes them again
            pin = device.type == "cuda"
            preds_host = torch.zeros(total_rows, dtype=torch.int64,
                                     pin_memory=pin)
            perm_host = torch.zeros(total_rows, dtype=torch.int64,
                                    pin_memory=pin)
            positions = torch.arange(lo, lo + cfg.max_t_len, device=device)
            out = []
            prev_ms = None
            for idx in range(len(ids_st)):
                init_ids = host_ids[idx].copy()
                init_masks = host_masks[idx].copy()
                init_feats = video_features_list[idx]
                init_ttypes = token_type_ids_list[idx]
                # tile x beam, batch-major blocks (reference tile :33)
                rows = {k: v.repeat_interleave(beam_size, dim=0)
                        for k, v in (("ids", ids_st[idx]),
                                     ("masks", masks_st[idx]),
                                     ("feats", init_feats),
                                     ("ttypes", init_ttypes))}
                if idx:
                    rows["ms"] = [m.repeat_interleave(beam_size, dim=0)
                                  for m in prev_ms]
                token = self._beam_token(idx == 0, reference_compat, rows,
                                         positions[:1], preds_host)
                beam = BeamSearch(
                    beam_size, batch_size, PAD, BOS, EOS, cfg.n_best,
                    cfg.min_sen_len, max_len, cfg.block_ngram_repeat,
                    exclusion_tokens=set(),
                    length_penalty_name=cfg.length_penalty_name,
                    length_penalty_alpha=cfg.length_penalty_alpha)
                n_alive = total_rows
                for dec_idx in range(lo, lo + cfg.max_t_len):
                    preds = preds_host.numpy()
                    preds[:] = 0
                    preds[:n_alive] = beam.current_predictions
                    token.load({"dec_idx": positions[dec_idx - lo:][:1],
                                "preds": preds_host})
                    if self.eager:
                        lp = token.body(token.inputs)
                    else:
                        lp = token()
                        self.replays += 1
                    with span("read"):
                        lp = lp.cpu().numpy()[:n_alive]
                    self.forwards += 1
                    self.host_reads += 1
                    beam.advance(lp)
                    if beam.is_finished.any():
                        beam.update_finished()
                        if beam.done:
                            break
                        sel = beam.select_indices
                    elif reference_compat:
                        # the reference reorders the rows only on steps
                        # where some beam finished (:146-160)
                        continue
                    else:
                        sel = beam.current_origin
                    perm = perm_host.numpy()
                    perm[:] = 0
                    perm[:len(sel)] = sel
                    n_alive = len(sel)
                    perm = perm_host.to(device, non_blocking=True)
                    for name, value in token.inputs.items():
                        if name in ("dec_idx", "preds"):
                            continue
                        for buf in (value if name == "ms" else [value]):
                            buf.copy_(buf.index_select(0, perm))

                # the top hypotheses into the untiled inputs (reference
                # :163-180)
                for b in range(batch_size):
                    hyp = (beam.predictions[b][0] if beam.predictions[b]
                           else np.asarray([], np.int64))
                    sen_ids = ([BOS] + [int(t) for t in hyp]
                               + [EOS])[:cfg.max_t_len]
                    init_ids[b, lo:lo + len(sen_ids)] = sen_ids
                    init_masks[b, lo:lo + len(sen_ids)] = 1
                x = {"ids": torch.from_numpy(init_ids).to(device),
                     "masks": torch.from_numpy(init_masks).to(device),
                     "feats": init_feats, "ttypes": init_ttypes}
                if idx:
                    x["ms"] = prev_ms
                prev_ms, dec_ids = self._run(("beam_memory", idx == 0),
                                             self._beam_memory, x)
                self.forwards += 1
                # the token program's runs would overwrite them
                prev_ms = [m.clone() for m in prev_ms]
                out.append(dec_ids.clone())
            return self._read(out)

    def _beam_token(self, first: bool, reference_compat: bool,
                    rows: Dict, dec_idx: torch.Tensor,
                    preds: torch.Tensor) -> Program:
        """The token step of one sentence over its tiled `rows` (ids,
        masks, feats, ttypes and, after the first sentence, the memories
        "ms"), with `dec_idx` and the predictions as inputs too: the
        program of (first_step, reference_compat) with `rows` loaded into
        its static buffers, or, eagerly, a program of its own whose body
        the caller runs op by op. The rows are reordered in place in its
        `inputs`."""
        def body(x):
            x["ids"].index_copy_(1, x["dec_idx"],
                                 x["preds"][:, None].to(x["ids"].dtype))
            x["masks"].index_fill_(1, x["dec_idx"], 1)
            return self._beam_logprobs(
                x.get("ms", [None] * self.cfg.num_hidden_layers), x["ids"],
                x["feats"], x["masks"], x["ttypes"], x["dec_idx"],
                reference_compat)

        inputs = {**rows, "dec_idx": dec_idx,
                  "preds": preds.to(dec_idx.device)}
        if self.eager:
            return Program(body, inputs)
        program = cache_of(self.model).get(
            ("beam_token", first, reference_compat, signature(inputs)),
            body, inputs)
        program.load(rows)
        return program


    # ---------- dispatch ----------

    def translate_batch(self, batch: Dict[str, torch.Tensor]):
        """The decode of a collated batch on the model's device that the
        config selects (JAX :585): recurrent (MART greedy or beam,
        TransformerXL greedy), [(N, max_t_len)] * S; single sentence
        (untied, MTransformer or joint), (N, max_t_len)."""
        cfg = self.cfg
        check_serving_config(cfg)
        with span("caption.translate_batch"):
            if cfg.recurrent:
                args = (batch["input_ids"], batch["video_feature"],
                        batch["input_mask"], batch["token_type_ids"])
                if cfg.use_beam:
                    return self.translate_batch_beam(
                        *args, reference_compat=cfg.beam_reference_compat)
                if cfg.xl:
                    return self.translate_batch_greedy_xl(*args)
                return self.translate_batch_greedy(*args)
            if cfg.untied or cfg.mtrans:
                return self.translate_batch_single_sentence_untied_greedy(
                    batch["video_feature"], batch["video_mask"],
                    batch["text_ids"], batch["text_mask"])
            return self.translate_batch_single_sentence_greedy(
                batch["input_ids"], batch["video_feature"],
                batch["input_mask"], batch["token_type_ids"])

    @classmethod
    def sort_res(cls, res_dict: Dict[str, list]) -> Dict[str, list]:
        """Sort output sentences by timestamp (reference :450)."""
        return {k: sorted(v, key=lambda x: float(x["timestamp"][0]))
                for k, v in res_dict.items()}
