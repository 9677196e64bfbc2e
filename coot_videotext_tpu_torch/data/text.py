"""
Text preprocessing pipelines for feature extraction.

Copy of coot_videotext_tpu/data/text.py (behavioral port of reference
nntrainer/data_text.py:14-130: named pipelines (bert_paper, bert_new,
gpt2, simple, nothing, with_dots) doing sentence cleanup, dot handling,
capitalization and [CLS]/[SEP] insertion), on the port's
`typext.ConstantHolder`. Golden outputs are pinned by
tests/test_utils_parity.py::test_text_preprocessing and held against the
JAX package by tests/test_torch_tools.py.

Implementation notes (differences from the reference that only show up on
pathological input): the reference's inner-sentence recapitalization scan
can run off the end of the string (IndexError) when no alphanumeric char
follows the first sentence break; this version simply leaves such a
sentence unchanged.
"""

from __future__ import annotations

import re
from functools import partial
from typing import Callable, List, Optional

from coot_videotext_tpu_torch.typext import ConstantHolder

_SPACES = re.compile(r"\s+")


class TextPreprocessing(ConstantHolder):
    """Pipeline names (reference :14)."""
    BERT_NEW = "bert_new"
    BERT_PAPER = "bert_paper"
    GPT2 = "gpt2"
    SIMPLE = "simple"
    NOTHING = "nothing"
    WITH_DOTS = "with_dots"


def get_text_preprocessor(func: str) -> Callable[[List[str]], List[str]]:
    """Pipeline factory (reference :26)."""
    presets = {
        TextPreprocessing.BERT_PAPER: dict(
            begin_paragraph_token="[CLS]", end_sentence_token="[SEP]",
            remove_ending_dot=True, replace_inside_dots=True,
            capitalize=False),
        TextPreprocessing.BERT_NEW: dict(
            begin_paragraph_token="[CLS]", end_sentence_token="[SEP]",
            remove_ending_dot=True, replace_inside_dots=True),
        TextPreprocessing.GPT2: dict(add_space_before_token=False),
        TextPreprocessing.SIMPLE: {},
        TextPreprocessing.NOTHING: dict(capitalize=False),
        TextPreprocessing.WITH_DOTS: dict(
            remove_ending_dot=True, replace_inside_dots=True,
            capitalize=False),
    }
    try:
        kwargs = presets[func]
    except KeyError:
        raise NotImplementedError(f"Text Processing '{func}' unknown")
    return partial(preprocess_paragraph, **kwargs)


def _fix_trailing_dot(sentence: str, remove: bool) -> str:
    """Either strip a single trailing '.' (keeping '..'/'...'), or make
    sure the sentence ends with one."""
    if remove:
        if sentence.endswith(".") and not sentence.endswith(".."):
            if len(sentence) > 1:
                sentence = sentence[:-1]
        return sentence
    return sentence if sentence.endswith(".") else sentence + "."


def _capitalize_second_sentence(sentence: str) -> str:
    """str.capitalize() lowercases everything past the first char, so a
    two-sentence string loses its second capital. Re-capitalize from the
    first alphanumeric char after the first '. ' break (reference :86-96,
    which only ever treats the first break)."""
    dot = sentence.find(". ")
    if dot < 0:
        return sentence
    for pos in range(dot + 1, len(sentence)):
        if sentence[pos].isalnum():
            return sentence[:pos] + sentence[pos:].capitalize()
    return sentence


def preprocess_paragraph(
        paragraph: List[str],
        begin_sentence_token: Optional[str] = None,
        end_sentence_token: Optional[str] = None,
        begin_paragraph_token: Optional[str] = None,
        end_paragraph_token: Optional[str] = None,
        add_space_before_token: bool = True,
        remove_ending_dot: bool = False,
        replace_inside_dots: bool = False,
        capitalize: bool = True) -> List[str]:
    """Preprocess a list of sentences (reference :56)."""
    # token pair spliced in at inner sentence breaks, e.g. "[EOS] [BOS]";
    # an end-only pipeline yields "END", begin-only "BEGIN"
    break_tokens = " ".join(
        tok for tok in (end_sentence_token, begin_sentence_token)
        if tok is not None) or None
    end_gap = " " if add_space_before_token else ""

    processed = []
    last = len(paragraph) - 1
    for idx, sentence in enumerate(paragraph):
        sentence = _SPACES.sub(" ", sentence).strip()
        if not sentence:
            raise ValueError(
                f"Empty sentence at position {idx} of paragraph")
        sentence = _fix_trailing_dot(sentence, remove_ending_dot)
        if capitalize:
            sentence = _capitalize_second_sentence(
                sentence.capitalize().strip())
        if replace_inside_dots and break_tokens is not None:
            kept_dot = "" if remove_ending_dot else "."
            sentence = sentence.replace(
                ". ", f"{kept_dot} {break_tokens} ")

        prefix = "".join(
            tok for tok in (
                begin_paragraph_token if idx == 0 else None,
                begin_sentence_token) if tok is not None)
        suffix = "".join(
            f"{end_gap}{tok}" for tok in (
                end_sentence_token,
                end_paragraph_token if idx == last else None)
            if tok is not None)
        words = " ".join(w for w in sentence.split(" ") if w)
        processed.append(f"{prefix} {words}{suffix}".strip())
    return processed
