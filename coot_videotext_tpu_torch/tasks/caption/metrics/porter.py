"""
The Porter stemmer (Porter 1980) with nltk's extensions, the stemmer
METEOR-lite matches words with.

The JAX package uses nltk's PorterStemmer in its default NLTK_EXTENSIONS
mode; the port has no nltk, so this module implements that mode: the five
steps of the paper plus nltk's departures (a table of irregular forms,
words of up to two letters kept, `ies`/`ied` of four letters to `ie`,
`y` -> `i` only after a consonant that is not the first letter, `alli` ->
`al` repeated through step 2, `fulli` -> `ful`, `logi` -> `log`, and a
two-letter vowel-consonant word ending counting as cvc).
tests/test_torch_caption_metrics.py holds it equal to nltk's on every word
of the YouCook2 captions.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

_VOWELS = frozenset("aeiou")
_IRREGULAR = {
    "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"],
    "tie": ["tying"], "news": ["news"], "inning": ["innings", "inning"],
    "outing": ["outings", "outing"], "canning": ["cannings", "canning"],
    "howe": ["howe"], "proceed": ["proceed"], "exceed": ["exceed"],
    "succeed": ["succeed"]}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _is_consonant(word: str, i: int) -> bool:
    if word[i] in _VOWELS:
        return False
    if word[i] == "y":
        # y is a consonant after a vowel or at the start, a vowel after a
        # consonant: count the run of y's back to what precedes it
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]."""
    cv = "".join("c" if _is_consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    n = len(word)
    if (n >= 3 and _is_consonant(word, n - 3)
            and not _is_consonant(word, n - 2)
            and _is_consonant(word, n - 1) and word[-1] not in "wxy"):
        return True
    return n == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1)


def _apply_rules(word: str, rules: List[Rule]) -> str:
    """The first rule whose suffix matches decides: replaced if its
    condition holds for the stem, else the word stays."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
        elif word.endswith(suffix) and suffix != "*d":
            stem = word[:len(word) - len(suffix)]
        else:
            continue
        if condition is None or condition(stem):
            return stem + replacement
        return word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return word[:-3] + "ie"
    return _apply_rules(word, [("sses", "ss", None), ("ies", "i", None),
                               ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _contains_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    return _apply_rules(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1], lambda s: stem[-1] not in "lsz"),
        ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s))])


def _step1c(word: str) -> str:
    return _apply_rules(word, [(
        "y", "i", lambda s: len(s) > 1 and _is_consonant(s, len(s) - 1))])


_STEP2 = [(suffix, rep, _positive_measure) for suffix, rep in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
    ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ("fulli", "ful"))]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive_measure(word[:-4]):
        return _step2(word[:-4] + "al")
    return _apply_rules(word, _STEP2 + [
        ("logi", "log", lambda s: _positive_measure(word[:-3]))])


_STEP3 = [(suffix, rep, _positive_measure) for suffix, rep in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""))]


def _measure_gt_1(stem: str) -> bool:
    return _measure(stem) > 1


_STEP4 = [(suffix, "", _measure_gt_1) for suffix in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent")] + [
    ("ion", "", lambda s: _measure(s) > 1 and s[-1] in "st")] + [
    (suffix, "", _measure_gt_1) for suffix in (
        "ou", "ism", "ate", "iti", "ous", "ive", "ize")]


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1
                                  and not _ends_cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rules(word, [
        ("ll", "l", lambda s: _measure(word[:-1]) > 1)])


class PorterStemmer:
    """`stem(word)`: the word lowercased and stemmed."""

    def __init__(self) -> None:
        self.pool = {form: key for key, forms in _IRREGULAR.items()
                     for form in forms}

    def stem(self, word: str) -> str:
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            return stem
        for step in (_step1a, _step1b, _step1c, _step2, lambda w:
                     _apply_rules(w, _STEP3), lambda w:
                     _apply_rules(w, _STEP4), _step5a, _step5b):
            stem = step(stem)
        return stem
