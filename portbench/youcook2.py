"""
The YouCook2 split that the COOT cells serve, as the release states it:
every video's duration and annotated segments (seconds), and each
sentence's token count as COOT's text pipeline hands it to BERT. The
counts are taken from the release's sentences by the `bert_paper`
preprocessing (`[CLS]` before the paragraph, `[SEP]` after each sentence,
the ending dot dropped, an inner ". " made a `[SEP]`) and BERT's basic
tokenization (lower case, accents stripped, split at white space and at
each punctuation character). WordPiece's further split of words outside
BERT's vocabulary is not counted: its vocabulary is not in the repo.

    python3 -m portbench.youcook2 annotations/youcook2/youcookii_annotations_trainval.json

rewrites `splits/youcook2.json` from the release's annotation file. The
benchmark reads only that file.
"""

from __future__ import annotations

import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
SPLIT_FILE = HERE / "splits" / "youcook2.json"
SUBSETS = {"training": "train", "validation": "val"}
SPECIAL = ("[CLS]", "[SEP]")
_SPACES = re.compile(r"\s+")


def _is_punctuation(ch: str) -> bool:
    """BERT's rule: ASCII symbols count as punctuation, as does every
    Unicode P* category."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or \
            123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokens(word: str) -> int:
    """Tokens of one white-space word under BERT's uncased basic
    tokenizer."""
    if word in SPECIAL:
        return 1
    word = "".join(c for c in unicodedata.normalize("NFD", word.lower())
                   if unicodedata.category(c) != "Mn")
    count, in_word = 0, False
    for ch in word:
        if _is_punctuation(ch):
            count += 1
            in_word = False
        elif not in_word:
            count += 1
            in_word = True
    return count


def paragraph_tokens(sentences: List[str]) -> List[int]:
    """Each sentence's token count after `bert_paper` preprocessing."""
    out = []
    for idx, sentence in enumerate(sentences):
        sentence = _SPACES.sub(" ", sentence).strip()
        if sentence.endswith(".") and not sentence.endswith("..") \
                and len(sentence) > 1:
            sentence = sentence[:-1]
        sentence = sentence.replace(". ", " [SEP] ")
        text = ("[CLS] " if idx == 0 else "") + sentence + " [SEP]"
        out.append(sum(basic_tokens(w) for w in text.split(" ") if w))
    return out


def derive(database: Dict[str, dict]) -> dict:
    """{split: [[duration_s, [[start_s, stop_s, tokens], ...]], ...]} in
    the release's order."""
    out = {"train": [], "val": []}
    for entry in database.values():
        anns = entry["annotations"]
        tokens = paragraph_tokens([a["sentence"] for a in anns])
        segs = [[float(a["segment"][0]), float(a["segment"][1]), n]
                for a, n in zip(anns, tokens)]
        out[SUBSETS[entry["subset"]]].append([float(entry["duration"]),
                                              segs])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0], encoding="utf8") as fh:
        database = json.load(fh)["database"]
    split = derive(database)
    SPLIT_FILE.parent.mkdir(exist_ok=True)
    lines = ["{"]
    for i, name in enumerate(("train", "val")):
        lines.append(f' "{name}": [')
        videos = split[name]
        for j, video in enumerate(videos):
            comma = "," if j < len(videos) - 1 else ""
            lines.append("  " + json.dumps(video, separators=(",", ":"))
                         + comma)
        lines.append(" ]" + ("," if i == 0 else ""))
    lines.append("}")
    SPLIT_FILE.write_text("\n".join(lines) + "\n", encoding="utf8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
