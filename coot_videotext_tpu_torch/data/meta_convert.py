"""Converters from published annotation releases to this framework's
``meta_all.json`` schema (copy of coot_videotext_tpu/data/meta_convert.py).

Every dataset tool writes the same per-video record::

    {"data_key": str, "split": str, "duration_sec": float,
     "segments": [{"text": str, "start_sec": float, "stop_sec": float}]}

The functions here are pure (parsed JSON in, meta dict out) so the
format-specific quirks are unit-testable without touching the
filesystem; the port's ``data_read_*_meta`` modules are thin wrappers. Output
contract matches the reference tools (reference
data_read_youcook2_meta.py, data_read_activitynet_meta.py) so feature
extractors and datasets downstream see identical metadata.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_WHITESPACE = re.compile(r"\s+")

# the YouCook2 release labels splits differently than this framework
_YOUCOOK2_SPLITS = {"training": "train", "validation": "val"}


def _record(data_key: str, split: str, duration_sec: float,
            segments: List[dict]) -> dict:
    return {"data_key": data_key, "split": split,
            "duration_sec": duration_sec, "segments": segments}


def convert_youcook2(database: Dict[str, dict]) -> Dict[str, dict]:
    """Convert the ``database`` table of
    ``youcookii_annotations_trainval.json`` (official YouCook2 release)
    to the meta_all schema. Videos keep their release ids as keys."""
    meta: Dict[str, dict] = {}
    for vid_id, entry in database.items():
        segments = []
        for ann in entry["annotations"]:
            start, stop = (float(t) for t in ann["segment"])
            if stop <= start:
                raise ValueError(
                    f"{vid_id}: segment with non-positive duration "
                    f"({start} .. {stop})")
            segments.append({"text": ann["sentence"],
                             "start_sec": start, "stop_sec": stop})
        meta[vid_id] = _record(vid_id, _YOUCOOK2_SPLITS[entry["subset"]],
                               entry["duration"], segments)
    return meta


def convert_activitynet(splits: Dict[str, Dict[str, dict]]
                        ) -> Tuple[Dict[str, dict], List[str]]:
    """Convert ActivityNet Captions split files (``train.json``,
    ``val_1.json``, ``val_2.json`` parsed, keyed by split name).

    Release quirks handled here:
      - a handful of segments ship with start/stop inverted — they are
        swapped (returned in the second element for the CLI to report);
      - sentences contain stray newlines/tabs — collapsed to single
        spaces;
      - video ids carry a ``v_`` prefix — stripped for ``data_key``;
      - the same video can appear in several splits, so meta keys are
        ``<ytid>_<split>``.
    """
    meta: Dict[str, dict] = {}
    swapped: List[str] = []
    for split, entries in splits.items():
        for vid_id, entry in entries.items():
            if not vid_id.startswith("v_"):
                raise ValueError(f"unexpected ActivityNet id: {vid_id}")
            ytid = vid_id[len("v_"):]
            segments = []
            for (start, stop), sentence in zip(entry["timestamps"],
                                               entry["sentences"]):
                if stop < start:
                    start, stop = stop, start
                    swapped.append(f"{ytid}_{split}")
                segments.append(
                    {"text": _WHITESPACE.sub(" ", sentence),
                     "start_sec": start, "stop_sec": stop})
            meta[f"{ytid}_{split}"] = _record(
                ytid, split, entry["duration"], segments)
    return meta, swapped
