"""The YouCook2 split the COOT cells serve: its file is the release's
annotations as `youcook2.py` derives them, and its segments map to frames
as the COOT dataset maps them."""

import json

import pytest

from portbench import data, run, youcook2

RELEASE = run.ROOT / "annotations" / "youcook2" / \
    "youcookii_annotations_trainval.json"


def test_the_split_file_is_derived_from_the_release():
    if not RELEASE.is_file():
        pytest.skip("the release's annotation file is not in this checkout")
    with open(RELEASE, encoding="utf8") as fh:
        derived = youcook2.derive(json.load(fh)["database"])
    with open(youcook2.SPLIT_FILE, encoding="utf8") as fh:
        assert derived == json.load(fh)
    assert (len(derived["train"]), len(derived["val"])) == (1333, 457)


@pytest.mark.parametrize("sentences,counts", [
    (["Spread margarine on two slices of white bread."], [10]),
    (["add salt, pepper", "mix well. serve hot"], [6, 6]),
    (["cut the  jalapeños"], [5]),
])
def test_token_counts_by_hand(sentences, counts):
    """[CLS] before the paragraph, [SEP] after each sentence and at an
    inner ". ", punctuation split off, the ending dot dropped."""
    assert youcook2.paragraph_tokens(sentences) == counts


def test_segments_map_to_frames_as_the_dataset_maps_them():
    meta = data.split_meta({"name": "youcook2", "feature_rows_per_s": 1.0,
                            "max_videos": 1}, "train", 2)
    with open(youcook2.SPLIT_FILE, encoding="utf8") as fh:
        duration, segments = json.load(fh)["train"][0]
    nf = int(duration)
    assert meta[0]["nf"] == nf
    fps = nf / duration
    for (first, n), (t0, t1, tokens) in zip(meta[0]["segs"], segments):
        assert first == int(fps * t0 // 1)
        assert first + n == min(-int(-fps * t1 // 1) + 2, nf)
    assert meta[0]["splits"] == [t for _, _, t in segments]
