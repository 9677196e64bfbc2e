"""
MART captioning dataset: annotation jsons -> joint video+text sequences ->
stacked recurrent-step batches, or single sentences in the untied or the
joint layout.

Port of coot_videotext_tpu/data/caption_dataset.py (reference
mart/recursive_caption_dataset.py:46-766):
    - special tokens PAD..UNK ids 0..6, IGNORE=-1 (:47-61)
    - video input either COOT embeddings (vid/ctx/clip lookup via the
      clip_num cumsum, :296-345) packed by coot_mode (`_get_vt_features`,
      :493), or raw MART rgb+flow features (`coot_model_name: null`):
      `<name>_resnet.npy` and `<name>_bn.npy` concatenated on the feature
      axis (:278), indexed by the frame<->second table of
      captioning_video_feat_duration.csv (:209-226); videos whose files are
      missing are dropped (:227-248); a clip longer than the video budget
      is subsampled at numpy linspace positions, a shorter one zero-padded
      (:529-570)
    - joint sequence [CLS] [VID]*v [SEP] [PAD]* + [BOS] w... [EOS] [PAD]*
      with mask 1=valid and shifted input_labels (IGNORE on video/pad
      positions) (:392-426, :529-605)
    - the untied layout (`recurrent: false` with `untied` or `mtrans`):
      one example per sentence, the video part without [CLS]/[SEP] and the
      text part apart, with shifted text_labels (:140-154, :428, :572);
      the joint single-sentence layout (`recurrent: false` alone, the
      NonRecurTransformer's): one joint sequence per sentence (:379-408)
    - Treebank word tokenization, lowercased, truncated to max_t_len-2
      (:607)
    - the recurrent collation stacks steps into (S, N, L[, D]) arrays and
      pads every video to the padded step count with IGNORE-labelled dummy
      steps (:646-695); the single-sentence collation stacks (N, ...)
      arrays, a short batch padded to N with IGNORE-labelled dummy rows

The embedding file is `{coot_model_name}_{mode}.h5` (the JAX trainer's
export; h5py is imported only to read it) or `{coot_model_name}_{mode}.npz`
with the same arrays (`key`, `clip_num`, `vid_emb`, `vid_context`,
`clip_emb`: what the port's retrieval export writes). The tokenizer is a
copy of the Treebank word tokenizer's rules, the tokenizer the JAX package
falls back to without punkt data, so nltk is not needed.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    COUNT_LADDER, bucket_size)
from coot_videotext_tpu_torch.parallel.mesh import Mesh, batch_rows

# special tokens (reference :47-61)
PAD_TOKEN = "[PAD]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
VID_TOKEN = "[VID]"
BOS_TOKEN = "[BOS]"
EOS_TOKEN = "[EOS]"
UNK_TOKEN = "[UNK]"
PAD, CLS, SEP, VID, BOS, EOS, UNK = range(7)
IGNORE = -1

# ---------- Treebank word tokenizer (the Penn Treebank rules) ----------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # the final period, before closing brackets and quotes
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# contractions split in two (Robert MacIntyre's list)
_CONTRACTIONS = [re.compile(p) for p in (
    r"(?i)\b(can)(not)\b", r"(?i)\b(d)('ye)\b", r"(?i)\b(gim)(me)\b",
    r"(?i)\b(gon)(na)\b", r"(?i)\b(got)(ta)\b", r"(?i)\b(lem)(me)\b",
    r"(?i)\b(more)('n)\b", r"(?i)\b(wan)(na)(?=\s)",
    r"(?i) ('t)(is)\b", r"(?i) ('t)(was)\b")]


def word_tokenize(sentence: str) -> List[str]:
    """Penn Treebank word tokenization of one sentence: contractions
    split (`don't` -> `do n't`), punctuation split off, a final period
    split off."""
    text = sentence
    for regexp, sub in _STARTING_QUOTES + _PUNCTUATION:
        text = regexp.sub(sub, text)
    for regexp, sub in (_PARENS_BRACKETS, _DOUBLE_DASHES):
        text = regexp.sub(sub, text)
    text = f" {text} "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def load_coot_embeddings(path_stem: Path) -> Dict[str, np.ndarray]:
    """The COOT-embedding export `<stem>.h5` or `<stem>.npz` as arrays;
    `key` comes back as a list of str."""
    h5_file = path_stem.with_suffix(".h5")
    npz_file = path_stem.with_suffix(".npz")
    names = ("key", "clip_num", "vid_emb", "vid_context", "clip_emb")
    if h5_file.is_file():
        import h5py
        with h5py.File(h5_file, "r") as h5:
            arrays = {name: np.asarray(h5[name]) for name in names}
    elif npz_file.is_file():
        with np.load(npz_file, allow_pickle=False) as npz:
            arrays = {name: np.asarray(npz[name]) for name in names}
    else:
        raise FileNotFoundError(
            f"Coot embeddings file not found: {h5_file} (or {npz_file})")
    arrays["key"] = [k.decode("utf8") if isinstance(k, bytes) else str(k)
                     for k in arrays["key"]]
    return arrays


class DataTypesConstCaption:
    COOT_EMB = "coot_emb"
    VIDEO_FEAT = "video_feat"


# seconds a raw-feature row covers at the reference's sampling (:211)
SAMPLING_SEC = 0.5


def frame_to_second_table(duration_file: Path, dset_name: str
                          ) -> Dict[str, float]:
    """{video name: seconds per feature row} from the duration CSV (lines
    `name,duration_sec,num_frames`, reference :209-226): YouCook2 rounds
    frames per row up, ActivityNet down, and ActivityNet's `_0CqozZun3U`
    is pinned to SAMPLING_SEC."""
    table = {}
    for line in duration_file.read_text().splitlines():
        vid_name, vid_dur, vid_frame = [e.strip() for e in line.split(",")]
        if dset_name == "activitynet":
            table[vid_name] = (
                float(vid_dur) * int(float(vid_frame) / int(float(vid_dur))
                                     * SAMPLING_SEC) / float(vid_frame))
        else:  # youcook2
            table[vid_name] = (
                float(vid_dur) * math.ceil(float(vid_frame) / float(vid_dur)
                                           * SAMPLING_SEC)
                / float(vid_frame))
    if dset_name == "activitynet":
        table["_0CqozZun3U"] = SAMPLING_SEC
    return table


class RecursiveCaptionDataset:
    """Captioning dataset (reference RecursiveCaptionDataset :46)."""

    def __init__(self, dset_name: str, max_t_len: int, max_v_len: int,
                 max_n_sen: int, mode: str = "train", *,
                 recurrent: bool = True, untied: bool = False,
                 video_feature_dir: Optional[str] = None,
                 coot_model_name: Optional[str] = None,
                 coot_mode: str = "vidclip", coot_dim_vid: int = 768,
                 coot_dim_clip: int = 384,
                 annotations_dir: str = "annotations",
                 coot_feat_dir: str = "provided_embeddings",
                 dataset_max: Optional[int] = None,
                 preload: bool = False) -> None:
        assert not (recurrent and untied)
        self.dset_name = dset_name
        self.annotations_dir = Path(annotations_dir)
        self.coot_model_name = coot_model_name
        self.coot_mode = coot_mode
        self.coot_dim_vid = coot_dim_vid
        self.coot_dim_clip = coot_dim_clip
        self.coot_feat_dir = Path(coot_feat_dir)
        self.video_feature_dir = (Path(video_feature_dir) / dset_name
                                  if video_feature_dir else None)
        self.word2idx_file = (self.annotations_dir / dset_name /
                              "mart_word2idx.json")
        self.word2idx: Dict[str, int] = json.loads(
            self.word2idx_file.read_text(encoding="utf8"))
        self.idx2word = {int(v): k for k, v in self.word2idx.items()}

        self.max_seq_len = max_v_len + max_t_len
        self.max_v_len = max_v_len
        self.max_t_len = max_t_len
        self.max_n_sen = max_n_sen
        self.mode = mode
        self.recurrent = recurrent
        self.untied = untied

        # metadata file per dataset/mode (reference :110-127)
        ann = self.annotations_dir / dset_name
        if dset_name == "activitynet":
            data_path = {"train": ann / "train.json",
                         "val": ann / "captioning_val_1.json",
                         "test": ann / "captioning_test_1.json"}[mode]
        elif dset_name == "youcook2":
            data_path = {"train": ann / "captioning_train.json",
                         "val": ann / "captioning_val.json"}[mode]
        else:
            raise ValueError(f"Unknown dataset {dset_name}")

        raw_data = json.loads(data_path.read_text(encoding="utf8"))
        coll_data = []
        for i, (k, line) in enumerate(raw_data.items()):
            if dataset_max is not None and 0 < dataset_max <= i:
                break
            line = dict(line)
            line["name"] = k
            line["timestamps"] = line["timestamps"][:max_n_sen]
            line["sentences"] = line["sentences"][:max_n_sen]
            coll_data.append(line)

        if recurrent:
            self.data = coll_data
        else:  # one example per sentence (reference :140-154)
            self.data = [{
                "duration": d["duration"], "name": d["name"],
                "timestamp": d["timestamps"][idx],
                "sentence": d["sentences"][idx], "idx": idx,
            } for d in coll_data
                for idx in range(min(max_n_sen, len(d["sentences"])))]

        if coot_model_name is not None:
            self.data_type = DataTypesConstCaption.COOT_EMB
            self.frame_to_second = None
            self._open_coot_embeddings(coot_model_name)
        else:
            self.data_type = DataTypesConstCaption.VIDEO_FEAT
            self.frame_to_second = frame_to_second_table(
                ann / "captioning_video_feat_duration.csv", dset_name)
            self._drop_missing_videos()

        # the config's `preload`: raw features read once and kept (the
        # COOT embeddings are held in memory either way)
        self.preloaded_videos: Dict[str, np.ndarray] = {}
        if preload and self.data_type == DataTypesConstCaption.VIDEO_FEAT:
            for meta in self.data:
                if meta["name"] not in self.preloaded_videos:
                    self.preloaded_videos[meta["name"]] = \
                        self._load_mart_video_feature(meta["name"])

    def _open_coot_embeddings(self, coot_model_name: str) -> None:
        """The split's COOT embeddings, held in memory (a split's are a
        few MB)."""
        coot_dataset_mode = "val" if self.mode == "test" else self.mode
        emb = load_coot_embeddings(
            self.coot_feat_dir / f"{coot_model_name}_{coot_dataset_mode}")
        self.coot_vid_emb = emb["vid_emb"]
        self.coot_vid_context = emb["vid_context"]
        self.coot_clip_emb = emb["clip_emb"]
        self.coot_clip_nums = np.asarray(emb["clip_num"])
        self.coot_vid_id_to_vid_number = {
            v: i for i, v in enumerate(emb["key"])}
        self.coot_clip_start = np.concatenate(
            [[0], np.cumsum(self.coot_clip_nums)]).astype(np.int64)

    def _feature_name(self, raw_name: str) -> str:
        """The raw-feature file stem of a video: ActivityNet's names lose
        their `v_` prefix."""
        return raw_name[2:] if self.dset_name == "activitynet" else raw_name

    def _drop_missing_videos(self) -> None:
        """Drop the videos whose `_bn` or `_resnet` file is missing
        (reference :227-248)."""
        self.missing_video_names = []
        for e in self.data:
            video_name = self._feature_name(e["name"])
            for suffix in ("bn", "resnet"):
                if not (self.video_feature_dir /
                        f"{video_name}_{suffix}.npy").exists():
                    self.missing_video_names.append(video_name)
        missing = set(self.missing_video_names)
        self.data = [e for e in self.data
                     if self._feature_name(e["name"]) not in missing]
        assert self.data, "No data found; check video feature dir."

    def __len__(self) -> int:
        return len(self.data)

    # ---------- feature loading ----------

    def _load_mart_video_feature(self, raw_name: str) -> np.ndarray:
        """rgb+flow: resnet and bn rows concatenated (reference :278)."""
        if raw_name in self.preloaded_videos:
            return self.preloaded_videos[raw_name]
        video_name = self._feature_name(raw_name)
        resnet = np.load(self.video_feature_dir / f"{video_name}_resnet.npy")
        bn = np.load(self.video_feature_dir / f"{video_name}_bn.npy")
        return np.concatenate([resnet, bn], axis=1)

    def _load_coot_video_feature(self, raw_name: str
                                 ) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """COOT embedding lookup (reference :296): the video's vector, its
        context vector and its clips' vectors."""
        try:
            vid_num = self.coot_vid_id_to_vid_number[raw_name]
        except KeyError:
            mode = "val_1" if self.mode == "val" else self.mode
            vid_num = self.coot_vid_id_to_vid_number[
                f"{raw_name[2:]}_{mode}"]
        start = self.coot_clip_start[vid_num]
        num_clips = int(self.coot_clip_nums[vid_num])
        return (np.asarray(self.coot_vid_emb[vid_num]),
                np.asarray(self.coot_vid_context[vid_num]),
                np.asarray(self.coot_clip_emb[start:start + num_clips]))

    def _load_video_feature(self, raw_name: str):
        if self.data_type == DataTypesConstCaption.VIDEO_FEAT:
            return self._load_mart_video_feature(raw_name)
        return self._load_coot_video_feature(raw_name)

    # ---------- sequence building ----------

    @staticmethod
    def _convert_to_feat_index_st_ed(feat_len: int, timestamp,
                                     frm2sec: float) -> Tuple[int, int]:
        """Wall time -> feature row range [st, ed] (reference :480)."""
        st = int(math.floor(timestamp[0] / frm2sec))
        ed = int(math.ceil(timestamp[1] / frm2sec))
        ed = min(ed, feat_len - 1)
        st = min(st, ed - 1)
        assert st <= ed <= feat_len
        return st, ed

    def _raw_rows(self, raw_feat: np.ndarray, timestamp, frm2sec: float,
                  max_v_l: int) -> Tuple[np.ndarray, int]:
        """(rows, valid count) of a clip: its feature rows, subsampled to
        max_v_l at numpy linspace positions when longer (torch.linspace
        rounds differently)."""
        st, ed = self._convert_to_feat_index_st_ed(len(raw_feat), timestamp,
                                                   frm2sec)
        if ed - st + 1 > max_v_l:
            idx = np.linspace(st, ed, max_v_l, endpoint=True).astype(
                np.int64).tolist()
            assert max(idx) < len(raw_feat)
            return raw_feat[idx], max_v_l
        return raw_feat[st:ed + 1], ed - st + 1

    def _get_vt_features(self, video_feat_tuple, clip_idx: int,
                         max_v_l: int) -> Tuple[np.ndarray, int]:
        """Pack COOT vectors by coot_mode (reference :493) into row 0 of
        max_v_l rows. The reference asserts valid_l == max_v_l (:539),
        which holds only in the joint layout (max_v_l = max_v_len - 2 = 1);
        the untied layout (max_v_l = max_v_len) keeps the other rows zero
        and masked, as the JAX package does."""
        vid_feat, vid_ctx_feat, clip_feats = video_feat_tuple
        clip_feat = clip_feats[clip_idx]
        dv, dc = self.coot_dim_vid, self.coot_dim_clip
        if self.coot_mode == "clip":
            feat = np.zeros((max_v_l, dc))
            feat[0] = clip_feat
        elif self.coot_mode == "vidclip":
            feat = np.zeros((max_v_l, dv + dc))
            feat[0, :dv] = vid_feat
            feat[0, dv:dv + dc] = clip_feat
        elif self.coot_mode == "vidclipctx":
            feat = np.zeros((max_v_l, dv + dc * 2))
            feat[0, :dv] = vid_feat
            feat[0, dv:dv + dc] = vid_ctx_feat
            feat[0, dv + dc:dv + dc * 2] = clip_feat
        elif self.coot_mode == "vid":
            feat = np.zeros((max_v_l, dv))
            feat[0] = vid_feat
        else:
            raise NotImplementedError(
                f"Unknown: opt.vtmode = {self.coot_mode}")
        return feat, 1

    def _load_indexed_video_feature(self, raw_feat, timestamp, frm2sec,
                                    clip_idx: int):
        """Joint-sequence video part (reference :529)."""
        max_v_l = self.max_v_len - 2
        if self.data_type == DataTypesConstCaption.COOT_EMB:
            rows, valid_l = self._get_vt_features(raw_feat, clip_idx,
                                                  max_v_l)
        else:
            rows, valid_l = self._raw_rows(raw_feat, timestamp, frm2sec,
                                           max_v_l)
        video_tokens = ([CLS_TOKEN] + [VID_TOKEN] * valid_l + [SEP_TOKEN]
                        + [PAD_TOKEN] * (max_v_l - valid_l))
        mask = [1] * (valid_l + 2) + [0] * (max_v_l - valid_l)
        feat = np.zeros((self.max_seq_len, rows.shape[1]))
        feat[1:len(rows) + 1] = rows
        return feat, video_tokens, mask

    def _load_indexed_video_feature_untied(self, raw_feat, timestamp,
                                           frm2sec, clip_idx: int):
        """Untied video part, no [CLS]/[SEP] (reference :572): (max_v_len
        rows, their mask)."""
        max_v_l = self.max_v_len
        if self.data_type == DataTypesConstCaption.COOT_EMB:
            feat, valid_l = self._get_vt_features(raw_feat, clip_idx,
                                                  max_v_l)
        else:
            rows, valid_l = self._raw_rows(raw_feat, timestamp, frm2sec,
                                           max_v_l)
            feat = np.zeros((max_v_l, rows.shape[1]))
            feat[:valid_l] = rows
        return feat, [1] * valid_l + [0] * (max_v_l - valid_l)

    def _tokenize_pad_sentence(self, sentence: str):
        """[BOS] w.. [EOS] [PAD]* (reference :607)."""
        max_t_len = self.max_t_len
        tokens = word_tokenize(sentence.lower())[:max_t_len - 2]
        tokens = [BOS_TOKEN] + tokens + [EOS_TOKEN]
        valid_l = len(tokens)
        mask = [1] * valid_l + [0] * (max_t_len - valid_l)
        tokens += [PAD_TOKEN] * (max_t_len - valid_l)
        return tokens, mask

    def _frm2sec(self, name: str) -> Optional[float]:
        if self.data_type == DataTypesConstCaption.COOT_EMB:
            return None
        return self.frame_to_second[self._feature_name(name)]

    def clip_sentence_to_feature(self, name, timestamp, sentence,
                                 video_feature, clip_idx: int):
        """One joint clip-sentence example (reference :392)."""
        feat, video_tokens, video_mask = self._load_indexed_video_feature(
            video_feature, timestamp, self._frm2sec(name), clip_idx)
        text_tokens, text_mask = self._tokenize_pad_sentence(sentence)
        input_tokens = video_tokens + text_tokens
        input_ids = [self.word2idx.get(t, self.word2idx[UNK_TOKEN])
                     for t in input_tokens]
        # labels shifted right; IGNORE on video+pad (reference :412-415)
        input_labels = (
            [IGNORE] * len(video_tokens)
            + [IGNORE if m == 0 else tid for tid, m in
               zip(input_ids[-len(text_mask):], text_mask)][1:]
            + [IGNORE])
        data = dict(
            name=name, input_tokens=input_tokens,
            input_ids=np.asarray(input_ids, np.int64),
            input_labels=np.asarray(input_labels, np.int64),
            input_mask=np.asarray(video_mask + text_mask, np.float32),
            token_type_ids=np.asarray(
                [0] * self.max_v_len + [1] * self.max_t_len, np.int64),
            video_feature=feat.astype(np.float32))
        meta = dict(name=name, timestamp=timestamp, sentence=sentence)
        return data, meta

    def clip_sentence_to_feature_untied(self, name, timestamp, sentence,
                                        raw_video_feature, clip_idx: int):
        """One untied example (reference :428): the video rows and mask,
        the text ids and mask, the text labels shifted by one."""
        video_feature, video_mask = \
            self._load_indexed_video_feature_untied(
                raw_video_feature, timestamp, self._frm2sec(name), clip_idx)
        text_tokens, text_mask = self._tokenize_pad_sentence(sentence)
        text_ids = [self.word2idx.get(t, self.word2idx[UNK_TOKEN])
                    for t in text_tokens]
        text_labels = [IGNORE if m == 0 else tid for tid, m in
                       zip(text_ids, text_mask)][1:] + [IGNORE]
        data = dict(
            name=name, text_tokens=text_tokens,
            text_ids=np.asarray(text_ids, np.int64),
            text_mask=np.asarray(text_mask, np.float32),
            text_labels=np.asarray(text_labels, np.int64),
            video_feature=video_feature.astype(np.float32),
            video_mask=np.asarray(video_mask, np.float32))
        meta = dict(name=name, timestamp=timestamp, sentence=sentence)
        return data, meta

    def convert_example_to_features(self, example):
        """Every sentence step of one video, or one sentence, untied or
        joint (reference :347)."""
        video_feature = self._load_video_feature(example["name"])
        if not self.recurrent:
            to_feature = (self.clip_sentence_to_feature_untied if self.untied
                          else self.clip_sentence_to_feature)
            return to_feature(example["name"], example["timestamp"],
                              example["sentence"], video_feature,
                              example["idx"])
        feats, metas = [], []
        for clip_idx in range(len(example["sentences"])):
            d, m = self.clip_sentence_to_feature(
                example["name"], example["timestamps"][clip_idx],
                example["sentences"][clip_idx], video_feature, clip_idx)
            feats.append(d)
            metas.append(m)
        return feats, metas

    def __getitem__(self, index: int):
        return self.convert_example_to_features(self.data[index])

    def convert_ids_to_sentence(self, ids) -> str:
        """The words after [BOS] up to the first [EOS], padding dropped
        (reference :623)."""
        raw_words = [self.idx2word[int(wid)] for wid in ids
                     if int(wid) not in (PAD, IGNORE)]
        words = []
        for w in raw_words[1:]:  # no [BOS]
            if w == EOS_TOKEN:
                break
            words.append(w)
        return " ".join(words)

    # ---------- collation ----------

    def collate_fn(self, batch, *, batch_size: Optional[int] = None,
                   steps: Optional[int] = None):
        """
        Recurrent: (stacked_batch, step_sizes, metas), stacked_batch
        holding (S, N, ...) arrays, S the step count bucketed on
        COUNT_LADDER (the reference's per-step list, :646, stacked). Dummy
        steps repeat step 0 with IGNORE labels.
        Single sentences: (collated, None, metas), collated holding the
        untied or the joint (N, ...) arrays (:536-555).
        `batch_size` pads a short batch to a static N with IGNORE-labelled
        dummy rows (step_sizes/metas keep only the real examples); `steps`
        sets S (a data-parallel rank takes its global batch's).
        """
        if not self.recurrent:
            return self._collate_single(batch, batch_size)
        raw_meta = [e[1] for e in batch]
        batch_meta = [{
            "name": m[0]["name"],
            "timestamp": [d["timestamp"] for d in m],
            "gt_sentence": [d["sentence"] for d in m],
        } for m in raw_meta]
        examples = [e[0] for e in batch]
        step_sizes = [len(e) for e in examples]
        s = (steps if steps is not None
             else bucket_size(max(step_sizes), COUNT_LADDER))

        n_real = len(examples)
        n = batch_size if batch_size is not None else n_real
        assert n >= n_real
        stacked: Dict[str, np.ndarray] = {}
        for key in STACKED_KEYS:
            proto = examples[0][0][key]
            stacked[key] = np.zeros((s, n) + proto.shape, proto.dtype)
        for i in range(n):
            ex = examples[i] if i < n_real else examples[0]
            for step in range(s):
                src = ex[step] if step < len(ex) else ex[0]
                for key in STACKED_KEYS:
                    stacked[key][step, i] = src[key]
                if step >= len(ex) or i >= n_real:  # dummy: no loss
                    stacked["input_labels"][step, i] = IGNORE
        stacked["step_valid"] = np.asarray(
            [[step < sz for sz in step_sizes] + [False] * (n - n_real)
             for step in range(s)], bool)
        return stacked, step_sizes, batch_meta

    @staticmethod
    def _collate_single(batch, batch_size: Optional[int]):
        """The untied or joint sentences stacked (N, ...); dummy rows
        repeat the first example with IGNORE labels."""
        batch_meta = [{"name": e[1]["name"], "timestamp": e[1]["timestamp"],
                       "gt_sentence": e[1]["sentence"]} for e in batch]
        examples = [e[0] for e in batch]
        n_real = len(examples)
        n = batch_size if batch_size is not None else n_real
        assert n >= n_real
        label_key = ("text_labels" if "text_labels" in examples[0]
                     else "input_labels")
        for _ in range(n - n_real):
            dummy = dict(examples[0])
            dummy[label_key] = np.full_like(examples[0][label_key], IGNORE)
            examples.append(dummy)
        collated: Dict[str, Any] = {}
        for key, value in examples[0].items():
            if isinstance(value, np.ndarray):
                collated[key] = np.stack([d[key] for d in examples])
            else:
                collated[key] = [d[key] for d in examples]
        return collated, None, batch_meta


# the arrays of a stacked batch, each (S, N, ...), or of a joint
# single-sentence batch, each (N, ...)
STACKED_KEYS = ("input_ids", "input_labels", "input_mask",
                "token_type_ids", "video_feature")
# the arrays of an untied single-sentence batch, each (N, ...)
UNTIED_KEYS = ("video_feature", "video_mask", "text_ids", "text_mask",
               "text_labels")


class CaptionBatchLoader:
    """Batches of the caption dataset (videos, or single sentences), in
    order or shuffled per epoch from a seed. Under a data-parallel `mesh`
    `batch_size` is the global batch (JAX's) and each rank gets its rows
    of every global batch, padded with dummy rows to its `local_batch`
    (a rank may hold dummy rows only), with the global batch's S."""

    def __init__(self, dataset: RecursiveCaptionDataset, batch_size: int,
                 *, shuffle: bool, seed: int = 0,
                 mesh: Optional[Mesh] = None) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.mesh = mesh
        self.rows = batch_rows(mesh, batch_size)
        self.local_batch = self.rows.stop - self.rows.start

    def unsharded(self) -> "CaptionBatchLoader":
        """The same batches whole, as one process sees them (the decode
        runs unsharded)."""
        loader = CaptionBatchLoader(self.dataset, self.batch_size,
                                    shuffle=self.shuffle, seed=self.seed)
        loader.epoch = self.epoch
        return loader

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            yield self._rank_rows(order[start:start + self.batch_size])

    def _rank_rows(self, idx: np.ndarray):
        """The rank's rows of the global batch `idx` (all of it in one
        process), at the global batch's S."""
        ds = self.dataset
        steps = None
        if ds.recurrent:
            steps = bucket_size(max(len(ds.data[int(i)]["sentences"])
                                    for i in idx), COUNT_LADDER)
        own = idx[self.rows]
        if len(own):
            points = [ds[int(i)] for i in own]
            return ds.collate_fn(points, batch_size=self.local_batch,
                                 steps=steps)
        # no real row: the global batch's first example as a dummy row
        arrays, _, _ = ds.collate_fn([ds[int(idx[0])]],
                                     batch_size=self.local_batch,
                                     steps=steps)
        for key in ("input_labels", "text_labels"):
            if key in arrays:
                arrays[key][...] = IGNORE
        if "step_valid" in arrays:
            arrays["step_valid"][...] = False
        return arrays, ([] if ds.recurrent else None), []


def create_mart_datasets_and_loaders(
        cfg, coot_feat_dir: str = "provided_embeddings",
        annotations_dir: str = "annotations",
        video_feature_dir: str = "data/mart_video_feature", *,
        seed: int = 0, mesh: Optional[Mesh] = None):
    """Factory (reference :735). Val uses max_n_sen + max_n_sen_add_val
    sentences (reference :749). `mesh`: the loaders yield the rank's rows
    of each global batch."""
    common: Dict[str, Any] = dict(
        recurrent=cfg.recurrent, untied=cfg.untied or cfg.mtrans,
        video_feature_dir=video_feature_dir,
        coot_model_name=cfg.coot_model_name, coot_mode=cfg.coot_mode,
        coot_dim_vid=cfg.coot_dim_vid, coot_dim_clip=cfg.coot_dim_clip,
        annotations_dir=annotations_dir, coot_feat_dir=coot_feat_dir)
    train_dataset = RecursiveCaptionDataset(
        cfg.dataset_train.name, cfg.max_t_len, cfg.max_v_len,
        cfg.max_n_sen, mode="train",
        dataset_max=cfg.dataset_train.max_datapoints,
        preload=cfg.dataset_train.preload, **common)
    val_dataset = RecursiveCaptionDataset(
        cfg.dataset_val.name, cfg.max_t_len, cfg.max_v_len,
        cfg.max_n_sen + cfg.max_n_sen_add_val, mode="val",
        dataset_max=cfg.dataset_val.max_datapoints,
        preload=cfg.dataset_val.preload, **common)
    train_loader = CaptionBatchLoader(
        train_dataset, cfg.train.batch_size,
        shuffle=cfg.dataset_train.shuffle, seed=seed, mesh=mesh)
    val_loader = CaptionBatchLoader(
        val_dataset, cfg.val.batch_size, shuffle=False, seed=seed,
        mesh=mesh)
    return train_dataset, val_dataset, train_loader, val_loader
