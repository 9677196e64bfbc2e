"""
MART captioning dataset: annotation jsons -> joint video+text sequences ->
stacked recurrent-step batches.

Port of coot_videotext_tpu/data/caption_dataset.py (reference
mart/recursive_caption_dataset.py:46-766), the recurrent COOT-embedding
path:
    - special tokens PAD..UNK ids 0..6, IGNORE=-1 (:47-61)
    - COOT embeddings (vid/ctx/clip lookup via the clip_num cumsum,
      :296-345) packed by coot_mode (`_get_vt_features`, :493)
    - joint sequence [CLS] [VID]*v [SEP] [PAD]* + [BOS] w... [EOS] [PAD]*
      with mask 1=valid and shifted input_labels (IGNORE on video/pad
      positions) (:392-426, :529-605)
    - Treebank word tokenization, lowercased, truncated to max_t_len-2
      (:607)
    - the recurrent collation stacks steps into (S, N, L[, D]) arrays and
      pads every video to the padded step count with IGNORE-labelled dummy
      steps (:646-695)

The embedding file is `{coot_model_name}_{mode}.h5` (the JAX trainer's
export; h5py is imported only to read it) or `{coot_model_name}_{mode}.npz`
with the same arrays (`key`, `clip_num`, `vid_emb`, `vid_context`,
`clip_emb`: what the port's retrieval export writes). The tokenizer is a
copy of the Treebank word tokenizer's rules, the tokenizer the JAX package
falls back to without punkt data, so nltk is not needed.

Raw MART video features (`.npy` rgb+flow) and the untied / single-sentence
layouts are not ported yet (ROADMAP A11): the dataset raises for them.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from coot_videotext_tpu_torch.data.retrieval_dataset import (
    COUNT_LADDER, bucket_size)

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


class RecursiveCaptionDataset:
    """Captioning dataset (reference RecursiveCaptionDataset :46),
    recurrent COOT-embedding input."""

    def __init__(self, dset_name: str, max_t_len: int, max_v_len: int,
                 max_n_sen: int, mode: str = "train", *,
                 recurrent: bool = True, untied: bool = False,
                 coot_model_name: Optional[str] = None,
                 coot_mode: str = "vidclip", coot_dim_vid: int = 768,
                 coot_dim_clip: int = 384,
                 annotations_dir: str = "annotations",
                 coot_feat_dir: str = "provided_embeddings",
                 dataset_max: Optional[int] = None) -> None:
        if not recurrent or untied:
            raise NotImplementedError(
                "the single-sentence and untied caption layouts are not "
                "ported yet (ROADMAP A11)")
        if coot_model_name is None:
            raise NotImplementedError(
                "raw MART video features (coot_model_name: null) are not "
                "ported yet (ROADMAP A11)")
        self.dset_name = dset_name
        self.annotations_dir = Path(annotations_dir)
        self.coot_model_name = coot_model_name
        self.coot_mode = coot_mode
        self.coot_dim_vid = coot_dim_vid
        self.coot_dim_clip = coot_dim_clip
        self.coot_feat_dir = Path(coot_feat_dir)
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
        self.data = []
        for i, (k, line) in enumerate(raw_data.items()):
            if dataset_max is not None and 0 < dataset_max <= i:
                break
            line = dict(line)
            line["name"] = k
            line["timestamps"] = line["timestamps"][:max_n_sen]
            line["sentences"] = line["sentences"][:max_n_sen]
            self.data.append(line)

        # COOT embeddings, held in memory (a split's are a few MB; the
        # config's `preload` changes nothing here)
        coot_dataset_mode = "val" if mode == "test" else mode
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

    def __len__(self) -> int:
        return len(self.data)

    # ---------- feature loading ----------

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

    # ---------- sequence building ----------

    def _get_vt_features(self, video_feat_tuple, clip_idx: int,
                         max_v_l: int) -> Tuple[np.ndarray, int]:
        """Pack COOT vectors by coot_mode (reference :493)."""
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

    def _load_indexed_video_feature(self, raw_feat, clip_idx: int):
        """Joint-sequence video part (reference :529)."""
        max_v_l = self.max_v_len - 2
        raw_feat, valid_l = self._get_vt_features(raw_feat, clip_idx,
                                                  max_v_l)
        video_tokens = ([CLS_TOKEN] + [VID_TOKEN] * valid_l + [SEP_TOKEN]
                        + [PAD_TOKEN] * (max_v_l - valid_l))
        mask = [1] * (valid_l + 2) + [0] * (max_v_l - valid_l)
        feat = np.zeros((self.max_seq_len, raw_feat.shape[1]))
        feat[1:len(raw_feat) + 1] = raw_feat
        return feat, video_tokens, mask

    def _tokenize_pad_sentence(self, sentence: str):
        """[BOS] w.. [EOS] [PAD]* (reference :607)."""
        max_t_len = self.max_t_len
        tokens = word_tokenize(sentence.lower())[:max_t_len - 2]
        tokens = [BOS_TOKEN] + tokens + [EOS_TOKEN]
        valid_l = len(tokens)
        mask = [1] * valid_l + [0] * (max_t_len - valid_l)
        tokens += [PAD_TOKEN] * (max_t_len - valid_l)
        return tokens, mask

    def clip_sentence_to_feature(self, name, timestamp, sentence,
                                 video_feature, clip_idx: int):
        """One joint clip-sentence example (reference :392)."""
        feat, video_tokens, video_mask = self._load_indexed_video_feature(
            video_feature, clip_idx)
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

    def convert_example_to_features(self, example):
        """Every sentence step of one video (reference :347)."""
        video_feature = self._load_coot_video_feature(example["name"])
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

    def collate_fn(self, batch, *, batch_size: Optional[int] = None):
        """
        Returns (stacked_batch, step_sizes, metas): stacked_batch holds
        (S, N, ...) arrays, S the step count bucketed on COUNT_LADDER (the
        reference's per-step list, :646, stacked). Dummy steps repeat step
        0 with IGNORE labels. `batch_size` pads a short batch to a static N with
        IGNORE-labelled dummy rows (step_sizes/metas keep only the real
        examples).
        """
        raw_meta = [e[1] for e in batch]
        batch_meta = [{
            "name": m[0]["name"],
            "timestamp": [d["timestamp"] for d in m],
            "gt_sentence": [d["sentence"] for d in m],
        } for m in raw_meta]
        examples = [e[0] for e in batch]
        step_sizes = [len(e) for e in examples]
        s = bucket_size(max(step_sizes), COUNT_LADDER)

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


# the arrays of a stacked batch, each (S, N, ...)
STACKED_KEYS = ("input_ids", "input_labels", "input_mask",
                "token_type_ids", "video_feature")


class CaptionBatchLoader:
    """Batches of the caption dataset, in order or shuffled per epoch
    from a seed."""

    def __init__(self, dataset: RecursiveCaptionDataset, batch_size: int,
                 *, shuffle: bool, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

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
            idx = order[start:start + self.batch_size]
            points = [self.dataset[int(i)] for i in idx]
            yield self.dataset.collate_fn(points,
                                          batch_size=self.batch_size)


def create_mart_datasets_and_loaders(
        cfg, coot_feat_dir: str = "provided_embeddings",
        annotations_dir: str = "annotations", *, seed: int = 0):
    """Factory (reference :735). Val uses max_n_sen + max_n_sen_add_val
    sentences (reference :749)."""
    common: Dict[str, Any] = dict(
        recurrent=cfg.recurrent, untied=cfg.untied or cfg.mtrans,
        coot_model_name=cfg.coot_model_name, coot_mode=cfg.coot_mode,
        coot_dim_vid=cfg.coot_dim_vid, coot_dim_clip=cfg.coot_dim_clip,
        annotations_dir=annotations_dir, coot_feat_dir=coot_feat_dir)
    train_dataset = RecursiveCaptionDataset(
        cfg.dataset_train.name, cfg.max_t_len, cfg.max_v_len,
        cfg.max_n_sen, mode="train",
        dataset_max=cfg.dataset_train.max_datapoints, **common)
    val_dataset = RecursiveCaptionDataset(
        cfg.dataset_val.name, cfg.max_t_len, cfg.max_v_len,
        cfg.max_n_sen + cfg.max_n_sen_add_val, mode="val",
        dataset_max=cfg.dataset_val.max_datapoints, **common)
    train_loader = CaptionBatchLoader(
        train_dataset, cfg.train.batch_size,
        shuffle=cfg.dataset_train.shuffle, seed=seed)
    val_loader = CaptionBatchLoader(
        val_dataset, cfg.val.batch_size, shuffle=False, seed=seed)
    return train_dataset, val_dataset, train_loader, val_loader
