"""
The device-resident feature store, on-device sampling and packed parts.

Port of coot_videotext_tpu/data/device_store.py: `RetrievalDeviceStore` :29
(the whole feature set of a split in device memory, in the compute dtype),
`collate_indices` :68 (host sampling, index-only batches),
`gather_dense_batch` :167 (the dense batch rebuilt on the device),
`RetrievalDeviceMeta` :205 (per-datapoint tables on the device, with the
pack budgets), `_sample_frame_indices` :293 and `device_sample_batch` :318
(datapoint ids -> index batch on the device, with part packing).

Every gather goes through kernel B5 (ops/gather.py): on the card the
Hopper kernel, with the training noise fused in. Deliberate differences:
    - the train jitter's uniforms are an argument of `device_sample_batch`
      (`draw_uniforms` takes them from the Philox bits of the step's seed
      state, on the device), so a test can hand it JAX's own draws;
    - the noise of each gather is keyed on (seed, site, element) with
      Philox bits (ops/philox.py), the seed a `philox.Seed` derived on the
      device, not drawn from a split JAX key.
Layout: all videos concatenated along frames into one (total_frames, D)
tensor with per-video offsets; paragraphs likewise. Padded slots index row
0 (or the sequence's first frame); their masks are False.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.gather import GatherNoise, gather_rows
from coot_videotext_tpu_torch.parallel.mesh import Mesh, batch_rows


def _upload(arrays, dim: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Concatenate (rows, dim) numpy arrays into one tensor on `device`,
    copied array by array."""
    out = torch.empty((sum(a.shape[0] for a in arrays), dim), dtype=dtype,
                      device=device)
    row = 0
    for a in arrays:
        out[row:row + a.shape[0]].copy_(
            torch.from_numpy(np.asarray(a, np.float32)))
        row += a.shape[0]
    return out


class RetrievalDeviceStore:
    """A RetrievalDataset's full feature set in device memory: `vid_store`
    (total video frames, D_vid) and `text_store` (total paragraph tokens,
    D_text), both in `dtype`; `nbytes` and `upload_s` say what it took."""

    def __init__(self, dataset, *, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device = torch.device("cpu")) -> None:
        self.dataset = dataset
        self.device = device
        start = time.perf_counter()
        vid_chunks = []
        self.vid_offset: Dict[str, int] = {}
        offset = 0
        for data_key in dict.fromkeys(dataset.data_keys):
            feat = dataset.vid_feats[data_key]
            self.vid_offset[data_key] = offset
            offset += feat.shape[0]
            vid_chunks.append(feat)
        text_chunks = []
        self.text_offset: Dict[str, int] = {}
        offset = 0
        for key in dataset.keys:
            feat, _splits = dataset.text_feats[key]
            self.text_offset[key] = offset
            offset += feat.shape[0]
            text_chunks.append(feat)
        self.vid_store = _upload(vid_chunks, dataset.cfg.vid_feat_dim, dtype,
                                 device)
        self.text_store = _upload(text_chunks, dataset.cfg.text_feat_dim,
                                  dtype, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.upload_s = time.perf_counter() - start
        self.nbytes = (self.vid_store.numel() * self.vid_store.element_size()
                       + self.text_store.numel()
                       * self.text_store.element_size())

    # ---------- host side: index-only collation ----------

    def collate_indices(self, points, *, batch_size: Optional[int] = None,
                        fixed_shapes: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
        """
        The dense batch dict with `vid_feat`, `clip_feat`, `par_feat`,
        `sent_feat` replaced by int32 row indices into the store:
        `vid_idx (B, Lv)`, `clip_idx (B, N, Lc)`, `par_idx (B, Lp)`,
        `sent_idx (B, N, Ls)`. Points are the dataset's `get_indices`.
        """
        n_real = len(points)
        b = batch_size if batch_size is not None else n_real
        if fixed_shapes is None:
            fixed_shapes = index_dims(points)
        lv, lc = fixed_shapes["lv"], fixed_shapes["lc"]
        ls, lp = fixed_shapes["ls"], fixed_shapes["lp"]
        n_parts = fixed_shapes["n_parts"]

        batch = {
            "key": [p["key"] for p in points],
            "data_key": [p["data_key"] for p in points],
            "sentences": [p["sentences"] for p in points],
            "batch_valid": np.zeros(b, bool),
            "vid_idx": np.zeros((b, lv), np.int32),
            "vid_mask": np.zeros((b, lv), bool),
            "vid_len": np.ones(b, np.int32),
            "clip_idx": np.zeros((b, n_parts, lc), np.int32),
            "clip_mask": np.zeros((b, n_parts, lc), bool),
            "clip_len": np.zeros((b, n_parts), np.int32),
            "clip_valid": np.zeros((b, n_parts), bool),
            "clip_num": np.ones(b, np.int32),
            "par_idx": np.zeros((b, lp), np.int32),
            "par_mask": np.zeros((b, lp), bool),
            "par_len": np.ones(b, np.int32),
            "sent_idx": np.zeros((b, n_parts, ls), np.int32),
            "sent_mask": np.zeros((b, n_parts, ls), bool),
            "sent_len": np.zeros((b, n_parts), np.int32),
            "sent_valid": np.zeros((b, n_parts), bool),
            "sent_num": np.ones(b, np.int32),
        }
        for i, p in enumerate(points):
            batch["batch_valid"][i] = True
            voff = self.vid_offset[p["data_key"]]
            toff = self.text_offset[p["key"]]
            nv = len(p["vid_idx"])
            batch["vid_idx"][i, :nv] = voff + np.asarray(p["vid_idx"])
            batch["vid_mask"][i, :nv] = True
            batch["vid_len"][i] = nv
            np_tok = p["par_len"]
            batch["par_idx"][i, :np_tok] = toff + np.arange(np_tok)
            batch["par_mask"][i, :np_tok] = True
            batch["par_len"][i] = np_tok
            batch["clip_num"][i] = p["clip_num"]
            batch["sent_num"][i] = len(p["sent_split"])
            for j, cidx in enumerate(p["clip_idx"]):
                nc = len(cidx)
                batch["clip_idx"][i, j, :nc] = voff + np.asarray(cidx)
                batch["clip_mask"][i, j, :nc] = True
                batch["clip_len"][i, j] = nc
                batch["clip_valid"][i, j] = True
            ptr = 0
            for j, slen in enumerate(p["sent_split"]):
                batch["sent_idx"][i, j, :slen] = toff + ptr + np.arange(
                    slen)
                batch["sent_mask"][i, j, :slen] = True
                batch["sent_len"][i, j] = slen
                batch["sent_valid"][i, j] = True
                ptr += slen
        # padded rows: one valid slot to keep masked math finite
        for i in range(n_real, b):
            batch["vid_mask"][i, 0] = True
            batch["par_mask"][i, 0] = True
            batch["clip_mask"][i, 0, 0] = True
            batch["clip_len"][i, 0] = 1
            batch["clip_valid"][i, 0] = True
            batch["sent_mask"][i, 0, 0] = True
            batch["sent_len"][i, 0] = 1
            batch["sent_valid"][i, 0] = True
        return batch


def index_dims(points) -> Dict[str, int]:
    """The bucketed padded dims (lv, lc, ls, lp, n_parts) of a batch of
    the dataset's `get_indices` points."""
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        COUNT_LADDER, LENGTH_LADDER, bucket_size)
    return {
        "lv": bucket_size(max(len(p["vid_idx"]) for p in points),
                          LENGTH_LADDER),
        "lc": bucket_size(max(len(c) for p in points for c in p["clip_idx"]),
                          LENGTH_LADDER),
        "ls": bucket_size(max(s for p in points for s in p["sent_split"]),
                          LENGTH_LADDER),
        "lp": bucket_size(max(p["par_len"] for p in points), LENGTH_LADDER),
        "n_parts": bucket_size(max(p["clip_num"] for p in points),
                               COUNT_LADDER),
    }


# the batch's index fields, their feature fields, their store and noise site
_GATHERS = (("vid_idx", "vid_feat", 0, philox.SITE_NOISE_VIDEO),
            ("clip_idx", "clip_feat", 0, philox.SITE_NOISE_CLIP),
            ("par_idx", "par_feat", 1, philox.SITE_NOISE_PARAGRAPH),
            ("sent_idx", "sent_feat", 1, philox.SITE_NOISE_SENTENCE))


def gather_dense_batch(batch: Dict[str, torch.Tensor],
                       vid_store: torch.Tensor, text_store: torch.Tensor, *,
                       frames_noise: float = 0.0, words_noise: float = 0.0,
                       seed: Optional[philox.SeedLike] = None
                       ) -> Dict[str, torch.Tensor]:
    """
    DEVICE side: the dense feature batch from the index fields, each of the
    four gathers through B5. With `seed` (training), truncnorm noise of std
    `frames_noise` (video, clips) and `words_noise` (paragraph, sentences)
    is fused into the gather, drawn per gathered slot: video and clip
    copies of a frame are noised independently, as in JAX (the reference
    draws it per datapoint copy on the host, dataset_retrieval.py:286-303).
    """
    out = dict(batch)
    stores = (vid_store, text_store)
    for idx_key, feat_key, which, site in _GATHERS:
        idx = out.pop(idx_key)
        std = frames_noise if which == 0 else words_noise
        noise = (GatherNoise(float(std), seed, site)
                 if seed is not None and std else None)
        store = stores[which]
        rows = gather_rows(store, idx.reshape(-1).contiguous(), noise)
        out[feat_key] = rows.view(*idx.shape, store.shape[1])
    return out


# ---------- fully device-resident pipeline: on-device sampling ----------

class RetrievalDeviceMeta:
    """
    Per-datapoint metadata on the device, so that frame sampling, the
    gather indices and the masks are built on the device and the host
    ships only (B,) datapoint ids per batch.

    Sampling: validation's center sampling is the reference formula
    floor(i * n / t + n / t / 2) (nntrainer/maths.py:12) in float32;
    training's jitter is floor((i + u_i) * n / t) with one uniform per
    slot: the reference's marginal distribution, another random stream.
    """

    def __init__(self, store: RetrievalDeviceStore,
                 fixed_shapes: Dict[str, int], max_frames: int, *,
                 batch_size: Optional[int] = None,
                 pack_parts: bool = True) -> None:
        ds = store.dataset
        n = len(ds.keys)
        n_parts = fixed_shapes["n_parts"]
        self.shapes = dict(fixed_shapes)
        self.max_frames = max_frames
        if pack_parts and batch_size is not None:
            # static pack budgets: no batch of `batch_size` distinct videos
            # can exceed the sum of the top-batch_size part counts, so the
            # packed layout never overflows; +batch_size covers the
            # one-live-slot fixups on padded final-batch rows
            def budget(counts):
                top = sorted(counts, reverse=True)[:batch_size]
                need = sum(top) + batch_size
                return min(-(-need // 64) * 64, batch_size * n_parts)

            self.shapes["pack_clips"] = budget(
                [len(ds.meta[k]["segments"]) for k in ds.keys])
            self.shapes["pack_sents"] = budget(
                [len(ds.sentence_split(k, [1])) for k in ds.keys])

        vid_off = np.zeros(n, np.int32)
        vid_nf = np.zeros(n, np.int32)
        seg_off = np.zeros((n, n_parts), np.int32)
        seg_nf = np.zeros((n, n_parts), np.int32)
        seg_valid = np.zeros((n, n_parts), bool)
        clip_num = np.zeros(n, np.int32)
        text_off = np.zeros(n, np.int32)
        sent_len = np.zeros((n, n_parts), np.int32)
        sent_off = np.zeros((n, n_parts), np.int32)
        sent_num = np.zeros(n, np.int32)
        par_len = np.zeros(n, np.int32)
        for i, (key, data_key) in enumerate(zip(ds.keys, ds.data_keys)):
            meta = ds.meta[key]
            vid_off[i] = store.vid_offset[data_key] + \
                meta["start_frame_vid"]
            vid_nf[i] = meta["num_frames_vid"]
            clip_num[i] = len(meta["segments"])
            for j, seg in enumerate(meta["segments"]):
                seg_off[i, j] = store.vid_offset[data_key] + \
                    seg["start_frame"]
                seg_nf[i, j] = seg["num_frames"]
                seg_valid[i, j] = True
            text_off[i] = store.text_offset[key]
            splits = ds.sentence_split(key)
            sent_num[i] = len(splits)
            ptr = 0
            for j, slen in enumerate(splits):
                sent_len[i, j] = slen
                sent_off[i, j] = text_off[i] + ptr
                ptr += slen
            par_len[i] = ptr
        tables = {"vid_off": vid_off, "vid_nf": vid_nf, "seg_off": seg_off,
                  "seg_nf": seg_nf, "seg_valid": seg_valid,
                  "clip_num": clip_num, "sent_len": sent_len,
                  "sent_off": sent_off, "sent_num": sent_num,
                  "par_len": par_len, "text_off": text_off}
        self.tables = {k: torch.from_numpy(v).to(store.device)
                       for k, v in tables.items()}


def draw_uniforms(state: torch.Tensor, batch_size: int,
                  shapes: Dict[str, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train jitter's uniforms on [0, 1): (B, Lv) for the videos and
    (B, N, Lc) for the clips, one draw from the seed state's Philox bits at
    SITE_JITTER, on the state's device."""
    nv = batch_size * shapes["lv"]
    u = philox.uniform(
        (nv + batch_size * shapes["n_parts"] * shapes["lc"],), state,
        philox.SITE_JITTER)
    return (u[:nv].view(batch_size, shapes["lv"]),
            u[nv:].view(batch_size, shapes["n_parts"], shapes["lc"]))


def _sample_frame_indices(offset: torch.Tensor, n_frames: torch.Tensor,
                          slots: int, max_frames: int,
                          u: Optional[torch.Tensor] = None):
    """
    nntrainer/maths.py compute_indices on the device for every sequence of
    `offset`/`n_frames` (any shape S): (idx S+(slots,), mask, length) with
    padded slots on the sequence's first frame. t = min(n_frames,
    max_frames) frames are sampled: interval centers without `u`, uniform
    jitter per interval with `u` (S+(slots,)).
    """
    t = torch.clamp(n_frames, max=max_frames)
    i = torch.arange(slots, dtype=torch.float32, device=offset.device)
    n_f = n_frames.to(torch.float32)[..., None]
    t_f = torch.clamp(t.to(torch.float32), min=1.0)[..., None]
    if u is None:  # center sampling (val)
        pos = torch.floor(i * n_f / t_f + n_f / t_f / 2.0)
    else:  # jittered (train)
        pos = torch.floor((i + u) * n_f / t_f)
    pos = torch.minimum(torch.clamp(pos.to(torch.int32), min=0),
                        torch.clamp(n_frames - 1, min=0)[..., None])
    mask = torch.arange(slots, device=offset.device) < t[..., None]
    idx = torch.where(mask, offset[..., None] + pos, offset[..., None])
    return idx, mask, t


def device_sample_batch(tables: Dict[str, torch.Tensor],
                        dp_idx: torch.Tensor, shapes: Dict[str, int],
                        max_frames: int, *,
                        uniforms: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                        batch_valid: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """
    DEVICE side: datapoint ids -> index batch (the schema of
    `RetrievalDeviceStore.collate_indices`). `uniforms` (from
    `draw_uniforms`) selects the train jitter; None the deterministic
    center sampling of validation. With pack budgets in `shapes`, the clip
    and sentence slots are packed (see below).
    """
    b = dp_idx.shape[0]
    lv, lc = shapes["lv"], shapes["lc"]
    ls, lp = shapes["ls"], shapes["lp"]
    n_parts = shapes["n_parts"]
    dev = dp_idx.device
    if batch_valid is None:
        batch_valid = torch.ones(b, dtype=torch.bool, device=dev)
    m = {k: v[dp_idx.long()] for k, v in tables.items()}

    u_vid, u_clip = uniforms if uniforms is not None else (None, None)
    vid_idx, vid_mask, vid_len = _sample_frame_indices(
        m["vid_off"], m["vid_nf"], lv, max_frames, u_vid)
    clip_idx, clip_mask, clip_len = _sample_frame_indices(
        m["seg_off"], m["seg_nf"], lc, max_frames, u_clip)

    # clamp masks by validity
    clip_valid = m["seg_valid"] & batch_valid[:, None]
    clip_mask = clip_mask & clip_valid[:, :, None]
    clip_len = torch.where(clip_valid, clip_len, 0)
    # keep one live slot on padded rows (finite masked softmaxes)
    first_slot = torch.arange(n_parts, device=dev)[None, :] == 0
    pad_first = ~batch_valid[:, None] & first_slot
    clip_valid = clip_valid | pad_first
    clip_mask[:, :, 0] |= pad_first
    clip_len = torch.maximum(clip_len, pad_first.to(torch.int32))

    # text: deterministic ranges
    par_len, sent_len = m["par_len"], m["sent_len"]
    tok = torch.arange(lp, device=dev)[None, :]
    par_idx = m["text_off"][:, None] + torch.minimum(
        tok, torch.clamp(par_len - 1, min=0)[:, None])
    par_mask = tok < par_len[:, None]
    par_mask[:, 0] = True
    stok = torch.arange(ls, device=dev)[None, None, :]
    sent_idx = m["sent_off"][:, :, None] + torch.minimum(
        stok, torch.clamp(sent_len - 1, min=0)[:, :, None])
    sent_valid = (sent_len > 0) & batch_valid[:, None]
    sent_mask = (stok < sent_len[:, :, None]) & sent_valid[:, :, None]
    sent_valid = sent_valid | pad_first
    sent_mask[:, :, 0] |= pad_first
    sent_lens = torch.where(sent_valid, torch.clamp(sent_len, min=1), 0)

    vid_mask[:, 0] = True
    i32 = torch.int32
    batch = {
        "batch_valid": batch_valid,
        "vid_idx": vid_idx.to(i32),
        "vid_mask": vid_mask,
        "vid_len": torch.clamp(vid_len, min=1).to(i32),
        "clip_idx": clip_idx.to(i32),
        "clip_mask": clip_mask,
        "clip_len": clip_len.to(i32),
        "clip_valid": clip_valid,
        "clip_num": torch.clamp(m["clip_num"], min=1).to(i32),
        "par_idx": par_idx.to(i32),
        "par_mask": par_mask,
        "par_len": torch.clamp(par_len, min=1).to(i32),
        "sent_idx": sent_idx.to(i32),
        "sent_mask": sent_mask,
        "sent_len": sent_lens.to(i32),
        "sent_valid": sent_valid,
        "sent_num": torch.clamp(m["sent_num"], min=1).to(i32),
    }

    # ---- part packing: drop padded clip/sentence slots ----
    # The dense (B, N, L) layout spends the local net on padded part slots
    # (mean ~7.7 clips vs N = 16 on yc2). With a static budget P >= any
    # batch's part count, the valid slots go to the front of a (P, L)
    # layout (stable sort, so in (b, n) order) and the model scatters the
    # local embeddings back to (B, N, D) at (owner, pos) before the global
    # net: every real part is encoded once, padded slots never are.
    def pack(valid2d, arrs, budget):
        flat_valid = valid2d.reshape(-1)
        order = torch.argsort(torch.where(flat_valid, 0, 1), stable=True)
        slots = order[:budget]
        packed = [a.reshape((-1,) + a.shape[2:])[slots] for a in arrs]
        return ((slots // n_parts).to(i32), (slots % n_parts).to(i32),
                flat_valid[slots], packed)

    pack_clips = shapes.get("pack_clips")
    pack_sents = shapes.get("pack_sents")
    if pack_clips is not None and pack_clips < b * n_parts:
        owner, pos, sv, (ci, cm, cl) = pack(
            clip_valid, [batch["clip_idx"], batch["clip_mask"],
                         batch["clip_len"]], pack_clips)
        batch.update(clip_idx=ci, clip_mask=cm, clip_len=cl,
                     clip_owner=owner, clip_pos=pos, clip_slot_valid=sv)
    if pack_sents is not None and pack_sents < b * n_parts:
        owner, pos, sv, (si, sm, sl) = pack(
            sent_valid, [batch["sent_idx"], batch["sent_mask"],
                         batch["sent_len"]], pack_sents)
        batch.update(sent_idx=si, sent_mask=sm, sent_len=sl,
                     sent_owner=owner, sent_pos=pos, sent_slot_valid=sv)
    return batch


@dataclasses.dataclass(frozen=True)
class FeatureSource:
    """Where a step's features come from besides a dense host batch: the
    loader's store (index batches), its device metadata (id batches), and
    the train-time noise that the store gathers add (slab rows carry the
    host's noise already). Counterpart of the JAX trainer's `_loader_mode`
    (tasks/retrieval/trainer.py:104)."""
    store: Optional[RetrievalDeviceStore] = None
    meta: Optional[RetrievalDeviceMeta] = None
    frames_noise: float = 0.0
    words_noise: float = 0.0

    @classmethod
    def of(cls, loader, frames_noise: float = 0.0,
           words_noise: float = 0.0) -> "FeatureSource":
        return cls(loader.device_store, loader.device_meta, frames_noise,
                   words_noise)

    @property
    def noisy(self) -> bool:
        """Whether the store gathers add noise (in training)."""
        return self.store is not None and bool(self.frames_noise
                                               or self.words_noise)


def assemble_batch(batch: Dict[str, Any],
                   source: Optional[FeatureSource] = None, *,
                   sample_state: Optional[torch.Tensor] = None,
                   noise_seed: Optional[philox.Seed] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """
    Any loader batch on the device -> the dense batch the model takes, by
    its "layout" (data/retrieval_dataset.py LAYOUTS; a batch without one
    is dense). A dense batch passes through. An id batch is sampled on the
    device: train jitter from the seed state `sample_state`, center
    sampling without one. Index batches gather their rows through B5 from
    the store, slab batches from the slabs they carry; `noise_seed`
    (training) adds the source's noise to store gathers only. Under a
    data-parallel `mesh` the batch holds the rank's rows of the global
    batch: the jitter's uniforms are drawn for the global batch and the
    rank takes its rows of them, so W ranks sample the frames one process
    would.
    """
    layout = batch.get("layout", "dense")
    if layout == "dense":
        return batch
    batch = {k: v for k, v in batch.items() if k != "layout"}
    if layout == "slab":
        return gather_dense_batch(batch, batch.pop("vid_store"),
                                  batch.pop("text_store"))
    if layout == "ids":
        meta = source.meta
        uniforms = None
        if sample_state is not None:
            local = batch["dp_idx"].shape[0]
            world = mesh.world if mesh is not None else 1
            rows = batch_rows(mesh, local * world)
            uniforms = tuple(u[rows] for u in draw_uniforms(
                sample_state, local * world, meta.shapes))
        dp_idx, batch_valid = batch.pop("dp_idx"), batch.pop("batch_valid")
        batch.update(device_sample_batch(
            meta.tables, dp_idx, meta.shapes, meta.max_frames,
            uniforms=uniforms, batch_valid=batch_valid))
    elif layout != "indices":
        raise ValueError(f"unknown batch layout {layout!r}")
    return gather_dense_batch(
        batch, source.store.vid_store, source.store.text_store,
        frames_noise=source.frames_noise, words_noise=source.words_noise,
        seed=noise_seed)
