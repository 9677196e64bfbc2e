"""
The work a cell asks of the chip, from the model's shapes and each batch's
valid counts alone: floating-point operations of the whole step (for the
`*mfu*` shares) and the least time each call of the program's own kernels
B1-B5 could take (for `kernel_roofline.*`).

Counts use valid rows only: frames a video or clip samples (capped at
max_frames), tokens of its paragraph and sentences, its clips. Padding,
recomputation and whatever a kernel reads twice are not counted, so the
shares read the same work whatever the program launches and stay at or
under 100%. A backward counts twice its forward's products (input and
weight gradients), except B1's, whose input is data and gets no gradient.

The peaks are an NVIDIA H100 SXM's (data sheet, dense): 3.35 TB/s of HBM,
989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of one call: bytes read once and written once at
    HBM speed, or its products at the dtype's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------- COOT (yc2_2d3d_coot widths) ----------

def coot_dims(cfg: dict) -> Dict[str, int]:
    local = cfg["net_video_local"]
    att = local["selfatn_config"]
    pool = local["pooler_config"]
    ds = cfg["dataset_train"]
    return {"d": int(att["hidden_dim"]), "ff": int(att["pointwise_ff_dim"]),
            "pool_hidden": int(pool["hidden_dim"]),
            "pool_heads": int(pool["num_heads"]),
            "vid_in": int(ds["vid_feat_dim"]),
            "text_in": int(ds["text_feat_dim"])}


def _local_apps(c: Dict[str, int], dims: Dict[str, int]):
    """(input width, valid rows, sum of squared sequence lengths) of the
    four local-net applications: videos, clips, paragraphs, sentences."""
    return ((dims["vid_in"], c["vid_rows"], c["vid_sq"]),
            (dims["vid_in"], c["clip_rows"], c["clip_sq"]),
            (dims["text_in"], c["par_rows"], c["par_sq"]),
            (dims["text_in"], c["sent_rows"], c["sent_sq"]))


def _encoder_flops(rows: int, sq: int, d: int, ff: int) -> float:
    return rows * (8 * d * d + 4 * d * ff) + 4 * sq * d


def _genpool_flops(rows: int, dims) -> float:
    d, hid, heads = dims["d"], dims["pool_hidden"], dims["pool_heads"]
    return 2 * rows * (d * hid + hid * d // heads)


def coot_forward_flops(c: Dict[str, int], dims: Dict[str, int]
                       ) -> Dict[str, float]:
    """Forward products of the four nets over the valid counts `c`
    (`data.RetrievalSplit.valid_counts`), split into B1 and the rest."""
    d, ff = dims["d"], dims["ff"]
    b1 = rest = 0.0
    for din, rows, sq in _local_apps(c, dims):
        b1 += 2 * rows * din * d
        rest += _encoder_flops(rows, sq, d, ff) + _genpool_flops(rows, dims)
    videos, clips = c["videos"], c["clips"]
    for _ in range(2):  # the two global nets over the clips / sentences
        rest += _encoder_flops(clips, c["clips_sq"], d, ff)
        # cross-attention: a length-1 query a video over its parts
        rest += (4 * videos * d * d + 4 * clips * d * d + 4 * clips * d
                 + 4 * videos * d * ff)
    return {"b1": b1, "rest": rest}


def coot_train_flops(c, dims) -> float:
    f = coot_forward_flops(c, dims)
    return 2 * f["b1"] + 3 * f["rest"]


def coot_eval_flops(c, dims) -> float:
    f = coot_forward_flops(c, dims)
    return f["b1"] + f["rest"]


def coot_kernel_bound_s(c: Dict[str, int], dims: Dict[str, int],
                        train: bool) -> float:
    """Summed least time of the B1-B5 calls of one step over the valid
    counts: B5 (the four gathers), B1 (the four input stages), B3 (every
    attention core), B2 (the four GenPools), B4 (every dropout site, in
    training); backward calls too in training. bfloat16 activations, float32
    parameters."""
    d, ff = dims["d"], dims["ff"]
    bf, f32 = 2, 4
    total = 0.0
    pool_params = (d * dims["pool_hidden"] + dims["pool_hidden"]
                   + dims["pool_hidden"] * d // dims["pool_heads"] + d) * f32
    for din, rows, sq in _local_apps(c, dims):
        total += bound_s(2 * rows * din * bf, 0, "bfloat16")  # B5
        fl = 2 * rows * din * d
        by = rows * din * bf + din * d * f32 + rows * d * bf
        total += bound_s(by, fl, "bfloat16")  # B1
        att_fl, att_by = 4 * sq * d, 4 * rows * d * bf
        total += bound_s(att_by, att_fl, "bfloat16")  # B3
        gp_fl = _genpool_flops(rows, dims)
        gp_by = rows * d * bf + pool_params
        total += bound_s(gp_by, gp_fl, "bfloat16")  # B2
        if train:
            total += bound_s(by + din * d * f32, fl, "bfloat16")
            total += bound_s(2 * att_by, 2 * att_fl, "bfloat16")
            total += bound_s(2 * gp_by + pool_params, 2 * gp_fl, "bfloat16")
            # B4 after attention and twice in the FFN, forward and back
            total += 2 * bound_s(2 * rows * (2 * d + ff) * bf, 0, "bfloat16")
    videos, clips = c["videos"], c["clips"]
    for _ in range(2):
        for q_rows, kv_rows, sq in ((clips, clips, c["clips_sq"]),
                                    (videos, clips, clips)):
            att_fl = 4 * sq * d
            att_by = (q_rows * 2 + kv_rows * 2) * d * bf
            total += bound_s(att_by, att_fl, "bfloat16")
            if train:
                total += bound_s(2 * att_by, 2 * att_fl, "bfloat16")
                total += 2 * bound_s(2 * q_rows * (2 * d + ff) * bf, 0,
                                     "bfloat16")
    return total


# ---------- MART (yc2_2d3d_coot_vidclip_mart widths) ----------

def mart_sentence_flops(cfg: dict) -> float:
    """Products of one sentence step of recurrent MART with every position
    run once, as a decoder with a cache runs it: the embedding stacks, per
    layer the self-attention over each position's prefix, the
    intermediate, the memory update (one memory cell a layer), the
    memory-augmented attention over memory and prefix, the memory
    projection and output, and the prediction head."""
    d, di = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    vocab, words = int(cfg["vocab_size"]), int(cfg["word_vec_size"])
    video = int(cfg["video_feature_size"])
    cells = int(cfg["n_memory_cells"])
    length = int(cfg["max_v_len"]) + int(cfg["max_t_len"])
    prefix = sum(range(1, length + 1))  # keys each position attends
    flops = length * 2 * d * (words + video)
    per_layer = (length * (8 * d * d + 2 * d * di + 2 * di * d)
                 + 4 * d * prefix
                 # memory update: q of the cells, k and v of the positions,
                 # the gates
                 + cells * 2 * d * d + length * 4 * d * d
                 + 4 * d * cells * length + cells * 8 * d * d
                 # memory-augmented attention, projection
                 + length * (8 * d * d) + 4 * d * (prefix + cells * length))
    flops += int(cfg["num_hidden_layers"]) * per_layer
    flops += length * (2 * d * d + 2 * d * vocab)
    return float(flops)


def mart_dropout_bound_s(cfg: dict, sentences: int) -> float:
    """Least time of the dropout calls (B4, forward and backward, float32:
    each element read and written once) of one video's `sentences`
    sentence steps in training: the word and video stacks, the embeddings,
    and per layer the attention probabilities, the attention output, the
    memory updater's and memory-augmented attention's probabilities, the
    output block, and the memory initialiser on the first step."""
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    cells = int(cfg["n_memory_cells"])
    length = int(cfg["max_v_len"]) + int(cfg["max_t_len"])
    per_step = length * (int(cfg["word_vec_size"])
                         + int(cfg["video_feature_size"]) + d)
    per_step += int(cfg["num_hidden_layers"]) * (
        heads * length * length + 2 * length * d
        + heads * cells * length + heads * length * (length + cells))
    elements = sentences * per_step + int(cfg["num_hidden_layers"]) * cells * d
    return 2 * bound_s(elements * 4 * 2, 0, "float32")
