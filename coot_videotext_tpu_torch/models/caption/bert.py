"""
BERT-style building blocks of the MART caption model family.

Port of coot_videotext_tpu/models/caption/bert.py (reference mart/model.py):
    - TF-style LayerNorm (biased variance, eps inside sqrt, :147) ==
      nn.LayerNorm with the same eps.
    - additive attention mask (1-mask)*-10000 (:198), not the -INF fill of
      the COOT side; scores in f32 from torch.matmul (the JAX package's
      einsum_f32), no fused attention kernel, so masked rows match JAX.
    - exact-erf gelu (:97), sincos PositionEncoding added to the summed
      embeddings (:108), video+word+token-type embedding sum (:458),
      prediction head (:802), its decoder matrix tied to the word
      embeddings under share_wd_cls_weight.
    - shifted masks: video prefix fully visible, text suffix causal,
      memory prefix visible (make_shifted_mask :286, make_pad_shifted_mask
      :316).
    - memory: masked mean-pool init with learned bias (:724), GRU-style
      z/c-gated update from attention over states (:751).
    - the joint single-sentence encoder without memory (BertLayerNoMemory,
      BertEncoderNoMemory, reference :334-382).
    - the cached greedy decode of recurrent MART, inference only
      (`decode_*` methods, the attention's `project` / `attend`):
      forward's rows a position at a time over per-layer key / value
      caches, each block's products as `rows_linear` and q, k and v in one
      product; no counterpart in JAX or the reference, which re-run the
      full forward a token (tasks/caption/translator.py).

Module and parameter names are the reference torch MART keys (what the JAX
package's utils/torch_convert.py::_convert_mart_key reads), so a reference
`{"model": state_dict}` loads as it is. Dropout sites use the port's
`models/layers.Dropout` (identity in eval); the attention and
intermediate projections are `models/layers.Linear` (float32 here, as
nn.Linear), which tensor parallelism places (parallel/tp.py: the rank's
heads and FFN columns of recurrent MART). Init: weights normal(0,
initializer_range), biases zero, LN ones/zeros (reference
init_bert_weights :1401-1413).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coot_videotext_tpu_torch.models.layers import Dropout, Linear
from coot_videotext_tpu_torch.parallel.mesh import Mesh
from coot_videotext_tpu_torch.parallel.tp import (
    copy_inputs, copy_to_model, gather_from_model, place_linear)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf gelu (reference model.py:97)."""
    return F.gelu(x, approximate="none")


def positional_encoding_table(max_len: int, dim: int) -> np.ndarray:
    """Sincos table (reference PositionEncoding :108-131)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def bert_layernorm(cfg, dim: int) -> nn.LayerNorm:
    """TF-style LayerNorm (reference BertLayerNorm :147)."""
    return nn.LayerNorm(dim, eps=cfg.layer_norm_eps)


# ---------- masks ----------

def make_shifted_mask(input_mask: torch.Tensor, max_v_len: int,
                      max_t_len: int, memory_len: int = 0) -> torch.Tensor:
    """(N, L) -> (N, max_v_len+max_t_len, M+L) float mask: memory+video
    columns always visible, text columns causal (reference :286)."""
    bsz, seq_len = input_mask.shape
    assert max_v_len + max_t_len + memory_len == seq_len
    n_rows = max_v_len + max_t_len
    row = torch.arange(n_rows, device=input_mask.device)[:, None]
    col = torch.arange(seq_len, device=input_mask.device)[None, :]
    always = col < memory_len + max_v_len
    # causal among text: row i (i >= max_v_len) sees text cols j with
    # j - (memory_len + max_v_len) <= i - max_v_len
    causal = (row >= max_v_len) & (col - memory_len <= row)
    mask = (always | causal).float()
    return mask[None].expand(bsz, n_rows, seq_len)


def make_pad_shifted_mask(input_mask: torch.Tensor, max_v_len: int,
                          max_t_len: int, memory_len: int = 0
                          ) -> torch.Tensor:
    """Shifted mask * padding mask (reference :316)."""
    shifted = make_shifted_mask(input_mask, max_v_len, max_t_len,
                                memory_len=memory_len)
    return shifted * input_mask.float()[:, None, :]


def make_video_only_mask(input_mask: torch.Tensor,
                         max_v_len: int) -> torch.Tensor:
    """Zero out the text suffix (reference :323)."""
    col = torch.arange(input_mask.shape[1], device=input_mask.device)
    return torch.where(col[None, :] < max_v_len, input_mask,
                       torch.zeros_like(input_mask))


# ---------- attention ----------

class BertSelfAttention(nn.Module):
    """Multi-head attention with additive -10000 mask (reference :164).
    Under tensor parallelism (`place_tp`) it runs the rank's heads: q, k
    and v column-parallel, each distinct input through `copy_to_model`,
    the probability dropout on a seed of the rank's own; its context is
    gathered (`gather_out`) unless a row-parallel output projection takes
    the rank's columns (BertAttention)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        assert cfg.hidden_size % cfg.num_attention_heads == 0
        self.n_heads = cfg.num_attention_heads
        self.d_head = cfg.hidden_size // cfg.num_attention_heads
        self.query = Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)
        self.tp: Optional[Mesh] = None
        self.gather_out = True

    def heads_shardable(self, mesh: Mesh, shards: Dict[str, int]) -> bool:
        """Whether q, k and v are sharded by output and the heads split
        evenly over the model group."""
        return (all(shards.get(f"{n}.weight") == 0
                    for n in ("query", "key", "value"))
                and self.n_heads % mesh.model_world == 0)

    def place_heads(self, mesh: Mesh, gather_out: bool):
        """Runs the rank's heads; returns (the parameters placed, their
        partial gradients)."""
        self.tp, self.gather_out = mesh, gather_out
        self.dropout.sharded = True
        for n in ("query", "key", "value"):
            place_linear(getattr(self, n), "column", mesh, 0)
        return ({f"{n}.weight" for n in ("query", "key", "value")},
                {f"{n}.bias" for n in ("query", "key", "value")})

    def place_tp(self, mesh: Mesh, shards: Dict[str, int]):
        """The rank's heads with the context gathered, where they split;
        else the Linears gather their weights."""
        if not self.heads_shardable(mesh, shards):
            return set(), set()
        return self.place_heads(mesh, gather_out=True)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        return x.view(b, length, -1, self.d_head).transpose(1, 2)

    def forward(self, query_states: torch.Tensor, key_states: torch.Tensor,
                value_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """query_states (N, Lq, D), key/value_states (N, L, D),
        attention_mask (N, Lq, L) with 1 = attend."""
        if self.tp is not None:
            query_states, key_states, value_states = copy_inputs(
                self.tp, query_states, key_states, value_states)
        add_mask = (1.0 - attention_mask.float()[:, None]) * -10000.0
        q = self._heads(self.query(query_states))
        k = self._heads(self.key(key_states))
        v = self._heads(self.value(value_states))
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores / math.sqrt(self.d_head) + add_mask
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(probs, v).transpose(1, 2)
        ctx = ctx.reshape(ctx.shape[0], ctx.shape[1], -1)
        if self.tp is not None and self.gather_out:
            ctx = gather_from_model(ctx, self.tp, -1)
        return ctx

    # the cached greedy decode (inference, whole weights)

    def stacked_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """q, k and v's weights and biases stacked: one product a row."""
        return (torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]),
                torch.cat([self.query.bias, self.key.bias, self.value.bias]))

    def project(self, states: torch.Tensor,
                stacked: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The queries (N, H, L, d_head) and the keys and values (N, H, L,
        2, d_head) of `states` (N, L, D), from one product with the
        `stacked_weights`."""
        n, length, d = states.shape
        qkv = rows_linear(states, *stacked)
        kv = qkv[..., d:].view(n, length, 2, self.n_heads, self.d_head)
        return self._heads(qkv[..., :d]), kv.permute(0, 3, 1, 2, 4)

    def new_cache(self, states: torch.Tensor, length: int) -> torch.Tensor:
        """Zeroed keys and values (N, H, length, 2, d_head) for `project`'s
        rows."""
        return states.new_zeros(states.shape[0], self.n_heads, length, 2,
                                self.d_head)

    def attend(self, q: torch.Tensor, kv: torch.Tensor,
               add_mask: torch.Tensor) -> torch.Tensor:
        """forward's attention of the queries q (N, H, Lq, d_head) over the
        keys and values kv (N, H, L, 2, d_head); add_mask (N, Lq or 1, L)
        is the additive mask (`additive_mask`)."""
        scores = torch.matmul(q, kv[..., 0, :].transpose(-1, -2))
        scores = scores / math.sqrt(self.d_head) + add_mask[:, None]
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(probs, kv[..., 1, :]).transpose(1, 2)
        return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """The -10000 additive form of a 1 = attend mask, as
    BertSelfAttention.forward forms it."""
    return (1.0 - mask.float()) * -10000.0


def rows_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """F.linear(x, weight, bias) as the product, then the bias: for the
    cached decode's few rows (50 a token) cuBLAS's fused-bias path takes a
    split-K kernel at twice the time on an H100 in float32."""
    return F.linear(x, weight) + bias


class BertSelfOutput(nn.Module):
    """Dense -> dropout -> residual LN (reference :230)."""

    def __init__(self, cfg, in_size: Optional[int] = None) -> None:
        super().__init__()
        self.dense = Linear(in_size or cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden_states: torch.Tensor,
                input_tensor: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.dense(hidden_states))
        return self.LayerNorm(h + input_tensor)

    def decode_rows(self, hidden_states: torch.Tensor,
                    input_tensor: torch.Tensor) -> torch.Tensor:
        """forward for the cached decode's rows (`rows_linear`)."""
        h = self.dropout(rows_linear(hidden_states, self.dense.weight,
                                     self.dense.bias))
        return self.LayerNorm(h + input_tensor)


class BertAttention(nn.Module):
    """Self-attention block (reference :240). Under tensor parallelism
    with its output projection sharded by input, the rank's heads feed it
    their columns (Megatron's attention block)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def place_tp(self, mesh: Mesh, shards: Dict[str, int]):
        """Returns (the parameters placed, their partial gradients)."""
        inner = {k[len("self."):]: d for k, d in shards.items()
                 if k.startswith("self.")}
        if (shards.get("output.dense.weight") != 1
                or not self.self.heads_shardable(mesh, inner)):
            return set(), set()
        took, partial = self.self.place_heads(mesh, gather_out=False)
        place_linear(self.output.dense, "row", mesh, 1)
        return ({f"self.{n}" for n in took} | {"output.dense.weight"},
                {f"self.{n}" for n in partial})

    def forward(self, input_tensor: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self_out = self.self(input_tensor, input_tensor, input_tensor,
                             attention_mask)
        return self.output(self_out, input_tensor)


class BertIntermediate(nn.Module):
    """Dense + gelu (reference :259); under tensor parallelism
    column-parallel, its columns gathered."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.tp: Optional[Mesh] = None

    def place_tp(self, mesh: Mesh, shards: Dict[str, int]):
        """Returns (the parameters placed, their partial gradients)."""
        if shards.get("dense.weight") != 0:
            return set(), set()
        self.tp = mesh
        place_linear(self.dense, "column", mesh, 0)
        return {"dense.weight"}, {"dense.bias"}

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return gelu(self.dense(hidden_states))
        out = gelu(self.dense(copy_to_model(hidden_states, self.tp)))
        return gather_from_model(out, self.tp, -1)

    def decode_rows(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """forward for the cached decode's rows (`rows_linear`)."""
        return gelu(rows_linear(hidden_states, self.dense.weight,
                                self.dense.bias))


class BertOutput(BertSelfOutput):
    """Dense -> dropout -> residual LN back to hidden (reference :271)."""

    def __init__(self, cfg) -> None:
        super().__init__(cfg, in_size=cfg.intermediate_size)


# ---------- memory ----------

class MemoryInitializer(nn.Module):
    """Masked mean-pool + learned bias -> FC (reference :724)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.n_memory_cells = cfg.n_memory_cells
        self.init_memory_bias = nn.Parameter(
            torch.zeros(1, cfg.n_memory_cells, 1))
        self.init_memory_fc = nn.Sequential(
            nn.Linear(cfg.hidden_size, cfg.hidden_size),
            bert_layernorm(cfg, cfg.hidden_size),
            Dropout(cfg.memory_dropout_prob))

    def forward(self, input_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        mask = attention_mask.float()
        pooled = (input_states * mask[:, :, None]).sum(dim=1)
        pooled = pooled / mask.sum(dim=1, keepdim=True)
        pooled = pooled[:, None].repeat(1, self.n_memory_cells, 1)
        return self.init_memory_fc(pooled + self.init_memory_bias)


class MemoryUpdater(nn.Module):
    """Attention over states + GRU-style z/c gates (reference :751)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.memory_update_attention = BertSelfAttention(cfg)
        d = cfg.hidden_size
        self.mc = nn.Linear(d, d, bias=False)
        self.sc = nn.Linear(d, d)
        self.mz = nn.Linear(d, d, bias=False)
        self.sz = nn.Linear(d, d)

    def forward(self, prev_m: torch.Tensor, input_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        n_cells = prev_m.shape[1]
        update_mask = attention_mask.float()[:, None].repeat(1, n_cells, 1)
        s_t = self.memory_update_attention(prev_m, input_states,
                                           input_states, update_mask)
        c_t = torch.tanh(self.mc(prev_m) + self.sc(s_t))
        z_t = torch.sigmoid(self.mz(prev_m) + self.sz(s_t))
        return (1 - z_t) * c_t + z_t * prev_m


# ---------- layers / encoders ----------

class BertLayerNoMemory(nn.Module):
    """Plain joint-sequence layer (reference :334)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.max_v_len = cfg.max_v_len
        self.max_t_len = cfg.max_t_len
        self.attention = BertAttention(cfg)
        self.hidden_intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        shifted = make_pad_shifted_mask(attention_mask, self.max_v_len,
                                        self.max_t_len)
        att = self.attention(hidden_states, shifted)
        return self.output(self.hidden_intermediate(att), att)


class BertEncoderNoMemory(nn.Module):
    """Stack of no-memory layers (reference :359)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayerNoMemory(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            hidden_states = layer(hidden_states, attention_mask)
        return hidden_states


class BertLayerWithMemory(nn.Module):
    """Memory-augmented layer (reference :383)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        # the memory attention reads the intermediate states with
        # hidden-wide projections (as the reference does)
        assert cfg.intermediate_size == cfg.hidden_size, (
            "the memory layer needs intermediate_size == hidden_size")
        self.max_v_len = cfg.max_v_len
        self.max_t_len = cfg.max_t_len
        self.attention = BertAttention(cfg)
        self.memory_initilizer = MemoryInitializer(cfg)
        self.memory_updater = MemoryUpdater(cfg)
        self.memory_augmented_attention = BertSelfAttention(cfg)
        self.hidden_intermediate = BertIntermediate(cfg)
        self.memory_projection = nn.Linear(cfg.hidden_size,
                                           cfg.hidden_size)
        self.output = BertOutput(cfg)

    def forward(self, prev_m: Optional[torch.Tensor],
                hidden_states: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        shifted = make_pad_shifted_mask(attention_mask, self.max_v_len,
                                        self.max_t_len)
        att = self.attention(hidden_states, shifted)
        inter = self.hidden_intermediate(att)
        if prev_m is None:
            # first step: init memory from the video part only (:399-402)
            prev_m = self.memory_initilizer(
                inter, make_video_only_mask(attention_mask,
                                            self.max_v_len))
        updated_m = self.memory_updater(prev_m, inter, attention_mask)

        concat_mh = torch.cat([prev_m, inter], dim=1)
        bsz, n_cells = prev_m.shape[:2]
        raw_mask = torch.cat([attention_mask.new_ones(bsz, n_cells),
                              attention_mask], dim=-1)
        mem_mask = make_pad_shifted_mask(raw_mask, self.max_v_len,
                                         self.max_t_len, memory_len=n_cells)
        mem_att = self.memory_augmented_attention(inter, concat_mh,
                                                  concat_mh, mem_mask)
        layer_out = self.output(self.memory_projection(mem_att), att)
        return updated_m, layer_out

    # ---------- the cached greedy decode ----------
    # forward's rows, computed a position at a time. The text is causal
    # and the memory fixed within a sentence, so a row's keys and values
    # do not change once computed; masked columns add exp(-10000) = 0 in
    # float32, so a row over its visible prefix is forward's row. The
    # memory update is left to the sentence's full forward.

    def decode_prefix(self, prev_m: Optional[torch.Tensor],
                      hidden_states: torch.Tensor, masks: torch.Tensor
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The pass over the video rows `hidden_states` (N, V, D) once a
        sentence: (the layer's caches for `decode_token`, the rows'
        output). `masks` (N, L): the video mask, every text column 1 (a
        token step opens its own position). The caches hold both
        attentions' stacked weights and additive masks, and the keys and
        values of the self-attention over the L positions ("kv") and of
        the memory attention over the memory cells and the L positions
        ("mem_kv"), filled as far as the video rows."""
        n_video, length = hidden_states.shape[1], masks.shape[1]
        sa, ma = self.attention.self, self.memory_augmented_attention
        cache = {"sa": sa.stacked_weights(), "ma": ma.stacked_weights(),
                 "add": additive_mask(masks),
                 "kv": sa.new_cache(hidden_states, length)}
        att = self._decode_attention(cache, hidden_states, 0)
        inter = self.hidden_intermediate.decode_rows(att)
        if prev_m is None:
            prev_m = self.memory_initilizer(inter, masks[:, :n_video])
        n_cells = prev_m.shape[1]
        cache["mem_add"] = additive_mask(torch.cat(
            [masks.new_ones(masks.shape[0], n_cells), masks], dim=-1))
        cache["mem_kv"] = ma.new_cache(hidden_states, n_cells + length)
        cache["mem_kv"][:, :, :n_cells] = ma.project(prev_m, cache["ma"])[1]
        return cache, self._decode_memory(cache, att, inter, n_cells)

    def decode_token(self, cache: Dict[str, torch.Tensor],
                     hidden_state: torch.Tensor, pos: int) -> torch.Tensor:
        """forward's output row at position `pos` (N, 1, D) from its input
        row, attending over the positions up to `pos`; writes the row's
        keys and values into `cache`."""
        att = self._decode_attention(cache, hidden_state, pos)
        inter = self.hidden_intermediate.decode_rows(att)
        n_cells = cache["mem_kv"].shape[2] - cache["kv"].shape[2]
        return self._decode_memory(cache, att, inter, n_cells + pos)

    def _decode_attention(self, cache: Dict[str, torch.Tensor],
                          hidden: torch.Tensor, start: int) -> torch.Tensor:
        """The self-attention block's output of the rows of `hidden` at
        positions start.., over the positions up to their last; their
        keys and values written into the cache."""
        sa = self.attention.self
        stop = start + hidden.shape[1]
        q, kv = sa.project(hidden, cache["sa"])
        cache["kv"][:, :, start:stop] = kv
        ctx = sa.attend(q, cache["kv"][:, :, :stop],
                        cache["add"][:, None, :stop])
        return self.attention.output.decode_rows(ctx, hidden)

    def _decode_memory(self, cache: Dict[str, torch.Tensor],
                       att: torch.Tensor, inter: torch.Tensor,
                       start: int) -> torch.Tensor:
        """The layer's output of the rows of `inter` at the memory
        attention's positions start.. (after the memory cells), over the
        positions up to their last; their keys and values written into
        the cache."""
        ma = self.memory_augmented_attention
        stop = start + inter.shape[1]
        q, kv = ma.project(inter, cache["ma"])
        cache["mem_kv"][:, :, start:stop] = kv
        ctx = ma.attend(q, cache["mem_kv"][:, :, :stop],
                        cache["mem_add"][:, None, :stop])
        return self.output.decode_rows(
            rows_linear(ctx, self.memory_projection.weight,
                        self.memory_projection.bias), att)


class BertEncoderWithMemory(nn.Module):
    """Stack of memory layers threading per-layer memory (reference
    :433)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayerWithMemory(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, prev_ms: List[Optional[torch.Tensor]],
                hidden_states: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        prev_ms = list(prev_ms)
        for i, layer in enumerate(self.layer):
            prev_ms[i], hidden_states = layer(prev_ms[i], hidden_states,
                                              attention_mask)
        return prev_ms, hidden_states

    def decode_prefix(self, prev_ms: List[Optional[torch.Tensor]],
                      hidden_states: torch.Tensor, masks: torch.Tensor
                      ) -> List[Dict[str, torch.Tensor]]:
        """Every layer's caches after the video rows' pass
        (BertLayerWithMemory.decode_prefix)."""
        caches = []
        for prev_m, layer in zip(prev_ms, self.layer):
            cache, hidden_states = layer.decode_prefix(prev_m, hidden_states,
                                                       masks)
            caches.append(cache)
        return caches

    def decode_token(self, caches: List[Dict[str, torch.Tensor]],
                     hidden_state: torch.Tensor, pos: int) -> torch.Tensor:
        """The last layer's output row at position `pos`."""
        for cache, layer in zip(caches, self.layer):
            hidden_state = layer.decode_token(cache, hidden_state, pos)
        return hidden_state


# ---------- embeddings / head ----------

def _embedding_stack(cfg, in_size: int) -> nn.Sequential:
    """LN -> dropout -> Linear -> ReLU -> LN (reference :474-487)."""
    return nn.Sequential(
        bert_layernorm(cfg, in_size), Dropout(cfg.hidden_dropout_prob),
        nn.Linear(in_size, cfg.hidden_size), nn.ReLU(True),
        bert_layernorm(cfg, cfg.hidden_size))


class BertEmbeddingsWithVideo(nn.Module):
    """word + video + token-type embeddings summed, then PE + LN + dropout
    (reference :458); without the PE (`add_position_embeddings` false) for
    the TransformerXL, whose attention is relative."""

    def __init__(self, cfg, add_position_embeddings: bool = True) -> None:
        super().__init__()
        self.add_position_embeddings = add_position_embeddings
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.word_vec_size)
        self.word_fc = _embedding_stack(cfg, cfg.word_vec_size)
        self.video_embeddings = _embedding_stack(cfg,
                                                 cfg.video_feature_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        # the sincos table is not a parameter (the reference's `pe` buffer
        # is dropped when loading)
        self.register_buffer("position_table", torch.from_numpy(
            positional_encoding_table(cfg.max_position_embeddings,
                                      cfg.hidden_size)), persistent=False)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor, video_features: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        w = self.word_fc(self.word_embeddings(input_ids))
        v = self.video_embeddings(video_features)
        t = self.token_type_embeddings(token_type_ids)
        emb = w + v + t
        if self.add_position_embeddings:
            emb = emb + self.position_table[:input_ids.shape[-1]][None]
        return self.dropout(self.LayerNorm(emb))

    def decode_prefix(self, input_ids: torch.Tensor,
                      video_features: torch.Tensor,
                      token_type_ids: torch.Tensor, n_video: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cached greedy decode's embeddings once a sentence: forward
        of the first n_video rows, and the part of every later row that
        does not depend on its word (video + token type + position)."""
        rest = (self.video_embeddings(video_features[:, n_video:])
                + self.token_type_embeddings(token_type_ids[:, n_video:])
                + self.position_table[n_video:input_ids.shape[-1]][None])
        return self(input_ids[:, :n_video], video_features[:, :n_video],
                    token_type_ids[:, :n_video]), rest

    def decode_word(self, word_ids: torch.Tensor,
                    rest: torch.Tensor) -> torch.Tensor:
        """forward's row of the words `word_ids` (N, 1) given the row's
        `rest` from decode_prefix (N, 1, D)."""
        w = self.word_fc(self.word_embeddings(word_ids))
        return self.dropout(self.LayerNorm(w + rest))


class BertPredictionHeadTransform(nn.Module):
    """Dense -> gelu -> LN (reference :790)."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = bert_layernorm(cfg, cfg.hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(gelu(self.dense(hidden_states)))

    def decode_rows(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """forward for the cached decode's rows (`rows_linear`)."""
        return self.LayerNorm(gelu(rows_linear(
            hidden_states, self.dense.weight, self.dense.bias)))


class BertLMPredictionHead(nn.Module):
    """Transform + decoder matrix + bias (reference :802). Under
    share_wd_cls_weight the decoder's weight IS the word-embedding matrix
    `word_embeddings` (one Parameter: it takes the gradient of both uses
    and is decayed and clipped once; the state dict keeps both reference
    keys), logits = transform(h) @ E^T + bias (JAX mart.py:42-46)."""

    def __init__(self, cfg, word_embeddings: Optional[nn.Embedding] = None
                 ) -> None:
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias=False)
        if cfg.share_wd_cls_weight:
            if word_embeddings is None:  # JAX asserts (bert.py:436)
                raise ValueError("share_wd_cls_weight ties the head to the "
                                 "word embeddings of the joint models; this "
                                 "model passes none")
            self.decoder.weight = word_embeddings.weight
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(hidden_states)) + self.bias

    def decode_rows(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """forward for the cached decode's rows (`rows_linear`; the
        decoder matrix has no bias of its own)."""
        return (self.decoder(self.transform.decode_rows(hidden_states))
                + self.bias)


def init_bert_weights(module: nn.Module, std: float,
                      generator: torch.Generator) -> None:
    """Weights normal(0, std), biases zero, LN ones/zeros, memory bias
    normal(0, 1) (reference init_bert_weights :1401-1413)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MemoryInitializer):
                m.init_memory_bias.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, BertLMPredictionHead):
                m.bias.zero_()
