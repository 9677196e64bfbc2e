"""
COOT retrieval model: 4 cooperative transformer networks (video
local/global, text local/global).

Counterpart of coot_videotext_tpu/models/retrieval.py: `_encode_hierarchy`
:41 and `RetrievalModel` :125 (reference coot/model_retrieval.py:57-197).
Both part layouts of JAX: the dense (B, N, Lp, D) one (:93-111), whose
padded part slots are zeroed with `where` before the global net, and the
packed (P, Lp, D) one of on-device sampling (:80-92). Deliberate
differences:
    - the compute dtype is an argument of `forward` (parameters stay
      float32), not a property of the module.
    - on CUDA tensors the local nets' input stage, every attention core and
      every GenPool always run the hand-written kernels B1-B3; there is no
      size-based or environment switch back to plain PyTorch.
Mask convention: True = valid.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from coot_videotext_tpu_torch.models.transformer import CootTransformer
from coot_videotext_tpu_torch.typext import ConstantHolder


# the lengths that the nets pool over: a sequence's, its parts', its count
# of parts
LENGTH_KEYS = ("vid_len", "clip_len", "clip_num", "par_len", "sent_len",
               "sent_num")


class RetrievalNetworksConst(ConstantHolder):
    """The 4 network names (reference configs_retrieval.py:182)."""
    NET_VIDEO_LOCAL = "net_video_local"
    NET_VIDEO_GLOBAL = "net_video_global"
    NET_TEXT_LOCAL = "net_text_local"
    NET_TEXT_GLOBAL = "net_text_global"


def _encode_hierarchy(net_local: CootTransformer,
                      net_global: CootTransformer, batch, prefix: str,
                      part: str, dtype: torch.dtype,
                      max_lengths: Optional[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """
    Shared video/text hierarchy encoding (reference encode_visual :86 /
    encode_text :143) of `batch`'s `<prefix>_*` sequence (video frames /
    paragraph tokens: feat (B, L, D), mask (B, L), len (B,)) and `<part>_*`
    parts (clips / sentences): valid (B, N) True where the slot holds a
    real part, num (B,), and feat/mask/len either dense (B, N, Lp, D) /
    (B, N, Lp) / (B, N) or packed (P, Lp, D) / (P, Lp) / (P,) with
    `<part>_owner`, `<part>_pos` and `<part>_slot_valid` (P,).
    `max_lengths`: the global batch's longest `<prefix>_len`, `<part>_len`
    and `<part>_num` (`LENGTH_KEYS`) under data parallelism, else None.
    """
    def longest(key: str) -> Optional[torch.Tensor]:
        return None if max_lengths is None else max_lengths[key]

    context, _ = net_local(batch[f"{prefix}_feat"].to(dtype),
                           batch[f"{prefix}_mask"], batch[f"{prefix}_len"],
                           max_length=longest(f"{prefix}_len"))
    part_feat = batch[f"{part}_feat"]
    part_valid = batch[f"{part}_valid"]
    b, n = part_valid.shape
    if part_feat.dim() == 3:  # packed: the local net sees real parts only
        part_emb_flat, _ = net_local(part_feat.to(dtype),
                                     batch[f"{part}_mask"],
                                     batch[f"{part}_len"],
                                     max_length=longest(f"{part}_len"))
        slot_valid = batch[f"{part}_slot_valid"]
        # `where`, not multiply, then a collision-free scatter into zeros:
        # unpacked slots keep zeros, as the dense layout's where gives,
        # and the scatter's backward is a gather
        contrib = torch.where(slot_valid[:, None], part_emb_flat,
                              torch.zeros_like(part_emb_flat))
        part_emb = contrib.new_zeros((b, n, contrib.shape[-1])).index_put(
            (batch[f"{part}_owner"].long(), batch[f"{part}_pos"].long()),
            contrib)
    else:
        _, _, lp, d = part_feat.shape
        part_emb, _ = net_local(part_feat.reshape(b * n, lp, d).to(dtype),
                                batch[f"{part}_mask"].reshape(b * n, lp),
                                batch[f"{part}_len"].reshape(b * n),
                                max_length=longest(f"{part}_len"))
        part_emb = part_emb.view(b, n, -1)
        # zero padded part slots: the reference scatters local embeddings
        # into a zero-initialized (B, max_parts, D) tensor
        # (model_retrieval.py:124-136), and the global net's unmasked
        # avg_special pool sees them
        part_emb = torch.where(part_valid[..., None], part_emb,
                               torch.zeros_like(part_emb))
    part_num = batch[f"{part}_num"]
    hidden = context if net_global.cfg.use_context else None
    emb, _ = net_global(part_emb, part_valid, part_num, hidden,
                        max_length=longest(f"{part}_num"))
    return {"emb": emb, "part_emb": part_emb, "context": context}


class RetrievalModel(nn.Module):
    """The 4-network COOT model. Input dims chain as in the reference
    (:68-73): video_local <- vid_feat_dim, video_global <- video_local's
    output dim; likewise for text."""

    def __init__(self, model_cfgs, vid_feat_dim: int, text_feat_dim: int,
                 max_len: int = 1024) -> None:
        super().__init__()
        c = RetrievalNetworksConst
        self.net_video_local = CootTransformer(
            model_cfgs[c.NET_VIDEO_LOCAL], vid_feat_dim, max_len=max_len,
            input_is_data=True)
        self.net_video_global = CootTransformer(
            model_cfgs[c.NET_VIDEO_GLOBAL], self.net_video_local.output_dim,
            max_len=max_len)
        self.net_text_local = CootTransformer(
            model_cfgs[c.NET_TEXT_LOCAL], text_feat_dim, max_len=max_len,
            input_is_data=True)
        self.net_text_global = CootTransformer(
            model_cfgs[c.NET_TEXT_GLOBAL], self.net_text_local.output_dim,
            max_len=max_len)

    def nets(self) -> Dict[str, CootTransformer]:
        return {name: getattr(self, name)
                for name in RetrievalNetworksConst.values()}

    def reset_parameters(self, generator: Optional[torch.Generator]
                         ) -> None:
        for net in self.nets().values():
            net.reset_parameters(generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype = torch.float32,
                max_lengths: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Both branches (reference model_retrieval.py:86/:143); output
        keys as the JAX model. `max_lengths`: the global batch's longest
        lengths (`LENGTH_KEYS`) under data parallelism; None: the
        batch's."""
        vis = _encode_hierarchy(self.net_video_local, self.net_video_global,
                                batch, "vid", "clip", compute_dtype,
                                max_lengths)
        txt = _encode_hierarchy(self.net_text_local, self.net_text_global,
                                batch, "par", "sent", compute_dtype,
                                max_lengths)
        return {
            "vid_emb": vis["emb"], "clip_emb": vis["part_emb"],
            "vid_context": vis["context"],
            "clip_valid": batch["clip_valid"], "clip_num": batch["clip_num"],
            "par_emb": txt["emb"], "sent_emb": txt["part_emb"],
            "par_context": txt["context"],
            "sent_valid": batch["sent_valid"], "sent_num": batch["sent_num"],
        }
