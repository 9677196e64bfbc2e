"""
Retrieval model manager: builds the 4-network COOT model on a device with
a seeded init, and names its train and val compute dtypes.

Port of coot_videotext_tpu/tasks/retrieval/model_manager.py. Parameters
are float32; the compute dtype is bfloat16 where the config asks for fp16
(`compute_dtype` for training, `fp16_val` for validation) and float32
otherwise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from coot_videotext_tpu_torch.models.retrieval import (
    RetrievalModel, RetrievalNetworksConst)

# reference checkpoint entries that are buffers, not parameters here
# (JAX utils/torch_convert.py _SKIP_PATTERNS for the COOT nets)
_SKIP_SUFFIXES = ("embedding.pe", ".fixed_ones", ".genpool_one",
                  ".num_batches_tracked")


def dtype_from_name(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.bfloat16}[name]


class RetrievalModelManager:
    """Owns the model and its compute dtypes."""

    def __init__(self, cfg, device: torch.device, seed: int = 0) -> None:
        self.cfg = cfg
        self.device = device
        self.train_dtype = dtype_from_name(cfg.compute_dtype)
        self.val_dtype = torch.bfloat16 if cfg.fp16_val else torch.float32
        self.model = RetrievalModel(
            cfg.model_cfgs, cfg.dataset_train.vid_feat_dim,
            cfg.dataset_train.text_feat_dim)
        generator = torch.Generator().manual_seed(seed)
        self.model.reset_parameters(generator)
        self.model.to(device).eval()
        self.was_loaded = False

    def count_parameters(self) -> int:
        return sum(int(np.prod(p.shape)) for p in self.model.parameters())

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{net_name: state_dict}, the reference model_<ep>.pth layout."""
        return {name: net.state_dict()
                for name, net in self.model.nets().items()}

    def load_state(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load {net_name: state_dict} (a reference .pth loads as it is:
        its non-parameter buffers are dropped). Strict on everything
        else."""
        if set(state) != set(RetrievalNetworksConst.values()):
            raise ValueError(f"expected the 4 COOT nets, got {sorted(state)}")
        for name, net in self.model.nets().items():
            sd = {k: v for k, v in state[name].items()
                  if not k.endswith(_SKIP_SUFFIXES)}
            net.load_state_dict(sd, strict=True)
        self.was_loaded = True

    def load_file(self, path: str) -> None:
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.load_state(state)
