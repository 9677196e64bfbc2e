"""
Caption model factory and manager.

Port of coot_videotext_tpu/tasks/caption/model_manager.py (reference
mart/model.py:45 create_mart_model and mart/trainer_caption.py:89
MartModelManager): builds the model of the config's family (the recurrent
MART model, the TransformerXL, the untied or joint single-sentence model,
or the MTransformer; JAX :71-87) on one device from a seed, loads the
GloVe word vectors from the cache (reference :79-85) and a
reference-layout checkpoint `{"model": state_dict}`.

GloVe loads into the word-embedding table when its shape matches (JAX
:119-121): not into a decoder tied at word_vec_size = hidden_size, whose
table is wider than the cache's 300-d vectors. The MTransformer has no
word-embedding table (its word vectors are the output matrix, tied), so
GloVe has nothing to load into: its init stays and a warning says so. The
JAX package's `apply_glove` raises KeyError 'embeddings' there
(model_manager.py:111-126).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from coot_videotext_tpu_torch.models.caption.mart import (
    NonRecurTransformer, RecursiveTransformer)
from coot_videotext_tpu_torch.models.caption.mtransformer import (
    MTransformer)
from coot_videotext_tpu_torch.models.caption.untied import (
    NonRecurTransformerUntied)
from coot_videotext_tpu_torch.models.caption.xl import TransformerXL
from coot_videotext_tpu_torch.utils.param_bridge import load_mart_checkpoint


def load_glove_matrix(cache_dir: str, dataset_name: str) -> np.ndarray:
    """Load `<dset>_vocab_glove.pt` (a torch-saved float array).

    The released cache is a legacy numpy pickle; rather than full pickle
    deserialization only the exact numpy constructors it needs are
    allowlisted under weights_only=True. The pickled module path is the
    pre-numpy-2 "numpy.core.…", so the callable is registered under that
    historical name explicitly.
    """
    path = Path(cache_dir) / f"{dataset_name}_vocab_glove.pt"
    try:
        from numpy._core import multiarray as _multiarray
    except ImportError:  # numpy < 2
        from numpy.core import multiarray as _multiarray
    safe = [(_multiarray._reconstruct, "numpy.core.multiarray._reconstruct"),
            np.ndarray, np.dtype]
    try:
        from numpy import dtypes as _np_dtypes
        safe += [_np_dtypes.Float32DType, _np_dtypes.Float64DType]
    except ImportError:
        pass
    with torch.serialization.safe_globals(safe):
        arr = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(arr, "numpy"):
        arr = arr.numpy()
    return np.asarray(arr, np.float32)


CaptionModel = Union[RecursiveTransformer, TransformerXL,
                     NonRecurTransformerUntied, MTransformer,
                     NonRecurTransformer]


def check_serving_config(cfg) -> None:
    """Raise for what the JAX package refuses too: beam search decodes the
    recurrent MART model only (JAX translator.py:592-596)."""
    if cfg.use_beam and (not cfg.recurrent or cfg.xl):
        raise ValueError("beam search is wired for the recurrent MART "
                         "model: set use_beam false for the xl, untied, "
                         "joint single-sentence and masked transformer "
                         "models")


def model_family(cfg) -> type:
    """The caption model class of the config (JAX :71-87)."""
    if cfg.recurrent:
        return TransformerXL if cfg.xl else RecursiveTransformer
    if cfg.untied:
        return NonRecurTransformerUntied
    return MTransformer if cfg.mtrans else NonRecurTransformer


def create_mart_model(cfg, vocab_size: int, device: torch.device, *,
                      seed: int = 0) -> CaptionModel:
    """The caption model of this config on `device`, initialized from
    `seed` (reference :45), f32."""
    check_serving_config(cfg)
    cfg.max_position_embeddings = cfg.max_v_len + cfg.max_t_len
    cfg.vocab_size = vocab_size
    model = model_family(cfg)(
        cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(device)


class MartModelManager:
    """Owns the caption model on one device."""

    def __init__(self, cfg, model: CaptionModel,
                 device: torch.device, *,
                 cache_dir: str = "cache_caption") -> None:
        self.cfg = cfg
        self.model = model
        self.device = device
        self.cache_dir = cache_dir
        self.was_loaded = False

    def apply_glove(self) -> bool:
        """Replace the word embeddings with the GloVe vectors (reference
        :79-85); keeps the init when the cache is missing or its shape
        differs (a decoder tied at hidden width), as the JAX package does,
        and when the model has no word-embedding table (the MTransformer),
        with a warning. Returns whether it applied."""
        if isinstance(self.model, MTransformer):
            logging.getLogger(__name__).warning(
                "use_glove: the MTransformer's word vectors are its output "
                "matrix (tied), it has no word-embedding table to load "
                "GloVe into; keeping the initialization")
            return False
        try:
            glove = load_glove_matrix(self.cache_dir,
                                      self.cfg.dataset_train.name)
        except (FileNotFoundError, OSError):
            return False
        weight = self.model.embeddings.word_embeddings.weight
        if tuple(glove.shape) != tuple(weight.shape):
            return False
        with torch.no_grad():
            weight.copy_(torch.from_numpy(glove))
        return True

    def load_state(self, state: Dict[str, Any]) -> None:
        """A reference-layout `{"model": state_dict}`."""
        load_mart_checkpoint(self.model, state)
        self.was_loaded = True

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The reference layout, tensors on the CPU."""
        return {"model": {k: v.detach().cpu() for k, v in
                          self.model.state_dict().items()}}

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.model.parameters())


def build_mart_model_manager(cfg, vocab_size: int, device: torch.device,
                             *, seed: int = 0,
                             cache_dir: str = "cache_caption",
                             ) -> MartModelManager:
    """Model from `seed`, GloVe applied when the config asks for it."""
    mgr = MartModelManager(
        cfg, create_mart_model(cfg, vocab_size, device, seed=seed), device,
        cache_dir=cache_dir)
    if cfg.use_glove:
        mgr.apply_glove()
    return mgr
