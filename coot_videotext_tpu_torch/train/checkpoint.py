"""
Checkpoint save and restore with torch.save / torch.load.

Counterpart of coot_videotext_tpu/train/checkpoint.py (orbax there). The
model file is the reference `.pth` layout, {net_name: state_dict}
(reference trainer_base.py:672-716), which RetrievalModelManager.load_file
and the JAX package's torch converter read as they are; the optimizer state
(moments, step, the run's generator states) goes in its own file. Files are
written to a temporary name and renamed, so an interrupted save leaves the
previous checkpoint intact.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Union

import torch


def save(path: Union[str, Path], obj: Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: Union[str, Path]) -> Any:
    """Tensors come back on the CPU; only tensors and plain containers
    are accepted (weights_only)."""
    return torch.load(path, map_location="cpu", weights_only=True)
