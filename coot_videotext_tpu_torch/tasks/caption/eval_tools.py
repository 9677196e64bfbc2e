"""
Copy of coot_videotext_tpu/tasks/caption/eval_tools.py (pure Python; the
port keeps its own copy so it never imports the JAX package).

Reference-file lookup for caption evaluation
(port of mart/caption_eval_tools.py:11).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

from coot_videotext_tpu_torch.utils.general import TrainerPathConst


def get_reference_files(
        dset_name: str,
        annotations_dir: Union[str, Path] = TrainerPathConst.DIR_ANNOTATIONS
) -> Dict[str, List[Path]]:
    annotations_dir = Path(annotations_dir) / dset_name
    if dset_name == "activitynet":
        return {
            "val": [annotations_dir / "captioning_val_1_para.json",
                    annotations_dir / "captioning_val_2_para.json"],
            "test": [annotations_dir / "captioning_test_1_para.json",
                     annotations_dir / "captioning_test_2_para.json"]}
    if dset_name == "youcook2":
        return {"val": [annotations_dir / "captioning_val_para.json"]}
    raise ValueError(f"Dataset unknown {dset_name}")
