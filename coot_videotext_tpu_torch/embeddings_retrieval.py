"""
Retrieval metrics of saved COOT embeddings:

    python -m coot_videotext_tpu_torch.embeddings_retrieval \\
        <embeddings_<ep>.h5 or .npz> [--device cpu]

video-paragraph and clip-sentence retrieval (tasks/retrieval/eval.py,
ranks on the device) over the embedding export of the retrieval trainer:
h5 (the JAX trainer's schema) or the port's npz of the same arrays. Files
of the reference's older schema (`vid_norm`, `par_norm`, `clip_norm`,
`sent_norm`) are read under the current names. Port of
test_embeddings_retrieval.py at the repo root (reference
test_embeddings_retrieval.py). Runs on the CUDA device unless `--device
cpu` is given.
"""

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from coot_videotext_tpu_torch.tasks.retrieval import eval as retrieval
from coot_videotext_tpu_torch.train_retrieval import resolve_device
from coot_videotext_tpu_torch.utils.arguments import ArgParser

KEYS = ("vid_emb", "par_emb", "clip_emb", "sent_emb")
LEGACY_KEYS = {"vid_emb": "vid_norm", "par_emb": "par_norm",
               "clip_emb": "clip_norm", "sent_emb": "sent_norm"}


def load_embeddings(path: Path) -> Dict[str, np.ndarray]:
    """The four embedding sets of an h5 or npz export, legacy keys
    mapped."""
    if path.suffix == ".npz":
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    else:
        import h5py
        with h5py.File(path, "r") as h5:
            arrays = {k: np.asarray(h5[k]) for k in h5}
    if "vid_emb" not in arrays:  # backwards compatibility
        return {tgt: arrays[src] for tgt, src in LEGACY_KEYS.items()}
    return {key: arrays[key] for key in KEYS}


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    parser = ArgParser(description=__doc__)
    parser.add_argument("path_to_embeddings", type=str,
                        help="Path to the h5 or npz embeddings file.")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    path = Path(args.path_to_embeddings)
    print(f"Testing retrieval on embeddings: {path}")
    data = load_embeddings(path)
    print(retrieval.VALHEADER)
    v2p, p2v, _, _ = retrieval.compute_retrieval(data, "vid_emb",
                                                 "par_emb", device)
    c2s, s2c, _, _ = retrieval.compute_retrieval(data, "clip_emb",
                                                 "sent_emb", device)
    return {"v2p": v2p, "p2v": p2v, "c2s": c2s, "s2c": s2c}


if __name__ == "__main__":
    main()
