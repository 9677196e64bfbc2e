"""
Generate the reference-scale synthetic retrieval dataset under
<root>/yc2big/ (port of data_gen_yc2big.py at the repo root):

    python -m coot_videotext_tpu_torch.data_gen_yc2big [--data_path data] \\
        [--feat_format h5|npy]

A deterministic (seed 0) YouCook2 "2d3d" lookalike at the reference's
split sizes: 1333 train / 457 val videos with data_gen_yc2like's per-video
distribution, signal_scale 0.55 and modality_noise 0.7 (each modality sees
its own noised copy of every clip latent, which caps retrieval near the
real yc2_2d3d regime). About 9.5 GB on disk; the arrays are those of the
JAX package's generator for the seed, as h5 where h5py is installed and
as the `npy` feature source otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from coot_videotext_tpu_torch.data_gen_yc2like import run_preset


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    return run_preset("yc2big", __doc__, argv)


if __name__ == "__main__":
    main()
