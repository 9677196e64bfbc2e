"""
Generate the yc2-scale synthetic retrieval dataset under <root>/yc2like/
(port of data_gen_yc2like.py at the repo root):

    python -m coot_videotext_tpu_torch.data_gen_yc2like [--data_path data] \\
        [--feat_format h5|npy]

A deterministic (seed 0) 1/6-scale YouCook2 "2d3d" lookalike: 192 train /
48 val videos, ~7.7 clips and sentences a video, 4096-d video features at
1 fps, 1536-d text features, paired through a shared latent per clip so
that retrieval is learnable (data/synthetic.py RETRIEVAL_PRESETS). The
arrays are those of the JAX package's generator for the seed, written as
h5 where h5py is installed and as the `npy` feature source otherwise.
Prints the dataset config overrides.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from coot_videotext_tpu_torch.data.synthetic import generate_preset


def run_preset(name: str, description: str,
               argv: Optional[List[str]] = None) -> Dict[str, str]:
    """The command line of a dataset preset."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--data_path", default="data",
                        help="root of the datasets (default: data)")
    parser.add_argument("--feat_format", choices=("h5", "npy"),
                        default=None,
                        help="h5 (default where h5py is installed) or npy")
    args = parser.parse_args(argv)
    overrides = generate_preset(name, args.data_path,
                                feat_format=args.feat_format)
    print(f"generated {args.data_path}/{name}; dataset config overrides:")
    print(overrides)
    return overrides


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    return run_preset("yc2like", __doc__, argv)


if __name__ == "__main__":
    main()
