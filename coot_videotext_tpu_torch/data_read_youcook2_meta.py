"""
Convert the official YouCook2 annotation release
(annotations/youcook2/youcookii_annotations_trainval.json, relative to the
working directory) into <data_path>/youcook2/meta_all.json:

    python -m coot_videotext_tpu_torch.data_read_youcook2_meta \\
        [--data_path data]

Port of data_read_youcook2_meta.py at the repo root (output contract of
the reference tool data_read_youcook2_meta.py); the conversion is
data/meta_convert.py. Pure Python: no device.
"""

import json
from pathlib import Path
from typing import List, Optional

from coot_videotext_tpu_torch.data.meta_convert import convert_youcook2
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser

ANNOTATIONS = Path("annotations/youcook2/youcookii_annotations_trainval.json")


def main(argv: Optional[List[str]] = None) -> Path:
    parser = ArgParser(description=__doc__)
    arguments.add_path_args(parser)
    args = parser.parse_args(argv)
    data_root = Path(args.data_path if args.data_path is not None
                     else arguments.DEFAULT_DATA_PATH)

    release = json.loads(ANNOTATIONS.read_text(encoding="utf8"))
    meta = convert_youcook2(release["database"])

    out_file = data_root / "youcook2" / "meta_all.json"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(meta, sort_keys=True), encoding="utf8")
    print(f"{len(meta)} videos from {ANNOTATIONS} -> {out_file}")
    return out_file


if __name__ == "__main__":
    main()
