"""
Convert the ActivityNet Captions release (annotations/activitynet/
{train,val_1,val_2}.json, relative to the working directory) into
<data_path>/activitynet/meta_all.json:

    python -m coot_videotext_tpu_torch.data_read_activitynet_meta \\
        [--data_path data]

Port of data_read_activitynet_meta.py at the repo root (output contract
of the reference tool: inverted timestamps swapped, ids keyed
<ytid>_<split>); the conversion is data/meta_convert.py. Pure Python: no
device.
"""

import json
from pathlib import Path
from typing import List, Optional

from coot_videotext_tpu_torch.data.meta_convert import convert_activitynet
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser

ANNOTATIONS_DIR = Path("annotations/activitynet")
SPLITS = ("train", "val_1", "val_2")


def main(argv: Optional[List[str]] = None) -> Path:
    parser = ArgParser(description=__doc__)
    arguments.add_path_args(parser)
    args = parser.parse_args(argv)
    data_root = Path(args.data_path if args.data_path is not None
                     else arguments.DEFAULT_DATA_PATH)

    release = {
        split: json.loads(
            (ANNOTATIONS_DIR / f"{split}.json").read_text(encoding="utf8"))
        for split in SPLITS}
    meta, swapped = convert_activitynet(release)
    for item in swapped:
        print(f"swapped inverted segment timestamps in {item}")

    out_file = data_root / "activitynet" / "meta_all.json"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(meta, sort_keys=True), encoding="utf8")
    print(f"{len(meta)} datapoints from {ANNOTATIONS_DIR} -> {out_file}")
    return out_file


if __name__ == "__main__":
    main()
