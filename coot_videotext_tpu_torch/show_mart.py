"""
Show results of original-MART experiment trees (the legacy "mart"
experiment type, laid out as the caption type):

    python -m coot_videotext_tpu_torch.show_mart [--log_dir experiments] ...

with show_caption's flags and table. Port of show_mart.py at the repo
root (reference show_mart.py). Pure Python: no device.
"""

from typing import List, Optional

from coot_videotext_tpu_torch.show_caption import show_text_results

EXP_TYPE = "mart"


def main(argv: Optional[List[str]] = None) -> None:
    show_text_results(EXP_TYPE, argv, __doc__)


if __name__ == "__main__":
    main()
