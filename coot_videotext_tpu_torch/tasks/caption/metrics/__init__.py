"""Native caption metrics (BLEU / ROUGE-L / CIDEr-D / METEOR wrapper), a
copy of coot_videotext_tpu/tasks/caption/metrics.

The reference delegates to the `pycocoevalcap` pip package (BLEU, ROUGE-L,
CIDEr are pure python there; METEOR is a Java subprocess). This package
reimplements the same algorithms natively so the framework is hermetic;
METEOR keeps the reference's crash-tolerant -999 semantics
(mart/evaluate_language.py:63-68,168-182) when no Java/jar is available.
"""

from coot_videotext_tpu_torch.tasks.caption.metrics.bleu import (  # noqa
    BleuScorer)
from coot_videotext_tpu_torch.tasks.caption.metrics.cider import Cider  # noqa
from coot_videotext_tpu_torch.tasks.caption.metrics.rouge import Rouge  # noqa
from coot_videotext_tpu_torch.tasks.caption.metrics.meteor import (  # noqa
    make_meteor)
