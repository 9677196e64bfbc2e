"""
Standalone METEOR health check with the PyTorch package (the repo's
meteor_test.py, :11-25, through the port's tasks/caption/metrics/meteor.py):
prints where the METEOR jar is, then whether the Java scorer starts and
scores a trivial pair, or why caption evaluation reports -999 for METEOR.

    python -m coot_videotext_tpu_torch.meteor_test

The jar is $METEOR_JAR, or the one that pycocoevalcap ships.
"""

from __future__ import annotations

from coot_videotext_tpu_torch.tasks.caption.metrics.meteor import (
    find_meteor_jar, make_meteor)


def main() -> None:
    jar = find_meteor_jar()
    print(f"METEOR jar: {jar}")
    scorer = make_meteor()
    if scorer is None:
        print("METEOR unavailable (no java or no jar); caption eval "
              "will report -999 for METEOR (same crash semantics as the "
              "reference, mart/evaluate_language.py:63).")
        return
    gts = {0: ["this is a cat"]}
    res = {0: ["this is a cat"]}
    score, _ = scorer.compute_score(gts, res)
    print(f"METEOR ok, identity score: {score:.4f}")
    scorer.close()


if __name__ == "__main__":
    main()
