"""
Phase marks of the train steps: an empty kernel at each boundary of a
step (csrc/phase.cu), `phase_mark_<phase>` by name, launched on the
current stream. A captured step replays as one unbroken stream of
kernels; its marks split that stream in a device trace into the forward
(from the forward mark, before the batch is sampled), the backward (from
the backward mark, before `torch.autograd.grad`) and the optimizer (from
the optimizer mark, after the gradients and their reduction over a mesh:
clipping, the update, the EMA) up to the end mark.

They are always on, captured into every train graph and launched by the
eager steps too: four launches of no work a step. On a CPU tensor `mark`
does nothing. They are not counted in `cuda_build.launch_counts`, which
counts the kernels B1-B5.
"""

from __future__ import annotations

import torch

from coot_videotext_tpu_torch.ops import cuda_build

PHASES = {"forward": 0, "backward": 1, "optimizer": 2, "end": 3}
KERNEL_PREFIX = "phase_mark_"


def mark(phase: str, like: torch.Tensor) -> None:
    """The mark of `phase` (a key of PHASES) on the current stream of
    `like`'s device; nothing on the CPU."""
    if like.device.type != "cuda":
        return
    err = cuda_build.load_library().coot_phase_mark(
        PHASES[phase], cuda_build.stream(like))
    cuda_build.check(err, KERNEL_PREFIX + phase)
