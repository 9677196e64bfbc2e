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

Two more marks bound a stretch inside a phase (`MARKS`): `relattn` and
`relattn_end` around each relative attention of the TransformerXL, in
the forward and, through `Bracket`, again in the backward.
"""

from __future__ import annotations

import torch

from coot_videotext_tpu_torch.ops import cuda_build

PHASES = {"forward": 0, "backward": 1, "optimizer": 2, "end": 3}
MARKS = {**PHASES, "relattn": 4, "relattn_end": 5}
KERNEL_PREFIX = "phase_mark_"


def mark(phase: str, like: torch.Tensor) -> None:
    """The mark of `phase` (a key of MARKS) on the current stream of
    `like`'s device; nothing on the CPU."""
    if like.device.type != "cuda":
        return
    err = cuda_build.load_library().coot_phase_mark(
        MARKS[phase], cuda_build.stream(like))
    cuda_build.check(err, KERNEL_PREFIX + phase)


class Bracket(torch.autograd.Function):
    """The identity on `x` that launches the mark `forward_mark` where the
    forward passes it and `backward_mark` where its gradient passes it
    back, so that a stretch bracketed in the forward is bracketed again,
    the other way round, in the backward. The gradient is passed on as
    it is."""

    @staticmethod
    def forward(ctx, x, forward_mark: str, backward_mark: str):
        ctx.backward_mark = backward_mark
        mark(forward_mark, x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mark(ctx.backward_mark, grad)
        return grad, None, None
