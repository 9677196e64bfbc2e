"""
B4 dropout: y = x * keep / (1 - rate), keep iff Philox bits >=
floor(rate * 2^32); the backward applies the same mask, regenerated from
(seed, site), to the cotangent. The seed is a `philox.Seed` (the step's
seed state on the device and the call's position); the kernel derives it
on the device, the plain version with PyTorch ops on the state's device.

Counterpart of coot_videotext_tpu/ops/pallas_dropout.py::hw_dropout :98
with the semantics of the module's Dropout (models/layers.py:38). On a CUDA
tensor `dropout` launches the Hopper kernel in csrc/dropout.cu (forward
and backward); on a CPU tensor it computes `dropout_plain` with the same
bits (ops/philox.py).

The train step launches B4 48 times (24 forward, 24 backward), so the
host's time per call counts: the forward checks its input and computes the
launch arguments once (`launch_args`); the backward reuses them, since
autograd hands it a cotangent of the output's dtype and device on the
forward's stream, and only makes it contiguous.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coot_videotext_tpu_torch.ops import cuda_build, philox
from coot_videotext_tpu_torch.ops.common import is_bf16

KERNEL = "dropout"


def dropout_plain(x: torch.Tensor, seed: philox.SeedLike, rate: float,
                  site: int = philox.SITE_DROPOUT) -> torch.Tensor:
    """Plain version: the keep factor in float32, the product rounded to
    x.dtype, as the kernel does."""
    f = philox.keep_factor(x.shape, seed, site, rate, x.device)
    return (x.float() * f).to(x.dtype)


class LaunchArgs(NamedTuple):
    """What `coot_dropout` takes besides the pointers and the count."""
    state: int
    call: int
    thresh: int
    scale: float
    site: int
    bf16: int
    stream: int


def launch_args(x: torch.Tensor, seed: philox.Seed, rate: float, site: int,
                stream: int = 0) -> LaunchArgs:
    """The checked launch arguments of a call on x (float32 or bfloat16);
    `stream` is the CUDA stream handle the kernel goes to."""
    return LaunchArgs(philox.state_pointer(seed, x.device), seed.call,
                      philox.threshold(rate), 1.0 / (1.0 - rate), site,
                      int(is_bf16(KERNEL, x)), stream)


def launch(x: torch.Tensor, args: LaunchArgs, name: str) -> torch.Tensor:
    """One kernel launch on a contiguous CUDA tensor x."""
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        err = cuda_build.load_library().coot_dropout(
            x.data_ptr(), y.data_ptr(), n, *args)
        cuda_build.check(err, name)
        cuda_build.launch_counts[name] += 1
    return y


class _Dropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, seed, rate, site):
        if x.device.type == "cpu":
            ctx.params = (seed, rate, site)
            return dropout_plain(x, seed, rate, site)
        if x.device.type != "cuda":
            raise ValueError(f"{KERNEL}: unsupported device {x.device}")
        ctx.args = launch_args(x, seed, rate, site, cuda_build.stream(x))
        return launch(x.contiguous(), ctx.args, KERNEL)

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return dropout_plain(g, *ctx.params), None, None, None
        return launch(g.contiguous(), ctx.args, KERNEL + "_bwd"), None, \
            None, None


def dropout(x: torch.Tensor, seed: philox.Seed, rate: float,
            site: int = philox.SITE_DROPOUT) -> torch.Tensor:
    """
    Args:
        x: any shape, float32 or bfloat16
        seed: the call's seed (ops/philox.next_seed), its state on x's
            device
        rate: drop probability in (0, 1)
        site: Philox site of the call

    Returns x's shape and dtype.
    """
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{KERNEL}: rate must be in (0, 1), got {rate}")
    if not isinstance(seed, philox.Seed):
        raise TypeError(f"{KERNEL}: seed must be a philox.Seed, got "
                        f"{type(seed)}")
    return _Dropout.apply(x, seed, float(rate), int(site))
