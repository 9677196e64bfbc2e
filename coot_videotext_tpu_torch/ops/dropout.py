"""
B4 dropout: y = x * keep / (1 - rate), keep iff Philox bits >=
floor(rate * 2^32); the backward applies the same mask, regenerated from
(seed, site), to the cotangent.

Counterpart of coot_videotext_tpu/ops/pallas_dropout.py::hw_dropout :98
with the semantics of the module's Dropout (models/layers.py:38). On a CUDA
tensor `dropout` launches the Hopper kernel in csrc/dropout.cu (forward
and backward); on a CPU tensor it computes `dropout_plain` with the same
bits (ops/philox.py).
"""

from __future__ import annotations

import torch

from coot_videotext_tpu_torch.ops import cuda_build, philox
from coot_videotext_tpu_torch.ops.common import check_tensor, is_bf16

KERNEL = "dropout"


def dropout_plain(x: torch.Tensor, seed: int, rate: float,
                  site: int = philox.SITE_DROPOUT) -> torch.Tensor:
    """Plain version: the keep factor in float32, the product rounded to
    x.dtype, as the kernel does."""
    f = philox.keep_factor(x.shape, seed, site, rate, x.device)
    return (x.float() * f).to(x.dtype)


def _launch(x: torch.Tensor, seed: int, rate: float, site: int,
            name: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    bf16 = is_bf16(KERNEL, x)
    x = x.contiguous()
    check_tensor(KERNEL, "x", x, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = cuda_build.load_library()
    err = lib.coot_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), seed, philox.threshold(rate),
        1.0 / (1.0 - rate), site, int(bf16),
        cuda_build.stream(x))
    cuda_build.check(err, name)
    cuda_build.launch_counts[name] += 1
    return y


class _Dropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, seed, rate, site):
        ctx.params = (seed, rate, site)
        if x.device.type == "cpu":
            return dropout_plain(x, seed, rate, site)
        return _launch(x, seed, rate, site, KERNEL)

    @staticmethod
    def backward(ctx, g):
        seed, rate, site = ctx.params
        if g.device.type == "cpu":
            return dropout_plain(g, seed, rate, site), None, None, None
        return _launch(g, seed, rate, site, KERNEL + "_bwd"), None, None, \
            None


def dropout(x: torch.Tensor, seed: int, rate: float,
            site: int = philox.SITE_DROPOUT) -> torch.Tensor:
    """
    Args:
        x: any shape, float32 or bfloat16
        seed: 64-bit seed of this call (ops/philox.next_seed)
        rate: drop probability in (0, 1)
        site: Philox site of the call

    Returns x's shape and dtype.
    """
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{KERNEL}: rate must be in (0, 1), got {rate}")
    return _Dropout.apply(x, int(seed), float(rate), int(site))
