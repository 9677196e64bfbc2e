"""
B6: the post-LN residual add and CootLayerNorm in one op,
CootLayerNorm(y + residual) with the residual optional, forward and
backward.

CootLayerNorm is gain * (x - mean) / (std_bessel + eps) + bias over the last
axis, in float32, the output in the input's dtype (reference
normalizations.py:84-101). The JAX package has no kernel for it (XLA fuses
it); on a CUDA tensor `coot_norm` launches the Hopper kernels in
csrc/coot_norm.cu, on a CPU tensor it computes `coot_norm_plain` and, for
the gradients, `coot_norm_backward_plain`, the kernel's formula written out
in PyTorch. `tests/test_torch_ops.py` holds that formula against autograd
of `coot_layer_norm`.

The sum y + residual is rounded to the input dtype, as the plain add
rounds, and it is what the norm sees; its gradient, the same tensor for y
and the residual, is rounded to the input dtype once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    check_tensor, is_bf16, kernel_operand, sm_count)

KERNEL = "coot_norm"
MAX_WIDTH = 1024  # one warp holds a row in registers


def coot_norm_moments(x32: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std_bessel) over the last axis, in float32 (JAX
    CootLayerNorm :133-176). The sums are taken on x shifted by each row's
    first element, which removes the s2 - mean*s1 cancellation for rows
    whose mean^2 >> var at no extra pass; std is 0 (not NaN, and with a
    zero gradient) for constant rows, which do occur (zeroed padded
    slots)."""
    dim = x32.shape[-1]
    # the shift cancels in mean and variance: no gradient through it
    c = x32[..., :1].detach()
    xc = x32 - c
    s1 = xc.sum(dim=-1, keepdim=True)
    s2 = (xc * xc).sum(dim=-1, keepdim=True)
    mean_c = s1 / dim
    var = torch.clamp(s2 - mean_c * s1, min=0.0) / max(dim - 1, 1)
    var_pos = var > 0.0
    std = torch.where(var_pos, torch.sqrt(torch.where(var_pos, var, 1.0)),
                      0.0)
    return c + mean_c, std


def coot_norm_stats(x32: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std_bessel + eps) over the last axis, in float32."""
    mean, std = coot_norm_moments(x32)
    return mean, std + eps


def coot_layer_norm(x32: torch.Tensor, gain: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """gain * (x - mean) / (std_bessel + eps) + bias over the last axis, in
    float32."""
    mean, denom = coot_norm_stats(x32, eps)
    return gain * (x32 - mean) / denom + bias


def _sum(y: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    return y if residual is None else y + residual


def coot_norm_plain(y: torch.Tensor, residual: Optional[torch.Tensor],
                    gain: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """CootLayerNorm(y + residual) as the unfused modules compose it: the
    sum in y's dtype, the norm in float32, the output in y's dtype."""
    s = _sum(y, residual)
    return coot_layer_norm(s.float(), gain, bias, eps).to(s.dtype)


def coot_norm_backward_plain(s: torch.Tensor, gain: torch.Tensor, eps: float,
                             dout: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dx in s's dtype, dgain, dbias in float32) of CootLayerNorm at the
    sum s, with the kernel's formula: xhat = (s - mean) / denom,
    g = dout * gain,
        dx = (g - mean(g)) / denom - xhat * sum(g xhat) / ((D - 1) std),
    the second term 0 where std = 0 (no gradient through it); dgain =
    sum dout * xhat and dbias = sum dout over the rows. Computed in float32,
    or in float64 for a float64 s."""
    wide = torch.float64 if s.dtype == torch.float64 else torch.float32
    x = s.to(wide)
    dim = x.shape[-1]
    mean, std = coot_norm_moments(x)
    xhat = (x - mean) / (std + eps)
    d = dout.to(wide)
    g = d * gain.to(wide)
    coef = torch.where(std > 0, (g * xhat).sum(-1, keepdim=True)
                       / (max(dim - 1, 1) * torch.where(std > 0, std, 1.0)),
                       0.0)
    dx = (g - g.mean(-1, keepdim=True)) / (std + eps) - xhat * coef
    rows = (-1, dim)
    return (dx.to(s.dtype), (d * xhat).reshape(rows).sum(0),
            d.reshape(rows).sum(0))


def backward_blocks(rows: int, sms: int) -> int:
    """Blocks of the backward kernel: at least 32 rows (4 a warp) each, at
    most 4 blocks per SM; their partial column sums add up in a second
    pass."""
    return max(1, min(-(-rows // 32), 4 * sms))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel's 16-byte vectors read it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(y: torch.Tensor, residual: Optional[torch.Tensor]) -> bool:
    """Raises on what the kernel does not take; returns whether y is
    bfloat16."""
    if y.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {y.device}")
    bf16 = is_bf16(KERNEL, y)
    width = y.shape[-1] if y.dim() else 0
    if width % 8 or not 8 <= width <= MAX_WIDTH:
        raise ValueError(f"{KERNEL}: the last axis must be a multiple of 8 "
                         f"from 8 to {MAX_WIDTH}, got {width}")
    check_tensor(KERNEL, "y", y, y.device)
    if residual is not None:
        if residual.shape != y.shape or residual.dtype != y.dtype:
            raise ValueError(f"{KERNEL}: the residual must match y, got "
                             f"{residual.shape} {residual.dtype} against "
                             f"{y.shape} {y.dtype}")
        check_tensor(KERNEL, "residual", residual, y.device)
    return bf16


class _CootNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, residual, gain, bias, eps, need_grad):
        ctx.eps = eps
        ctx.has_residual = residual is not None
        if y.device.type == "cpu":
            s = _sum(y, residual)
            if need_grad:
                ctx.save_for_backward(s, gain)
            return coot_layer_norm(s.float(), gain, bias, eps).to(s.dtype)
        bf16 = _check(y, residual)
        dev = y.device
        y = _aligned(y)
        residual = None if residual is None else _aligned(residual)
        gain32, bias32 = (kernel_operand(t, torch.float32, dev)
                          for t in (gain, bias))
        out = torch.empty_like(y)
        rows = y.numel() // y.shape[-1]
        s = mean = inv = None
        if need_grad:
            s = y if residual is None else torch.empty_like(y)
            mean = torch.empty(rows, dtype=torch.float32, device=dev)
            inv = torch.empty(rows, dtype=torch.float32, device=dev)
        if rows:
            def ptr(t):
                return 0 if t is None else t.data_ptr()
            err = cuda_build.load_library().coot_norm_fwd(
                y.data_ptr(), ptr(residual), gain32.data_ptr(),
                bias32.data_ptr(), out.data_ptr(),
                0 if residual is None else ptr(s), ptr(mean), ptr(inv),
                rows, y.shape[-1], float(eps), int(bf16),
                cuda_build.stream(y))
            cuda_build.check(err, KERNEL)
            cuda_build.launch_counts[KERNEL] += 1
        if need_grad:
            ctx.save_for_backward(s, gain32, mean, inv)
        return out

    @staticmethod
    def backward(ctx, dout):
        if dout.device.type == "cpu":
            s, gain = ctx.saved_tensors
            dx, dgain, dbias = coot_norm_backward_plain(s, gain, ctx.eps,
                                                        dout)
        else:
            s, gain32, mean, inv = ctx.saved_tensors
            dx, dgain, dbias = _backward_kernel(s, gain32, mean, inv, dout)
        return (dx, dx if ctx.has_residual else None, dgain, dbias, None,
                None)


def _backward_kernel(s, gain32, mean, inv, dout):
    dev = s.device
    width = s.shape[-1]
    rows = s.numel() // width
    dout = _aligned(dout.to(s.dtype).contiguous())
    dx = torch.empty_like(s)
    grads = torch.empty(2 * width, dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, grads.zero_()[:width], grads[width:]
    blocks = backward_blocks(rows, sm_count(dev.index))
    scratch = torch.empty(blocks * 2 * width, dtype=torch.float32,
                          device=dev)
    err = cuda_build.load_library().coot_norm_bwd(
        dout.data_ptr(), s.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gain32.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
        grads.data_ptr(), rows, width, blocks, int(is_bf16(KERNEL, s)),
        cuda_build.stream(s))
    cuda_build.check(err, KERNEL + "_bwd")
    cuda_build.launch_counts[KERNEL + "_bwd"] += 1
    return dx, grads[:width], grads[width:]


def coot_norm(y: torch.Tensor, residual: Optional[torch.Tensor],
              gain: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """
    Args:
        y: (..., D) float32 or bfloat16 (the compute dtype); on the card
            contiguous, D a multiple of 8 up to 1024
        residual: y's shape and dtype, added to y before the norm, or None
        gain, bias: (D,) float32 CootLayerNorm parameters
        eps: added to the Bessel std

    Returns CootLayerNorm(y + residual) in y's dtype; differentiable in y,
    residual, gain and bias.
    """
    need_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (y, residual, gain, bias))
    return _CootNorm.apply(y, residual, gain, bias, float(eps), need_grad)
