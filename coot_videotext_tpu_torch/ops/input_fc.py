"""
B1 fused input projection: y = act(cootnorm(x; gain, bias) . W^T + b),
forward and backward.

Counterpart of coot_videotext_tpu/ops/pallas_input_fc.py::fused_input_fc
:207 (forward :238, backward :284). `fused_input_fc` is a
torch.autograd.Function: on CUDA tensors its forward and backward launch
the Hopper kernels in csrc/input_fc.cu; on CPU tensors they compute
`fused_input_fc_plain` (the port of `fused_input_fc_reference` :327) and
`fused_input_fc_backward_plain` (the formulas of `_bwd_kernel` :167). The
weight is taken in the torch Linear layout (dout, din).

The input is pipeline data (JAX :25-32): no gradient is formed for x, and
an x that requires grad raises; the caller passes `x.detach()`
(models/transformer.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from coot_videotext_tpu_torch.models.layers import coot_norm_stats
from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    ACT_CODES, check_tensor, gelu_grad, is_bf16, kernel_operand)

KERNEL = "input_fc"


def _norm_rows(x32: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
               eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """CootLayerNorm over the last axis in f32, as (xhat, xn) (JAX
    `_norm_rows` :95)."""
    mean, denom = coot_norm_stats(x32, eps)
    xhat = (x32 - mean) / denom
    return xhat, gain.float() * xhat + bias.float()


def fused_input_fc_plain(x: torch.Tensor, gain: torch.Tensor,
                         bias: torch.Tensor, weight: torch.Tensor,
                         b: torch.Tensor, eps: float, act: str
                         ) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: f32 norm, the
    normalized rows rounded to x.dtype, f32 accumulation of the product,
    exact-erf gelu, output in x.dtype."""
    _, xn = _norm_rows(x.float(), gain, bias, eps)
    xn_c = xn.to(x.dtype).float()
    pre = xn_c @ weight.to(x.dtype).float().t() + b.float()
    y = F.gelu(pre) if act == "gelu" else pre
    return y.to(x.dtype)


def fused_input_fc_backward_plain(
        x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
        weight: torch.Tensor, b: torch.Tensor, eps: float, act: str,
        dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dgain, dbias, dweight (dout, din), db) in f32 with the kernel's
    numerics: dpre = dy * act'(pre) rounded to x.dtype; dW = xn_c^T dpre;
    db = sum dpre; dxn = dpre W; dgain = sum dxn * xhat; dbias = sum dxn."""
    dt = x.dtype
    xhat, xn = _norm_rows(x.float(), gain, bias, eps)
    xn_c = xn.to(dt).float()
    w_c = weight.to(dt).float()
    pre = xn_c @ w_c.t() + b.float()
    dpre = dy.float() * gelu_grad(pre) if act == "gelu" else dy.float()
    dpre = dpre.to(dt).float()
    dxn = dpre @ w_c
    return ((dxn * xhat).sum(dim=0), dxn.sum(dim=0), dpre.t() @ xn_c,
            dpre.sum(dim=0))


def _check(x, gain, bias, weight, b):
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{KERNEL}: x must be (S, din), got {x.shape}")
    s, din = x.shape
    dout = weight.shape[0]
    check_tensor(KERNEL, "x", x, x.device)
    if weight.shape != (dout, din) or b.shape != (dout,) \
            or gain.shape != (din,) or bias.shape != (din,):
        raise ValueError(f"{KERNEL}: parameter shapes do not match x")
    return s, din, dout, is_bf16(KERNEL, x)


class _InputFC(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gain, bias, weight, b, eps, act):
        ctx.params = (eps, act)
        need_grad = any(ctx.needs_input_grad[1:5])
        if x.device.type == "cpu":
            if need_grad:
                ctx.save_for_backward(x, gain, bias, weight, b)
            return fused_input_fc_plain(x, gain, bias, weight, b, eps, act)
        s, din, dout, bf16 = _check(x, gain, bias, weight, b)
        w_c = kernel_operand(weight, x.dtype, x.device)
        gain32, bias32, b32 = (kernel_operand(t, torch.float32, x.device)
                               for t in (gain, bias, b))
        y = torch.empty((s, dout), dtype=x.dtype, device=x.device)
        mean = torch.empty(s, dtype=torch.float32, device=x.device)
        inv = torch.empty(s, dtype=torch.float32, device=x.device)
        pre = (torch.empty((s, dout), dtype=torch.float32, device=x.device)
               if need_grad else None)
        if s > 0:
            lib = cuda_build.load_library()
            err = lib.coot_input_fc_fwd(
                x.data_ptr(), gain32.data_ptr(), bias32.data_ptr(),
                w_c.data_ptr(), b32.data_ptr(), y.data_ptr(),
                mean.data_ptr(), inv.data_ptr(),
                0 if pre is None else pre.data_ptr(), s, din, dout,
                float(eps), ACT_CODES[act], int(bf16), cuda_build.stream(x))
            cuda_build.check(err, KERNEL)
            cuda_build.launch_counts[KERNEL] += 1
        if need_grad:
            ctx.save_for_backward(x, gain32, bias32, w_c, mean, inv, pre)
        return y

    @staticmethod
    def backward(ctx, dy):
        eps, act = ctx.params
        if dy.device.type == "cpu":
            x, gain, bias, weight, b = ctx.saved_tensors
            dgain, dbias, dw, db = fused_input_fc_backward_plain(
                x, gain, bias, weight, b, eps, act, dy)
            return None, dgain, dbias, dw, db, None, None
        x, gain32, bias32, w_c, mean, inv, pre = ctx.saved_tensors
        s, din = x.shape
        dout = w_c.shape[0]
        dev = x.device
        f32 = dict(dtype=torch.float32, device=dev)
        dw = torch.empty((din, dout), **f32)
        db = torch.empty(dout, **f32)
        dgain = torch.empty(din, **f32)
        dbias = torch.empty(din, **f32)
        if s == 0:
            return (None, dgain.zero_(), dbias.zero_(), dw.zero_().t(),
                    db.zero_(), None, None)
        if din % 64 or dout % 16 or dout > 384:
            raise ValueError(f"{KERNEL}: the backward kernel takes din % 64 "
                             f"== 0 and dout % 16 == 0, dout <= 384; got "
                             f"din={din}, dout={dout}")
        dy = dy.to(x.dtype).contiguous()
        dpre = torch.empty((s, dout), dtype=x.dtype, device=dev)
        splits = cuda_build.splits_for(s, -(-din // 64) * -(-dout // 64))
        scratch = torch.empty(splits * din * dout, **f32)
        lib = cuda_build.load_library()
        err = lib.coot_input_fc_bwd(
            x.data_ptr(), gain32.data_ptr(), bias32.data_ptr(),
            w_c.data_ptr(), mean.data_ptr(), inv.data_ptr(), pre.data_ptr(),
            dy.data_ptr(), dpre.data_ptr(), scratch.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dgain.data_ptr(),
            dbias.data_ptr(), s, din, dout, ACT_CODES[act],
            splits, int(is_bf16(KERNEL, x)), cuda_build.stream(x))
        cuda_build.check(err, KERNEL + "_bwd")
        cuda_build.launch_counts[KERNEL + "_bwd"] += 1
        return None, dgain, dbias, dw.t(), db, None, None


def fused_input_fc(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
                   weight: torch.Tensor, b: torch.Tensor, eps: float,
                   act: str) -> torch.Tensor:
    """
    Args:
        x: (S, din) features, float32 or bfloat16 (the compute dtype);
            pipeline data: must not require grad
        gain, bias: (din,) CootLayerNorm parameters
        weight: (dout, din) Linear weight; b: (dout,) Linear bias
        act: "gelu" | "none"

    Returns (S, dout) in x.dtype; differentiable in gain, bias, weight, b.
    """
    if act not in ("gelu", "none"):
        raise ValueError(f"input_fc supports gelu/none, got {act}")
    if x.requires_grad:
        raise ValueError(
            f"{KERNEL}: x is pipeline data and gets no gradient (as the "
            "JAX kernel's zero input cotangent); pass x.detach()")
    return _InputFC.apply(x, gain, bias, weight, b, float(eps), act)
