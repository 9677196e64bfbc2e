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

The backward kernel forms one product, G = xhat^T dpre, and derives every
parameter gradient from it (csrc/input_fc.cu); the plain backward keeps the
TPU kernel's two products, and `tests/test_torch_ops.py` holds the identity
between the two against jax.grad.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    ACT_CODES, check_tensor, gelu_grad, is_bf16, kernel_operand, sm_count)
from coot_videotext_tpu_torch.ops.coot_norm import coot_norm_stats

KERNEL = "input_fc"

# Tiles of the bf16 backward's product (csrc/tn_mma.cuh, shared with B2): a
# block owns G_ROWS x G_COLS of G = xhat^T dpre and one row split, which it
# walks G_STEP rows at a time.
G_ROWS, G_COLS, G_STEP = 128, 192, 64


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def splits_for_tiles(rows: int, tiles: int, sms: int) -> int:
    """Row splits of a tensor-core weight-gradient product over `tiles`
    output tiles (csrc/tn_mma.cuh, one block per tile and split, one block
    per SM): the fewest splits that give at least one block per SM and
    fill whole waves to 85% or more, with at least 4 steps of G_STEP rows
    per split (at most 64 splits)."""
    most = max(1, min(64, rows // (4 * G_STEP)))
    least = max(1, _ceil(sms, tiles))
    for splits in range(least, most + 1):
        blocks = tiles * splits
        if blocks >= 0.85 * _ceil(blocks, sms) * sms:
            return splits
    return min(most, least)


def backward_splits(rows: int, din: int, dout: int, sms: int) -> int:
    """Row splits of the bf16 backward's product G (din x dout tiles of
    G_ROWS x G_COLS)."""
    return splits_for_tiles(rows, _ceil(din, G_ROWS) * _ceil(dout, G_COLS),
                            sms)


def backward_plan(rows: int, din: int, dout: int, bf16: bool,
                  sms: int) -> Tuple[int, int]:
    """(splits of the product G, splits of the dpre pass). bf16 takes the
    tensor-core product's splits; float32 the FMA reduction's
    (csrc/tn_reduce.cuh, 64 x 64 tiles). The dpre pass runs one block of
    up to 1,024 threads per SM, each block over one row split."""
    if bf16:
        splits = backward_splits(rows, din, dout, sms)
    else:
        splits = cuda_build.splits_for(rows, _ceil(din, 64) * _ceil(dout, 64))
    return splits, max(1, min(sms, _ceil(rows, 64)))


def pad_backward_operands(x, gain, bias, w, pre, dy):
    """The backward kernel's operands zero-padded to din % 64 == 0 and
    dout % 16 == 0 (returned as they are when both widths already are).
    Every parameter gradient of input column k depends only on column k,
    and a padded output column has dy = 0, so dpre = 0 there: the real
    gradients are the padded ones sliced back. mean and inv stay the
    forward's (over the real din); the padded columns of xhat are then
    garbage that the slice drops."""
    din, dout = x.shape[1], w.shape[0]
    pin, pout = -din % 64, -dout % 16
    if not (pin or pout):
        return x, gain, bias, w, pre, dy
    return (F.pad(x, (0, pin)), F.pad(gain, (0, pin)), F.pad(bias, (0, pin)),
            F.pad(w, (0, pin, 0, pout)), F.pad(pre, (0, pout)),
            F.pad(dy, (0, pout)))


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
        s, din0 = x.shape
        dout0 = w_c.shape[0]
        dev = x.device
        f32 = dict(dtype=torch.float32, device=dev)
        if s == 0:
            return (None, torch.zeros(din0, **f32), torch.zeros(din0, **f32),
                    torch.zeros((dout0, din0), **f32),
                    torch.zeros(dout0, **f32), None, None)
        if dout0 > 384:
            raise ValueError(f"{KERNEL}: the backward kernel takes dout <= "
                             f"384; got dout={dout0}")
        x, gain32, bias32, w_c, pre, dy = pad_backward_operands(
            x, gain32, bias32, w_c, pre, dy.to(x.dtype))
        din, dout = x.shape[1], w_c.shape[0]
        dw = torch.empty((din, dout), **f32)
        db = torch.empty(dout, **f32)
        dgain = torch.empty(din, **f32)
        dbias = torch.empty(din, **f32)
        dy = dy.contiguous()
        if dy.data_ptr() % 16:  # the dpre pass reads 16-byte vectors
            dy = dy.clone()
        bf16 = is_bf16(KERNEL, x)
        dpre = torch.empty((s, dout), dtype=x.dtype, device=dev)
        splits, dpre_splits = backward_plan(s, din, dout, bf16,
                                            sm_count(dev.index))
        scratch = torch.empty(splits * din * dout + dpre_splits * dout,
                              **f32)
        # float32: gain 1 and bias 0 turn the FMA reduction's xn into xhat
        unit = None if bf16 else torch.cat([torch.ones(din, **f32),
                                            torch.zeros(din, **f32)])
        lib = cuda_build.load_library()
        err = lib.coot_input_fc_bwd(
            x.data_ptr(), gain32.data_ptr(), bias32.data_ptr(),
            w_c.data_ptr(), mean.data_ptr(), inv.data_ptr(), pre.data_ptr(),
            dy.data_ptr(), dpre.data_ptr(), scratch.data_ptr(),
            0 if unit is None else unit.data_ptr(), dw.data_ptr(),
            db.data_ptr(), dgain.data_ptr(), dbias.data_ptr(), s, din, dout,
            ACT_CODES[act], splits, dpre_splits, int(bf16),
            cuda_build.stream(x))
        cuda_build.check(err, KERNEL + "_bwd")
        cuda_build.launch_counts[KERNEL + "_bwd"] += 1
        return (None, dgain[:din0], dbias[:din0], dw[:din0, :dout0].t(),
                db[:dout0], None, None)


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
