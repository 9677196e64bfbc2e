"""
The precision the references compute their matrix products in.

"float32" is the reference itself: float32 operands and sums (TF32 is
switched off by the harness on the card). The controls put the reference
in the program's place one precision below the configuration's:
    - "fp8" (under a bfloat16 configuration): every operand of every
      product, forward and backward, rounded to float8 e4m3 with one
      scale per tensor (its largest magnitude maps to 448), sums in
      float32;
    - "tf32" (under a float32 configuration): every operand rounded to
      TF32's 10-bit mantissa (round to nearest even), sums in float32, as
      the tensor cores take them with TF32 on.
Normalisations, softmaxes and the loss stay in float32 in every mode.
"""

from __future__ import annotations

import torch

MODES = ("float32", "fp8", "tf32")
_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def round_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    x = x.float()
    if mode == "fp8":
        return _fp8(x)
    if mode == "tf32":
        return _tf32(x)
    return x


def round_result(y: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's result in the mode's precision: float8 results under
    "fp8" (a bfloat16 program's products return bfloat16), float32 under
    "tf32" and "float32"."""
    return _fp8(y) if mode == "fp8" else y


class _Product(torch.autograd.Function):
    """a @ b with both operands rounded, and both products of the
    backward rounded the same way."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return round_result(torch.matmul(round_operand(a, mode),
                                         round_operand(b, mode)), mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m = ctx.mode
        gq = round_operand(g, m)
        ga = round_result(
            torch.matmul(gq, round_operand(b, m).transpose(-1, -2)), m)
        gb = round_result(
            torch.matmul(round_operand(a, m).transpose(-1, -2), gq), m)
        # broadcast batch dims back to each operand's shape
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in float32 after rounding the operands per `mode`."""
    if mode not in MODES:
        raise ValueError(f"precision {mode!r} is not one of {MODES}")
    if mode == "float32":
        return torch.matmul(a.float(), b.float())
    return _Product.apply(a.float(), b.float(), mode)


def linear(x: torch.Tensor, weight: torch.Tensor, bias, mode: str
           ) -> torch.Tensor:
    """x @ weight.T + bias, weight (out, in) as torch stores it."""
    y = matmul(x, weight.t(), mode)
    return y if bias is None else y + bias.float()
