"""
B1 fused input projection: y = act(cootnorm(x; gain, bias) . W^T + b).

Counterpart of coot_videotext_tpu/ops/pallas_input_fc.py::fused_input_fc
(forward only). On a CUDA tensor `fused_input_fc` launches the Hopper kernel
in csrc/input_fc.cu; on a CPU tensor it computes the plain version
`fused_input_fc_plain`, the port of `fused_input_fc_reference` :327. The
weight is taken in the torch Linear layout (dout, din).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coot_videotext_tpu_torch.models.layers import coot_layer_norm
from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    ACT_CODES, check_no_grad, check_tensor, is_bf16, kernel_operand)

KERNEL = "input_fc"


def fused_input_fc_plain(x: torch.Tensor, gain: torch.Tensor,
                         bias: torch.Tensor, weight: torch.Tensor,
                         b: torch.Tensor, eps: float, act: str
                         ) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: f32 norm, the
    normalized rows rounded to x.dtype, f32 accumulation of the product,
    exact-erf gelu, output in x.dtype."""
    xn = coot_layer_norm(x.float(), gain.float(), bias.float(), eps)
    xn_c = xn.to(x.dtype).float()
    pre = xn_c @ weight.to(x.dtype).float().t() + b.float()
    y = F.gelu(pre) if act == "gelu" else pre
    return y.to(x.dtype)


def fused_input_fc(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
                   weight: torch.Tensor, b: torch.Tensor, eps: float,
                   act: str) -> torch.Tensor:
    """
    Args:
        x: (S, din) features, float32 or bfloat16 (the compute dtype)
        gain, bias: (din,) CootLayerNorm parameters
        weight: (dout, din) Linear weight; b: (dout,) Linear bias
        act: "gelu" | "none"

    Returns (S, dout) in x.dtype.
    """
    if act not in ("gelu", "none"):
        raise ValueError(f"input_fc supports gelu/none, got {act}")
    check_no_grad(KERNEL, x, gain, bias, weight, b)
    if x.device.type == "cpu":
        return fused_input_fc_plain(x, gain, bias, weight, b, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{KERNEL}: x must be (S, din), got {x.shape}")
    s, din = x.shape
    dout = weight.shape[0]
    bf16 = is_bf16(KERNEL, x)
    check_tensor(KERNEL, "x", x, x.device)
    if weight.shape != (dout, din) or b.shape != (dout,) \
            or gain.shape != (din,) or bias.shape != (din,):
        raise ValueError(f"{KERNEL}: parameter shapes do not match x")
    w_c = kernel_operand(weight, x.dtype, x.device)
    gain32, bias32, b32 = (kernel_operand(t, torch.float32, x.device)
                           for t in (gain, bias, b))
    y = torch.empty((s, dout), dtype=x.dtype, device=x.device)
    if s == 0:
        return y
    mean = torch.empty(s, dtype=torch.float32, device=x.device)
    inv = torch.empty(s, dtype=torch.float32, device=x.device)
    lib = cuda_build.load_library()
    err = lib.coot_input_fc_fwd(
        x.data_ptr(), gain32.data_ptr(), bias32.data_ptr(), w_c.data_ptr(),
        b32.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        s, din, dout, float(eps), ACT_CODES[act], int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, KERNEL)
    cuda_build.launch_counts[KERNEL] += 1
    return y
