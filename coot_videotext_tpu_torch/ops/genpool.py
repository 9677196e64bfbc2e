"""
B2 GenPool forward (deterministic): per-head MLP over the features, a
masked softmax over the sequence (fill -32752) and the weighted sum.

Counterpart of coot_videotext_tpu/ops/pallas_genpool.py::fused_genpool
(forward, rate 0). `genpool` takes the module's head-stacked parameters
(reference poolers.py:129-139 layout). On a CUDA tensor it launches the
Hopper kernel in csrc/genpool.cu, which reads w1 in the flat
head-interleaved (D, heads*dh) layout and w2 per head; on a CPU tensor it
computes `genpool_plain`, the port of `fused_genpool_reference` :391.
The output column order is [h*dho + o], the reference's head interleave.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    ACT_CODES, check_no_grad, check_tensor, is_bf16, kernel_operand)
from coot_videotext_tpu_torch.typext import INF

KERNEL = "genpool"


def flat_w1(w1_heads: torch.Tensor) -> torch.Tensor:
    """(heads, D, dh) -> (D, heads*dh), column h*dh + k = head h, unit k."""
    heads, d, dh = w1_heads.shape
    return w1_heads.permute(1, 0, 2).reshape(d, heads * dh)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(x)
    if act == "relu":
        return torch.relu(x)
    return x


def genpool_plain(f: torch.Tensor, mask: torch.Tensor,
                  w1_heads: torch.Tensor, b1_heads: torch.Tensor,
                  w2_heads: torch.Tensor, b2_heads: torch.Tensor,
                  act: str) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: products of
    compute-dtype operands accumulated in f32, the hidden activations
    rounded to the compute dtype, f32 softmax and sum."""
    cdtype = f.dtype
    heads, dh, dho = w2_heads.shape
    f32 = f.float()
    pre1 = f32 @ flat_w1(w1_heads).to(cdtype).float() \
        + b1_heads.reshape(-1).float()
    h1 = _act(pre1, act).to(cdtype).float()
    w2c = w2_heads.to(cdtype).float()
    h2 = torch.cat([h1[..., hh * dh:(hh + 1) * dh] @ w2c[hh]
                    for hh in range(heads)], dim=-1)
    logits = h2 + b2_heads.reshape(-1).float()
    logits = torch.where(mask.bool()[..., None], logits,
                         torch.full_like(logits, -INF))
    sm = torch.softmax(logits, dim=1)
    return (f32 * sm).sum(dim=1).to(cdtype)


def genpool(f: torch.Tensor, mask: torch.Tensor, w1_heads: torch.Tensor,
            b1_heads: torch.Tensor, w2_heads: torch.Tensor,
            b2_heads: torch.Tensor, act: str) -> torch.Tensor:
    """
    Args:
        f: (S, L, D) features in the compute dtype (float32 or bfloat16)
        mask: (S, L) validity, True = valid
        w1_heads: (heads, D, dh); b1_heads: (heads, dh)
        w2_heads: (heads, dh, dho); b2_heads: (heads, dho), D = heads*dho
        act: "gelu" | "relu" | "none"

    Returns (S, D) pooled rows in f.dtype.
    """
    if act not in ACT_CODES:
        raise ValueError(f"{KERNEL} supports {sorted(ACT_CODES)}, got {act}")
    check_no_grad(KERNEL, f, w1_heads, b1_heads, w2_heads, b2_heads)
    if f.device.type == "cpu":
        return genpool_plain(f, mask, w1_heads, b1_heads, w2_heads,
                             b2_heads, act)
    if f.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {f.device}")
    if f.dim() != 3 or mask.shape != f.shape[:2]:
        raise ValueError(f"{KERNEL}: f must be (S, L, D) and mask (S, L), "
                         f"got {tuple(f.shape)} and {tuple(mask.shape)}")
    s, length, d = f.shape
    heads, dh, dho = w2_heads.shape
    h = heads * dh
    if w1_heads.shape != (heads, d, dh) or heads * dho != d:
        raise ValueError(f"{KERNEL}: parameter shapes do not match f")
    if d % 16 or dh % 16 or dho % 16 or d > 1024 or h > 1024:
        raise ValueError(
            f"{KERNEL}: kernel takes D, dh, dho multiples of 16 and D, H <= "
            f"1024; got D={d}, heads={heads}, dh={dh}, dho={dho}")
    if s == 0 or length == 0:
        raise ValueError(f"{KERNEL}: empty input {tuple(f.shape)}")
    bf16 = is_bf16(KERNEL, f)
    check_tensor(KERNEL, "f", f, f.device)
    mask_u8 = mask.to(device=f.device, dtype=torch.uint8).contiguous()
    w1 = kernel_operand(flat_w1(w1_heads), f.dtype, f.device)
    w2 = kernel_operand(w2_heads, f.dtype, f.device)
    b1 = kernel_operand(b1_heads.reshape(-1), torch.float32, f.device)
    b2 = kernel_operand(b2_heads.reshape(-1), torch.float32, f.device)
    out = torch.empty((s, d), dtype=f.dtype, device=f.device)
    lib = cuda_build.load_library()
    err = lib.coot_genpool_fwd(
        f.data_ptr(), mask_u8.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), s, length, d, h,
        heads, ACT_CODES[act], int(bf16),
        torch.cuda.current_stream(f.device).cuda_stream)
    cuda_build.check(err, KERNEL)
    cuda_build.launch_counts[KERNEL] += 1
    return out
