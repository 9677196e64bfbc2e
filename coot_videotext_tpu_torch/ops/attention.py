"""
B3 masked multi-head attention forward:
    o = softmax(where(key_valid, q k^T * scale, -32752)) v, in f32.

Counterpart of coot_videotext_tpu/ops/pallas_attention.py::
pallas_masked_attention (forward). q, k, v keep the JAX (N = B*heads, L, Dh)
layout; the COOT nets only mask keys, so the mask is the (B, Lk) key
validity instead of a materialized (N, Lq, Lk) mask. On a CUDA tensor
`masked_attention` launches the Hopper kernel in csrc/attention.cu; on a
CPU tensor it computes `masked_attention_plain`, the port of
`masked_attention_reference` :178.
"""

from __future__ import annotations

import torch

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.common import (
    check_no_grad, check_tensor, is_bf16)
from coot_videotext_tpu_torch.typext import INF

KERNEL = "attention"


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, key_valid: torch.Tensor,
                           num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 scores from q and k read into f32, the
    scale applied to the f32 product, f32 softmax and f32 PV."""
    mask = key_valid.bool().repeat_interleave(num_heads, dim=0)[:, None, :]
    scores = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -INF))
    p = torch.softmax(scores, dim=-1)
    return torch.bmm(p, v.float()).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """
    Args:
        q: (N, Lq, Dh) with N = B * num_heads (batch-major, head-minor)
        k, v: (N, Lk, Dh)
        key_valid: (B, Lk) bool, True = attend
        scale: score scale (1/sqrt(Dh))

    Returns (N, Lq, Dh) in q.dtype.
    """
    check_no_grad(KERNEL, q, k, v)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, key_valid, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"{KERNEL}: q, k, v must be (N, L, Dh)")
    n, lq, dh = q.shape
    lk = k.shape[1]
    if k.shape[0] != n or k.shape[2] != dh:
        raise ValueError(f"{KERNEL}: k/v shape {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if key_valid.shape != (n // num_heads, lk) or n % num_heads:
        raise ValueError(f"{KERNEL}: key_valid must be (N/heads, Lk), got "
                         f"{tuple(key_valid.shape)}")
    if dh > 64 or lk == 0 or lq == 0:
        raise ValueError(f"{KERNEL}: kernel takes Dh <= 64 and non-empty "
                         f"sequences; got Dh={dh}, Lq={lq}, Lk={lk}")
    bf16 = is_bf16(KERNEL, q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(KERNEL, name, t, q.device)
        if t.dtype != q.dtype:
            raise TypeError(f"{KERNEL}: {name} dtype {t.dtype} != "
                            f"{q.dtype}")
    valid_u8 = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    o = torch.empty_like(q)
    lib = cuda_build.load_library()
    err = lib.coot_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
        o.data_ptr(), n, lq, lk, dh, num_heads, float(scale), int(bf16),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, KERNEL)
    cuda_build.launch_counts[KERNEL] += 1
    return o
