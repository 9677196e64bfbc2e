"""
B3 masked multi-head attention, forward and backward:
    P = softmax(where(key_valid, q k^T * scale, -32752)),
    o = dropout(P) v, in f32.

Counterpart of coot_videotext_tpu/ops/pallas_attention.py::
pallas_masked_attention :114 (forward :135, backward :158). q, k, v keep the
JAX (N = B*heads, L, Dh) layout; the COOT nets only mask keys, so the mask
is the (B, Lk) key validity instead of a materialized (N, Lq, Lk) mask.
With `rate > 0` the kernel also drops P, as the module does
(models/attention.py:187-192), with Philox bits (ops/philox.py).

`masked_attention` is a torch.autograd.Function: on CUDA tensors its
forward and backward launch the Hopper kernels in csrc/attention.cu (in
bf16 the forward walks its key blocks with an online softmax on the tensor
cores, tiled by `forward_plan`); on CPU
tensors they compute `masked_attention_plain` and
`masked_attention_backward_plain`, the port of `masked_attention_reference`
:178 and of its autodiff. The score gradient is zero at masked keys, as
autodiff of the module's where() gives (the Pallas `_bwd_kernel` :84-89
leaves it non-zero on rows whose keys are all masked).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from coot_videotext_tpu_torch.ops import cuda_build, philox
from coot_videotext_tpu_torch.ops.common import check_tensor, is_bf16
from coot_videotext_tpu_torch.typext import INF

KERNEL = "attention"
MMA_MAX_KEYS = 128  # keys per block of the bf16 backward and forward
FWD_KEY_STEP = 32   # keys per online-softmax step of the bf16 forward


def _balanced(length: int, unit: int, most: int) -> int:
    """The fewest equal parts of at most `most` that cover `length` in
    whole units: the size of one part."""
    units = -(-length // unit)
    parts = -(-units // (most // unit))
    return -(-units // parts) * unit


def forward_plan(lq: int, lk: int) -> Tuple[int, int, int]:
    """(queries per chunk, keys per staged block, cells per block) of the
    bf16 forward (csrc/attention.cu masked_attention_fwd_mma): a warp per
    16 queries, at most 8 warps; key blocks of at most 128 keys in steps
    of 32; cells of Lq, Lk <= 32 several to a block, at least 4 warps."""
    bq = _balanced(lq, 16, MMA_MAX_KEYS)
    bk = _balanced(lk, FWD_KEY_STEP, MMA_MAX_KEYS)
    cells = max(1, 4 // (bq // 16)) if lq <= 32 and lk <= 32 else 1
    return bq, bk, cells


def _probs(q, k, key_valid, num_heads, scale):
    mask = key_valid.bool().repeat_interleave(num_heads, dim=0)[:, None, :]
    scores = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, -INF))
    return torch.softmax(scores, dim=-1), mask


def _drop(shape, seed, rate, device) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    return philox.keep_factor(shape, seed, philox.SITE_ATTENTION, rate,
                              device)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, key_valid: torch.Tensor,
                           num_heads: int, scale: float, rate: float = 0.0,
                           seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version: f32 scores from q and k read into f32, the
    scale applied to the f32 product, f32 softmax, P dropped with the
    kernel's bits, f32 PV."""
    p, _ = _probs(q, k, key_valid, num_heads, scale)
    f = _drop(p.shape, seed, rate, p.device)
    if f is not None:
        p = p * f
    return torch.bmm(p, v.float()).to(q.dtype)


def masked_attention_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        key_valid: torch.Tensor, g: torch.Tensor, num_heads: int,
        scale: float, rate: float = 0.0, seed: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype, by the kernel's formulas in f32:
    dv = Pd^T g; dS = where(valid, P * (g v^T * f - rowsum(g * o)), 0);
    dq = dS k * scale; dk = dS^T q * scale; f = keep / (1 - rate)."""
    p, mask = _probs(q, k, key_valid, num_heads, scale)
    f = _drop(p.shape, seed, rate, p.device)
    pd = p if f is None else p * f
    g32, v32 = g.float(), v.float()
    o = torch.bmm(pd, v32)
    dv = torch.bmm(pd.transpose(1, 2), g32)
    dpd = torch.bmm(g32, v32.transpose(1, 2))
    dp = dpd if f is None else dpd * f
    delta = (g32 * o).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), torch.zeros_like(p))
    dq = torch.bmm(ds, k.float()) * scale
    dk = torch.bmm(ds.transpose(1, 2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, key_valid, num_heads):
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
    return n, lq, lk, dh, bf16


def _launch_fwd(q, k, v, key_valid, num_heads, scale, rate, seed,
                need_stats):
    n, lq, lk, dh, bf16 = _check(q, k, v, key_valid, num_heads)
    valid_u8 = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    o = torch.empty_like(q)
    stats = None
    rm = ri = 0
    if need_stats:
        stats = torch.empty((2, n, lq), dtype=torch.float32, device=q.device)
        rm, ri = stats[0].data_ptr(), stats[1].data_ptr()
    lib = cuda_build.load_library()
    err = lib.coot_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
        o.data_ptr(), rm, ri, n, lq, lk, dh, num_heads, float(scale),
        *philox.kernel_args(rate, seed), *forward_plan(lq, lk), int(bf16),
        cuda_build.stream(q))
    cuda_build.check(err, KERNEL)
    cuda_build.launch_counts[KERNEL] += 1
    return o, valid_u8, stats


def needs_dq_scratch(lk: int, bf16: bool) -> bool:
    """The bf16 backward sums dq over key blocks of at most 128 keys in an
    f32 scratch (csrc/attention.cu kMmaMaxRows); one block needs none."""
    return bf16 and lk > MMA_MAX_KEYS


def _launch_bwd(q, k, v, o, g, valid_u8, stats, num_heads, scale, rate,
                seed):
    # the forward checked q, k, v and the mask
    n, lq, dh = q.shape
    lk = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    scratch = (torch.empty(n * lq * dh, dtype=torch.float32, device=q.device)
               if needs_dq_scratch(lk, bf16) else None)
    lib = cuda_build.load_library()
    err = lib.coot_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        valid_u8.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), n, lq, lk, dh,
        num_heads, float(scale), *philox.kernel_args(rate, seed), int(bf16),
        cuda_build.stream(q))
    cuda_build.check(err, KERNEL + "_bwd")
    cuda_build.launch_counts[KERNEL + "_bwd"] += 1
    return dq, dk, dv


class _MaskedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, key_valid, num_heads, scale, rate, seed):
        ctx.params = (num_heads, scale, rate, seed)
        need_grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            if need_grad:
                ctx.save_for_backward(q, k, v, key_valid)
            return masked_attention_plain(q, k, v, key_valid, num_heads,
                                          scale, rate, seed)
        o, valid_u8, stats = _launch_fwd(q, k, v, key_valid, num_heads,
                                         scale, rate, seed, need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, valid_u8, o, stats)
        return o

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, rate, seed = ctx.params
        saved = ctx.saved_tensors
        if g.device.type == "cpu":
            q, k, v, key_valid = saved
            grads = masked_attention_backward_plain(
                q, k, v, key_valid, g, num_heads, scale, rate, seed)
        else:
            q, k, v, valid_u8, o, stats = saved
            grads = _launch_bwd(q, k, v, o, g, valid_u8, stats, num_heads,
                                scale, rate, seed)
        return (*grads, None, None, None, None, None)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: torch.Tensor, num_heads: int,
                     scale: float, rate: float = 0.0,
                     seed: int = 0) -> torch.Tensor:
    """
    Args:
        q: (N, Lq, Dh) with N = B * num_heads (batch-major, head-minor)
        k, v: (N, Lk, Dh)
        key_valid: (B, Lk) bool, True = attend
        scale: score scale (1/sqrt(Dh))
        rate, seed: dropout on P (rate 0: none)

    Returns (N, Lq, Dh) in q.dtype; differentiable in q, k and v.
    """
    return _MaskedAttention.apply(q, k, v, key_valid, int(num_heads),
                                  float(scale), float(rate), int(seed))
