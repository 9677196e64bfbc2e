"""
B2 GenPool, forward and backward: per-head MLP over the features, a masked
softmax over the sequence (fill -32752) and the weighted sum, with dropout
at its three sites (the hidden pre-activation, the second projection and
the softmax weights).

Counterpart of coot_videotext_tpu/ops/pallas_genpool.py::fused_genpool
:284 (forward :319, backward :358, `_recompute` :149). `genpool` takes the
module's head-stacked parameters (reference poolers.py:129-139 layout) and
returns their gradients in the same shapes. It is a torch.autograd.Function:
on CUDA tensors its forward and backward launch the Hopper kernels in
csrc/genpool.cu, which read w1 in the flat head-interleaved (D, heads*dh)
layout and w2 per head; on CPU tensors they compute `genpool_plain` (the
port of `fused_genpool_reference` :391, with the masks) and
`genpool_backward_plain` (the formulas of `_bwd_kernel` :202). In bf16
the forward is a tensor-core pass over flat tiles of the S*L rows that
writes the masked, dropped logits (an f32 scratch of S*L x D) and a
pooling pass over L; the backward is a fused pass over the same tiles
plus two tensor-core weight-gradient products (`backward_plan`). In
float32 both run a kernel per pooled row (and FMA reductions). The output
column order is [h*dho + o], the reference's head interleave. The masks
come from Philox bits (ops/philox.py), one seed per call, so the backward
regenerates them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from coot_videotext_tpu_torch.ops import cuda_build, philox
from coot_videotext_tpu_torch.ops.common import (
    ACT_CODES, act_fn, act_grad, check_tensor, is_bf16, kernel_operand)
from coot_videotext_tpu_torch.ops.input_fc import (
    G_COLS, G_ROWS, sm_count, splits_for_tiles)
from coot_videotext_tpu_torch.typext import INF

KERNEL = "genpool"


def backward_plan(s: int, length: int, d: int, h: int, heads: int,
                  sms: int) -> Dict[str, int]:
    """Row splits of the bf16 backward's two weight-gradient products, dw1
    (D x H) and dw2 (heads items of dh x dho), on csrc/tn_mma.cuh's G_ROWS
    x G_COLS tiles. The tile pass picks its own tile (csrc/genpool.cu,
    tile_plan)."""
    rows = s * length
    dh, dho = h // heads, d // heads
    return dict(
        splits_w1=splits_for_tiles(
            rows, -(-d // G_ROWS) * -(-h // G_COLS), sms),
        splits_w2=splits_for_tiles(
            rows, heads * -(-dh // G_ROWS) * -(-dho // G_COLS), sms))


def flat_w1(w1_heads: torch.Tensor) -> torch.Tensor:
    """(heads, D, dh) -> (D, heads*dh), column h*dh + k = head h, unit k."""
    heads, d, dh = w1_heads.shape
    return w1_heads.permute(1, 0, 2).reshape(d, heads * dh)


def _factors(shape3, seed: int, rate: float, device
             ) -> Dict[str, torch.Tensor]:
    """The keep factors of the three sites (empty without dropout)."""
    if rate <= 0.0:
        return {}
    s, length, d, h = shape3
    return {
        "hidden": philox.keep_factor((s, length, h), seed,
                                     philox.SITE_GENPOOL_HIDDEN, rate,
                                     device),
        "logits": philox.keep_factor((s, length, d), seed,
                                     philox.SITE_GENPOOL_LOGITS, rate,
                                     device),
        "weights": philox.keep_factor((s, length, d), seed,
                                      philox.SITE_GENPOOL_WEIGHTS, rate,
                                      device),
    }


def _recompute(f, mask, w1_heads, b1_heads, w2_heads, b2_heads, act, rate,
               seed):
    """The forward's intermediates with the kernel's numerics: products of
    compute-dtype operands accumulated in f32, the hidden activations
    rounded to the compute dtype, f32 softmax."""
    cdtype = f.dtype
    heads, dh, dho = w2_heads.shape
    s, length, d = f.shape
    f32 = f.float()
    w1c = flat_w1(w1_heads).to(cdtype).float()
    w2c = w2_heads.to(cdtype).float()
    fac = _factors((s, length, d, w1c.shape[1]), seed, rate, f.device)
    pre1 = f32 @ w1c + b1_heads.reshape(-1).float()
    hin = pre1 * fac["hidden"] if fac else pre1
    h1 = act_fn(hin, act).to(cdtype).float()
    h2 = torch.cat([h1[..., hh * dh:(hh + 1) * dh] @ w2c[hh]
                    for hh in range(heads)], dim=-1)
    logits = h2 + b2_heads.reshape(-1).float()
    if fac:
        logits = logits * fac["logits"]
    valid = mask.bool()[..., None]
    logits = torch.where(valid, logits, torch.full_like(logits, -INF))
    sm = torch.softmax(logits, dim=1)
    smd = sm * fac["weights"] if fac else sm
    return dict(f32=f32, w1c=w1c, w2c=w2c, fac=fac, hin=hin, h1=h1, sm=sm,
                smd=smd, valid=valid)


def genpool_plain(f: torch.Tensor, mask: torch.Tensor,
                  w1_heads: torch.Tensor, b1_heads: torch.Tensor,
                  w2_heads: torch.Tensor, b2_heads: torch.Tensor,
                  act: str, rate: float = 0.0, seed: int = 0
                  ) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics and masks."""
    r = _recompute(f, mask, w1_heads, b1_heads, w2_heads, b2_heads, act,
                   rate, seed)
    return (r["f32"] * r["smd"]).sum(dim=1).to(f.dtype)


def genpool_backward_plain(
        f: torch.Tensor, mask: torch.Tensor, w1_heads: torch.Tensor,
        b1_heads: torch.Tensor, w2_heads: torch.Tensor,
        b2_heads: torch.Tensor, act: str, dout: torch.Tensor,
        rate: float = 0.0, seed: int = 0
) -> Tuple[torch.Tensor, ...]:
    """(df, dw1_heads, db1_heads, dw2_heads, db2_heads) by the kernel's
    formulas: dsm = dout * f * keep3, dlg = where(valid, sm * (dsm -
    dout * out), 0), dh2 = dlg * keep2 (rounded), dpre1 = (dh2 w2^T) *
    act'(h1_in) * keep1 (rounded), df = dout * smd + dpre1 w1^T; the
    weight gradients are f32 sums over all rows."""
    cdtype = f.dtype
    heads, dh, dho = w2_heads.shape
    s, length, d = f.shape
    r = _recompute(f, mask, w1_heads, b1_heads, w2_heads, b2_heads, act,
                   rate, seed)
    fac = r["fac"]
    g = dout.float()[:, None, :]
    out32 = (r["f32"] * r["smd"]).sum(dim=1, keepdim=True)
    f3 = fac.get("weights", 1.0)
    dsm = g * r["f32"] * f3
    dlg = torch.where(r["valid"], r["sm"] * (dsm - g * out32),
                      torch.zeros_like(dsm))
    dh2 = (dlg * fac.get("logits", 1.0)).to(cdtype).float()
    dh1 = torch.cat([dh2[..., hh * dho:(hh + 1) * dho] @ r["w2c"][hh].t()
                     for hh in range(heads)], dim=-1)
    dpre1 = (dh1 * act_grad(r["hin"], act)
             * fac.get("hidden", 1.0)).to(cdtype).float()
    df = (g * r["smd"] + dpre1 @ r["w1c"].t()).to(cdtype)
    rows = s * length
    f2, h1 = r["f32"].reshape(rows, d), r["h1"].reshape(rows, -1)
    dpre1, dh2 = dpre1.reshape(rows, -1), dh2.reshape(rows, d)
    dw1 = (f2.t() @ dpre1).reshape(d, heads, dh).permute(1, 0, 2)
    dw2 = torch.stack([h1[:, hh * dh:(hh + 1) * dh].t()
                       @ dh2[:, hh * dho:(hh + 1) * dho]
                       for hh in range(heads)])
    return (df, dw1, dpre1.sum(dim=0).reshape(heads, dh), dw2,
            dh2.sum(dim=0).reshape(heads, dho))


def _check(f, mask, w1_heads, w2_heads, act):
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
    check_tensor(KERNEL, "f", f, f.device)
    return s, length, d, h, heads, is_bf16(KERNEL, f)


class _GenPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, mask, w1_heads, b1_heads, w2_heads, b2_heads, act,
                rate, seed):
        ctx.params = (act, rate, seed)
        need_grad = any(ctx.needs_input_grad[:6])
        if f.device.type == "cpu":
            if need_grad:
                ctx.save_for_backward(f, mask, w1_heads, b1_heads, w2_heads,
                                      b2_heads)
            return genpool_plain(f, mask, w1_heads, b1_heads, w2_heads,
                                 b2_heads, act, rate, seed)
        s, length, d, h, heads, bf16 = _check(f, mask, w1_heads, w2_heads,
                                              act)
        if bf16 and f.data_ptr() % 16:  # the pooling pass's vector loads
            f = f.clone()
        mask_u8 = mask.to(device=f.device, dtype=torch.uint8).contiguous()
        w1 = kernel_operand(flat_w1(w1_heads), f.dtype, f.device)
        w2 = kernel_operand(w2_heads, f.dtype, f.device)
        b1 = kernel_operand(b1_heads.reshape(-1), torch.float32, f.device)
        b2 = kernel_operand(b2_heads.reshape(-1), torch.float32, f.device)
        out = torch.empty((s, d), dtype=f.dtype, device=f.device)
        stats = (torch.empty((3, s, d), dtype=torch.float32, device=f.device)
                 if need_grad else None)
        logits = (torch.empty((s * length, d), dtype=torch.float32,
                              device=f.device) if bf16 else None)
        lib = cuda_build.load_library()
        err = lib.coot_genpool_fwd(
            f.data_ptr(), mask_u8.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            0 if stats is None else stats.data_ptr(),
            0 if logits is None else logits.data_ptr(), s, length, d, h,
            heads, ACT_CODES[act], *philox.kernel_args(rate, seed), int(bf16),
            cuda_build.stream(f))
        cuda_build.check(err, KERNEL)
        cuda_build.launch_counts[KERNEL] += 1
        if need_grad:
            ctx.save_for_backward(f, mask_u8, w1, b1, w2, b2, stats)
            ctx.heads = (heads, h // heads, d // heads)
        return out

    @staticmethod
    def backward(ctx, dout):
        act, rate, seed = ctx.params
        if dout.device.type == "cpu":
            grads = genpool_backward_plain(*ctx.saved_tensors, act, dout,
                                           rate, seed)
            return (grads[0], None, *grads[1:], None, None, None)
        f, mask_u8, w1, b1, w2, b2, stats = ctx.saved_tensors
        heads, dh, dho = ctx.heads
        s, length, d = f.shape
        h = heads * dh
        dev, cdt = f.device, f.dtype
        f32 = dict(dtype=torch.float32, device=dev)
        rows = s * length
        bf16 = is_bf16(KERNEL, f)
        df = torch.empty_like(f)
        h1 = torch.empty((rows, h), dtype=cdt, device=dev)
        dpre = torch.empty((rows, h), dtype=cdt, device=dev)
        dh2 = torch.empty((rows, d), dtype=cdt, device=dev)
        # dw1 | db1 and dw2 | db2 each in one buffer (the bf16 path sums
        # each pair in one pass)
        out1 = torch.empty(d * h + h, **f32)
        out2 = torch.empty(heads * dh * dho + d, **f32)
        # bf16: act'(hin) * keep1 from the tile pass's pass A to its pass B
        fac = torch.empty((rows, h) if bf16 else 0, **f32)
        if bf16:
            plan = backward_plan(s, length, d, h, heads, sm_count(dev.index))
            splits, splits2 = plan["splits_w1"], plan["splits_w2"]
            scratch = torch.empty(splits * (d * h + h)
                                  + splits2 * (heads * dh * dho + d), **f32)
        else:
            splits = cuda_build.splits_for(rows, -(-d // 64) * -(-h // 64))
            splits2 = 0
            scratch = torch.empty(splits * d * h, **f32)
        dout = dout.to(cdt).contiguous()
        lib = cuda_build.load_library()
        err = lib.coot_genpool_bwd(
            f.data_ptr(), mask_u8.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), stats.data_ptr(), dout.data_ptr(),
            df.data_ptr(), h1.data_ptr(), dpre.data_ptr(), dh2.data_ptr(),
            fac.data_ptr(), scratch.data_ptr(), out1.data_ptr(),
            out1[d * h:].data_ptr(),
            out2.data_ptr(), out2[heads * dh * dho:].data_ptr(), s, length,
            d, h, heads, ACT_CODES[act], *philox.kernel_args(rate, seed),
            splits, splits2, int(bf16), cuda_build.stream(f))
        cuda_build.check(err, KERNEL + "_bwd")
        cuda_build.launch_counts[KERNEL + "_bwd"] += 1
        dw1_heads = out1[:d * h].view(d, heads, dh).permute(1, 0, 2)
        return (df, None, dw1_heads, out1[d * h:].view(heads, dh),
                out2[:heads * dh * dho].view(heads, dh, dho),
                out2[heads * dh * dho:].view(heads, dho), None, None, None)


def genpool(f: torch.Tensor, mask: torch.Tensor, w1_heads: torch.Tensor,
            b1_heads: torch.Tensor, w2_heads: torch.Tensor,
            b2_heads: torch.Tensor, act: str, rate: float = 0.0,
            seed: int = 0) -> torch.Tensor:
    """
    Args:
        f: (S, L, D) features in the compute dtype (float32 or bfloat16)
        mask: (S, L) validity, True = valid
        w1_heads: (heads, D, dh); b1_heads: (heads, dh)
        w2_heads: (heads, dh, dho); b2_heads: (heads, dho), D = heads*dho
        act: "gelu" | "relu" | "none"
        rate, seed: dropout at the three sites (rate 0: none)

    Returns (S, D) pooled rows in f.dtype; differentiable in f and the four
    parameters.
    """
    if act not in ACT_CODES:
        raise ValueError(f"{KERNEL} supports {sorted(ACT_CODES)}, got {act}")
    return _GenPool.apply(f, mask, w1_heads, b1_heads, w2_heads, b2_heads,
                          act, float(rate), int(seed))
