"""
B5 row gather: out[i] = table[idx[i]], optionally with truncated-normal
feature noise fused in: out = (table[idx] + std * tn).to(table.dtype).

Counterpart of coot_videotext_tpu/ops/pallas_gather.py::pallas_gather_rows
:64, run for every gather of the device feature store and of the slab
batches (data/device_store.py). On a CUDA tensor `gather_rows` launches the
Hopper kernel in csrc/gather.cu; on a CPU tensor it computes
`gather_rows_plain`, whose noise takes the same Philox bits (ops/philox.py).
Forward only: no gradient flows into the store, and a table that requires
grad is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coot_videotext_tpu_torch.ops import cuda_build, philox
from coot_videotext_tpu_torch.ops.common import check_tensor, is_bf16

KERNEL = "gather"


class GatherNoise(NamedTuple):
    """Truncated-normal noise of one gather: std * tn with tn on [-2, 2]
    from the Philox bits of (seed, site, output element). The kernel takes
    a `philox.Seed` (its state on the table's device) and derives the seed
    there; the plain version also takes a seed by value."""
    std: float
    seed: philox.SeedLike
    site: int


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    is_bf16(KERNEL, table)
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{KERNEL}: table must be (T, D) and idx (N,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{KERNEL}: idx must be int32, got {idx.dtype}")
    if table.shape[1] * table.element_size() % 16:
        raise ValueError(f"{KERNEL}: a row of {table.shape[1]} x "
                         f"{table.dtype} is not a multiple of 16 bytes")
    if table.requires_grad:
        raise ValueError(f"{KERNEL}: forward only, the table must not "
                         "require grad")
    check_tensor(KERNEL, "table", table, table.device)
    check_tensor(KERNEL, "idx", idx, table.device)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      noise: Optional[GatherNoise] = None) -> torch.Tensor:
    """Plain version: table[idx] (an index outside [0, T) raises instead
    of wrapping), plus the noise in float32, rounded once to the table's
    dtype."""
    if idx.numel() and (int(idx.min()) < 0
                        or int(idx.max()) >= table.shape[0]):
        raise IndexError(f"{KERNEL}: index outside [0, {table.shape[0]})")
    out = table[idx.long()]
    if noise is None or noise.std == 0.0:
        return out
    tn = philox.truncnorm(out.shape, noise.seed, noise.site, out.device)
    return (out.float() + noise.std * tn).to(table.dtype)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                noise: Optional[GatherNoise] = None) -> torch.Tensor:
    """
    Args:
        table: (T, D) float32 or bfloat16, contiguous; a row must be a
            multiple of 16 bytes (D % 8 == 0 in bf16, D % 4 == 0 in f32)
        idx: (N,) int32 in [0, T) on the table's device; the kernel traps
            on anything else
        noise: optional GatherNoise

    Returns (N, D) in the table's dtype.
    """
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, noise)
    if table.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {table.device}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if idx.numel() == 0:
        return out
    if table.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: table and output must be 16-byte "
                         "aligned")
    state, call, site, std = 0, 0, 0, 0.0
    if noise is not None and noise.std != 0.0:
        state = philox.state_pointer(noise.seed, table.device)
        call, site, std = noise.seed.call, noise.site, noise.std
    lib = cuda_build.load_library()
    err = lib.coot_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        table.shape[0], table.shape[1] * table.element_size(), state, call,
        site, std, philox.TRUNCNORM_LO, philox.TRUNCNORM_SPAN,
        int(table.dtype == torch.bfloat16), cuda_build.stream(table))
    cuda_build.check(err, KERNEL)
    cuda_build.launch_counts[KERNEL] += 1
    return out
