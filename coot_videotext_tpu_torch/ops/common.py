"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

ACT_CODES = {"none": 0, "gelu": 1, "relu": 2}


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels are forward-only until the training slice adds their
    backward: refuse to run where autograd would record them, so no
    gradient can silently be wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: forward-only kernel called with grad enabled on "
            "tensors that require grad; run under torch.no_grad() or "
            "torch.inference_mode()")


def is_bf16(name: str, x: torch.Tensor) -> bool:
    """True for bfloat16, False for float32; anything else raises."""
    if x.dtype == torch.bfloat16:
        return True
    if x.dtype == torch.float32:
        return False
    raise TypeError(f"{name}: compute dtype must be float32 or bfloat16, "
                    f"got {x.dtype}")


def check_tensor(name: str, what: str, t: torch.Tensor,
                 device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def kernel_operand(t: torch.Tensor, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """A parameter as the kernel reads it: on `device`, in `dtype`,
    contiguous and 32-byte aligned (wmma loads it straight from device
    memory). Casting a float32 parameter to bfloat16 makes a fresh copy."""
    if t.device != device:
        raise ValueError(f"parameter on {t.device}, expected {device}")
    t = t.detach().to(dtype).contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t
