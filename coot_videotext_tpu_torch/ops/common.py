"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import functools

import torch

ACT_CODES = {"none": 0, "gelu": 1, "relu": 2}


def is_bf16(name: str, x: torch.Tensor) -> bool:
    """True for bfloat16, False for float32; anything else raises."""
    if x.dtype == torch.bfloat16:
        return True
    if x.dtype == torch.float32:
        return False
    raise TypeError(f"{name}: compute dtype must be float32 or bfloat16, "
                    f"got {x.dtype}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu / dx of the exact-erf gelu, in float32."""
    return (0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
            + x * torch.exp(-0.5 * x * x) * 0.3989422804014327)


def act_fn(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return torch.nn.functional.gelu(x)
    if act == "relu":
        return torch.relu(x)
    return x


def act_grad(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return gelu_grad(x)
    if act == "relu":
        return (x > 0).to(torch.float32)
    return torch.ones_like(x)
