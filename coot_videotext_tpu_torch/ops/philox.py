"""
Counter-based dropout bits: Philox4x32-10 in PyTorch integer ops, the same
bits as csrc/philox.cuh, and the source of per-call dropout seeds.

Element e of dropout site `site` takes word (e & 3) of
philox(counter = (lo32(e >> 2), hi32(e >> 2), site, 0), key = (lo32(seed),
hi32(seed))), so a mask depends only on (seed, site, element index). Every
32 x 32-bit product is split into 16-bit halves so that int64 never
overflows. Dropout keeps an element iff its bits >= floor(rate * 2^32)
(coot_videotext_tpu/ops/pallas_dropout.py:33-36); the stream differs from
the TPU's hardware PRNG, and masks are not part of any parity contract.

Seeds come from an explicit CPU `torch.Generator` that the train step owns
(`dropout_seeds`): drawing them on the host costs no device sync. A module
that drops in training mode without such a generator raises, as flax's
Dropout does without a `dropout` rng.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF

# sites of the dropout kernels; each call draws its own seed as well
SITE_DROPOUT = 0          # B4, the Dropout module
SITE_ATTENTION = 1        # B3, dropout on P
SITE_GENPOOL_HIDDEN = 2   # B2, the hidden pre-activation
SITE_GENPOOL_LOGITS = 3   # B2, the second projection
SITE_GENPOOL_WEIGHTS = 4  # B2, the softmax weights


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a and int64 b < 2^32."""
    al, ah = a & _MASK16, a >> 16
    bl, bh = b & _MASK16, b >> 16
    p0, p1, p2, p3 = al * bl, al * bh, ah * bl, ah * bh
    mid = (p0 >> 16) + (p1 & _MASK16) + (p2 & _MASK16)
    lo = ((mid & _MASK16) << 16) | (p0 & _MASK16)
    hi = p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    """counter: 4 int64 tensors (words < 2^32); key: 2 ints. Returns the 4
    output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: int, site: int, numel: int,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The 32-bit words of elements 0 .. numel-1 (int64 tensor)."""
    groups = (numel + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(g)
    words = philox4x32_10(
        (g & _MASK32, g >> 32, zeros + site, zeros),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def threshold(rate: float) -> int:
    """floor(rate * 2^32), the keep threshold of the bits."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * 2 ** 32)


def kernel_args(rate: float, seed: int):
    """(seed, threshold, 1/(1-rate)) as the kernels take them; threshold 0
    means no dropout."""
    if rate <= 0.0:
        return 0, 0, 1.0
    return seed, threshold(rate), 1.0 / (1.0 - rate)


def keep_factor(shape, seed: int, site: int, rate: float,
                device: torch.device = torch.device("cpu")
                ) -> torch.Tensor:
    """float32 keep * 1/(1 - rate) over `shape`, elements in row-major
    order: the factor every kernel multiplies by."""
    numel = 1
    for n in shape:
        numel *= int(n)
    keep = dropout_bits(seed, site, numel, device) >= threshold(rate)
    return (keep.to(torch.float32) * (1.0 / (1.0 - rate))).reshape(shape)


_seed_generator: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_seeds(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Draw the seeds of every dropout launched inside from `generator`
    (a CPU generator); None: no dropout seeds, training-mode dropout
    raises."""
    global _seed_generator
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("dropout seeds come from a CPU torch.Generator")
    previous = _seed_generator
    _seed_generator = generator
    try:
        yield
    finally:
        _seed_generator = previous


def next_seed() -> int:
    """A fresh 64-bit seed for one dropout call."""
    if _seed_generator is None:
        raise RuntimeError(
            "dropout in training mode needs seeds: run the forward inside "
            "ops.philox.dropout_seeds(generator), or call model.eval()")
    return int(torch.randint(0, 2 ** 63 - 1, (1,),
                             generator=_seed_generator).item())
