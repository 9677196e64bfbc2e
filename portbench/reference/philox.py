"""
Philox4x32-10 bits in plain PyTorch integer ops, frozen here so that the
references draw the program's random stream from the same seed without
importing it.

The program keys every random draw of a train step on its seed state (a
64-bit word the step advances by one) and on the call's position in the
step: call c's key is words (0, 1) of philox(counter = (c, 0, SITE_SEED,
0), key = state). Element e of a draw at `site` takes word (e & 3) of
philox(counter = (lo32(e >> 2), hi32(e >> 2), site, 0), key). Dropout
keeps an element iff its bits >= floor(rate * 2^32); uniforms are
(bits >> 8) * 2^-24; the truncated normal is sqrt(2) * erfinv of a
uniform on (erf(-sqrt 2), erf(sqrt 2)). The references take the same seed
from the benchmark and recompute the masks, jitter and noise of each step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF

SITE_DROPOUT = 0
SITE_ATTENTION = 1
SITE_GENPOOL_HIDDEN = 2
SITE_GENPOOL_LOGITS = 3
SITE_GENPOOL_WEIGHTS = 4
SITE_NOISE_VIDEO = 5
SITE_NOISE_CLIP = 6
SITE_NOISE_PARAGRAPH = 7
SITE_NOISE_SENTENCE = 8
SITE_SEED = 9
SITE_JITTER = 10
SITE_CC = 11


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


TRUNCNORM_LO = _f32(-math.erf(math.sqrt(2.0)))
TRUNCNORM_SPAN = _f32(2.0 * math.erf(math.sqrt(2.0)))
_SQRT2 = _f32(math.sqrt(2.0))


def _mulhilo(a: int, b: torch.Tensor):
    pl = a * (b & _MASK16)
    t = (pl >> 16) + a * (b >> 16)
    return t >> 16, ((t & _MASK16) << 16) | (pl & _MASK16)


def philox4x32_10(counter, key):
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


def seed_state(seed: int, device="cpu") -> torch.Tensor:
    """A (1,) int64 tensor holding the 64-bit word `seed`."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed - (1 << 64) if seed >> 63 else seed],
                        dtype=torch.int64, device=device)


def _words(x):
    return x & _MASK32, (x >> 32) & _MASK32


class Seed(NamedTuple):
    """One random call: the step's seed state and the call's position."""
    state: torch.Tensor
    call: int


def _key(seed: Seed):
    state = seed.state.reshape(())
    zero = torch.zeros_like(state)
    w0, w1, _, _ = philox4x32_10(
        (zero + seed.call, zero, zero + SITE_SEED, zero), _words(state))
    return w0, w1


def _bits(key, site: int, numel: int, device) -> torch.Tensor:
    groups = (numel + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(g)
    words = philox4x32_10((g & _MASK32, g >> 32, zeros + site, zeros), key)
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def keep_factor(shape, seed: Seed, site: int, rate: float) -> torch.Tensor:
    """float32 keep / (1 - rate) over `shape`, row-major elements."""
    device = seed.state.device
    bits = _bits(_key(seed), site, _numel(shape), device)
    keep = bits >= int(rate * 2 ** 32)
    return (keep.to(torch.float32) * (1.0 / (1.0 - rate))).reshape(shape)


def truncnorm(shape, seed: Seed, site: int) -> torch.Tensor:
    """float32 standard normal truncated at +-2 over `shape`."""
    bits = _bits(_key(seed), site, _numel(shape), seed.state.device)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    v = u * TRUNCNORM_SPAN + TRUNCNORM_LO
    return (torch.erfinv(v) * _SQRT2).clamp_(-2.0, 2.0).reshape(shape)


def uniform(shape, state: torch.Tensor, site: int) -> torch.Tensor:
    """float32 uniforms on [0, 1) keyed on the seed state itself."""
    bits = _bits(_words(state.reshape(())), site, _numel(shape),
                 state.device)
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(shape)


class Calls:
    """Hands out the seeds of one step's random calls in order."""

    def __init__(self, state: torch.Tensor) -> None:
        self.state = state
        self.count = 0

    def next(self) -> Seed:
        seed = Seed(self.state, self.count)
        self.count += 1
        return seed
