"""
Counter-based random bits: Philox4x32-10 in PyTorch integer ops, the same
bits as csrc/philox.cuh, the truncated-normal feature noise of B5 and the
uniforms of the train step built on them, and the seeds of the step's
random calls.

Element e of dropout site `site` takes word (e & 3) of
philox(counter = (lo32(e >> 2), hi32(e >> 2), site, 0), key = (lo32(seed),
hi32(seed))), so a mask depends only on (seed, site, element index). Every
32 x 32-bit product is split into 16-bit halves so that int64 never
overflows. Dropout keeps an element iff its bits >= floor(rate * 2^32)
(coot_videotext_tpu/ops/pallas_dropout.py:33-36); the stream differs from
the TPU's hardware PRNG, and masks are not part of any parity contract.

Seeds live on the device, as the JAX kernels read theirs from device
memory (pallas_dropout.py:129 `seed_from_key`). The train state holds a
seed state, a (1,) int64 tensor that the step advances once per step on
the device. Each random call of a step is a `Seed`: that tensor and the
call's position in the step, counted in the order the step makes its calls
(`dropout_seeds` numbers them, `next_seed` hands them out). Its 64-bit
seed is derived where it is used, on the device: words (0, 1) of
philox(counter = (call, 0, SITE_SEED, 0), key = state); `derive_seed`
gives the same number on the host. No seed crosses to the host, so a step
captured into a CUDA graph draws new bits on every replay. A module that
drops in training mode outside `dropout_seeds` raises, as flax's Dropout
does without a `dropout` rng.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple, Optional, Union

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
# sites of the feature-store gathers' noise (B5, data/device_store.py)
SITE_NOISE_VIDEO = 5
SITE_NOISE_CLIP = 6
SITE_NOISE_PARAGRAPH = 7
SITE_NOISE_SENTENCE = 8
# the derivation of each call's seed from the seed state (csrc/philox.cuh
# kSiteSeed), and the two draws of the train step keyed on the state itself
SITE_SEED = 9
SITE_JITTER = 10          # the train jitter of on-device sampling
SITE_CC = 11              # the cycle-consistency subsampling


def _f32(x: float) -> float:
    """x rounded to float32, as the kernels take it."""
    return float(torch.tensor(x, dtype=torch.float32))


# truncated normal on [-2, 2]: sqrt(2) * erfinv of a uniform on
# (erf(-sqrt 2), erf(sqrt 2)), as jax.random.truncated_normal draws it
TRUNCNORM_LO = _f32(-math.erf(math.sqrt(2.0)))
TRUNCNORM_SPAN = _f32(2.0 * math.erf(math.sqrt(2.0)))
_SQRT2 = _f32(math.sqrt(2.0))


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a < 2^32 and int64
    b < 2^32: b is split into 16-bit halves, each product < 2^48."""
    pl = a * (b & _MASK16)
    t = (pl >> 16) + a * (b >> 16)
    return t >> 16, ((t & _MASK16) << 16) | (pl & _MASK16)


def philox4x32_10(counter, key):
    """counter: 4 int64 tensors (words < 2^32); key: 2 ints or two 0-dim
    int64 tensors (words < 2^32). Returns the 4 output words as int64
    tensors."""
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


class Seed(NamedTuple):
    """The seed of one random call: the step's seed state ((1,) int64 on
    the call's device, read by the kernels through its pointer) and the
    call's position in the step."""
    state: torch.Tensor
    call: int


SeedLike = Union[int, Seed]


def seed_state(seed: int, device: Union[str, torch.device] = "cpu"
               ) -> torch.Tensor:
    """A seed state holding the 64-bit word `seed`."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed - (1 << 64) if seed >> 63 else seed],
                        dtype=torch.int64, device=device)


def _words(x):
    """(lo32, hi32) of a 64-bit word: a Python int or an int64 tensor."""
    return x & _MASK32, (x >> 32) & _MASK32


def derive_seed(state: int, call: int) -> int:
    """The seed of call `call` under the seed state `state`, on the host:
    the by-value form of a `Seed`."""
    c = tuple(torch.tensor([w], dtype=torch.int64)
              for w in (call, 0, SITE_SEED, 0))
    w0, w1, _, _ = philox4x32_10(c, _words(state & ((1 << 64) - 1)))
    return int(w0) | (int(w1) << 32)


def _key(seed: SeedLike):
    """The Philox key of a seed: two ints for a seed passed by value, two
    0-dim int64 tensors on the state's device for a `Seed`, derived there
    without a host sync."""
    if not isinstance(seed, Seed):
        return _words(int(seed))
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


def dropout_bits(seed: SeedLike, site: int, numel: int,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The 32-bit words of elements 0 .. numel-1 (int64 tensor); a `Seed`'s
    state must lie on `device`."""
    return _bits(_key(seed), site, numel, device)


def uniform(shape, state: torch.Tensor, site: int) -> torch.Tensor:
    """float32 uniforms on [0, 1) over `shape` on the state's device, keyed
    on the seed state itself at `site` (SITE_JITTER, SITE_CC): u = (bits >>
    8) * 2^-24."""
    numel = 1
    for n in shape:
        numel *= int(n)
    bits = _bits(_words(state.reshape(())), site, numel, state.device)
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(shape)


def threshold(rate: float) -> int:
    """floor(rate * 2^32), the keep threshold of the bits."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * 2 ** 32)


def kernel_args(rate: float, seed: Optional[Seed], device: torch.device):
    """(seed state pointer, call, threshold, 1/(1-rate)) as the kernels take
    them; threshold 0 means no dropout, and then the state is not read."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return (state_pointer(seed, device), seed.call, threshold(rate),
            1.0 / (1.0 - rate))


def state_pointer(seed: Seed, device: torch.device) -> int:
    """The device address of a `Seed`'s state, checked."""
    if not isinstance(seed, Seed):
        raise TypeError(f"a kernel takes a philox.Seed, got {type(seed)}")
    state = seed.state
    if (state.device != device or state.dtype != torch.int64
            or state.numel() != 1):
        raise ValueError(f"seed state must be one int64 on {device}, got "
                         f"{state.dtype} {tuple(state.shape)} on "
                         f"{state.device}")
    if not 0 <= seed.call < 2 ** 32:
        raise ValueError(f"call {seed.call} outside [0, 2^32)")
    return state.data_ptr()


def keep_factor(shape, seed: SeedLike, site: int, rate: float,
                device: torch.device = torch.device("cpu")
                ) -> torch.Tensor:
    """float32 keep * 1/(1 - rate) over `shape`, elements in row-major
    order: the factor every kernel multiplies by."""
    numel = 1
    for n in shape:
        numel *= int(n)
    keep = dropout_bits(seed, site, numel, device) >= threshold(rate)
    return (keep.to(torch.float32) * (1.0 / (1.0 - rate))).reshape(shape)


def truncnorm(shape, seed: SeedLike, site: int,
              device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """float32 standard normal truncated at +-2 over `shape`, elements in
    row-major order, from the bits of (seed, site, element): u = (bits >>
    8) * 2^-24, v = u * span + lo, tn = erfinv(v) * sqrt(2), each op
    rounded on its own as csrc/gather.cu does."""
    numel = 1
    for n in shape:
        numel *= int(n)
    bits = dropout_bits(seed, site, numel, device)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    v = u * TRUNCNORM_SPAN + TRUNCNORM_LO
    tn = torch.erfinv(v) * _SQRT2
    return tn.clamp_(-2.0, 2.0).reshape(shape)


_seed_state: Optional[torch.Tensor] = None
_calls = 0
_first = 0
_shard_base = 0

# the calls of one rank of a data-parallel group start at rank * RANK_CALLS
RANK_CALLS = 1 << 20
# a call on a tensor sharded over the `model` axis (a rank's heads) adds
# model rank * SHARD_CALLS to its position; a step makes fewer calls
SHARD_CALLS = 1 << 16


@contextlib.contextmanager
def dropout_seeds(state: Optional[torch.Tensor], rank: int = 0,
                  model_rank: int = 0) -> Iterator[None]:
    """Give the random calls made inside the seeds (state, c), (state, c +
    1), ... in the order they are made, from c = rank * RANK_CALLS; None:
    no seeds, training-mode dropout raises. `rank` is the data rank: the
    ranks of a data-parallel group hold the same seed state and make the
    same calls on their own rows, so the rank keeps their masks and noise
    apart (rank 0's calls are those of a single process). The ranks of
    one model group (tensor parallelism, parallel/tp.py) share their data
    rank, so a call on a replicated tensor draws the same bits on each; a
    call on a tensor sharded by `model_rank` asks `next_seed(sharded=True)`
    and is moved by model_rank * SHARD_CALLS."""
    global _seed_state, _calls, _first, _shard_base
    if not 0 <= rank < (1 << 32) // RANK_CALLS:
        raise ValueError(f"rank {rank} outside the seeds' call range")
    if not 0 <= model_rank < RANK_CALLS // SHARD_CALLS:
        raise ValueError(f"model rank {model_rank} outside the seeds' call "
                         "range")
    previous = _seed_state, _calls, _first, _shard_base
    _seed_state, _calls = state, rank * RANK_CALLS
    _first, _shard_base = _calls, model_rank * SHARD_CALLS
    try:
        yield
    finally:
        _seed_state, _calls, _first, _shard_base = previous


def next_seed(sharded: bool = False) -> Seed:
    """The seed of the next random call of the step; `sharded`: a call on
    this rank's shard of a tensor split over the `model` axis."""
    global _calls
    if _seed_state is None:
        raise RuntimeError(
            "dropout in training mode needs seeds: run the forward inside "
            "ops.philox.dropout_seeds(state), or call model.eval()")
    call = _calls
    if sharded and _shard_base:
        if call - _first >= SHARD_CALLS:
            raise RuntimeError(f"a step of more than {SHARD_CALLS} random "
                               "calls under tensor parallelism")
        call += _shard_base
    _calls += 1
    return Seed(_seed_state, call)
