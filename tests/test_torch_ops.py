"""
Kernel modules of the PyTorch port (coot_videotext_tpu_torch/ops) held
against the JAX package.

Each plain PyTorch version is compared with the JAX `*_reference` and with
the JAX Pallas kernel run as the JAX package's own tests run it on the CPU
(`interpret=True` for the input FC and GenPool, force_tpu_interpret_mode for
attention), on the same numpy inputs, in float32 at atol = rtol = 2e-5.
The CUDA kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py holds them against the plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coot_videotext_tpu.ops import pallas_attention as jattn
from coot_videotext_tpu.ops import pallas_genpool as jgen
from coot_videotext_tpu.ops import pallas_input_fc as jfc
from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.attention import (
    masked_attention, masked_attention_plain)
from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
from coot_videotext_tpu_torch.ops.input_fc import (
    fused_input_fc, fused_input_fc_plain)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _fc_inputs(s, din, dout, seed=0, constant_rows=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(s, din) * 2 + 0.5).astype(np.float32)
    x[:constant_rows] = 3.0  # zero-variance rows (padded slots)
    gain = (1 + 0.1 * rng.randn(din)).astype(np.float32)
    bias = (0.1 * rng.randn(din)).astype(np.float32)
    w = (rng.randn(din, dout) / np.sqrt(din)).astype(np.float32)
    b = (0.1 * rng.randn(dout)).astype(np.float32)
    return x, gain, bias, w, b


def _torch_fc(x, gain, bias, w, b, act, fn=fused_input_fc):
    t = torch.from_numpy
    return fn(t(x), t(gain), t(bias), t(np.ascontiguousarray(w.T)), t(b),
              1e-6, act).numpy()


@pytest.mark.parametrize("act", ["gelu", "none"])
def test_input_fc_plain_matches_jax_reference(act):
    """S = 70 is not a multiple of 32; rows 0-1 are constant."""
    x, gain, bias, w, b = _fc_inputs(70, 96, 40)
    ref = np.asarray(jfc.fused_input_fc_reference(
        jnp.asarray(x), gain, bias, w, b, 1e-6, act))
    np.testing.assert_allclose(_torch_fc(x, gain, bias, w, b, act), ref,
                               **TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        _torch_fc(x, gain, bias, w, b, act),
        _torch_fc(x, gain, bias, w, b, act, fused_input_fc_plain))


def test_input_fc_plain_matches_pallas_interpret():
    x, gain, bias, w, b = _fc_inputs(48, 128, 64, seed=1)
    y, _ = jfc._fwd_call(jnp.asarray(x), gain, bias, w, b, 1e-6, "gelu",
                         need_pre=False, interpret=True)
    np.testing.assert_allclose(_torch_fc(x, gain, bias, w, b, "gelu"),
                               np.asarray(y), **TOL)


def _genpool_inputs(s, length, d, h, heads, seed=0):
    rng = np.random.RandomState(seed)
    f = rng.randn(s, length, d).astype(np.float32)
    mask = np.ones((s, length), bool)
    for i in range(s):
        mask[i, rng.randint(1, length + 1):] = False
    mask[-1] = False  # all-masked row: pools to the uniform average
    w1h = (rng.randn(heads, d, h // heads) * 0.1).astype(np.float32)
    b1h = (rng.randn(heads, h // heads) * 0.1).astype(np.float32)
    w2h = (rng.randn(heads, h // heads, d // heads) * 0.1).astype(np.float32)
    b2h = (rng.randn(heads, d // heads) * 0.1).astype(np.float32)
    return f, mask, w1h, b1h, w2h, b2h


def _torch_genpool(f, mask, w1h, b1h, w2h, b2h, act):
    t = torch.from_numpy
    return genpool(t(f), t(mask), t(w1h), t(b1h), t(w2h), t(b2h),
                   act).numpy()


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
def test_genpool_plain_matches_jax_reference(act):
    """L = 20 spans two of the CUDA kernel's 16-row chunks."""
    f, mask, *heads = _genpool_inputs(6, 20, 32, 64, 2)
    flat = jgen.head_params_to_flat(*heads)
    ref = np.asarray(jgen.fused_genpool_reference(
        jnp.asarray(f), jnp.asarray(mask), *flat, act))
    out = _torch_genpool(f, mask, *heads, act)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out[-1], f[-1].mean(axis=0), **TOL)


def test_genpool_plain_matches_pallas_interpret():
    f, mask, *heads = _genpool_inputs(8, 16, 128, 256, 2, seed=3)
    w1, b1, w2, b2 = (jnp.asarray(a) for a in
                      jgen.head_params_to_flat(*heads))
    out = jgen._fwd_call(jnp.asarray(f), jnp.asarray(mask), w1, b1, w2, b2,
                         jnp.zeros(1, jnp.int32), "gelu", 0.0, False,
                         interpret=True)
    np.testing.assert_allclose(_torch_genpool(f, mask, *heads, "gelu"),
                               np.asarray(out), **TOL)


def _attn_inputs(b, heads, lq, lk, dh, seed=0):
    rng = np.random.RandomState(seed)
    n = b * heads
    q = rng.randn(n, lq, dh).astype(np.float32)
    k = rng.randn(n, lk, dh).astype(np.float32)
    v = rng.randn(n, lk, dh).astype(np.float32)
    key_valid = np.arange(lk)[None] < rng.randint(1, lk + 1, (b, 1))
    key_valid[-1] = False  # all keys masked: uniform average of v
    return q, k, v, key_valid


def _jax_mask(key_valid, heads, lq):
    m = np.repeat(key_valid, heads, axis=0)[:, None, :]
    return jnp.asarray(np.broadcast_to(m, (m.shape[0], lq, m.shape[2])))


@pytest.mark.parametrize("b,heads,lq,lk", [(3, 2, 20, 20), (4, 8, 1, 16)],
                         ids=["self", "cross_lq1"])
def test_attention_plain_matches_jax(b, heads, lq, lk):
    """d_head = 48 (COOT's), a self-attention and an Lq = 1 cross shape,
    one batch row with every key masked; against the JAX reference and
    the interpret-mode Pallas kernel."""
    q, k, v, key_valid = _attn_inputs(b, heads, lq, lk, 48)
    scale = 48 ** -0.5
    t = torch.from_numpy
    out = masked_attention(t(q), t(k), t(v), t(key_valid), heads,
                           scale).numpy()
    jm = _jax_mask(key_valid, heads, lq)
    ref = np.asarray(jattn.masked_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, scale))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(jattn.pallas_masked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, scale))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pal, **TOL)
    last = slice((b - 1) * heads, b * heads)
    np.testing.assert_allclose(
        out[last], np.broadcast_to(v[last].mean(axis=1, keepdims=True),
                                   out[last].shape), **TOL)


def test_wrappers_refuse_autograd():
    """Forward-only kernels: no silently wrong gradient."""
    x, gain, bias, w, b = _fc_inputs(8, 16, 8)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    t = torch.from_numpy
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_input_fc(t(x), t(gain), t(bias), wt, t(b), 1e-6, "gelu")
    with torch.no_grad():
        fused_input_fc(t(x), t(gain), t(bias), wt, t(b), 1e-6, "gelu")


def test_cpu_path_launches_no_kernel():
    cuda_build.reset_launch_counts()
    q, k, v, key_valid = _attn_inputs(2, 2, 4, 4, 8)
    t = torch.from_numpy
    masked_attention(t(q), t(k), t(v), t(key_valid), 2, 0.3)
    assert sum(cuda_build.launch_counts.values()) == 0
