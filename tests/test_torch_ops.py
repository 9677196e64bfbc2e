"""
Kernel modules of the PyTorch port (coot_videotext_tpu_torch/ops) held
against the JAX package.

Each plain PyTorch version is compared with the JAX `*_reference` and with
the JAX Pallas kernel run as the JAX package's own tests run it on the CPU
(`interpret=True` for the input FC and GenPool, force_tpu_interpret_mode for
attention), on the same numpy inputs, in float32: forwards at atol = rtol =
2e-5; each plain backward against jax.grad of the reference and against the
Pallas backward kernel at 1e-4 x max(1, max |reference|) per tensor (the
two sum in different orders). With dropout on, each plain backward is held
against autograd through its own plain forward (the masks are Philox bits
that JAX does not draw). The CUDA kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py holds them against the plain versions.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from coot_videotext_tpu.ops import pallas_attention as jattn
from coot_videotext_tpu.ops import pallas_genpool as jgen
from coot_videotext_tpu.ops import pallas_input_fc as jfc
from coot_videotext_tpu_torch.ops import coot_norm as cn_mod
from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops import dropout as dropout_mod
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.attention import (
    forward_plan, masked_attention, masked_attention_backward_plain,
    masked_attention_plain, needs_dq_scratch)
from coot_videotext_tpu_torch.ops.dropout import dropout, dropout_plain
from coot_videotext_tpu_torch.ops import genpool as gp_mod
from coot_videotext_tpu_torch.ops.common import act_fn, act_grad
from coot_videotext_tpu_torch.ops.genpool import (
    flat_w1, genpool, genpool_backward_plain, genpool_plain)
from coot_videotext_tpu_torch.ops import input_fc as fc_mod
from coot_videotext_tpu_torch.ops.input_fc import (
    fused_input_fc, fused_input_fc_backward_plain, fused_input_fc_plain)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = 1e-4


def _close_grad(ours, ref, name=""):
    """max |ours - ref| <= GRAD_TOL * max(1, max |ref|)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(ref).max()), (name, err)


def _fc_inputs(s, din, dout, seed=0, constant_rows=2, offset=False):
    """x ~ 2 N + 0.5, or with `offset` 100 + 0.5 N (mean^2 >> var, where
    unshifted sums would cancel)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(s, din)
    x = (x * 0.5 + 100.0 if offset else x * 2 + 0.5).astype(np.float32)
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


FC_CASES = [pytest.param("gelu", False, id="gelu"),
            pytest.param("none", False, id="none"),
            pytest.param("gelu", True, id="gelu-offset100")]


@pytest.mark.parametrize("act,offset", FC_CASES)
def test_input_fc_plain_matches_jax_reference(act, offset):
    """S = 70 is not a multiple of 32; rows 0-1 are constant; and rows of
    100 + 0.5 N."""
    x, gain, bias, w, b = _fc_inputs(70, 96, 40, offset=offset)
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
    """B1 refuses a gradient into its input (pipeline data, as the JAX
    kernel's zero input cotangent); gradients flow to every parameter of
    B1-B3 and through B4."""
    x, gain, bias, w, b = _fc_inputs(8, 16, 8)
    t = torch.from_numpy
    params = [t(gain).requires_grad_(), t(bias).requires_grad_(),
              t(np.ascontiguousarray(w.T)).requires_grad_(),
              t(b).requires_grad_()]
    with pytest.raises(ValueError, match="pipeline data"):
        fused_input_fc(t(x).requires_grad_(), *params, 1e-6, "gelu")
    fused_input_fc(t(x), *params, 1e-6, "gelu").sum().backward()
    f, mask, *heads = _genpool_inputs(3, 20, 32, 64, 2)
    f = t(f).requires_grad_()
    heads = [t(a).requires_grad_() for a in heads]
    pooled = genpool(f, t(mask), *heads, "gelu")
    pooled.backward(torch.randn_like(pooled))
    q, k, v, key_valid = (t(a) for a in _attn_inputs(4, 2, 6, 16, 8))
    qkv = [a.requires_grad_() for a in (q, k, v)]
    out = masked_attention(*qkv, key_valid, 2, 0.3)
    out.backward(torch.randn_like(out))
    y = t(x).requires_grad_()
    dropout(y, philox.Seed(philox.seed_state(5), 0), 0.5).sum().backward()
    # b2 (heads[3]) shifts a whole softmax column: its gradient is ~0
    for p in params + [f] + heads[:3] + qkv + [y]:
        assert p.grad is not None and bool(p.grad.abs().sum() > 0)
    assert heads[3].grad is not None


@pytest.mark.parametrize("act,offset", FC_CASES)
def test_input_fc_backward_matches_jax_grad(act, offset):
    """The plain backward, and autograd through the wrapper, against
    jax.grad of the JAX reference; constant rows included, and rows of
    100 + 0.5 N."""
    x, gain, bias, w, b = _fc_inputs(70, 96, 40, seed=2, offset=offset)
    dy = np.random.RandomState(3).randn(70, 40).astype(np.float32)

    def loss(g_, bi_, w_, b_):
        y = jfc.fused_input_fc_reference(jnp.asarray(x), g_, bi_, w_, b_,
                                         1e-6, act)
        return jnp.sum(y * dy)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(gain, bias, w, b)
    t = torch.from_numpy
    plain = fused_input_fc_backward_plain(
        t(x), t(gain), t(bias), t(np.ascontiguousarray(w.T)), t(b), 1e-6,
        act, t(dy))
    params = [t(gain).requires_grad_(), t(bias).requires_grad_(),
              t(np.ascontiguousarray(w.T)).requires_grad_(),
              t(b).requires_grad_()]
    fused_input_fc(t(x), *params, 1e-6, act).backward(t(dy))
    for name, ours, grad, r in zip(("gain", "bias", "w", "b"), plain,
                                   params, ref):
        r = np.asarray(r).T if name == "w" else np.asarray(r)
        _close_grad(ours.numpy(), r, name)
        _close_grad(grad.grad.numpy(), r, name)


def _jax_fc_grads(x, gain, bias, w, b, act, dy):
    def loss(g_, bi_, w_, b_):
        y = jfc.fused_input_fc_reference(jnp.asarray(x), g_, bi_, w_, b_,
                                         1e-6, act)
        return jnp.sum(y * dy)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(gain, bias, w, b)


@pytest.mark.parametrize("act", ["gelu", "none"])
def test_input_fc_backward_one_product_identity(act):
    """The algebra of the CUDA backward (csrc/input_fc.cu): one product
    G = xhat^T dpre gives dW = gain (x) G + bias (x) db, dgain = rowsum(W .
    G) and dbias = W db, held in float32 against jax.grad of the JAX
    reference; constant rows (xhat = 0) included."""
    x, gain, bias, w, b = _fc_inputs(70, 96, 40)
    dy = np.random.RandomState(6).randn(70, 40).astype(np.float32)
    t = torch.from_numpy
    xhat, xn = fc_mod._norm_rows(t(x), t(gain), t(bias), 1e-6)
    assert float(xhat[:2].abs().max()) == 0.0
    wt = t(w)  # (din, dout), the JAX layout
    pre = xn @ wt + t(b)
    dpre = t(dy) * (fc_mod.gelu_grad(pre) if act == "gelu" else 1.0)
    g = xhat.t() @ dpre
    db = dpre.sum(dim=0)
    dw = t(gain)[:, None] * g + t(bias)[:, None] * db[None, :]
    dgain = (wt * g).sum(dim=1)
    dbias = wt @ db
    ref = _jax_fc_grads(x, gain, bias, w, b, act, dy)
    for name, ours, r in zip(("gain", "bias", "w", "b"),
                             (dgain, dbias, dw, db), ref):
        _close_grad(ours.numpy(), np.asarray(r), name)


def test_input_fc_launch_plan():
    """The bf16 backward's launch choices (ops/input_fc.py) at the four
    calls of a yc2_2d3d_coot train step on 132 SMs, and at edge sizes."""
    calls = {"clips": (66560, 4096), "video global": (5120, 4096),
             "paragraph": (20480, 1536), "sentences": (19968, 1536)}
    for s, din in calls.values():
        splits, dpre_splits = fc_mod.backward_plan(s, din, 384, True, 132)
        blocks = (-(-din // fc_mod.G_ROWS)) * (-(-384 // fc_mod.G_COLS)) \
            * splits
        assert blocks >= 132  # every SM gets a block
        assert blocks >= 0.85 * -(-blocks // 132) * 132  # whole waves
        assert s // splits >= 4 * fc_mod.G_STEP
        assert dpre_splits == min(132, -(-s // 64))
    assert fc_mod.backward_splits(66560, 4096, 384, 132) == 4
    assert fc_mod.backward_splits(20480, 1536, 384, 132) == 10
    for s in (0, 1, 17, 255):
        assert fc_mod.backward_plan(s, 4096, 384, True, 132) == \
            (1, max(1, -(-s // 64)))
    assert fc_mod.backward_splits(1001, 1536, 384, 132) == 3
    assert fc_mod.backward_splits(10 ** 7, 64, 16, 132) == 64
    # float32 keeps the FMA reduction's splits (csrc/tn_reduce.cuh)
    assert fc_mod.backward_plan(66560, 4096, 384, False, 132)[0] == \
        cuda_build.splits_for(66560, 64 * 6)


def _one_product_grads(x, gain, bias, w, mean, inv, pre, dy, act):
    """The CUDA backward's algebra (csrc/input_fc.cu) on given mean and
    inv: (dgain, dbias, dW (din, dout), db)."""
    xhat = (x - mean[:, None]) * inv[:, None]
    dpre = dy * (fc_mod.gelu_grad(pre) if act == "gelu" else 1.0)
    g = xhat.t() @ dpre
    db = dpre.sum(dim=0)
    return ((w.t() * g).sum(dim=1), w.t() @ db,
            gain[:, None] * g + bias[:, None] * db[None, :], db)


@pytest.mark.parametrize("din,dout", [(48, 32), (50, 20)])
def test_input_fc_backward_padded_widths(din, dout):
    """The backward wrapper's zero padding (ops/input_fc.py::
    pad_backward_operands): at din 48 / dout 32 (synthetic_smoke's text
    input FC) and 50 / 20, the one-product gradients of the padded
    operands, with the forward's mean and inv over the real din, sliced
    back, equal the unpadded ones and jax.grad of the JAX reference."""
    x, gain, bias, w, b = _fc_inputs(70, din, dout, seed=21)
    dy = np.random.RandomState(22).randn(70, dout).astype(np.float32)
    t = torch.from_numpy
    wt = t(np.ascontiguousarray(w.T))  # (dout, din), the torch layout
    mean, denom = fc_mod.coot_norm_stats(t(x), 1e-6)
    mean, inv = mean[:, 0], 1.0 / denom[:, 0]
    _, xn = fc_mod._norm_rows(t(x), t(gain), t(bias), 1e-6)
    pre = xn @ wt.t() + t(b)
    padded = fc_mod.pad_backward_operands(t(x), t(gain), t(bias), wt, pre,
                                          t(dy))
    assert padded[0].shape == (70, 64) and padded[3].shape == (32, 64)
    pg, pb, pw, pdb = _one_product_grads(*padded[:4], mean, inv,
                                         *padded[4:], "gelu")
    ours = (pg[:din], pb[:din], pw[:din, :dout], pdb[:dout])
    plain = _one_product_grads(t(x), t(gain), t(bias), wt, mean, inv, pre,
                               t(dy), "gelu")
    ref = _jax_fc_grads(x, gain, bias, w, b, "gelu", dy)
    for name, a, p, r in zip(("gain", "bias", "w", "b"), ours, plain, ref):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-6)
        _close_grad(a.numpy(), np.asarray(r), name)
    assert fc_mod.pad_backward_operands(*padded)[0] is padded[0]


def test_input_fc_backward_matches_pallas_interpret():
    x, gain, bias, w, b = _fc_inputs(64, 128, 128, seed=4)
    dy = np.random.RandomState(5).randn(64, 128).astype(np.float32)
    _, pre = jfc._fwd_call(jnp.asarray(x), gain, bias, w, b, 1e-6, "gelu",
                           need_pre=True, interpret=True)
    _, dgain, dbias, dw, db = jfc._bwd_call(
        jnp.asarray(x), gain, bias, w, pre, jnp.asarray(dy), 1e-6, "gelu",
        interpret=True)
    t = torch.from_numpy
    ours = fused_input_fc_backward_plain(
        t(x), t(gain), t(bias), t(np.ascontiguousarray(w.T)), t(b), 1e-6,
        "gelu", t(dy))
    for name, a, r in zip(("gain", "bias", "w", "b"), ours,
                          (dgain, dbias, np.asarray(dw).T, db)):
        _close_grad(a.numpy(), np.asarray(r), name)


def _torch_genpool_grads(f, mask, heads, act, dout, rate=0.0, seed=None):
    t = torch.from_numpy
    ft = t(f).requires_grad_()
    ht = [t(a).requires_grad_() for a in heads]
    genpool(ft, t(mask), *ht, act, rate, seed).backward(t(dout))
    return [ft.grad] + [a.grad for a in ht]


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_genpool_backward_matches_jax_grad(act):
    """df and every parameter gradient against jax.grad of the JAX
    reference in the flat layout (the dense w2's diagonal blocks are the
    per-head gradients); db2 is identically ~0 deterministically
    (pallas_genpool.py:39-44) and is held to an absolute 1e-5."""
    f, mask, *heads = _genpool_inputs(6, 20, 32, 64, 2, seed=6)
    dout = np.random.RandomState(7).randn(6, 32).astype(np.float32)
    flat = [jnp.asarray(a) for a in jgen.head_params_to_flat(*heads)]

    def loss(f_, w1_, b1_, w2_, b2_):
        y = jgen.fused_genpool_reference(f_, jnp.asarray(mask), w1_, b1_,
                                         w2_, b2_, act)
        return jnp.sum(y * dout)

    rf, rw1, rb1, rw2, rb2 = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(f), *flat)
    df, dw1, db1, dw2, db2 = _torch_genpool_grads(f, mask, heads, act, dout)
    _close_grad(df.numpy(), np.asarray(rf), "df")
    _close_grad(dw1.permute(1, 0, 2).reshape(32, 64).numpy(),
                np.asarray(rw1), "dw1")
    _close_grad(db1.reshape(-1).numpy(), np.asarray(rb1), "db1")
    rw2 = np.asarray(rw2)
    for hh in range(2):
        _close_grad(dw2[hh].numpy(),
                    rw2[hh * 32:(hh + 1) * 32, hh * 16:(hh + 1) * 16],
                    f"dw2[{hh}]")
    assert np.abs(db2.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(rb2)).max() <= 1e-5


def test_genpool_backward_matches_pallas_interpret():
    f, mask, *heads = _genpool_inputs(8, 16, 128, 256, 2, seed=8)
    dout = np.random.RandomState(9).randn(8, 128).astype(np.float32)
    w1, b1, w2, b2 = (jnp.asarray(a) for a in
                      jgen.head_params_to_flat(*heads))
    rf, rw1, rb1, rw2, _ = jgen._bwd_call(
        jnp.asarray(f), jnp.asarray(mask), w1, b1, w2, b2,
        jnp.zeros(1, jnp.int32), jnp.asarray(dout), "gelu", 0.0, False,
        interpret=True)
    df, dw1, db1, dw2, _ = _torch_genpool_grads(f, mask, heads, "gelu",
                                                dout)
    _close_grad(df.numpy(), np.asarray(rf), "df")
    _close_grad(dw1.permute(1, 0, 2).reshape(128, 256).numpy(),
                np.asarray(rw1), "dw1")
    _close_grad(db1.reshape(-1).numpy(), np.asarray(rb1), "db1")
    rw2 = np.asarray(rw2)
    for hh in range(2):
        _close_grad(dw2[hh].numpy(),
                    rw2[hh * 128:(hh + 1) * 128, hh * 64:(hh + 1) * 64],
                    f"dw2[{hh}]")


def _genpool_bwd_tile_order(f, mask, w1h, b1h, w2h, b2h, act, dout, rate,
                            seed, tile, splits, stats=None):
    """B2's backward as csrc/genpool.cu's bf16 tile pass orders it, in
    float32: the forward's per-(pooled row, column) stats (softmax max, sum
    and the pooled row out; computed here, or `stats` (3, S, D) as the
    forward wrote them), then flat tiles of `tile` of the S*L rows that
    cross pooled-row boundaries, each row reading the stats of its s (the
    row-coupling sum is dout * out); the weight gradients as partial sums
    over `splits` row splits (whole tiles) added in split order."""
    s, length, d = f.shape
    heads, dh, dho = w2h.shape
    h = heads * dh
    rows = s * length
    w1 = flat_w1(w1h)
    b1, b2 = b1h.reshape(-1), b2h.reshape(-1)
    fac = gp_mod._factors((s, length, d, h), seed, rate, f.device)
    keep1, keep2, keep3 = (fac[k].reshape(rows, -1) if fac else None
                           for k in ("hidden", "logits", "weights"))

    def row_pass(r):
        """Every per-row quantity of the flat rows r."""
        fr = f.reshape(rows, d)[r]
        hin = fr @ w1 + b1
        if keep1 is not None:
            hin = hin * keep1[r]
        h1 = act_fn(hin, act)
        lg = torch.cat([h1[:, i * dh:(i + 1) * dh] @ w2h[i]
                        for i in range(heads)], dim=1) + b2
        if keep2 is not None:
            lg = lg * keep2[r]
        valid = mask.reshape(rows)[r][:, None]
        return fr, hin, h1, torch.where(valid, lg,
                                        torch.full_like(lg, -32752.0)), valid

    # the forward's stats, per pooled row (genpool.cu's `stats`)
    if stats is not None:
        mx, total, out = stats
    else:
        _, _, _, lg, _ = row_pass(torch.arange(rows))
        lg = lg.reshape(s, length, d)
        mx = lg.max(dim=1).values
        e = torch.exp(lg - mx[:, None])
        total = e.sum(dim=1)
        smd = e / total[:, None]
        if keep3 is not None:
            smd = smd * keep3.reshape(s, length, d)
        out = (f * smd).sum(dim=1)

    df = torch.empty(rows, d)
    n_tiles = -(-rows // tile)
    per_split = -(-n_tiles // splits)
    parts = []
    for sp in range(splits):
        part = [torch.zeros(d, h), torch.zeros(h), torch.zeros(heads, dh, dho),
                torch.zeros(d)]
        for ti in range(sp * per_split, min(n_tiles, (sp + 1) * per_split)):
            r = torch.arange(ti * tile, min(rows, (ti + 1) * tile))
            fr, hin, h1, lgr, valid = row_pass(r)
            si = r // length
            sm = torch.exp(lgr - mx[si]) / total[si]
            g = dout[si]
            k3 = keep3[r] if keep3 is not None else 1.0
            dsm = g * fr * k3
            dlg = torch.where(valid, sm * (dsm - g * out[si]),
                              torch.zeros_like(sm))
            dh2 = dlg * (keep2[r] if keep2 is not None else 1.0)
            dh1 = torch.cat([dh2[:, i * dho:(i + 1) * dho] @ w2h[i].t()
                             for i in range(heads)], dim=1)
            dpre1 = dh1 * act_grad(hin, act) * (
                keep1[r] if keep1 is not None else 1.0)
            df[r] = g * sm * k3 + dpre1 @ w1.t()
            part[0] += fr.t() @ dpre1
            part[1] += dpre1.sum(dim=0)
            part[2] += torch.stack([h1[:, i * dh:(i + 1) * dh].t()
                                    @ dh2[:, i * dho:(i + 1) * dho]
                                    for i in range(heads)])
            part[3] += dh2.sum(dim=0)
        parts.append(part)
    dw1, db1, dw2, db2 = (sum(p[i] for p in parts) for i in range(4))
    return (df.reshape(s, length, d),
            dw1.reshape(d, heads, dh).permute(1, 0, 2), db1.reshape(heads, dh),
            dw2, db2.reshape(heads, dho))


@pytest.mark.parametrize("s,length,tile,rate", [
    (7, 20, 16, 0.0), (7, 20, 16, 0.3), (5, 24, 64, 0.3), (40, 1, 8, 0.3),
    (3, 37, 64, 0.0)])
def test_genpool_backward_tile_order(s, length, tile, rate):
    """The identity the bf16 kernel rests on: with the forward's stats, the
    backward is local to each sequence row, so flat tiles that cross
    pooled-row boundaries (L not dividing the tile, L = 1), all-masked
    rows and dropout (the masks regenerated by element index) give the
    plain backward's gradients, and without dropout jax.grad's, at 1e-5
    relative in float32; the weight gradients as split sums."""
    f, mask, *heads = _genpool_inputs(s, length, 32, 64, 2, seed=23)
    dout = np.random.RandomState(24).randn(s, 32).astype(np.float32)
    t = torch.from_numpy
    tiled = _genpool_bwd_tile_order(t(f), t(mask), *(t(a) for a in heads),
                                    "gelu", t(dout), rate, 99, tile, 3)
    plain = genpool_backward_plain(t(f), t(mask), *(t(a) for a in heads),
                                   "gelu", t(dout), rate, 99)
    names = ("df", "dw1", "db1", "dw2", "db2")
    for name, a, r in zip(names, tiled, plain):
        r = r.numpy()
        assert np.abs(a.numpy() - r).max() <= 1e-5 * max(1.0,
                                                         np.abs(r).max()), name
    if rate == 0.0:
        flat = [jnp.asarray(a) for a in jgen.head_params_to_flat(*heads)]

        def loss(f_, w1_, b1_, w2_, b2_):
            y = jgen.fused_genpool_reference(f_, jnp.asarray(mask), w1_,
                                             b1_, w2_, b2_, "gelu")
            return jnp.sum(y * dout)

        rf, rw1, rb1, rw2, _ = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            jnp.asarray(f), *flat)
        _close_grad(tiled[0].numpy(), np.asarray(rf), "df")
        _close_grad(tiled[1].permute(1, 0, 2).reshape(32, 64).numpy(),
                    np.asarray(rw1), "dw1")
        _close_grad(tiled[2].reshape(-1).numpy(), np.asarray(rb1), "db1")
        rw2 = np.asarray(rw2)
        for hh in range(2):
            _close_grad(tiled[3][hh].numpy(),
                        rw2[hh * 32:(hh + 1) * 32, hh * 16:(hh + 1) * 16],
                        f"dw2[{hh}]")


def test_genpool_backward_launch_plan():
    """The bf16 backward's row splits (ops/genpool.py) at the four calls of
    a yc2_2d3d_coot train step on 132 SMs (D 384, H 768, 2 heads), and at
    other widths."""
    calls = {"clips": (832, 80), "video context": (64, 80),
             "paragraph": (64, 320), "sentences": (832, 24)}
    for s, length in calls.values():
        plan = gp_mod.backward_plan(s, length, 384, 768, 2, 132)
        assert set(plan) == {"splits_w1", "splits_w2"}
        for key, tiles in (("splits_w1", 3 * 4), ("splits_w2", 2 * 3)):
            blocks = tiles * plan[key]
            most = s * length // (4 * fc_mod.G_STEP)  # 4 steps a split
            if plan[key] < most:  # every SM gets a block, in whole waves
                assert blocks >= 132
                assert blocks >= 0.85 * -(-blocks // 132) * 132
            assert plan[key] <= most
    assert gp_mod.backward_plan(832, 80, 384, 768, 2, 132)["splits_w1"] == 11
    assert gp_mod.backward_plan(832, 80, 384, 768, 2, 132)["splits_w2"] == 22
    # synthetic_smoke's D 32 / H 64: one split each; 8 heads of 16 columns
    small = gp_mod.backward_plan(4, 20, 32, 64, 2, 132)
    assert small == {"splits_w1": 1, "splits_w2": 1}
    many = gp_mod.backward_plan(64, 80, 128, 256, 8, 132)
    assert many["splits_w2"] <= 64 * 80 // (4 * fc_mod.G_STEP)


def _genpool_fwd_tile_order(f, mask, w1h, b1h, w2h, b2h, act, rate, seed,
                            tile):
    """B2's forward as csrc/genpool.cu's bf16 passes order it, in float32:
    genpool_fwd_tiles writes the masked, dropped logits of flat tiles of
    `tile` of the S*L rows (across pooled-row boundaries, the masks by
    each row's element index); genpool_pool reduces over L per (pooled
    row, column) in kPoolGroups = 8 row groups (rows l = g, g + 8, ...),
    each an online max / sum / sum e*keep3*f, merged in group order.
    Returns the pooled rows and the stats (column max, sum, pooled)."""
    s, length, d = f.shape
    heads, dh, _ = w2h.shape
    h = heads * dh
    rows = s * length
    w1, b1, b2 = flat_w1(w1h), b1h.reshape(-1), b2h.reshape(-1)
    fac = gp_mod._factors((s, length, d, h), seed, rate, f.device)
    keep1, keep2, keep3 = (fac[k].reshape(rows, -1) if fac else None
                           for k in ("hidden", "logits", "weights"))
    flat_f, flat_mask = f.reshape(rows, d), mask.reshape(rows)
    logits = torch.empty(rows, d)
    for r0 in range(0, rows, tile):
        r = torch.arange(r0, min(rows, r0 + tile))
        hin = flat_f[r] @ w1 + b1
        if keep1 is not None:
            hin = hin * keep1[r]
        h1 = act_fn(hin, act)
        lg = torch.cat([h1[:, i * dh:(i + 1) * dh] @ w2h[i]
                        for i in range(heads)], dim=1) + b2
        if keep2 is not None:
            lg = lg * keep2[r]
        logits[r] = torch.where(flat_mask[r][:, None], lg,
                                torch.full_like(lg, -32752.0))
    logits = logits.reshape(s, length, d)
    k3 = (keep3.reshape(s, length, d) if keep3 is not None
          else torch.ones(s, length, d))
    parts = []
    for g in range(8):
        m = torch.full((s, d), -float("inf"))
        total, acc = torch.zeros(s, d), torch.zeros(s, d)
        for li in range(g, length, 8):
            x = logits[:, li]
            mn = torch.maximum(m, x)
            sc, ex = torch.exp(m - mn), torch.exp(x - mn)
            total = total * sc + ex
            acc = acc * sc + ex * k3[:, li] * f[:, li]
            m = mn
        parts.append((m, total, acc))
    mx = torch.stack([p[0] for p in parts]).max(dim=0).values
    total, acc = torch.zeros(s, d), torch.zeros(s, d)
    for m, t_, a in parts:
        w = torch.exp(m - mx)
        total, acc = total + t_ * w, acc + a * w
    pooled = acc / total
    return pooled, (mx, total, pooled)


def _genpool_plain_stats(f, mask, w1h, b1h, w2h, b2h, act, rate, seed):
    """The forward's stats from genpool_plain's own intermediates: the
    column max and sum of the masked, dropped logits, the pooled row."""
    r = gp_mod._recompute(f, mask, w1h, b1h, w2h, b2h, act, rate, seed)
    heads, dh, _ = w2h.shape
    lg = torch.cat([r["h1"][..., i * dh:(i + 1) * dh] @ r["w2c"][i]
                    for i in range(heads)], dim=-1) + b2h.reshape(-1)
    if r["fac"]:
        lg = lg * r["fac"]["logits"]
    lg = torch.where(r["valid"], lg, torch.full_like(lg, -32752.0))
    mx = lg.max(dim=1).values
    return (mx, torch.exp(lg - mx[:, None]).sum(dim=1),
            (r["f32"] * r["smd"]).sum(dim=1))


@pytest.mark.parametrize("s,length,tile,rate", [
    (7, 20, 64, 0.0), (7, 20, 16, 0.1), (5, 24, 64, 0.1), (40, 1, 64, 0.1),
    (3, 37, 64, 0.0)])
def test_genpool_forward_tile_order(s, length, tile, rate):
    """The bf16 forward's order (flat tiles of logits across pooled rows,
    then the pooling pass's row groups): L not dividing the tile, L = 1
    (more row groups than rows), all-masked pooled rows and dropout 0.1
    give genpool_plain's pooled rows and stats at 1e-5 relative; without
    dropout the JAX reference's and the interpret-mode Pallas kernel's;
    and its stats drive the backward's tile order to the plain
    backward's gradients."""
    f, mask, *heads = _genpool_inputs(s, length, 32, 64, 2, seed=31)
    t = torch.from_numpy
    args = (t(f), t(mask), *(t(a) for a in heads), "gelu")
    pooled, stats = _genpool_fwd_tile_order(*args, rate, 99, tile)
    plain = genpool_plain(*args, rate, 99)
    ref_stats = _genpool_plain_stats(*args, rate, 99)

    def close(a, r, name):
        a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
        assert np.abs(a - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name

    close(pooled, plain, "out")
    for name, a, r in zip(("max", "sum", "pooled"), stats, ref_stats):
        close(a, r, name)
    if rate == 0.0:
        flat = [jnp.asarray(a) for a in jgen.head_params_to_flat(*heads)]
        ref = jgen.fused_genpool_reference(jnp.asarray(f), jnp.asarray(mask),
                                           *flat, "gelu")
        close(pooled, ref, "reference")
        pal = jgen._fwd_call(jnp.asarray(f), jnp.asarray(mask), *flat,
                             jnp.zeros(1, jnp.int32), "gelu", 0.0, False,
                             interpret=True)
        close(pooled, pal, "pallas")
    dout = t(np.random.RandomState(32).randn(s, 32).astype(np.float32))
    tiled = _genpool_bwd_tile_order(*args, dout, rate, 99, 64, 2,
                                    stats=stats)
    for name, a, r in zip(("df", "dw1", "db1", "dw2", "db2"), tiled,
                          genpool_backward_plain(*args, dout, rate, 99)):
        close(a, r, name)


def _attention_block_order(q, k, v, key_valid, heads, scale, rate, seed):
    """B3's bf16 forward as csrc/attention.cu orders it, in float32: per
    query chunk of forward_plan's bq, key blocks of its bk in steps of 32
    keys (keys past Lk at -inf, masked keys at -32752), an online row max,
    the sum of P undropped and the accumulator of P * keep @ v rescaled at
    each step. Returns o and the stats (row max, 1/sum)."""
    n, lq, dh = q.shape
    lk = k.shape[1]
    bq, bk, _ = forward_plan(lq, lk)
    f = philox.keep_factor((n, lq, lk), seed, philox.SITE_ATTENTION, rate,
                           q.device) if rate > 0 else torch.ones(n, lq, lk)
    valid = key_valid.repeat_interleave(heads, dim=0)
    o = torch.empty(n, lq, dh)
    row_max, row_inv = torch.empty(n, lq), torch.empty(n, lq)
    for q0 in range(0, lq, bq):
        qs = slice(q0, min(lq, q0 + bq))
        m = torch.full((n, qs.stop - q0), -float("inf"))
        total = torch.zeros(n, qs.stop - q0)
        acc = torch.zeros(n, qs.stop - q0, dh)
        for kb in range(0, lk, bk):
            for k0 in range(kb, min(lk, kb + bk), 32):
                ks = slice(k0, k0 + 32)
                sc = torch.bmm(q[:, qs], k[:, ks].transpose(1, 2)) * scale
                sc = torch.where(valid[:, None, ks], sc,
                                 torch.full_like(sc, -32752.0))
                pad = 32 - sc.shape[2]  # keys past Lk
                sc = torch.nn.functional.pad(sc, (0, pad),
                                             value=-float("inf"))
                mn = torch.maximum(m, sc.max(dim=2).values)
                alpha = torch.exp(m - mn)
                p = torch.exp(sc - mn[..., None])[..., :32 - pad]
                total = total * alpha + p.sum(dim=2)
                acc = acc * alpha[..., None] + torch.bmm(
                    p * f[:, qs, ks], v[:, ks])
                m = mn
        o[:, qs] = acc / total[..., None]
        row_max[:, qs], row_inv[:, qs] = m, 1.0 / total
    return o, row_max, row_inv


@pytest.mark.parametrize("b,heads,lq,lk,rate", [
    (3, 2, 20, 130, 0.1), (2, 2, 37, 130, 0.0), (2, 2, 40, 320, 0.1),
    (3, 2, 1, 130, 0.1), (3, 4, 24, 24, 0.0), (2, 2, 150, 80, 0.1)])
def test_attention_forward_block_order(b, heads, lq, lk, rate):
    """The bf16 forward's order (key blocks walked 32 keys at a time with
    an online rescale, query chunks, keys past Lk at -inf): Lk 130 and 320
    (two and three key blocks), Lq 1, two query chunks, all-masked rows
    and dropout 0.1 give masked_attention_plain's output and its row max
    and 1/sum at 1e-5 relative; without dropout the JAX reference's."""
    q, k, v, key_valid = _attn_inputs(b, heads, lq, lk, 48, seed=33)
    scale = 48 ** -0.5
    t = torch.from_numpy
    o, row_max, row_inv = _attention_block_order(
        t(q), t(k), t(v), t(key_valid), heads, scale, rate, 7)
    plain = masked_attention_plain(t(q), t(k), t(v), t(key_valid), heads,
                                   scale, rate, 7)
    mask = t(key_valid).repeat_interleave(heads, dim=0)[:, None, :]
    sc = torch.bmm(t(q), t(k).transpose(1, 2)) * scale
    sc = torch.where(mask, sc, torch.full_like(sc, -32752.0))
    ref_max = sc.max(dim=2).values
    ref_inv = 1.0 / torch.exp(sc - ref_max[..., None]).sum(dim=2)

    def close(a, r, name):
        a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
        assert np.abs(a - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name

    close(o, plain, "o")
    close(row_max, ref_max, "row max")
    close(row_inv, ref_inv, "1/sum")
    if rate == 0.0:
        ref = jattn.masked_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            _jax_mask(key_valid, heads, lq), scale)
        close(o, ref, "reference")


def test_attention_forward_launch_plan():
    """forward_plan (ops/attention.py) at the six shapes of a
    yc2_2d3d_coot train step, and its limits over a range of lengths: a
    warp per 16 queries, at most 8 warps, the fewest query chunks and key
    blocks of at most 128, key blocks in steps of 32, and blocks of short
    cells packed to at least 4 warps."""
    assert forward_plan(80, 80) == (80, 96, 1)     # clips, video context
    assert forward_plan(320, 320) == (112, 128, 1)  # paragraph
    assert forward_plan(24, 24) == (32, 32, 2)     # sentences
    assert forward_plan(16, 16) == (16, 32, 4)     # global nets
    assert forward_plan(1, 16) == (16, 32, 4)      # cross-attention
    for lq in (1, 15, 16, 17, 32, 33, 80, 128, 129, 300, 320, 1000):
        for lk in (1, 16, 31, 32, 33, 80, 130, 320, 1000):
            bq, bk, cells = forward_plan(lq, lk)
            assert bq % 16 == 0 and 16 <= bq <= 128 and cells * bq <= 128
            assert bk % 32 == 0 and 32 <= bk <= 128
            assert -(-lq // bq) == -(-lq // 128)  # fewest query chunks
            assert -(-lk // bk) == -(-lk // 128)  # fewest key blocks
            assert bq - 16 < -(-lq // -(-lq // 128))  # balanced chunks
            if lq <= 32 and lk <= 32:
                assert cells * bq // 16 >= 4


def _attn_grads(q, k, v, key_valid, heads, scale, g, rate=0.0,
                seed=None):
    t = torch.from_numpy
    qkv = [t(a).requires_grad_() for a in (q, k, v)]
    masked_attention(*qkv, t(key_valid), heads, scale, rate,
                     seed).backward(t(g))
    return [a.grad.numpy() for a in qkv]


@pytest.mark.parametrize("b,heads,lq,lk", [(3, 2, 20, 20), (4, 8, 1, 16),
                                           (2, 8, 80, 80), (2, 2, 37, 130)],
                         ids=["self", "cross_lq1", "local_l80",
                              "ragged_37x130"])
def test_attention_backward_matches_module_autodiff(b, heads, lq, lk):
    """dq, dk, dv against jax.grad of masked_attention_reference, the
    module's math. The last batch row has every key masked: autodiff of
    where(mask, s, -INF) gives a zero score gradient there (so dq = dk =
    0 on those cells) while dv keeps the uniform-average term; the Pallas
    _bwd_kernel does not zero it, so it is not the oracle here."""
    q, k, v, key_valid = _attn_inputs(b, heads, lq, lk, 48, seed=10)
    g = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    scale = 48 ** -0.5
    jm = _jax_mask(key_valid, heads, lq)

    def loss(q_, k_, v_):
        return jnp.sum(jattn.masked_attention_reference(q_, k_, v_, jm,
                                                        scale) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    ours = _attn_grads(q, k, v, key_valid, heads, scale, g)
    for name, a, r in zip("qkv", ours, ref):
        _close_grad(a, np.asarray(r), "d" + name)
    last = slice((b - 1) * heads, b * heads)
    assert np.abs(ours[0][last]).max() == 0.0
    assert np.abs(ours[1][last]).max() == 0.0
    assert np.abs(ours[2][last]).max() > 0.0


def test_attention_backward_matches_pallas_interpret():
    """Against the Pallas backward kernel on rows with at least one valid
    key (where the two formulations agree)."""
    q, k, v, key_valid = _attn_inputs(3, 2, 20, 20, 48, seed=12)
    key_valid[-1, 0] = True
    g = np.random.RandomState(13).randn(*q.shape).astype(np.float32)
    scale = 48 ** -0.5
    jm = _jax_mask(key_valid, 2, 20)

    def loss(q_, k_, v_):
        return jnp.sum(jattn.pallas_masked_attention(q_, k_, v_, jm,
                                                     scale) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    ours = _attn_grads(q, k, v, key_valid, 2, scale, g)
    for name, a, r in zip("qkv", ours, ref):
        _close_grad(a, np.asarray(r), "d" + name)


def _autograd_of_plain(fn, inputs, g):
    inputs = [a.clone().requires_grad_() for a in inputs]
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("kernel", ["genpool", "attention", "dropout"])
def test_backward_with_dropout_matches_autograd_of_plain(kernel):
    """With dropout on, each explicit plain backward equals autograd
    through the plain forward with the same Philox masks (the seed: call 3
    of a seed state)."""
    t = torch.from_numpy
    rate, seed = 0.3, philox.Seed(philox.seed_state(1234), 3)
    if kernel == "genpool":
        f, mask, *heads = _genpool_inputs(4, 20, 32, 64, 2, seed=14)
        inputs = [t(f)] + [t(a) for a in heads]
        g = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
        ref = _autograd_of_plain(
            lambda *a: genpool_plain(a[0], t(mask), *a[1:], "gelu", rate,
                                     seed), inputs, g)
        ours = genpool_backward_plain(inputs[0], t(mask), *inputs[1:],
                                      "gelu", g, rate, seed)
        through = _torch_genpool_grads(f, mask, heads, "gelu", g.numpy(),
                                       rate, seed)
    elif kernel == "attention":
        q, k, v, key_valid = _attn_inputs(3, 2, 7, 9, 8, seed=15)
        inputs = [t(q), t(k), t(v)]
        g = torch.randn(6, 7, 8, generator=torch.Generator().manual_seed(0))
        ref = _autograd_of_plain(
            lambda *a: masked_attention_plain(*a, t(key_valid), 2, 0.3,
                                              rate, seed), inputs, g)
        ours = masked_attention_backward_plain(*inputs, t(key_valid), g, 2,
                                               0.3, rate, seed)
        through = [t(a) for a in _attn_grads(q, k, v, key_valid, 2, 0.3,
                                             g.numpy(), rate, seed)]
    else:
        x = torch.randn(33, 17, generator=torch.Generator().manual_seed(0))
        g = torch.randn(33, 17, generator=torch.Generator().manual_seed(1))
        ref = _autograd_of_plain(lambda a: dropout_plain(a, seed, rate),
                                 [x], g)
        ours = [dropout_plain(g, seed, rate)]
        xg = x.clone().requires_grad_()
        dropout(xg, seed, rate).backward(g)
        through = [xg.grad]
    for a, b, r in zip(ours, through, ref):
        _close_grad(a.detach().numpy(), r.numpy())
        _close_grad(b.detach().numpy(), r.numpy())


def test_cpu_path_launches_no_kernel():
    cuda_build.reset_launch_counts()
    q, k, v, key_valid = _attn_inputs(2, 2, 4, 4, 8)
    t = torch.from_numpy
    masked_attention(t(q), t(k), t(v), t(key_valid), 2, 0.3)
    assert sum(cuda_build.launch_counts.values()) == 0


def test_kernel_launch_arguments():
    """Host-side launch logic: B4's arguments, checked and computed once in
    the forward for both launches; when B3's bf16 backward needs its f32
    dq scratch (more than one block of 128 keys); the C signatures of the
    forwards, whose bf16 kernels take B2's logits scratch and B3's tiles
    (forward_plan's three ints before the dtype flag)."""
    x = torch.zeros(3, 5, dtype=torch.bfloat16)
    seed = philox.Seed(philox.seed_state(2 ** 40 + 1), 17)
    args = dropout_mod.launch_args(x, seed, 0.01, philox.SITE_DROPOUT, 7)
    assert args == (seed.state.data_ptr(), 17, int(0.01 * 2 ** 32),
                    1.0 / 0.99, philox.SITE_DROPOUT, 1, 7)
    assert philox.kernel_args(0.01, seed, x.device)[:3] == args[:3]
    assert philox.kernel_args(0.0, None, x.device) == (0, 0, 0, 1.0)
    assert dropout_mod.launch_args(x.float(), seed, 0.5, 3).bf16 == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dropout_mod.launch_args(x.half(), seed, 0.5, 3)
    with pytest.raises(ValueError, match="rate"):
        dropout_mod.launch_args(x, seed, 1.0, 3)
    # the seed state is read on the kernel's device, one int64
    two = philox.Seed(torch.zeros(2, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="seed state"):
        dropout_mod.launch_args(x, two, 0.5, 3)
    with pytest.raises(TypeError, match="philox.Seed"):
        dropout_mod.launch_args(x, 5, 0.5, 3)
    assert not needs_dq_scratch(128, True)
    assert needs_dq_scratch(129, True) and needs_dq_scratch(320, True)
    assert not needs_dq_scratch(320, False)
    c = ctypes
    genpool_fwd = cuda_build._SIGNATURES["coot_genpool_fwd"]
    assert genpool_fwd[:9] == [c.c_void_p] * 9  # ..., stats, logits
    assert len(genpool_fwd) == 21
    attention_fwd = cuda_build._SIGNATURES["coot_attention_fwd"]
    assert attention_fwd[-6:] == [c.c_float] + [c.c_int] * 4 + [c.c_void_p]
    assert len(attention_fwd) == 22
    # every dropout-taking entry: the seed state's pointer, then the call
    for name, at in (("coot_genpool_fwd", 15), ("coot_genpool_bwd", 24),
                     ("coot_attention_fwd", 13), ("coot_attention_bwd", 19),
                     ("coot_dropout", 3), ("coot_gather_rows", 6)):
        sig = cuda_build._SIGNATURES[name]
        assert sig[at:at + 2] == [c.c_void_p, c.c_uint], name


# ---------------- B6: the residual add and CootLayerNorm ----------------

def _norm_case(rows, width, kind, seed=0):
    """(y, residual, gain, bias, dout) in float64: y ~ 2 N + 0.5, rows 0
    and 1 constant for "constant", every row 100 + 0.5 N (mean^2 >> var)
    for "offset"; residual ~ N."""
    rng = np.random.RandomState(seed)
    y = rng.randn(rows, width) * 2 + 0.5
    if kind == "offset":
        y = rng.randn(rows, width) * 0.5 + 100.0
    r = rng.randn(rows, width)
    if kind == "constant":
        y[:2] = 3.0
        r[:2] = -1.0
    gain = 1 + 0.1 * rng.randn(width)
    bias = 0.1 * rng.randn(width)
    dout = rng.randn(rows, width)
    return [torch.from_numpy(a) for a in (y, r, gain, bias, dout)]


NORM_CASES = [(rows, width, kind, residual)
              for rows, width, kind in ((64, 384, "random"),
                                        (37, 768, "random"),
                                        (33, 384, "constant"),
                                        (29, 768, "offset"),
                                        (1, 384, "random"))
              for residual in (True, False)]


@pytest.mark.parametrize("rows,width,kind,residual", NORM_CASES)
def test_coot_norm_backward_formula_matches_autograd(rows, width, kind,
                                                     residual):
    """The kernel's backward formula (coot_norm_backward_plain) against
    autograd of coot_layer_norm in float64: dx (the same for y and the
    residual), dgain and dbias; a constant row's dx is finite, with no
    gradient through its std of 0."""
    y, r, gain, bias, dout = _norm_case(rows, width, kind)
    leaves = [a.clone().requires_grad_() for a in (y, r, gain, bias)]
    s = leaves[0] + leaves[1] if residual else leaves[0]
    cn_mod.coot_layer_norm(s, leaves[2], leaves[3], 1e-6).backward(dout)
    s = y + r if residual else y
    dx, dgain, dbias = cn_mod.coot_norm_backward_plain(s, gain, 1e-6, dout)
    assert dx.dtype == torch.float64 and torch.isfinite(dx).all()
    for ours, ref in ((dx, leaves[0].grad), (dgain, leaves[2].grad),
                      (dbias, leaves[3].grad)):
        err = float((ours - ref).abs().max())
        assert err <= 1e-9 * max(1.0, float(ref.abs().max()))
    if residual:
        assert torch.equal(leaves[0].grad, leaves[1].grad)
    if kind == "constant":
        # std 0: dx = (g - mean(g)) / eps, nothing through the std
        g = dout[:2] * gain
        ref = (g - g.mean(-1, keepdim=True)) / 1e-6
        assert torch.allclose(dx[:2], ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
def test_coot_norm_op_matches_unfused_norm_on_cpu(dtype, residual):
    """coot_norm on CPU tensors equals CootLayerNorm(y + x) as the modules
    composed it before B6: the forward bit for bit, the gradients of y, the
    residual, gain and bias (the formula against autograd) within 1e-4 x
    max(1, max |reference|) in float32 and one bf16 step (1e-2) in
    bfloat16."""
    y, r, gain, bias, dout = _norm_case(67, 384, "constant", seed=1)
    y, r, dout = y.to(dtype), r.to(dtype), dout.to(dtype)
    gain, bias = gain.float(), bias.float()

    def unfused(y, r, gain, bias):
        x = y + r if residual else y
        return cn_mod.coot_layer_norm(x.float(), gain, bias,
                                      1e-6).to(x.dtype)

    def fused(y, r, gain, bias):
        return cn_mod.coot_norm(y, r if residual else None, gain, bias, 1e-6)

    grads, outs = [], []
    for fn in (fused, unfused):
        leaves = [a.clone().requires_grad_() for a in (y, r, gain, bias)]
        out = fn(*leaves)
        out.backward(dout)
        outs.append(out.detach())
        grads.append([a.grad for a in leaves])
    assert torch.equal(outs[0], outs[1])
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for i, (ours, ref) in enumerate(zip(*grads)):
        if i == 1 and not residual:
            assert ours is None and ref is None
            continue
        assert ours.dtype == ref.dtype
        err = float((ours.float() - ref.float()).abs().max())
        assert err <= tol * max(1.0, float(ref.float().abs().max())), i


def _encoder_layer(width=32, seed=0):
    from coot_videotext_tpu_torch.models.attention import (
        TransformerEncoderLayer)
    from coot_videotext_tpu_torch.models.configs import (
        TransformerEncoderConfig)
    cfg = TransformerEncoderConfig(dict(
        hidden_dim=width, num_layers=1, dropout=0.0, num_heads=4,
        pointwise_ff_dim=48, activation="gelu", norm="layernorm_coot"))
    layer = TransformerEncoderLayer(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2
                    + (1.0 if name.endswith("gain") else 0.0))
    return layer


def _unfused_layer_forward(layer, query, key, value, key_valid):
    """TransformerEncoderLayer.forward as written before B6: the sublayer
    output plus the residual in the compute dtype, then CootLayerNorm."""
    def norm(sub, x):
        n = sub.layer_normalization
        return cn_mod.coot_layer_norm(x.float(), n.gain, n.bias,
                                      n.eps).to(x.dtype)
    attn = layer.self_attention_layer
    x = norm(attn, attn.sublayer(query, key, value, key_valid) + query)
    x = layer.dropout(x)
    ffn = layer.pointwise_feedforward_layer
    return norm(ffn, ffn.sublayer(x) + x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cross", [False, True])
def test_encoder_layer_with_fused_norm_matches_unfused(dtype, cross):
    """The post-LN encoder layer passing the residual into the norm gives
    the unfused composition's output bit for bit and its gradients (input,
    key / value and every parameter) within 1e-4 x max(1, max |reference|)
    in float32 and 2e-2 in bfloat16, on the CPU; self-attention and
    cross-attention (a one-row query, as the context decoder runs)."""
    layer = _encoder_layer()
    g = torch.Generator().manual_seed(5)
    lq = 1 if cross else 9
    q = torch.randn(3, lq, 32, generator=g).to(dtype)
    kv = torch.randn(3, 9, 32, generator=g).to(dtype) if cross else q
    valid = torch.arange(9)[None] < torch.tensor([[9], [4], [1]])
    dout = torch.randn(3, lq, 32, generator=g).to(dtype)
    results = []
    for fn in (lambda *a: layer(*a), lambda *a: _unfused_layer_forward(
            layer, *a)):
        layer.zero_grad()
        qq = q.clone().requires_grad_()
        kk = kv.clone().requires_grad_() if cross else qq
        out = fn(qq, kk, kk, valid)
        out.backward(dout)
        results.append((out.detach(), [qq.grad, kk.grad] + [
            p.grad.clone() for p in layer.parameters()]))
    (out, grads), (ref_out, ref_grads) = results
    assert torch.equal(out, ref_out)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for ours, ref in zip(grads, ref_grads):
        err = float((ours.float() - ref.float()).abs().max())
        assert err <= tol * max(1.0, float(ref.float().abs().max()))


def test_coot_norm_cpu_path_and_launch_plan():
    """A CPU call launches no kernel and saves nothing without a gradient;
    the backward's blocks take at least 32 rows each and at most four a
    SM; the C entries' signatures."""
    cuda_build.reset_launch_counts()
    y, r, gain, bias, _ = [a.float() for a in _norm_case(40, 64, "random")]
    with torch.no_grad():
        cn_mod.coot_norm(y, r, gain, bias, 1e-6)
    cn_mod.coot_norm(y, None, gain.requires_grad_(), bias, 1e-6).sum(
    ).backward()
    assert sum(cuda_build.launch_counts.values()) == 0
    assert cn_mod.backward_blocks(1, 132) == 1
    assert cn_mod.backward_blocks(5120, 132) == 160
    assert cn_mod.backward_blocks(66560, 132) == 528
    c = ctypes
    assert cuda_build._SIGNATURES["coot_norm_fwd"] == (
        [c.c_void_p] * 8 + [c.c_int, c.c_int, c.c_float, c.c_int,
                            c.c_void_p])
    assert cuda_build._SIGNATURES["coot_norm_bwd"] == (
        [c.c_void_p] * 8 + [c.c_int] * 4 + [c.c_void_p])
