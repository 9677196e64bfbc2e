"""
The port's CUDA kernels (coot_videotext_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `cuda`: without a GPU they skip (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_kernels.py

Tolerance, max |kernel - plain| / max(1, max |plain|): 1e-4 in float32
(summation order), 1e-2 in bfloat16 (outputs rounded to 8 significant
bits, so the two can land one bf16 step apart); the same for every
backward output. Dropout masks come from the same Philox bits on both
sides, so kernel and plain agree on them exactly; the B5 gather is a copy
and agrees bit for bit, and its fused noise takes the same bits (within
the tolerance above: the two erfinv may differ in the last bits). Every
seed is a `philox.Seed`: a seed state on the card and the call's
position, which the kernels and the plain versions derive the same way.
A step captured as a CUDA graph and replayed agrees with the same steps
run eagerly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.attention import (
    masked_attention, masked_attention_backward_plain,
    masked_attention_plain)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.dropout import dropout, dropout_plain
from coot_videotext_tpu_torch.ops.gather import (
    GatherNoise, gather_rows, gather_rows_plain)
from coot_videotext_tpu_torch.ops.genpool import (
    genpool, genpool_backward_plain, genpool_plain)
from coot_videotext_tpu_torch.ops.input_fc import (
    fused_input_fc, fused_input_fc_backward_plain, fused_input_fc_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode; run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _seed(device, value, call=0):
    """The seed of call `call` under a seed state of `value` on device."""
    return philox.Seed(philox.seed_state(value, device), call)


def _rel(out, ref):
    out, ref = out.detach().float(), ref.detach().float()
    return float((out - ref).abs().max()) / max(1.0,
                                                float(ref.abs().max()))


def _run(kernel, plain, args, name):
    before = cuda_build.launch_counts[name]
    with torch.inference_mode():
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
    assert cuda_build.launch_counts[name] == before + 1
    return _rel(out, ref)


# (S, din, constant rows, x = 100 + 0.5 N): the text width with ragged S;
# 4,099 rows (ragged in every tile size) at the video width; S = 1 and 17;
# rows with mean^2 >> var
FC_SHAPES = [(1001, 1536, 3, False), (4099, 4096, 7, False),
             (1, 1536, 0, False), (17, 1536, 2, False),
             (4099, 4096, 7, True)]


def _fc_args(cuda, dtype, s, din, dout, constant_rows=3, offset=False):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(s, din, generator=g, device=cuda)
    x = x * 0.5 + 100 if offset else x * 2 + 0.5
    x[:constant_rows] = 3.0
    params = [1 + 0.1 * torch.randn(din, generator=g, device=cuda),
              0.1 * torch.randn(din, generator=g, device=cuda),
              torch.randn(dout, din, generator=g, device=cuda) / din ** 0.5,
              0.1 * torch.randn(dout, generator=g, device=cuda)]
    dy = torch.randn(s, dout, generator=g, device=cuda)
    return x.to(dtype), params, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,din,const,offset", FC_SHAPES)
def test_input_fc_kernel(cuda, dtype, s, din, const, offset):
    """Ragged S with constant rows (xhat = 0 exactly), both widths, S = 1
    and 17, and large-offset rows."""
    x, params, _ = _fc_args(cuda, dtype, s, din, 384, const, offset)
    params[2] = params[2].to(dtype)
    args = (x, *params, 1e-6, "gelu")
    assert _run(fused_input_fc, fused_input_fc_plain, args,
                "input_fc") <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_fc_kernel_empty(cuda, dtype):
    """S = 0: an empty (0, dout) output; no kernel is launched."""
    x, params, _ = _fc_args(cuda, dtype, 0, 1536, 384, 0)
    with torch.inference_mode():
        y = fused_input_fc(x, *params, 1e-6, "gelu")
    assert y.shape == (0, 384) and y.dtype == dtype


# (pooled rows, L, D, H, heads, rate): the paragraph length L = 300, the
# four calls of a train step at reduced S (the clips and the video context
# at L 80, the paragraph at 320, the sentences at 24), L = 1, and other
# widths: synthetic_smoke's D 32 / H 64, one head (D 32 and 128 / H 64),
# D 512 (two column groups) and 1024 (heads split over groups)
GENPOOL_FWD = [(40, 300, 384, 768, 2, 0.0), (48, 80, 384, 768, 2, 0.1),
               (64, 80, 384, 768, 2, 0.0), (12, 320, 384, 768, 2, 0.1),
               (64, 24, 384, 768, 2, 0.1), (200, 1, 384, 768, 2, 0.1),
               (20, 37, 32, 64, 2, 0.1), (20, 37, 32, 64, 1, 0.1),
               (20, 37, 128, 64, 1, 0.0), (20, 37, 512, 512, 2, 0.1),
               (20, 37, 1024, 1024, 2, 0.0)]


def _genpool_fwd_args(cuda, dtype, s, length, d, h, heads):
    g = torch.Generator(device=cuda).manual_seed(1)
    dh = h // heads
    f = torch.randn(s, length, d, generator=g, device=cuda)
    lens = torch.randint(1, length + 1, (s,), generator=g, device=cuda)
    mask = torch.arange(length, device=cuda)[None] < lens[:, None]
    mask[:4] = False
    w1 = torch.randn(heads, d, dh, generator=g, device=cuda) / d ** 0.5
    b1 = 0.1 * torch.randn(heads, dh, generator=g, device=cuda)
    w2 = torch.randn(heads, dh, d // heads, generator=g,
                     device=cuda) / dh ** 0.5
    b2 = 0.1 * torch.randn(heads, d // heads, generator=g, device=cuda)
    return f.to(dtype), mask, w1, b1, w2, b2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,length,d,h,heads,rate", GENPOOL_FWD)
def test_genpool_kernel(cuda, dtype, s, length, d, h, heads, rate):
    """Fully masked rows (they pool to the plain average without dropout);
    dropout at the three sites with the plain version's masks. In bf16
    the tile pass and the pooling pass; the backward tests drive the
    unchanged backward from this forward's stats."""
    args = (*_genpool_fwd_args(cuda, dtype, s, length, d, h, heads),
            "gelu", rate, _seed(cuda, 77, 2))
    assert _run(genpool, genpool_plain, args, "genpool") <= TOL[dtype]
    if rate == 0.0:
        with torch.inference_mode():
            out = genpool(*args)
        assert _rel(out[:4], args[0][:4].float().mean(dim=1)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,heads", [(384, 768, 2), (32, 64, 1)])
def test_genpool_forward_repeats_bit_for_bit(cuda, d, h, heads):
    """Two bf16 forwards on the same inputs, without and with the stats
    (eval and train), give bit-equal pooled rows (dropout on)."""
    f, mask, *params = _genpool_fwd_args(cuda, torch.bfloat16, 96, 80, d, h,
                                         heads)
    seed = _seed(cuda, 77)
    with torch.inference_mode():
        first = genpool(f, mask, *params, "gelu", 0.1, seed)
        assert torch.equal(first, genpool(f, mask, *params, "gelu", 0.1,
                                          seed))
    leaves = [p.clone().requires_grad_() for p in params]
    for _ in range(2):
        assert torch.equal(genpool(f, mask, *leaves, "gelu", 0.1,
                                   seed).detach(), first)


# (Lq, Lk, d_head, rate): self (L 80), cross (Lq = 1), the paragraph's 300
# and 320 (three key blocks), the sentences' 24 and the global nets' 16
# (several cells a block), a ragged 37 x 130 (two key blocks) at d_head 16,
# 48, 64 and an odd 21, and Lq = 1 over 130 keys
ATTENTION_FWD = [(80, 80, 48, 0.0), (80, 80, 48, 0.1), (1, 16, 48, 0.0),
                 (300, 300, 48, 0.0), (320, 320, 48, 0.1), (24, 24, 48, 0.1),
                 (16, 16, 48, 0.0), (37, 130, 16, 0.1), (37, 130, 48, 0.0),
                 (37, 130, 64, 0.1), (37, 130, 21, 0.1), (1, 130, 48, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,dh,rate", ATTENTION_FWD)
def test_attention_kernel(cuda, dtype, lq, lk, dh, rate):
    """All-masked rows (without dropout the plain average of v), dropout
    on P with the plain version's masks."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, heads = 16, 8
    q = torch.randn(b * heads, lq, dh, generator=g, device=cuda)
    k = torch.randn(b * heads, lk, dh, generator=g, device=cuda)
    v = torch.randn(b * heads, lk, dh, generator=g, device=cuda)
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=cuda)
    key_valid = torch.arange(lk, device=cuda)[None] < lens[:, None]
    key_valid[:2] = False
    args = (q.to(dtype), k.to(dtype), v.to(dtype), key_valid, heads,
            dh ** -0.5, rate, _seed(cuda, 9, 5))
    assert _run(masked_attention, masked_attention_plain, args,
                "attention") <= TOL[dtype]
    if rate == 0.0:
        with torch.inference_mode():
            out = masked_attention(*args).float()
        expect = v[:2 * heads].mean(dim=1, keepdim=True).expand(-1, lq, -1)
        assert _rel(out[:2 * heads], expect) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(80, 80), (320, 320), (24, 24)])
def test_attention_forward_repeats_bit_for_bit(cuda, lq, lk):
    """Two bf16 forwards on the same inputs, without and with the stats,
    give bit-equal outputs (dropout on)."""
    qkv, key_valid, _, heads, dh = _attention_case(cuda, torch.bfloat16, lq,
                                                   lk)
    args = (key_valid, heads, dh ** -0.5, 0.1, _seed(cuda, 9))
    with torch.inference_mode():
        first = masked_attention(*qkv, *args)
        assert torch.equal(first, masked_attention(*qkv, *args))
    leaves = [a.clone().requires_grad_() for a in qkv]
    for _ in range(2):
        assert torch.equal(masked_attention(*leaves, *args).detach(), first)


@pytest.mark.cuda
def test_kernel_wrappers_reject_unsupported_inputs(cuda):
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    wide = torch.zeros(4, 8, 80, device=cuda)
    with pytest.raises(ValueError, match="Dh <= 64"):
        masked_attention(wide, wide, wide, valid, 4, 1.0)
    half = torch.zeros(4, 8, 48, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        masked_attention(half, half, half, valid, 4, 1.0)


def _grads(fn, inputs, g, name):
    """Gradients of fn's output against g through the kernels' autograd
    Function; the backward must launch once."""
    before = cuda_build.launch_counts[name + "_bwd"]
    inputs = [a.detach().clone().requires_grad_() for a in inputs]
    out = fn(*inputs)
    out.backward(g.to(out.dtype))
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[name + "_bwd"] == before + 1
    return [a.grad for a in inputs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,din,const,offset", FC_SHAPES)
def test_input_fc_backward_kernel(cuda, dtype, s, din, const, offset):
    """The one-product backward against the plain two-product one, at the
    forward's shapes."""
    x, params, dy = _fc_args(cuda, dtype, s, din, 384, const, offset)
    ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"), params,
                  dy, "input_fc")
    ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                        dy.to(dtype))
    for a, r in zip(ours, ref):
        assert _rel(a, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dout", [192, 96])
def test_input_fc_kernel_at_tensor_parallel_widths(cuda, dtype, dout):
    """B1 column-parallel over a `model` axis of 2 and 4 (parallel/tp.py):
    dout 384 / M at both input widths, forward and backward, against the
    plain versions."""
    for s, din in ((4099, 4096), (1001, 1536)):
        x, params, dy = _fc_args(cuda, dtype, s, din, dout)
        args = (x, *params, 1e-6, "gelu")
        assert _run(fused_input_fc, fused_input_fc_plain, args,
                    "input_fc") <= TOL[dtype]
        ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"),
                      params, dy, "input_fc")
        ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                            dy.to(dtype))
        for a, r in zip(ours, ref):
            assert _rel(a, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_fc_backward_repeats_bit_for_bit(cuda, dtype):
    """No float atomics: two backward calls on the same inputs give
    bit-equal dgain, dbias, dW and db."""
    x, params, dy = _fc_args(cuda, dtype, 4099, 4096, 384, 7)

    def fn(*p):
        return fused_input_fc(x, *p, 1e-6, "gelu")

    first = _grads(fn, params, dy, "input_fc")
    second = _grads(fn, params, dy, "input_fc")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_fc_backward_kernel_ragged_widths(cuda, dtype):
    """din 48 and dout 32 (synthetic_smoke's text input FC): the backward
    pads them to 64 and 32 and runs its kernel (no plain path)."""
    x, params, dy = _fc_args(cuda, dtype, 1001, 48, 32)
    params[2] = params[2].to(dtype)
    assert _run(fused_input_fc, fused_input_fc_plain,
                (x, *params, 1e-6, "gelu"), "input_fc") <= TOL[dtype]
    params[2] = params[2].float()
    ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"), params,
                  dy, "input_fc")
    ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                        dy.to(dtype))
    for a, r in zip(ours, ref):
        assert a.shape == r.shape
        assert _rel(a, r) <= TOL[dtype]


def _genpool_case(cuda, dtype, s, length, d=384, h=768, heads=2):
    g = torch.Generator(device=cuda).manual_seed(4)
    dh = h // heads
    f = torch.randn(s, length, d, generator=g, device=cuda).to(dtype)
    lens = torch.randint(1, length + 1, (s,), generator=g, device=cuda)
    mask = torch.arange(length, device=cuda)[None] < lens[:, None]
    mask[:4] = False
    params = [torch.randn(heads, d, dh, generator=g, device=cuda) / d ** 0.5,
              0.1 * torch.randn(heads, dh, generator=g, device=cuda),
              torch.randn(heads, dh, d // heads, generator=g,
                          device=cuda) / dh ** 0.5,
              0.1 * torch.randn(heads, d // heads, generator=g, device=cuda)]
    dout = torch.randn(s, d, generator=g, device=cuda)
    return f, mask, params, dout


def _check_genpool_backward(f, mask, params, dout, rate, dtype):
    seed = _seed(f.device, 77, 1)
    with torch.inference_mode():
        assert _rel(genpool(f, mask, *params, "gelu", rate, seed),
                    genpool_plain(f, mask, *params, "gelu", rate, seed)) \
            <= TOL[dtype]
    ours = _grads(lambda f_, *p: genpool(f_, mask, *p, "gelu", rate, seed),
                  [f] + params, dout, "genpool")
    ref = genpool_backward_plain(f, mask, *params, "gelu", dout.to(dtype),
                                 rate, seed)
    for i, (a, r) in enumerate(zip(ours, ref)):
        # db2 (i = 4) is ~0 without dropout: compare it absolutely
        assert _rel(a, r) <= TOL[dtype], i
    if rate >= 0.1 and f.shape[1] > 1:
        # the keep2 mask makes db2 clearly nonzero (at L = 1 the softmax
        # over one slot has no gradient, so db2 stays ~0)
        db2, ref_db2 = ours[4].float(), ref[4].float()
        assert float((db2 - ref_db2).abs().max()) <= \
            TOL[dtype] * float(ref_db2.abs().max())
    return ours


# (pooled rows, L): the four calls of a train step at reduced S (the clips
# and the video context at L 80, the sentences at 24, the paragraph at
# 320, with tiles that cross pooled rows), and L = 1 (a tile of 64 pooled
# rows, past the staged stats)
GENPOOL_ROWS = [(48, 80), (64, 24), (12, 320), (200, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s,length", GENPOOL_ROWS)
def test_genpool_backward_kernel(cuda, dtype, rate, s, length):
    """D 384, H 768, 2 heads, fully masked rows; dropout at the three
    sites."""
    _check_genpool_backward(*_genpool_case(cuda, dtype, s, length), rate,
                            dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,heads", [(32, 64, 2), (512, 512, 2),
                                       (1024, 1024, 2), (128, 256, 8),
                                       (32, 64, 1), (128, 64, 1)])
def test_genpool_backward_kernel_widths(cuda, d, h, heads):
    """bf16 at other widths: synthetic_smoke's D 32 / H 64 (one 32-unit
    hidden block per head), D 512 (two column groups), D 1024 (tiles of 32
    rows, two groups of 512 columns each split), 8 heads of 16 columns,
    and one head of one 64-unit block (PoolerConfig's default head count),
    where pass B's first step follows pass A's last closely."""
    _check_genpool_backward(*_genpool_case(cuda, torch.bfloat16, 20, 37, d,
                                           h, heads), 0.1, torch.bfloat16)


@pytest.mark.cuda
def test_genpool_backward_repeats_bit_for_bit(cuda):
    """No float atomics: two bf16 backward calls on the same inputs give
    bit-equal df, dw1, db1, dw2 and db2 (dropout on)."""
    f, mask, params, dout = _genpool_case(cuda, torch.bfloat16, 96, 80)
    seed = _seed(cuda, 77)

    def fn(f_, *p):
        return genpool(f_, mask, *p, "gelu", 0.1, seed)

    first = _grads(fn, [f] + params, dout, "genpool")
    second = _grads(fn, [f] + params, dout, "genpool")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _attention_case(cuda, dtype, lq, lk, dh=48):
    g = torch.Generator(device=cuda).manual_seed(5)
    b, heads = 16, 8
    qkv = [torch.randn(b * heads, n, dh, generator=g, device=cuda).to(dtype)
           for n in (lq, lk, lk)]
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=cuda)
    key_valid = torch.arange(lk, device=cuda)[None] < lens[:, None]
    key_valid[:2] = False
    go = torch.randn(b * heads, lq, dh, generator=g, device=cuda)
    return qkv, key_valid, go, heads, dh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,rate,dh", [
    (80, 80, 0.0, 48), (80, 80, 0.1, 48), (1, 16, 0.0, 48),
    (300, 300, 0.1, 48), (24, 24, 0.1, 48), (320, 320, 0.01, 48),
    (37, 130, 0.1, 48), (37, 130, 0.1, 21)])
def test_attention_backward_kernel(cuda, dtype, lq, lk, rate, dh):
    """Self, cross (Lq = 1), sentence (L = 24) and paragraph lengths (300;
    320 as the train step runs it, three key blocks), a ragged 37 x 130
    (no multiple of 16, two key blocks; also with an odd d_head, staged
    and stored element by element), all-masked rows (zero score gradient
    there), dropout on P."""
    qkv, key_valid, go, heads, dh = _attention_case(cuda, dtype, lq, lk, dh)
    seed = _seed(cuda, 9, 4)
    with torch.inference_mode():
        assert _rel(masked_attention(*qkv, key_valid, heads, dh ** -0.5,
                                     rate, seed),
                    masked_attention_plain(*qkv, key_valid, heads,
                                           dh ** -0.5, rate, seed)) \
            <= TOL[dtype]
    ours = _grads(lambda *a: masked_attention(*a, key_valid, heads,
                                              dh ** -0.5, rate, seed),
                  qkv, go, "attention")
    ref = masked_attention_backward_plain(*qkv, key_valid, go.to(dtype),
                                          heads, dh ** -0.5, rate, seed)
    for a, r in zip(ours, ref):
        assert _rel(a, r) <= TOL[dtype]
    assert float(ours[0][:2 * heads].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,rate", [(80, 80, 0.01), (24, 24, 0.1),
                                        (320, 320, 0.01), (37, 130, 0.1)])
def test_attention_backward_rows_of_one_key(cuda, lq, lk, rate):
    """C4: where a batch row's only valid key is key 0, the score gradient
    is 0, and so is dk there in the plain version. The bf16 kernel forms
    D = rowsum(g * o) in f32, as sum_j P f (g . v), so its dk there is 0
    up to f32 rounding too (formed from the forward's bf16 o, it reached
    0.17 with dropout on: 5.5 bf16 ulps of max |dk|, over the gate); over 8
    draws with 8 such rows each, every gradient within the gate."""
    b, heads, dh = 16, 8, 48
    for draw in range(8):
        g = torch.Generator(device=cuda).manual_seed(100 + draw)
        qkv = [torch.randn(b * heads, n, dh, generator=g,
                           device=cuda).to(torch.bfloat16)
               for n in (lq, lk, lk)]
        lens = torch.randint(1, lk + 1, (b,), generator=g, device=cuda)
        lens[:8] = 1
        key_valid = torch.arange(lk, device=cuda)[None] < lens[:, None]
        go = torch.randn(b * heads, lq, dh, generator=g, device=cuda)
        seed = _seed(cuda, 20261016 + draw)
        ours = _grads(lambda *a: masked_attention(*a, key_valid, heads,
                                                  dh ** -0.5, rate, seed),
                      qkv, go, "attention")
        ref = masked_attention_backward_plain(
            *qkv, key_valid, go.to(torch.bfloat16), heads, dh ** -0.5, rate,
            seed)
        for a, r in zip(ours, ref):
            assert _rel(a, r) <= TOL[torch.bfloat16], draw
        assert float(ref[1][:8 * heads, 0].float().abs().max()) <= 1e-4
        assert float(ours[1][:8 * heads, 0].float().abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(80, 80), (320, 320), (37, 130)])
def test_attention_backward_repeats_bit_for_bit(cuda, lq, lk):
    """No float atomics: two backward calls on the same inputs give
    bit-equal dq, dk, dv (bf16, dropout on)."""
    qkv, key_valid, go, heads, dh = _attention_case(cuda, torch.bfloat16,
                                                    lq, lk)

    seed = _seed(cuda, 9)

    def fn(*a):
        return masked_attention(*a, key_valid, heads, dh ** -0.5, 0.1, seed)

    first = _grads(fn, qkv, go, "attention")
    second = _grads(fn, qkv, go, "attention")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel(cuda, dtype):
    """A ragged element count; forward and backward equal the plain
    version exactly (same bits, one rounding)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(1001, 383, generator=g, device=cuda).to(dtype)
    before = cuda_build.launch_counts["dropout"]
    seed = _seed(cuda, 2 ** 50 + 3, 7)
    with torch.inference_mode():
        y = dropout(x, seed, 0.1)
    assert cuda_build.launch_counts["dropout"] == before + 1
    assert torch.equal(y, dropout_plain(x, seed, 0.1))
    gy = torch.randn(1001, 383, generator=g, device=cuda)
    gx, = _grads(lambda a: dropout(a, seed, 0.1), [x], gy, "dropout")
    assert torch.equal(gx, dropout_plain(gy.to(dtype), seed, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_misaligned_and_strided(cuda, dtype):
    """A view one element off 16-byte alignment (scalar head and tail
    around the 16-byte vectors) and a transposed cotangent: forward and
    backward equal the plain version bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.randn(1001 * 383 + 1, generator=g, device=cuda).to(dtype)
    x = flat.view(-1)[1:].view(1001, 383)
    assert x.data_ptr() % 16
    seed = _seed(cuda, 2 ** 33 + 5, 11)
    with torch.inference_mode():
        assert torch.equal(dropout(x, seed, 0.1), dropout_plain(x, seed, 0.1))
    strided = torch.randn(383, 1001, generator=g, device=cuda).to(dtype).t()
    for gy in (x, strided):
        gx, = _grads(lambda a: dropout(a, seed, 0.1), [x], gy, "dropout")
        assert torch.equal(gx, dropout_plain(gy, seed, 0.1))


# B4's float32 calls in the caption train steps of yc2_mart.yaml (raw
# features, L = 122: hidden rows and attention probabilities) and of
# yc2_100m_coot_vidclip_mtrans.yaml (video rows 1152 / 768, text rows,
# self-, cross- and video-attention probabilities), and two element counts
# that are not multiples of 4 (the scalar tail after the 16-byte vectors)
CAPTION_DROPOUT_SHAPES = [
    (16, 122, 768), (16, 12, 122, 122), (16, 3, 1152), (16, 3, 768),
    (16, 12, 3, 3), (16, 22, 768), (16, 12, 22, 22), (16, 12, 22, 3),
    (15, 1, 3, 3), (15, 22, 767)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CAPTION_DROPOUT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dropout_kernel_caption_shapes(cuda, shape):
    """Rate 0.1 in float32: forward and backward bit-equal to the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(shape, generator=g, device=cuda)
    seed = _seed(cuda, 2 ** 40 + 1, 3)
    before = cuda_build.launch_counts["dropout"]
    with torch.inference_mode():
        y = dropout(x, seed, 0.1)
    assert cuda_build.launch_counts["dropout"] == before + 1
    assert torch.equal(y, dropout_plain(x, seed, 0.1))
    gy = torch.randn(shape, generator=g, device=cuda)
    gx, = _grads(lambda a: dropout(a, seed, 0.1), [x], gy, "dropout")
    assert torch.equal(gx, dropout_plain(gy, seed, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4096, 1536])
def test_gather_kernel(cuda, dtype, d):
    """Ragged N with repeated indices and the table's last row: a bit-equal
    copy, and with noise bit-equal to the plain version (same Philox bits,
    erfinvf and rounding), which differs from the copy."""
    g = torch.Generator(device=cuda).manual_seed(7)
    table = torch.randn(3000, d, generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, 3000, (1001,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[:5] = 2999
    before = cuda_build.launch_counts["gather"]
    out = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["gather"] == before + 1
    assert torch.equal(out, gather_rows_plain(table, idx))
    noise = GatherNoise(0.01, _seed(cuda, 2 ** 40 + 1, 3),
                        philox.SITE_NOISE_CLIP)
    noisy = gather_rows(table, idx, noise)
    assert torch.equal(noisy, gather_rows_plain(table, idx, noise))
    assert not torch.equal(noisy, out)


@pytest.mark.cuda
def test_gather_noise_is_a_truncated_normal(cuda):
    """1e6 draws of std 1 on a zero table: |tn| <= 2 and the std of a
    normal truncated at +-2 (0.8796) within 2%."""
    zeros = torch.zeros(1, 1000, device=cuda)
    draws = gather_rows(zeros, torch.zeros(1000, dtype=torch.int32,
                                           device=cuda),
                        GatherNoise(1.0, _seed(cuda, 5),
                                    philox.SITE_NOISE_VIDEO))
    assert float(draws.abs().max()) <= 2.0
    assert abs(float(draws.std()) / 0.8796 - 1.0) < 0.02


@pytest.mark.cuda
def test_gather_rejects_unsupported_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        gather_rows(torch.zeros(8, 6, device=cuda), idx)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(torch.zeros(8, 8, device=cuda), idx.long())


# ---------------- device seeds and the captured step ----------------

@pytest.mark.cuda
def test_kernels_derive_the_host_derived_seed(cuda):
    """Each kernel with a seed state on the card equals its plain version
    given the seed by value, derived on the host (philox.derive_seed): B4
    and B5's noise bit for bit, B2 and B3 within the tolerance."""
    value, call = 2 ** 62 + 2 ** 31 + 5, 19
    seed = _seed(cuda, value, call)
    host = philox.derive_seed(value, call)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(777, 65, generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        assert torch.equal(dropout(x, seed, 0.2), dropout_plain(x, host, 0.2))
        table = torch.randn(300, 64, generator=g, device=cuda)
        idx = torch.randint(0, 300, (500,), generator=g, device=cuda,
                            dtype=torch.int32)
        assert torch.equal(
            gather_rows(table, idx, GatherNoise(0.5, seed, 6)),
            gather_rows_plain(table, idx, GatherNoise(0.5, host, 6)))
        args = _genpool_fwd_args(cuda, torch.float32, 16, 20, 32, 64, 2)
        assert _rel(genpool(*args, "gelu", 0.2, seed),
                    genpool_plain(*args, "gelu", 0.2, host)) <= 1e-4
        qkv, key_valid, _, heads, dh = _attention_case(cuda, torch.float32,
                                                       20, 20)
        assert _rel(masked_attention(*qkv, key_valid, heads, dh ** -0.5, 0.2,
                                     seed),
                    masked_attention_plain(*qkv, key_valid, heads,
                                           dh ** -0.5, 0.2, host)) <= 1e-4


@pytest.mark.cuda
def test_masks_change_with_the_step_and_the_call(cuda):
    """Advancing the seed state (once per train step) or taking the next
    call gives another mask; the same (state, call) the same mask."""
    x = torch.ones(4096, device=cuda)
    state = philox.seed_state(3, cuda)
    with torch.inference_mode():
        first = dropout(x, philox.Seed(state, 0), 0.5)
        assert torch.equal(first, dropout(x, philox.Seed(state, 0), 0.5))
        other_call = dropout(x, philox.Seed(state, 1), 0.5)
        state.add_(1)
        next_step = dropout(x, philox.Seed(state, 0), 0.5)
    for other in (other_call, next_step):
        assert not torch.equal(first == 0, other == 0)
        assert abs(float((other == 0).float().mean()) - 0.5) < 0.05


@pytest.mark.cuda
def test_captured_dropout_replays_new_masks(cuda):
    """A CUDA graph of (dropout at call 0, advance the state) replayed 3
    times gives bit for bit the masks of 3 eager runs, each a new one."""
    x = torch.randn(1000, 33, device=cuda)
    out = torch.empty_like(x)

    def step(state):
        out.copy_(dropout(x, philox.Seed(state, 0), 0.3))
        state.add_(1)

    eager_state = philox.seed_state(11, cuda)
    eager = []
    for _ in range(3):
        step(eager_state)
        eager.append(out.clone())
    state = philox.seed_state(11, cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm up, then reset
        step(state)
    torch.cuda.current_stream().wait_stream(stream)
    state.fill_(11)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(state)
    for ref in eager:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    assert not torch.equal(eager[0] == 0, eager[1] == 0)
    assert int(state) == int(eager_state) == 14


def _id_train_setup(cuda, tmp_path):
    """A tiny retrieval run on id batches (store on the card, device
    sampling), dropout 0.1 in the self-attention and the GenPool, frame
    and word noise 0.05, cycle consistency on; two model managers with the
    same weights."""
    from coot_videotext_tpu_torch.data.retrieval_dataset import (
        create_retrieval_datasets_and_loaders)
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_retrieval_dataset)
    from coot_videotext_tpu_torch.tasks.retrieval.config import (
        RetrievalConfig)
    from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
        RetrievalModelManager)
    # tests/helpers.py by its path: the card's machine may have another
    # module named `tests` on its path
    spec = importlib.util.spec_from_file_location(
        "coot_test_helpers", Path(__file__).with_name("helpers.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    retrieval_config_dict = helpers.retrieval_config_dict
    overrides = generate_retrieval_dataset(
        tmp_path, num_videos=48, num_val_videos=4, mean_clips=3.0,
        max_clips=5, seed=2, feat_format="npy")
    cfg_dict = retrieval_config_dict(overrides, batch_size=8)
    cfg_dict["dataset_train"].update(frames_noise=0.05, words_noise=0.05)
    for net in ("net_video_local", "net_text_local", "net_video_global",
                "net_text_global"):
        cfg_dict[net]["selfatn_config"]["dropout"] = 0.1
        if cfg_dict[net]["pooler_config"]["name"] == "atn":
            cfg_dict[net]["pooler_config"]["dropout"] = 0.1
    cfg = RetrievalConfig(cfg_dict)
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, tmp_path, seed=0, fixed_shapes=True, device_preload=True,
        device=cuda)
    assert loader.layout == "ids"
    mgrs = [RetrievalModelManager(cfg, cuda, seed=0) for _ in range(2)]
    return cfg, loader, mgrs


@pytest.mark.cuda
def test_captured_step_replays_like_eager_steps(cuda, tmp_path):
    """Six steps on id batches, per step (eager) and as two groups of 3
    (the first step eager, then the captured step replayed 2 and 3
    times): the same seed state after each (so the same masks and
    noise), per-step losses and every parameter and moment within 1e-4 of
    max(1, max |eager|) (float32)."""
    from coot_videotext_tpu_torch.data.device_store import FeatureSource
    from coot_videotext_tpu_torch.tasks.retrieval.steps import (
        TrainState, retrieval_train_group, retrieval_train_step)
    from coot_videotext_tpu_torch.train.optim import make_optimizer
    cfg, loader, mgrs = _id_train_setup(cuda, tmp_path)
    source = FeatureSource.of(loader, 0.05, 0.05)
    batches = [b for _, b in zip(range(6), loader)]
    assert len(batches) == 6
    kw = dict(lr=3e-3, clip_gradient=1.0, compute_dtype=torch.float32,
              source=source, margin=0.2, loss_cycle_cons=0.001,
              loss_weights=cfg.train.contrastive_loss_config.as_dict())
    states = [TrainState(m.model, make_optimizer(
        cfg.optimizer, dict(m.model.named_parameters())),
        philox.seed_state(0, cuda)) for m in mgrs]
    eager = []
    for b in batches:
        batch = {"layout": "ids",
                 "dp_idx": torch.from_numpy(b["dp_idx"]).to(cuda),
                 "batch_valid": torch.from_numpy(b["batch_valid"]).to(cuda)}
        eager.append({k: float(v) for k, v in retrieval_train_step(
            states[0], batch, **kw).items()})
    grouped = []
    for g0 in (0, 3):
        ids = np.stack([b["dp_idx"] for b in batches[g0:g0 + 3]])
        valid = np.stack([b["batch_valid"] for b in batches[g0:g0 + 3]])
        out = retrieval_train_group(states[1], ids, valid, 3, **kw)
        grouped += [{k: float(v[i]) for k, v in out.items()}
                    for i in range(3)]
    assert states[1].graph is not None and states[1].graph.graph is not None
    assert states[0].step == states[1].step == 6
    assert int(states[0].seed) == int(states[1].seed) == 6
    assert int(states[1].optimizer.step_count) == 6
    for e, g in zip(eager, grouped):
        assert set(e) == set(g)
        for k in e:
            assert abs(e[k] - g[k]) <= 1e-4 * max(1.0, abs(e[k])), k
    for (name, a), b in zip(states[0].optimizer.params.items(),
                            states[1].optimizer.params.values()):
        assert _rel(b, a) <= 1e-4, name
        for moments in ("mu", "nu"):
            ref = getattr(states[0].optimizer, moments)[name]
            assert _rel(getattr(states[1].optimizer, moments)[name],
                        ref) <= 1e-4, (moments, name)
