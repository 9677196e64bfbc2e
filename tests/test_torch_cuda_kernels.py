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
the tolerance above: the two erfinv may differ in the last bits).
"""

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


def _rel(out, ref):
    out, ref = out.float(), ref.float()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_fc_kernel(cuda, dtype):
    """Ragged S with constant rows, the text width."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1001, 1536, generator=g, device=cuda) * 2 + 0.5
    x[:3] = 3.0
    gain = 1 + 0.1 * torch.randn(1536, generator=g, device=cuda)
    bias = 0.1 * torch.randn(1536, generator=g, device=cuda)
    w = torch.randn(384, 1536, generator=g, device=cuda) / 1536 ** 0.5
    b = 0.1 * torch.randn(384, generator=g, device=cuda)
    args = (x.to(dtype), gain, bias, w.to(dtype), b, 1e-6, "gelu")
    assert _run(fused_input_fc, fused_input_fc_plain, args,
                "input_fc") <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_genpool_kernel(cuda, dtype):
    """The paragraph length L = 300, with fully masked rows."""
    g = torch.Generator(device=cuda).manual_seed(1)
    s, length, d, heads, dh = 40, 300, 384, 2, 384
    f = torch.randn(s, length, d, generator=g, device=cuda)
    lens = torch.randint(1, length + 1, (s,), generator=g, device=cuda)
    mask = torch.arange(length, device=cuda)[None] < lens[:, None]
    mask[:4] = False
    w1 = torch.randn(heads, d, dh, generator=g, device=cuda) / d ** 0.5
    b1 = 0.1 * torch.randn(heads, dh, generator=g, device=cuda)
    w2 = torch.randn(heads, dh, d // heads, generator=g,
                     device=cuda) / dh ** 0.5
    b2 = 0.1 * torch.randn(heads, d // heads, generator=g, device=cuda)
    args = (f.to(dtype), mask, w1, b1, w2, b2, "gelu")
    assert _run(genpool, genpool_plain, args, "genpool") <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk", [(80, 80), (1, 16), (300, 300)])
def test_attention_kernel(cuda, dtype, lq, lk):
    """d_head 48; self, cross (Lq = 1) and paragraph lengths; all-masked
    rows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, heads, dh = 16, 8, 48
    q = torch.randn(b * heads, lq, dh, generator=g, device=cuda)
    k = torch.randn(b * heads, lk, dh, generator=g, device=cuda)
    v = torch.randn(b * heads, lk, dh, generator=g, device=cuda)
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=cuda)
    key_valid = torch.arange(lk, device=cuda)[None] < lens[:, None]
    key_valid[:2] = False
    args = (q.to(dtype), k.to(dtype), v.to(dtype), key_valid, heads,
            dh ** -0.5)
    assert _run(masked_attention, masked_attention_plain, args,
                "attention") <= TOL[dtype]
    with torch.inference_mode():
        out = masked_attention(*args).float()
    expect = v[:2 * heads].mean(dim=1, keepdim=True).expand(-1, lq, -1)
    assert _rel(out[:2 * heads], expect) <= TOL[dtype]


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


def _fc_args(cuda, dtype, s, din, dout):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(s, din, generator=g, device=cuda) * 2 + 0.5
    x[:3] = 3.0
    params = [1 + 0.1 * torch.randn(din, generator=g, device=cuda),
              0.1 * torch.randn(din, generator=g, device=cuda),
              torch.randn(dout, din, generator=g, device=cuda) / din ** 0.5,
              0.1 * torch.randn(dout, generator=g, device=cuda)]
    dy = torch.randn(s, dout, generator=g, device=cuda)
    return x.to(dtype), params, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_fc_backward_kernel(cuda, dtype):
    """Ragged S with constant rows, the text width."""
    x, params, dy = _fc_args(cuda, dtype, 1001, 1536, 384)
    ours = _grads(lambda *p: fused_input_fc(x, *p, 1e-6, "gelu"), params,
                  dy, "input_fc")
    ref = fused_input_fc_backward_plain(x, *params, 1e-6, "gelu",
                                        dy.to(dtype))
    for a, r in zip(ours, ref):
        assert _rel(a, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_genpool_backward_kernel(cuda, dtype, rate):
    """L = 80 with fully masked rows; dropout at the three sites."""
    g = torch.Generator(device=cuda).manual_seed(4)
    s, length, d, heads, dh = 48, 80, 384, 2, 384
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
    with torch.inference_mode():
        assert _rel(genpool(f, mask, *params, "gelu", rate, 77),
                    genpool_plain(f, mask, *params, "gelu", rate, 77)) \
            <= TOL[dtype]
    ours = _grads(lambda f_, *p: genpool(f_, mask, *p, "gelu", rate, 77),
                  [f] + params, dout, "genpool")
    ref = genpool_backward_plain(f, mask, *params, "gelu", dout.to(dtype),
                                 rate, 77)
    for i, (a, r) in enumerate(zip(ours, ref)):
        # db2 (i = 4) is ~0 without dropout: compare it absolutely
        assert _rel(a, r) <= TOL[dtype], i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,rate", [(80, 80, 0.0), (80, 80, 0.1),
                                        (1, 16, 0.0), (300, 300, 0.1)])
def test_attention_backward_kernel(cuda, dtype, lq, lk, rate):
    """Self, cross (Lq = 1) and paragraph lengths, all-masked rows (zero
    score gradient there), dropout on P."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, heads, dh = 16, 8, 48
    qkv = [torch.randn(b * heads, n, dh, generator=g, device=cuda).to(dtype)
           for n in (lq, lk, lk)]
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=cuda)
    key_valid = torch.arange(lk, device=cuda)[None] < lens[:, None]
    key_valid[:2] = False
    go = torch.randn(b * heads, lq, dh, generator=g, device=cuda)
    with torch.inference_mode():
        assert _rel(masked_attention(*qkv, key_valid, heads, dh ** -0.5,
                                     rate, 9),
                    masked_attention_plain(*qkv, key_valid, heads,
                                           dh ** -0.5, rate, 9)) \
            <= TOL[dtype]
    ours = _grads(lambda *a: masked_attention(*a, key_valid, heads,
                                              dh ** -0.5, rate, 9),
                  qkv, go, "attention")
    ref = masked_attention_backward_plain(*qkv, key_valid, go.to(dtype),
                                          heads, dh ** -0.5, rate, 9)
    for a, r in zip(ours, ref):
        assert _rel(a, r) <= TOL[dtype]
    assert float(ours[0][:2 * heads].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel(cuda, dtype):
    """A ragged element count; forward and backward equal the plain
    version exactly (same bits, one rounding)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(1001, 383, generator=g, device=cuda).to(dtype)
    before = cuda_build.launch_counts["dropout"]
    with torch.inference_mode():
        y = dropout(x, 2 ** 50 + 3, 0.1)
    assert cuda_build.launch_counts["dropout"] == before + 1
    assert torch.equal(y, dropout_plain(x, 2 ** 50 + 3, 0.1))
    gy = torch.randn(1001, 383, generator=g, device=cuda)
    gx, = _grads(lambda a: dropout(a, 2 ** 50 + 3, 0.1), [x], gy,
                 "dropout")
    assert torch.equal(gx, dropout_plain(gy.to(dtype), 2 ** 50 + 3, 0.1))


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
    noise = GatherNoise(0.01, 2 ** 40 + 1, philox.SITE_NOISE_CLIP)
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
                        GatherNoise(1.0, 5, philox.SITE_NOISE_VIDEO))
    assert float(draws.abs().max()) <= 2.0
    assert abs(float(draws.std()) / 0.8796 - 1.0) < 0.02


@pytest.mark.cuda
def test_gather_rejects_unsupported_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        gather_rows(torch.zeros(8, 6, device=cuda), idx)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(torch.zeros(8, 8, device=cuda), idx.long())
