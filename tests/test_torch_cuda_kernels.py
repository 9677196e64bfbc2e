"""
The port's CUDA kernels (coot_videotext_tpu_torch/csrc) against their plain
PyTorch versions on the card. Marked `cuda`: without a GPU they skip (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_kernels.py

Tolerance, max |kernel - plain| / max(1, max |plain|): 1e-4 in float32
(summation order), 1e-2 in bfloat16 (outputs rounded to 8 significant
bits, so the two can land one bf16 step apart).
"""

import pytest
import torch

from coot_videotext_tpu_torch.ops import cuda_build
from coot_videotext_tpu_torch.ops.attention import (
    masked_attention, masked_attention_plain)
from coot_videotext_tpu_torch.ops.genpool import genpool, genpool_plain
from coot_videotext_tpu_torch.ops.input_fc import (
    fused_input_fc, fused_input_fc_plain)

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
