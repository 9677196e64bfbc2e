"""
S3D-G HowTo100M video backbone, inference only, in NCDHW.

Port of coot_videotext_tpu/models/s3d.py (`BatchNormInference` :35,
`STConv3D` :56, `max_pool_3d_tf_padding` :95, `SelfGating` :117,
`InceptionBlock` :131, `S3D` :170; reference extract_100m_features.py
:195-520). The parameter names are the released `s3d_howto100m.pth`'s,
the keys JAX's `load_torch_s3d_weights` :240 reads (`conv1.conv1.weight`,
`mixed_3b.conv_b1_b.bn2.running_var`, `mixed_4c.gating_b2.fc.weight`,
`gating.fc.bias`, `fc.weight`), so that file loads as it is
(`load_s3d_checkpoint`; its `text_module.*` keys are ignored).

What follows JAX exactly:
    - space-to-depth: (t, h, w, c) blocks of 2 x 2 x 2 become 8C
      channels, channel ((dt * 2 + dh) * 2 + dw) * C + c (:179-186);
    - the stem: a (2, 4, 4) conv with padding (1, 2, 2), then the crop
      [:, :, 1:, 1:, 1:] (:194-196);
    - TF-SAME max pooling: padding max(k - s, 0) split low / high, the
      high side extended so the last window fits (ceil mode), filled with
      -inf, then pooling without padding (torch's own `padding=` is
      symmetric and cannot express it);
    - BatchNorm from stored statistics, eps 1e-5, the scale and shift
      computed in float32 and cast to the compute dtype (:51-53);
    - the head: mixed_5c averaged over (T, H, W), then `fc` to the 512-d
      video_embedding.
The parameters stay float32; under `dtype=torch.bfloat16` each is cast at
use, as JAX's `param_dtype=float32, dtype=bfloat16`. The convolutions are
`F.conv3d` (cuDNN on the card): JAX runs them as `lax.conv`, outside any
Pallas kernel. A float32 forward on the card runs with TF32 off
(`exact_float32`), without touching the global flags beyond the call.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
EMBED_DIM = 512  # the video_embedding of the HowTo100M head


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v, v, v)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the
    block; the previous settings come back after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class BatchNormInference(nn.Module):
    """BatchNorm3d.eval() from stored statistics (JAX :35)."""

    def __init__(self, features: int, eps: float = BN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.running_var + self.eps)
        inv = self.weight / std
        shift = self.bias - self.running_mean * self.weight / std
        shape = (1, -1, 1, 1, 1)
        return (x * inv.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))


class Conv3d(nn.Module):
    """A bias-free 3-D convolution whose float32 weight is cast to the
    input's dtype at use (OIDHW, the checkpoint's layout)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int]) -> None:
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


class Linear(nn.Linear):
    """nn.Linear with its float32 parameters cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class STConv3D(nn.Module):
    """Conv3d + BN + ReLU, separable into (1, k, k) and (k, 1, 1) when
    asked (JAX :56, reference :273)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size,
                 stride: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 separable: bool = False) -> None:
        super().__init__()
        k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
        self.separable = separable and k[0] != 1
        if self.separable:
            self.conv1 = Conv3d(in_dim, out_dim, (1, k[1], k[2]),
                                (1, s[1], s[2]), (0, p[1], p[2]))
            self.bn1 = BatchNormInference(out_dim)
            self.conv2 = Conv3d(out_dim, out_dim, (k[0], 1, 1),
                                (s[0], 1, 1), (p[0], 0, 0))
            self.bn2 = BatchNormInference(out_dim)
        else:
            self.conv1 = Conv3d(in_dim, out_dim, k, s, p)
            self.bn1 = BatchNormInference(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.separable:
            x = F.relu(self.bn2(self.conv2(x)))
        return x


def tf_same_pads(sizes: Sequence[int], kernel, stride
                 ) -> Tuple[Tuple[int, int], ...]:
    """(low, high) padding of each of (T, H, W): TF-SAME plus the ceil-mode
    extension of JAX :95-114."""
    pads = []
    for kd, sd, size in zip(_triple(kernel), _triple(stride), sizes):
        pad_along = max(kd - sd, 0)
        lo = pad_along // 2
        hi = pad_along - lo
        extra = (-(size + lo + hi - kd)) % sd
        pads.append((lo, hi + extra))
    return tuple(pads)


def max_pool_3d_tf_padding(x: torch.Tensor, kernel_size, stride
                           ) -> torch.Tensor:
    """TF-SAME padding with -inf + max pooling without padding (JAX :95,
    reference :333)."""
    (t0, t1), (h0, h1), (w0, w1) = tf_same_pads(x.shape[2:], kernel_size,
                                                stride)
    xp = F.pad(x, (w0, w1, h0, h1, t0, t1), value=-math.inf)
    return F.max_pool3d(xp, _triple(kernel_size), _triple(stride))


class SelfGating(nn.Module):
    """S3D-G feature gating (JAX :117, reference :257)."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.fc = Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))
        return w[:, :, None, None, None] * x


class InceptionBlock(nn.Module):
    """Four branches, each gated (JAX :131, reference :204)."""

    def __init__(self, in_dim: int, n0: int, n1a: int, n1b: int, n2a: int,
                 n2b: int, n3b: int) -> None:
        super().__init__()
        self.conv_b0 = STConv3D(in_dim, n0, 1)
        self.conv_b1_a = STConv3D(in_dim, n1a, 1)
        self.conv_b1_b = STConv3D(n1a, n1b, 3, padding=1, separable=True)
        self.conv_b2_a = STConv3D(in_dim, n2a, 1)
        self.conv_b2_b = STConv3D(n2a, n2b, 3, padding=1, separable=True)
        self.conv_b3_b = STConv3D(in_dim, n3b, 1)
        self.gating_b0 = SelfGating(n0)
        self.gating_b1 = SelfGating(n1b)
        self.gating_b2 = SelfGating(n2b)
        self.gating_b3 = SelfGating(n3b)
        self.output_dim = n0 + n1b + n2b + n3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.conv_b0(x)
        b1 = self.conv_b1_b(self.conv_b1_a(x))
        b2 = self.conv_b2_b(self.conv_b2_a(x))
        # a 3x3x3 max over -inf padding (torch pools over the padding the
        # same way)
        b3 = self.conv_b3_b(F.max_pool3d(x, 3, stride=1, padding=1))
        return torch.cat([self.gating_b0(b0), self.gating_b1(b1),
                          self.gating_b2(b2), self.gating_b3(b3)], dim=1)


# (n0, n1a, n1b, n2a, n2b, n3b) of each inception block (JAX :201-224)
INCEPTION = (
    ("mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("mixed_5c", (384, 192, 384, 48, 128, 128)),
)
# max pools (kernel, stride) before these blocks (JAX :207, :218)
POOL_BEFORE = {"mixed_4b": ((3, 3, 3), (2, 2, 2)),
               "mixed_5b": ((2, 2, 2), (2, 2, 2))}


class S3D(nn.Module):
    """S3D-G base with the space-to-depth stem and gating, as the
    released checkpoint (JAX :170 at its defaults, reference :420). Input
    NCDHW (B, 3, T, H, W) in [0, 1], T a multiple of 2 (of 16 for the
    pooled head to see every frame) and H, W multiples of 2; returns
    video_embedding (B, 512), mixed_5c (B, 1024) and before_mean (B, 1024,
    T', H', W'), in the compute dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = STConv3D(24, 64, (2, 4, 4), stride=1, padding=(1, 2, 2))
        self.conv_2b = STConv3D(64, 64, 1)
        self.conv_2c = STConv3D(64, 192, 3, padding=1, separable=True)
        self.gating = SelfGating(192)
        in_dim = 192
        for name, dims in INCEPTION:
            block = InceptionBlock(in_dim, *dims)
            self.add_module(name, block)
            in_dim = block.output_dim
        self.fc = Linear(in_dim, EMBED_DIM)

    @staticmethod
    def space_to_depth_ncdhw(x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) -> (B, 8C, T/2, H/2, W/2), channel
        ((dt * 2 + dh) * 2 + dw) * C + c (JAX :179)."""
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // 2, 2, h // 2, 2, w // 2, 2)
        x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
        return x.reshape(b, 8 * c, t // 2, h // 2, w // 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        exact = (self.dtype == torch.float32 and x.is_cuda)
        with exact_float32() if exact else contextlib.nullcontext():
            return self._forward(x.to(self.dtype))

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        net = self.conv1(self.space_to_depth_ncdhw(x))[:, :, 1:, 1:, 1:]
        net = max_pool_3d_tf_padding(net, (1, 3, 3), (1, 2, 2))
        net = self.gating(self.conv_2c(self.conv_2b(net)))
        net = max_pool_3d_tf_padding(net, (1, 3, 3), (1, 2, 2))
        for name, _ in INCEPTION:
            if name in POOL_BEFORE:
                net = max_pool_3d_tf_padding(net, *POOL_BEFORE[name])
            net = getattr(self, name)(net)
        pooled = net.mean(dim=(2, 3, 4))
        return {"video_embedding": self.fc(pooled), "mixed_5c": pooled,
                "before_mean": net}


def init_s3d_weights(model: S3D, seed: int) -> S3D:
    """Seeded weights in place of the released checkpoint: He-normal
    convolutions (activations stay O(1) through the 60+ layers), 1/sqrt(in)
    linears, BatchNorm statistics and affine terms near the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.state_dict().items()):
            if name.endswith("running_var"):
                v = 1.0 + 0.1 * torch.rand(p.shape, generator=gen)
            elif p.dim() == 5:
                fan_in = p[0].numel()
                v = torch.randn(p.shape, generator=gen) * math.sqrt(
                    2.0 / fan_in)
            elif p.dim() == 2:
                v = torch.randn(p.shape, generator=gen) / math.sqrt(
                    p.shape[1])
            elif name.endswith(".weight"):  # BatchNorm scale
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            else:  # biases, running_mean
                v = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(v)
    return model


def load_s3d_checkpoint(model: S3D, state: Dict[str, torch.Tensor]) -> S3D:
    """The released state dict (`s3d_howto100m.pth`) into `model`: the
    text branch's `text_module.*` keys and BatchNorm's
    `num_batches_tracked` counters are not the video backbone's; every
    other key must match."""
    state = {k: v for k, v in state.items()
             if not k.startswith("text_module")
             and not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=True)
    return model
