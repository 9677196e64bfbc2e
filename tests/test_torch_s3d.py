"""
The port's S3D-G backbone and feature extractor against the JAX package's
(coot_videotext_tpu/models/s3d.py, extract_100m_features.py), on the CPU.

The JAX parameters are `eval_shape`-filled numpy values (a real
`model.init` of the 60+ convolutions costs minutes here, as
tests/test_s3d.py notes) and its forward is jitted (2.8 s to compile
against ~21 s eager). Tolerances: float32 within 1e-4 of max |JAX|;
bfloat16 (both sides bf16 convolutions with float32 parameters) cosine
>= 0.99 against JAX's bf16 output.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coot_videotext_tpu.models import s3d as js3d
from coot_videotext_tpu_torch import extract_100m_features as port_tool
from coot_videotext_tpu_torch.models import s3d
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_s3d_params_to_state_dict)

torch.set_num_threads(1)

TOL = 1e-4
MIN_COSINE = 0.99
OUTPUTS = ("video_embedding", "mixed_5c")


def _rel_err(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _filled_params(model, sample, seed=0):
    """The parameter tree of `model` from `eval_shape`, filled with seeded
    values: kernels 0.05 N(0, 1), BN scale 1 + 0.1 N, var 1 + 0.1 U,
    bias / mean 0.1 N."""
    shapes = jax.eval_shape(lambda r: model.init(r, sample),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = 0.05 * rng.standard_normal(s.shape)
        elif name == "var":
            v = 1.0 + 0.1 * rng.rand(*s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_forward(params, x, dtype):
    model = js3d.S3D(num_classes=512, dtype=dtype)
    out = jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, jnp.asarray(x))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _port(state, dtype=torch.float32) -> s3d.S3D:
    model = s3d.S3D(dtype=dtype)
    model.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in state.items()})
    return model.eval()


def _port_forward(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    x = np.random.RandomState(0).rand(1, 16, 32, 32, 3).astype(np.float32)
    params = _filled_params(js3d.S3D(num_classes=512), jnp.asarray(x))
    ref = {"f32": _jax_forward(params, x, jnp.float32),
           "bf16": _jax_forward(params, x, jnp.bfloat16)}
    return params, x, ref


def test_forward_shapes(setup):
    params, x, _ = setup
    out = _port_forward(_port(jax_s3d_params_to_state_dict(params)), x)
    assert out["video_embedding"].shape == (1, 512)
    assert out["mixed_5c"].shape == (1, 1024)
    assert out["before_mean"].shape == (1, 1024, 2, 1, 1)
    assert np.isfinite(out["video_embedding"]).all()


@pytest.mark.parametrize("name", OUTPUTS)
def test_float32_matches_jax(setup, name):
    params, x, ref = setup
    out = _port_forward(_port(jax_s3d_params_to_state_dict(params)), x)
    assert _rel_err(out[name], ref["f32"][name]) <= TOL
    # before_mean is (B, C, T, H, W) here, (B, T, H, W, C) in JAX
    assert _rel_err(out["before_mean"].transpose(0, 2, 3, 4, 1),
                    ref["f32"]["before_mean"]) <= TOL


@pytest.mark.parametrize("name", OUTPUTS)
def test_bfloat16_matches_jax(setup, name):
    params, x, ref = setup
    model = _port(jax_s3d_params_to_state_dict(params), torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = _port_forward(model, x)
    assert _cosine(out[name], ref["bf16"][name]) >= MIN_COSINE


def test_state_dict_keys_are_the_checkpoint_keys(setup):
    params, _, _ = setup
    keys = set(s3d.S3D().state_dict())
    assert keys == set(jax_s3d_params_to_state_dict(params))
    for key in ("conv1.conv1.weight", "mixed_3b.conv_b1_b.bn2.running_var",
                "mixed_4c.gating_b2.fc.weight", "gating.fc.bias",
                "fc.weight"):
        assert key in keys


def test_checkpoint_loader_ignores_the_text_branch():
    state = s3d.init_s3d_weights(s3d.S3D(), 3).state_dict()
    extra = dict(state)
    extra["text_module.fc1.weight"] = torch.zeros(2, 2)
    extra["conv1.bn1.num_batches_tracked"] = torch.tensor(0)
    model = s3d.load_s3d_checkpoint(s3d.S3D(), extra)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    del extra["fc.weight"]
    with pytest.raises(RuntimeError, match="fc.weight"):
        s3d.load_s3d_checkpoint(s3d.S3D(), extra)


def test_port_weights_through_jax_loader(setup):
    """The port's state_dict, poured into JAX's tree by JAX's own
    `load_torch_s3d_weights`, gives the port's outputs."""
    params, x, _ = setup
    model = s3d.init_s3d_weights(s3d.S3D(), 1).eval()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    loaded = js3d.load_torch_s3d_weights(params, state)
    ref = _jax_forward(loaded, x, jnp.float32)
    out = _port_forward(model, x)
    for name in OUTPUTS:
        assert _rel_err(out[name], ref[name]) <= TOL, name
    back = jax_s3d_params_to_state_dict(loaded)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_space_to_depth_channel_order():
    x = np.random.RandomState(2).rand(2, 4, 6, 8, 3).astype(np.float32)
    ref = np.asarray(js3d.S3D._space_to_depth(jnp.asarray(x)))
    ours = s3d.S3D.space_to_depth_ncdhw(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    np.testing.assert_array_equal(ours.transpose(0, 2, 3, 4, 1), ref)
    # channel ((dt * 2 + dh) * 2 + dw) * C + c
    assert ours[1, ((1 * 2 + 0) * 2 + 1) * 3 + 2, 1, 2, 3] == \
        x[1, 2 * 1 + 1, 2 * 2 + 0, 2 * 3 + 1, 2]


def test_stem_conv_and_crop():
    """The (2, 4, 4) stem with padding (1, 2, 2), then the crop of the
    first step of T, H and W."""
    x = np.random.RandomState(3).rand(1, 8, 12, 12, 24).astype(np.float32)
    jmod = js3d.STConv3D(64, [2, 4, 4], stride=1, padding=(1, 2, 2))
    variables = {"params": _filled_params(jmod, jnp.asarray(x), seed=4)}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))[:, 1:, 1:, 1:]
    mod = s3d.STConv3D(24, 64, (2, 4, 4), stride=1, padding=(1, 2, 2))
    mod.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in
                         jax_s3d_params_to_state_dict(
                             variables["params"]).items()})
    with torch.no_grad():
        ours = mod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    ours = ours[:, :, 1:, 1:, 1:].permute(0, 2, 3, 4, 1).numpy()
    assert ref.shape == (1, 8, 12, 12, 64)
    assert _rel_err(ours, ref) <= TOL


@pytest.mark.parametrize("size,kernel,stride", [
    ((7, 9, 11), (1, 3, 3), (1, 2, 2)),
    ((5, 7, 7), (3, 3, 3), (2, 2, 2)),
    ((3, 5, 5), (2, 2, 2), (2, 2, 2)),
    ((8, 8, 8), (3, 3, 3), (2, 2, 2)),
], ids=["stem-pool-odd", "3-2-odd", "2-2-odd", "3-2-even"])
def test_tf_same_pooling(size, kernel, stride):
    """-inf padding, low / high split and the ceil-mode extension at odd
    sizes; negative inputs show any zero padding."""
    x = -np.random.RandomState(5).rand(2, *size, 4).astype(np.float32)
    ref = np.asarray(js3d.max_pool_3d_tf_padding(jnp.asarray(x), kernel,
                                                 stride))
    ours = s3d.max_pool_3d_tf_padding(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), kernel, stride)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 4, 1).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_scale_in_float32_then_cast(dtype):
    rng = np.random.RandomState(6)
    n = 16
    stats = {"scale": rng.rand(n) + 0.5, "bias": rng.randn(n),
             "mean": rng.randn(n), "var": rng.rand(n) + 0.5}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    x = rng.randn(2, 3, 4, 5, n).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = js3d.BatchNormInference(n, dtype=jdt).apply(
        {"params": stats}, jnp.asarray(x).astype(jdt))
    bn = s3d.BatchNormInference(n)
    bn.load_state_dict({
        "weight": torch.from_numpy(stats["scale"]),
        "bias": torch.from_numpy(stats["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        ours = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(tdt))
    ours = ours.permute(0, 2, 3, 4, 1).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    # XLA may fuse x * inv + shift into one rounding: float32 within a few
    # ulps, bfloat16 within one bf16 step (2^-8 relative) of each value
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---------------- the extractor ----------------

KERNEL, STRIDE, BATCH = 16, 8, 4
COUNTS = {"vidA": 40, "vidB": 20, "vidC": 5}  # vidC < kernel: one window


@pytest.fixture(scope="module")
def frames_root(tmp_path_factory):
    """jpg frames as tests/test_extract_100m.py builds them."""
    from PIL import Image
    root = tmp_path_factory.mktemp("s3d_frames") / "frames"
    rng = np.random.RandomState(0)
    for vid, n in COUNTS.items():
        d = root / vid
        d.mkdir(parents=True)
        for i in range(n):
            arr = rng.randint(0, 255, (32, 32, 3), np.uint8)
            Image.fromarray(arr).save(d / f"frame_{i + 1:010d}.jpg")
    return root


def _expected_windows(n: int) -> int:
    return 1 if n <= KERNEL else len(range(0, n, STRIDE))


def test_video_windows_match_jax_rules():
    for n in (5, 15, 16, 17, 20, 40):
        frames = np.arange(n, dtype=np.float32)[:, None, None, None]
        windows = port_tool.video_windows(frames, KERNEL, STRIDE)
        assert len(windows) == _expected_windows(n), n
        assert all(w.shape[0] == (KERNEL if n >= KERNEL else 16)
                   for w in windows)
        if n < 16:  # padded by repeating the last frame
            np.testing.assert_array_equal(windows[0][n:, 0, 0, 0], n - 1)


@pytest.fixture(scope="module")
def extracted(frames_root, tmp_path_factory):
    """Both extractors on the same frames and the same weights (the port's,
    saved as a .pth that JAX loads through --checkpoint)."""
    import h5py
    import extract_100m_features as jax_tool

    tmp = tmp_path_factory.mktemp("s3d_extract")
    ckpt = tmp / "s3d.pth"
    torch.save(s3d.init_s3d_weights(s3d.S3D(), 7).state_dict(), ckpt)
    common = [str(frames_root), "--kernel", str(KERNEL), "--stride",
              str(STRIDE), "--batch_size", str(BATCH), "--checkpoint",
              str(ckpt)]

    real_init = js3d.S3D.init

    def cheap_init(self, rng, sample):  # shapes only; the .pth fills them
        shapes = jax.eval_shape(lambda r: real_init(self, r, sample), rng)
        return jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(js3d.S3D, "init", cheap_init)
        mp.setattr(sys, "argv", ["extract_100m_features.py",
                                 common[0], str(tmp / "jax.h5")]
                   + common[1:])
        jax_tool.main()
    finally:
        mp.undo()
    with h5py.File(tmp / "jax.h5") as f:
        ref = {k: f[k][:] for k in f}
    runs = {}
    for fmt, out in (("h5", tmp / "port.h5"), ("npy", tmp / "port_npy")):
        argv = [common[0], str(out)] + common[1:] + [
            "--output_format", fmt, "--device", "cpu"]
        runs[fmt] = (argv, port_tool.main(argv), out)
    return ref, runs


@pytest.mark.parametrize("fmt", ["h5", "npy"])
def test_extractor_matches_jax(extracted, fmt):
    import h5py
    ref, runs = extracted
    _, result, out = runs[fmt]
    assert result["output_format"] == fmt
    assert sorted(result["written"]) == sorted(COUNTS)
    if fmt == "h5":
        with h5py.File(out) as f:
            ours = {k: f[k][:] for k in f}
    else:
        ours = {p.stem: np.load(p) for p in out.glob("*.npy")}
    assert set(ours) == set(ref) == set(COUNTS)
    for vid, n in COUNTS.items():
        assert ours[vid].shape == ref[vid].shape == (
            _expected_windows(n), 512), vid
        assert ours[vid].dtype == np.float32
        assert _rel_err(ours[vid], ref[vid]) <= TOL, vid


@pytest.mark.parametrize("fmt", ["h5", "npy"])
def test_extractor_rerun_skips_written_keys(extracted, fmt):
    _, runs = extracted
    argv, _, _ = runs[fmt]
    assert port_tool.main(argv)["written"] == []


def test_extractor_layers_concatenate_in_order(frames_root, tmp_path):
    common = [str(frames_root), "--kernel", str(KERNEL), "--stride",
              str(STRIDE), "--batch_size", str(BATCH), "--checkpoint",
              str(tmp_path / "missing.pth"), "--output_format", "npy",
              "--device", "cpu"]
    port_tool.main(common[:1] + [str(tmp_path / "a")] + common[1:]
                   + ["--layer", "video_embedding,mixed_5c"])
    port_tool.main(common[:1] + [str(tmp_path / "b")] + common[1:]
                   + ["--layer", "mixed_5c"])
    both = np.load(tmp_path / "a" / "vidC.npy")
    alone = np.load(tmp_path / "b" / "vidC.npy")
    assert both.shape == (1, 512 + 1024)
    np.testing.assert_array_equal(both[:, 512:], alone)


def test_extractor_needs_a_gpu_unless_asked_for_the_cpu(frames_root,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_tool.main([str(frames_root), str(tmp_path / "x")])
