"""
The PyTorch port's validation CLI end to end on the CPU, against the JAX
eval step on the same weights, plus its import hygiene and device rules.

`python -m coot_videotext_tpu_torch.train_retrieval --validate
--ignore_untrained --save_embeddings --device cpu` runs on a tiny synthetic
dataset; its h5 must have the JAX trainer's schema, its embeddings must
match the JAX eval step's (float32, atol = rtol = 2e-5) and its retrieval
metrics must be equal.
"""

import ast
import copy
import json
import logging
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

from coot_videotext_tpu.tasks.retrieval import eval as jeval
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.tasks.retrieval.steps import make_retrieval_eval_step
from coot_videotext_tpu.utils import torch_convert
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.data import retrieval_dataset
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import EMB_KEYS
from coot_videotext_tpu_torch.tasks.retrieval.validate import (
    validate_retrieval)
from tests.helpers import retrieval_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "coot_videotext_tpu_torch"
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(config dict, yaml path, data root) of a 10-video val split."""
    root = tmp_path_factory.mktemp("torch_cli")
    overrides = generate_retrieval_dataset(
        root / "data", num_videos=4, num_val_videos=10, vid_feat_dim=64,
        text_feat_dim=48, seed=0)
    cfg_dict = retrieval_config_dict(overrides, batch_size=6)
    path = root / "synth.yaml"
    path.write_text(yaml.safe_dump(cfg_dict), encoding="utf8")
    return cfg_dict, path, root


def _argv(path, root, *extra):
    return ["-c", str(path), "--data_path", str(root / "data"),
            "--log_dir", str(root / "experiments"), *extra]


@pytest.fixture(scope="module")
def h5_run(synth):
    _, path, root = synth
    return train_retrieval.main(_argv(
        path, root, "--validate", "--ignore_untrained", "--save_embeddings",
        "--device", "cpu"))[0]


def test_validate_cli_matches_jax(synth, h5_run):
    cfg_dict, path, root = synth
    results = h5_run
    emb_file = results["emb_file"]
    assert emb_file == (root / "experiments" / "retrieval" / "default" /
                        "synth_run1" / "embeddings" / "embeddings_0.h5")

    # the same weights in the JAX model: the CLI seeds its model with the
    # config seed, so an identical manager reproduces them
    tcfg = RetrievalConfig(copy.deepcopy(cfg_dict), is_train=False)
    state = RetrievalModelManager(tcfg, torch.device("cpu"),
                                  seed=0).state_dict()
    jcfg = JRetrievalConfig(copy.deepcopy(cfg_dict), is_train=False)
    jmgr = JModelManager(jcfg)
    _, _, _, loader = create_retrieval_datasets_and_loaders(
        tcfg, root / "data", seed=0)
    batches = list(loader)
    template = {"params": jmgr.init_params(0, batches[0])}
    params = torch_convert.apply_converted(
        template["params"], torch_convert.convert_retrieval_model_state(
            {net: {k: v.numpy() for k, v in sd.items()}
             for net, sd in state.items()}))
    step = make_retrieval_eval_step(
        jmgr.model_eval,
        loss_weights=jcfg.train.contrastive_loss_config.as_dict(),
        margin=jcfg.train.contrastive_loss_config.margin,
        loss_cycle_cons=jcfg.train.loss_cycle_cons)
    collected = {k: [] for k in EMB_KEYS}
    keys = []
    for batch in batches:
        arrays = {k: v for k, v in batch.items()
                  if k not in retrieval_dataset.HOST_KEYS}
        embs, _ = step(params, arrays, None)
        bv = batch["batch_valid"]
        for key in EMB_KEYS:
            sel = bv
            if key in ("clip_emb", "sent_emb"):
                sel = np.asarray(embs[key.replace("emb", "valid")]) & \
                    bv[:, None]
            collected[key].append(np.asarray(embs[key])[sel])
        keys += batch["key"]
    jdata = {k: np.concatenate(v) for k, v in collected.items()}

    with h5py.File(emb_file, "r") as h5:
        assert set(h5.keys()) == {
            "clip_num", "sent_num", "key", *EMB_KEYS,
            *(f"{k}_before_norm" for k in EMB_KEYS)}
        assert [k.decode() for k in h5["key"][()]] == keys
        assert len(h5["clip_num"]) == 10
        assert h5["clip_emb"].shape[0] == int(h5["clip_num"][()].sum())
        for key in EMB_KEYS:
            np.testing.assert_allclose(h5[key][()], jdata[key],
                                       err_msg=key, **TOL)

    quiet = dict(print_fn=lambda s: None)
    for (k1, k2), names in (((("vid_emb", "par_emb")), ("v2p", "p2v")),
                            ((("clip_emb", "sent_emb")), ("c2s", "s2c"))):
        r1, r2, _, _ = jeval.compute_retrieval(jdata, k1, k2, **quiet)
        assert results[names[0]] == r1
        assert results[names[1]] == r2
    assert np.isfinite(results["loss_total"])


def test_npy_features_and_npz_export_match_h5(synth, h5_run, tmp_path):
    """The h5-free route (npy feature files, npz export) of machines
    without h5py gives the h5 route's arrays under the same names."""
    _, path, _ = synth
    generate_retrieval_dataset(
        tmp_path / "data", num_videos=4, num_val_videos=10, vid_feat_dim=64,
        text_feat_dim=48, seed=0, feat_format="npy")
    results = train_retrieval.main(_argv(
        path, tmp_path, "--validate", "--ignore_untrained",
        "--save_embeddings", "--device", "cpu", "--embeddings_format", "npz",
        "-o", ",".join(f"{d}.{m}_feat_source=npy"
                       for d in ("dataset_train", "dataset_val")
                       for m in ("vid", "text"))))[0]
    assert results["emb_file"].suffix == ".npz"
    with np.load(results["emb_file"]) as npz, \
            h5py.File(h5_run["emb_file"], "r") as h5:
        assert set(npz.files) == set(h5.keys())
        assert list(npz["key"]) == [k.decode() for k in h5["key"][()]]
        for name in npz.files:
            if name != "key":
                np.testing.assert_array_equal(npz[name], h5[name][()])


def test_cli_loads_a_reference_layout_checkpoint(synth, h5_run, tmp_path):
    """--load_model takes {net_name: state_dict} as the reference saves it
    (its sincos `embedding.pe` buffers included) and names the export
    after the checkpoint's epoch."""
    cfg_dict, path, root = synth
    mgr = RetrievalModelManager(
        RetrievalConfig(copy.deepcopy(cfg_dict), is_train=False),
        torch.device("cpu"), seed=5)
    state = mgr.state_dict()
    for sd in state.values():
        sd["embedding.pe"] = torch.zeros(1, 1000, 32)
    ckpt = tmp_path / "model_3.pth"
    torch.save(state, ckpt)
    results = train_retrieval.main(_argv(
        path, root, "--validate", "--save_embeddings", "--device", "cpu",
        "--load_model", str(ckpt), "-r", "loaded"))[0]
    assert results["emb_file"].name == "embeddings_3.h5"
    # seed 5's weights, not the seed-0 init of an untrained run
    assert not np.allclose(results["embeddings"]["vid_emb"],
                           h5_run["embeddings"]["vid_emb"])
    _, _, _, loader = create_retrieval_datasets_and_loaders(
        mgr.cfg, root / "data", seed=0)
    direct = validate_retrieval(
        mgr.model, mgr.cfg, loader, torch.device("cpu"),
        compute_dtype=torch.float32, val_clips=True, cc_seed=42,
        logger=logging.getLogger("test"))
    for key, value in direct["embeddings"].items():
        np.testing.assert_array_equal(results["embeddings"][key], value)


def test_cli_refuses_training_and_untrained_models(synth):
    """Training runs on the CPU (tests/test_torch_train.py holds it
    against JAX); the CLI refuses an embedding export outside validation
    and validation of a model no checkpoint was loaded into."""
    _, path, root = synth
    result = train_retrieval.main(_argv(
        path, root, "--device", "cpu", "-r", "train", "-o",
        "train.num_epochs=1"))[0]
    assert result["state"]["current_epoch"] == 1
    assert np.isfinite(result["step_losses"]).all()
    with pytest.raises(ValueError, match="--validate"):
        train_retrieval.main(_argv(path, root, "--device", "cpu",
                                   "--save_embeddings"))
    with pytest.raises(ValueError, match="untrained"):
        train_retrieval.main(_argv(path, root, "--validate", "--device",
                                   "cpu", "-r", "fresh"))


def test_cli_device_defaults_to_cuda(synth):
    """Without --device the CLI runs on the GPU; with no GPU it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert train_retrieval.resolve_device("cuda").type == "cuda"
        return
    _, path, root = synth
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_retrieval.main(_argv(path, root, "--validate",
                                   "--ignore_untrained"))


def test_cli_dataset_test_and_preload(synth, capsys):
    """--test_dataset prints one collated train batch and trains nothing;
    --preload reads the features into RAM first; --preload_device puts
    the features into a store on the device (here the CPU) and batches
    carry row indices, with --fixed_shapes datapoint ids."""
    _, path, root = synth
    assert train_retrieval.main(_argv(path, root, "--device", "cpu",
                                      "--test_dataset", "--preload")) == []
    out = capsys.readouterr().out
    assert "Dataset: 4 datapoints, 1 batches." in out
    assert "clip_feat: (6," in out
    assert train_retrieval.main(_argv(path, root, "--device", "cpu",
                                      "--test_dataset",
                                      "--preload_device")) == []
    out = capsys.readouterr().out
    assert "Feature store on cpu" in out and "clip_idx: (6," in out
    assert "clip_feat" not in out
    assert train_retrieval.main(_argv(path, root, "--device", "cpu",
                                      "--test_dataset", "--preload_device",
                                      "--fixed_shapes")) == []
    out = capsys.readouterr().out
    assert "sampled on the device" in out and "dp_idx: (6,)" in out
    assert "layout: ids" in out


def test_preload_device_true_raises(synth, monkeypatch):
    """preload_device: true takes the store; a store that does not fit
    the device's free memory raises instead of falling back."""
    cfg_dict, _, root = synth
    cfg_dict = copy.deepcopy(cfg_dict)
    cfg_dict["dataset_train"]["preload_device"] = True
    cfg = RetrievalConfig(cfg_dict, is_train=False)
    _, _, _, loader = create_retrieval_datasets_and_loaders(cfg, root / "data")
    assert loader.device_store is not None
    batch = next(iter(loader))
    assert batch["layout"] == "indices"
    assert "vid_idx" in batch and "vid_feat" not in batch
    monkeypatch.setattr(retrieval_dataset, "device_free_bytes",
                        lambda device: 1.0)
    with pytest.raises(RuntimeError, match="feature store needs"):
        create_retrieval_datasets_and_loaders(cfg, root / "data")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn_cli(cli, argvs, tmp_path, keys):
    """Two ranks of `cli` started as torchrun starts them, one main() per
    argv; their results."""
    import multiprocessing
    from tests import torch_parallel_worker as worker
    ctx = multiprocessing.get_context("spawn")
    ports = [_free_port() for _ in argvs]
    procs = [ctx.Process(target=worker.cli_rank, args=(
        r, 2, ports, argvs, str(tmp_path), cli, keys)) for r in range(2)]
    for p in procs:
        p.start()
    return procs


def _join(procs, tmp_path):
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():  # hung: end it before failing
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(tmp_path / f"cli{r}.pt", weights_only=False)
            for r in range(2)]


def test_cli_trains_under_two_gloo_ranks_and_resumes(tmp_path):
    """synthetic_smoke.yaml trained by train_retrieval under two ranks on
    the CPU, started as torchrun starts them (gloo through MASTER_PORT),
    one epoch and then resumed to two: both ranks see the losses of one
    process run the same way (1e-5 relative; a resumed host path samples
    its frames anew from the seed, so an unbroken run differs), rank 0
    writes the reference `.pth` layout (one file per net key, no `module.`
    prefix), and both ranks load epoch 0 to resume."""
    smoke = ROOT / "config" / "retrieval" / "default" / "synthetic_smoke.yaml"
    generate_retrieval_dataset(tmp_path / "data", num_videos=16,
                               num_val_videos=8, seed=0)

    def argv(log_dir, epochs):
        return ["-c", str(smoke), "--data_path", str(tmp_path / "data"),
                "--log_dir", str(tmp_path / log_dir), "--device", "cpu",
                "-o", f"train.num_epochs={epochs}"]

    procs = _spawn_cli("train_retrieval", [argv("dp", 1), argv("dp", 2)],
                       tmp_path, ("path_base", "state", "step_losses",
                                  "rank", "world"))
    train_retrieval.main(argv("one", 1))
    alone = train_retrieval.main(argv("one", 2))[0]
    ranks = _join(procs, tmp_path)
    ref = alone["step_losses"]
    assert len(ref) == 4
    for r, (first, resumed) in enumerate(ranks):
        assert (first["rank"], first["world"]) == (r, 2)
        assert resumed["state"]["current_epoch"] == 2
        np.testing.assert_allclose(first["step_losses"], ref[:2], rtol=1e-5)
        np.testing.assert_allclose(resumed["step_losses"], ref, rtol=1e-5)
    assert ranks[0][1]["step_losses"] == ranks[1][1]["step_losses"]
    models = ranks[0][1]["path_base"] / "models"
    for ep in (0, 1):
        ours = torch.load(models / f"model_{ep}.pth", weights_only=True)
        one = torch.load(alone["path_base"] / "models" / f"model_{ep}.pth",
                         weights_only=True)
        assert ours.keys() == one.keys()
        for net in ours:
            assert ours[net].keys() == one[net].keys()
            assert not any(k.startswith("module.") for k in ours[net])


def test_caption_and_mlp_clis_under_two_gloo_ranks(tmp_path):
    """train_caption (synthetic_smoke.yaml at dropout 0, one epoch with
    its validation: rank 0 decodes and scores the whole split) and
    run_mlp_mnist (one epoch) under two ranks on the CPU: every epoch
    meter but the timings equal one process's within 1e-4 relative."""
    from coot_videotext_tpu_torch import run_mlp_mnist, train_caption
    from coot_videotext_tpu_torch.data.synthetic import (
        generate_caption_dataset)
    info = generate_caption_dataset(tmp_path / "data", num_videos=16,
                                    num_val_videos=8, seed=1)
    smoke = ROOT / "config" / "caption" / "default" / "synthetic_smoke.yaml"

    def caption_argv(log_dir):
        return ["-c", str(smoke), "--device", "cpu", "--log_dir",
                str(tmp_path / log_dir), "--annotations_dir",
                info["annotations_dir"], "--coot_feat_dir",
                info["coot_feat_dir"], "--cache_dir", str(tmp_path),
                "-o", "train.num_epochs=1,hidden_dropout_prob=0,"
                "attention_probs_dropout_prob=0,memory_dropout_prob=0"]

    def mlp_argv(log_dir):
        return ["-g", "default", "-e", "mnist", "--device", "cpu",
                "--config_dir", str(ROOT / "config"), "--log_dir",
                str(tmp_path / log_dir), "-o", "train.num_epochs=1"]

    (tmp_path / "cap").mkdir()
    (tmp_path / "mlp").mkdir()
    caption = _spawn_cli("train_caption", [caption_argv("dp_cap")],
                         tmp_path / "cap", ("metrics_file", "total_step"))
    mlp = _spawn_cli("run_mlp_mnist", [mlp_argv("dp_mlp")],
                     tmp_path / "mlp", ("val_loss", "val_accuracy"))
    cap_one = train_caption.main(caption_argv("one_cap"))[0]
    mlp_one = run_mlp_mnist.main(mlp_argv("one_mlp"))[0]
    cap_ranks = _join(caption, tmp_path / "cap")
    mlp_ranks = _join(mlp, tmp_path / "mlp")

    def meters(path):
        data = json.loads(Path(path).read_text())
        return {k: [v for _, v in vals] for k, vals in data.items()
                if "time" not in k and "profile" not in k}

    ref = meters(cap_one["metrics_file"])
    assert "cap/b4" in ref  # the decode's scores
    for (rank,) in cap_ranks:
        assert rank["total_step"] == cap_one["total_step"]
        got = meters(rank["metrics_file"])
        assert got.keys() == ref.keys()
        for key, values in ref.items():
            np.testing.assert_allclose(got[key], values, rtol=1e-4,
                                       err_msg=key)
    for (rank,) in mlp_ranks:
        for key in ("val_loss", "val_accuracy"):
            np.testing.assert_allclose(rank[key], mlp_one[key], rtol=1e-4,
                                       err_msg=key)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "nltk",
                           "coot_videotext_tpu"), f"{path}: imports {name}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys; import coot_videotext_tpu_torch.train_retrieval, "
            "coot_videotext_tpu_torch.train_caption, "
            "coot_videotext_tpu_torch.utils.param_bridge; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'nltk', 'coot_videotext_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("jar", ["none", "fake_jar"])
def test_meteor_test_prints_the_root_script_s_lines(tmp_path, jar):
    """`python -m coot_videotext_tpu_torch.meteor_test` prints what the
    repo's meteor_test.py prints on this machine: without a jar, and with
    $METEOR_JAR naming a file (the scorer then starts only where java
    runs it)."""
    import os
    env = {k: v for k, v in os.environ.items() if k != "METEOR_JAR"}
    if jar == "fake_jar":
        (tmp_path / "meteor-1.5.jar").write_bytes(b"")
        env["METEOR_JAR"] = str(tmp_path / "meteor-1.5.jar")
    outs = [subprocess.run([sys.executable] + cmd, cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300,
                           check=True).stdout
            for cmd in (["meteor_test.py"],
                        ["-m", "coot_videotext_tpu_torch.meteor_test"])]
    assert outs[0].startswith("METEOR jar: ")
    assert outs[1] == outs[0]
