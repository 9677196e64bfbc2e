"""
The port's prefetch pipeline (coot_videotext_tpu_torch/data/pipeline.py)
against the sequential copy it replaces (`to_device`) and against the JAX
package's `PrefetchIterator` (coot_videotext_tpu/data/pipeline.py), on
the CPU: equal batches for every retrieval layout (host frame noise on),
equal arrays to JAX's iterator, a loader's exception raised in the
consumer, the producer gone within a second of an early close, and the
CLI's per-step losses equal to those of the sequential copy (run in the
test, and as recorded from the tree before the pipeline, torch on one
thread).
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from coot_videotext_tpu.data.pipeline import PrefetchIterator
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.data import pipeline
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    HOST_KEYS, create_retrieval_datasets_and_loaders, to_device)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from tests.helpers import retrieval_config_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "config" / "retrieval" / "default" / "synthetic_smoke.yaml"
CPU = torch.device("cpu")
# the time limit of each thread test, seconds
LIMIT = 10.0

# synthetic_smoke.yaml, 16 train / 8 val generated videos (seed 0), 2
# epochs, frame noise 0.01: the losses of the CLI calls of
# test_cli_losses_equal_the_sequential_copy run on the tree before
# data/pipeline.py (git 99e4c69, whose trainers copied each batch with
# `to_device`), torch on one thread; the slab layout (pack_transfer) gives
# the same values
GOLDEN_STEP_LOSSES = [1.6066861152648926, 1.6479120254516602,
                      1.587250828742981, 1.6881210803985596]
GOLDEN_VAL_LOSSES = [1.6903269290924072, 1.6903201341629028]


def within(seconds: float, fn):
    """fn() in a thread that must end within `seconds`."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"did not end within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def producers_alive() -> int:
    return sum(t.name == pipeline.THREAD_NAME and t.is_alive()
               for t in threading.enumerate())


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline") / "data"
    overrides = generate_retrieval_dataset(
        root, num_videos=20, num_val_videos=10, vid_feat_dim=64,
        text_feat_dim=48, seed=0)
    return root, overrides


LAYOUTS = {
    "dense": ({}, dict(device_preload=False)),
    "slab": ({"pack_transfer": True}, dict(device_preload=False)),
    "indices": ({}, dict(device_preload=True, fixed_shapes=False)),
    "ids": ({}, dict(device_preload=True, fixed_shapes=True)),
}


def _loaders(data_root, layout):
    root, overrides = data_root
    dataset, kw = LAYOUTS[layout]
    cfg = RetrievalConfig(retrieval_config_dict(
        {**overrides, "frames_noise": 0.05, **dataset}, batch_size=6))
    _, _, train, val = create_retrieval_datasets_and_loaders(
        cfg, root, seed=3, device=CPU, **kw)
    assert train.layout == val.layout == layout
    return train, val


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefetched_batches_equal_the_sequential_copy(data_root, layout):
    """Two loaders from one seed: one through `prefetch`, one through
    `to_device`, two epochs of train batches (host frame noise drawn in
    the producer thread) and the val batches."""
    ours, theirs = _loaders(data_root, layout), _loaders(data_root, layout)
    for epoch in (0, 1):
        ours[0].set_epoch(epoch)
        theirs[0].set_epoch(epoch)
        for which in (0, 1):
            got = [{**host, **tensors} for tensors, host in
                   pipeline.prefetch(ours[which], CPU)]
            want = [to_device(b, CPU) for b in theirs[which]]
            assert len(got) == len(want) == len(theirs[which])
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for key in b:
                    if key in HOST_KEYS:
                        assert a[key] == b[key], key
                    else:
                        assert a[key].dtype == b[key].dtype, key
                        assert torch.equal(a[key], b[key]), key


def test_split_keeps_strings_on_the_host(data_root):
    train, _ = _loaders(data_root, "dense")
    batch = next(iter(train))
    arrays, host = pipeline.split_batch(batch)
    assert set(host) == {"key", "data_key", "sentences", "layout"}
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    assert set(arrays) | set(host) == set(batch)


def _numpy_batches(n=5, seed=0):
    rng = np.random.RandomState(seed)
    return [{"vid_feat": rng.randn(3, 4, 8).astype(np.float32),
             "vid_len": rng.randint(1, 5, 3).astype(np.int32),
             "batch_valid": rng.rand(3) > 0.3,
             "key": [f"v{i}_{j}" for j in range(3)]} for i in range(n)]


def test_matches_the_jax_iterator():
    import jax
    ref = [(jax.device_get(d), h)
           for d, h in PrefetchIterator(_numpy_batches())]
    ours = list(pipeline.prefetch(_numpy_batches(), CPU))
    assert len(ours) == len(ref) == 5
    for (tensors, host), (jdev, jhost) in zip(ours, ref):
        assert host["key"] == jhost["key"]
        assert set(tensors) == set(jdev)
        for k, v in tensors.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jdev[k]))
            assert v.numpy().dtype == np.asarray(jdev[k]).dtype


def test_loader_exception_is_raised_in_the_consumer():
    def loader():
        yield from _numpy_batches(2)
        raise ValueError("broken loader")

    def consume():
        seen = []
        with pytest.raises(ValueError, match="broken loader"):
            for tensors, _ in pipeline.prefetch(loader(), CPU):
                seen.append(tensors)
        return len(seen)

    assert within(LIMIT, consume) == 2
    assert within(LIMIT, producers_alive) == 0


def _endless():
    while True:
        yield from _numpy_batches(4)


def _wait_for_no_producer(seconds: float) -> bool:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if producers_alive() == 0:
            return True
        time.sleep(0.01)
    return producers_alive() == 0


def test_close_after_one_batch_stops_the_producer():
    def run():
        batches = pipeline.prefetch(_endless(), CPU)
        next(batches)
        assert producers_alive() == 1
        time.sleep(0.2)  # the producer fills the queue and waits on put
        batches.close()
        return _wait_for_no_producer(1.0)

    assert within(LIMIT, run)


def test_break_out_of_the_loop_stops_the_producer():
    def run():
        for _ in pipeline.prefetch(_endless(), CPU):
            time.sleep(0.2)
            break
        return _wait_for_no_producer(1.0)

    assert within(LIMIT, run)


def sequential(loader, device, split=pipeline.split_batch):
    """The copy the pipeline replaced: each batch through `to_device` in
    the consumer's own thread."""
    for item in loader:
        yield split(to_device(item, device))


def test_cli_losses_equal_the_sequential_copy(tmp_path, monkeypatch):
    """synthetic_smoke.yaml through the CLI, dense and slab batches: the
    per-step and val losses bit-equal to those of the same CLI run with
    the trainer and validation copying each batch through `to_device`,
    and those of the tree before the pipeline (GOLDEN_*)."""
    from coot_videotext_tpu_torch.tasks.retrieval import trainer, validate
    generate_retrieval_dataset(tmp_path / "data", num_videos=16,
                               num_val_videos=8, seed=0)
    slab_yaml = tmp_path / "slab.yaml"
    slab_yaml.write_text(SMOKE.read_text().replace(
        "    drop_last: false\n",
        "    drop_last: false\n    pack_transfer: true\n", 1))

    def losses(layout, config, log_dir):
        result = train_retrieval.main([
            "-c", str(config), "--data_path", str(tmp_path / "data"),
            "--log_dir", str(log_dir), "--device", "cpu", "-o",
            "train.num_epochs=2,dataset_train.frames_noise=0.01"])[0]
        assert result["layout"] == layout
        metrics = (result["path_base"] / "metrics" /
                   "metrics_epoch_1.json")
        val = [v for _, v in json.loads(metrics.read_text())[
            "val_base/loss"]]
        return result["step_losses"], val

    for layout, config in (("dense", SMOKE), ("slab", slab_yaml)):
        steps, val = losses(layout, config, tmp_path / layout)
        with monkeypatch.context() as m:
            m.setattr(trainer, "prefetch", sequential)
            m.setattr(validate, "prefetch", sequential)
            want_steps, want_val = losses(layout, config,
                                          tmp_path / f"{layout}_sequential")
        assert len(steps) == len(GOLDEN_STEP_LOSSES)
        np.testing.assert_array_equal(steps, want_steps)
        np.testing.assert_array_equal(val, want_val)
        np.testing.assert_allclose(steps, GOLDEN_STEP_LOSSES, rtol=1e-6)
        np.testing.assert_allclose(val, GOLDEN_VAL_LOSSES, rtol=1e-6)
    assert producers_alive() == 0
