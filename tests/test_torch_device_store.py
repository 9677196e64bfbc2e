"""
The PyTorch port's device feature store held against the JAX package on
the CPU: the B5 gather (ops/gather.py), index collation, fixed shapes, the
dense batch rebuilt from the store, on-device sampling with part packing,
the packed forward, a train step on id batches, and the CLI's store path.

Tolerances: exact (array_equal) where the operation is a copy or integer
bookkeeping (gathers, index batches, sampling, packing); atol = rtol = 2e-5
in float32 where the model runs (the frameworks sum in different orders;
observed errors ~1e-6), gradients 2e-5 x max(1, max |g|) per tensor. The
train jitter of the port draws its uniforms from a torch.Generator; the
sampler takes them as an argument, so the test hands it JAX's own draws.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from coot_videotext_tpu.data import device_store as jstore_mod
from coot_videotext_tpu.data.retrieval_dataset import (
    RetrievalDataset as JRetrievalDataset)
from coot_videotext_tpu.ops.pallas_gather import (
    gather_rows_reference, pallas_gather_rows)
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.data import retrieval_dataset
from coot_videotext_tpu_torch.data.device_store import (
    FeatureSource, RetrievalDeviceMeta, RetrievalDeviceStore,
    assemble_batch, device_sample_batch, gather_dense_batch)
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    RetrievalDataset, create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.gather import (
    GatherNoise, gather_rows, gather_rows_plain)
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_loss_and_grads)
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_params_to_state_dict)
from tests.helpers import retrieval_config_dict
from tests.test_torch_train import _flat_torch, _jax_loss_and_grads, _loss_kw

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
BATCH = 8
# six real datapoints (one repeated) and two padded rows
DP_IDX = np.array([3, 0, 5, 7, 1, 3, 0, 0], np.int32)
VALID = np.array([True] * 6 + [False] * 2)


# ---------------- B5 ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_jax(dtype):
    """D = 4096: JAX's XLA reference and the Pallas kernel in interpret
    mode, repeated indices and the last row included; exact."""
    rng = np.random.RandomState(0)
    table = rng.randn(40, 4096).astype(np.float32)
    idx = rng.randint(0, 40, 32).astype(np.int32)
    idx[:4] = 39
    idx[4:8] = idx[8]
    jt = jnp.asarray(table, getattr(jnp, dtype))
    ref = np.asarray(gather_rows_reference(jt, jnp.asarray(idx)), np.float32)
    pallas = np.asarray(pallas_gather_rows(jt, jnp.asarray(idx),
                                           rows_per_block=8, interpret=True),
                        np.float32)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    ti = torch.from_numpy(idx)
    for ours in (gather_rows_plain(tt, ti), gather_rows(tt, ti)):
        assert ours.dtype == tt.dtype and ours.shape == (32, 4096)
        np.testing.assert_array_equal(ours.float().numpy(), ref)
        np.testing.assert_array_equal(ours.float().numpy(), pallas)


def test_gather_rows_refuses_what_the_kernel_does_not_take():
    table = torch.zeros(5, 1536, dtype=torch.bfloat16)
    for bad in ([5], [-1]):  # never clamped, never wrapped
        with pytest.raises(IndexError, match="outside"):
            gather_rows(table, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="16 bytes"):
        gather_rows(torch.zeros(5, 6), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        gather_rows(table, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="forward only"):
        gather_rows(torch.zeros(5, 8, requires_grad=True),
                    torch.zeros(2, dtype=torch.int32))


def test_gather_noise_is_a_truncated_normal():
    """1e6 draws: |tn| <= 2, mean ~0 and the std of a normal truncated at
    +-2 (0.87963) within 1%; the fused noise is table + std * tn of the
    same (seed, site) bits, another site draws other bits."""
    tn = philox.truncnorm((1000, 1000), seed=11,
                          site=philox.SITE_NOISE_VIDEO)
    assert float(tn.abs().max()) <= 2.0
    assert abs(float(tn.mean())) < 0.005
    assert abs(float(tn.std()) / 0.87963 - 1.0) < 0.01
    table = torch.randn(7, 64, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([6, 0, 6, 3], dtype=torch.int32)
    noise = GatherNoise(0.05, 11, philox.SITE_NOISE_CLIP)
    out = gather_rows(table, idx, noise)
    expect = table[idx.long()] + 0.05 * philox.truncnorm(
        (4, 64), 11, philox.SITE_NOISE_CLIP)
    np.testing.assert_array_equal(out.numpy(), expect.numpy())
    other = gather_rows(table, idx, noise._replace(
        site=philox.SITE_NOISE_VIDEO))
    assert not torch.equal(out, other)


# ---------------- the store against JAX ----------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(data root, config dict): 12 train videos of up to 5 clips."""
    root = tmp_path_factory.mktemp("store")
    overrides = generate_retrieval_dataset(
        root, num_videos=12, num_val_videos=4, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0)
    return root, retrieval_config_dict(overrides, batch_size=BATCH)


@pytest.fixture(scope="module")
def stores(synth):
    """Port and JAX datasets, stores (float32) and metadata of the train
    split, and the pack shapes forced under B x N (the dataset-derived
    budget equals B x N at this size, so nothing would be packed)."""
    root, cfg_dict = synth
    tcfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    jcfg = JRetrievalConfig(copy.deepcopy(cfg_dict))
    tds = RetrievalDataset(tcfg.dataset_train, root)
    jds = JRetrievalDataset(jcfg.dataset_train, root)
    tstore = RetrievalDeviceStore(tds, dtype=torch.float32)
    jst = jstore_mod.RetrievalDeviceStore(jds, dtype="float32")
    max_frames = tcfg.dataset_train.max_frames
    tmeta = RetrievalDeviceMeta(tstore, tds.compute_fixed_shapes(),
                                max_frames, batch_size=BATCH)
    jmeta = jstore_mod.RetrievalDeviceMeta(
        jst, jds.compute_fixed_shapes(), max_frames, batch_size=BATCH)
    counts = np.asarray(jmeta.tables["clip_num"])[DP_IDX[VALID]]
    budget = int(counts.sum()) + 2
    packed = dict(tmeta.shapes, pack_clips=budget, pack_sents=budget)
    assert budget < BATCH * packed["n_parts"]
    return dict(tcfg=tcfg, jcfg=jcfg, tds=tds, jds=jds, tstore=tstore,
                jstore=jst, tmeta=tmeta, jmeta=jmeta, packed=packed)


def _np(batch):
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in batch.items()}


def _assert_batches_equal(ours, ref):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, list):
            assert ours[key] == value, key
        else:
            np.testing.assert_array_equal(np.asarray(ours[key]),
                                          np.asarray(value), err_msg=key)


def test_store_tables_and_fixed_shapes_match_jax(stores):
    s = stores
    assert s["tds"].compute_fixed_shapes() == s["jds"].compute_fixed_shapes()
    assert s["tmeta"].shapes == s["jmeta"].shapes
    assert s["tstore"].vid_offset == s["jstore"].vid_offset
    assert s["tstore"].text_offset == s["jstore"].text_offset
    np.testing.assert_array_equal(s["tstore"].vid_store.numpy(),
                                  np.asarray(s["jstore"].vid_store))
    np.testing.assert_array_equal(s["tstore"].text_store.numpy(),
                                  np.asarray(s["jstore"].text_store))
    _assert_batches_equal(_np(s["tmeta"].tables), s["jmeta"].tables)


@pytest.mark.parametrize("fixed", [False, True])
def test_collate_indices_matches_jax(stores, fixed):
    """Host sampling (jittered: a train split) from the same numpy
    stream, then index collation with padded rows."""
    s = stores
    shapes = s["tds"].compute_fixed_shapes() if fixed else None
    s["tds"].rng = np.random.RandomState(4)
    s["jds"].rng = np.random.RandomState(4)
    ours = s["tstore"].collate_indices(
        [s["tds"].get_indices(i) for i in range(6)], batch_size=BATCH,
        fixed_shapes=shapes)
    ref = s["jstore"].collate_indices(
        [s["jds"].get_indices(i) for i in range(6)], batch_size=BATCH,
        fixed_shapes=shapes)
    _assert_batches_equal(ours, ref)


def _index_batch(s):
    s["tds"].rng = np.random.RandomState(5)
    host = s["tstore"].collate_indices(
        [s["tds"].get_indices(i) for i in range(6)], batch_size=BATCH)
    return {k: v for k, v in host.items()
            if k not in retrieval_dataset.HOST_KEYS}


def test_gather_dense_batch_matches_jax(stores):
    s = stores
    arrays = _index_batch(s)
    ours = gather_dense_batch({k: torch.from_numpy(v)
                               for k, v in arrays.items()},
                              s["tstore"].vid_store, s["tstore"].text_store)
    ref = jstore_mod.gather_dense_batch(
        jax.device_put(arrays), s["jstore"].vid_store,
        s["jstore"].text_store)
    _assert_batches_equal(_np(ours), jax.device_get(ref))


def _jax_uniforms(rng, shapes):
    """The uniforms JAX's device_sample_batch draws from `rng` (its key
    splits, :359-371)."""
    rng_v, rng_c = jax.random.split(rng)
    lv, lc, n = shapes["lv"], shapes["lc"], shapes["n_parts"]
    u_vid = jax.vmap(lambda k: jax.random.uniform(k, (lv,)))(
        jax.random.split(rng_v, BATCH))
    ckeys = jax.random.split(rng_c, BATCH * n)
    ckeys = ckeys.reshape((BATCH, n) + ckeys.shape[1:])
    u_clip = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (lc,))))(
        ckeys)
    return (torch.from_numpy(np.array(u_vid)),
            torch.from_numpy(np.array(u_clip)))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("jitter", [False, True], ids=["center", "train"])
def test_device_sample_batch_matches_jax(stores, jitter, packed):
    s = stores
    shapes = s["packed"] if packed else s["tmeta"].shapes
    rng = jax.random.PRNGKey(3) if jitter else None
    ref = jstore_mod.device_sample_batch(
        s["jmeta"].tables, jnp.asarray(DP_IDX), shapes,
        s["jmeta"].max_frames, rng=rng, batch_valid=jnp.asarray(VALID))
    ours = device_sample_batch(
        s["tmeta"].tables, torch.from_numpy(DP_IDX), shapes,
        s["tmeta"].max_frames,
        uniforms=_jax_uniforms(rng, shapes) if jitter else None,
        batch_valid=torch.from_numpy(VALID))
    if packed:
        assert ours["clip_idx"].shape[0] == shapes["pack_clips"]
        assert "sent_owner" in ours
    _assert_batches_equal(_np(ours), jax.device_get(ref))


# ---------------- the model and the step on the store path ----------------

@pytest.fixture(scope="module")
def bridged(stores):
    """(JAX manager, JAX params, port manager with the same weights, the
    dense and the packed batch of DP_IDX, center-sampled)."""
    s = stores
    dp, bv = torch.from_numpy(DP_IDX), torch.from_numpy(VALID)
    batches = []
    for shapes in (s["tmeta"].shapes, s["packed"]):
        idx = device_sample_batch(s["tmeta"].tables, dp, shapes,
                                  s["tmeta"].max_frames, batch_valid=bv)
        batches.append(gather_dense_batch(idx, s["tstore"].vid_store,
                                          s["tstore"].text_store))
    jmgr = JModelManager(s["jcfg"])
    params = jax.tree_util.tree_map(np.asarray,
                                    jmgr.init_params(0, _np(batches[0])))
    tmgr = RetrievalModelManager(s["tcfg"], torch.device("cpu"), seed=1)
    tmgr.load_state({net: {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}
                     for net, sd in jax_params_to_state_dict(params).items()})
    return jmgr, params, tmgr, batches[0], batches[1]


def test_packed_forward_matches_dense_and_jax(bridged):
    jmgr, params, tmgr, dense, packed = bridged
    with torch.inference_mode():
        out_d = tmgr.model(dense)
        out_p = tmgr.model(packed)
    for key in ("vid_emb", "par_emb", "vid_context", "par_context"):
        np.testing.assert_allclose(out_p[key].numpy(), out_d[key].numpy(),
                                   err_msg=key, **TOL)
    for key, valid in (("clip_emb", "clip_valid"), ("sent_emb",
                                                    "sent_valid")):
        sel = dense[valid].numpy()
        np.testing.assert_allclose(out_p[key].numpy()[sel],
                                   out_d[key].numpy()[sel], err_msg=key,
                                   **TOL)
        assert not out_p[key].numpy()[~sel].any()
    jout = jmgr.model_eval.apply({"params": params}, _np(packed),
                                 deterministic=True)
    assert set(out_p) == set(jout)
    for key in jout:
        np.testing.assert_allclose(out_p[key].numpy(), np.asarray(jout[key]),
                                   err_msg=key, **TOL)


def test_store_train_step_matches_jax(stores, bridged):
    """One train step on an id batch (device sampling with train jitter
    from the state's seed state, parts packed, store gathers): its
    contrastive parts equal those of the batch assembled from the same
    seed state outside the step; on that batch the step's loss parts (the
    full-mean cycle consistency: no seed state) and every gradient against
    JAX's value_and_grad; the step's own cycle consistency subsamples."""
    s = stores
    jmgr, params, tmgr, _, _ = bridged
    meta = copy.copy(s["tmeta"])
    meta.shapes = s["packed"]
    source = FeatureSource(s["tstore"], meta)
    ids = {"layout": "ids", "dp_idx": torch.from_numpy(DP_IDX),
           "batch_valid": torch.from_numpy(VALID)}
    gathered = assemble_batch(ids, source,
                              sample_state=philox.seed_state(5))
    assert gathered["clip_feat"].shape[0] == s["packed"]["pack_clips"]
    opt = optim.make_optimizer(s["tcfg"].optimizer,
                               dict(tmgr.model.named_parameters()))
    state = TrainState(tmgr.model, opt, philox.seed_state(5))
    parts, grads = retrieval_loss_and_grads(TrainState(tmgr.model, opt),
                                            gathered, **_loss_kw(s["tcfg"]))
    jparts, jgrads = _jax_loss_and_grads(s["jcfg"], jmgr, params,
                                         _np(gathered))
    for key in jparts:
        np.testing.assert_allclose(float(parts[key]), float(jparts[key]),
                                   err_msg=key, **TOL)
    ref = _flat_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(ref)
    for name, g in grads.items():
        err = np.abs(g.numpy() - ref[name]).max()
        assert err <= 2e-5 * max(1.0, np.abs(ref[name]).max()), (name, err)
    in_step, _ = retrieval_loss_and_grads(state, ids, source=source,
                                          **_loss_kw(s["tcfg"]))
    for key in parts:
        if key not in ("loss_cc", "loss_total"):
            np.testing.assert_allclose(float(in_step[key]),
                                       float(parts[key]), err_msg=key,
                                       **TOL)
    assert np.isfinite(float(in_step["loss_cc"]))
    assert float(in_step["loss_cc"]) != float(parts["loss_cc"])
    with pytest.raises(ValueError, match="seed state"):
        retrieval_loss_and_grads(dataclasses.replace(state, seed=None),
                                 ids, source=source, **_loss_kw(s["tcfg"]))


# ---------------- the loaders and the CLI ----------------

def test_factory_modes_on_the_cpu(synth, monkeypatch):
    """"auto" takes the host path on the CPU (dense batches: no slabs
    without a device link); forced, the store gives index batches, with
    --fixed_shapes id batches; every batch names its layout; a forced
    store that does not fit raises."""
    root, cfg_dict = synth
    cfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    _, _, train, val = create_retrieval_datasets_and_loaders(cfg, root)
    assert train.device_store is None and train.layout == "dense"
    batch = next(iter(val))
    assert batch["layout"] == "dense" and "clip_feat" in batch
    _, _, train, val = create_retrieval_datasets_and_loaders(
        cfg, root, device_preload=True)
    assert train.device_meta is None and train.layout == "indices"
    batch = next(iter(val))
    assert batch["layout"] == "indices" and "clip_idx" in batch
    _, _, train, val = create_retrieval_datasets_and_loaders(
        cfg, root, device_preload=True, fixed_shapes=True)
    assert val.layout == "ids"
    assert set(next(iter(train))) == {"layout", "key", "data_key",
                                      "sentences", "dp_idx", "batch_valid"}
    monkeypatch.setattr(retrieval_dataset, "device_free_bytes",
                        lambda device: 1000.0)
    with pytest.raises(RuntimeError, match="feature store needs"):
        create_retrieval_datasets_and_loaders(cfg, root,
                                              device_preload=True)


def test_slab_batches_rebuild_the_dense_batch(stores):
    """collate_slab + B5 gives collate_fn's floats at every valid position
    and the same masks (host sampling from the same stream)."""
    ds = stores["tds"]
    shapes = ds.compute_fixed_shapes()
    ds.rng = np.random.RandomState(6)
    points = [ds[i] for i in range(6)]
    dense = ds.collate_fn(points, batch_size=BATCH, fixed_shapes=shapes)
    slab = ds.collate_slab(points, batch_size=BATCH, fixed_shapes=shapes)
    assert slab["vid_store"].shape[0] % 4096 == 0
    arrays = {k: torch.from_numpy(v) for k, v in slab.items()
              if k not in retrieval_dataset.HOST_KEYS}
    got = _np(assemble_batch({"layout": "slab", **arrays}))
    for key, value in dense.items():
        if key.endswith("_feat"):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        elif key not in retrieval_dataset.HOST_KEYS:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_layouts_are_checked(stores):
    """A loader refuses a layout without its store or metadata, and the
    step's batch assembly an unknown layout."""
    s = stores
    loader = retrieval_dataset.RetrievalBatchLoader
    with pytest.raises(ValueError, match="not one of"):
        loader(s["tds"], BATCH, shuffle=False, layout="packed")
    with pytest.raises(ValueError, match="metadata"):
        loader(s["tds"], BATCH, shuffle=False, layout="ids",
               device_store=s["tstore"])
    with pytest.raises(ValueError, match="store"):
        loader(s["tds"], BATCH, shuffle=False, layout="dense",
               device_store=s["tstore"])
    with pytest.raises(ValueError, match="unknown batch layout"):
        assemble_batch({"layout": "packed"})


@pytest.fixture(scope="module")
def store_cli(synth, tmp_path_factory):
    """The CLI on the CPU with --preload_device --fixed_shapes: 2 epochs of
    training, then resumed to 3."""
    root, cfg_dict = synth
    path = tmp_path_factory.mktemp("store_cli") / "synth.yaml"
    path.write_text(yaml.safe_dump(cfg_dict), encoding="utf8")
    argv = ["-c", str(path), "--data_path", str(root), "--log_dir",
            str(path.parent / "exp"), "--device", "cpu"]
    store = ["--preload_device", "--fixed_shapes"]
    first = train_retrieval.main(argv + store + ["-o",
                                                 "train.num_epochs=2"])[0]
    resumed = train_retrieval.main(argv + store + ["-o",
                                                   "train.num_epochs=3"])[0]
    return argv, store, first, resumed


def test_store_cli_trains_and_resumes(store_cli):
    _, _, first, resumed = store_cli
    assert len(first["step_losses"]) == 4
    assert np.isfinite(first["step_losses"]).all()
    assert resumed["state"]["current_epoch"] == 3
    assert resumed["step_losses"][:4] == first["step_losses"]
    assert len(resumed["step_losses"]) == 6
    opt = torch.load(resumed["path_base"] / "models" / "optimizer_2.pth",
                     weights_only=True)
    # the run seed (0) advanced once per step; the device step count
    assert opt["step"] == 6 and int(opt["seed"]) == 6
    assert int(opt["optimizer"]["step"]) == 6


def test_store_cli_validates_like_the_host_path(store_cli, capsys):
    """Without frame noise the store path's val retrieval metrics equal
    the host path's on the same checkpoint."""
    argv, store, _, _ = store_cli
    capsys.readouterr()
    ours = train_retrieval.main(argv + store + ["--validate",
                                                "--load_epoch", "2"])[0]
    assert "Feature store on cpu" in capsys.readouterr().out
    host = train_retrieval.main(argv + ["--validate", "--load_epoch",
                                        "2"])[0]
    for key in ("v2p", "p2v", "c2s", "s2c"):
        assert ours[key] == host[key], key
    np.testing.assert_allclose(ours["loss_total"], host["loss_total"],
                               **TOL)


def test_store_cli_resumes_an_optimizer_file_without_sample(store_cli):
    """An optimizer_<ep>.pth of an earlier version (no seed state but the
    CPU and device generators, the step count an int) still loads: the
    seed state is the run seed advanced by the step count, so the resumed
    run repeats the unbroken one."""
    argv, store, first, _ = store_cli
    run = ["-r", "old"]
    train_retrieval.main(argv + store + run + ["-o", "train.num_epochs=1"])
    opt_file = first["path_base"].parent / "synth_old1" / "models" / \
        "optimizer_0.pth"
    opt = torch.load(opt_file, weights_only=True)
    del opt["seed"]
    opt["optimizer"]["step"] = int(opt["optimizer"]["step"])
    opt.update(seeds=torch.Generator().get_state(),
               cc=torch.Generator().get_state())
    torch.save(opt, opt_file)
    resumed = train_retrieval.main(argv + store + run + [
        "-o", "train.num_epochs=2"])[0]
    assert resumed["state"]["current_epoch"] == 2
    assert resumed["step_losses"] == first["step_losses"]
