"""
The port's group step (tasks/retrieval/steps.py `retrieval_train_group`,
the trainer's group dispatch) and the device-side state it needs, held on
the CPU, where the group runs the same step body eagerly step by step:

- device seeds (ops/philox.py): each plain version given a `Seed` (a seed
  state tensor and the call's position) equals its by-value form given
  `philox.derive_seed` of the same pair, bit for bit; the uniforms of the
  jitter and of the cycle-consistency subsampling;
- the optimizers with their device step count and learning rate against
  JAX's make_radam / make_adam over steps 1-7 (across RAdam's N_sma >= 5
  switch), rtol 1e-6 / atol 1e-7 as the tenth-update test;
- `lr_varies_per_step` against the JAX scheduler's;
- a group of K = 3 plus a tail of 1 equals four per-step calls from the
  same state bit for bit (dropout and noise on): parameters, moments, step
  count, seed state and metrics;
- the group against JAX's `make_retrieval_train_scan` on bridged weights,
  where no random draw reaches the result (dropout 0, noise 0, cycle
  consistency 0, every clip no longer than its slots): parameters and
  moments after a group of 4 and a tail of 3 (the JAX side pads it with an
  identity step) within 1e-4 x max(1, max |JAX|) per tensor, the tolerance
  of test_train_step_radam_update_matches_jax;
- the trainer's group dispatch and its per-step dispatch during a per-step
  warmup (the port's counterparts of test_trainer_scan_fused_dispatch and
  test_trainer_scan_degrades_during_step_warmup), and a CLI run resumed
  across a group boundary that repeats the unbroken one.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coot_videotext_tpu.config.base import SchedulerConfig as JSchedCfg
from coot_videotext_tpu.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders as j_loaders)
from coot_videotext_tpu.tasks.retrieval.config import (
    RetrievalConfig as JRetrievalConfig)
from coot_videotext_tpu.tasks.retrieval.model_manager import (
    RetrievalModelManager as JModelManager)
from coot_videotext_tpu.tasks.retrieval.steps import (
    TrainState as JTrainState, make_retrieval_train_scan)
from coot_videotext_tpu.train import optim as joptim
from coot_videotext_tpu.train import schedule as jschedule
from coot_videotext_tpu_torch import train_retrieval
from coot_videotext_tpu_torch.config.base import SchedulerConfig
from coot_videotext_tpu_torch.data.device_store import (
    FeatureSource, draw_uniforms)
from coot_videotext_tpu_torch.data.retrieval_dataset import (
    create_retrieval_datasets_and_loaders)
from coot_videotext_tpu_torch.data.synthetic import (
    generate_retrieval_dataset)
from coot_videotext_tpu_torch.ops import philox
from coot_videotext_tpu_torch.ops.attention import masked_attention_plain
from coot_videotext_tpu_torch.ops.dropout import dropout_plain
from coot_videotext_tpu_torch.ops.gather import (
    GatherNoise, gather_rows_plain)
from coot_videotext_tpu_torch.ops.genpool import genpool_plain
from coot_videotext_tpu_torch.tasks.retrieval.config import RetrievalConfig
from coot_videotext_tpu_torch.tasks.retrieval.model_manager import (
    RetrievalModelManager)
from coot_videotext_tpu_torch.tasks.retrieval.steps import (
    TrainState, retrieval_train_group, retrieval_train_step)
from coot_videotext_tpu_torch.tasks.retrieval.trainer import (
    RetrievalTrainer)
from coot_videotext_tpu_torch.train import losses as tlosses
from coot_videotext_tpu_torch.train import optim
from coot_videotext_tpu_torch.train.schedule import make_lr_scheduler
from coot_videotext_tpu_torch.utils.metrics import DefaultMetricsConst as M
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_params_to_state_dict)
from tests.helpers import retrieval_config_dict
from tests.test_torch_train import _close_grad, _flat_torch

torch.set_num_threads(1)
CPU = torch.device("cpu")


# ---------------- device seeds ----------------

# (state, call): a small state, one past 2^63 (a negative int64), a large
# call index
SEEDS = [(7, 0), (2 ** 63 + 12345, 3), (2 ** 40 + 1, 70000)]


@pytest.mark.parametrize("value,call", SEEDS)
def test_plain_versions_take_the_device_seed(value, call):
    """Every plain version given a `Seed` equals its by-value form: the
    seed derived on the host from the same (state, call)."""
    seed = philox.Seed(philox.seed_state(value), call)
    host = philox.derive_seed(value, call)
    assert 0 <= host < 2 ** 64
    assert torch.equal(philox.dropout_bits(seed, 3, 101),
                       philox.dropout_bits(host, 3, 101))
    assert torch.equal(philox.keep_factor((7, 9), seed, 2, 0.3),
                       philox.keep_factor((7, 9), host, 2, 0.3))
    assert torch.equal(philox.truncnorm((5, 8), seed, 6),
                       philox.truncnorm((5, 8), host, 6))
    rng = np.random.RandomState(value % 1000)
    x = torch.from_numpy(rng.randn(13, 11).astype(np.float32))
    assert torch.equal(dropout_plain(x, seed, 0.25),
                       dropout_plain(x, host, 0.25))
    table = torch.from_numpy(rng.randn(20, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, 30).astype(np.int32))
    assert torch.equal(
        gather_rows_plain(table, idx, GatherNoise(0.1, seed, 5)),
        gather_rows_plain(table, idx, GatherNoise(0.1, host, 5)))
    f = torch.from_numpy(rng.randn(3, 6, 32).astype(np.float32))
    mask = torch.ones(3, 6, dtype=torch.bool)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)
              for s in ((2, 32, 32), (2, 32), (2, 32, 16), (2, 16))]
    assert torch.equal(genpool_plain(f, mask, *params, "gelu", 0.2, seed),
                       genpool_plain(f, mask, *params, "gelu", 0.2, host))
    q = torch.from_numpy(rng.randn(4, 5, 8).astype(np.float32))
    valid = torch.ones(2, 5, dtype=torch.bool)
    assert torch.equal(
        masked_attention_plain(q, q, q, valid, 2, 0.3, 0.2, seed),
        masked_attention_plain(q, q, q, valid, 2, 0.3, 0.2, host))


def test_derived_seeds_differ_by_state_and_call():
    """derive_seed is Philox keyed on the state: distinct for neighbouring
    states (one step apart) and calls, and the state's 64 bits all count."""
    seeds = {philox.derive_seed(s, c) for s in (0, 1, 2, 2 ** 32, 2 ** 63)
             for c in (0, 1, 2)}
    assert len(seeds) == 15
    state = philox.seed_state(2 ** 64 - 1)
    assert state.dtype == torch.int64 and int(state) == -1


def test_uniforms_are_uniform_and_keyed_on_the_state():
    """The jitter's uniforms: on [0, 1), mean 1/2 and variance 1/12 within
    5 sigma, another draw for the next state, split into the video and
    clip shapes in order."""
    n = 200_000
    u = philox.uniform((n,), philox.seed_state(9), philox.SITE_JITTER)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12 / n) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 0.002
    nxt = philox.uniform((n,), philox.seed_state(10), philox.SITE_JITTER)
    assert not torch.equal(u, nxt)
    shapes = {"lv": 5, "n_parts": 3, "lc": 4}
    vid, clip = draw_uniforms(philox.seed_state(9), 2, shapes)
    assert vid.shape == (2, 5) and clip.shape == (2, 3, 4)
    assert torch.equal(torch.cat([vid.reshape(-1), clip.reshape(-1)]),
                       u[:34])


def test_cc_subsample_is_uniform_over_valid_positions():
    """The cycle-consistency draw takes one valid position per row, each
    with probability 1 / (valid positions), and skips padded ones."""
    mask = torch.tensor([[True, False, True, True, False],
                         [False, False, False, False, True]])
    l_seq = torch.tensor([[1.0, 100.0, 2.0, 3.0, 100.0],
                          [100.0, 100.0, 100.0, 100.0, 7.0]])
    lens = mask.sum(dim=1)
    counts = {1.0: 0, 2.0: 0, 3.0: 0}
    for s in range(3000):
        u = philox.uniform((2,), philox.seed_state(s), philox.SITE_CC)
        total = tlosses._subsampled_total(l_seq, mask, lens, 1, u)
        picked_row0 = float(total) * 2 - 7.0
        counts[round(picked_row0)] += 1
    for value, count in counts.items():
        assert abs(count - 1000) < 5 * (3000 * (1 / 3) * (2 / 3)) ** 0.5, \
            (value, count)


# ---------------- optimizers and scheduler ----------------

def _tree(seed, shapes=(("dense", "kernel", (6, 4)), ("dense", "bias", (4,)),
                        ("norm", "gain", (4,)))):
    rng = np.random.RandomState(seed)
    out = {}
    for a, b, shape in shapes:
        out.setdefault(a, {})[b] = rng.randn(*shape).astype(np.float32)
    return out


def _flat(tree):
    return {f"{a}.{b}": torch.from_numpy(v.copy())
            for a, sub in tree.items() for b, v in sub.items()}


@pytest.mark.parametrize("name", ["radam", "radam_sgd", "adam"])
def test_optimizer_steps_1_to_7_match_jax(name):
    """Seven updates from a fresh state with new gradients each step and
    weight decay on (bias exempt): RAdam only moves its moments until
    N_sma >= 5 (step 6 at beta2 0.98), or takes SGD steps there
    (degenerated_to_sgd); Adam from step 1. The step count and the
    learning rate live in device tensors."""
    beta1, beta2, eps, wd, lr = 0.56, 0.98, 1.5e-9, 0.01, 3.6e-4
    if name == "adam":
        jopt = joptim.make_adam(beta1, beta2, eps, wd)
        topt = optim.Adam(_flat(_tree(0)), beta1, beta2, eps, wd)
    else:
        sgd = name == "radam_sgd"
        jopt = joptim.make_radam(beta1, beta2, eps, wd, sgd)
        topt = optim.RAdam(_flat(_tree(0)), beta1, beta2, eps, wd, sgd)
    jparams = _tree(0)
    jstate = jopt.init(jparams)
    start = {k: v.clone() for k, v in topt.params.items()}
    for step in range(1, 8):
        grads = _tree(100 + step)
        jparams, jstate = jopt.update(grads, jstate, jparams,
                                      jnp.float32(lr))
        topt.step(_flat(grads), lr)
        assert int(topt.step_count) == step
        assert float(topt.lr) == np.float32(lr)
        ref = _flat(jax.tree_util.tree_map(np.asarray, jparams))
        for key, value in topt.params.items():
            np.testing.assert_allclose(value.numpy(), ref[key].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key} step {step}")
        for tree, ours in ((jstate.mu, topt.mu), (jstate.nu, topt.nu)):
            ref = _flat(jax.tree_util.tree_map(np.asarray, tree))
            for key, value in ours.items():
                np.testing.assert_allclose(value.numpy(), ref[key].numpy(),
                                           rtol=1e-6, atol=1e-7)
        moved = max(float((topt.params[k] - start[k]).abs().max())
                    for k in start)
        assert (moved > 0) == (name != "radam" or step >= 6), (name, step)


def test_optimizer_state_round_trip_keeps_the_tensors():
    """load_state_dict copies in place (a captured step keeps reading the
    same tensors) and takes an int step (files of earlier versions)."""
    opt = optim.RAdam(_flat(_tree(0)), 0.9, 0.98, 1e-8, 0.0)
    step_count, mu = opt.step_count, opt.mu["dense.kernel"]
    state = {"step": 4, "mu": _flat(_tree(1)), "nu": _flat(_tree(2))}
    opt.load_state_dict(state)
    assert opt.step_count is step_count and int(step_count) == 4
    assert opt.mu["dense.kernel"] is mu
    assert torch.equal(mu, state["mu"]["dense.kernel"])
    saved = opt.state_dict()
    assert saved["step"].dtype == torch.int32 and int(saved["step"]) == 4


@pytest.mark.parametrize("warmup_type", ["none", "epoch", "step"])
def test_lr_varies_per_step_matches_jax(warmup_type):
    """Over 6 epochs of 3 steps with 2 warmup epochs: the gate of the
    group dispatch agrees with the JAX scheduler's at every step."""
    cfg = {"name": "reduce_opw", "warmup_type": warmup_type,
           "warmup_epochs": 2, "rop_factor": 0.1, "rop_patience": 1,
           "rop_cooldown": 1, "rop_min_lr_factor": 0.001}
    ours = make_lr_scheduler(SchedulerConfig(dict(cfg)), 1e-3, 6, 3)
    ref = jschedule.make_lr_scheduler(JSchedCfg(dict(cfg)), 1e-3, 6, 3)
    seen = []
    for _ in range(6):
        for _ in range(3):
            assert ours.lr_varies_per_step() == ref.lr_varies_per_step()
            seen.append(ours.lr_varies_per_step())
            ours.step()
            ref.step()
        ours.step_epoch(True, False)
        ref.step_epoch(True, False)
    assert any(seen) == (warmup_type == "step")
    assert not seen[-1]


# ---------------- the group step ----------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(root, config dict): 24 train videos of up to 5 clips, batch 8 (3
    steps an epoch), h5 features."""
    root = tmp_path_factory.mktemp("group")
    overrides = generate_retrieval_dataset(
        root, num_videos=24, num_val_videos=8, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=0)
    return root, retrieval_config_dict(overrides, batch_size=8)


def _with_dropout_and_noise(cfg_dict):
    cfg_dict = copy.deepcopy(cfg_dict)
    cfg_dict["dataset_train"].update(frames_noise=0.05, words_noise=0.05)
    for net in ("net_video_local", "net_text_local", "net_video_global",
                "net_text_global"):
        cfg_dict[net]["selfatn_config"]["dropout"] = 0.1
        if cfg_dict[net]["pooler_config"]["name"] == "atn":
            cfg_dict[net]["pooler_config"]["dropout"] = 0.1
    return cfg_dict


def _loss_kw(cfg):
    w = cfg.train.contrastive_loss_config
    return dict(loss_weights=w.as_dict(), margin=w.margin,
                loss_cycle_cons=cfg.train.loss_cycle_cons)


def test_group_equals_per_step_calls(synth):
    """Four steps on id batches with dropout, noise, the jitter, the cycle
    consistency subsampling and clipping on: a group of K = 3 plus a tail
    of 1 (the second call's rows 1-2 are not run) against four per-step
    calls from the same state, bit for bit."""
    root, cfg_dict = synth
    cfg = RetrievalConfig(_with_dropout_and_noise(cfg_dict))
    _, _, loader, _ = create_retrieval_datasets_and_loaders(
        cfg, root, seed=0, fixed_shapes=True, device_preload=True)
    assert loader.layout == "ids"
    source = FeatureSource.of(loader, 0.05, 0.05)
    batches = list(loader) + list(loader)[:1]
    states = []
    for _ in range(2):
        mgr = RetrievalModelManager(cfg, CPU, seed=0)
        states.append(TrainState(mgr.model, optim.make_optimizer(
            cfg.optimizer, dict(mgr.model.named_parameters())),
            philox.seed_state(0)))
    kw = dict(lr=3e-3, clip_gradient=1.0, source=source, **_loss_kw(cfg))
    eager = [retrieval_train_step(
        states[0], {"layout": "ids",
                    "dp_idx": torch.from_numpy(b["dp_idx"]),
                    "batch_valid": torch.from_numpy(b["batch_valid"])},
        **kw) for b in batches]
    ids = np.stack([b["dp_idx"] for b in batches[:3]])
    valid = np.stack([b["batch_valid"] for b in batches[:3]])
    first = retrieval_train_group(states[1], ids, valid, 3, **kw)
    tail_ids, tail_valid = ids.copy(), valid.copy()
    tail_ids[0], tail_valid[0] = batches[3]["dp_idx"], \
        batches[3]["batch_valid"]
    tail = retrieval_train_group(states[1], tail_ids, tail_valid, 1, **kw)
    assert set(first) == set(eager[0]) and "grad_norm" in first
    for name in first:
        grouped = torch.cat([first[name], tail[name]])
        assert grouped.shape == (4,)
        assert torch.equal(grouped, torch.stack([e[name] for e in eager]))
    assert states[0].step == states[1].step == 4
    assert int(states[0].seed) == int(states[1].seed) == 4
    a, b = states[0].optimizer, states[1].optimizer
    assert torch.equal(a.step_count, b.step_count)
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
        assert torch.equal(a.mu[name], b.mu[name]), name
        assert torch.equal(a.nu[name], b.nu[name]), name
    with pytest.raises(ValueError, match="num_steps"):
        retrieval_train_group(states[1], ids, valid, 4, **kw)


def test_group_matches_jax_scan(tmp_path):
    """A group of 4 and a tail of 3 from bridged weights against JAX's
    scan (the tail padded with an identity step), where no draw reaches
    the result: parameters and moments after 7 steps (RAdam updates the
    parameters from step 6) within 1e-4 x max(1, max |JAX|)."""
    overrides = generate_retrieval_dataset(
        tmp_path, num_videos=16, num_val_videos=4, vid_feat_dim=64,
        text_feat_dim=48, mean_clips=3.0, max_clips=5, seed=3)
    cfg_dict = retrieval_config_dict(overrides, batch_size=8)
    for split in ("dataset_train", "dataset_val"):
        # every video and clip fits its slots: the jitter picks each frame
        cfg_dict[split]["max_frames"] = 1000
    cfg_dict["train"]["loss_cycle_cons"] = 0.0
    tcfg = RetrievalConfig(copy.deepcopy(cfg_dict))
    jcfg = JRetrievalConfig(copy.deepcopy(cfg_dict))
    _, _, tloader, _ = create_retrieval_datasets_and_loaders(
        tcfg, tmp_path, seed=0, fixed_shapes=True, device_preload=True)
    _, _, jloader, _ = j_loaders(jcfg, tmp_path, seed=0, fixed_shapes=True,
                                 device_preload=True)
    meta, jmeta = tloader.device_meta, jloader.device_meta
    assert meta.shapes == jmeta.shapes
    assert max(int(meta.tables["vid_nf"].max()),
               int(meta.tables["seg_nf"].max())) <= meta.max_frames
    jmgr = JModelManager(jcfg)
    params = jmgr.init_params(0)
    tmgr = RetrievalModelManager(tcfg, CPU, seed=1)
    tmgr.load_state({net: {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}
                     for net, sd in jax_params_to_state_dict(
                         jax.tree_util.tree_map(np.asarray, params)).items()})
    jopt = joptim.make_optimizer(jcfg.optimizer)
    jstate = JTrainState(params, jopt.init(params), jnp.int32(0))
    state = TrainState(tmgr.model, optim.make_optimizer(
        tcfg.optimizer, dict(tmgr.model.named_parameters())),
        philox.seed_state(0))
    lw = tcfg.train.contrastive_loss_config.as_dict()
    margin = tcfg.train.contrastive_loss_config.margin
    scan = make_retrieval_train_scan(
        jmgr.model_train, jopt, loss_weights=lw, margin=margin,
        loss_cycle_cons=0.0, device_sampling={
            "shapes": jmeta.shapes, "max_frames": jmeta.max_frames})
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 16, (8, 8)).astype(np.int32)
    valid = np.ones((8, 8), bool)
    valid[2, 5:] = False
    source = FeatureSource(tloader.device_store, meta)
    for g0, n in ((0, 4), (4, 3)):
        sv = np.arange(4) < n
        jstate, jmetrics = scan(
            jstate, jnp.asarray(ids[g0:g0 + 4]),
            jnp.asarray(valid[g0:g0 + 4]), jnp.asarray(sv),
            jnp.float32(1e-3), jax.random.PRNGKey(g0),
            jloader.device_store.vid_store, jloader.device_store.text_store,
            jmeta.tables)
        out = retrieval_train_group(
            state, ids[g0:g0 + 4], valid[g0:g0 + 4], n, lr=1e-3,
            loss_weights=lw, margin=margin, loss_cycle_cons=0.0,
            source=source)
        np.testing.assert_allclose(
            out["loss_total"].numpy(),
            np.asarray(jmetrics["loss_total"])[:n], rtol=2e-5, atol=2e-5)
    assert int(jstate.step) == state.step == 7
    assert int(state.optimizer.step_count) == 7
    for tree, ours in ((jstate.params, dict(tmgr.model.named_parameters())),
                       (jstate.opt_state.mu, state.optimizer.mu),
                       (jstate.opt_state.nu, state.optimizer.nu)):
        ref = _flat_torch(jax.tree_util.tree_map(np.asarray, tree))
        for name, value in ours.items():
            _close_grad(value.detach().numpy(), ref[name], name)


# ---------------- the trainer ----------------

def _trainer(root, cfg_dict, tmp_path, run):
    cfg = RetrievalConfig(cfg_dict)
    _, _, train_loader, val_loader = create_retrieval_datasets_and_loaders(
        cfg, root, seed=0, fixed_shapes=True, device_preload=True)
    assert train_loader.layout == "ids"
    trainer = RetrievalTrainer(
        cfg, RetrievalModelManager(cfg, CPU), "default", "group", run,
        len(train_loader), log_dir=str(tmp_path / "experiments"))
    return trainer, train_loader, val_loader


def test_trainer_group_dispatch(synth, tmp_path):
    """train.steps_per_dispatch = 2 on id batches: 3 steps an epoch as a
    group of 2 and a tail of 1, with the per-step bookkeeping of the
    meters, the scheduler and the checkpoint (the port's
    test_trainer_scan_fused_dispatch)."""
    root, cfg_dict = synth
    cfg_dict = copy.deepcopy(cfg_dict)
    cfg_dict["train"]["steps_per_dispatch"] = 2
    trainer, train_loader, val_loader = _trainer(root, cfg_dict, tmp_path,
                                                 "run1")
    trainer.train_model(train_loader, val_loader)
    assert trainer.dispatches == {"group": 4}
    assert trainer.state.current_epoch == 2
    assert trainer.state.total_step == 2 * len(train_loader) == 6
    assert trainer.train_state.step == 6
    assert int(trainer.train_state.optimizer.step_count) == 6
    assert int(trainer.train_state.seed) == 6
    losses = [v for _, v in trainer.metrics.storage_step[M.TRAIN_LOSS]]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert [s for s, _ in trainer.metrics.storage_step[M.TRAIN_LOSS]] == \
        list(range(1, 7))
    # each step booked its share of its group's time
    assert trainer.metrics.meters[M.TIME_STEP_FORWARD].count == 6
    assert len(trainer.metrics.storage_step[M.TIME_STEP_TOTAL + "-avg"]) \
        == 6
    val = [v for _, v in trainer.metrics.storage_epoch["val_base/loss"]]
    assert np.isfinite(val).all()


def test_trainer_group_degrades_during_step_warmup(synth, tmp_path):
    """A per-step warmup epoch dispatches per step (a group applies one lr
    to its steps); the epoch after it in groups (the port's
    test_trainer_scan_degrades_during_step_warmup)."""
    root, cfg_dict = synth
    cfg_dict = copy.deepcopy(cfg_dict)
    cfg_dict["train"]["steps_per_dispatch"] = 2
    cfg_dict["lr_scheduler"].update({"warmup_type": "step",
                                     "warmup_epochs": 1})
    trainer, train_loader, val_loader = _trainer(root, cfg_dict, tmp_path,
                                                 "warm")
    trainer.train_model(train_loader, val_loader)
    assert trainer.dispatches == {"step": 3, "group": 2}
    assert trainer.state.total_step == 2 * len(train_loader)
    lrs = [v for _, v in trainer.metrics.storage_step[M.TRAIN_LR]]
    assert len(set(lrs[:len(train_loader)])) > 1
    assert len(set(lrs[len(train_loader):])) == 1


def test_trainer_without_id_batches_dispatches_per_step(synth, tmp_path):
    """steps_per_dispatch > 1 on index batches (no device sampling) logs
    and trains per step, as JAX does."""
    root, cfg_dict = synth
    cfg_dict = copy.deepcopy(cfg_dict)
    cfg_dict["train"]["steps_per_dispatch"] = 2
    cfg_dict["train"]["num_epochs"] = 1
    cfg = RetrievalConfig(cfg_dict)
    _, _, train_loader, val_loader = create_retrieval_datasets_and_loaders(
        cfg, root, seed=0, device_preload=True)
    assert train_loader.layout == "indices"
    trainer = RetrievalTrainer(
        cfg, RetrievalModelManager(cfg, CPU), "default", "group", "idx",
        len(train_loader), log_dir=str(tmp_path / "experiments"))
    trainer.train_model(train_loader, val_loader)
    assert trainer.dispatches == {"step": 3}


def test_cli_group_run_resumes_like_an_unbroken_one(synth, tmp_path):
    """Through the CLI with dropout and noise on, in groups of 2: two
    epochs unbroken, and one epoch then resumed from its checkpoint (a
    group boundary), give the same losses; the checkpoint holds the seed
    state and the optimizer's device step count."""
    import yaml
    root, cfg_dict = synth
    cfg_dict = _with_dropout_and_noise(cfg_dict)
    cfg_dict["train"]["steps_per_dispatch"] = 1  # -o sets only known keys
    path = tmp_path / "group.yaml"
    path.write_text(yaml.safe_dump(cfg_dict), encoding="utf8")
    argv = ["-c", str(path), "--data_path", str(root), "--log_dir",
            str(tmp_path / "exp"), "--device", "cpu", "--preload_device",
            "--fixed_shapes"]
    unbroken = train_retrieval.main(argv + [
        "-r", "a", "-o", "train.num_epochs=2,train.steps_per_dispatch=2"])[0]
    train_retrieval.main(argv + [
        "-r", "b", "-o", "train.num_epochs=1,train.steps_per_dispatch=2"])
    resumed = train_retrieval.main(argv + [
        "-r", "b", "-o", "train.num_epochs=2,train.steps_per_dispatch=2"])[0]
    assert unbroken["dispatches"] == {"group": 4}
    assert resumed["dispatches"] == {"group": 2}
    assert len(unbroken["step_losses"]) == 6
    assert resumed["step_losses"] == unbroken["step_losses"]
    opt = torch.load(resumed["path_base"] / "models" / "optimizer_1.pth",
                     weights_only=True)
    assert int(opt["seed"]) == 6 and int(opt["optimizer"]["step"]) == 6
