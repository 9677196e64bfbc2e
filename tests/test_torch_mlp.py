"""
The port's MLP example (coot_videotext_tpu_torch/examples/mlp_mnist.py,
run_mlp_mnist) against the JAX package's, on the CPU: the same synthetic
digits and batches (byte-equal), logits, loss and one Adam step on weights
bridged from JAX (within 1e-5), and the integration contract of
tests/test_integration_mlp.py: train, resume from the checkpoint, reload
for inference, and two trainings from one seed bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coot_videotext_tpu.examples import mlp_mnist as jmlp
from coot_videotext_tpu.train.optim import make_adam
from coot_videotext_tpu_torch import run_mlp_mnist
from coot_videotext_tpu_torch.examples.mlp_mnist import (
    MLPMNISTDataLoader, MLPMNISTExperimentConfig, MLPMNISTTrainer,
    MLPModelManager, make_synthetic_mnist, nll_per_row)
from coot_videotext_tpu_torch.utils.param_bridge import (
    jax_mlp_params_to_state_dict)
from coot_videotext_tpu_torch.utils.yaml_utils import load_yaml_config_file

torch.set_num_threads(1)

CONFIG = "config/mlp/default/mnist.yaml"
TOL = 1e-5
CPU = torch.device("cpu")


def make_cfg(num_epochs=2):
    config = load_yaml_config_file(CONFIG)
    config["train"]["num_epochs"] = num_epochs
    return MLPMNISTExperimentConfig(config)


def make_loaders(cfg):
    (tx, ty), (vx, vy) = make_synthetic_mnist(num_train=256, num_val=128)
    return (MLPMNISTDataLoader(tx, ty, cfg.train.batch_size,
                               shuffle=True, seed=0),
            MLPMNISTDataLoader(vx, vy, cfg.val.batch_size, shuffle=False))


def test_data_and_batches_equal_jax():
    ours = make_synthetic_mnist(num_train=100, num_val=50, seed=3)
    ref = jmlp.make_synthetic_mnist(num_train=100, num_val=50, seed=3)
    for (a, b), (c, d) in zip(ours, ref):
        assert a.tobytes() == c.tobytes() and a.dtype == c.dtype
        assert b.tobytes() == d.tobytes() and b.dtype == d.dtype
    (tx, ty), _ = ours
    loader = MLPMNISTDataLoader(tx, ty, 32, shuffle=True, seed=5)
    jloader = jmlp.MLPMNISTDataLoader(tx, ty, 32, shuffle=True, seed=5)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        batches = list(loader)
        assert len(batches) == len(loader) == 4
        for a, b in zip(batches, jloader):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    assert batches[-1]["weights"].sum() == 100 - 3 * 32


@pytest.fixture(scope="module")
def bridged():
    """JAX's MLP (its own init, seed 0) and the port's with its weights,
    plus a padded batch."""
    cfg = make_cfg()
    jmodel = jmlp.MLPModel(hidden_dim=cfg.mlp_hidden_dim)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((2, 28 * 28)))["params"]
    mgr = MLPModelManager(make_cfg(), CPU)
    mgr.model.load_state_dict({
        k: torch.from_numpy(np.array(v))
        for k, v in jax_mlp_params_to_state_dict(params).items()})
    (tx, ty), _ = make_synthetic_mnist(num_train=50, num_val=10)
    batch = next(iter(MLPMNISTDataLoader(tx, ty, 64, shuffle=False)))
    return cfg, jmodel, params, mgr, batch


def _jax_loss(jmodel, params, batch):
    logits = jmodel.apply({"params": params}, batch["images"])
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    nll = -jnp.take_along_axis(logp, batch["labels"][:, None], axis=1)[:, 0]
    w = batch["weights"]
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0), logits


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_logits_and_loss_match_jax(bridged):
    _, jmodel, params, mgr, batch = bridged
    ref_loss, ref_logits = _jax_loss(jmodel, params, batch)
    t = _tensors(batch)
    with torch.no_grad():
        logits = mgr.model(t["images"])
        nll = nll_per_row(logits, t["labels"])
        loss = (nll * t["weights"]).sum() / t["weights"].sum()
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    assert batch["weights"].sum() == 50  # 14 padded rows weigh 0


def test_adam_step_matches_jax(bridged, tmp_path):
    """One train step (loss, gradients, Adam at lr 1e-3) from the bridged
    weights: the loss and every updated parameter within 1e-5."""
    cfg, jmodel, params, _, batch = bridged
    opt = cfg.optimizer
    jopt = make_adam(0.9, opt.adam_beta2, opt.adam_eps, opt.weight_decay,
                     opt.weight_decay_for_bias)
    loss, grads = jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, batch)[0])(params)
    new_params, _ = jopt.update(grads, jopt.init(params), params, 1e-3)
    mgr = MLPModelManager(cfg, CPU)
    mgr.model.load_state_dict({
        k: torch.from_numpy(np.array(v))
        for k, v in jax_mlp_params_to_state_dict(params).items()})
    trainer = MLPMNISTTrainer(cfg, mgr, "default", "mnist", "step", 1,
                              log_dir=str(tmp_path))
    try:
        ours = trainer.train_step(_tensors(batch), 1e-3)
    finally:
        trainer.close()
    np.testing.assert_allclose(float(ours), float(loss), rtol=TOL)
    state = mgr.model.state_dict()
    for k, v in jax_mlp_params_to_state_dict(new_params).items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=TOL, rtol=0,
                                   err_msg=k)
    assert int(trainer.optimizer.step_count) == 1


def run_training(log_dir, num_epochs, run_name="run1"):
    cfg = make_cfg(num_epochs)
    train_loader, val_loader = make_loaders(cfg)
    mgr = MLPModelManager(cfg, CPU)
    trainer = MLPMNISTTrainer(cfg, mgr, "default", "mnist", run_name,
                              len(train_loader), log_dir=log_dir)
    trainer.train_model(train_loader, val_loader)
    accs = [v for _, v in
            trainer.metrics.storage_epoch["val_base/best_field"]]
    losses = [v for _, v in trainer.metrics.storage_epoch["val_base/loss"]]
    epoch = trainer.state.current_epoch
    trainer.close()
    return accs, losses, epoch


def test_train_resume_and_reload(tmp_path):
    log_dir = str(tmp_path / "exp")
    accs, _losses, epoch = run_training(log_dir, 2)
    assert epoch == 2
    assert accs[-1] > 0.5  # synthetic digits are easily learnable

    cfg3 = make_cfg(3)
    train_loader, val_loader = make_loaders(cfg3)
    trainer = MLPMNISTTrainer(cfg3, MLPModelManager(cfg3, CPU), "default",
                              "mnist", "run1", len(train_loader),
                              log_dir=log_dir)
    assert trainer.load and trainer.state.current_epoch == 2
    trainer.train_model(train_loader, val_loader)
    assert trainer.state.current_epoch == 3
    assert int(trainer.optimizer.step_count) == 3 * len(train_loader)
    trainer.close()

    cfg_t = make_cfg(3)
    train_loader, val_loader = make_loaders(cfg_t)
    mgr = MLPModelManager(cfg_t, CPU, seed=123)
    trainer = MLPMNISTTrainer(cfg_t, mgr, "default", "mnist", "run1",
                              len(train_loader), log_dir=log_dir,
                              load_best=True, is_test=True)
    assert mgr.was_loaded
    loss, acc, _ = trainer.validate_epoch(val_loader)
    assert np.isfinite(loss) and acc > 0.5
    trainer.close()


def test_determinism(tmp_path):
    """Two trainings from seed 0 give bit-identical validation results
    (reference integration_deter.py:55-66)."""
    accs_a, losses_a, _ = run_training(str(tmp_path / "a"), 2, "runA")
    accs_b, losses_b, _ = run_training(str(tmp_path / "b"), 2, "runB")
    np.testing.assert_array_equal(accs_a, accs_b)
    np.testing.assert_array_equal(losses_a, losses_b)


def test_cli_trains_resumes_and_validates(tmp_path, monkeypatch):
    argv = ["-g", "default", "-e", "mnist", "--device", "cpu",
            "--log_dir", str(tmp_path)]
    first = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=1"])[0]
    assert first["state"]["current_epoch"] == 1
    assert (first["path_base"] / "models" / "model_0.pth").is_file()
    resumed = run_mlp_mnist.main(argv + ["-o", "train.num_epochs=2"])[0]
    assert resumed["state"]["current_epoch"] == 2
    assert len(resumed["val_loss"]) == 2
    val = run_mlp_mnist.main(argv + ["--validate", "--load_epoch", "1"])[0]
    assert val["val_loss"] == pytest.approx(resumed["val_loss"][1],
                                            rel=1e-12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_mlp_mnist.main(["-g", "default", "-e", "mnist"])
