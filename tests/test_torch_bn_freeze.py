"""The port's "precise BN" recalibration (ladder_tpu_torch/serving/
bn_freeze.py) and its CLI (python -m ladder_tpu_torch.freeze_bn) against
ladder_tpu's estimate_bn_stats on the same converted weights and batches,
the single-batch exactness property, the npz round trip, and frozen-BN
serving of the result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladder_tpu.serving import bn_freeze as jbn
from ladder_tpu_torch import freeze_bn
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.serving import InferenceEngine
from ladder_tpu_torch.serving import bn_freeze as tbn
from ladder_tpu_torch.utils.checkpoint import CheckpointManager
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B = 6


def _config(tmp_path, **kw):
    cfg = make_config(exp_name="celeba", prior="ours", dim_input_x=128,
                      dim_input_y=128, dim_input_channel=3,
                      num_hidden_units=16, code_size=8,
                      num_hidden_units_inner_VAE=8, n_layers_inner_VAE=2,
                      n_mixtures=3, batch_size=B, synthetic_n_train=24,
                      synthetic_n_val=8, synthetic_n_test=8,
                      data_path=str(tmp_path / "data") + "/", **kw)
    cfg["checkpoint_dir"] = str(tmp_path / "ckpt") + "/"
    cfg["result_dir"] = str(tmp_path / "result") + "/"
    return cfg


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded model's flax-layout weights, with BatchNorm gammas and betas
    away from 1 and 0, and three batches: uint8 and float."""
    params = make_model(_config(tmp_path_factory.mktemp("w")),
                        seed=2).flax_params()
    rng = np.random.default_rng(0)
    for name, layer in params["encoder"].items():
        if name.startswith("BatchNormTrain_"):
            layer["gamma"] = rng.uniform(0.5, 1.5, layer["gamma"].shape
                                         ).astype(np.float32)
            layer["beta"] = rng.normal(0, 0.3, layer["beta"].shape
                                       ).astype(np.float32)
    batches = [rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
               rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
               rng.random((B, 128, 128, 3)).astype(np.float32)]
    return params, batches


def test_stats_match_ladder_tpu(weights, tmp_path):
    """Per layer and channel, mean and var within rtol 1e-5, plus 1e-5 of
    the channel's standard deviation (mean) or variance (var) absolute: the
    sums are float64 over float32 conv outputs that the two packages compute
    in other summation orders, and a channel mean near zero has no relative
    scale of its own (measured 7e-7 abs, 1.4e-6 of its std, on a mean of
    0.034)."""
    params, batches = weights
    cfg = _config(tmp_path)
    got = tbn.estimate_bn_stats(cfg, params, batches, device="cpu")
    want = jbn.estimate_bn_stats(cfg, jax.tree.map(jnp.asarray, params),
                                 batches)
    assert sorted(got) == sorted(want) == [f"BatchNormTrain_{i}"
                                           for i in range(6)]
    for name, mv in want.items():
        var = np.asarray(mv["var"], np.float64)
        for leaf, scale in (("mean", np.sqrt(var)), ("var", var)):
            g = got[name][leaf]
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            w = np.asarray(mv[leaf], np.float64)
            gap = np.abs(g.numpy() - w)
            assert (gap <= 1e-5 * np.abs(w) + 1e-5 * scale).all(), (
                name, leaf, gap.max())
        assert (got[name]["var"] >= 0).all()
    assert got["BatchNormTrain_5"]["mean"].shape == (16,)
    assert got["BatchNormTrain_0"]["mean"].shape == (4,)


def test_one_batch_of_stats_reproduces_the_batch_statistic_forward(
        weights, tmp_path):
    """Statistics from a single batch make the frozen forward equal the
    batch-statistic forward on that batch (within 1e-5 abs)."""
    params, batches = weights
    cfg = _config(tmp_path)
    stats = tbn.estimate_bn_stats(cfg, params, batches[:1], device="cpu")
    x = torch.tensor(batches[0]).float().mul(1 / 255).permute(0, 3, 1, 2)
    outs = []
    for mode in ("batch", "frozen"):
        model = make_model(dict(cfg, bn_mode=mode))
        model.load_flax_params(params)
        if mode == "frozen":
            model.set_bn_stats(stats)
        with torch.no_grad():
            outs.append(model.encode(x))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


def test_save_and_load_round_trip(weights, tmp_path):
    params, batches = weights
    stats = tbn.estimate_bn_stats(_config(tmp_path), params, batches,
                                  device="cpu")
    path = tbn.save_bn_stats(str(tmp_path / "out" / "bn_stats.npz"), stats)
    back = tbn.load_bn_stats(path)
    theirs = jbn.load_bn_stats(path)   # ladder_tpu reads the same file
    assert sorted(back) == sorted(stats) == sorted(theirs)
    for name, mv in stats.items():
        for leaf in ("mean", "var"):
            assert torch.equal(back[name][leaf], mv[leaf])
            np.testing.assert_array_equal(np.asarray(theirs[name][leaf]),
                                          mv[leaf].numpy())


def test_no_batches_and_mnist_are_refused(weights, tmp_path):
    params, _ = weights
    with pytest.raises(ValueError, match="at least one batch"):
        tbn.estimate_bn_stats(_config(tmp_path), params, [], device="cpu")
    with pytest.raises(ValueError, match="CelebA encoder only"):
        tbn.estimate_bn_stats(make_config(), params, [], device="cpu")


def test_cli_writes_stats_that_serve_rows_deterministically(
        weights, tmp_path, capsys):
    """python -m ladder_tpu_torch.freeze_bn --device cpu over 3 train
    batches of a saved checkpoint: the JSON line, the stats of those
    batches, and an engine with them whose rows do not depend on the batch
    around them (1e-5 abs)."""
    params, _ = weights
    cfg = _config(tmp_path, synthetic_data=1)
    os.makedirs(cfg["checkpoint_dir"])
    CheckpointManager(cfg).save(params, model="joint")
    config = tmp_path / "celeba.json"
    config.write_text(json.dumps(cfg))
    capsys.readouterr()
    assert freeze_bn.main(["--config", str(config), "--checkpoint-dir",
                           cfg["checkpoint_dir"], "--batches", "3",
                           "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = os.path.join(cfg["checkpoint_dir"], "bn_stats.npz")
    assert line == {"bn_stats": path, "batches": 3, "layers": {
        f"BatchNormTrain_{i}": c for i, c in enumerate((4, 4, 8, 8, 16, 16))}}

    from ladder_tpu_torch.data.celeba import CelebAData
    train = CelebAData(cfg).train
    want = tbn.estimate_bn_stats(
        cfg, params, list(train.epoch(B, seed=0, prefetch=False))[:3],
        device="cpu")
    got = tbn.load_bn_stats(path)
    for name in want:
        for leaf in ("mean", "var"):
            assert torch.equal(got[name][leaf], want[name][leaf])

    eng = InferenceEngine(cfg, bn_stats_path=path, device="cpu",
                          allow_uninitialized=True, serve_batch=8)
    x = train.first_batch(8)
    batch_mean, _ = eng.encode(x)
    for i in (0, 5):
        alone, _ = eng.encode(x[i:i + 1])
        np.testing.assert_allclose(alone[0], batch_mean[i], atol=1e-5,
                                   rtol=0)
    recon = eng.reconstruct(x[:3])
    assert np.isfinite(recon).all() and recon.min() >= 0 and recon.max() <= 1


def test_cli_refuses_mnist_and_defaults_to_cuda(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    mnist = tmp_path / "mnist.json"
    mnist.write_text(json.dumps(make_config()))
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.freeze_bn", "--config",
         str(mnist), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "applies to CelebA models only" in proc.stderr
    celeba = tmp_path / "celeba.json"
    celeba.write_text(json.dumps(_config(tmp_path)))
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.freeze_bn", "--config",
         str(celeba)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
