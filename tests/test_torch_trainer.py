"""The port's trainer and train CLI (ladder_tpu_torch/training/trainer.py,
ladder_tpu_torch/train.py) on a tiny synthetic mnist_digit 'ours' config,
against a ladder_tpu run of the same config: the same artifact files, npz
keys and array shapes, a resume that trains only the remaining epoch, and
checkpoints that each package loads from the other bit for bit. The random
streams differ (a torch generator against the JAX key chain), so values
are not compared here: tests/test_torch_mnist_step.py holds the steps
against ladder_tpu on fed noise, tests/test_torch_gmm.py the GM fits."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladder_tpu.data.mnist import DataGenerator as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.step import init_state as jinit_state
from ladder_tpu.training.trainer import MNISTTrainer as JTrainer
from ladder_tpu.utils.checkpoint import CheckpointManager as JCheckpoints
from ladder_tpu.utils.config import create_dirs
from ladder_tpu_torch import train as ttrain
from ladder_tpu_torch.data.mnist import DataGenerator
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.training import trainer as ttrainer
from ladder_tpu_torch.training.step import flax_state
from ladder_tpu_torch.utils import checkpoint as tck
from tests.conftest import make_config
from tests.test_torch_checkpoint import _assert_same_tree as _same_order
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN, BATCH = 256, 64
STEPS = N_TRAIN // BATCH
TINY = dict(num_epochs=2, sg_pretraining=1, accurate_fit=2,
            synthetic_n_train=N_TRAIN, synthetic_n_test=128,
            num_hidden_units=64, num_hidden_units_inner_VAE=16,
            n_layers_inner_VAE=2, n_MC_samples=4, n_mixtures=4,
            enable_plots=0, batch_size=BATCH, load_dir="default",
            load_model=1)


def _dirs(cfg, root):
    cfg["result_dir"] = str(root / "result") + "/"
    cfg["checkpoint_dir"] = str(root / "checkpoint") + "/"
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    return cfg


def _write_config(path, **kw):
    cfg = {k: v for k, v in make_config(**{**TINY, **kw}).items()}
    path.write_text(json.dumps(cfg))
    return str(path)


def _run_cli(workdir, argv):
    """ladder_tpu_torch.train.main in ``workdir`` (its directories are
    relative to the working directory)."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        trainer = ttrain.main(argv)
    finally:
        os.chdir(old)
    for key in ("result_dir", "checkpoint_dir", "summary_dir"):
        trainer.config[key] = str(workdir / trainer.config[key])
    return trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A ladder_tpu run and a port CLI run of the same 2-epoch config, then
    the port's resume to 3 epochs."""
    jroot = tmp_path_factory.mktemp("jax")
    cfg = _dirs(make_config(**TINY), jroot)
    jmodel = jmake(cfg)
    # seeded weights from the port stand in for flax's eager initialiser,
    # which costs seconds here
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=4).flax_params())
    jmodel.init = lambda rng: params
    jtrainer = JTrainer(jmodel, JData(cfg), cfg)
    jtrainer.train()

    troot = tmp_path_factory.mktemp("port")
    config = _write_config(troot / "tiny.json")
    first = _run_cli(troot, ["--config", config, "--device", "cpu"])
    kept = troot / "after_two_epochs"
    shutil.copytree(first.config["result_dir"], kept)
    before = dict(losses=list(first.metrics.train_loss), results=kept,
                  params=first.model.flax_params(),
                  files={p.name: p.stat().st_mtime_ns
                         for p in Path(first.config["checkpoint_dir"]).iterdir()})
    resume_cfg = _write_config(troot / "three.json", num_epochs=3)
    resumed = _run_cli(troot, ["--config", resume_cfg, "--device", "cpu"])
    return dict(jax=jtrainer, first=first, before=before, resumed=resumed,
                jroot=jroot, troot=troot)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _assert_same_tree(a, b):
    """Equal keys, shapes, dtypes and bytes, whatever the dicts' order."""
    _same_order(_sorted(a), _sorted(b))


def _files(d):
    return sorted(p.name for p in Path(d).iterdir()
                  if not p.name.startswith("training_config_"))


def test_artifacts_match_ladder_tpu(runs):
    jcfg, tcfg = runs["jax"].config, runs["first"].config
    assert _files(jcfg["result_dir"]) == _files(tcfg["result_dir"]) == [
        "GM_prior_info.npz", "mnist_digit-result.npz"]
    assert _files(jcfg["checkpoint_dir"]) == _files(tcfg["checkpoint_dir"])
    assert _files(tcfg["checkpoint_dir"]) == [
        "prior-model.msgpack", "train-state.msgpack", "vae-model.msgpack"]
    assert any(p.startswith("training_config_")
               for p in os.listdir(tcfg["checkpoint_dir"]))
    # the port's results after the 2-epoch run, before the resume
    # rewrote them
    kept = runs["before"]["results"]
    for name in ("mnist_digit-result.npz", "GM_prior_info.npz"):
        want = np.load(os.path.join(jcfg["result_dir"], name))
        got = np.load(kept / name)
        assert sorted(got.files) == sorted(want.files), name
        for key in want.files:
            if key.endswith("_active"):
                continue  # as many rows as the fit left active
            assert got[key].shape == want[key].shape, (name, key)
            assert got[key].dtype.kind == want[key].dtype.kind, (name, key)
        for key in ("num_para_VAE", "n_train_iter", "n_val_iter"):
            if key in want.files:
                np.testing.assert_array_equal(got[key], want[key])
    got = np.load(kept / "mnist_digit-result.npz")
    assert len(got["train_loss"]) == 2 * STEPS and len(got["sigma"]) == 2
    gm = np.load(kept / "GM_prior_info.npz")
    np.testing.assert_allclose(gm["w_full"].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(gm["w_active"].sum(), 1.0, rtol=1e-5)
    assert gm["K_active"].shape == (len(gm["w_active"]), 2, 2)


def test_resume_trains_only_the_remaining_epoch(runs, capsys):
    resumed, before = runs["resumed"], runs["before"]
    assert runs["first"].cur_epoch == 2 and resumed.cur_epoch == 3
    assert len(resumed.metrics.train_loss) == 3 * STEPS
    np.testing.assert_array_equal(resumed.metrics.train_loss[:2 * STEPS],
                                  before["losses"])
    assert [t["epoch"] for t in resumed.timings] == [3]
    assert len(resumed.metrics.test_sigma) == 3
    r = np.load(os.path.join(resumed.config["result_dir"],
                             "mnist_digit-result.npz"))
    assert len(r["train_loss"]) == 3 * STEPS and len(r["sigma"]) == 3
    ck = Path(resumed.config["checkpoint_dir"])
    for name in ("vae-model.msgpack", "prior-model.msgpack",
                 "train-state.msgpack"):
        assert (ck / name).stat().st_mtime_ns > before["files"][name]
    # epoch 3 is the last: a fast and an accurate fit
    assert [g["mode"] for g in resumed.timings[0]["gm"]] == ["fast",
                                                              "accurate"]
    for g in resumed.timings[0]["gm"]:
        assert 1 <= g["n_iter"] and g["samples"] % BATCH == 0
    # a further run of the finished config trains nothing
    again = _run_cli(runs["troot"], ["--config",
                                     str(runs["troot"] / "three.json"),
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Full train state restored (epoch 3)." in out
    assert again.cur_epoch == 3 and again.timings == []


def _jax_state(cfg):
    """A ladder_tpu train state to load into (its values do not matter)."""
    jmodel = jmake(cfg)
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=5).flax_params())
    jmodel.init = lambda rng: params
    return jinit_state(jmodel, jax.random.PRNGKey(5))


def test_ladder_tpu_loads_the_ports_checkpoints(runs):
    resumed = runs["resumed"]
    cfg = resumed.config
    mine = resumed.model.flax_params()
    jck = JCheckpoints(cfg)
    state = jck.load(jck.load(_jax_state(cfg), "VAE"), "prior")
    _assert_same_tree(jax.tree.map(np.asarray, state["params"]), mine)
    full = jck.load_full(_jax_state(cfg))
    assert full is not None
    jstate, extra = full
    _assert_same_tree(jax.tree.map(np.asarray, jstate),
                      flax_state(resumed.state))
    assert int(extra["cur_epoch"]) == 3 and "rng" not in extra
    assert ttrainer.RNG_KEY in extra


def test_the_port_loads_ladder_tpus_checkpoints(runs, capsys):
    jtrainer = runs["jax"]
    cfg = dict(runs["first"].config,
               checkpoint_dir=jtrainer.config["checkpoint_dir"])
    want_params = jax.tree.map(np.asarray, jtrainer.state["params"])
    # the two groups alone
    trainer = ttrainer.MNISTTrainer(make_model(cfg, seed=3),
                                    DataGenerator(cfg), cfg, device="cpu")
    ck = tck.CheckpointManager(cfg)
    params = ck.load(ck.load(trainer.model.flax_params(), "VAE"), "prior")
    _assert_same_tree(params, want_params)
    # the full train state: params, moments and counters; the JAX key does
    # not cross, so the generator keeps its seeded state
    seeded = trainer.generator.get_state().clone()
    trainer.restore()
    assert "Full train state restored (epoch 2)." in capsys.readouterr().out
    assert trainer.cur_epoch == 2
    _assert_same_tree(flax_state(trainer.state),
                      jax.tree.map(np.asarray, jtrainer.state))
    assert torch.equal(trainer.generator.get_state(), seeded)
    np.testing.assert_array_equal(trainer.metrics.train_loss,
                                  jtrainer.metrics.train_loss)
    np.testing.assert_array_equal(trainer.gm_fast[0].numpy(),
                                  np.asarray(jtrainer.gm_fast[0]))


def test_the_writer_matches_flax_on_a_train_state(runs):
    from flax import serialization

    state = flax_state(runs["resumed"].state)
    tree = {"state": state, "extra": {"cur_epoch": np.asarray(3),
                                      "metrics": {"train_loss": np.arange(
                                          5.0)}}}
    assert tck.msgpack_serialize(tree) == serialization.msgpack_serialize(
        tree)


@pytest.mark.parametrize("override, match", [
    ({"gmm_backend": "sklearn"}, "scikit-learn"),
    ({"enable_plots": 1}, "enable_plots"),
    ({"mesh_shape": [2]}, "one device"),
    ({"checkpoint_backend": "orbax"}, "msgpack backend"),
    ({"async_checkpoint": 1}, "asynchronous")])
def test_unported_options_raise_at_construction(tmp_path, override, match):
    cfg = _dirs(make_config(**{**TINY, **override}), tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        ttrainer.MNISTTrainer(make_model(cfg), DataGenerator(cfg), cfg,
                              device="cpu")


def test_steps_per_call_runs_the_same_epoch(tmp_path):
    """steps_per_call is accepted and trains the same epoch, step by step,
    as a config without it."""
    losses = []
    for k in (1, 3):
        cfg = _dirs(make_config(**{**TINY, "steps_per_call": k,
                                   "num_epochs": 1}), tmp_path / str(k))
        trainer = ttrainer.MNISTTrainer(make_model(cfg), DataGenerator(cfg),
                                        cfg, device="cpu")
        trainer.train()
        assert trainer.state["step"] == STEPS
        losses.append(trainer.metrics.train_loss)
    assert len(losses[1]) == STEPS
    assert all(np.isfinite(losses[1]))
    np.testing.assert_array_equal(losses[1], losses[0])


def test_a_random_state_of_another_device_is_not_restored(tmp_path, capsys):
    """A train state written on the card holds a CUDA generator's 16-byte
    state; resumed on the CPU, the seeded generator is kept."""
    cfg = _dirs(make_config(**TINY), tmp_path)
    trainer = ttrainer.MNISTTrainer(make_model(cfg), DataGenerator(cfg), cfg,
                                    device="cpu")
    seeded = trainer.generator.get_state().clone()
    trainer._restore_generator(np.arange(16, dtype=np.uint8))
    assert "another device" in capsys.readouterr().out
    assert torch.equal(trainer.generator.get_state(), seeded)
    torch.rand(3, generator=trainer.generator)
    trainer._restore_generator(seeded.numpy())
    assert torch.equal(trainer.generator.get_state(), seeded)


def test_to_host_keeps_structure_and_dtypes():
    tree = [{"a": torch.tensor(1.5), "b": torch.arange(3.0)},
            {"c": torch.tensor([[1, 2]], dtype=torch.int32)}]
    host = ttrainer._to_host(tree)
    assert host[0]["a"].shape == () and host[0]["a"] == 1.5
    np.testing.assert_array_equal(host[0]["b"], [0.0, 1.0, 2.0])
    assert host[1]["c"].dtype == np.int32 and host[1]["c"].shape == (1, 2)


def test_bad_config_prints_and_exits_zero(capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--config", "/nonexistent/config.json", "--device",
                     "cpu"])
    assert exc.value.code == 0
    assert "missing or invalid arguments" in capsys.readouterr().out


def test_cli_defaults_to_cuda(tmp_path):
    """python -m ladder_tpu_torch.train without --device asks for the card,
    and fails here, where there is none."""
    config = _write_config(tmp_path / "tiny.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.train", "--config", config],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "experiments").exists()
