"""The port's CelebA trainer (ladder_tpu_torch/training/celeba_trainer.py)
through its train CLI (ladder_tpu_torch/train.py) on a tiny synthetic
CelebA config (h=16, code 16, batch 8, 32/16/8 images), against
ladder_tpu's CelebATrainer on the same config: the same artifact files, npz
keys and array shapes, the staircase lr per epoch, the checkpoint indices,
the TRAIN_VAE=0 validation quirk, a resume that trains only the remaining
epoch, and checkpoints that each package loads from the other bit for bit.
The random streams differ (a torch generator against the JAX key chain),
so the trained values are not compared: tests/test_torch_train_step.py
holds the steps against ladder_tpu on fed noise. Then bfloat16: the loss
on the same weights and fed noise against float32 and against
ladder_tpu's bf16 loss, and five bf16 single-pass steps."""

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

import ladder_tpu.training.losses as jlosses
from ladder_tpu.data.celeba import CelebAData as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.celeba_trainer import CelebATrainer as JTrainer
from ladder_tpu.training.step import init_state as jinit_state
from ladder_tpu.utils.checkpoint import CheckpointManager as JCheckpoints
from ladder_tpu.utils.config import create_dirs
from ladder_tpu_torch import train as ttrain
from ladder_tpu_torch.data.celeba import CelebAData
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.training import losses
from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
from ladder_tpu_torch.training.losses import identity_gm
from ladder_tpu_torch.training.step import (
    flax_state,
    init_state,
    make_train_step,
)
from ladder_tpu_torch.utils import checkpoint as tck
from tests.conftest import make_config
from tests.test_torch_losses import (  # noqa: F401  (few_threads: autouse)
    NoiseQueue,
    few_threads,
    noise_for,
    small_celeba,
    torch_noise,
)
from tests.test_torch_trainer import _assert_same_tree, _files, _run_cli

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN, N_VAL, N_TEST, BATCH = 32, 16, 8, 8
STEPS = N_TRAIN // BATCH
TINY = dict(exp_name="celeba", dim_input_x=128, dim_input_y=128,
            dim_input_channel=3, num_hidden_units=16, code_size=16,
            batch_size=BATCH, num_epochs=1, sg_pretraining=1,
            accurate_fit=2, n_MC_samples=2, n_mixtures=3,
            num_iter_to_plot=2, synthetic_n_train=N_TRAIN,
            synthetic_n_val=N_VAL, synthetic_n_test=N_TEST, enable_plots=0,
            num_hidden_units_inner_VAE=8, n_layers_inner_VAE=2,
            load_dir="default", load_model=1)


def _config(root, **kw):
    cfg = make_config(**{**TINY, "data_path": str(root / "data") + "/",
                         **kw})
    return cfg


def _dirs(cfg, root):
    for key in ("result", "checkpoint", "summary"):
        cfg[f"{key}_dir"] = str(root / key) + "/"
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    return cfg


def _write_config(path, data_root, **kw):
    path.write_text(json.dumps(_config(data_root, **kw)))
    return str(path)


def _lr_rows(cfg):
    with open(os.path.join(cfg["summary_dir"], "scalars.jsonl")) as f:
        return [(row["epoch"], row["lr_ae"]) for row in map(json.loads, f)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A ladder_tpu CelebA run and a port CLI run of the same one-epoch
    config (an accurate GM fit on its last epoch writes GM_prior_info.npz),
    then the port's resume to 2 epochs."""
    data_root = tmp_path_factory.mktemp("data")
    jroot = tmp_path_factory.mktemp("jax")
    cfg = _dirs(_config(data_root), jroot)
    jmodel = jmake(cfg)
    # seeded weights from the port stand in for flax's eager initialiser
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=4).flax_params())
    jmodel.init = lambda rng: params
    jtrainer = JTrainer(jmodel, JData(cfg), cfg)
    jtrainer.train()

    troot = tmp_path_factory.mktemp("port")
    config = _write_config(troot / "tiny.json", data_root)
    first = _run_cli(troot, ["--config", config, "--device", "cpu"])
    kept = troot / "after_one_epoch"
    shutil.copytree(first.config["result_dir"], kept)
    before = dict(losses=list(first.metrics.train_loss), results=kept,
                  files={p.name: p.stat().st_mtime_ns
                         for p in Path(first.config["checkpoint_dir"]).iterdir()})
    resume_cfg = _write_config(troot / "two.json", data_root, num_epochs=2)
    resumed = _run_cli(troot, ["--config", resume_cfg, "--device", "cpu"])
    return dict(jax=jtrainer, first=first, before=before, resumed=resumed,
                data_root=data_root, troot=troot)


def test_artifacts_match_ladder_tpu(runs):
    jcfg, tcfg = runs["jax"].config, runs["first"].config
    assert _files(jcfg["result_dir"]) == _files(tcfg["result_dir"]) == [
        "GM_prior_info.npz", "celeba-result.npz"]
    assert _files(jcfg["checkpoint_dir"]) == _files(tcfg["checkpoint_dir"])
    assert _files(tcfg["checkpoint_dir"]) == [
        "prior-model.msgpack", "train-state.msgpack", "vae-model.msgpack"]
    kept = runs["before"]["results"]
    for name in ("celeba-result.npz", "GM_prior_info.npz"):
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
    got = np.load(kept / "celeba-result.npz")
    assert len(got["train_loss"]) == STEPS and len(got["sigma"]) == 1
    assert len(got["val_loss"]) == N_VAL // BATCH
    assert np.isfinite(got["train_loss"]).all()
    gm = np.load(kept / "GM_prior_info.npz")
    np.testing.assert_allclose(gm["w_full"].sum(), 1.0, rtol=1e-5)


def test_staircase_lr_per_epoch(runs):
    """The epochs' lr_ae as each run logged it, and the schedule's steps at
    epochs 25/26, 50/51 and 75/76 (/1, /2, /5, /10 with a restarted 0.99
    decay), equal between the two trainers (rtol 1e-12: the same double
    arithmetic)."""
    jax_rows = _lr_rows(runs["jax"].config)
    rows = _lr_rows(runs["resumed"].config)   # the first run's, then epoch 2
    assert [e for e, _ in jax_rows] == [1]
    assert [e for e, _ in rows] == [1, 2]
    np.testing.assert_allclose(rows[:1], jax_rows, rtol=1e-12)
    jtrainer, trainer = runs["jax"], runs["resumed"]
    lr0 = trainer.config["learning_rate_ae"]
    for epoch in (1, 3, 25, 26, 50, 51, 75, 76, 100):
        jtrainer.cur_epoch = trainer.cur_epoch = epoch
        assert trainer.current_lr_ae() == pytest.approx(
            jtrainer.current_lr_ae(), rel=1e-12)
        assert trainer._lrs()["ae"] == trainer.current_lr_ae()
    jtrainer.cur_epoch, trainer.cur_epoch = 1, 2
    np.testing.assert_allclose(rows, [(1, lr0), (2, lr0 * 0.99)],
                               rtol=1e-12)


@pytest.mark.parametrize("num_iter_to_plot", [0, 1, 2, 3, 5])
def test_checkpoint_indices_match(runs, num_iter_to_plot):
    cfg = dict(runs["first"].config, num_iter_to_plot=num_iter_to_plot)
    trainer = CelebATrainer(make_model(cfg), runs["first"].data, cfg,
                            device="cpu")
    jtrainer = runs["jax"]
    n_iter = jtrainer.n_train_iter()
    step = max(n_iter // max(num_iter_to_plot, 1), 1)
    np.testing.assert_array_equal(trainer.idx_check_point,
                                  np.arange(0, n_iter - 1, step))
    if num_iter_to_plot == TINY["num_iter_to_plot"]:
        np.testing.assert_array_equal(trainer.idx_check_point,
                                      jtrainer.idx_check_point)
    assert trainer.n_train_iter() == n_iter == STEPS
    assert trainer.n_val_iter() == jtrainer.n_val_iter() == N_VAL // BATCH


def test_train_vae_off_records_a_zero_val_average(runs, tmp_path):
    """TRAIN_VAE=0: no VAE validation record, and the epoch average is
    0 / n_val_iter = 0.0, as the reference's trainers.py:186 records it."""
    cfg = _dirs(_config(runs["data_root"], TRAIN_VAE=0, num_epochs=1),
                tmp_path)
    trainer = CelebATrainer(make_model(cfg), CelebAData(cfg), cfg,
                            device="cpu")
    trainer.train()
    assert trainer.metrics.val_loss_ave_epoch == [0.0]
    assert trainer.metrics.val_loss == [] and trainer.metrics.train_loss == []
    assert len(trainer.metrics.val_loss_prior) == N_VAL // BATCH
    # ladder_tpu's trainer records the same for no VAE val step
    jtrainer = runs["jax"]
    jtrainer.append_val_average(0.0, 0)
    assert jtrainer.metrics.val_loss_ave_epoch.pop() == 0.0


def test_resume_trains_only_the_remaining_epoch(runs):
    resumed, before = runs["resumed"], runs["before"]
    assert runs["first"].cur_epoch == 1 and resumed.cur_epoch == 2
    assert len(resumed.metrics.train_loss) == 2 * STEPS
    np.testing.assert_array_equal(resumed.metrics.train_loss[:STEPS],
                                  before["losses"])
    assert [t["epoch"] for t in resumed.timings] == [2]
    r = np.load(os.path.join(resumed.config["result_dir"],
                             "celeba-result.npz"))
    assert len(r["train_loss"]) == 2 * STEPS and len(r["sigma"]) == 2
    ck = Path(resumed.config["checkpoint_dir"])
    for name in ("vae-model.msgpack", "prior-model.msgpack",
                 "train-state.msgpack"):
        assert (ck / name).stat().st_mtime_ns > before["files"][name]
    # the GM samples: every train batch of the epoch (32 of 2000 / 20000)
    assert [(g["mode"], g["samples"]) for g in resumed.timings[0]["gm"]] \
        == [("fast", N_TRAIN), ("accurate", N_TRAIN)]
    assert resumed.data.train.native


def _jax_state(cfg):
    jmodel = jmake(cfg)
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=5).flax_params())
    jmodel.init = lambda rng: params
    return jinit_state(jmodel, jax.random.PRNGKey(5))


def test_ladder_tpu_loads_the_ports_checkpoints(runs):
    resumed = runs["resumed"]
    cfg = resumed.config
    jck = JCheckpoints(cfg)
    state = jck.load(jck.load(_jax_state(cfg), "VAE"), "prior")
    _assert_same_tree(jax.tree.map(np.asarray, state["params"]),
                      resumed.model.flax_params())
    jstate, extra = jck.load_full(_jax_state(cfg))
    _assert_same_tree(jax.tree.map(np.asarray, jstate),
                      flax_state(resumed.state))
    assert int(extra["cur_epoch"]) == 2


def test_the_port_loads_ladder_tpus_checkpoints(runs, capsys):
    jtrainer = runs["jax"]
    cfg = dict(runs["first"].config,
               checkpoint_dir=jtrainer.config["checkpoint_dir"])
    trainer = CelebATrainer(make_model(cfg, seed=3), runs["first"].data, cfg,
                            device="cpu")
    ck = tck.CheckpointManager(cfg)
    params = ck.load(ck.load(trainer.model.flax_params(), "VAE"), "prior")
    _assert_same_tree(params, jax.tree.map(np.asarray,
                                           jtrainer.state["params"]))
    trainer.restore()
    assert "Full train state restored (epoch 1)." in capsys.readouterr().out
    assert trainer.cur_epoch == 1
    _assert_same_tree(flax_state(trainer.state),
                      jax.tree.map(np.asarray, jtrainer.state))
    np.testing.assert_array_equal(trainer.metrics.train_loss,
                                  jtrainer.metrics.train_loss)


def test_cli_defaults_to_cuda(runs, tmp_path):
    """python -m ladder_tpu_torch.train with a CelebA config and no
    --device asks for the card, and fails here, where there is none."""
    config = _write_config(tmp_path / "tiny.json", runs["data_root"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.train", "--config", config],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "experiments").exists()


# ---- bfloat16 --------------------------------------------------------------

def _bf16_setup(seed=0):
    cfg32 = small_celeba("ours")
    cfg16 = dict(cfg32, dtype="bfloat16")
    params = make_model(cfg32, seed=seed).flax_params()
    rng = np.random.default_rng(seed)
    x = rng.random((cfg32["batch_size"], 128, 128, 3)).astype(np.float32)
    return cfg32, cfg16, params, x, rng


def test_bf16_loss_within_band_of_float32_and_ladder_tpu(monkeypatch):
    """Same weights, batch and fed noise: the port's bf16 loss within rtol
    0.05 of its float32 loss and of ladder_tpu's bf16 loss (the band of
    tests/test_perf_modes.py's bf16 test)."""
    cfg32, cfg16, params, x, rng = _bf16_setup()
    draws = noise_for(cfg32, rng)
    gm = identity_gm(cfg32["n_mixtures"], cfg32["representation_size"])
    flags = {"use_sg_prior": False, "use_mask": False}
    got = {}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        model = make_model(cfg)
        model.load_flax_params(params)
        xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous()
        loss, _ = losses.compute_loss(model, xt, gm=gm, flags=flags,
                                      noise=torch_noise(draws))
        got[name] = float(loss.detach())
    queue = NoiseQueue(monkeypatch)
    queue.feed([draws])
    jmodel = jmake(cfg16)
    jgm = {k: jnp.asarray(v.numpy()) for k, v in gm.items()}

    # jitted: the fed draws are taken while tracing (eager, the bf16
    # forward dispatches op by op for half a minute)
    @jax.jit
    def jloss(p, xj):
        return jlosses.compute_loss(jmodel, p, xj, jax.random.PRNGKey(0),
                                    jgm, flags)[0]

    jloss = jloss(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    assert not queue.queue
    assert np.isfinite(got["bf16"]) and got["bf16"] != got["f32"]
    np.testing.assert_allclose(got["bf16"], got["f32"], rtol=0.05)
    np.testing.assert_allclose(got["bf16"], float(jloss), rtol=0.05)


def test_bf16_single_pass_steps_train_in_float32_parameters():
    """Five bf16 mode-2 steps on one batch: finite losses that fall, and
    parameters and moments that stay float32 (tests/test_perf_modes.py's
    bf16 training test, on the CelebA model)."""
    cfg32, cfg16, params, x, _ = _bf16_setup(seed=1)
    cfg16 = dict(cfg16, fused_train_step=2)
    model = make_model(cfg16)
    model.load_flax_params(params)
    state = init_state(model, device="cpu")
    step = make_train_step(model)
    gm = identity_gm(cfg16["n_mixtures"], cfg16["representation_size"])
    lrs = dict.fromkeys(("ae", "sigma", "prior", "inner_sigma"), 1e-3)
    generator = torch.Generator().manual_seed(5)
    trace = []
    for _ in range(5):
        state, out = step(state, x, generator, gm, {}, lrs, True)
        trace.append(float(out["ae"]["loss_ae"]))
    assert np.all(np.isfinite(trace))
    assert trace[-1] < trace[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for group in state["opt"].values():
        assert all(m.dtype == torch.float32 for m in group["m"].values())
    assert all(v.dtype == torch.float32 for v in out["ae"].values())
