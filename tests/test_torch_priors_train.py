"""The port's train CLI (python -m ladder_tpu_torch.train) for the four
priors other than 'ours', beside ladder_tpu's MNISTTrainer on the same
tiny synthetic mnist_digit config (2 epochs, sg_pretraining 1): the same
result and checkpoint files (prior-model.msgpack only where ladder_tpu
writes it), the same npz keys, shapes and dtypes, and the prior's own
curves. Then a resume of standard_gaussian from 2 to 3 epochs and an
mnist_fashion run (tests/test_train_e2e.py:187, :281). The random streams
differ, so values are not compared (tests/test_torch_mnist_step.py and
tests/test_torch_priors.py hold the steps and the fits)."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ladder_tpu.data.mnist import DataGenerator as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.trainer import MNISTTrainer as JTrainer
from ladder_tpu.utils.metrics import MetricsRecorder as JMetrics
from ladder_tpu_torch.models.builder import make_model
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_trainer import TINY, _dirs, _files, _run_cli, \
    _write_config, STEPS

PRIORS = ["standard_gaussian", "GMM", "hierarchical", "vampPrior"]


@pytest.fixture(scope="module", params=PRIORS)
def runs(request, tmp_path_factory):
    """A ladder_tpu run and a port CLI run of the prior's 2-epoch config."""
    prior = request.param
    jroot = tmp_path_factory.mktemp(f"jax_{prior}")
    cfg = _dirs(make_config(**TINY, prior=prior), jroot)
    jmodel = jmake(cfg)
    # seeded weights from the port stand in for flax's eager initialiser
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=4).flax_params())
    jmodel.init = lambda rng: params
    jtrainer = JTrainer(jmodel, JData(cfg), cfg)
    jtrainer.train()
    troot = tmp_path_factory.mktemp(f"port_{prior}")
    config = _write_config(troot / "tiny.json", prior=prior)
    trainer = _run_cli(troot, ["--config", config, "--device", "cpu"])
    return dict(prior=prior, jax=jtrainer, port=trainer, troot=troot)


def test_files_match_ladder_tpu(runs):
    jcfg, tcfg = runs["jax"].config, runs["port"].config
    assert _files(tcfg["result_dir"]) == _files(jcfg["result_dir"])
    assert _files(tcfg["checkpoint_dir"]) == _files(jcfg["checkpoint_dir"])
    with_gm = runs["prior"] == "GMM"
    assert ("GM_prior_info.npz" in _files(tcfg["result_dir"])) == with_gm
    with_prior = runs["prior"] in ("hierarchical", "vampPrior")
    assert ("prior-model.msgpack"
            in _files(tcfg["checkpoint_dir"])) == with_prior


def test_npz_keys_shapes_and_dtypes_match(runs):
    jdir = runs["jax"].config["result_dir"]
    tdir = runs["port"].config["result_dir"]
    names = [n for n in _files(jdir) if n.endswith(".npz")]
    assert "mnist_digit-result.npz" in names
    for name in names:
        want = np.load(os.path.join(jdir, name))
        got = np.load(os.path.join(tdir, name))
        assert sorted(got.files) == sorted(want.files), name
        for key in want.files:
            assert got[key].dtype.kind == want[key].dtype.kind, (name, key)
            if key.endswith("_active"):
                assert got[key].shape[1:] == want[key].shape[1:], (name, key)
                continue  # as many rows as the fit left active
            assert got[key].shape == want[key].shape, (name, key)


def test_curves_are_finite_and_the_priors_own(runs):
    """Both packages record the same buffers (vampPrior's cross-entropy
    among them, tests/test_train_e2e.py:78-87), finite, over 2 epochs."""
    jm, tm = runs["jax"].metrics, runs["port"].metrics
    assert len(tm.train_loss) == 2 * STEPS
    assert len(tm.train_loss_ave_epoch) == 2
    for name, values in vars(jm).items():
        if not isinstance(values, list):
            continue
        mine = getattr(tm, name)
        assert bool(len(mine)) == bool(len(values)), name
        assert len(mine) == len(values) or name.startswith("gmm_"), name
        if mine and not name.startswith("gmm_"):
            assert np.isfinite(np.asarray(mine, float)).all(), name
    if runs["prior"] == "vampPrior":
        assert len(tm.vampPrior_crossEntropy_prior_train) > 0
    if runs["prior"] == "GMM":
        assert runs["port"].gm_fast is not None
        assert runs["port"].gm_final is not None
        assert [[g["mode"] for g in t["gm"]]
                for t in runs["port"].timings] == [["fast"], ["accurate"]]


def test_standard_gaussian_resume_trains_epoch_three_only(tmp_path, capsys):
    root = Path(tmp_path)
    cfg2 = _write_config(root / "two.json", prior="standard_gaussian")
    first = _run_cli(root, ["--config", cfg2, "--device", "cpu"])
    losses = list(first.metrics.train_loss)
    cfg3 = _write_config(root / "three.json", prior="standard_gaussian",
                         num_epochs=3)
    resumed = _run_cli(root, ["--config", cfg3, "--device", "cpu"])
    assert "Full train state restored (epoch 2)." in capsys.readouterr().out
    assert resumed.cur_epoch == 3
    assert [t["epoch"] for t in resumed.timings] == [3]
    assert len(resumed.metrics.train_loss) == 3 * STEPS
    np.testing.assert_array_equal(resumed.metrics.train_loss[:2 * STEPS],
                                  losses)
    r = np.load(os.path.join(resumed.config["result_dir"],
                             "mnist_digit-result.npz"))
    assert len(r["train_loss"]) == 3 * STEPS and len(r["sigma"]) == 3
    assert "prior-model.msgpack" not in os.listdir(
        resumed.config["checkpoint_dir"])


def test_fashion_run(tmp_path):
    """tests/test_train_e2e.py:281 through the port's CLI: the fashion
    family trains 2 epochs, its loss falls, and its npz has ladder_tpu's
    keys."""
    n_train = 512
    config = _write_config(tmp_path / "fashion.json",
                           prior="standard_gaussian",
                           exp_name="mnist_fashion",
                           synthetic_n_train=n_train)
    trainer = _run_cli(tmp_path, ["--config", config, "--device", "cpu"])
    losses = trainer.metrics.train_loss_ave_epoch
    assert len(losses) == 2 and losses[1] < losses[0]
    r = np.load(os.path.join(trainer.config["result_dir"],
                             "mnist_fashion-result.npz"))
    assert len(r["train_loss"]) == 2 * (n_train // TINY["batch_size"])
    want = np.load(JMetrics().save(
        {"result_dir": str(tmp_path) + "/", "exp_name": "jax_fashion"},
        [1, 2], 3, 4))
    assert sorted(r.files) == sorted(want.files)
