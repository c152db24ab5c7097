"""The port's plots and prior sampling (ladder_tpu_torch/utils/plotting.py,
the trainers' plot hooks and sample_codes_from_prior), against ladder_tpu.

Filenames: with enable_plots on, the port's trainers write the PDF set that
ladder_tpu's write on the same config (MNISTTrainer for 'ours' and 'GMM');
the other three priors write the names of ladder_tpu's rule (tests/test_torch_plot_cli.py runs
the train CLIs). Values, with their tolerances:
  * the density plot's numpy Gaussian densities against scipy's
    multivariate_normal: 1e-10 absolute;
  * codes and decoded images from the same draws (t, k and eps) and the
    same weights: 1e-5 absolute;
  * 20,000 GMM draws: the sample mean and covariance within 5 standard
    errors of the mixture's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladder_tpu.training.trainer as jtrainer_mod
from ladder_tpu.data.mnist import DataGenerator as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.celeba_trainer import CelebATrainer as JCelebA
from ladder_tpu.training.trainer import JointTrainer as JJoint
from ladder_tpu.training.trainer import MNISTTrainer as JTrainer
from ladder_tpu.utils.config import create_dirs
from ladder_tpu_torch.data.mnist import DataGenerator
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.training import trainer as ttrainer
from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
from ladder_tpu_torch.utils import plotting
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ATOL = 1e-5
# tests/test_plots_and_generation.py:_run_with_plots's config
PLOTS = dict(num_epochs=1, sg_pretraining=0, accurate_fit=1,
             synthetic_n_train=128, synthetic_n_test=128,
             num_hidden_units=64, num_hidden_units_inner_VAE=16,
             n_layers_inner_VAE=2, n_MC_samples=2, n_mixtures=3,
             enable_plots=1)


def _dirs(cfg, root):
    cfg["result_dir"] = str(root / "result") + "/"
    cfg["checkpoint_dir"] = str(root / "checkpoint") + "/"
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    return cfg


def _pdfs(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".pdf"))


def _port_run(root, prior, **kw):
    cfg = _dirs(make_config(prior=prior, **{**PLOTS, **kw}), root)
    trainer = ttrainer.MNISTTrainer(make_model(cfg, seed=4),
                                    DataGenerator(cfg), cfg, device="cpu")
    trainer.train()
    return trainer


def _jax_trainer(root, prior, **kw):
    cfg = _dirs(make_config(prior=prior, **{**PLOTS, **kw}), root)
    jmodel = jmake(cfg)
    # the port's seeded weights stand in for flax's eager initialiser
    params = jax.tree.map(jnp.asarray,
                          make_model(cfg, seed=4).flax_params())
    jmodel.init = lambda rng: params
    return JTrainer(jmodel, JData(cfg), cfg)


@pytest.mark.parametrize("prior", ["ours", "GMM"])
def test_plot_filenames_match_ladder_tpu(tmp_path, prior):
    kw = dict(code_size=2) if prior == "GMM" else {}
    jtrainer = _jax_trainer(tmp_path / "jax", prior, **kw)
    jtrainer.train()
    trainer = _port_run(tmp_path / "port", prior, **kw)
    want = _pdfs(jtrainer.config["result_dir"])
    assert _pdfs(trainer.config["result_dir"]) == want
    assert "prior_estimate_density_1_accurate-GM.pdf" in want
    assert "test_reconstructed_1_0.pdf" in want


RULE = {
    "standard_gaussian": ["generated_samples_prior_1.pdf"],
    "hierarchical": ["generated_samples_prior_1.pdf", "loss-inner-VAE.pdf"],
    "vampPrior": ["generated_samples_prior_1.pdf",
                  "vampPrior-prior-loss.pdf"],
}


@pytest.mark.parametrize("prior", sorted(RULE))
def test_other_priors_plot_ladder_tpus_names(tmp_path, prior):
    """ladder_tpu's rule (trainer.py:434-443, 649-675): samples without a
    fit mode for these priors; the prior's loss panels once the epoch is
    past sg_pretraining with a prior model trained."""
    trainer = _port_run(tmp_path, prior)
    assert _pdfs(trainer.config["result_dir"]) == sorted(RULE[prior] + [
        "loss-elbo.pdf", "loss-outer-VAE-val.pdf", "sigma.pdf",
        "test_original_0.pdf", "test_reconstructed_1_0.pdf"])


def test_plots_need_matplotlib(tmp_path, monkeypatch):
    """Plots on and no matplotlib: an ImportError that names it, raised
    at construction, before any step."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    cfg = _dirs(make_config(prior="ours", **PLOTS), tmp_path)
    with pytest.raises(ImportError, match="matplotlib"):
        ttrainer.MNISTTrainer(make_model(cfg), DataGenerator(cfg), cfg,
                              device="cpu")
    assert not os.listdir(cfg["result_dir"])


def test_density_is_scipys():
    from scipy.stats import multivariate_normal

    rng = np.random.default_rng(0)
    w = np.array([0.5, 0.3, 0.195, 0.005])   # the last one is inactive
    m = rng.standard_normal((4, 2)) * 3.0
    a = rng.standard_normal((4, 2, 2))
    K = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(2)
    x, y = np.mgrid[-10:10:.05, -10:10:.05]
    pos = np.dstack([x, y])
    for i in range(4):
        np.testing.assert_allclose(plotting.gaussian_pdf(pos, m[i], K[i]),
                                   multivariate_normal(m[i], K[i]).pdf(pos),
                                   rtol=0, atol=1e-10)
    want = sum(multivariate_normal(m[i], K[i]).pdf(pos)
               for i in range(3)) / 3 + 1e-8
    np.testing.assert_allclose(plotting.prior_density_grid(w, m, K), want,
                               rtol=0, atol=1e-10)


def test_prior_distribution_plots_both_styles(tmp_path):
    rng = np.random.default_rng(1)
    K = np.stack([np.eye(2) * 0.5] * 3)
    for style in ("circle", "density"):
        plotting.plot_prior_distribution(
            rng.standard_normal((64, 2)), [0.5, 0.5, 0.0],
            rng.standard_normal((3, 2)), K, str(tmp_path), 3,
            mode="accurate-GM", style=style)
    assert _pdfs(tmp_path) == ["prior_estimate_circle_3_accurate-GM.pdf",
                               "prior_estimate_density_3_accurate-GM.pdf"]


@pytest.fixture(scope="module")
def sampling_pair(tmp_path_factory):
    """A ladder_tpu trainer and the port's on the same weights and the same
    fast and accurate GMs (plots off: sampling does not depend on them)."""
    root = tmp_path_factory.mktemp("sampling")
    pairs = {}
    for prior in ("ours", "hierarchical", "vampPrior", "GMM",
                  "standard_gaussian"):
        kw = dict(enable_plots=0)
        jtr = _jax_trainer(root / f"jax_{prior}", prior, **kw)
        cfg = _dirs(make_config(prior=prior, **{**PLOTS, **kw}),
                    root / f"port_{prior}")
        tr = ttrainer.MNISTTrainer(make_model(cfg, seed=4),
                                   DataGenerator(cfg), cfg, device="cpu")
        pairs[prior] = (jtr, tr)
    return pairs


def _draws(prior, cfg, n, rng):
    if prior in ("ours", "hierarchical"):
        return {"t": rng.standard_normal(
            (n, cfg["representation_size"])).astype(np.float32)}
    if prior == "vampPrior":
        return {"k": rng.integers(0, cfg["n_mixtures"], n),
                "eps": rng.standard_normal(
                    (n, cfg["code_size"])).astype(np.float32)}
    return {"z": rng.standard_normal((n, cfg["code_size"])).astype(
        np.float32)}


@pytest.mark.parametrize("prior", ["ours", "hierarchical", "vampPrior",
                                   "GMM", "standard_gaussian"])
def test_codes_and_decodes_from_the_same_draws(sampling_pair, monkeypatch,
                                                prior):
    """ladder_tpu's sample_codes_from_prior with its draws replaced by the
    fed ones (t for sample_gmm or the normal, k for randint, eps for the
    normal) against the port's codes_from_draws, then both decodes."""
    jtr, tr = sampling_pair[prior]
    cfg = tr.config
    draws = _draws(prior, cfg, 100, np.random.default_rng(3))
    fed = draws.get("t", draws.get("z", draws.get("eps")))
    monkeypatch.setattr(jtrainer_mod, "sample_gmm",
                        lambda *a: jnp.asarray(fed))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(fed))
    if "k" in draws:
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(draws["k"]))
    if prior in ("ours", "GMM"):
        gm = (np.full(3, 1 / 3, np.float32),
              np.zeros((3, fed.shape[1]), np.float32),
              np.stack([np.eye(fed.shape[1], dtype=np.float32)] * 3))
        jtr.gm_fast = tuple(jnp.asarray(a) for a in gm)
        tr.gm_fast = tuple(torch.tensor(a) for a in gm)
    want = np.asarray(jtr.sample_codes_from_prior(100))
    got = tr.codes_from_draws({k: torch.tensor(v) for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    images = tr.fwd["decode"](got).numpy()
    np.testing.assert_allclose(
        images, np.asarray(jtr.fwd["decode"](jtr.state["params"],
                                             jnp.asarray(want))),
        rtol=0, atol=ATOL)
    assert images.shape == (100, 28, 28, 1)


@pytest.mark.parametrize("prior, epoch, name", [
    ("ours", 1, "generated_samples_prior_1.pdf"),          # sg pretraining
    ("ours", 2, "generated_samples_prior_2_accurate-GM.pdf"),
    ("ours", 3, "generated_samples_prior_3_crude-GM.pdf"),
    ("GMM", 2, "generated_samples_prior_2_crude-GM.pdf"),
    ("GMM", 4, "generated_samples_prior_4_accurate-GM.pdf"),
    ("vampPrior", 3, "generated_samples_prior_3.pdf")])
def test_prior_samples_follow_the_epoch_rule(sampling_pair, prior, epoch,
                                             name):
    """The device half of generate_samples_from_prior: 100 host images and
    the filename of ladder_tpu's rule (sg_pretraining 1, accurate_fit 2,
    num_epochs 4 here)."""
    _, tr = sampling_pair[prior]
    tr.config = dict(tr.config, sg_pretraining=1, accurate_fit=2,
                     num_epochs=4)
    tr.cur_epoch = epoch
    d = tr.config["code_size" if prior == "GMM" else "representation_size"]
    gm = (torch.full((3,), 1 / 3), torch.zeros(3, d),
          torch.eye(d).expand(3, d, d).clone())
    tr.gm_fast = tr.gm_final = gm
    images, filename = tr.prior_samples()
    assert isinstance(images, np.ndarray) and images.shape == (100, 28, 28, 1)
    assert np.isfinite(images).all()
    assert filename == os.path.join(tr.config["result_dir"], name)


def test_gmm_draws_have_the_mixtures_moments(sampling_pair):
    _, tr = sampling_pair["GMM"]
    d = tr.config["code_size"]
    rng = np.random.default_rng(5)
    w = np.array([0.2, 0.5, 0.3])
    m = rng.standard_normal((3, d)) * 2.0
    a = rng.standard_normal((3, d, d)) * 0.5
    K = a @ a.transpose(0, 2, 1) + 0.2 * np.eye(d)
    tr.gm_fast = tuple(torch.tensor(x, dtype=torch.float32)
                       for x in (w, m, K))
    n = 20000
    z = tr.prior_draws(n, mode="crude-GM")["z"].double().numpy()
    mean = w @ m
    cov = sum(w[i] * (K[i] + np.outer(m[i] - mean, m[i] - mean))
              for i in range(3))
    assert np.all(np.abs(z.mean(0) - mean) <= 5 * np.sqrt(np.diag(cov) / n))
    # the standard error of a sample covariance entry: sqrt(var((x-mu)(y-nu))/n)
    c = z - mean
    prods = c[:, :, None] * c[:, None, :]
    se = prods.std(0) / np.sqrt(n)
    assert np.all(np.abs(prods.mean(0) - cov) <= 5 * se + 1e-12)


class _Data:
    def __init__(self, n_train):
        self.n_train = n_train
        self.test = type("T", (), {"first_batch": lambda self, b: None})()


@pytest.mark.parametrize("n_train, batch, num_iter_to_plot", [
    (1024, 64, 2), (512, 8, 5), (32, 8, 2), (64, 64, 2), (640, 64, 1),
    (2000, 16, 7)])
def test_celeba_check_points_are_ladder_tpus(monkeypatch, n_train, batch,
                                             num_iter_to_plot):
    def bare_init(self, model, data, config, *rest, **kw):
        self.data, self.config = data, config

    monkeypatch.setattr(JJoint, "__init__", bare_init)
    monkeypatch.setattr(ttrainer.JointTrainer, "__init__", bare_init)
    cfg = dict(batch_size=batch, num_iter_to_plot=num_iter_to_plot)
    want = JCelebA(None, _Data(n_train), cfg).idx_check_point
    got = CelebATrainer(None, _Data(n_train), cfg).idx_check_point
    np.testing.assert_array_equal(got, want)
