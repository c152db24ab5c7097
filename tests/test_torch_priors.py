"""The four priors other than 'ours' (and 'ours' beside them) in the port's
trainer and engine, held against ladder_tpu's on the CPU:

* the epoch's flags, do_prior and the GM fed to the train step
  (``_flags``, ``_do_prior``, ``_gm_for_step``) at the epochs where they
  change, with and without a fitted GM; the trainers take no step;
* the fast GM fits the trainers make from the same samples and the same
  previous fit (the 'GMM' prior's EM warm start from the previous weights,
  means and covariances; 'ours'' responsibilities under it): these draw
  no random numbers, and agree at tests/test_torch_gmm.py's fixed
  tolerance (rtol 1e-4, atol 1e-5); the accurate fits start from random
  draws that cannot match, so only their shapes, weights and the npz they
  write are compared;
* the serving engine on an mnist_digit model: its deterministic paths, and
  the images generate() draws when both engines are fed the same standard
  normals and component indices (tests/test_torch_serving.py's tolerance,
  rtol = atol = 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladder_tpu.serving.engine as jengine_mod
from ladder_tpu.data.mnist import DataGenerator as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.serving import InferenceEngine as JaxEngine
from ladder_tpu.training.trainer import MNISTTrainer as JTrainer
from ladder_tpu.utils.checkpoint import save_gm_prior_info
from ladder_tpu_torch.data.mnist import DataGenerator
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.ops.distributions import sample_gmm_from_noise
from ladder_tpu_torch.serving import InferenceEngine
from ladder_tpu_torch.serving import engine as tengine_mod
from ladder_tpu_torch.training import trainer as ttrainer
from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, save_msgpack
from ladder_tpu_torch.utils.config import create_dirs
from tests.conftest import make_config
from tests.test_torch_gmm import FIXED_TOL
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

PRIORS = ["standard_gaussian", "GMM", "hierarchical", "vampPrior", "ours"]
SG, MASK = 2, 5          # sg_pretraining, use_mask_start
EPOCHS = {"first": 1, "sg_pretraining": SG, "after_sg": SG + 1,
          "use_mask_start": MASK}
GM_TOL = 1e-6
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(sg_pretraining=SG, use_mask_start=MASK, num_epochs=6,
             synthetic_n_train=256, synthetic_n_test=64, batch_size=64,
             num_hidden_units=64, num_hidden_units_inner_VAE=16,
             n_layers_inner_VAE=2, n_MC_samples=4, n_mixtures=4,
             enable_plots=0, load_dir="default")


def _config(prior, root):
    cfg = make_config(prior=prior, **SMALL)
    cfg["result_dir"] = str(root / "result") + "/"
    cfg["checkpoint_dir"] = str(root / "checkpoint") + "/"
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    return cfg


def _gm_dim(cfg):
    return (cfg["representation_size"] if cfg["prior"] == "ours"
            else cfg["code_size"])


def _random_gm(cfg, seed=0):
    """(weights, means, covs) over t ('ours') or z (the others)."""
    rng = np.random.default_rng(seed)
    k, d = cfg["n_mixtures"], _gm_dim(cfg)
    a = rng.standard_normal((k, d, d)) * 0.3
    covs = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)).astype(np.float32)
    w = rng.random(k) + 0.5
    return ((w / w.sum()).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32), covs)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A ladder_tpu trainer and a port trainer per prior, untrained (the
    JAX model's flax init replaced by the port's seeded weights)."""
    out = {}
    for prior in PRIORS:
        root = tmp_path_factory.mktemp(prior)
        cfg = _config(prior, root)
        jmodel = jmake(cfg)
        params = jax.tree.map(jnp.asarray,
                              make_model(cfg, seed=1).flax_params())
        jmodel.init = lambda rng, params=params: params
        out[prior] = (JTrainer(jmodel, JData(cfg), cfg),
                      ttrainer.MNISTTrainer(make_model(cfg, seed=1),
                                            DataGenerator(cfg), cfg,
                                            device="cpu"))
    return out


@pytest.mark.parametrize("fitted", [False, True], ids=["no_gm", "gm_fast"])
@pytest.mark.parametrize("epoch", list(EPOCHS))
@pytest.mark.parametrize("prior", PRIORS)
def test_epoch_flags_and_step_gm_match(trainers, prior, epoch, fitted):
    jt, tt = trainers[prior]
    gm = _random_gm(tt.config) if fitted else None
    jt.gm_fast = None if gm is None else tuple(jnp.asarray(a) for a in gm)
    tt.gm_fast = None if gm is None else tuple(torch.tensor(a) for a in gm)
    jt.cur_epoch = tt.cur_epoch = EPOCHS[epoch]
    assert tt._flags() == {k: bool(v) for k, v in jt._flags().items()}
    assert tt._do_prior() == jt._do_prior()
    want, got = jt._gm_for_step(), tt._gm_for_step()
    if want is None:
        assert got is None and prior not in ("ours", "GMM")
        return
    assert set(got) == set(want) == {"weights", "means", "chols"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=GM_TOL, err_msg=key)
    fed = fitted and EPOCHS[epoch] > (SG if prior == "ours" else 1)
    if fed:
        # the fitted GM from its epoch on: 'GMM' with +0.01 I (base.py
        # :925-933), 'ours' without
        chol = got["chols"].numpy().astype(np.float64)
        jitter = 0.01 if prior == "GMM" else 0.0
        np.testing.assert_allclose(
            chol @ chol.transpose(0, 2, 1),
            gm[2] + jitter * np.eye(_gm_dim(tt.config)), rtol=0, atol=1e-5)
    else:  # the identity GM of the pretraining epochs
        np.testing.assert_allclose(got["chols"].numpy(), np.broadcast_to(
            np.eye(_gm_dim(tt.config)), got["chols"].shape), atol=0)


def _feed_samples(jt, tt, samples):
    jt._collect_samples = lambda n, space: jnp.asarray(samples)
    tt._collect_samples = lambda n, space: torch.tensor(samples)
    tt.timings.append({"epoch": tt.cur_epoch, "gm": []})


@pytest.mark.parametrize("prior", ["GMM", "ours"])
def test_fast_fit_warm_start_matches(trainers, prior):
    """Each trainer's fast fit from the same samples and the same previous
    fast fit: 'GMM' passes it to EM as init_weights/means/covs
    (trainer.py:539-545), 'ours' as the responsibilities under it with
    1e-6 jitter (:576-584)."""
    jt, tt = trainers[prior]
    cfg = tt.config
    prev = _random_gm(cfg, seed=4)
    rng = np.random.default_rng(5)
    comps = rng.integers(0, cfg["n_mixtures"], 300)
    samples = (prev[1][comps] + np.einsum(
        "nij,nj->ni", np.linalg.cholesky(prev[2])[comps],
        rng.standard_normal((300, _gm_dim(cfg))))).astype(np.float32)
    jt.gm_fast = tuple(jnp.asarray(a) for a in prev)
    tt.gm_fast = tuple(torch.tensor(a) for a in prev)
    jt.cur_epoch = tt.cur_epoch = SG + 1
    _feed_samples(jt, tt, samples)
    space = "t" if prior == "ours" else "z"
    jt.fit_GMM_VI(mode="fast", space=space)
    tt.fit_GMM_VI(mode="fast", space=space)
    record = tt.timings[-1]["gm"][-1]
    assert record["mode"] == "fast" and record["samples"] == 300
    for got, want, name in zip(tt.gm_fast, jt.gm_fast,
                               ("weights", "means", "covariances")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **FIXED_TOL)


@pytest.mark.parametrize("prior", ["GMM", "ours"])
def test_accurate_fit_shapes_and_artifact(trainers, prior, tmp_path):
    """The accurate fits from random starts: the same shapes, weights that
    sum to one, and GM_prior_info.npz with the same keys and shapes."""
    jt, tt = trainers[prior]
    cfg = tt.config
    samples = np.random.default_rng(6).standard_normal(
        (256, _gm_dim(cfg))).astype(np.float32)
    jt.cur_epoch = tt.cur_epoch = cfg["num_epochs"]
    _feed_samples(jt, tt, samples)
    files = {}
    for name, trainer in (("jax", jt), ("port", tt)):
        trainer.config["result_dir"] = str(tmp_path / name) + "/"
        os.makedirs(trainer.config["result_dir"])
        trainer.fit_GMM_VI(mode="accurate", space="t" if prior == "ours"
                           else "z")
        files[name] = np.load(os.path.join(trainer.config["result_dir"],
                                           "GM_prior_info.npz"))
    for got, want in zip(tt.gm_final, jt.gm_final):
        assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(float(tt.gm_final[0].sum()), 1.0, rtol=1e-5)
    assert sorted(files["port"].files) == sorted(files["jax"].files) == [
        "K_active", "K_full", "m_active", "m_full", "w_active", "w_full"]
    for key in ("w_full", "m_full", "K_full"):
        assert files["port"][key].shape == files["jax"][key].shape
        assert files["port"][key].dtype == files["jax"][key].dtype


# ---- the serving engine ----------------------------------------------

SERVE_BATCH = 4


@pytest.fixture(scope="module", params=PRIORS[:4])
def engines(request, tmp_path_factory):
    """A seeded mnist_digit model of the prior written as checkpoint groups
    (and, for 'GMM', a GM over z), served by both engines on the CPU."""
    prior = request.param
    root = tmp_path_factory.mktemp(f"serve_{prior}")
    cfg = _config(prior, root)
    params = make_model(cfg, seed=2).flax_params()
    save_msgpack(os.path.join(cfg["checkpoint_dir"], "vae-model.msgpack"),
                 {k: params[k] for k in VAE_KEYS})
    prior_keys = [k for k in ("prior", "inner_sigma") if k in params]
    if prior_keys:
        save_msgpack(os.path.join(cfg["checkpoint_dir"],
                                  "prior-model.msgpack"),
                     {k: params[k] for k in prior_keys})
    if prior == "GMM":
        save_gm_prior_info(cfg["result_dir"], *_random_gm(cfg, seed=3))
    kw = dict(serve_batch=SERVE_BATCH, buckets=(2,))
    return cfg, JaxEngine(cfg, **kw), InferenceEngine(cfg, device="cpu",
                                                      **kw)


def _images(n, seed):
    return np.random.default_rng(seed).random((n, 28, 28, 1)).astype(
        np.float32)


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)


@pytest.mark.parametrize("n", [3, 1])   # the padded bucket 4; bucket 2
def test_engine_deterministic_paths_match(engines, n):
    cfg, jeng, teng = engines
    x = _images(n, seed=n)
    for path in ("encode", "reconstruct"):
        _close(getattr(teng, path)(x), getattr(jeng, path)(x))
    z = np.random.default_rng(n + 1).standard_normal(
        (n, cfg["code_size"])).astype(np.float32)
    _close(teng.decode(z), jeng.decode(z))
    if cfg["prior"] == "hierarchical":
        _close(teng.represent(x), jeng.represent(x))
        t = np.random.default_rng(n + 2).standard_normal(
            (n, cfg["representation_size"])).astype(np.float32)
        _close(teng.decode_representation(t), jeng.decode_representation(t))
    else:
        for eng in (teng, jeng):
            with pytest.raises(ValueError, match="t-space"):
                eng.represent(x)


def test_engine_generate_matches_on_fed_noise(engines, monkeypatch):
    """generate() with both engines fed the same draws: standard normals
    for the code (standard_gaussian) or t (hierarchical), component
    indices and normals for the GM over z (GMM), pseudo-input indices and
    normals for vampPrior (engine.py:241-261)."""
    cfg, jeng, teng = engines
    prior = cfg["prior"]
    rng = np.random.default_rng(9)
    d = (cfg["representation_size"] if prior == "hierarchical"
         else cfg["code_size"])
    eps = rng.standard_normal((SERVE_BATCH, d)).astype(np.float32)
    comps = rng.integers(0, cfg["n_mixtures"], SERVE_BATCH)

    with monkeypatch.context() as m:
        if prior in ("standard_gaussian", "hierarchical"):
            def normal(key, shape, dtype=jnp.float32):
                assert tuple(shape) == eps.shape
                return jnp.asarray(eps)
            m.setattr(jax.random, "normal", normal)
        elif prior == "GMM":
            def jsample(key, w, means, chols, n):
                c = jnp.asarray(comps)
                return means[c] + jnp.einsum("nij,nj->ni", chols[c],
                                             jnp.asarray(eps))
            m.setattr(jengine_mod, "sample_gmm", jsample)
        else:
            m.setattr(jax.random, "randint",
                      lambda key, shape, lo, hi: jnp.asarray(comps))
            m.setattr(jengine_mod, "sample_diag_gaussian",
                      lambda key, mean, std: mean + std * jnp.asarray(eps))
        want = jeng.generate(SERVE_BATCH)

    with monkeypatch.context() as m:
        m.setattr(tengine_mod, "sample_diag_gaussian",
                  lambda gen, mean, std: mean + std * torch.tensor(eps))
        m.setattr(tengine_mod, "sample_gmm",
                  lambda gen, w, means, chols, n: sample_gmm_from_noise(
                      torch.tensor(comps), torch.tensor(eps), means, chols))
        m.setattr(torch, "randint",
                  lambda lo, hi, shape, generator=None: torch.tensor(comps))
        got = teng.generate(SERVE_BATCH)
    assert got.shape == (SERVE_BATCH, 28, 28, 1)
    _close(got, want)
