"""The port's compute_loss (ladder_tpu_torch/training/losses.py) against
ladder_tpu's for all five priors on a small CelebA model: the same weights
through the bridge, the same batch, GM and noise. ladder_tpu draws its noise
from jax.random; here its sample_diag_gaussian is replaced by a queue of
numpy draws, which the port receives as ``noise``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ladder_tpu.ops.pallas_output as po
import ladder_tpu.training.losses as jlosses
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.training import losses
from tests.conftest import make_config

PRIORS = ["standard_gaussian", "ours", "hierarchical", "GMM", "vampPrior"]
# float32 on both sides, the same ops in another summation order; loss_ae is
# ~5e4 and sums 49152 pixel errors
TOL = dict(rtol=1e-4, atol=1e-4)
B, L = 4, 6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for these CPU-heavy tests, their module's fixtures
    included (a module-scoped autouse fixture is set up before the others
    of its scope), and for the processes they start (OMP_NUM_THREADS).
    With every core taken in each of several test workers, a torch with a
    thread a core spins its threads against the other workers' (an 8-core
    host beside eight busy processes ran tests/test_torch_chip_smoke_celeba
    .py's phase-6 rehearsal in 272 s at 8 threads, in 16 s at 2), and
    timing-sensitive tests that run beside them (tests/test_native_reader.py
    races native threads against Python) lose their race."""
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(2)
    os.environ["OMP_NUM_THREADS"] = "2"
    yield
    torch.set_num_threads(before)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def small_celeba(prior="ours", **kw):
    return make_config(
        exp_name="celeba", prior=prior, batch_size=B, dim_input_x=128,
        dim_input_y=128, dim_input_channel=3, code_size=8,
        representation_size=3, num_hidden_units=16,
        num_hidden_units_inner_VAE=8, n_layers_inner_VAE=2, n_MC_samples=L,
        n_mixtures=3, **kw)


def gm_for(cfg, seed=0):
    """A mixture over t ('ours') or over z ('GMM'), or None."""
    if cfg["prior"] not in ("ours", "GMM"):
        return None
    d = (cfg["representation_size"] if cfg["prior"] == "ours"
         else cfg["code_size"])
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, d, d)) * 0.3
    covs = a @ a.transpose(0, 2, 1) + np.eye(d)
    return dict(weights=np.array([0.5, 0.3, 0.2], np.float32),
                means=rng.standard_normal((3, d)).astype(np.float32),
                chols=np.linalg.cholesky(covs).astype(np.float32))


def noise_for(cfg, rng, batch=B):
    """One compute_loss call's draws, in ladder_tpu's order of use."""
    prior, code, rep = cfg["prior"], cfg["code_size"], cfg["representation_size"]
    out = {"eps_z": rng.standard_normal((batch, code)).astype(np.float32)}
    if prior in ("ours", "hierarchical"):
        out["eps_t"] = rng.standard_normal((batch, rep)).astype(np.float32)
    if prior in ("ours", "GMM", "vampPrior"):
        d = rep if prior == "ours" else code
        out["eps_mc"] = rng.standard_normal(
            (cfg["n_MC_samples"], batch, d)).astype(np.float32)
    return out


class NoiseQueue:
    """Stands in for ladder_tpu.training.losses.sample_diag_gaussian."""

    def __init__(self, monkeypatch):
        self.queue = []
        monkeypatch.setattr(jlosses, "sample_diag_gaussian", self)

    def feed(self, draws):
        for d in draws:
            self.queue += [d[k] for k in ("eps_z", "eps_t", "eps_mc")
                           if k in d]

    def __call__(self, rng, mean, std):
        eps = self.queue.pop(0)
        assert eps.shape == tuple(mean.shape), (eps.shape, mean.shape)
        return mean + std * jnp.asarray(eps)


def torch_noise(draws):
    return {k: torch.tensor(v) for k, v in draws.items()}


def torch_gm(gm):
    return None if gm is None else {k: torch.tensor(v) for k, v in gm.items()}


def jax_gm(gm):
    return None if gm is None else {k: jnp.asarray(v) for k, v in gm.items()}


def both_models(cfg, seed=0, edit=None):
    jmodel = jmake(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    if edit is not None:
        edit(params)
    model = LadderModel(cfg)
    model.load_flax_params(params)
    return jmodel, jax.tree.map(jnp.asarray, params), model


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def compare_metrics(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].detach()
        if g.dim() == 4:                                 # images: NCHW -> NHWC
            g = g.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("use_sg", [False, True])
@pytest.mark.parametrize("prior", PRIORS)
def test_compute_loss_matches_jax(prior, use_sg, monkeypatch):
    cfg = small_celeba(prior)
    jmodel, jparams, model = both_models(cfg)
    rng = np.random.default_rng(1)
    x = rng.random((B, 128, 128, 3)).astype(np.float32)
    gm, draws = gm_for(cfg), noise_for(cfg, rng)
    flags = {"use_sg_prior": use_sg, "use_mask": False}
    queue = NoiseQueue(monkeypatch)
    queue.feed([draws])
    jloss, jmetrics = jlosses.compute_loss(
        jmodel, jparams, jnp.asarray(x), jax.random.PRNGKey(0), jax_gm(gm),
        {k: jnp.asarray(v) for k, v in flags.items()})
    assert not queue.queue
    loss, metrics = losses.compute_loss(model, _nchw(x), gm=torch_gm(gm),
                                        flags=flags, noise=torch_noise(draws))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    compare_metrics(metrics, jmetrics)
    assert ("loss_prior" in metrics) == (prior in ("ours", "hierarchical",
                                                   "vampPrior"))


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("use_mask", [False, True])
def test_ours_mask_and_fused_output_stage(use_mask, fused, monkeypatch):
    """use_mask both ways with posterior stds on both sides of 1, against
    ladder_tpu with and without its fused output-stage kernel (interpret
    mode); the port takes its output-stage op either way."""
    monkeypatch.setattr(po, "_INTERPRET", True)
    cfg = small_celeba("ours", fused_output_stage=fused)

    def spread_stds(params):
        params["encoder"]["code_std_dev"]["bias"] = np.linspace(
            0.2, 1.8, 8).astype(np.float32)

    jmodel, jparams, model = both_models(cfg, seed=2, edit=spread_stds)
    assert jmodel.fused_output == bool(fused)
    rng = np.random.default_rng(3)
    x = rng.random((B, 128, 128, 3)).astype(np.float32)
    gm, draws = gm_for(cfg), noise_for(cfg, rng)
    queue = NoiseQueue(monkeypatch)
    queue.feed([draws])
    _, jmetrics = jlosses.compute_loss(
        jmodel, jparams, jnp.asarray(x), jax.random.PRNGKey(0), jax_gm(gm),
        {"use_sg_prior": jnp.asarray(False), "use_mask": jnp.asarray(use_mask)})
    _, metrics = losses.compute_loss(
        model, _nchw(x), gm=torch_gm(gm),
        flags={"use_mask": torch.tensor(use_mask)}, noise=torch_noise(draws))
    std = metrics["code_std_dev"]
    assert (std > 1).any() and (std < 1).any()
    compare_metrics(metrics, jmetrics)


def test_mask_changes_the_loss():
    cfg = small_celeba("ours")
    model = LadderModel(cfg, seed=4)
    with torch.no_grad():
        model.encoder.code_std_dev.bias.copy_(torch.linspace(0.2, 1.8, 8))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(B, 3, 128, 128, generator=g)
    draws = losses.draw_noise(cfg, B, g, "cpu")
    gm = torch_gm(gm_for(cfg))
    with torch.no_grad():
        vals = [float(losses.compute_loss(
            model, x, gm=gm, flags={"use_mask": m}, noise=draws)[1][
            "code_reconstruction_likelihood"]) for m in (False, True)]
    assert vals[1] > vals[0]  # masked errors drop out of the likelihood


def test_uint8_batches_are_normalised_inside(monkeypatch):
    cfg = small_celeba("ours")
    jmodel, jparams, model = both_models(cfg, seed=5)
    rng = np.random.default_rng(6)
    x8 = rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8)
    gm, draws = gm_for(cfg), noise_for(cfg, rng)
    queue = NoiseQueue(monkeypatch)
    queue.feed([draws])
    jloss, jmetrics = jlosses.compute_loss(
        jmodel, jparams, jnp.asarray(x8), jax.random.PRNGKey(0), jax_gm(gm))
    loss, metrics = losses.compute_loss(
        model, torch.tensor(x8).permute(0, 3, 1, 2).contiguous(),
        gm=torch_gm(gm), noise=torch_noise(draws))
    compare_metrics(metrics, jmetrics)
    as_float = losses.compute_loss(
        model, _nchw(x8.astype(np.float32) * np.float32(1.0 / 255.0)),
        gm=torch_gm(gm), noise=torch_noise(draws))[0]
    assert float(loss) == float(as_float)


def test_noise_from_a_generator_is_reproducible():
    cfg = small_celeba("ours")
    model = LadderModel(cfg, seed=7)
    x = torch.rand(B, 3, 128, 128, generator=torch.Generator().manual_seed(1))
    gm = torch_gm(gm_for(cfg))
    runs = [float(losses.compute_loss(
        model, x, torch.Generator().manual_seed(s), gm)[0])
        for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
    draws = losses.draw_noise(cfg, B, torch.Generator().manual_seed(3), "cpu")
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        "eps_z": (B, 8), "eps_t": (B, 3), "eps_mc": (L, B, 3)}
    assert float(losses.compute_loss(model, x, gm=gm, noise=draws)[0]) \
        == runs[0]
    with pytest.raises(ValueError, match="generator or noise"):
        losses.compute_loss(model, x, gm=gm)
    with pytest.raises(ValueError, match="eps_t"):
        losses.compute_loss(model, x, gm=gm,
                            noise=dict(draws, eps_t=draws["eps_t"][:, :2]))


def test_sigma_floor_splits_the_gradient_at_a_tie():
    """max(|sigma|, mean_pixel_error) at a tie sends half the gradient each
    way in torch as in jax, so the two packages' sigma updates agree there."""
    g = jax.grad(lambda a, b: jnp.maximum(a, b), argnums=(0, 1))(
        jnp.float32(0.5), jnp.float32(0.5))
    a = torch.tensor(0.5, requires_grad=True)
    b = torch.tensor(0.5, requires_grad=True)
    torch.maximum(a, b).backward()
    assert (float(a.grad), float(b.grad)) == (float(g[0]), float(g[1])) \
        == (0.5, 0.5)


@pytest.mark.parametrize("value, want", [(0.1, 0.5), (0.07, 1.0), (0.2, 0.0),
                                         (0.05, 0.5), (0.01, 0.0)])
def test_inner_sigma_clamp_gradient_matches_jnp_clip(value, want):
    """|inner_sigma| clamped to [0.05, 0.1]: inside the gradient passes, at
    a bound half of it (jnp.clip's rule; the configs start on the bound)."""
    cfg = small_celeba("ours")
    jmodel = jmake(cfg)
    jg = jax.grad(lambda s: jmodel.inner_sigma_value(
        {"inner_sigma": {"inner_sigma": s}}))(jnp.float32(value))
    model = LadderModel(cfg)
    with torch.no_grad():
        model.inner_sigma["inner_sigma"].fill_(value)
    model.inner_sigma_value().backward()
    got = float(model.inner_sigma["inner_sigma"].grad)
    assert got == float(jg) == want


def test_identity_gm_matches_jax():
    want = jlosses.identity_gm(3, 4)
    got = losses.identity_gm(3, 4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
