"""The port's CelebA outer VAE and inner VAE against ladder_tpu's flax
modules: the same weights through the bridge, the same numpy inputs
(1e-4, as tests/test_pallas.py uses for the decoder)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ladder_tpu.ops.pallas_kernels as pk
from ladder_tpu.models import celeba as jceleba
from ladder_tpu.models import inner_vae as jinner
from ladder_tpu_torch.models import celeba as tceleba
from ladder_tpu_torch.models import inner_vae as tinner
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.ops import norm_chain as nc
from ladder_tpu_torch.utils.weights import flax_to_torch
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
H, CODE = 16, 8


def _load(module, group, params):
    """Load a flax subtree into a standalone port module via the bridge."""
    state = flax_to_torch({group: params})
    module.load_state_dict({k.split(".", 1)[1]: torch.tensor(v)
                            for k, v in state.items()})
    return module.eval()


def _images(n=3, seed=0):
    return np.random.default_rng(seed).random((n, 128, 128, 3)).astype(
        np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def encoder_params():
    enc = jceleba.CelebAEncoder(H, CODE)
    return enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)))[
        "params"]


def test_encoder_batch_statistics(encoder_params):
    x = _images()
    want = jceleba.CelebAEncoder(H, CODE).apply({"params": encoder_params},
                                                jnp.asarray(x))
    enc = _load(tceleba.CelebAEncoder(H, CODE), "encoder", encoder_params)
    with torch.no_grad():
        got = enc(_nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_encoder_frozen_statistics(encoder_params):
    rng = np.random.default_rng(2)
    widths = [H // 4, H // 4, H // 2, H // 2, H, H]
    stats = {f"BatchNormTrain_{i}": {
        "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "var": (0.5 + rng.random(c)).astype(np.float32)}
        for i, c in enumerate(widths)}
    x = _images(2, seed=3)
    want = jceleba.CelebAEncoder(H, CODE, bn_frozen=True).apply(
        {"params": encoder_params,
         "bn_stats": jax.tree.map(jnp.asarray, stats)}, jnp.asarray(x))
    enc = _load(tceleba.CelebAEncoder(H, CODE, bn_frozen=True), "encoder",
                encoder_params)
    for name, mv in stats.items():
        getattr(enc, name).set_stats(mv["mean"], mv["var"])
    with torch.no_grad():
        got = enc(_nchw(x))
        # frozen statistics make each row independent of the others
        one = enc(_nchw(x[:1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(one[0].numpy(), got[0][:1].numpy(), **TOL)


@pytest.mark.parametrize("use_pallas", [0, 1])
def test_decoder_matches_jax(use_pallas, monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(nc.fused_instnorm_style_lrelu, "launches", 0)
    z = np.random.default_rng(4).standard_normal((2, CODE)).astype(
        np.float32)
    jdec = jceleba.CelebADecoder(H, use_pallas=bool(use_pallas))
    params = jdec.init(jax.random.PRNGKey(5), jnp.asarray(z))["params"]
    want = jdec.apply({"params": params}, jnp.asarray(z))
    dec = _load(tceleba.CelebADecoder(H, CODE, use_pallas=bool(use_pallas)),
                "decoder", params)
    with torch.no_grad():
        got = dec(torch.tensor(z))
    assert got.shape == (2, 3, 128, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)
    assert nc.fused_instnorm_style_lrelu.launches == 0  # CPU: plain version


@pytest.mark.parametrize("activation, train_std", [
    ("leaky_relu", False), ("tanh", True), ("relu", False)])
def test_inner_vae_matches_jax(activation, train_std):
    rng = np.random.default_rng(6)
    z = rng.standard_normal((5, CODE)).astype(np.float32)
    t = rng.standard_normal((5, 2)).astype(np.float32)
    jenc = jinner.InnerEncoder(16, 2, 2, activation)
    jdec = jinner.InnerDecoder(16, CODE, 2, activation, train_std)
    penc = jenc.init(jax.random.PRNGKey(7), jnp.asarray(z))["params"]
    pdec = jdec.init(jax.random.PRNGKey(8), jnp.asarray(t))["params"]
    enc = _load(tinner.InnerEncoder(CODE, 16, 2, 2, activation), "e", penc)
    dec = _load(tinner.InnerDecoder(2, 16, CODE, 2, activation, train_std),
                "d", pdec)
    with torch.no_grad():
        got_e = enc(torch.tensor(z))
        got_d = dec(torch.tensor(t))
    for g, w in zip(got_e, jenc.apply({"params": penc}, jnp.asarray(z))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want_d = jdec.apply({"params": pdec}, jnp.asarray(t))
    np.testing.assert_allclose(got_d[0].numpy(), np.asarray(want_d[0]), **TOL)
    if train_std:
        np.testing.assert_allclose(got_d[1].numpy(), np.asarray(want_d[1]),
                                   **TOL)
    else:
        assert got_d[1] is None and want_d[1] is None


def _celeba_config(prior="ours", **kw):
    from tests.conftest import make_config
    return make_config(exp_name="celeba", prior=prior, dim_input_x=128,
                       dim_input_y=128, dim_input_channel=3,
                       num_hidden_units=H, code_size=CODE,
                       num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                       n_mixtures=3, **kw)


@pytest.mark.parametrize("prior", ["ours", "vampPrior", "GMM"])
def test_ladder_model_tree_matches_jax(prior):
    """The port's parameter tree has the flax model's keys and shapes, and
    the flax weights load into it and come back unchanged."""
    from ladder_tpu.models.builder import make_model as jmake

    cfg = _celeba_config(prior)
    jparams = jax.tree.map(np.asarray, jmake(cfg).init(jax.random.PRNGKey(0)))
    model = LadderModel(cfg)
    shapes = jax.tree.map(np.shape, model.flax_params())
    assert shapes == jax.tree.map(np.shape, jparams)
    model.load_flax_params(jparams)
    back = model.flax_params()
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    assert float(model.sigma_value().detach()) == pytest.approx(cfg["sigma"])
    if prior == "vampPrior":
        assert model.pseudo_inputs().shape == (3, 3, 128, 128)


def test_ladder_model_mnist_not_ported():
    """The mnist families build their own modules (the test's name dates
    from when they were refused; tests/test_torch_mnist_models.py holds
    them against ladder_tpu); an unknown family is refused."""
    from ladder_tpu_torch.models.mnist import DigitEncoder, FashionDecoder
    from tests.conftest import make_config
    assert isinstance(LadderModel(make_config()).encoder, DigitEncoder)
    assert isinstance(LadderModel(make_config(
        exp_name="mnist_fashion")).decoder, FashionDecoder)
    with pytest.raises(ValueError, match="unknown exp_name"):
        LadderModel(make_config(exp_name="svhn"))


def test_ladder_model_frozen_needs_stats():
    model = LadderModel(_celeba_config(bn_mode="frozen"))
    with pytest.raises(ValueError, match="set_bn_stats"):
        model.encode(torch.zeros(1, 3, 128, 128))
