"""The port's image ops and distributions against ladder_tpu's, on the same
numpy inputs and noise (1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ladder_tpu.models.layers import Conv as FlaxConv
from ladder_tpu.ops import distributions as jd
from ladder_tpu.ops import image as ji
from ladder_tpu_torch.models.layers import Conv
from ladder_tpu_torch.ops import distributions as td
from ladder_tpu_torch.ops import image as ti
from ladder_tpu_torch.utils.weights import flax_to_torch
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("in_hw, out_hw", [
    ((1, 1), (2, 2)), ((2, 2), (8, 8)), ((8, 8), (16, 16)),
    ((64, 64), (128, 128)), ((4, 6), (8, 6)),
])
def test_resize_bilinear_tf1(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal(
        (2,) + in_hw + (3,)).astype(np.float32)
    got = _nhwc(ti.resize_bilinear_tf1(_nchw(x), *out_hw))
    want = np.asarray(ji.resize_bilinear_tf1(jnp.asarray(x), *out_hw))
    np.testing.assert_allclose(got, want, **TOL)


def test_instance_norm():
    x = (3.0 + np.random.default_rng(1).standard_normal(
        (2, 8, 4, 5))).astype(np.float32)
    got = _nhwc(ti.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ji.instance_norm(
        jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("hw", [(2, 2), (4, 6), (8, 8)])
def test_conv3x3_up2x_matches_fused_and_explicit(hw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2,) + hw + (6,)).astype(np.float32)
    k = (0.2 * rng.standard_normal((3, 3, 6, 5))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    got = _nhwc(ti.conv3x3_up2x_tf1(
        _nchw(x), torch.tensor(k).permute(3, 2, 0, 1), torch.tensor(b)))
    fused = ji.conv3x3_up2x_tf1(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(b))
    up = ji.resize_bilinear_tf1(jnp.asarray(x), 2 * hw[0], 2 * hw[1])
    explicit = jax.lax.conv_general_dilated(
        up, jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    for want in (fused, explicit):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("size, k, stride, padding", [
    (8, 3, 2, "SAME"), (7, 3, 2, "SAME"), (8, 3, 1, "SAME"),
    (4, 3, 1, "VALID"), (2, 1, 1, "SAME"),
])
def test_conv_tf_padding(size, k, stride, padding):
    """TF SAME with stride 2 pads 0 before and 1 after on even inputs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    flax_conv = FlaxConv(5, k, strides=stride, padding=padding)
    params = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = flax_conv.apply({"params": params}, jnp.asarray(x))
    conv = Conv(4, 5, k, strides=stride, padding=padding)
    state = flax_to_torch({"c": params})
    conv.load_state_dict({k_.split(".", 1)[1]: torch.tensor(v)
                          for k_, v in state.items()})
    np.testing.assert_allclose(_nhwc(conv(_nchw(x)).detach()),
                               np.asarray(want), **TOL)


def _mixture(seed, k=4, d=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, d, d))
    covs = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    w[1] = 0.0  # zero-weight component masked to -inf
    w /= w.sum()
    means = rng.standard_normal((k, d)).astype(np.float32)
    return w, means, covs


def test_gmm_logpdf():
    w, means, covs = _mixture(4)
    x = np.random.default_rng(5).standard_normal((7, 3)).astype(np.float32)
    want = jd.gmm_logpdf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(means),
                         jd.gmm_cholesky(jnp.asarray(covs)))
    got = td.gmm_logpdf(torch.tensor(x), torch.tensor(w), torch.tensor(means),
                        td.gmm_cholesky(torch.tensor(covs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        td.gmm_cholesky(torch.tensor(covs)).numpy(),
        np.asarray(jd.gmm_cholesky(jnp.asarray(covs))), **TOL)


def test_sample_gmm_from_the_same_noise():
    """JAX draws (component, eps) from its key; the port's noise-fed core
    given those same numbers returns the same samples."""
    w, means, covs = _mixture(6)
    chols = jd.gmm_cholesky(jnp.asarray(covs))
    key = jax.random.PRNGKey(3)
    want = jd.sample_gmm(key, jnp.asarray(w), jnp.asarray(means), chols, 9)
    k_rng, g_rng = jax.random.split(key)
    comps = jax.random.categorical(
        k_rng, jnp.log(jnp.maximum(jnp.asarray(w), 1e-38)), shape=(9,))
    eps = jax.random.normal(g_rng, (9, 3))
    got = td.sample_gmm_from_noise(
        torch.tensor(np.asarray(comps)), torch.tensor(np.asarray(eps)),
        torch.tensor(means), torch.tensor(np.asarray(chols)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_gmm_generator():
    """Seeded draws are reproducible and have the mixture's mean."""
    w, means, covs = _mixture(7)
    args = (torch.tensor(w), torch.tensor(means),
            td.gmm_cholesky(torch.tensor(covs)))
    a = td.sample_gmm(torch.Generator().manual_seed(0), *args, 20000)
    b = td.sample_gmm(torch.Generator().manual_seed(0), *args, 20000)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(a.mean(0).numpy(), w @ means, atol=0.06)


def test_sample_diag_gaussian():
    mean, std = torch.full((4000, 2), 2.0), torch.full((4000, 2), 0.5)
    eps = torch.randn(4000, 2, generator=torch.Generator().manual_seed(1))
    s = td.sample_diag_gaussian(torch.Generator().manual_seed(1), mean, std)
    torch.testing.assert_close(s, mean + std * eps)
    np.testing.assert_allclose(s.std(0).numpy(), 0.5, atol=0.03)


def test_mvn_full_logpdf():
    _, means, covs = _mixture(8)
    x = np.random.default_rng(9).standard_normal((2, 5, 3)).astype(np.float32)
    want = jd.mvn_full_logpdf(jnp.asarray(x), jnp.asarray(means[0]),
                              jnp.linalg.cholesky(jnp.asarray(covs[0])))
    got = td.mvn_full_logpdf(torch.tensor(x), torch.tensor(means[0]),
                             torch.linalg.cholesky(torch.tensor(covs[0])))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
