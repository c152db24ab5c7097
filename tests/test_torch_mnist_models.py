"""The port's mnist families (ladder_tpu_torch/models/mnist.py) against
ladder_tpu's flax modules: depth_to_space and symmetric padding, the digit
and fashion encoders and decoders on the same weights (through the bridge)
and the same numpy inputs, at test_torch_models.py's TOL, and the bridge on
the pretrained mnist trees (bit-exact round trips, the flattened dense
rows). The digit decoder ends at h/64 channels, so the digit modules are
tested at h=64 and the fashion modules at h=32."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ladder_tpu.models import mnist as jmnist
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.ops import image as ji
from ladder_tpu_torch.models import mnist as tmnist
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.models.layers import init_parameters
from ladder_tpu_torch.ops import image as ti
from ladder_tpu_torch.utils import checkpoint as tck
from ladder_tpu_torch.utils.weights import flax_to_torch, torch_to_flax
from tests.conftest import make_config
from tests.test_torch_checkpoint import _assert_same_tree
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
CODE = 8
WIDTHS = {"digit": 64, "fashion": 32}


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _images(n=4, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1)).astype(
        np.float32)


@pytest.mark.parametrize("shape, r", [((2, 1, 1, 64), 4), ((2, 3, 5, 16), 2),
                                      ((1, 4, 4, 36), 3)])
def test_depth_to_space_is_tf_dcr(shape, r):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(ji.depth_to_space(jnp.asarray(x), r))
    got = _nhwc(ti.depth_to_space(_nchw(x), r))
    np.testing.assert_array_equal(got, want)
    # torch.pixel_shuffle orders the channels otherwise (CRD)
    assert not np.array_equal(_nhwc(torch.pixel_shuffle(_nchw(x), r)), want)


@pytest.mark.parametrize("pad", [(2, 2), (1, 3), (0, 2)])
def test_pad_symmetric_repeats_the_edge(pad):
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 3)).astype(
        np.float32)
    want = np.asarray(ji.pad_symmetric(jnp.asarray(x), *pad))
    got = _nhwc(ti.pad_symmetric(_nchw(x), *pad))
    np.testing.assert_array_equal(got, want)
    row = ti.pad_symmetric(torch.tensor([[[[1.0, 2.0, 3.0]]]]), 0, 2)
    assert row.flatten().tolist() == [2, 1, 1, 2, 3, 3, 2]


def _encoders(family):
    h = WIDTHS[family]
    if family == "digit":
        return (jmnist.DigitEncoder(h, CODE, 3, 1e-3),
                tmnist.DigitEncoder(h, CODE, 3, 1e-3))
    return (jmnist.FashionEncoder(h, CODE, 1e-3),
            tmnist.FashionEncoder(h, CODE, 1e-3))


def _decoders(family):
    h = WIDTHS[family]
    if family == "digit":
        return jmnist.DigitDecoder(h), tmnist.DigitDecoder(h, CODE)
    return jmnist.FashionDecoder(h), tmnist.FashionDecoder(h, CODE)


def _random_params(module, group, seed):
    """Random weights for a port module (Xavier kernels, biases of size
    0.1) and the same weights as a flax tree, through the bridge."""
    g = torch.Generator().manual_seed(seed)
    init_parameters(module, g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
    tree = torch_to_flax({f"{group}.{k}": v
                          for k, v in module.state_dict().items()})
    return module.eval(), tree[group]


@pytest.mark.parametrize("family", ["digit", "fashion"])
def test_encoder_matches_jax(family):
    jenc, tenc = _encoders(family)
    tenc, params = _random_params(tenc, "encoder", 3)
    x = _images()
    want = jax.jit(jenc.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(_nchw(x))
    for g, w in zip(got, want):
        assert g.shape == (4, CODE)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("family", ["digit", "fashion"])
def test_decoder_matches_jax(family):
    jdec, tdec = _decoders(family)
    tdec, params = _random_params(tdec, "decoder", 4)
    z = np.random.default_rng(5).standard_normal((4, CODE)).astype(
        np.float32)
    want = np.asarray(jax.jit(jdec.apply)({"params": params},
                                          jnp.asarray(z)))
    with torch.no_grad():
        got = tdec(torch.tensor(z))
    assert got.shape == (4, 1, 28, 28) and got.dtype == torch.float32
    assert (want > 0).any() and (want == 0).any()   # the relu output
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


@pytest.mark.parametrize("exp", ["mnist_digit", "mnist_fashion"])
def test_ladder_model_tree_and_counts_match_jax(exp):
    """The port's tree has the flax model's keys and shapes (from its
    abstract init), and a tree loaded into it comes back unchanged."""
    cfg = make_config(exp_name=exp, num_hidden_units=64)
    jmodel = jmake(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = LadderModel(cfg, seed=1)
    tree = model.flax_params()
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda a: tuple(a.shape), shapes)
    other = jax.tree.map(lambda a: a + 1.0, tree)
    model.load_flax_params(other)
    jax.tree.map(np.testing.assert_array_equal, model.flax_params(), other)
    assert model.count_params() == jmodel.count_params()


def _pretrained(family):
    ck = ROOT / "pretrained_models" / family
    return {**tck.load_msgpack(ck / "vae-model.msgpack"),
            **tck.load_msgpack(ck / "prior-model.msgpack")}


@pytest.mark.parametrize("family, flat", [
    ("mnist_digit", (4096, 64)), ("mnist_fashion", (1024, 512))])
def test_bridge_round_trips_pretrained_mnist_exactly(family, flat):
    tree = _pretrained(family)
    state = flax_to_torch(tree)
    assert state["encoder.Dense_0.weight"].shape == flat[::-1]
    back = torch_to_flax({k: torch.tensor(v) for k, v in state.items()})
    _assert_same_tree(dict(sorted(back.items())), dict(sorted(tree.items())))


@pytest.mark.parametrize("family, conv, c, s", [
    ("mnist_digit", "Conv_2", 256, 16), ("mnist_fashion", "Conv_3", 256, 4)])
def test_bridge_permutes_the_flattened_dense_rows(family, conv, c, s):
    """The encoder's Dense_0 row s*C + c (NHWC flatten of the last conv's
    map) becomes column c*S + s (NCHW flatten); the decoder's Dense_0 is
    only transposed."""
    tree = _pretrained(family)
    enc = tree["encoder"]
    assert enc[conv]["kernel"].shape[3] == c
    k = enc["Dense_0"]["kernel"]
    w = flax_to_torch(tree)["encoder.Dense_0.weight"]
    for ch in (0, 1, c - 1):
        for sp in (0, s - 1):
            np.testing.assert_array_equal(w[:, ch * s + sp], k[sp * c + ch])
    np.testing.assert_array_equal(flax_to_torch(tree)["decoder.Dense_0.weight"],
                                  tree["decoder"]["Dense_0"]["kernel"].T)


def test_pretrained_digit_model_matches_jax():
    """The pretrained mnist_digit model (h=256, code 16) end to end:
    encode, decode and the inner VAE on the same images and codes."""
    from ladder_tpu.utils.config import process_config

    cfg = process_config(str(ROOT / "demo" / "mnist_digit_config.json"))
    tree = _pretrained("mnist_digit")
    jmodel = jmake(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    model = LadderModel(cfg)
    model.load_flax_params(tree)
    model.eval()
    x = _images(6, seed=7)
    mean, std = jmodel.encode(params, jnp.asarray(x))
    with torch.no_grad():
        tmean, tstd = model.encode(_nchw(x))
        dec = model.decode(tmean)
        t_mean, t_std = model.inner_encode(tmean)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(std), **TOL)
    np.testing.assert_allclose(
        _nhwc(dec), np.asarray(jmodel.decode(params, mean)), **TOL)
    want_t = jmodel.inner_encode(params, mean)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(want_t[0]), **TOL)
    np.testing.assert_allclose(t_std.numpy(), np.asarray(want_t[1]), **TOL)
