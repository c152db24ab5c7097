"""The port's FC-DenseNet blocks (ladder_tpu_torch/models/densenet.py)
against ladder_tpu's: the shapes of tests/test_densenet.py, then the values
with ladder_tpu's flax variables bridged in (utils/weights.py:
flax_variables_to_torch), in inference mode (running statistics) and in
training mode (batch statistics and the running averages' update; dropout
off on both sides: the streams cannot match), within 1e-5. Dropout itself
is held to its rate and its scaling."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ladder_tpu.models import densenet as J
from ladder_tpu_torch.models import densenet as T
from ladder_tpu_torch.utils.weights import (
    flax_variables_to_torch,
    torch_to_flax_variables,
)
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

TOL = 1e-5
# (name, jax module, port module, input NHWC, output NHWC)
CASES = {
    "conv_layer": (lambda: J.ConvLayer(16), lambda: T.ConvLayer(4, 16),
                   (2, 8, 8, 4), (2, 8, 8, 16)),
    "dense_block": (lambda: J.DenseBlock(layers_per_block=(3,), block_nb=0,
                                         growth_k=5),
                    lambda: T.DenseBlock(4, (3,), 0, 5),
                    (2, 8, 8, 4), (2, 8, 8, 15)),
    "transition_down": (lambda: J.TransitionDown(6),
                        lambda: T.TransitionDown(12, 6),
                        (2, 8, 8, 12), (2, 4, 4, 6)),
    "transition_up": (lambda: J.TransitionUp(3), lambda: T.TransitionUp(6, 3),
                      (2, 4, 4, 6), (2, 8, 8, 3)),
}


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _variables(name):
    """ladder_tpu's module and its initial variables (jitted: eager flax
    dispatches, and compiles, op by op)."""
    jm = CASES[name][0]()
    x = jnp.zeros(CASES[name][2], jnp.float32)
    if name == "transition_up":
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    else:
        variables = jax.jit(jm.init, static_argnums=2)(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, True)
    return jm, jax.tree.map(np.asarray, variables)


def _both(name, x):
    """(jax module, its variables, port module with them loaded)."""
    jm, variables = _variables(name)
    tm = CASES[name][1]()
    if "batch_stats" in variables:
        # running statistics away from their init, so inference mode
        # tests them
        rng = np.random.default_rng(3)
        variables = dict(variables)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        flax_variables_to_torch(variables).items()},
                       strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_shapes(name):
    """tests/test_densenet.py's four shape checks, on the port."""
    _, tmake, shape_in, shape_out = CASES[name]
    x = torch.tensor(_inputs(shape_in)).permute(0, 3, 1, 2)
    module = tmake()
    y = module(x) if name == "transition_up" else module(
        x, training=True, generator=torch.Generator().manual_seed(0))
    assert tuple(_nhwc(y).shape) == shape_out
    assert np.isfinite(_nhwc(y)).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_inference_matches_ladder_tpu(name):
    x = _inputs(CASES[name][2])
    jm, variables, tm = _both(name, x)
    if name == "transition_up":
        want, got = jax.jit(jm.apply)(variables, x), tm(_nchw(x))
    else:
        want = jax.jit(jm.apply, static_argnums=2)(variables, x, False)
        got = tm(_nchw(x), training=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL,
                               atol=TOL)
    back = torch_to_flax_variables(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["conv_layer", "dense_block",
                                  "transition_down"])
def test_training_matches_ladder_tpu(name, monkeypatch):
    """Batch statistics and the running averages' update, dropout off."""
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, *a, **kw: x)
    x = _inputs(CASES[name][2], seed=1)
    jm, variables, tm = _both(name, x)
    for m in tm.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    want, updated = jax.jit(
        lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
            variables, x)
    got = tm(_nchw(x), training=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL,
                               atol=TOL)
    stats = torch_to_flax_variables(tm.state_dict())["batch_stats"]
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(jax.tree.map(np.asarray, updated))):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_dropout_rate_and_scale():
    x = torch.ones(1, 4, 64, 64)
    layer = T.ConvLayer(4, 4)
    with torch.no_grad():
        layer.Conv_0.weight.zero_()
        layer.Conv_0.bias.fill_(1.0)
    with torch.no_grad():
        y = layer(x, training=True,
                  generator=torch.Generator().manual_seed(0))
        inference = layer(x, training=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.8, rtol=1e-6)
    assert torch.equal(inference, torch.ones_like(x))
