"""The port's optimiser (ladder_tpu_torch/training/optim.py, ops/adam.py)
and schedules against ladder_tpu's: TF1 Adam with the +-1 clip inside,
skip_nonfinite, and the five learning-rate schedules. On CPU tensors the
port takes its plain version; the CUDA kernel is held against it on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ladder_tpu.ops.pallas_adam as pa
from ladder_tpu.training import optim as joptim
from ladder_tpu.training import schedules as jsched
from ladder_tpu_torch.ops import adam
from ladder_tpu_torch.training import optim, schedules
from tests.conftest import make_config

TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_pallas.py's, for the TPU kernel
SHAPES = {"conv": (3, 3, 16, 128), "dense": (64, 96), "bias": (77,),
          "scalar": ()}


def _tree(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    # five different gradients, up to 3 sigma in size: the clip acts
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    return params, grads


def test_constants_match():
    assert (optim.ADAM_B1, optim.ADAM_B2, optim.ADAM_EPS) == (
        joptim.ADAM_B1, joptim.ADAM_B2, joptim.ADAM_EPS)


@pytest.mark.parametrize("fused", [False, True])
def test_five_updates_match_jax(fused, monkeypatch):
    """Against clip_grads -> adam_update, and against the Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(pa, "_INTERPRET", True)
    monkeypatch.setattr(pa, "_MIN_FUSED_ELEMS", 1024)
    monkeypatch.setattr(adam.adam_update_, "launches", 0)
    params, grads = _tree(0)
    lr = 2.5e-4
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = joptim.adam_init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = optim.adam_init(tp)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if fused:
            jp, js = pa.adam_update_fused(jg, js, jp, jnp.float32(lr),
                                          joptim.ADAM_B1, joptim.ADAM_B2,
                                          joptim.ADAM_EPS)
        else:
            jp, js = joptim.adam_update(joptim.clip_grads(jg), js, jp,
                                        jnp.float32(lr))
        optim.adam_update({k: torch.tensor(v) for k, v in g.items()}, ts, tp,
                          lr)
    assert ts["t"] == int(js["t"]) == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TOL)
        for moment in ("m", "v"):
            np.testing.assert_allclose(ts[moment][k].numpy(),
                                       np.asarray(js[moment][k]),
                                       err_msg=f"{moment}/{k}", **TOL)
    assert adam.adam_update_.launches == 0 and adam.LIBRARY.loaded is None


@pytest.mark.parametrize("bad, skipped", [(np.nan, True), (np.inf, False),
                                          (-np.inf, False)])
def test_skip_nonfinite_follows_jax(bad, skipped):
    """The guard sees the gradients after the clip, as ladder_tpu's step
    applies it: a NaN drops the whole group update, t included; an infinite
    element clips to +-1 and the update goes through."""
    params, grads = _tree(1)
    g = grads[0]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = joptim.adam_init(jp), optim.adam_init(tp)
    # one good update, one with a single bad element, one good again
    for poison in (False, True, False):
        gs = {k: v.copy() for k, v in g.items()}
        if poison:
            gs["dense"][3, 5] = bad
        jp, js = joptim.adam_update(
            joptim.clip_grads({k: jnp.asarray(v) for k, v in gs.items()}),
            js, jp, jnp.float32(1e-3), skip_nonfinite=True)
        before = {k: v.clone() for k, v in tp.items()}
        optim.adam_update({k: torch.tensor(v) for k, v in gs.items()}, ts,
                          tp, 1e-3, skip_nonfinite=True)
        if poison:
            same = all(torch.equal(tp[k], before[k]) for k in tp)
            assert same == skipped
        assert ts["t"] == int(js["t"])
    assert ts["t"] == (2 if skipped else 3)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
        np.testing.assert_allclose(ts["v"][k].numpy(),
                                   np.asarray(js["v"][k]), **TOL)


def test_without_the_guard_a_nan_spreads():
    tp = {"w": torch.ones(4)}
    ts = optim.adam_init(tp)
    optim.adam_update({"w": torch.tensor([0.0, np.nan, 1.0, 2.0])}, ts, tp,
                      1e-3)
    assert ts["t"] == 1 and torch.isnan(tp["w"][1])
    assert torch.isfinite(tp["w"][[0, 2, 3]]).all()


def test_bias_corrected_lr():
    want = 1e-3 * np.sqrt(1 - 0.95 ** 3) / (1 - 0.9 ** 3)
    assert adam.bias_corrected_lr(1e-3, 3, 0.9, 0.95) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("bad, err", [
    (lambda p, g, m, v: ([], [], [], []), ValueError),
    (lambda p, g, m, v: (p, g[:1], m, v), ValueError),
    (lambda p, g, m, v: (p, [g[0].double(), g[1]], m, v), TypeError),
    (lambda p, g, m, v: (p, [g[0][:1], g[1]], m, v), ValueError),
    (lambda p, g, m, v: ([p[0].T, p[1]], [g[0].T, g[1]], [m[0].T, m[1]],
                         [v[0].T, v[1]]), ValueError),  # not contiguous
])
def test_wrapper_rejects_bad_inputs(bad, err):
    mk = lambda: [torch.zeros(3, 2), torch.zeros(5)]
    with pytest.raises(err):
        adam.adam_update_(*bad(mk(), mk(), mk(), mk()), 1e-3, 1, 0.9, 0.95,
                          1e-8)


@pytest.mark.parametrize("exp_name", ["celeba", "mnist_digit"])
@pytest.mark.parametrize("epoch", [1, 25, 26, 51, 76, 100])
def test_schedules_match_jax(exp_name, epoch):
    cfg = make_config(exp_name=exp_name)
    assert schedules.all_lrs(cfg, epoch) == jsched.all_lrs(cfg, epoch)
    for name in ("lr_ae", "lr_sigma", "lr_prior", "lr_inner_sigma"):
        assert getattr(schedules, name)(cfg, epoch) == getattr(jsched, name)(
            cfg, epoch)
