"""The port's fused output stage (ladder_tpu_torch/ops/output_stage.py)
against the JAX package's Pallas kernels (ops/pallas_output.py, interpret
mode on CPU): forward and gradients, float32 and bfloat16, with the layouts
converted as the weight bridge converts them (NHWC <-> NCHW, Conv_8's
[1,1,C,Co] kernel <-> [Co,C]). On CPU tensors the port takes its plain
versions; the CUDA kernels are held against those on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ladder_tpu.ops.pallas_output as po
from ladder_tpu_torch.ops import output_stage as ost
from ladder_tpu_torch.utils.weights import flax_to_torch, torch_to_flax
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(po, "_INTERPRET", True)


def _inputs(shape, seed, dtype):
    """NHWC numpy inputs, u already rounded to the working dtype."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    u = np.asarray(jnp.asarray(rng.standard_normal(shape), DTYPES[dtype][0]),
                   np.float32)
    kernel = (rng.standard_normal((1, 1, c, 3)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(3) * 0.1).astype(np.float32)
    target = rng.random((b, h, w, 3)).astype(np.float32)
    return u, kernel, bias, target


def _nchw(a, dtype=torch.float32):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _port_args(u, kernel, bias, target, dtype):
    state = flax_to_torch({"Conv_8": {"kernel": kernel, "bias": bias}})
    weight = torch.tensor(state["Conv_8.weight"]).reshape(3, -1)
    return (_nchw(u, DTYPES[dtype][1]), weight,
            torch.tensor(state["Conv_8.bias"]), _nchw(target))


def _jax_args(u, kernel, bias, target, dtype):
    return (jnp.asarray(u, DTYPES[dtype][0]), jnp.asarray(kernel),
            jnp.asarray(bias), jnp.asarray(target))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 12, 4, 8)])
def test_forward_matches_pallas(dtype, shape):
    """dec rtol/atol 1e-6 and the sums rtol 1e-5, as the JAX package holds
    its kernel to the explicit path; in bf16 dec may differ by a rounding
    that flips (one bf16 ulp, 2**-8 relative) on a few elements."""
    args = _inputs(shape, seed=sum(shape), dtype=dtype)
    dec, l1, l2 = ost.fused_output_recon(*_port_args(*args, dtype))
    jdec, jl1, jl2 = po.fused_output_recon(*_jax_args(*args, dtype))
    assert dec.dtype == torch.float32 and dec.shape == (shape[0], 3) + shape[1:3]
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(_nhwc(dec), np.asarray(jdec), rtol=tol,
                               atol=tol)
    sum_tol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(l1), float(jl1), rtol=sum_tol)
    np.testing.assert_allclose(float(l2), float(jl2), rtol=sum_tol)


@pytest.mark.parametrize("with_ddec", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_pallas(dtype, with_ddec):
    """Gradients w.r.t. u, W8, b8 with every output's cotangent, and with
    decoded's absent as in the train step: rtol 2e-2 / atol 2e-5, the JAX
    package's own gradient tolerance (tests/test_pallas_output.py), which in
    float32 this test tightens to rtol 1e-5 / atol 1e-5."""
    shape = (2, 8, 8, 16)
    u, kernel, bias, target = _inputs(shape, seed=1, dtype=dtype)

    def jscalar(u_, k_, b_):
        dec, l1, l2 = po.fused_output_recon(u_, k_, b_, jnp.asarray(target))
        out = 0.7 * l1 + 0.3 * l2
        return out + jnp.sum(dec * 0.01) if with_ddec else out

    ju, jk, jb, _ = _jax_args(u, kernel, bias, target, dtype)
    want = jax.grad(jscalar, argnums=(0, 1, 2))(ju, jk, jb)

    tu, tw, tb, tt = _port_args(u, kernel, bias, target, dtype)
    for t in (tu, tw, tb):
        t.requires_grad_(True)
    dec, l1, l2 = ost.fused_output_recon(tu, tw, tb, tt)
    out = 0.7 * l1 + 0.3 * l2
    if with_ddec:
        out = out + (dec * 0.01).sum()
    gu, gw, gb = torch.autograd.grad(out, (tu, tw, tb))
    assert gu.dtype == tu.dtype and gw.dtype == gb.dtype == torch.float32
    gk = torch_to_flax({"Conv_8.weight": gw.reshape(3, -1, 1, 1)})[
        "Conv_8"]["kernel"]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-5)
    np.testing.assert_allclose(_nhwc(gu), np.asarray(want[0], np.float32),
                               **tol)
    np.testing.assert_allclose(gk, np.asarray(want[1]), **tol)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want[2]), **tol)


def test_target_gradient_matches_pallas():
    u, kernel, bias, target = _inputs((2, 8, 8, 16), seed=2, dtype="float32")
    ju, jk, jb, jt = _jax_args(u, kernel, bias, target, "float32")

    def jscalar(t):
        _, l1, l2 = po.fused_output_recon(ju, jk, jb, t)
        return 0.7 * l1 + 0.3 * l2

    want = np.asarray(jax.grad(jscalar)(jt))
    tu, tw, tb, tt = _port_args(u, kernel, bias, target, "float32")
    tt.requires_grad_(True)
    _, l1, l2 = ost.fused_output_recon(tu, tw, tb, tt)
    (got,) = torch.autograd.grad(0.7 * l1 + 0.3 * l2, (tt,))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_equals_autograd_of_plain_forward(dtype):
    """The explicit backward the kernel is held against on the card equals
    autograd through the plain forward (float32 exactly the same function;
    bf16 within the roundings of the two products' operands)."""
    u, kernel, bias, target = _inputs((2, 6, 6, 8), seed=3, dtype=dtype)
    tu, tw, tb, tt = _port_args(u, kernel, bias, target, dtype)
    for t in (tu, tw, tb):
        t.requires_grad_(True)
    dec, l1, l2 = ost.output_recon_reference(tu, tw, tb, tt)
    want = torch.autograd.grad(0.03 * l1 + 0.01 * l2, (tu, tw, tb))
    got = ost.output_recon_bwd_reference(
        tu.detach(), tw.detach(), dec.detach(), tt, torch.tensor(0.03),
        torch.tensor(0.01))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2e-2, atol=1e-3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_sign_of_zero_is_zero():
    """target == decoded contributes no l1 gradient (jnp.sign(0) = 0)."""
    u = torch.zeros(1, 4, 2, 2)
    weight, bias = torch.ones(3, 4), torch.full((3,), 0.25)
    target = torch.full((1, 3, 2, 2), 0.25)
    dec, l1, l2 = ost.output_recon_reference(u, weight, bias, target)
    assert float(l1) == 0.0
    du, dw, db = ost.output_recon_bwd_reference(
        u, weight, dec, target, torch.tensor(1.0), torch.tensor(0.0))
    assert not du.any() and not dw.any() and not db.any()


def test_cpu_takes_the_plain_versions(monkeypatch):
    monkeypatch.setattr(ost.fused_output_recon, "launches", 0)
    monkeypatch.setattr(ost.output_recon_backward, "launches", 0)
    args = _port_args(*_inputs((2, 4, 4, 8), seed=4, dtype="float32"),
                      "float32")
    args[0].requires_grad_(True)
    got = ost.fused_output_recon(*args)
    want = ost.output_recon_reference(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got[1].backward()
    assert ost.fused_output_recon.launches == 0
    assert ost.output_recon_backward.launches == 0
    assert ost.LIBRARY.loaded is None


@pytest.mark.parametrize("bad, err", [
    (lambda u, w, b, t: (u[0], w, b, t), ValueError),              # rank 3
    (lambda u, w, b, t: (u.double(), w, b, t), TypeError),
    (lambda u, w, b, t: (u, w[:2], b, t), ValueError),             # Co != 3
    (lambda u, w, b, t: (u, w.bfloat16(), b, t), TypeError),
    (lambda u, w, b, t: (u, w, b, t[:, :, :-1]), ValueError),
    (lambda u, w, b, t: (u[:0], w, b, t[:0]), ValueError),         # empty
])
def test_wrapper_rejects_bad_inputs(bad, err):
    args = (torch.zeros(2, 4, 3, 3), torch.zeros(3, 4), torch.zeros(3),
            torch.zeros(2, 3, 3, 3))
    with pytest.raises(err):
        ost.fused_output_recon(*bad(*args))
