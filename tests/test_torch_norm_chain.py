"""The port's norm-chain op (ladder_tpu_torch/ops/norm_chain.py), forward
and gradients, against the JAX package's Pallas kernels (interpret mode on
CPU) and its unfused reference. On CPU tensors the wrapper takes the plain
versions and never launches the CUDA kernels; the kernels themselves are
checked against the plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ladder_tpu.ops.pallas_kernels as pk
from ladder_tpu_torch.ops import norm_chain as nc
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

SHAPES = [(2, 2, 2, 16), (2, 8, 8, 16), (2, 4, 8, 8)]  # NHWC, as in JAX


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
    shift = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
    return x, scale, shift


def _port(x, scale, shift, dtype):
    """NHWC numpy -> the port's op on NCHW CPU tensors -> NHWC float32."""
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    y = nc.fused_instnorm_style_lrelu(xt, torch.tensor(scale).to(dtype),
                                      torch.tensor(shift).to(dtype))
    assert y.dtype == dtype
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_matches_pallas_and_reference(shape):
    x, scale, shift = _inputs(shape, seed=sum(shape))
    got = _port(x, scale, shift, torch.float32)
    args = [jnp.asarray(a) for a in (x, scale, shift)]
    for want in (pk.fused_instnorm_style_lrelu(*args),
                 pk.reference_instnorm_style_lrelu(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bfloat16_matches_pallas_and_reference(shape):
    x, scale, shift = _inputs(shape, seed=7 + sum(shape))
    # both packages see the same bf16-rounded inputs
    x, scale, shift = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                       for a in (x, scale, shift))
    got = _port(x, scale, shift, torch.bfloat16)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (x, scale, shift)]
    for want in (pk.fused_instnorm_style_lrelu(*args),
                 pk.reference_instnorm_style_lrelu(*args)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=0.02, atol=0.02)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(nc.fused_instnorm_style_lrelu, "launches", 0)
    x, scale, shift = _inputs((2, 4, 4, 8), seed=3)
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous()
    got = nc.fused_instnorm_style_lrelu(xt, torch.tensor(scale),
                                        torch.tensor(shift))
    want = nc.norm_chain_reference(xt, torch.tensor(scale),
                                   torch.tensor(shift))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert nc.fused_instnorm_style_lrelu.launches == 0
    # the CUDA library was never built or loaded
    assert nc.LIBRARY.loaded is None


def test_plain_version_rounds_once():
    """bf16: statistics and the chain in fp32, one rounding at the end —
    not the unfused composition's intermediate bf16 x_hat."""
    x, scale, shift = _inputs((2, 8, 8, 16), seed=5)
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    st, ht = torch.tensor(scale).bfloat16(), torch.tensor(shift).bfloat16()
    got = nc.norm_chain_reference(xt, st, ht)
    want = nc.norm_chain_reference(xt.float(), st.float(), ht.float())
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("bad, err", [
    (lambda x, s, t: (x[0], s, t), ValueError),                  # rank 3
    (lambda x, s, t: (x.double(), s.double(), t.double()), TypeError),
    (lambda x, s, t: (x, s[:, :-1], t), ValueError),             # width
    (lambda x, s, t: (x, s.bfloat16(), t), TypeError),           # dtype
    (lambda x, s, t: (x[:0], s[:0], t[:0]), ValueError),         # empty
])
def test_wrapper_rejects_bad_inputs(bad, err):
    x = torch.zeros(2, 4, 3, 3)
    s, t = torch.zeros(2, 4), torch.zeros(2, 4)
    with pytest.raises(err):
        nc.fused_instnorm_style_lrelu(*bad(x, s, t))


def test_library_key_follows_source_and_flags(monkeypatch):
    from ladder_tpu_torch.ops._build import BUILD_DIR

    path = nc.LIBRARY.path()
    assert path.parent == BUILD_DIR
    assert path.name.startswith("libnorm_chain_") and path.suffix == ".so"
    assert nc.LIBRARY.path() == path  # stable for the same source and flags
    monkeypatch.setattr(nc.LIBRARY, "flags", nc.LIBRARY.flags + ("-lineinfo",))
    assert nc.LIBRARY.path() != path


def _port_grads(x, scale, shift, cot, dtype):
    """Gradients of sum(y * cot) through the port's op, back in NHWC."""
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    st, ht = torch.tensor(scale).to(dtype), torch.tensor(shift).to(dtype)
    for t in (xt, st, ht):
        t.requires_grad_(True)
    y = nc.fused_instnorm_style_lrelu(xt, st, ht)
    ct = torch.tensor(cot).permute(0, 3, 1, 2).to(dtype)
    gx, gs, gh = torch.autograd.grad(y, (xt, st, ht), ct)
    assert gx.dtype == gs.dtype == gh.dtype == dtype
    return (gx.float().permute(0, 2, 3, 1).numpy(), gs.float().numpy(),
            gh.float().numpy())


def _jax_grads(fn, x, scale, shift, cot, dtype):
    args = [jnp.asarray(a, dtype) for a in (x, scale, shift)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(cot, dtype))]


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_gradients_match_pallas_vjp(shape):
    """fp32: rtol 2e-4 / atol 2e-5, the tolerance of the JAX package's own
    backward test (sums over the plane in another order)."""
    x, scale, shift = _inputs(shape, seed=11 + sum(shape))
    cot = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    got = _port_grads(x, scale, shift, cot, torch.float32)
    for fn in (pk.fused_instnorm_style_lrelu,
               pk.reference_instnorm_style_lrelu):
        want = _jax_grads(fn, x, scale, shift, cot, jnp.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_bfloat16_gradients_match_pallas_vjp():
    """bf16: both compute in fp32 from the same bf16 inputs and round at the
    end, so they agree within a band of bf16 roundings (2 ulp = 2**-7
    relative, plus 0.02 absolute for the sums over the plane)."""
    shape = (2, 8, 8, 16)
    x, scale, shift = _inputs(shape, seed=13)
    cot = np.random.default_rng(14).standard_normal(shape).astype(np.float32)
    x, scale, shift, cot = (
        np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        for a in (x, scale, shift, cot))
    got = _port_grads(x, scale, shift, cot, torch.bfloat16)
    want = _jax_grads(pk.fused_instnorm_style_lrelu, x, scale, shift, cot,
                      jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=0.02)


def test_backward_plain_version_equals_autograd():
    """The explicit backward the kernel is held against on the card equals
    autograd through the plain forward."""
    x, scale, shift = _inputs((2, 6, 6, 8), seed=15)
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    ht = torch.tensor(shift).requires_grad_(True)
    g = torch.tensor(np.random.default_rng(16).standard_normal(
        xt.shape).astype(np.float32))
    want = torch.autograd.grad(nc.norm_chain_reference(xt, st, ht),
                               (xt, st, ht), g)
    got = nc.norm_chain_bwd_reference(g, xt.detach(), st.detach(),
                                      ht.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_backward_on_cpu_launches_nothing(monkeypatch):
    monkeypatch.setattr(nc.norm_chain_backward, "launches", 0)
    x, scale, shift = _inputs((2, 4, 4, 8), seed=17)
    _port_grads(x, scale, shift, np.ones_like(x), torch.float32)
    assert nc.norm_chain_backward.launches == 0
    assert nc.LIBRARY.loaded is None
