"""The port's norm-chain op (ladder_tpu_torch/ops/norm_chain.py) against the
JAX package's Pallas kernel (interpret mode on CPU) and its unfused
reference. On CPU tensors the wrapper takes the plain version and never
launches the CUDA kernel; the kernel itself is checked against the plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ladder_tpu.ops.pallas_kernels as pk
from ladder_tpu_torch.ops import norm_chain as nc

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
    assert nc._lib is None  # the CUDA library was never built or loaded


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
    path = nc.library_path()
    assert path.parent == nc.BUILD_DIR
    assert path.name.startswith("libnorm_chain_") and path.suffix == ".so"
    assert nc.library_path() == path  # stable for the same source and flags
    monkeypatch.setattr(nc, "NVCC_FLAGS", nc.NVCC_FLAGS + ("-lineinfo",))
    assert nc.library_path() != path
