"""Shared NN building blocks, NCHW.

The port of ``ladder_tpu/models/layers.py``. Modules keep the flax names of
their parameters' owners so the weight bridge (utils/weights.py) maps
checkpoints by name. Parameters are stored in float32; ``dtype`` is the
computation dtype (None = float32, or torch.bfloat16 for the conv and dense
stacks), as flax's ``dtype`` / ``param_dtype`` split.

Initialisation is Xavier-uniform for kernels, zeros for biases, ones/zeros
for BatchNorm scale/offset (``init_parameters``), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu
from ladder_tpu_torch.parallel.mesh import all_reduce_sum, sharded


def leaky_relu(x):
    """TF's tf.nn.leaky_relu slope 0.2 (torch's default is 0.01)."""
    return F.leaky_relu(x, negative_slope=0.2)


def get_activation(name):
    """Resolve config['inner_activation']."""
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    if name == "leaky_relu":
        return leaky_relu
    raise ValueError(f"unknown activation: {name}")


def _xavier_(weight, generator):
    if weight.dim() == 4:
        o, i, kh, kw = weight.shape
        fan_in, fan_out = i * kh * kw, o * kh * kw
    else:
        fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-a, a, generator=generator)


class Dense(nn.Module):
    """Affine layer; weight [out, in]."""

    def __init__(self, in_features, features, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.dtype or torch.float32
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _same_pads(size, k, s):
    """TF 'SAME' (before, after) padding of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with TF padding semantics; weight [out, in, k, k].

    TF 'SAME' with stride 2 on an even input pads 0 before and 1 after
    (torch refuses padding='same' with stride 2), so uneven pads are
    applied explicitly."""

    def __init__(self, in_channels, features, kernel_size, strides=1,
                 padding="SAME", dtype=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.dtype = dtype
        self.k, self.s, self.padding = kernel_size, strides, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.dtype or torch.float32
        x = x.to(dt)
        pad = 0
        if self.padding == "SAME":
            ph = _same_pads(x.shape[2], self.k, self.s)
            pw = _same_pads(x.shape[3], self.k, self.s)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt),
                        stride=self.s, padding=pad)


class StyleMod(nn.Module):
    """The decoder's whole instance_norm -> style modulation -> leaky_relu
    chain. (scale, shift) = Dense(dlatent, 2C): the first C columns are the
    scale, the next C the shift, cast to the activation dtype; the chain is
    the fused norm-chain op (the kernel on CUDA tensors)."""

    def __init__(self, dlatent_size, channels, dtype=None):
        super().__init__()
        self.style = Dense(dlatent_size, 2 * channels, dtype=dtype)

    def forward(self, x, dlatent):
        c = x.shape[1]
        style = self.style(dlatent).reshape(-1, 2, c).to(x.dtype)
        return fused_instnorm_style_lrelu(x, style[:, 0].contiguous(),
                                          style[:, 1].contiguous())


class BatchNormTrain(nn.Module):
    """Batch normalisation with batch statistics (tf.layers.batch_normalization
    (training=True), epsilon 1e-3), statistics in fp32. frozen=True
    (serving only) normalises with fixed population statistics set by
    ``set_stats`` instead. With a data mesh set (``set_batchnorm_mesh``)
    and sharded, the statistics are those of the global batch, in float32,
    as ``ladder_tpu``'s under GSPMD: the channel sums are all-reduced, the
    mean first, then the centred squares, inside the autograd graph."""

    def __init__(self, channels, epsilon=1e-3, frozen=False):
        super().__init__()
        self.epsilon = epsilon
        self.frozen = frozen
        self.mesh = None
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels), persistent=False)
        self.register_buffer("var", torch.ones(channels), persistent=False)

    def set_stats(self, mean, var):
        with torch.no_grad():
            self.mean.copy_(torch.as_tensor(mean))
            self.var.copy_(torch.as_tensor(var))

    def forward(self, x):
        xf = x.float()
        mesh = sharded(self.mesh)
        if self.frozen:
            mean, var = self.mean, self.var
        elif mesh is not None:
            count = xf.numel() // xf.shape[1] * mesh.world
            mean = all_reduce_sum(xf.sum(dim=(0, 2, 3)), mesh) / count
            var = all_reduce_sum(
                (xf - mean[None, :, None, None]).square().sum(dim=(0, 2, 3)),
                mesh) / count
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        y = (xf - mean[None, :, None, None]) * inv[None, :, None, None]
        y = y * self.gamma[None, :, None, None] + self.beta[None, :, None, None]
        return y.to(x.dtype)


def set_batchnorm_mesh(module, mesh):
    """Give every BatchNormTrain under ``module`` the data mesh (None: local
    statistics)."""
    for m in module.modules():
        if isinstance(m, BatchNormTrain):
            m.mesh = mesh


def init_parameters(module, generator):
    """Xavier-uniform kernels, zero biases, BatchNorm ones/zeros."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            _xavier_(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, BatchNormTrain):
            with torch.no_grad():
                m.gamma.fill_(1.0)
                m.beta.zero_()
