"""FC-DenseNet (Tiramisu) building blocks, NCHW (the port of
``ladder_tpu/models/densenet.py``).

The reference vendors these helpers (its codes/modules.py:13-138) and never
calls them from its models; ``ladder_tpu`` keeps them for users who extend
the framework with segmentation-style decoders, and so does the port. No
path of the trainers or the engine runs them.

  * ConvLayer       - BN -> relu -> 3x3 conv -> dropout
  * DenseBlock      - growth-rate concatenating block
  * TransitionDown  - BN -> relu -> 1x1 conv -> dropout -> 2x2 max-pool
  * TransitionUp    - 3x3 stride-2 transposed conv

As flax's modules they stand in for: BatchNorm without a scale (a bias
only), momentum 0.999, epsilon 1e-3, batch statistics in training with the
running averages updated, the running averages otherwise; the variance as
flax computes it (E[x^2] - E[x]^2, clipped at 0); dropout 0.2 (kept
elements scaled by 1/0.8), drawn from the generator the caller passes;
max-pool and the convs with SAME padding; the transposed conv as
``lax.conv_transpose`` computes it with its kernel as given (not flipped):
the input dilated by the stride, padded (2, 1) on each spatial axis, and
correlated with the kernel. He (variance-scaling, truncated normal)
kernels, zero biases. Module and parameter names are flax's, so
utils/weights.py:flax_variables_to_torch maps a flax variable tree
({params, batch_stats}) onto the state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _he_(weight, generator=None):
    """variance_scaling(2.0, 'fan_in', 'truncated_normal') on an OIHW
    kernel: a normal truncated at two standard deviations, scaled so the
    truncated variance is 2 / fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class _Conv(nn.Module):
    """A SAME-padded stride-1 conv with flax's parameter names (the weight
    in OIHW)."""

    def __init__(self, in_ch, out_ch, k, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _he_(self.weight, generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding="same")


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_scale=False, momentum=0.999, epsilon=1e-3)``
    over NCHW's channel axis, statistics in float32."""

    def __init__(self, channels, momentum=0.999, epsilon=1e-3):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, training=True):
        xf = x.float()
        if training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp(xf.square().mean(dim=(0, 2, 3))
                              - mean.square(), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum)
                                                   * mean.detach())
                self.var.mul_(self.momentum).add_((1 - self.momentum)
                                                  * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (xf - mean[None, :, None, None]) * torch.rsqrt(
            var + self.epsilon)[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


def _dropout(x, rate, training, generator):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device if generator is not None
                      else x.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class ConvLayer(nn.Module):
    """BN -> relu -> conv3x3 -> dropout (modules.py:31-58)."""

    def __init__(self, in_ch, filters, dropout_rate=0.2, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = _Conv(in_ch, filters, 3, generator)

    def forward(self, x, training=True, generator=None):
        x = torch.relu(self.BatchNorm_0(x, training))
        x = self.Conv_0(x)
        return _dropout(x, self.dropout_rate, training, generator)


class DenseBlock(nn.Module):
    """Concatenating dense block: each layer adds growth_k channels; the
    block output concatenates the per-layer features (modules.py:61-86)."""

    def __init__(self, in_ch, layers_per_block, block_nb, growth_k,
                 dropout_rate=0.2, generator=None):
        super().__init__()
        self.n_layers = layers_per_block[block_nb]
        for i in range(self.n_layers):
            setattr(self, f"layer_{i}",
                    ConvLayer(in_ch + i * growth_k, growth_k, dropout_rate,
                              generator))

    def forward(self, x, training=True, generator=None):
        dense_out = []
        for i in range(self.n_layers):
            conv = getattr(self, f"layer_{i}")(x, training, generator)
            x = torch.cat([conv, x], dim=1)
            dense_out.append(conv)
        return torch.cat(dense_out, dim=1)


class TransitionDown(nn.Module):
    """BN relu conv1x1 dropout maxpool2x2 (modules.py:89-116)."""

    def __init__(self, in_ch, filters, dropout_rate=0.2, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = _Conv(in_ch, filters, 1, generator)

    def forward(self, x, training=True, generator=None):
        x = torch.relu(self.BatchNorm_0(x, training))
        x = _dropout(self.Conv_0(x), self.dropout_rate, training, generator)
        # SAME max-pool: an odd edge is padded with -inf
        x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2),
                  value=float("-inf"))
        return F.max_pool2d(x, 2, 2)


class TransitionUp(nn.Module):
    """3x3 stride-2 SAME transposed conv (modules.py:119-138), as
    ``lax.conv_transpose`` computes it (module docstring)."""

    def __init__(self, in_ch, filters, generator=None):
        super().__init__()
        self.ConvTranspose_0 = _Conv(in_ch, filters, 3, generator)

    def forward(self, x):
        b, c, h, w = x.shape
        dilated = x.new_zeros(b, c, 2 * h - 1, 2 * w - 1)
        dilated[:, :, ::2, ::2] = x
        dilated = F.pad(dilated, (2, 1, 2, 1))
        conv = self.ConvTranspose_0
        return F.conv2d(dilated, conv.weight, conv.bias)
