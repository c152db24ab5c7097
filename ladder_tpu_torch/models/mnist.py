"""Outer VAE architectures for MNIST digit and fashion, NCHW.

The port of ``ladder_tpu/models/mnist.py``. Submodules carry the flax
names (``Conv_0``.., ``Dense_0``, ``code_mean``, ``code_std_dev``), so the
weight bridge maps checkpoints by name. The encoders flatten their last
conv map in NCHW order, where ``ladder_tpu`` flattens NHWC: the bridge
permutes the rows of the encoder's ``Dense_0`` kernel (and of its Adam
moments) to match (utils/weights.py). The decoders' ``Dense_0`` feeds a
1x1 map, whose order is the same in both layouts; the channel order after
it lives in ``depth_to_space`` (TF's DCR order, ops/image.py).

Both std-dev heads keep ``ladder_tpu``'s relu parameterisation:
std = relu(dense(h)) + latent_variance_precision. The decoders end in a
relu 5x5 VALID conv (not a sigmoid) computed in float32 whatever the
compute dtype, as the flax conv without a dtype is.
"""

from __future__ import annotations

import torch
from torch import nn

from ladder_tpu_torch.models.layers import Conv, Dense, leaky_relu
from ladder_tpu_torch.ops.image import depth_to_space, pad_symmetric


class _Encoder(nn.Module):
    """pad_symmetric(2) -> leaky convs -> NCHW flatten -> leaky Dense_0 ->
    float32 heads. ``convs``: (in, out, kernel, stride, padding) per conv;
    ``flat``: the flattened width; ``hidden``: Dense_0's width."""

    def __init__(self, convs, flat, hidden, code_size,
                 latent_variance_precision, dtype):
        super().__init__()
        self.dtype = dtype
        self.latent_variance_precision = latent_variance_precision
        self.n_convs = len(convs)
        for i, (cin, cout, k, s, pad) in enumerate(convs):
            setattr(self, f"Conv_{i}",
                    Conv(cin, cout, k, strides=s, padding=pad, dtype=dtype))
        self.Dense_0 = Dense(flat, hidden, dtype=dtype)
        self.code_mean = Dense(hidden, code_size)
        self.code_std_dev = Dense(hidden, code_size)

    def forward(self, x):
        x = pad_symmetric(x, 2, 2)                          # 28 -> 32
        for i in range(self.n_convs):
            x = leaky_relu(getattr(self, f"Conv_{i}")(x))
        x = leaky_relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = x.float()  # heads in float32: the posterior scales feed logs
        mean = self.code_mean(x)
        std = torch.relu(self.code_std_dev(x))
        return mean, std + self.latent_variance_precision


class DigitEncoder(_Encoder):
    """[B,1,28,28] -> (code_mean, code_std), each [B, code_size]; the
    flattened map is [B, h, 4, 4] (``ladder_tpu/models/mnist.py:42``)."""

    def __init__(self, num_hidden_units, code_size, kernel_size=3,
                 latent_variance_precision=1e-3, dtype=None):
        h, k = num_hidden_units, kernel_size
        convs = [(1, h // 16, k, 2, "SAME"),                # 16x16
                 (h // 16, h // 4, k, 2, "SAME"),           # 8x8
                 (h // 4, h, k, 2, "SAME")]                 # 4x4
        super().__init__(convs, 16 * h, h // 4, code_size,
                         latent_variance_precision, dtype)


class FashionEncoder(_Encoder):
    """Four convs and Dense_0 of width h; the flattened map is
    [B, h/2, 2, 2] (``ladder_tpu/models/mnist.py:88``)."""

    def __init__(self, num_hidden_units, code_size,
                 latent_variance_precision=1e-3, dtype=None):
        h = num_hidden_units
        convs = [(1, h // 4, 3, 2, "SAME"),                 # 16x16
                 (h // 4, h // 4, 3, 2, "SAME"),            # 8x8
                 (h // 4, h // 2, 3, 2, "SAME"),            # 4x4
                 (h // 2, h // 2, 3, 1, "VALID")]           # 2x2
        super().__init__(convs, 4 * (h // 2), h, code_size,
                         latent_variance_precision, dtype)


class _Decoder(nn.Module):
    """leaky Dense_0 -> 1x1 map -> [depth_to_space -> leaky conv]* ->
    depth_to_space -> relu 5x5 VALID conv to one channel, float32.
    ``stages``: (block, in, out, kernel) per leaky conv; ``last_in``: the
    final conv's input channels; ``first_block``: the first
    depth_to_space's block size."""

    def __init__(self, code_size, width, first_block, stages, last_in,
                 dtype):
        super().__init__()
        self.dtype = dtype
        self.first_block = first_block
        self.Dense_0 = Dense(code_size, width, dtype=dtype)
        self.blocks = [r for r, _, _, _ in stages]
        for i, (_, cin, cout, k) in enumerate(stages):
            setattr(self, f"Conv_{i}", Conv(cin, cout, k, dtype=dtype))
        setattr(self, f"Conv_{len(stages)}",
                Conv(last_in, 1, 5, padding="VALID"))

    def forward(self, z):
        x = leaky_relu(self.Dense_0(z))
        x = depth_to_space(x.reshape(x.shape[0], -1, 1, 1), self.first_block)
        n = len(self.blocks)
        for i in range(n):
            x = leaky_relu(getattr(self, f"Conv_{i}")(x))
            x = depth_to_space(x, self.blocks[i])
        return torch.relu(getattr(self, f"Conv_{n}")(x)).float()


class DigitDecoder(_Decoder):
    """[B, code_size] -> [B,1,28,28]: 4x4xh, 8x8xh/4, 16x16xh/16,
    32x32xh/64, then the 5x5 VALID conv."""

    def __init__(self, num_hidden_units, code_size, dtype=None):
        h = num_hidden_units
        stages = [(2, h, h, 3), (2, h // 4, h // 4, 3),
                  (2, h // 16, h // 16, 3)]
        super().__init__(code_size, 16 * h, 4, stages, h // 64, dtype)


class FashionDecoder(_Decoder):
    """[B, code_size] -> [B,1,28,28]: a depth_to_space(2) + conv pyramid
    from 1x1xh to 32x32xh/4, then the 5x5 VALID conv."""

    def __init__(self, num_hidden_units, code_size, dtype=None):
        h = num_hidden_units
        stages = [(2, h // 4, h, 1)] + [(2, h // 4, h, 3)] * 3
        super().__init__(code_size, h, 2, stages, h // 4, dtype)
