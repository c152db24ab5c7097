"""CelebA-128 outer VAE, NCHW: BN-conv pyramid encoder + style-modulated
decoder.

The port of ``ladder_tpu/models/celeba.py``. The encoder is 6x
[conv -> batch_norm -> leaky_relu] (128->64->32->16->8->4-> valid), with
batch statistics unless frozen for serving. The decoder maps z through an
8-layer MLP "dlatent" network and a conv/resize pyramid with four
instance_norm + style modulation + leaky_relu stages; bilinear resizes use
TF1 legacy coordinates. It returns the raw (unclipped) decoder output.

The four style stages always go through ``fused_instnorm_style_lrelu``
(ops/norm_chain.py): the hand-written kernel on CUDA tensors, its plain
version on CPU tensors. ``use_pallas`` is accepted for config
compatibility but chooses no path; dispatch is by device. Each [2x resize
-> 3x3 conv] pair is computed as the explicit resize and conv, whatever
config['fuse_upsample_conv'] says; that equals ``ladder_tpu``'s fused
lhs-dilated form up to float rounding, and both read the same checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from ladder_tpu_torch.models.layers import (
    BatchNormTrain,
    Conv,
    Dense,
    StyleMod,
    leaky_relu,
)
from ladder_tpu_torch.ops.image import conv3x3_up2x_tf1, resize_bilinear_tf1


class CelebAEncoder(nn.Module):
    """[B,3,128,128] -> (code_mean, code_std), each [B, code_size]."""

    def __init__(self, num_hidden_units, code_size, kernel_size=3,
                 latent_variance_precision=1e-3, dtype=None, bn_frozen=False,
                 image_size=128, in_channels=3):
        super().__init__()
        h, k = num_hidden_units, kernel_size
        self.dtype = dtype
        self.bn_frozen = bn_frozen
        self.latent_variance_precision = latent_variance_precision
        widths = [h // 4, h // 4, h // 2, h // 2, h]
        cin, size = in_channels, image_size
        for i, w in enumerate(widths):                     # 128->64->...->4
            setattr(self, f"Conv_{i}", Conv(cin, w, k, strides=2, dtype=dtype))
            setattr(self, f"BatchNormTrain_{i}",
                    BatchNormTrain(w, frozen=bn_frozen))
            cin, size = w, -(-size // 2)
        self.Conv_5 = Conv(h, h, k, padding="VALID", dtype=dtype)
        self.BatchNormTrain_5 = BatchNormTrain(h, frozen=bn_frozen)
        flat = h * (size - k + 1) ** 2
        self.code_mean = Dense(flat, code_size)
        self.code_std_dev = Dense(flat, code_size)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(6):
            x = getattr(self, f"Conv_{i}")(x)
            x = leaky_relu(getattr(self, f"BatchNormTrain_{i}")(x))
        x = x.reshape(x.shape[0], -1).float()              # NCHW flatten
        mean = self.code_mean(x)
        std = torch.relu(self.code_std_dev(x))
        return mean, std + self.latent_variance_precision


class UpConvTF1(Conv):
    """[TF1 bilinear 2x upsample -> SAME 3x3 conv]; the parameters are a
    plain 3x3 conv's."""

    def __init__(self, in_channels, features, dtype=None):
        super().__init__(in_channels, features, 3, dtype=dtype)

    def forward(self, x):
        dt = self.dtype or x.dtype
        return conv3x3_up2x_tf1(x.to(dt), self.weight.to(dt),
                                self.bias.to(dt))


class CelebADecoder(nn.Module):
    """[B, code_size] -> [B,3,128,128] (unclipped, float32)."""

    def __init__(self, num_hidden_units, code_size, dtype=None,
                 use_pallas=False):
        super().__init__()
        h = num_hidden_units
        self.dtype = dtype
        self.use_pallas = use_pallas  # no effect: dispatch is by device
        self.Dense_0 = Dense(code_size, h, dtype=dtype)
        for i in range(8):
            setattr(self, f"dlatent_{i}", Dense(h, h, dtype=dtype))
        self.Conv_0 = Conv(h, h, 1, dtype=dtype)
        self.Conv_1 = Conv(h, h, 3, dtype=dtype)
        self.Conv_2 = Conv(h, h, 3, dtype=dtype)
        self.Conv_3 = Conv(h, h, 3, dtype=dtype)
        self.Conv_4 = UpConvTF1(h, h // 2, dtype=dtype)
        self.Conv_5 = UpConvTF1(h // 2, h // 2, dtype=dtype)
        self.Conv_6 = UpConvTF1(h // 2, h // 4, dtype=dtype)
        self.Conv_7 = UpConvTF1(h // 4, h // 4, dtype=dtype)
        self.Conv_8 = Conv(h // 4, 3, 1, dtype=dtype)
        for i, c in enumerate((h, h, h // 2, h // 4)):
            setattr(self, f"style_mod_{i}", StyleMod(h, c, dtype=dtype))

    def forward(self, z):
        h = self.Dense_0.weight.shape[0]
        if self.dtype is not None:
            z = z.to(self.dtype)
        encoded = leaky_relu(self.Dense_0(z))
        dlatent = encoded
        for i in range(8):
            dlatent = leaky_relu(getattr(self, f"dlatent_{i}")(dlatent))

        def in_style(x, num):
            return getattr(self, f"style_mod_{num}")(x, dlatent)

        # 1x1 conv on the reshaped code, resize to 2x2
        x = self.Conv_0(encoded.reshape(-1, h, 1, 1))
        x = resize_bilinear_tf1(x, 2, 2)
        # style stages 0 and 1 at 2x2, then resize to 8x8
        x = in_style(self.Conv_1(x), 0)
        x = in_style(self.Conv_2(x), 1)
        x = resize_bilinear_tf1(x, 8, 8)
        x = leaky_relu(self.Conv_3(x))
        # 8 -> 16 (style stage 2) -> 32
        x = in_style(self.Conv_4(x), 2)
        x = leaky_relu(self.Conv_5(x))
        # 32 -> 64 (style stage 3) -> 128
        x = in_style(self.Conv_6(x), 3)
        x = leaky_relu(self.Conv_7(x))
        # decoded_6: 1x1 conv to 3 channels, linear (fp32 output)
        return self.Conv_8(x).float()
