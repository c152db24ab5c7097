"""Image-space ops of the CelebA decoder, NCHW: TF1-semantics bilinear
resize, instance norm, and the [2x resize -> SAME 3x3 conv] pair.

``resize_bilinear_tf1`` reproduces TF1 ``tf.image.resize_images`` default
semantics (align_corners=False, half_pixel_centers=False: src = dst * in/out)
with the same interpolation matrices as ``ladder_tpu/ops/image.py`` — not
``F.interpolate``, whose coordinates differ. ``conv3x3_up2x_tf1`` is written
as that explicit resize followed by a SAME 3x3 conv; ``ladder_tpu`` fuses
the pair into one lhs-dilated conv with boundary corrections, which equals
this form up to float rounding (tests/test_models.py of the JAX package).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _tf1_interp_matrix(in_size, out_size):
    """[out_size, in_size] bilinear interpolation matrix with TF1 legacy
    coordinates. Each row has at most two non-zeros."""
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _cached_matrix(in_size, out_size, device, dtype):
    """The matrix as a tensor on ``device``, made once (read-only use). It
    is made outside inference mode even when a serving call is the first to
    ask: an inference tensor could not enter a later train step's graph."""
    with torch.inference_mode(False):
        return torch.tensor(_tf1_interp_matrix(in_size, out_size)).to(
            device=device, dtype=dtype)


def _matrix(in_size, out_size, like):
    return _cached_matrix(in_size, out_size, like.device, like.dtype)


def resize_bilinear_tf1(x, out_h, out_w):
    """NCHW bilinear resize with TF1 align_corners=False legacy semantics,
    as contractions with the interpolation matrices."""
    in_h, in_w = x.shape[2], x.shape[3]
    if in_h != out_h:
        x = torch.einsum("bchw,oh->bcow", x, _matrix(in_h, out_h, x))
    if in_w != out_w:
        x = torch.einsum("bchw,pw->bchp", x, _matrix(in_w, out_w, x))
    return x.contiguous()


def conv3x3_up2x_tf1(x, weight, bias=None):
    """conv3x3_SAME(resize_bilinear_tf1(x, 2H, 2W)).

    x: [B,Ci,H,W]; weight: [Co,Ci,3,3] (OIHW); returns [B,Co,2H,2W]."""
    x = resize_bilinear_tf1(x, 2 * x.shape[2], 2 * x.shape[3])
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), padding=1)


def instance_norm(x, eps=1e-6):
    """Per-sample per-channel normalisation over H,W without scale/offset,
    matching tf.contrib.layers.instance_norm(scale=False, center=False).
    NCHW input. Statistics in fp32 even for bf16 activations."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
