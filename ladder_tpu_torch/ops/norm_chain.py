"""Fused instance-norm -> style modulation -> leaky_relu, forward and
backward.

Replaces the Pallas TPU kernels ``ladder_tpu/ops/pallas_kernels.py:_fwd_kernel``
and ``:_bwd_kernel`` (driven there by ``fused_instnorm_style_lrelu`` and its
custom VJP). For x [B,C,H,W] (NCHW, contiguous, float32 or bfloat16) and
scale, shift [B,C] in x's dtype:

    y = leaky_0.2((x - mean) * rsqrt(var + 1e-6) * (scale + 1) + shift)

with per-(b, c) mean and centred variance over H*W in fp32 (two passes, as
the TPU kernel's ``mean(square(x - mean))``) and one rounding to x's dtype
at the end. The backward keeps x, scale and shift only and recomputes the
statistics, as the TPU kernel does; dscale and dshift are summed in fp32 and
cast to scale's dtype.

Kernels: ``ladder_tpu_torch/csrc/norm_chain.cu``, CUDA C++ for sm_90a. The
forward reads each plane from device memory once with 16-byte accesses and
holds it on chip: one thread per 4-element plane, a group of 16 threads
per plane of up to 256 elements (in registers), and, for planes of 1024
elements up to 16 KB, a persistent grid that streams planes through a ring
of shared-memory buffers filled by bulk asynchronous copies; other shapes,
larger planes and unaligned tensors take a generic kernel (``forward_path``
names the variant). The backward gives a group of 4, 32 or 256 threads to a
plane by its size and re-reads the plane from cache.
Bound: bytes. The forward must read x once and write y once,
2*B*C*H*W*itemsize bytes: 304 MB per CelebA-128 decode at batch 64 in
float32 (four stages, [64,512,2,2] twice, [64,256,16,16], [64,128,64,64]),
about 91 us at an H100 SXM's 3.35 TB/s; the backward reads g and x and
writes dx, 456 MB, about 136 us. Half that in bfloat16.

Dispatch is by device: a CPU tensor goes to ``norm_chain_reference`` and
``norm_chain_bwd_reference``, the plain PyTorch versions; a CUDA tensor
launches the kernels or raises. ``fused_instnorm_style_lrelu.launches`` and
``norm_chain_backward.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ladder_tpu_torch.ops._build import KernelLibrary

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
LIBRARY = KernelLibrary("norm_chain", {
    # x, scale, shift, out, planes, hw, dtype, eps, alpha, stream
    "norm_chain_fwd": [_P, _P, _P, _P, _L, _I, _I, _F, _F, _P],
    # g, x, scale, shift, dx, dscale, dshift, planes, hw, dtype, eps, alpha,
    # stream
    "norm_chain_bwd": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _P],
    # x, out, hw, dtype -> the forward's variant (an index of FORWARD_PATHS)
    "norm_chain_fwd_path": [_P, _P, _I, _I],
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward kernel's variants, in the order of csrc/norm_chain.cu:FwdPath
FORWARD_PATHS = ("generic", "thread per plane", "group of 16", "ring")


def norm_chain_reference(x, scale, shift, eps=1e-6, alpha=0.2):
    """Plain PyTorch version: fp32 statistics, one final rounding."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + eps)
    y = xhat * (scale.float() + 1.0)[:, :, None, None] \
        + shift.float()[:, :, None, None]
    return torch.where(y > 0, y, alpha * y).to(x.dtype)


def norm_chain_bwd_reference(g, x, scale, shift, eps=1e-6, alpha=0.2):
    """Plain PyTorch version of the backward: (dx in x's dtype, dscale and
    dshift [B,C] float32), recomputed from x as the kernel does."""
    gf, xf = g.float(), x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    s = (scale.float() + 1.0)[:, :, None, None]
    y = xhat * s + shift.float()[:, :, None, None]
    dy = gf * torch.where(y > 0, 1.0, alpha)
    dscale = (dy * xhat).sum(dim=(2, 3))
    dshift = dy.sum(dim=(2, 3))
    dxhat = dy * s
    m1 = dxhat.mean(dim=(2, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3), keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * inv).to(x.dtype)
    return dx, dscale, dshift


def _check(x, scale, shift):
    if x.dim() != 4:
        raise ValueError(f"x must be [B,C,H,W], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, c = x.shape[:2]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (b, c):
            raise ValueError(f"{name} must be [{b},{c}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.numel() == 0:
        raise ValueError("empty input")


def _require_cuda_contiguous(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(x, scale, shift, eps, alpha):
    if x.device.type == "cpu":
        return norm_chain_reference(x, scale, shift, eps, alpha)
    _require_cuda_contiguous(x=x, scale=scale, shift=shift)
    out = torch.empty_like(x)
    b, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        LIBRARY.call("norm_chain_fwd", x.data_ptr(), scale.data_ptr(),
                     shift.data_ptr(), out.data_ptr(), b * c, h * w,
                     _DTYPES[x.dtype], eps, alpha, stream)
    fused_instnorm_style_lrelu.launches += 1
    return out


def forward_path(x):
    """The variant of the forward kernel that the CUDA tensor x takes (the
    wrapper's output is a fresh, aligned tensor): one of FORWARD_PATHS."""
    _require_cuda_contiguous(x=x)
    h, w = x.shape[2:]
    return FORWARD_PATHS[LIBRARY.load().norm_chain_fwd_path(
        x.data_ptr(), 0, h * w, _DTYPES[x.dtype])]


def norm_chain_backward(g, x, scale, shift, eps=1e-6, alpha=0.2):
    """(dx, dscale, dshift) of the chain for the output's gradient g.

    dx has x's dtype; dscale and dshift are [B,C] float32. CPU tensors take
    the plain version; CUDA tensors launch the backward kernel."""
    _check(x, scale, shift)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    if x.device.type == "cpu":
        return norm_chain_bwd_reference(g, x, scale, shift, eps, alpha)
    g = g.contiguous()
    _require_cuda_contiguous(x=x, scale=scale, shift=shift)
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dshift = torch.empty_like(dscale)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        LIBRARY.call("norm_chain_bwd", g.data_ptr(), x.data_ptr(),
                     scale.data_ptr(), shift.data_ptr(), dx.data_ptr(),
                     dscale.data_ptr(), dshift.data_ptr(), b * c, h * w,
                     _DTYPES[x.dtype], eps, alpha, stream)
    norm_chain_backward.launches += 1
    return dx, dscale, dshift


class _NormChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps, alpha):
        ctx.save_for_backward(x, scale, shift)
        ctx.eps, ctx.alpha = eps, alpha
        return _forward(x, scale, shift, eps, alpha)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift = ctx.saved_tensors
        dx, dscale, dshift = norm_chain_backward(g, x, scale, shift, ctx.eps,
                                                 ctx.alpha)
        return (dx, dscale.to(scale.dtype), dshift.to(shift.dtype), None,
                None)


def fused_instnorm_style_lrelu(x, scale, shift, eps=1e-6, alpha=0.2):
    """leaky(instance_norm(x) * (scale+1) + shift) for NCHW x, differentiable
    in x, scale and shift.

    CPU tensors take the plain versions; CUDA tensors launch the kernels."""
    _check(x, scale, shift)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _NormChain.apply(x, scale, shift, eps, alpha)


fused_instnorm_style_lrelu.launches = 0
norm_chain_backward.launches = 0
