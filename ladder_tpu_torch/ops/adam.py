"""Clipped TF1-style Adam over all tensors of one optimiser group, in place.

Replaces the Pallas TPU kernel ``ladder_tpu/ops/pallas_adam.py:_adam_kernel``
(driven there by ``adam_update_fused``). Per element, in float32:

    g = clip(g, -1, 1)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    p = p - lr_t * m / (sqrt(v) + eps)

with lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t) computed on the host in double
and passed as one float32. This is TF1's Adam (bias correction folded into
the step size, eps added to the uncorrected sqrt(v)) with the elementwise
+-1 gradient clip inside the update; it is not ``torch.optim.Adam``.

Kernel: ``ladder_tpu_torch/csrc/adam.cu``, CUDA C++ for sm_90a: one launch
for up to 96 tensors (their addresses travel in the kernel's arguments), so
a group of some seventy tensors costs one launch, not seventy.
Bound: bytes, 28 per element (read g, p, m, v; write p, m, v).

Dispatch is by device: CPU tensors take ``adam_update_reference``, the plain
PyTorch version; CUDA tensors launch the kernel or raise.
``adam_update_.launches`` counts group updates that launched the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ladder_tpu_torch.ops._build import KernelLibrary

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary("adam", {
    # p, g, m, v, n (host arrays), num_tensors, lr_t, b1, 1-b1, b2, 1-b2,
    # eps, stream
    "adam_update": [_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _P],
    # g, n (host arrays), num_tensors, flag, stream
    "adam_nonfinite_flag": [_P, _P, _I, _P, _P],
})


def bias_corrected_lr(lr, t, b1, b2):
    """TF1 Adam's step size at step t >= 1."""
    return float(lr) * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)


def adam_update_reference(params, grads, m, v, lr_t, b1, b2, eps):
    """Plain PyTorch version: updates params, m and v in place."""
    with torch.no_grad():
        for p, g, m_, v_ in zip(params, grads, m, v):
            g = g.clamp(-1.0, 1.0)
            m_.copy_(b1 * m_ + (1.0 - b1) * g)
            v_.copy_(b2 * v_ + (1.0 - b2) * g * g)
            p.copy_(p - lr_t * m_ / (torch.sqrt(v_) + eps))


def any_nonfinite_reference(grads):
    return any(not bool(torch.isfinite(g.clamp(-1.0, 1.0)).all())
               for g in grads)


def _check(params, grads, m, v):
    if not params:
        raise ValueError("empty group")
    if not len(params) == len(grads) == len(m) == len(v):
        raise ValueError("params, grads, m and v differ in length")
    device = params[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    f32 = torch.float32
    for p, g, m_, v_ in zip(params, grads, m, v):
        if not (p.dtype == g.dtype == m_.dtype == v_.dtype == f32):
            raise TypeError("float32 tensors only, got "
                            f"{[t.dtype for t in (p, g, m_, v_)]}")
        if not (p.shape == g.shape == m_.shape == v_.shape
                and device == g.device == m_.device == v_.device
                == p.device):
            raise ValueError(
                "a gradient or moment does not match its parameter: "
                f"{[(tuple(t.shape), str(t.device)) for t in (p, g, m_, v_)]}")
        if not (p.is_contiguous() and m_.is_contiguous()
                and v_.is_contiguous()):
            raise ValueError("parameters and moments must be contiguous")
    return device


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _sizes(tensors):
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def any_nonfinite(grads):
    """True if any gradient element is not finite after the clip to
    [-1, 1]: the guard sees the clipped gradients, as in ``ladder_tpu``'s
    train step, so an infinite element passes (as +-1) and a NaN does not.
    On CUDA tensors one kernel raises a flag in device memory and the host
    reads it: one host synchronisation per call."""
    grads = [g.contiguous() for g in grads]
    device = grads[0].device
    if device.type == "cpu":
        return any_nonfinite_reference(grads)
    flag = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        LIBRARY.call("adam_nonfinite_flag", _pointers(grads), _sizes(grads),
                     len(grads), flag.data_ptr(), stream)
    return bool(flag.item())


def adam_update_(params, grads, m, v, lr, t, b1, b2, eps):
    """One Adam step at step count t >= 1 over the lists params, grads, m,
    v (float32 tensors of one device). Updates params, m and v in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    device = _check(params, grads, m, v)
    lr_t = bias_corrected_lr(lr, t, b1, b2)
    if device.type == "cpu":
        adam_update_reference(params, grads, m, v, lr_t, b1, b2, eps)
        return
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        LIBRARY.call("adam_update", _pointers(params), _pointers(grads),
                     _pointers(m), _pointers(v), _sizes(params), len(params),
                     lr_t, b1, 1.0 - b1, b2, 1.0 - b2, eps, stream)
    adam_update_.launches += 1


adam_update_.launches = 0
