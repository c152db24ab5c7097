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
per group of up to ``ADAM_MAX_TENSORS`` tensors. Its grid walks a plan
(``adam_plan``) that cuts the group into chunks of ``ADAM_CHUNK`` elements
(a tensor's last one shorter), none crossing a tensor, one block a chunk;
its threads move 16 bytes a load. The plan and the parameters' and
moments' addresses are built once per group and kept in device memory,
cached under ``adam_plan_key`` (every tensor's address and every
parameter's size): a replaced tensor builds a new plan. A call checks that
the parameters and moments are still float32 and contiguous, and the
gradients' device, dtype, shape and contiguity, and passes only the
gradients' addresses, by value in the kernel's arguments.
Bound: bytes, 28 per element (read g, p, m, v; write p, m, v).

Dispatch is by device: CPU tensors take ``adam_update_reference``, the plain
PyTorch version; CUDA tensors launch the kernel or raise.
``adam_update_.launches`` counts group updates that launched the kernel.
"""

from __future__ import annotations

import ctypes
import math
import operator
from array import array
from itertools import chain

import numpy as np
import torch

from ladder_tpu_torch.ops._build import KernelLibrary

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
LIBRARY = KernelLibrary("adam", {
    # g (host array), num_tensors, tensors, chunks (device), num_chunks,
    # lr_t, b1, 1-b1, b2, 1-b2, eps, stream
    "adam_update": [_P, _I, _P, _P, _L, _F, _F, _F, _F, _F, _F, _P],
    # g (host array), num_tensors, chunks, num_chunks, flag, reset, stream
    "adam_nonfinite_flag": [_P, _I, _P, _L, _P, _I, _P],
})
# Elements of a chunk (a tensor's last may hold fewer): two float4 for each
# of the kernel's 256 threads.
ADAM_CHUNK = 2048
# Gradient addresses one launch takes by value (csrc/adam.cu:kMaxTensors).
ADAM_MAX_TENSORS = 256
# Groups whose plans are kept (a train step has at most five).
_MAX_PLANS = 16

_ADDRESS, _NUMEL = torch.Tensor.data_ptr, torch.Tensor.numel
_CONTIGUOUS = torch.Tensor.is_contiguous
_DEVICE, _DTYPE = operator.attrgetter("device"), operator.attrgetter("dtype")
_FLOAT32 = {torch.float32}


def adam_plan(sizes, chunk=ADAM_CHUNK, max_tensors=ADAM_MAX_TENSORS):
    """Cut tensors of ``sizes`` elements into the Adam kernel's work.

    Returns one ``(first, count, chunks)`` per launch, for the tensors
    ``first .. first + count - 1`` (at most ``max_tensors``): ``chunks`` is
    an int64 array [n, 3] of (tensor index within the launch, start,
    length), tensor by tensor, together covering every element once, none
    crossing a tensor, each ``chunk`` elements long but a tensor's last,
    which holds 1 to ``chunk``: the blocks' work is equal within one
    chunk."""
    sizes = np.asarray(sizes, dtype=np.int64)
    launches = []
    for first in range(0, len(sizes), max_tensors):
        part = sizes[first:first + max_tensors]
        per_tensor = -(-part // chunk)
        tensor = np.repeat(np.arange(len(part)), per_tensor)
        # a chunk's index within its tensor
        index = np.arange(len(tensor)) - np.repeat(
            np.cumsum(per_tensor) - per_tensor, per_tensor)
        start = index * chunk
        length = np.minimum(chunk, part[tensor] - start)
        launches.append((first, len(part),
                         np.stack([tensor, start, length], axis=1)))
    return launches


def adam_plan_key(params, m, v):
    """The key of a group's cached plan: the address of every parameter
    and moment and the size of every parameter."""
    return (tuple(map(_ADDRESS, params)), tuple(map(_ADDRESS, m)),
            tuple(map(_ADDRESS, v)), tuple(map(_NUMEL, params)))


class AdamPlan:
    """A group's plan in device memory, as csrc/adam.cu reads it (int64
    words): per tensor {p, m, v, n}, per chunk {start, tensor | length <<
    32}."""

    def __init__(self, params, m, v):
        words, parts = [], []
        offset = 0
        for first, count, chunks in adam_plan([p.numel() for p in params]):
            group = slice(first, first + count)
            tensors = np.array(
                [[p.data_ptr(), m_.data_ptr(), v_.data_ptr(), p.numel()]
                 for p, m_, v_ in zip(params[group], m[group], v[group])],
                dtype=np.int64).ravel()
            records = np.stack([chunks[:, 1],
                                chunks[:, 0] | (chunks[:, 2] << 32)],
                               axis=1).ravel()
            parts.append((first, count, offset, offset + len(tensors),
                          len(chunks)))
            words += [tensors, records]
            offset += len(tensors) + len(records)
        self.device = params[0].device
        self.table = torch.from_numpy(np.concatenate(words)).to(self.device)
        base = self.table.data_ptr()
        # (first, count, tensors, chunks, chunk count) per launch
        self.launches = [(first, count, base + 8 * t, base + 8 * c, n)
                         for first, count, t, c, n in parts]
        self.shapes = [p.shape for p in params]


_PLANS = {}


def group_plan(params, grads, m, v):
    """The cached plan of the group (params, m, v) on a CUDA device; a new
    plan, after the full checks of every tensor, when an address or a
    parameter's size has changed. A tensor found at a cached address may be
    another one than the plan was built for: the plan holds only while
    every parameter and moment there is float32 and contiguous."""
    key = adam_plan_key(params, m, v)
    plan = _PLANS.get(key)
    if plan is None:
        _check(params, grads, m, v)
        if len(_PLANS) >= _MAX_PLANS:
            del _PLANS[next(iter(_PLANS))]
        plan = _PLANS[key] = AdamPlan(params, m, v)
    elif (set(map(_DTYPE, chain(params, m, v))) != _FLOAT32
          or not all(map(_CONTIGUOUS, chain(params, m, v)))):
        raise ValueError("parameters and moments must be contiguous "
                         "float32 tensors")
    return plan


def _gradient_addresses(grads, plan):
    """Host array of the gradients' addresses (kept alive by the caller),
    after the checks of what a step changes: device, dtype, shape,
    contiguity."""
    devices = set(map(_DEVICE, grads))
    if devices != {plan.device}:
        raise ValueError(f"gradients on {sorted(map(str, devices))}, the "
                         f"group on {plan.device}")
    if [g.shape for g in grads] != plan.shapes:
        raise ValueError("a gradient does not match its parameter: "
                         f"{[tuple(g.shape) for g in grads]} vs "
                         f"{[tuple(s) for s in plan.shapes]}")
    if set(map(_DTYPE, grads)) != _FLOAT32:
        raise TypeError("float32 gradients only, got "
                        f"{sorted(map(str, set(map(_DTYPE, grads))))}")
    if not all(map(_CONTIGUOUS, grads)):
        grads = [g.contiguous() for g in grads]
    return grads, array("Q", map(_ADDRESS, grads))


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
    """Every check of a group: lengths, devices, dtypes, shapes and
    contiguity of all four lists. Returns the device."""
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


def any_nonfinite(params, grads, m, v):
    """True if any gradient element of the group is not finite after the
    clip to [-1, 1]: the guard sees the clipped gradients, as in
    ``ladder_tpu``'s train step, so an infinite element passes (as +-1)
    and a NaN does not. On CUDA tensors a kernel walks the group's plan and
    raises a flag in device memory, and the host reads it: one host
    synchronisation per call."""
    if not params or params[0].device.type != "cuda":
        return any_nonfinite_reference(grads)
    plan = group_plan(params, grads, m, v)
    grads, addresses = _gradient_addresses(grads, plan)
    base = addresses.buffer_info()[0]
    flag = torch.empty(1, dtype=torch.int32, device=plan.device)
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    with torch.cuda.device(plan.device):
        for i, (first, count, _, chunks, n) in enumerate(plan.launches):
            LIBRARY.call("adam_nonfinite_flag", base + 8 * first, count,
                         chunks, n, flag.data_ptr(), int(i == 0), stream)
    return bool(flag.item())


def adam_update_(params, grads, m, v, lr, t, b1, b2, eps):
    """One Adam step at step count t >= 1 over the lists params, grads, m,
    v (float32 tensors of one device). Updates params, m and v in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    lr_t = bias_corrected_lr(lr, t, b1, b2)
    if not params or params[0].device.type != "cuda":
        _check(params, grads, m, v)
        adam_update_reference(params, grads, m, v, lr_t, b1, b2, eps)
        return
    plan = group_plan(params, grads, m, v)
    grads, addresses = _gradient_addresses(grads, plan)
    base = addresses.buffer_info()[0]
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    with torch.cuda.device(plan.device):
        for first, count, tensors, chunks, n in plan.launches:
            LIBRARY.call("adam_update", base + 8 * first, count, tensors,
                         chunks, n, lr_t, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                         stream)
    adam_update_.launches += 1


adam_update_.launches = 0
