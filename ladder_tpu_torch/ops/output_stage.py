"""Fused decoder output stage: leaky_relu -> 1x1 conv to 3 channels ->
reconstruction sums, forward and backward.

Replaces the Pallas TPU kernels ``ladder_tpu/ops/pallas_output.py:_fwd_kernel``
and ``:_bwd_kernel`` (driven there by ``fused_output_recon`` and its custom
VJP). NCHW here:

    fused_output_recon(u, weight, bias, target) -> (decoded, l1_sum, l2_sum)

u [B,C,H,W] is the decoder trunk's output, the input of the last leaky_relu,
in the activation dtype T (float32 or bfloat16); weight [3,C] and bias [3]
are Conv_8's float32 parameters; target [B,3,H,W] is float32.

    x7      = where(u > 0, u, T(0.2) * u)                       (in T)
    decoded = T(T(weight) . x7 + bias) as float32           (fp32 sum over C)
    l1_sum  = sum |target - decoded|, l2_sum = sum (target - decoded)^2

The backward makes one pass over u for du, dweight and dbias, with the
operands of both products rounded to T and fp32 accumulation, as the TPU
kernel computes them; sign(0) = 0. The target's gradient is plain code
outside the kernel and is computed only when asked for.

Kernels: ``ladder_tpu_torch/csrc/output_stage.cu``, CUDA C++ for sm_90a.
Bound: bytes, the read of u (537 MB in float32 at [64,128,128,128]) and in
the backward also the write of du. The cross-block sums go through per-block
partials and a second small kernel, so l1, l2, dweight and dbias are the
same from run to run.

Dispatch is by device: CPU tensors take ``output_recon_reference`` and
``output_recon_bwd_reference``, the plain PyTorch versions; CUDA tensors
launch the kernels or raise. ``fused_output_recon.launches`` counts forward
launches and ``output_recon_backward.launches`` backward launches.
"""

from __future__ import annotations

import ctypes

import torch

from ladder_tpu_torch.ops._build import KernelLibrary

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary("output_stage", {
    # u, w8, b8, target, dec, partials, partial_rows, sums, batch, channels,
    # hw, dtype, alpha, stream
    "output_stage_fwd": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F,
                         _P],
    # u, w8, dec, target, a12, ddec, du, partials, partial_rows, dw_db,
    # batch, channels, hw, dtype, alpha, stream
    "output_stage_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                         _I, _F, _P],
})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALPHA = 0.2  # tf.nn.leaky_relu's slope
OUT_CHANNELS = 3  # the kernels are written for the 3-channel image head
MAX_CHANNELS = 2048  # the backward's per-warp sums must fit shared memory
_PIX_PER_BLOCK = 1024  # kPixPerBlock in output_stage.cu


def _leaky(u):
    return torch.where(u > 0, u, torch.tensor(ALPHA, dtype=u.dtype) * u)


def output_recon_reference(u, weight, bias, target):
    """Plain PyTorch version of the forward."""
    x7 = _leaky(u)
    dec = torch.einsum("bchw,oc->bohw", x7.float(),
                       weight.to(u.dtype).float())
    dec = (dec + bias.float()[None, :, None, None]).to(u.dtype).float()
    diff = target.float() - dec
    return dec, diff.abs().sum(), diff.square().sum()


def output_recon_bwd_reference(u, weight, dec, target, a1, a2, ddec=None):
    """Plain PyTorch version of the backward: (du in u's dtype, dweight
    [3,C] and dbias [3] float32). a1, a2: gradients of l1_sum and l2_sum
    (0-dim tensors); ddec: gradient of decoded, or None."""
    diff = target.float() - dec
    dout = -a1 * torch.sign(diff) - 2.0 * a2 * diff
    if ddec is not None:
        dout = dout + ddec.float()
    dout_a = dout.to(u.dtype).float()
    x7 = _leaky(u).float()
    dweight = torch.einsum("bohw,bchw->oc", dout_a, x7)
    dbias = dout.sum(dim=(0, 2, 3))
    dx7 = torch.einsum("bohw,oc->bchw", dout_a,
                       weight.to(u.dtype).float()).to(u.dtype)
    du = torch.where(u > 0, dx7, torch.tensor(ALPHA, dtype=u.dtype) * dx7)
    return du, dweight, dbias


def _check(u, weight, bias, target):
    if u.dim() != 4:
        raise ValueError(f"u must be [B,C,H,W], got shape {tuple(u.shape)}")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    b, c, h, w = u.shape
    if u.numel() == 0:
        raise ValueError("empty input")
    if c > MAX_CHANNELS or b > 65535:
        raise ValueError(f"at most {MAX_CHANNELS} channels and 65535 "
                         f"samples, got {c} and {b}")
    shapes = (("weight", weight, (OUT_CHANNELS, c)),
              ("bias", bias, (OUT_CHANNELS,)),
              ("target", target, (b, OUT_CHANNELS, h, w)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")


def _partial_rows(u):
    b, _, h, w = u.shape
    return b * -(-(h * w) // _PIX_PER_BLOCK)


def _forward(u, weight, bias, target):
    if u.device.type == "cpu":
        return output_recon_reference(u, weight, bias, target)
    u, weight, bias, target = (t.contiguous()
                               for t in (u, weight, bias, target))
    b, c, h, w = u.shape
    dec = torch.empty_like(target)
    rows = _partial_rows(u)
    partials = torch.empty((rows, 2), dtype=torch.float32, device=u.device)
    sums = torch.empty(2, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        LIBRARY.call("output_stage_fwd", u.data_ptr(), weight.data_ptr(),
                     bias.data_ptr(), target.data_ptr(), dec.data_ptr(),
                     partials.data_ptr(), rows, sums.data_ptr(), b, c, h * w,
                     _DTYPES[u.dtype], ALPHA, stream)
    fused_output_recon.launches += 1
    return dec, sums[0], sums[1]


def output_recon_backward(u, weight, dec, target, a1, a2, ddec=None):
    """(du, dweight, dbias) of the stage; see output_recon_bwd_reference.

    CPU tensors take the plain version; CUDA tensors launch the backward
    kernel."""
    if u.device.type == "cpu":
        return output_recon_bwd_reference(u, weight, dec, target, a1, a2,
                                          ddec)
    u, weight, dec, target = (t.contiguous()
                              for t in (u, weight, dec, target))
    if ddec is not None:
        ddec = ddec.float().contiguous()
    b, c, h, w = u.shape
    a12 = torch.stack([a1.reshape(()), a2.reshape(())]).float()
    du = torch.empty_like(u)
    columns = OUT_CHANNELS * c + OUT_CHANNELS
    rows = _partial_rows(u)
    partials = torch.empty((rows, columns), dtype=torch.float32,
                           device=u.device)
    dw_db = torch.empty(columns, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        LIBRARY.call("output_stage_bwd", u.data_ptr(), weight.data_ptr(),
                     dec.data_ptr(), target.data_ptr(), a12.data_ptr(),
                     None if ddec is None else ddec.data_ptr(),
                     du.data_ptr(), partials.data_ptr(), rows,
                     dw_db.data_ptr(), b, c, h * w, _DTYPES[u.dtype], ALPHA,
                     stream)
    output_recon_backward.launches += 1
    return (du, dw_db[:OUT_CHANNELS * c].reshape(OUT_CHANNELS, c),
            dw_db[OUT_CHANNELS * c:])


class _OutputRecon(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, weight, bias, target):
        dec, l1, l2 = _forward(u, weight, bias, target)
        ctx.save_for_backward(u, weight, target, dec)
        # an output nobody differentiates arrives as None, not as zeros:
        # in a train step decoded has no gradient and the kernel skips it
        ctx.set_materialize_grads(False)
        return dec, l1, l2

    @staticmethod
    def backward(ctx, ddec, dl1, dl2):
        u, weight, target, dec = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=u.device)
        a1 = zero if dl1 is None else dl1.float()
        a2 = zero if dl2 is None else dl2.float()
        du = dweight = dbias = dtarget = None
        if any(ctx.needs_input_grad[:3]):
            du, dweight, dbias = output_recon_backward(
                u, weight, dec, target, a1, a2, ddec)
        if ctx.needs_input_grad[3]:
            # decoded does not depend on the target
            diff = target - dec
            dtarget = a1 * torch.sign(diff) + 2.0 * a2 * diff
        return du, dweight, dbias, dtarget


def fused_output_recon(u, weight, bias, target):
    """(decoded, l1_sum, l2_sum) of the decoder's output stage, differentiable
    in u, weight, bias and target.

    CPU tensors take the plain versions; CUDA tensors launch the kernels."""
    _check(u, weight, bias, target)
    return _OutputRecon.apply(u, weight, bias, target)


fused_output_recon.launches = 0
output_recon_backward.launches = 0
