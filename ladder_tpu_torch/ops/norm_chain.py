"""Fused instance-norm -> style modulation -> leaky_relu (forward).

Replaces the Pallas TPU kernel ``ladder_tpu/ops/pallas_kernels.py:_fwd_kernel``
(driven there by ``fused_instnorm_style_lrelu``). For x [B,C,H,W] (NCHW,
contiguous, float32 or bfloat16) and scale, shift [B,C] in x's dtype:

    y = leaky_0.2((x - mean) * rsqrt(var + 1e-6) * (scale + 1) + shift)

with per-(b, c) mean and centred variance over H*W in fp32 (two passes, as
the TPU kernel's ``mean(square(x - mean))``) and one rounding to x's dtype
at the end.

Kernel: ``ladder_tpu_torch/csrc/norm_chain.cu``, CUDA C++ for sm_90a, one
warp per (b, c) plane with warp-shuffle reductions; it re-reads the plane
(at most 16 KB on the decoder's path) from cache instead of holding it.
Bound: bytes. It must read x once and write y once, 2*B*C*H*W*itemsize
bytes: 304 MB per CelebA-128 decode at batch 64 in float32 (four stages,
[64,512,2,2] twice, [64,256,16,16], [64,128,64,64]), about 91 us at an H100
SXM's 3.35 TB/s; half that in bfloat16.

Dispatch is by device: a CPU tensor goes to ``norm_chain_reference``, the
plain PyTorch version; a CUDA tensor launches the kernel or raises. The
kernel is built with nvcc at first use into ``ladder_tpu_torch/_build/``,
keyed by a hash of its source and flags, and loaded with ctypes.
``fused_instnorm_style_lrelu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "norm_chain.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def norm_chain_reference(x, scale, shift, eps=1e-6, alpha=0.2):
    """Plain PyTorch version: fp32 statistics, one final rounding."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + eps)
    y = xhat * (scale.float() + 1.0)[:, :, None, None] \
        + shift.float()[:, :, None, None]
    return torch.where(y > 0, y, alpha * y).to(x.dtype)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def library_path():
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnorm_chain_{key}.so"


def build():
    """Compile the kernel if its library is not built yet. Returns
    (library path, compiler output; empty when it was already built)."""
    so = library_path()
    if so.is_file():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            lib.norm_chain_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
            lib.norm_chain_fwd.restype = ctypes.c_int
            lib.norm_chain_error_string.argtypes = [ctypes.c_int]
            lib.norm_chain_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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


def fused_instnorm_style_lrelu(x, scale, shift, eps=1e-6, alpha=0.2):
    """leaky(instance_norm(x) * (scale+1) + shift) for NCHW x.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(x, scale, shift)
    if x.device.type == "cpu":
        return norm_chain_reference(x, scale, shift, eps, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("scale", scale), ("shift", shift)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or shift.requires_grad):
        raise NotImplementedError(
            "the norm-chain kernel has no backward yet (see ROADMAP.md)")
    lib = _library()
    out = torch.empty_like(x)
    b, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.norm_chain_fwd(x.data_ptr(), scale.data_ptr(),
                                shift.data_ptr(), out.data_ptr(), b * c, h * w,
                                _DTYPES[x.dtype], eps, alpha, stream)
    if rc != 0:
        raise RuntimeError("norm_chain_fwd launch failed: "
                           + lib.norm_chain_error_string(rc).decode())
    fused_instnorm_style_lrelu.launches += 1
    return out


fused_instnorm_style_lrelu.launches = 0
