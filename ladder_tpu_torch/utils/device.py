"""Device selection and float32 numerics shared by the serving engine and
the train step."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device):
    """torch.device for 'cuda' / 'cuda:N' / 'cpu'; raises if CUDA is asked
    for and absent, or cuda:N names no device (never falls back to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device={device!r} but this machine has "
                f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls (restored after)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
