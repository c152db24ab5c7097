"""Clocks for timing the port's hand-written kernels on one CUDA card, used
by chip_smoke.py:

- ``device_ms``: the kernel's own time on the card. ``torch.profiler``
  records every launch of N calls (CUPTI); the durations of the kernels
  whose names hold one of the given marks are summed and divided by N.
  Gaps between launches, and the host, do not count.
- ``call_ms``: N calls through the wrapper on the host clock, then one
  synchronise, over N. Where the wrapper's host work exceeds the kernel's
  device time, this is the host's time, not the kernel's.
- ``host_ms``: the median host-clock time of one call over N calls made
  without a synchronise: the wrapper's enqueue time alone, robust to the
  host's occasional stalls.
"""

from __future__ import annotations

import statistics
import subprocess
import time

# more than five times the H100's 50 MB L2 cache
L2_FLUSH_BYTES = 256 << 20


def _warm(fn, times=3):
    import torch
    for _ in range(times):
        fn()
    torch.cuda.synchronize()


def device_ms(fn, iters, marks, flush=None):
    """(device ms per call, launches seen per call) of the kernels whose
    names hold one of ``marks``, over ``iters`` calls of fn. flush, when
    given, runs before every call (its own kernels do not count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _warm(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and any(mark in evt.key for mark in marks)):
            total_us += evt.self_device_time_total
            launches += evt.count
    if not total_us:
        raise RuntimeError(f"the profiler recorded no device time for "
                           f"{marks}: device time not measured")
    return total_us / 1e3 / iters, launches / iters


def call_ms(fn, iters):
    """Host-clock ms per call of N back-to-back calls, ending in a
    synchronise."""
    import torch
    _warm(fn)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def host_ms(fn, iters):
    """Median host-clock ms of one call over N calls made without a
    synchronise: the wrapper's own time on the host."""
    import torch
    _warm(fn)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def l2_flusher():
    """A function that overwrites L2_FLUSH_BYTES of device memory."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device="cuda")
    return buf.zero_


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
