"""Per-step timing and the profiler trace of the training loop (the port of
``ladder_tpu/utils/profiling.py``).

  * StepTimer: per-step host times (start/stop around each step call) with
    percentiles, and the epoch's wall time (wall_start before the loop,
    wall_stop after the final synchronisation). PyTorch enqueues CUDA work
    and returns, so a step's host time is its dispatch time unless the
    timer synchronises (``stop(sync_on=...)``, config['sync_each_step']);
    the epoch wall over the step count is the honest step time.
  * trace(profile_dir): ``torch.profiler`` around a block, CPU and (when
    there is a card) CUDA activity, written as a Chrome trace into
    profile_dir; a no-op when profile_dir is falsy (config['profile_dir']
    arms it for the first epoch).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def synchronize(tree):
    """Wait for the CUDA devices that hold the tensors of ``tree`` (a
    tensor or nested dicts / lists of tensors)."""
    devices = set()

    def walk(node):
        if torch.is_tensor(node):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Per-step host times and the epoch wall (see the module docstring)."""

    def __init__(self, batch_size=None):
        self.batch_size = batch_size
        self.times = []
        self._t0 = None
        self.wall = None
        self._w0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None, n_steps=1):
        """sync_on: tensors to wait for before reading the clock. n_steps>1:
        the timed call covered several steps; each gets the average."""
        if sync_on is not None:
            synchronize(sync_on)
        dt = time.perf_counter() - self._t0
        self.times.extend([dt / n_steps] * n_steps)
        return dt

    def wall_start(self):
        self._w0 = time.perf_counter()

    def wall_stop(self):
        if self._w0 is not None:
            self.wall = time.perf_counter() - self._w0
        return self.wall

    def summary(self):
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # drop the first step
        out = dict(
            steps=len(self.times),
            dispatch_mean_ms=float(t.mean() * 1000),
            p50_ms=float(np.percentile(t, 50) * 1000),
            p99_ms=float(np.percentile(t, 99) * 1000),
        )
        if self.wall:
            out["wall_s"] = float(self.wall)
            out["step_ms"] = float(self.wall / len(self.times) * 1000)
            if self.batch_size:
                out["images_per_sec"] = float(
                    len(self.times) * self.batch_size / self.wall)
        elif self.batch_size:
            # synchronous timing: the host times are the step times
            out["step_ms"] = out["dispatch_mean_ms"]
            out["images_per_sec"] = float(self.batch_size / t.mean())
        return out

    def report(self, prefix=""):
        s = self.summary()
        if s:
            if "step_ms" in s:
                msg = f"{prefix}step {s['step_ms']:.2f} ms"
                if "images_per_sec" in s:
                    msg += f", {s['images_per_sec']:.0f} images/sec"
                msg += (f" (dispatch p50 {s['p50_ms']:.2f}, "
                        f"p99 {s['p99_ms']:.2f} ms)")
            else:
                msg = (f"{prefix}dispatch {s['dispatch_mean_ms']:.2f} ms "
                       f"(p50 {s['p50_ms']:.2f}, p99 {s['p99_ms']:.2f})")
            print(msg)
        return s


@contextlib.contextmanager
def trace(profile_dir=None):
    """torch.profiler trace of the block into profile_dir/trace.json."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
