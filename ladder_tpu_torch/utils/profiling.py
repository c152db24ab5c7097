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
    arms it for the first epoch). The block marks its steps
    (``Trace.step_range``), and the trace is summarised over the steps
    after the first (``Trace.summary``, written beside the trace as
    summary.json): the window's wall time, the device's busy time (the
    union of its kernels and copies) and idle share, the device time of
    the host<->device copies, and the host time of the collectives by
    name.
  * read_chrome_trace(logdir) and chrome_events(trace_events): the newest
    trace.json under a directory, and its complete events in the form
    ``summarise`` reads (``trace`` summarises the file it wrote with them,
    and the profilers of the port read traces back with them).
"""

from __future__ import annotations

import contextlib
import glob
import json
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


STEP_MARK = "ladder_step#"
_COLLECTIVE_WORDS = ("all_reduce", "allreduce", "broadcast", "all_gather",
                     "allgather", "barrier")


def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarise(events):
    """The summary of ``Trace`` from a profile's events, each (name, is
    device, start us, end us), over the steps after the first."""
    steps = [(a, b) for name, dev, a, b in events
             if not dev and name.startswith(STEP_MARK)
             and name != STEP_MARK + "0"]
    if not steps:
        return None
    lo = min(a for a, _ in steps)
    hi = max(b for _, b in steps)
    # the device's kernels and copies (not the device-side spans of the
    # step marks, which cover each step's work whole)
    device = [(max(a, lo), b) for name, dev, a, b in events
              if dev and b > lo and not name.startswith(STEP_MARK)]
    if device:
        hi = max(hi, max(b for _, b in device))
    busy = _union_us(device)
    copies = sum(b - a for (name, dev, a, b) in events
                 if dev and b > lo and name.startswith("Memcpy"))
    coll = {}
    for name, dev, a, b in events:
        if (not dev and lo <= a < hi
                and any(w in name.lower() for w in _COLLECTIVE_WORDS)):
            c = coll.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e3
    return dict(steps=len(steps), wall_ms=(hi - lo) / 1e3,
                device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / (hi - lo)) if hi > lo
                else None,
                copy_ms=copies / 1e3, collectives_ms=coll)


# the Chrome trace's categories of device activity; its device-side copies
# of the host's profiler ranges ("gpu_user_annotation") are left out
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def read_chrome_trace(logdir):
    """The traceEvents of the newest trace.json under ``logdir``."""
    paths = glob.glob(os.path.join(logdir, "**", "trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {logdir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        return json.load(f)["traceEvents"]


def chrome_events(trace_events):
    """The complete ('X') events of a Chrome trace as ``summarise`` reads
    them: (name, is device, start us, end us)."""
    return [(e["name"], e.get("cat") in DEVICE_CATEGORIES, float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0)))
            for e in trace_events
            if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]


class Trace:
    """The profile of a block (see trace)."""

    def __init__(self):
        self.summary = None

    @staticmethod
    def step_range(k):
        """A profiler range around step k of the block."""
        return torch.profiler.record_function(f"{STEP_MARK}{k}")


@contextlib.contextmanager
def trace(profile_dir=None):
    """torch.profiler trace of the block into profile_dir/trace.json;
    yields a Trace (None when profile_dir is falsy) whose summary is set
    when the block ends."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    out = Trace()
    with profile(activities=activities) as prof:
        yield out
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    # read back from the file: building prof.events() costs ten times as
    # much (~70 us an event) as writing and parsing the JSON
    with open(path) as f:
        out.summary = summarise(chrome_events(json.load(f)["traceEvents"]))
    with open(os.path.join(profile_dir, "summary.json"), "w") as f:
        json.dump(out.summary, f)
    print(f"profiler trace written to {path}")
