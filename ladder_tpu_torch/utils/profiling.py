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
    arms it for the first epoch). The block marks its steps (the trainer's
    loop with its ``train.step`` span, the profilers with
    ``Trace.step_range``), and the trace is summarised over the steps
    after the first (``Trace.summary``, written beside the trace as
    summary.json): the window's wall time, the device's busy time (the
    union of its kernels and copies) and idle share, the device time of
    the host<->device copies, and the host time of the collectives by
    name.
  * read_chrome_trace(logdir) and chrome_events(trace_events): the newest
    trace.json under a directory, and its complete events in the form
    ``summarise`` reads (``trace`` summarises the file it wrote with them,
    and the profilers of the port read traces back with them).
  * span(name, **attrs) and count(name, n=1): spans and counters inside the
    program, recorded while a torch profiler runs anywhere in the process
    (``trace``, ``profile_step``, a benchmark's traced window) and read back
    with ``recorded()``. Off, each costs one read of the profiler's
    process-wide flag: no clock, no profiler range, nothing kept. On, a
    span keeps its name, its parent (a stack per thread), its thread, its
    start and end on the realtime clock (the clock of a Chrome trace's
    ``ts`` + ``baseTimeNanoseconds``) and its attributes; on a thread the
    profiler records it is also a ``record_function`` range, so the trace
    carries it and names the device's idle gaps with it. ``trace`` clears
    the record when it starts and writes the spans of the threads the
    profiler did not record into its trace.json, a lane for each thread.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---- spans and counters inside the program -----------------------------

MAX_SPANS = 1 << 18
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """A finished span; times in ns on the realtime clock. ``thread`` is
    the native id of the thread it ran on, None for a span that began in
    one thread and ended in another (``record``); ``traced``: it was also a
    profiler range of its thread."""

    id: int
    parent: int | None
    name: str
    thread: int | None
    start_ns: int
    end_ns: int
    attrs: dict
    traced: bool


class Recorder:
    """The spans (at most ``max_spans``; the rest are counted in
    ``dropped``) and the counters recorded since the last clear()."""

    def __init__(self):
        self.max_spans = MAX_SPANS
        self.threads = {}  # native thread id -> thread name
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.clear()

    def clear(self):
        with self._lock:
            self._spans, self._counters, self._dropped = [], {}, 0

    def thread(self):
        """This thread's stack of open span ids, and its native id."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
            self.threads[local.tid] = threading.current_thread().name
        return local.stack, local.tid

    def next_id(self):
        return next(self._ids)

    def add(self, record):
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(record)
            else:
                self._dropped += 1

    def count(self, name, n):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def recorded(self):
        with self._lock:
            return dict(spans=list(self._spans), counters=dict(self._counters),
                        dropped=self._dropped)


# one for the process, as the profiler that arms it is
RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack, _ = RECORDER.thread()
        self.parent = stack[-1] if stack else None
        self.id = RECORDER.next_id()
        stack.append(self.id)
        self.range = None
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():  # the profiler records us
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack, tid = RECORDER.thread()
        stack.pop()
        RECORDER.add(SpanRecord(self.id, self.parent, self.name, tid,
                                self.start, end, self.attrs,
                                self.range is not None))
        return False


def span(name, **attrs):
    """A span around the block while armed, else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while armed."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.count(name, n)


def stamp():
    """The realtime clock in ns while armed, else None: the start of a
    span that ends in another thread (``record``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return time.time_ns()


def record(name, start_ns, **attrs):
    """A span from ``start_ns`` (a ``stamp()``, perhaps of another thread)
    to now, with no parent, thread or profiler range; nothing when
    ``start_ns`` is None."""
    if start_ns is not None:
        RECORDER.add(SpanRecord(RECORDER.next_id(), None, name, None,
                                start_ns, time.time_ns(), attrs, False))


def recorded():
    """{'spans': [SpanRecord], 'counters': {name: n}, 'dropped': n} since
    the last clear (``trace`` clears when it starts)."""
    return RECORDER.recorded()


def _add_untraced_spans(data, spans, threads):
    """Add to a Chrome trace (its parsed JSON) the spans the profiler did
    not record, as complete events on the trace's clock: a lane for each
    thread, and one for each name of the spans that crossed threads.
    Returns how many it added."""
    spans = [s for s in spans if not s.traced]
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    lanes = {}
    spare = itertools.count(max(threads, default=0) + 1)
    events = data["traceEvents"]
    for s in spans:
        lane = s.thread if s.thread is not None else s.name
        if lane not in lanes:
            lanes[lane] = s.thread if s.thread is not None else next(spare)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": lanes[lane],
                           "args": {"name": threads.get(lane, lane)}})
        events.append({"ph": "X", "cat": "ladder_span", "name": s.name,
                       "pid": pid, "tid": lanes[lane],
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, id=s.id, parent=s.parent)})
    return len(spans)


STEP_MARK = "ladder_step#"
STEP_SPAN = "train.step"
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


def _is_step(name):
    return name == STEP_SPAN or name.startswith(STEP_MARK)


def summarise(events):
    """The summary of ``Trace`` from a profile's events, each (name, is
    device, start us, end us), over the steps after the first. A step is a
    trainer loop's ``train.step`` span or a ``Trace.step_range``."""
    steps = sorted((a, b) for name, dev, a, b in events
                   if not dev and _is_step(name))[1:]
    if not steps:
        return None
    lo = min(a for a, _ in steps)
    hi = max(b for _, b in steps)
    # the device's kernels and copies (not the device-side spans of the
    # step marks, which cover each step's work whole)
    device = [(max(a, lo), b) for name, dev, a, b in events
              if dev and b > lo and not _is_step(name)]
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
        """A profiler range around step k of a block that runs its own
        steps (the trainer's loop marks them with its ``train.step``
        span)."""
        return torch.profiler.record_function(f"{STEP_MARK}{k}")


@contextlib.contextmanager
def trace(profile_dir=None):
    """torch.profiler trace of the block into profile_dir/trace.json,
    with the spans of the threads the profiler did not record; yields a
    Trace (None when profile_dir is falsy) whose summary is set when the
    block ends."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    out = Trace()
    RECORDER.clear()
    with profile(activities=activities) as prof:
        yield out
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    # read back from the file: building prof.events() costs ten times as
    # much (~70 us an event) as writing and parsing the JSON
    with open(path) as f:
        data = json.load(f)
    if _add_untraced_spans(data, recorded()["spans"], RECORDER.threads):
        with open(path, "w") as f:
            json.dump(data, f)
    out.summary = summarise(chrome_events(data["traceEvents"]))
    with open(os.path.join(profile_dir, "summary.json"), "w") as f:
        json.dump(out.summary, f)
    print(f"profiler trace written to {path}")
