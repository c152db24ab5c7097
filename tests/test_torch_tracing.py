"""Spans and counters inside the port (utils/profiling.py): off, a span
costs one flag read and records nothing; a running torch profiler arms
them in every thread, with parents and ids, on the Chrome trace's clock;
``trace`` writes the spans of the threads it did not record into its
trace.json; the train step's sub-step tree and the serving front's spans
and counters agree with what the step and the batcher did."""

import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.serving import Batcher, InferenceEngine
from ladder_tpu_torch.training import step as tstep
from ladder_tpu_torch.training.losses import identity_gm
from ladder_tpu_torch.training.trainer import JointTrainer
from ladder_tpu_torch.utils import profiling
from ladder_tpu_torch.utils.config import apply_defaults, validate_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
STEP_GROUPS = ["ae", "sigma", "prior", "inner_sigma", "z_std"]


def tiny_cfg(tmp_path, **kw):
    """The published CelebA recipe at widths a CPU test holds."""
    cfg = json.loads((ROOT / "codes" / "celeba_config.json").read_text())
    cfg.update(num_hidden_units=16, code_size=8, representation_size=2,
               num_hidden_units_inner_VAE=8, n_layers_inner_VAE=2,
               n_MC_samples=2, n_mixtures=3, batch_size=2, enable_plots=0,
               checkpoint_dir=str(tmp_path / "ckpt"),
               result_dir=str(tmp_path / "result"), **kw)
    return validate_config(apply_defaults(cfg))


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def dur(s):
    return s.end_ns - s.start_ns


def children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


def self_ns(spans, parent):
    """The span's time less the union of its children's."""
    covered, end = 0, None
    for c in children(spans, parent):
        a, b = max(c.start_ns, end or c.start_ns), c.end_ns
        if b > a:
            covered += b - a
        end = max(end or b, b)
    return dur(parent) - covered


def armed():
    return torch.autograd.profiler._is_profiler_enabled


def test_off_reads_one_flag_and_records_nothing(monkeypatch):
    assert not armed()
    profiling.RECORDER.clear()
    calls = []

    def counting(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called while off")
        return f

    monkeypatch.setattr(time, "time_ns", counting("time_ns"))
    monkeypatch.setattr(time, "perf_counter", counting("perf_counter"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function"))
    first = profiling.span("a", step=1)
    assert profiling.span("b") is first  # one shared null context
    with first as handle, profiling.span("b"):
        profiling.count("c", 3)
        assert handle is None and profiling.stamp() is None
        profiling.record("d", profiling.stamp(), request=0)
    monkeypatch.undo()
    got = profiling.recorded()
    assert calls == [] and got == dict(spans=[], counters={}, dropped=0)


def test_a_cpu_profiler_arms_every_thread(tmp_path):
    profiling.RECORDER.clear()
    ids = {}

    def worker():
        ids["worker"] = threading.get_native_id()
        with profiling.span("worker.outer", batch=7):
            with profiling.span("worker.inner"):
                pass
        profiling.record("crossed", start, request=3)

    with cpu_profile() as prof:
        assert armed()
        with torch.profiler.record_function("warm"):  # the first range's
            pass                                       # lazy set-up
        profiling.RECORDER.clear()
        start = profiling.stamp()
        with profiling.span("anchor", step=0):
            with profiling.span("anchor.child"):
                torch.ones(4).sum()
            profiling.count("rows", 2)
            profiling.count("rows")
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and not armed()
    got = profiling.recorded()
    by = {s.name: s for s in got["spans"]}
    assert set(by) == {"anchor", "anchor.child", "worker.outer",
                       "worker.inner", "crossed"}
    assert len({s.id for s in got["spans"]}) == 5
    assert got["counters"] == {"rows": 3} and got["dropped"] == 0
    main = threading.get_native_id()
    assert by["anchor"].parent is None and by["anchor"].attrs == {"step": 0}
    assert by["anchor.child"].parent == by["anchor"].id
    assert by["worker.outer"].parent is None
    assert by["worker.inner"].parent == by["worker.outer"].id
    assert by["worker.outer"].attrs == {"batch": 7}
    assert by["anchor"].thread == main
    assert by["worker.inner"].thread == ids["worker"] != main
    # the main thread's spans are profiler ranges too; the worker's are not
    assert by["anchor"].traced and by["anchor.child"].traced
    assert not by["worker.outer"].traced and not by["worker.inner"].traced
    cross = by["crossed"]
    assert (cross.thread, cross.parent, cross.attrs) == (None, None,
                                                         {"request": 3})
    assert cross.start_ns == start <= by["anchor"].start_ns
    assert all(s.end_ns >= s.start_ns for s in got["spans"])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    notes = {e["name"]: e for e in data["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"anchor", "anchor.child"} <= set(notes)
    assert not {"worker.outer", "worker.inner"} & set(notes)
    # one clock: the span's start against the trace's ts + base, in ns
    base = int(data.get("baseTimeNanoseconds", 0))
    ts_ns = float(notes["anchor"]["ts"]) * 1e3 + base
    assert abs(ts_ns - by["anchor"].start_ns) < 1e6


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    profiling.RECORDER.clear()
    monkeypatch.setattr(profiling.RECORDER, "max_spans", 2)
    with cpu_profile():
        for k in range(5):
            with profiling.span("s", step=k):
                pass
    got = profiling.recorded()
    assert [s.attrs["step"] for s in got["spans"]] == [0, 1]
    assert got["dropped"] == 3


def test_trace_writes_unrecorded_threads_and_finds_steps(tmp_path):
    def worker():
        with profiling.span("serve.batch", batch=0):
            with profiling.span("engine.call", rows=1):
                pass

    profiling.RECORDER.clear()
    with profiling.span("left.over"):  # armed by no profiler: not kept
        pass
    with profiling.trace(str(tmp_path)) as tr:
        for k in range(3):
            with profiling.span(profiling.STEP_SPAN, step=k):
                torch.ones(8).sum()
        t = threading.Thread(target=worker, name="serving-batcher")
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert tr.summary["steps"] == 2  # the steps after the first
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "ladder_span"]
    assert [e["name"] for e in mine] == ["engine.call", "serve.batch"]
    lanes = {e["tid"] for e in mine}
    assert len(lanes) == 1
    lane = lanes.pop()
    assert lane != threading.get_native_id()
    assert {"ph": "M", "name": "thread_name", "pid": mine[0]["pid"],
            "tid": lane, "args": {"name": "serving-batcher"}} in events
    outer = mine[1]
    assert outer["args"]["batch"] == 0 and outer["args"]["parent"] is None
    assert mine[0]["args"]["parent"] == outer["args"]["id"]
    steps = [e for e in events if e.get("name") == profiling.STEP_SPAN
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 3
    # on the trace's clock: the worker ran after the steps
    assert max(e["ts"] + e["dur"] for e in steps) < outer["ts"]


@pytest.mark.parametrize("mode", [1, 2])
def test_the_step_loop_records_the_substep_tree(tmp_path, mode):
    cfg = tiny_cfg(tmp_path, fused_train_step=mode,
                   TRAIN_decoded_z_std=int(mode == 1))
    model = make_model(cfg)
    state = tstep.init_state(model, device="cpu")
    gm = identity_gm(cfg["n_mixtures"], cfg["representation_size"],
                     device="cpu")
    batch = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    loop = types.SimpleNamespace(
        train_batches=lambda: [batch], _place=lambda b: b,
        train_step=tstep.make_train_step(model), state=state,
        generator=torch.Generator().manual_seed(0),
        mid_epoch_hook=lambda i: None)
    timer = profiling.StepTimer()
    lrs = dict(ae=1e-4, sigma=1e-4, prior=1e-4, inner_sigma=1e-4)
    flags = {"use_sg_prior": False, "use_mask": False}
    profiling.RECORDER.clear()
    with cpu_profile():
        outs = JointTrainer._run_steps(loop, timer, gm, flags, lrs, True,
                                       False, False)
    assert len(outs) == 1 and len(timer.times) == 1
    spans = profiling.recorded()["spans"]
    top = sorted((s for s in spans if s.parent is None),
                 key=lambda s: s.start_ns)
    # a wait for the batch the step took, the step, the wait that ended
    assert [(s.name, s.attrs) for s in top] == [
        ("train.batch_wait", {"step": 0}), ("train.step", {"step": 0}),
        ("train.batch_wait", {"step": 1})]
    step = top[1]
    leaves = ["forward", "backward", "update"]
    if mode == 1:
        subs = children(spans, step)
        assert [s.name for s in subs] == [f"train.step.{g}"
                                          for g in STEP_GROUPS]
        for sub in subs:
            assert [c.name for c in children(spans, sub)] == [
                f"{sub.name}.{leaf}" for leaf in leaves]
            assert self_ns(spans, sub) >= 0
    else:
        assert [c.name for c in children(spans, step)] == [
            f"train.step.{leaf}" for leaf in leaves]
    assert self_ns(spans, step) >= 0
    for s in spans:
        assert self_ns(spans, s) >= 0 and s.traced
    # the mixture's density, inside the forwards that score t
    by_id = {s.id: s for s in spans}
    mix = [s for s in spans if s.name == "mixture.logpdf"]
    assert mix and all(by_id[s.parent].name.endswith(".forward")
                       for s in mix)


def test_batcher_spans_and_counters_match_its_stats(tmp_path):
    cfg = tiny_cfg(tmp_path)
    engine = InferenceEngine(cfg, serve_batch=4, buckets=(2,),
                             allow_uninitialized=True, device="cpu")
    batcher = Batcher(engine, max_wait_ms=20)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)
              for n in (1, 1, 2, 1, 3, 1)]
    batcher.reconstruct(images[0])  # warm
    before = dict(batcher.stats)
    profiling.RECORDER.clear()
    with cpu_profile():
        futs = []
        threads = [threading.Thread(
            target=lambda x=x: futs.append(batcher.submit("reconstruct", x)))
            for x in images]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        outs = [f.result(timeout=60) for f in list(futs)]
    batcher.close()
    assert len(outs) == len(images)
    delta = {k: batcher.stats[k] - before[k] for k in before}
    got = profiling.recorded()
    spans = got["spans"]

    def named(name):
        return [s for s in spans if s.name == name]

    queue, batches = named("serve.queue"), named("serve.batch")
    assert len(queue) == delta["requests"] == len(images)
    assert len({s.attrs["request"] for s in queue}) == len(queue)
    assert len(batches) == delta["batches"]
    assert sum(b.attrs["rows"] for b in batches) == delta["rows"] == 9
    assert sum(b.attrs["requests"] for b in batches) == len(images)
    assert {s.attrs["batch"] for s in queue} == {b.attrs["batch"]
                                                 for b in batches}
    for b in batches:
        assert sum(s.attrs["batch"] == b.attrs["batch"]
                   for s in queue) == b.attrs["requests"]
    calls = named("engine.call")
    assert sorted(c.parent for c in calls) == sorted(b.id for b in batches)
    for c in calls:
        assert [s.name for s in children(spans, c)] == [
            "engine.pad", "engine.upload", "engine.launch",
            "engine.download"]
        assert c.attrs["bucket"] == (2 if c.attrs["rows"] <= 2 else 4)
    assert got["counters"] == {
        "engine.rows": delta["rows"],
        "engine.pad_rows": sum(c.attrs["bucket"] - c.attrs["rows"]
                               for c in calls)}
    for name in ("serve.linger", "serve.gather", "serve.scatter"):
        assert len(named(name)) == len(batches)
    # the worker is not a thread the profiler records
    assert not any(s.traced for s in spans)
    worker = {s.thread for s in spans if s.thread is not None}
    assert len(worker) == 1 and threading.get_native_id() not in worker
