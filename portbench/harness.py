"""Runs one cell of the benchmark once (see portbench/__init__.py).

A cell is portbench/workloads/<cell>.json: its configuration (a file of
portbench/configs/), its traffic mix (portbench/traffic/<mix>.json, whose
"kind" names the generator module portbench/traffic/<kind>.py), the chips
it takes and the limits of its correctness check. The metrics a run
reports are BENCHMARK.json's: with --trace 0 the cell's end-to-end ones,
which the traffic generator measures, with --trace 1 its per-layer ones,
each read by portbench/metrics/<metric>.py from what the run recorded.
Adding a cell, a mix or a metric adds files; none here changes.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ladder_tpu")


def _process_start():
    """This process's start on the perf_counter clock (Linux: its start
    time since boot against the uptime), else the harness's import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        now = time.perf_counter()
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()


def load_json(folder, name):
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(folder, name):
    """portbench/<folder>/<name>.py as a module (names may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload: its configuration, mix, generator and limits."""

    def __init__(self, name, config_overrides=None, mix_overrides=None):
        self.name = name
        self.workload = load_json("workloads", name)
        self.config_file = load_json("configs", self.workload["config"])
        self.config = dict(self.config_file["config"])
        self.config.update(config_overrides or {})
        self.mix = dict(load_json("traffic", self.workload["traffic"]))
        self.mix.update(mix_overrides or {})
        self.kind = load_module("traffic", self.mix["kind"])
        self.chips = int(self.workload["chips"])
        self.limits = dict(self.workload["limits"])


def benchmark_spec(root=None):
    """BENCHMARK.json at the root of the checkout."""
    path = Path(root or Path.cwd()) / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell_metrics(spec, cell):
    """(end-to-end metrics, per-layer metrics) that BENCHMARK.json gives
    ``cell``."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, cell, names)]
    return e2e, layer


def forbidden_loaded():
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (the program's name begins with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def cache_environment(root):
    """Build and kernel caches at fixed paths inside the checkout; no
    library of the program loads JAX."""
    cache = Path(root) / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


class Run:
    """What a traffic generator is handed and fills in."""

    def __init__(self, cell, seed, seconds, trace, device, workdir):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.workdir = bool(trace), device, workdir
        self.process_start = PROCESS_START
        self.setup_s = None
        self.e2e = {}              # end-to-end values by metric name
        self.host = {}             # the host-side records the readers use
        self.trace_summary = None  # yardstick.summarise of the traced part
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.readings = {}         # every number the comparison read
        self.checks = {}           # the compared ones: name -> (value, limit)


def execute(cell_name, seed, seconds, trace, device="cuda",
            config_overrides=None, mix_overrides=None, root=None):
    """Run one cell once; returns the result dict (the printed line)."""
    root = Path(root or Path.cwd())
    spec = benchmark_spec(root)
    cell = Cell(cell_name, config_overrides, mix_overrides)
    e2e, layer = cell_metrics(spec, cell_name)
    base = os.environ.get("TMPDIR") or None
    workdir = tempfile.mkdtemp(prefix="portbench-", dir=base)
    run = Run(cell, seed, seconds, trace, device, workdir)
    try:
        cell.kind.run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    metrics = {}
    if not trace:
        for m in e2e:
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.e2e.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(run.checks) and all(
        v is not None and math.isfinite(v) and v <= lim
        for v, lim in run.checks.values())
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_record(cell.chips, run, device)}
    if trace and run.trace_summary is not None:
        result["breakdown"] = run.trace_summary["breakdown"]
    result["readings"] = run.readings
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    return result


def device_record(chips, run, device):
    import torch

    rec = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if str(device).startswith("cuda") else "cpu"),
           "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.trace_summary is not None:
        rec["busy_s"] = run.trace_summary["busy_s"]
        rec["window_s"] = run.trace_summary["window_s"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_environment(root)
    import torch

    chips = int(load_json("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = execute(args.workload, args.seed, args.seconds,
                         args.trace, "cuda", root=root)
        gc.collect()
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    return 0
