"""Traffic kind ``open_loop``: requests arriving on a fixed schedule into
the serving front (``Batcher`` over ``InferenceEngine`` of
ladder_tpu_torch), in one process.

The schedule is the mix's: ``rate_rps`` requests a second over the
window, each a path (``paths``: name -> share) and a number of images
(``sizes``: [share, lo, hi] bands, uniform inside a band). The set of
gaps, paths and sizes is drawn once from the mix's ``table_seed`` and
put in another order by the run's seed, so every seed offers the same
work. Each request sends uint8 rows of a pool of images made from the
seed. It is timed from when it was due until its answer is set; one that
fails, or has no answer a minute after the window closes, counts as
missing (infinitely late). The engine serves the configuration's weights,
made from the seed, with the encoder's BatchNorm frozen to statistics
made from the seed (``bn_stats_path``), so a request's rows do not depend
on what they were batched with.

Set-up warms each path at each bucket. With --trace 1 the requests due in
the first half of the window are served untraced (the host clocks and
the batcher's counters), those of the second half under the profiler.

After the answers are in and the memory is read, the program is freed and
the reference recomputes a sample of the answered requests, drawn from the
seed with the largest among them.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from portbench import checks, seeded, yardstick
from portbench.reference import ladder_celeba as ref

LATENCY_METRIC = "serve_p95_ms"
ANSWER_WAIT_S = 60.0


class EngineClock:
    """The engine as the batcher sees it, with each call's path, rows,
    bucket, start and host time recorded (the calls return host arrays,
    so each ends synchronised)."""

    def __init__(self, engine):
        self._engine = engine
        self.calls = []

    def _timed(self, path):
        fn = getattr(self._engine, path)

        def call(x):
            t0 = time.perf_counter()
            out = fn(x)
            n = len(x)
            self.calls.append((path, n, self._engine._bucket_for(n), t0,
                               time.perf_counter() - t0))
            return out
        return call

    def __getattr__(self, name):
        if name in ("reconstruct", "represent"):
            return self._timed(name)
        return getattr(self._engine, name)


def schedule(mix, seed, seconds):
    """[(due s, path, rows, pool offset)] of one window."""
    n = max(1, int(round(mix["rate_rps"] * seconds)))
    rng = np.random.default_rng(mix["table_seed"])
    gaps = rng.exponential(1.0, n)
    gaps *= seconds / (gaps.sum() + gaps.mean())
    names = sorted(mix["paths"])
    shares = np.array([mix["paths"][p] for p in names], float)
    paths = rng.choice(len(names), n, p=shares / shares.sum())
    bands = mix["sizes"]
    w = np.array([b[0] for b in bands], float)
    band = rng.choice(len(bands), n, p=w / w.sum())
    rows = np.array([rng.integers(bands[b][1], bands[b][2] + 1)
                     for b in band])
    offsets = rng.integers(0, mix["pool_images"], n)
    order = np.random.default_rng(seeded.sub_seed(seed, "order")
                                  ).permutation(n)
    due = np.cumsum(gaps[order])
    return [(float(due[i]), names[paths[j]], int(rows[j]), int(offsets[j]))
            for i, j in enumerate(order)]


def _rows(pool, offset, n):
    idx = (offset + np.arange(n)) % len(pool)
    return np.ascontiguousarray(pool[idx])


def _write_bn_stats(path, stats):
    flat = {}
    for name, (mean, var) in stats.items():
        flat[f"{name}/mean"] = mean.cpu().numpy()
        flat[f"{name}/var"] = var.cpu().numpy()
    np.savez(path, **flat)


def setup(run):
    """The engine and batcher, warmed; returns the serving state."""
    from ladder_tpu_torch.serving.batcher import Batcher
    from ladder_tpu_torch.serving.engine import InferenceEngine
    from ladder_tpu_torch.utils.config import apply_defaults, validate_config

    mix, device = run.cell.mix, run.device
    cfg = validate_config(apply_defaults(dict(run.cell.config)))
    cfg.update(checkpoint_dir=os.path.join(run.workdir, "checkpoint"),
               result_dir=os.path.join(run.workdir, "result"),
               enable_plots=0)
    bn_path = os.path.join(run.workdir, "bn_stats.npz")
    _write_bn_stats(bn_path, seeded.bn_stats(cfg, run.seed, device))
    engine = InferenceEngine(cfg, serve_batch=mix["serve_batch"],
                             buckets=tuple(mix["buckets"]),
                             allow_uninitialized=True, bn_stats_path=bn_path,
                             device=device)
    engine.model.load_state_dict(seeded.weights(cfg, run.seed, device),
                                 strict=True)
    clock = EngineClock(engine)
    batcher = Batcher(clock, max_wait_ms=mix["max_wait_ms"])
    pool = seeded.images(mix["pool_images"], run.seed, "requests", device,
                         size=cfg["dim_input_x"]).cpu().numpy()
    for path in sorted(mix["paths"]):
        for b in sorted(set(mix["buckets"]) | {mix["serve_batch"]}):
            for _ in range(2):
                batcher.submit(path, pool[:b]).result()
    clock.calls.clear()
    return dict(cfg=cfg, engine=engine, clock=clock, batcher=batcher,
                pool=pool)


def window(state, plan, trace=False, keep=(), workdir=None):
    """Offer the requests of ``plan``; returns the per-request records,
    the kept answers, and the host and trace records of the two halves."""
    batcher, clock, pool = state["batcher"], state["clock"], state["pool"]
    n = len(plan)
    done = [None] * n
    answers = {}
    errors = [None] * n
    keep = set(keep)
    half = plan[-1][0] / 2 if trace else math.inf
    prof = mark = None
    split = {}

    def finish(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is not None:
            errors[i] = fut.exception()
        elif i in keep:
            answers[i] = fut.result()

    futs, sent = [], [0.0] * n
    t0 = time.perf_counter()
    for i, (due, path, rows, offset) in enumerate(plan):
        if prof is None and due >= half:
            split = dict(stats=dict(batcher.stats), calls=len(clock.calls),
                         t=time.perf_counter())
            prof = yardstick.profiler(state["engine"].device)
            prof.__enter__()
            mark = torch.profiler.record_function(yardstick.WINDOW_MARK)
            mark.__enter__()
        x = _rows(pool, offset, rows)
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent[i] = time.perf_counter()
        fut = batcher.submit(path, x)
        fut.add_done_callback(lambda f, i=i: finish(i, f))
        futs.append(fut)
    t_close = t0 + plan[-1][0]
    for fut in futs:
        try:
            fut.result(timeout=max(0.0, t_close + ANSWER_WAIT_S
                                   - time.perf_counter()))
        except Exception:  # noqa: BLE001 - counted as missing below
            pass
    summary = None
    if prof is not None:
        if str(state["engine"].device).startswith("cuda"):
            torch.cuda.synchronize()
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        summary = yardstick.read_profile(prof, workdir)
    lat = []
    for i, (due, _, _, _) in enumerate(plan):
        ok = done[i] is not None and errors[i] is None
        lat.append((done[i] - (t0 + due)) * 1e3 if ok else math.inf)
    late = [(sent[i] - (t0 + plan[i][0])) * 1e3 for i in range(n)]
    return dict(latency_ms=lat, late_ms=late, answers=answers,
                failed=sum(1 for v in lat if math.isinf(v)), split=split,
                trace=summary, t0=t0)



def sample(plan, seed, count):
    """Indices of the requests the reference recomputes: ``count`` drawn
    from the seed, with the largest request among them."""
    rng = np.random.default_rng(seeded.sub_seed(seed, "sample"))
    largest = max(range(len(plan)), key=lambda i: plan[i][2])
    pick = rng.choice(len(plan), min(count, len(plan)), replace=False)
    return sorted(set(int(i) for i in pick) | {largest})


def reference_readings(cfg, seed, mix, plan, answers, device, precision):
    """{path: worst output gap} of the answered sampled requests against
    the reference; a sampled request with no answer reads infinite."""
    weights = seeded.weights(cfg, seed, device)
    stats = seeded.bn_stats(cfg, seed, device)
    pool = seeded.images(mix["pool_images"], seed, "requests", device,
                         size=cfg["dim_input_x"])
    prec = ref.Precision(precision)
    gaps = {p: 0.0 for p in mix["paths"]}
    with ref.tf32_off(), torch.no_grad():
        for i, out in answers.items():
            _, path, rows, offset = plan[i]
            idx = torch.as_tensor((offset + np.arange(rows))
                                  % len(pool), device=device)
            outs = ref.serve(weights, cfg, path, pool[idx], stats, prec)
            prog = out if isinstance(out, tuple) else (out,)
            for p, r in zip(prog, outs):
                gaps[path] = max(gaps[path], checks.output_gap(p, r))
    return gaps


def run(run):
    mix, device = run.cell.mix, run.device
    state = setup(run)
    plan = schedule(mix, run.seed, run.seconds)
    keep = sample(plan, run.seed, mix["check_requests"])
    run.setup_s = time.perf_counter() - run.process_start
    stats0 = dict(state["batcher"].stats)
    rec = window(state, plan, run.trace, keep, run.workdir)
    state["batcher"].close()
    cfg = state["cfg"]
    run.attempted, run.failed = len(plan), rec["failed"]
    if not run.trace:
        run.e2e[LATENCY_METRIC] = yardstick.percentile(rec["latency_ms"], 95)
    split = rec["split"] or dict(stats=dict(state["batcher"].stats),
                                 calls=len(state["clock"].calls))
    calls = state["clock"].calls
    run.host.update(
        batcher=(stats0, split["stats"]),
        untraced_calls=calls[:split["calls"]],
        traced_calls=calls[split["calls"]:] if rec["trace"] else [],
        row_flops={p: yardstick.serve_row_flops(cfg, p)
                   for p in mix["paths"]},
        decode_bounds={b: yardstick.bound_seconds(
            *yardstick.kernel_bounds(cfg, b, cfg["dtype"])["norm_chain_fwd"],
            cfg["dtype"])
            for b in set(mix["buckets"]) | {mix["serve_batch"]}},
        late_ms=rec["late_ms"], latency_ms=rec["latency_ms"])
    run.trace_summary = rec["trace"]
    if str(device).startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    answers = rec["answers"]
    del state, rec
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    gaps = reference_readings(cfg, run.seed, mix, plan, answers, device,
                              "float32")
    missing = [i for i in keep if i not in answers]
    run.readings = {f"{p}_gap": math.inf if missing else g
                    for p, g in sorted(gaps.items())}
    run.checks = {k: (v, run.cell.limits[k])
                  for k, v in run.readings.items() if k in run.cell.limits}
