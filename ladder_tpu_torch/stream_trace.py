"""Streamed-training overlap on the card (the counterpart of
``scripts/stream_trace.py``):

    python -m ladder_tpu_torch.stream_trace [--batch 64] [--steps 40]
        [--warmup 6] [--out STREAM_torch.json] [--device cuda|cpu]

Traces real streamed CelebA-128 training (bf16, mode 2, the JAX script's
config): TFRecord decode by the native reader and the prefetch thread's
copy to the card (``data/celeba.py``: ``CelebAData`` ``epoch(...,
to_device=device)``), then accounts the device's idle time against the
copy's cost, to show whether the pipeline overlaps (wall a step ~=
max(transfer, compute)) or serialises (transfer + compute).

Writes one JSON record with the JAX script's keys:
  wall_step_ms        wall clock a streamed step, over the traced steps
  device_busy_ms      device time a step: the union of the kernels and
                      copies in the trace's window (``utils/profiling.py:
                      summarise``, over the steps after the first); the
                      JAX script sums its XLA ops' durations instead
  device_idle_ms      the window a step less device_busy_ms
  transfer_ms         a batch's host-to-device time: pipelined
                      ``.to(device, non_blocking=True)`` copies of pinned
                      decoded batches, as the prefetch thread makes them
  serial_bound_ms     transfer + busy (a pipeline that does not overlap)
  overlap_bound_ms    max(transfer, busy) (one that overlaps perfectly)
  overlap_efficiency  (serial_bound - wall) / (serial_bound -
                      overlap_bound): 1 = perfect overlap, 0 = serial

A trace without CUDA activity (a run on the CPU) stops with a message.
``--device`` is cuda unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time


def device_window_and_busy(logdir):
    """(window_ms, busy_ms, steps) of the newest trace under ``logdir``:
    ``summarise``'s window and device busy time over the marked steps
    after the first, and how many steps that is."""
    from ladder_tpu_torch.utils.profiling import (chrome_events,
                                                  read_chrome_trace, summarise)

    events = chrome_events(read_chrome_trace(logdir))
    summary = summarise(events)
    if summary is None or not any(dev for _, dev, _, _ in events):
        raise SystemExit("trace has no CUDA activity — was the run on the "
                         "CPU? (the overlap accounting needs the card's "
                         "kernels and copies)")
    return summary["wall_ms"], summary["device_busy_ms"], summary["steps"]


def build_config(args):
    """The JAX script's config for these arguments."""
    from ladder_tpu_torch.profile_step import celeba_config

    return celeba_config(args.batch, args.hidden, dtype="bfloat16",
                         fused_train_step=2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--out", default="STREAM_torch.json")
    ap.add_argument("--logdir", default="/tmp/ladder_torch_stream_trace")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ladder_tpu_torch.data.celeba import CelebAData
    from ladder_tpu_torch.profile_step import train_setup
    from ladder_tpu_torch.utils.device import resolve_device
    from ladder_tpu_torch.utils.profiling import synchronize, trace

    device = resolve_device(args.device)
    cfg = build_config(args)
    state, step, rest = train_setup(cfg, device)
    n_total = args.steps + args.warmup
    with tempfile.TemporaryDirectory() as td:
        data = CelebAData(dict(cfg, synthetic_data=1,
                               synthetic_n_train=args.batch * n_total,
                               synthetic_n_val=args.batch,
                               synthetic_n_test=args.batch,
                               data_path=td + "/"))

        # -- steady-state transfer cost: pipelined copies of pinned decoded
        # batches (the prefetch thread's copy, minus the compute)
        host_batches = list(data.train.epoch(args.batch, seed=1,
                                             prefetch=False))[:20]
        pinned = [torch.from_numpy(b).pin_memory()
                  if device.type == "cuda" else torch.from_numpy(b)
                  for b in host_batches]
        # warm the transfer path
        synchronize(pinned[0].to(device, non_blocking=True))
        t0 = time.perf_counter()
        puts = [b.to(device, non_blocking=True) for b in pinned]
        synchronize(puts)
        transfer_ms = (time.perf_counter() - t0) * 1e3 / len(puts)
        nbytes = host_batches[0].nbytes
        link_mbs = nbytes / (transfer_ms / 1e3) / 1e6
        del puts

        # -- streamed training, traced after warmup
        it = iter(data.train.epoch(args.batch, seed=0, to_device=device))
        for _ in range(args.warmup):
            state, out = step(state, next(it), *rest)
        synchronize(out)

        shutil.rmtree(args.logdir, ignore_errors=True)
        n = 0
        with trace(args.logdir) as tr:
            t0 = time.perf_counter()
            for b in it:
                with tr.step_range(n):
                    state, out = step(state, b, *rest)
                n += 1
            synchronize(out)
            # the steps' wall, not the trace's export
            wall_ms = (time.perf_counter() - t0) * 1e3 / n

    window_ms, busy_total_ms, traced = device_window_and_busy(args.logdir)
    busy_ms = busy_total_ms / traced
    idle_ms = max(0.0, window_ms / traced - busy_ms)
    serial_bound = transfer_ms + busy_ms
    overlap_bound = max(transfer_ms, busy_ms)
    eff = ((serial_bound - wall_ms) / (serial_bound - overlap_bound)
           if serial_bound > overlap_bound else 1.0)

    rec = {
        "what": ("streamed CelebA-128 training of the port (native "
                 "TFRecord decode + the prefetch thread's copy to the "
                 "card) traced on the card; overlap accounting of device "
                 "idle vs transfer starvation"),
        "batch": args.batch,
        "steps": n,
        "batch_mb": round(nbytes / 1e6, 2),
        "wall_step_ms": round(wall_ms, 2),
        "device_busy_ms": round(busy_ms, 2),
        "device_idle_ms": round(idle_ms, 2),
        "transfer_ms": round(transfer_ms, 2),
        "link_mbs": round(link_mbs, 1),
        "serial_bound_ms": round(serial_bound, 2),
        "overlap_bound_ms": round(overlap_bound, 2),
        "overlap_efficiency": round(eff, 3),
        "img_per_s": round(args.batch / wall_ms * 1e3, 1),
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
