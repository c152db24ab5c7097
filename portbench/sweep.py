"""Finds a serving cell's knee: the highest request rate at which the
program holds no growing backlog. One set-up, then one window a rate on
the same engine, the cell's mix at each rate; prints one JSON line a rate
(p50 and p95 latency, how late the generator ran, and the latency of the
first and last quarters of the window's requests, whose ratio shows a
backlog that grows).

    python -m portbench.sweep --workload <cell> --seed <n> --seconds <s>
        --rates <rps> [<rps> ...]

Window i orders its requests by seed + i.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import tempfile

from portbench import harness, yardstick
from portbench.traffic import open_loop


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    with tempfile.TemporaryDirectory(prefix="portbench-sweep-") as work:
        run = harness.Run(cell, args.seed, args.seconds, False, args.device,
                          work)
        with contextlib.redirect_stdout(sys.stderr):
            state = open_loop.setup(run)
        for i, rate in enumerate(args.rates):
            mix = dict(cell.mix, rate_rps=rate)
            plan = open_loop.schedule(mix, args.seed + i, args.seconds)
            before = dict(state["batcher"].stats)
            rec = open_loop.window(state, plan)
            lat = rec["latency_ms"]
            q = max(1, len(lat) // 4)
            after = state["batcher"].stats
            batches = after["batches"] - before["batches"]
            print(json.dumps(dict(
                rate_rps=rate, seed=args.seed + i, requests=len(plan),
                failed=rec["failed"],
                images_s=sum(p[2] for p in plan) / args.seconds,
                p50_ms=yardstick.percentile(lat, 50),
                p95_ms=yardstick.percentile(lat, 95),
                first_quarter_p50_ms=statistics.median(lat[:q]),
                last_quarter_p50_ms=statistics.median(lat[-q:]),
                late_p95_ms=yardstick.percentile(rec["late_ms"], 95),
                rows_per_call=(after["rows"] - before["rows"]) / batches
                if batches else None)), flush=True)
        state["batcher"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
