"""The controls of a cell's correctness check: the plain reference put in
the program's place, computed in the precision below the configuration's
(TF32 for float32 with TF32 off), or with a fault
planted in it (``--fault half_batch``: each step's loss over the first
half of the batch, the mean taken over it), and compared with the float32
reference exactly as a run compares the program. Nothing of the program
runs. Prints one JSON line a seed with the readings and the cell's limits.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--precision tf32] [--fault half_batch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import checks, harness, seeded
from portbench.reference import ladder_celeba as ref

LOWER = {"float32": "tf32"}


def train_control(cell, seed, precision, fault, device):
    from portbench.traffic import train_loop

    cfg = dict(cell.config)
    mix = cell.mix
    weights, batches, gm, gen, lrs = train_loop.reference_inputs(
        cfg, seed, mix, device)
    if fault == "half_batch":
        batches = [b[:b.shape[0] // 2] for b in batches]
    with ref.tf32_off():
        losses, first, after = ref.train_steps(
            cfg, weights, batches, gm, gen, lrs,
            cfg.get("fused_train_step", 1), ref.Precision(precision))
    prog = dict(losses=[{k: float(v) for k, v in s.items()} for s in losses],
                grad_norms={k: checks.norm(g) for k, g in first.items()},
                params=after)
    del losses, first, after, weights, batches
    return train_loop.reference_readings(cfg, seed, mix, device, prog,
                                         "float32")


def serve_control(cell, seed, precision, fault, device, seconds):
    from portbench.traffic import open_loop

    cfg = dict(cell.config)
    mix = cell.mix
    plan = open_loop.schedule(mix, seed, seconds)
    keep = open_loop.sample(plan, seed, mix["check_requests"])
    weights = seeded.weights(cfg, seed, device)
    stats = seeded.bn_stats(cfg, seed, device)
    pool = seeded.images(mix["pool_images"], seed, "requests", device,
                         size=cfg["dim_input_x"])
    answers = {}
    with ref.tf32_off(), torch.no_grad():
        for i in keep:
            _, path, rows, offset = plan[i]
            idx = (offset + torch.arange(rows, device=device)) % len(pool)
            outs = ref.serve(weights, cfg, path, pool[idx], stats,
                             ref.Precision(precision))
            answers[i] = tuple(o.cpu().numpy() for o in outs)
    gaps = open_loop.reference_readings(cfg, seed, mix, plan, answers,
                                        device, "float32")
    return {f"{p}_gap": g for p, g in sorted(gaps.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision")
    ap.add_argument("--fault", choices=("half_batch",))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    precision = args.precision or (
        "float32" if args.fault else LOWER[cell.config.get("dtype",
                                                           "float32")])
    for seed in args.seeds:
        if cell.mix["kind"] == "train_loop":
            readings = train_control(cell, seed, precision, args.fault,
                                     args.device)
        else:
            readings = serve_control(cell, seed, precision, args.fault,
                                     args.device, args.seconds)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              precision=precision, fault=args.fault,
                              readings=readings, limits=cell.limits)),
              flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
