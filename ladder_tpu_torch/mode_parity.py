"""The mode-1 / mode-2 quality study on CelebA of the port (the counterpart
of ``scripts/mode_parity_celeba.sh`` and ``scripts/mode_parity_combine.py``):
does the sequential step (``fused_train_step`` 1, the reference's
semantics) end where the single-pass step (2, what every quality record
runs) does?

    python -m ladder_tpu_torch.mode_parity sweep [OUT] [--device cuda|cpu]
    python -m ladder_tpu_torch.mode_parity combine [OUT] --out FILE

``sweep`` runs ``python -m ladder_tpu_torch.quality`` for seeds 0 1 2 x
``--fused 2 1`` at the flagship shapes (codes/celeba_config.json: h=512,
z=256, batch 64) on the 12,800-image synthetic set, abbreviated to 12
epochs: ``OUT/m{fused}_s{seed}.json`` with its work directory
``OUT/work_m{fused}_s{seed}`` and log ``OUT/m{fused}_s{seed}.log``; a run
whose record exists is skipped, a failing one gets 3 attempts 30 s apart.
Each run is a subprocess from the repository's root, one after another in
the shell script's order. ``--epochs``, ``--n-train`` and ``--override``
cut the study (their defaults are the shell script's).

``combine`` reads the records and writes ``mode_parity_combine.py``'s JSON
key for key: per key of ``KEYS`` both modes' values, means and spreads,
the gap, the signed ``mode2_minus_mode1_mean``, whether the gap sits
inside the seed spread; ``verdict_gap_within_spread`` and
``all_primary_within_spread``. It needs both modes at 3 seeds or more.

Departures: the default ``OUT`` is ``<tmp>/mode_parity_torch`` and the
default ``--out`` ``MODE_PARITY_torch.json`` (the JAX package's names are
its own); ``--device`` (cuda unless the caller asks for the CPU) reaches
every record.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

KEYS = ("final_val_neg_elbo", "final_train_neg_elbo", "final_val_recons",
        "final_train_recons", "sigma_final", "encoder_fid_generated_vs_test",
        "active_mixtures")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "mode_parity_torch")
SWEEP_OVERRIDE = {"sg_pretraining": 3, "accurate_fit": 3,
                  "synthetic_n_val": 512}
SEEDS = (0, 1, 2)
MODES = (2, 1)
FID_SAMPLES = 512
ATTEMPTS = 3
RETRY_WAIT = 30  # seconds after a failed attempt, as the script's sleep
TIMEOUT = 7200  # seconds an attempt may take


def quality_argv(out, fused, seed, args):
    """The quality record's arguments of one (mode, seed): the shell
    script's, in its order, then --device."""
    tag = f"m{fused}_s{seed}"
    return ["--config", "codes/celeba_config.json",
            "--out", f"{out}/{tag}.json",
            "--fused", str(fused), "--seed", str(seed),
            "--epochs", str(args.epochs), "--n-train", str(args.n_train),
            "--fid-samples", str(FID_SAMPLES),
            "--workdir", f"{out}/work_{tag}",
            "--override", args.override,
            "--device", args.device]


def _stamp():
    return time.strftime("%a %b %d %H:%M:%S %Z %Y")


def run_record(out, fused, seed, args, env, quality_cmd, attempts=ATTEMPTS):
    """One (mode, seed): skipped when its record exists, else up to
    ``attempts`` runs of ``quality_cmd`` + its arguments; returns the last
    exit code (0 when skipped)."""
    tag = f"m{fused}_s{seed}"
    path = os.path.join(out, f"{tag}.json")
    if os.path.isfile(path) and os.path.getsize(path) > 0:
        print(f"== {tag} already done", flush=True)
        return 0
    cmd = list(quality_cmd) + quality_argv(out, fused, seed, args)
    rc = None
    for attempt in range(1, attempts + 1):
        print(f"== {tag} attempt {attempt}: {_stamp()}", flush=True)
        with open(os.path.join(out, f"{tag}.log"), "w") as log:
            try:
                rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    timeout=TIMEOUT).returncode
            except subprocess.TimeoutExpired:
                rc = 124  # as timeout(1)
        print(f"== {tag} attempt {attempt} rc={rc}: {_stamp()}", flush=True)
        if rc == 0:
            break
        if attempt < attempts:
            time.sleep(RETRY_WAIT)
    return rc


def sweep(args, quality_cmd=None, attempts=ATTEMPTS):
    """The records of SEEDS x MODES in turn, each a subprocess of
    ``quality_cmd`` (default: python -m ladder_tpu_torch.quality) from the
    repository's root, each given up to ``attempts`` tries; 0 when every
    record was written."""
    quality_cmd = quality_cmd or [sys.executable, "-m",
                                  "ladder_tpu_torch.quality"]
    out = os.path.abspath(args.out_dir)
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    rcs = [run_record(out, fused, seed, args, env, quality_cmd, attempts)
           for seed in SEEDS for fused in MODES]
    print(f"== all done: {_stamp()}", flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


def combined(sweep_dir):
    """mode_parity_combine.py's record of the m*_s*.json in sweep_dir."""
    runs = {}
    for path in sorted(glob.glob(os.path.join(sweep_dir, "m*_s*.json"))):
        m = re.match(r"m(\d)_s(\d+)\.json", os.path.basename(path))
        with open(path) as f:
            runs[(int(m.group(1)), int(m.group(2)))] = json.load(f)
    modes = sorted({k[0] for k in runs})
    seeds = sorted({k[1] for k in runs})
    assert len(modes) == 2 and len(seeds) >= 3, (
        f"need both modes x >=3 seeds, have {sorted(runs)}")

    summary = {}
    verdicts = {}
    for key in KEYS:
        per_mode = {m: [runs[(m, s)][key] for s in seeds
                        if runs[(m, s)].get(key) is not None]
                    for m in modes}
        if any(not v for v in per_mode.values()):
            continue
        means = {m: sum(v) / len(v) for m, v in per_mode.items()}
        spread = {m: max(v) - min(v) for m, v in per_mode.items()}
        gap = abs(means[1] - means[2])
        max_spread = max(spread.values())
        scale = max(abs(means[1]), abs(means[2]), 1e-9)
        summary[key] = {
            "mode1": {"values": per_mode[1], "mean": means[1],
                      "spread": spread[1]},
            "mode2": {"values": per_mode[2], "mean": means[2],
                      "spread": spread[2]},
            "mode_gap": gap,
            "mode_gap_rel": gap / scale,
            # signed: negative means mode2's mean is LOWER (better for
            # neg-ELBO/recons/FID, where lower = better)
            "mode2_minus_mode1_mean": means[2] - means[1],
            "max_seed_spread": max_spread,
            "gap_within_spread": bool(gap <= max_spread),
        }
        verdicts[key] = summary[key]["gap_within_spread"]

    return {
        "what": ("fused_train_step=1 (reference-sequential) vs =2 "
                 "(single-pass simultaneous updates) CelebA quality at "
                 "flagship shapes (h=512, z=256, batch 64), 12-epoch "
                 "abbreviated recipe on the 12.8k-image synthetic set, "
                 "seeds " + ",".join(map(str, seeds))),
        "recipe": {k: runs[(2, seeds[0])]["recipe"][k]
                   for k in runs[(2, seeds[0])]["recipe"]},
        "overrides": runs[(2, seeds[0])].get("overrides"),
        "train_wall_s": {f"mode{m}": [runs[(m, s)]["train_wall_s"]
                                      for s in seeds] for m in modes},
        "metrics": summary,
        "verdict_gap_within_spread": verdicts,
        "all_primary_within_spread": bool(
            verdicts.get("final_val_neg_elbo", False)),
    }


def combine(args):
    rec = combined(args.out_dir)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "metrics"},
                     indent=1))
    for key, s in rec["metrics"].items():
        print(f"{key}: mode1 {s['mode1']['mean']:.4f} (spread "
              f"{s['mode1']['spread']:.4f}) vs mode2 "
              f"{s['mode2']['mean']:.4f} (spread {s['mode2']['spread']:.4f})"
              f" -> gap {s['mode_gap']:.4f} "
              f"{'WITHIN' if s['gap_within_spread'] else 'BEYOND'} spread")
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sweep", help="run the quality records")
    p.add_argument("out_dir", nargs="?", default=DEFAULT_DIR)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--n-train", type=int, default=12800)
    p.add_argument("--override", default=json.dumps(SWEEP_OVERRIDE))
    p.set_defaults(fn=sweep)
    p = sub.add_parser("combine", help="combine the records")
    p.add_argument("out_dir", nargs="?", default=DEFAULT_DIR)
    p.add_argument("--out", default="MODE_PARITY_torch.json")
    p.set_defaults(fn=combine)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ladder_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
