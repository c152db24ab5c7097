"""Calibrate the quality check from a measured seed-to-seed spread (the
counterpart of ``scripts/quality_spread.py``): run the port's quality
record (``python -m ladder_tpu_torch.quality``) at N seeds, compute each
metric's relative spread and write it into the record named by
``--anchor`` as

  "seed_spread": {"seeds": [...], "rel": {metric: (max-min)/|mean|},
                  "active_mixtures_band": max(2*abs spread, 3),
                  "records": {seed: {metric: value}}}

so that ``quality.check_against`` derives per-metric tolerances
(max(2*spread, 0.5%)) instead of the one ``--check-rtol``.

    python -m ladder_tpu_torch.quality_spread \\
        --anchor QUALITY_torch_mnist_digit.json \\
        --config codes/mnist_digit_config.json --seeds 0 1

Point ``--anchor`` only at the port's own record (``QUALITY_torch*.json``),
never at a ``QUALITY_r04*.json``: those are the JAX package's anchors, and
the port's seeds are not the JAX package's. ``--extra`` passes the arguments
after it on to the quality record (``--extra --device cpu --n-train 12800
--override '{...}'``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from ladder_tpu_torch.quality import is_jax_anchor

SCALE_KEYS = ("final_train_neg_elbo", "final_val_neg_elbo",
              "final_train_recons", "final_val_recons", "sigma_final",
              "encoder_fid_generated_vs_test")


def seed_spread(records, seeds):
    """The ``seed_spread`` entry of per-seed records ({seed: record})."""
    rel = {}
    for key in SCALE_KEYS:
        vals = [records[s][key] for s in seeds
                if records[s].get(key) is not None]
        if len(vals) < 2:
            continue
        mean = sum(vals) / len(vals)
        rel[key] = (max(vals) - min(vals)) / max(abs(mean), 1e-9)
    am = [records[s]["active_mixtures"] for s in seeds
          if records[s].get("active_mixtures") is not None]
    return {
        "seeds": seeds,
        "rel": {k: round(v, 5) for k, v in rel.items()},
        "active_mixtures_band": (max(2 * (max(am) - min(am)), 3)
                                 if am else None),
        "records": {str(s): {k: records[s].get(k)
                             for k in SCALE_KEYS + ("active_mixtures",
                                                    "train_wall_s")}
                    for s in seeds},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--anchor", required=True,
                    help="the port's record to annotate in place")
    ap.add_argument("--config", default="codes/mnist_digit_config.json")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra quality arguments, e.g. --device cpu "
                         "--n-train 12800 --override '{...}'")
    # options after --extra that argparse does not know are the record's
    args, rest = ap.parse_known_args(argv)
    args.extra = args.extra + rest
    if is_jax_anchor(args.anchor):
        ap.error(f"--anchor {args.anchor} is a JAX package anchor; point "
                 "it at the port's own record")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    records = {}
    for seed in args.seeds:
        out = os.path.join(tempfile.gettempdir(),
                           f"quality_torch_spread_s{seed}.json")
        cmd = [sys.executable, "-m", "ladder_tpu_torch.quality",
               "--config", args.config, "--out", out,
               "--seed", str(seed)] + args.extra
        print("==", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, env=env)
        with open(out) as f:
            records[seed] = json.load(f)

    with open(args.anchor) as f:
        anchor = json.load(f)
    anchor["seed_spread"] = seed_spread(records, args.seeds)
    with open(args.anchor, "w") as f:
        json.dump(anchor, f, indent=1)
    print(json.dumps(anchor["seed_spread"]["rel"], indent=1))
    am = [records[s]["active_mixtures"] for s in args.seeds
          if records[s].get("active_mixtures") is not None]
    print("active_mixtures:", am, "-> band",
          anchor["seed_spread"]["active_mixtures_band"])
    print(f"annotated {args.anchor}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
