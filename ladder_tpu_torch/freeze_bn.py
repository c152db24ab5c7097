"""Estimate population BN statistics for deterministic CelebA serving:

    python -m ladder_tpu_torch.freeze_bn --config demo/celeba_config.json \\
        [--checkpoint-dir DIR] [--batches 32] [--batch-size N] \\
        [--out <checkpoint_dir>/bn_stats.npz] [--device cuda|cpu]
    python -m ladder_tpu_torch.serve --config demo/celeba_config.json \\
        --bn-stats <checkpoint_dir>/bn_stats.npz ...

The counterpart of ``scripts/freeze_bn.py``: it loads the VAE group from
the checkpoint, runs the "precise BN" recalibration pass
(serving/bn_freeze.py) over ``--batches`` batches of the training split
(the epoch of seed 0, no prefetch), writes ``bn_stats.npz`` and prints one
JSON line with the output path, the channels of each layer and the batch
count. Only CelebA models have BatchNorm; other configs are refused.
``--device`` is cuda unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from itertools import islice


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--batches", type=int, default=32,
                    help="training batches for the recalibration pass")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="override config batch_size for the pass")
    ap.add_argument("--out", default=None,
                    help="output npz (default <checkpoint_dir>/bn_stats.npz)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ladder_tpu_torch.utils.config import process_config
    from ladder_tpu_torch.utils.device import resolve_device

    cfg = process_config(args.config)
    if args.checkpoint_dir is not None:
        cfg["checkpoint_dir"] = args.checkpoint_dir
    if args.batch_size is not None:
        cfg["batch_size"] = args.batch_size
    if cfg["exp_name"] != "celeba":
        ap.error("BN freezing applies to CelebA models only")
    device = resolve_device(args.device)

    from ladder_tpu_torch.data.celeba import CelebAData
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.serving.bn_freeze import (
        estimate_bn_stats,
        save_bn_stats,
    )
    from ladder_tpu_torch.utils.checkpoint import CheckpointManager

    params = CheckpointManager(cfg).load(make_model(cfg).flax_params(),
                                         "VAE")
    batches = islice(
        CelebAData(cfg).train.epoch(cfg["batch_size"], seed=0,
                                    prefetch=False), args.batches)
    stats = estimate_bn_stats(cfg, params, batches, device=device)

    out = args.out or os.path.join(cfg["checkpoint_dir"], "bn_stats.npz")
    save_bn_stats(out, stats)
    print(json.dumps({
        "bn_stats": out,
        "layers": {k: int(v["mean"].shape[0])
                   for k, v in sorted(stats.items())},
        "batches": args.batches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
