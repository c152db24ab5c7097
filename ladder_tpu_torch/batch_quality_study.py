"""Batch-scaling quality study of the port (the counterpart of
``scripts/batch_quality_study.py``).

Trains the CelebA-128 'ours' recipe (reference hyperparameters,
codes/celeba_config.json: h=512, z=256, K=50, MC=100, the lr schedule) with
the port's CelebATrainer at several batch sizes on the synthetic CelebA set,
the learning rates scaled linearly by ``batch / batches[0]``, and records
the per-epoch train/val negative-ELBO trajectories.

    python -m ladder_tpu_torch.batch_quality_study --epochs 6 --n-train 4096 \\
        [--batches 64 256] [--dtype bfloat16] [--device cuda|cpu]

Writes ``docs/batch_quality_study_torch.json`` by default (the JAX
package's record, ``docs/batch_quality_study.json``, is never written) and
prints a summary table. ``run_one`` takes an optional dict of config
overrides (applied last; the tests shrink the widths with it). ``--device``
is cuda unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

# the JAX package's record (docs/), never written by the port
JAX_RECORD = "batch_quality_study.json"


def run_one(batch, args, lr_scale=1.0, overrides=None):
    from ladder_tpu_torch.data.celeba import CelebAData
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
    from ladder_tpu_torch.utils.config import apply_defaults
    from ladder_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        cfg = {
            "exp_name": "celeba", "prior": "ours", "load_dir": "default",
            "load_model": 0, "num_epochs": args.epochs,
            "batch_size": batch,
            "dim_input_x": 128, "dim_input_y": 128, "dim_input_channel": 3,
            "code_size": 256, "representation_size": 2,
            "num_hidden_units": 512, "num_hidden_units_inner_VAE": 512,
            "n_layers_inner_VAE": 5, "n_mixtures": 50, "n_MC_samples": 100,
            "GM_fit_restart": 3,
            "sigma": 0.5,
            # linear lr scaling with batch (Goyal et al.; the reference
            # schedules are per-epoch so trajectories stay comparable)
            "learning_rate_ae": 2.5e-4 * lr_scale,
            "learning_rate_sigma": 2.5e-4 * lr_scale,
            "learning_rate_prior": 1.25e-4 * lr_scale,
            "learning_rate_inner_sigma": 2e-4 * lr_scale,
            "TRAIN_VAE": 1, "TRAIN_sigma": 1, "TRAIN_prior": 1,
            "TRAIN_inner_sigma": 1,
            "sg_pretraining": args.sg_pretraining,
            "use_mask_start": 100, "accurate_fit": 3,
            "num_iter_to_plot": 0, "enable_plots": 0,
            "dtype": args.dtype, "fused_train_step": 2,
            "synthetic_data": 1, "synthetic_n_train": args.n_train,
            "synthetic_n_val": max(args.n_train // 8, batch),
            "synthetic_n_test": batch,
            "data_path": td + "/data/",
            "result_dir": td + "/result/", "checkpoint_dir": td + "/ckpt/",
            "seed": args.seed,
        }
        cfg = apply_defaults({**cfg, **(overrides or {})})
        os.makedirs(cfg["result_dir"], exist_ok=True)
        os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
        data = CelebAData(cfg)
        model = make_model(cfg, seed=int(cfg["seed"]))
        trainer = CelebATrainer(model, data, cfg, device=device)
        t0 = time.time()
        trainer.train()
        wall = time.time() - t0
        m = trainer.metrics
        return dict(
            batch=batch, lr_scale=lr_scale, wall_s=round(wall, 1),
            train_neg_elbo=[float(v) for v in m.train_loss_ave_epoch],
            val_neg_elbo=[float(v) for v in m.val_loss_ave_epoch],
            sigma=[float(v) for v in m.test_sigma],
            code_elbo_last=(float(m.code_elbo_train[-1])
                            if m.code_elbo_train else None),
        )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--sg-pretraining", type=int, default=2)
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr-scaling", type=int, default=1,
                    help="1: scale lrs linearly with batch/batches[0]")
    ap.add_argument("--out", default="docs/batch_quality_study_torch.json",
                    help="the port's record (docs/batch_quality_study.json "
                         "is the JAX package's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == JAX_RECORD:
        ap.error(f"--out {args.out}: {JAX_RECORD} is the JAX package's "
                 "record; write the port's elsewhere")
    return args


def study(args, overrides=None):
    """The runs of every batch and the record {"meta", "runs"}."""
    results = [run_one(b, args, lr_scale=(b / args.batches[0])
                       if args.lr_scaling else 1.0, overrides=overrides)
               for b in args.batches]
    meta = dict(epochs=args.epochs, n_train=args.n_train,
                lr_scaling=bool(args.lr_scaling),
                sg_pretraining=args.sg_pretraining, dtype=args.dtype,
                seed=args.seed, dataset="synthetic celebA-shaped")
    return dict(meta=meta, runs=results)


def main(argv=None):
    args = parse_args(argv)
    payload = study(args)
    results = payload["runs"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)

    print("\n=== batch quality study ===")
    base = results[0]
    for r in results:
        print(f"batch {r['batch']:>4}: val -ELBO/epoch "
              f"{['%.1f' % v for v in r['val_neg_elbo']]}  "
              f"sigma_last={r['sigma'][-1]:.4f}  wall={r['wall_s']}s")
        if r is not base and base["val_neg_elbo"]:
            last = r["val_neg_elbo"][-1]
            ref = base["val_neg_elbo"][-1]
            print(f"   final val -ELBO vs batch {base['batch']}: "
                  f"{100 * (last - ref) / abs(ref):+.2f}%")
    print(f"written to {args.out}")
    return payload


if __name__ == "__main__":
    main()
