"""GMM-component sweep of the port (the counterpart of
``scripts/sweep_gmm.py``): train the same recipe at each of a list of
n_mixtures values with the port's trainers and report the final validation
metrics.

    python -m ladder_tpu_torch.sweep_gmm --config codes/mnist_digit_config.json \\
        --mixtures 10 25 50 100 [--epochs 5] [--synthetic] [--dtype bfloat16] \\
        [--device cuda|cpu]

Each arm trains in its own experiment directories (suffix ``-sweepK{n}``),
plots off and ``load_model`` 0, so arms do not collide. Per arm: the final
validation loss and ELBO (``utils/metrics.py:MetricsRecorder``'s
``val_loss_ave_epoch`` and ``elbo_val``) and the fast fit's active
mixtures (``trainer.gm_fast`` weights >= 1e-2). Prints one table and one
JSON line ``{"sweep": [...]}``; ``main`` returns the list. ``--device`` is
cuda unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json

# the fast fit's weights at or above this count as active (the JAX script's)
ACTIVE_WEIGHT = 1e-2


def train_arm(cfg, device):
    """Train one arm from scratch; returns the trainer."""
    from ladder_tpu_torch.models.builder import make_model

    model = make_model(cfg, seed=int(cfg.get("seed", 0)))
    if cfg["exp_name"] == "celeba":
        from ladder_tpu_torch.data.celeba import CelebAData
        from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
        trainer = CelebATrainer(model, CelebAData(cfg), cfg, device=device)
    else:
        from ladder_tpu_torch.data.mnist import DataGenerator
        from ladder_tpu_torch.training.trainer import MNISTTrainer
        trainer = MNISTTrainer(model, DataGenerator(cfg), cfg, device=device)
    trainer.train()
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--mixtures", type=int, nargs="+",
                    default=[10, 25, 50, 100])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ladder_tpu_torch.utils.config import create_dirs, process_config
    from ladder_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    base = process_config(args.config)
    if args.epochs:
        base["num_epochs"] = args.epochs
    if args.synthetic:
        base["synthetic_data"] = 1
    if args.dtype:
        base["dtype"] = args.dtype
    base["enable_plots"] = 0
    base["load_model"] = 0

    results = []
    for k in args.mixtures:
        cfg = copy.deepcopy(base)
        cfg["n_mixtures"] = k
        for key in ("summary_dir", "result_dir", "checkpoint_dir"):
            cfg[key] = cfg[key].rstrip("/") + f"-sweepK{k}/"
        create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
        trainer = train_arm(cfg, device)
        rec = trainer.metrics
        active = None
        if trainer.gm_fast is not None:
            w = trainer.gm_fast[0].detach().cpu().numpy()
            active = int((w >= ACTIVE_WEIGHT).sum())
        results.append(dict(
            n_mixtures=k,
            final_val_loss=(rec.val_loss_ave_epoch[-1]
                            if rec.val_loss_ave_epoch else None),
            final_val_elbo=(rec.elbo_val[-1] if rec.elbo_val else None),
            active_mixtures=active,
        ))
        print(f"[sweep] K={k}: {results[-1]}")

    print("\nn_mixtures | final val loss | final val ELBO | active")
    for r in results:
        print(f"{r['n_mixtures']:10d} | {r['final_val_loss']!s:>14} | "
              f"{r['final_val_elbo']!s:>14} | {r['active_mixtures']}")
    print(json.dumps({"sweep": results}))
    return results


if __name__ == "__main__":
    main()
