"""The quality record of the port (the counterpart of
``scripts/quality_baseline.py``):

    python -m ladder_tpu_torch.quality --config codes/mnist_digit_config.json \\
        --out QUALITY_torch_mnist_digit.json --check QUALITY_r04.json
    # on the CPU, at a tiny size:
    python -m ladder_tpu_torch.quality --device cpu --epochs 2 --n-train 256 \\
        --n-test 128 --fid-samples 64 --override '{"sg_pretraining": 1,
        "accurate_fit": 1, "batch_size": 64, "n_mixtures": 4,
        "n_MC_samples": 4, "num_hidden_units": 64,
        "num_hidden_units_inner_VAE": 16, "n_layers_inner_VAE": 2}'

Trains a full recipe of any family (config['exp_name'] picks the data and
the trainer, as the train CLI does) on the deterministic synthetic set, or
on ``--data-dir``, then writes one JSON record with the JAX script's keys,
in its order and with its meaning:

- the final train/val negative ELBO and reconstruction error, the prior's
  losses and the code ELBO (the endpoints of ``{exp}-result.npz``);
- the sigma anneal's first and last value, and the number of curve points;
- the active mixtures of the final accurate GM fit (weights at or above
  ``ops.gmm.ACTIVE_WEIGHT_THRESHOLD`` in ``GM_prior_info.npz``);
- the encoder-space FID of ``--fid-samples`` generated images
  (``InferenceEngine.generate``) against as many validation images, and
  the validation set against itself (the self-floor, ~0).

``--check BASELINE`` then regresses the record against a committed record
with ``check_against``, which decides exactly as the JAX script's, and
exits 1 on a divergence beyond its tolerances.

Two departures from the JAX script: ``--device`` (cuda unless the caller
asks for the CPU; it reaches the trainer, the serving engine and the FID's
encoder), and ``--out``, which defaults to ``QUALITY_torch.json``. Never
point ``--out`` at a ``QUALITY_r04*.json``: those are the JAX package's
anchors.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="quality record of the port")
    ap.add_argument("--config", default="codes/mnist_digit_config.json")
    ap.add_argument("--out", default="QUALITY_torch.json",
                    help="the record (never a QUALITY_r04*.json: those are "
                         "the JAX package's anchors)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override num_epochs (default: recipe value)")
    ap.add_argument("--n-train", type=int, default=60000)
    ap.add_argument("--n-test", type=int, default=10000)
    ap.add_argument("--data-dir", default=None,
                    help="train on real data from this directory instead of "
                         "the synthetic set (mnist.npz / idx layout for the "
                         "MNIST families, celebA_*.tfrecords for celeba)")
    ap.add_argument("--fid-samples", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here (default: temp dir)")
    ap.add_argument("--fused", type=int, default=2, choices=[1, 2])
    ap.add_argument("--override", default=None,
                    help="JSON dict of config overrides applied last")
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="after the run, regress the new record against a "
                         "committed record (e.g. QUALITY_r04.json) and exit "
                         "1 on divergence beyond tolerances")
    ap.add_argument("--check-rtol", type=float, default=0.05,
                    help="relative tolerance for the ELBO/recons endpoints "
                         "when the baseline carries no seed_spread")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if is_jax_anchor(args.out):
        ap.error(f"--out {args.out} is a JAX package anchor; write the "
                 "port's record elsewhere")
    return args


def is_jax_anchor(path):
    """True for the JAX package's committed records (QUALITY_r04*.json)."""
    return os.path.basename(path).startswith("QUALITY_r04")


def build_config(args, workdir):
    """The recipe's config with the run's data, seed and directories (the
    JAX script's steps, the override last)."""
    from ladder_tpu_torch.utils.config import create_dirs, process_config

    cfg = process_config(args.config)
    if args.data_dir:
        cfg.update({"synthetic_data": 0, "data_dir": args.data_dir})
    else:
        cfg.update({"synthetic_data": 1, "synthetic_n_train": args.n_train,
                    "synthetic_n_test": args.n_test})
    cfg.update({
        "load_model": 0,
        "enable_plots": 0,
        "num_iter_to_plot": 0,
        "fused_train_step": args.fused,
        "seed": args.seed,
        "data_path": (args.data_dir if args.data_dir
                      else os.path.join(workdir, "data") + "/"),
        "result_dir": os.path.join(workdir, "result") + "/",
        "checkpoint_dir": os.path.join(workdir, "ckpt") + "/",
    })
    if args.epochs is not None:
        cfg["num_epochs"] = args.epochs
    if args.override:
        cfg.update(json.loads(args.override))
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    return cfg


def train(cfg, args, device):
    """Build the family's data and trainer and train from scratch (no
    restore); returns (data, trainer, seconds)."""
    from ladder_tpu_torch.models.builder import make_model

    t0 = time.time()
    if cfg["exp_name"] == "celeba":
        from ladder_tpu_torch.data.celeba import CelebAData
        from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
        cfg.setdefault("synthetic_n_val", max(256, args.fid_samples))
        data = CelebAData(cfg)
        trainer_cls = CelebATrainer
    else:
        from ladder_tpu_torch.data.mnist import DataGenerator
        from ladder_tpu_torch.training.trainer import MNISTTrainer
        data = DataGenerator(cfg)
        trainer_cls = MNISTTrainer
    model = make_model(cfg, seed=int(cfg.get("seed", 0)))
    trainer = trainer_cls(model, data, cfg, device=device)
    trainer.train()
    return data, trainer, time.time() - t0


def record_from_artifacts(cfg, args, data, workdir, device, train_wall):
    """The record from what the run wrote: the curves of {exp}-result.npz,
    GM_prior_info.npz and the checkpoints (the FID generates and encodes
    on ``device``). Writes generated.npz and real.npz into ``workdir``."""
    res = np.load(os.path.join(
        cfg["result_dir"], "{}-result.npz".format(cfg["exp_name"])))
    sigma = np.asarray(res["sigma"], np.float64)
    record = {
        "config": args.config,
        "recipe": {k: cfg[k] for k in (
            "exp_name", "prior", "num_epochs", "batch_size", "n_mixtures",
            "sg_pretraining", "accurate_fit", "n_MC_samples")},
        "data": ({"kind": "real", "dir": args.data_dir,
                  "n_train": int(data.n_train), "n_val": int(data.n_val)}
                 if args.data_dir else
                 {"kind": "synthetic", "n_train": args.n_train,
                  "n_test": args.n_test}),
        "synthetic_n_train": None if args.data_dir else args.n_train,
        "overrides": json.loads(args.override) if args.override else None,
        "seed": args.seed,
        "train_wall_s": round(train_wall, 1),
        "final_train_neg_elbo": float(res["train_loss"][-1]),
        "final_val_neg_elbo": float(res["val_loss"][-1]),
        "final_train_recons": float(res["recons_loss_train"][-1]),
        "final_val_recons": float(res["recons_loss_val"][-1]),
        # empty for prior 'ours'/'hierarchical' and before sg_pretraining
        "final_train_loss_prior": (float(res["train_loss_prior"][-1])
                                   if len(res["train_loss_prior"]) else None),
        "final_train_code_elbo": (float(res["code_elbo_train"][-1])
                                  if len(res.get("code_elbo_train", []))
                                  else None),
        "final_val_loss_prior": (float(res["val_loss_prior"][-1])
                                 if len(res["val_loss_prior"]) else None),
        "sigma_start": float(sigma[0]),
        "sigma_final": float(sigma[-1]),
        # curve points (epochs x evaluations an epoch), not epochs
        "n_curve_points": int(len(res["val_loss"])),
    }

    from ladder_tpu_torch.ops.gmm import ACTIVE_WEIGHT_THRESHOLD
    gm_path = os.path.join(cfg["result_dir"], "GM_prior_info.npz")
    if os.path.exists(gm_path):
        w = np.asarray(np.load(gm_path)["w_full"]).ravel()
        record["active_mixtures"] = int((w >= ACTIVE_WEIGHT_THRESHOLD).sum())
        record["n_mixtures"] = int(w.size)
    else:  # num_epochs <= sg_pretraining: the prior never trained
        record["active_mixtures"] = None
        record["n_mixtures"] = None

    from ladder_tpu_torch.models.builder import PRIORS_WITH_GM
    from ladder_tpu_torch.serving import InferenceEngine
    from ladder_tpu_torch.utils.fid import (
        compute_FID_score,
        encoder_feature_fn,
    )

    n = args.fid_samples
    if cfg["prior"] in PRIORS_WITH_GM and record["active_mixtures"] is None:
        # no GM fit yet: 'ours'/'GMM' cannot generate, so no FID
        record["encoder_fid_generated_vs_test"] = None
        record["workdir"] = workdir
        return record
    engine = InferenceEngine(cfg, checkpoint_dir=cfg["checkpoint_dir"],
                             device=device)
    gen = engine.generate(n, seed=args.seed)
    f_gen = os.path.join(workdir, "generated.npz")
    np.savez(f_gen, sampled_images=np.asarray(gen))
    # the FID's original set is uint8-scale: the MNIST loader yields
    # [0,1], so store x255; the CelebA reader yields [0,255] already
    n = min(n, data.n_val)
    if cfg["exp_name"] == "celeba":
        xt = np.asarray(data.val.first_batch(n), np.float32)
    else:
        xt = np.asarray(data.val_set["image"][:n], np.float32) * 255.0
    f_real = os.path.join(workdir, "real.npz")
    np.savez(f_real, sampled_images=xt)
    feature_fn = encoder_feature_fn(cfg, checkpoint_dir=cfg["checkpoint_dir"],
                                    device=device)
    fid = compute_FID_score(f_real, f_gen, feature_fn=feature_fn,
                            resize_to=cfg["dim_input_x"])
    same = compute_FID_score(f_real, f_real, feature_fn=feature_fn,
                             second_set="original",
                             resize_to=cfg["dim_input_x"])
    record["encoder_fid_generated_vs_test"] = float(fid)
    record["encoder_fid_self_floor"] = float(same)
    record["fid_samples"] = n
    record["workdir"] = workdir
    return record


def run(argv=None):
    """Train, record and write ``--out``; returns (args, record, trainer)."""
    from ladder_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="quality_torch_")
    cfg = build_config(args, workdir)
    data, trainer, train_wall = train(cfg, args, device)
    record = record_from_artifacts(cfg, args, data, workdir, device,
                                   train_wall)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return args, record, trainer


def main(argv=None):
    args, record, _ = run(argv)
    # as the JAX script: a record without an FID (no GM fit) is not checked
    if args.check and record["encoder_fid_generated_vs_test"] is not None:
        return check_against(record, args.check, args.check_rtol)
    return 0


def check_against(record, baseline_path, rtol):
    """Regress a fresh quality record against a committed baseline (the
    JAX script's check, decision for decision).

    Scale-bearing endpoints (ELBO, reconstruction, sigma, FID) must agree
    within a per-metric tolerance derived from the baseline's measured
    seed spread when it carries one (``seed_spread``, written by
    quality_spread: 2x the relative seed-to-seed spread, floored at 0.5%),
    else the ``rtol`` fallback; the active mixtures within a band. The
    FID's fallback tolerance is 2.0 on |a-b|/max(|a|,|b|), which two
    non-negative FIDs never exceed: kept so that the port decides as the
    JAX check does (ROADMAP.md, departures and quirks)."""
    with open(baseline_path) as f:
        base = json.load(f)
    spread = base.get("seed_spread", {}).get("rel", {})
    failures = []

    def close(key, tol):
        a, b = record.get(key), base.get(key)
        if a is None or b is None:
            return  # family/abbreviation differences are legitimate
        denom = max(abs(a), abs(b), 1e-6)
        if abs(a - b) / denom > tol:
            failures.append(f"{key}: {a} vs baseline {b} "
                            f"(>{tol:.1%} divergence)")

    def tol_for(key, fallback):
        if key in spread:
            return max(2.0 * spread[key], 0.005)
        return fallback

    for key in ("final_train_neg_elbo", "final_val_neg_elbo",
                "final_train_recons", "final_val_recons", "sigma_final"):
        close(key, tol_for(key, rtol))
    close("encoder_fid_generated_vs_test",
          tol_for("encoder_fid_generated_vs_test", 2.0))
    a, b = record.get("active_mixtures"), base.get("active_mixtures")
    am_band = base.get("seed_spread", {}).get("active_mixtures_band")
    band = am_band if am_band is not None else max(5, 0.3 * (b or 0))
    if a is not None and b is not None and abs(a - b) > band:
        failures.append(f"active_mixtures: {a} vs baseline {b} "
                        f"(band {band})")
    if failures:
        print("QUALITY REGRESSION vs {}:".format(baseline_path))
        for msg in failures:
            print("  " + msg)
        return 1
    print("quality check vs {}: ok".format(baseline_path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
