"""Real-dataset verification of the port (the counterpart of
``scripts/verify_real_data.py``), in two steps:

  1. the layout, before training:
       python -m ladder_tpu_torch.verify_real_data check \\
           --config codes/mnist_digit_config.json [--data-dir DIR]
     finds the dataset through the port's loaders
     (``data/mnist.py:_find_local_mnist``, ``data/tfrecord.py:
     ImageRecordReader``) and prints what it found (exit 1 with an
     actionable message otherwise).

  2. the curves' envelope, after ``python -m ladder_tpu_torch.train``:
       python -m ladder_tpu_torch.verify_real_data compare \\
           --config codes/mnist_digit_config.json [--envelope FILE]
     reads the run's {exp}-result.npz and GM_prior_info.npz and checks them
     against ``docs/envelopes/{exp}.json`` (the repository's, found from
     this package's location): finite curves, curve lengths, the loss
     drop, the final sigma, sigma's annealing, validation against
     training, the active mixtures. numpy only.

The same arguments, lines and exit codes as the JAX script, plus
``--device`` (cuda unless the caller asks for the CPU; neither step puts
anything on it, but like every entry point of the port it raises without
a card unless ``--device cpu`` is given).

Expected layouts
  mnist_digit / mnist_fashion (data_dir or $LADDER_DATA_DIR):
      mnist.npz / fashion_mnist.npz   (keras layout: x_train,y_train,x_test,y_test)
   or mnist/train-images-idx3-ubyte[.gz] + labels + t10k pair (idx layout)
  celeba (data_path or $LADDER_DATA_DIR):
      celebA_train.tfrecords, celebA_val.tfrecords, celebA_test.tfrecords
      (tf.train.Example with raw-bytes feature 'X', 128x128x3 uint8)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ENVELOPES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "envelopes")


def _load_config(path):
    from ladder_tpu_torch.utils.config import process_config
    return process_config(path)


def check(args):
    cfg = _load_config(args.config)
    exp = cfg["exp_name"]
    ok = True
    if exp in ("mnist_digit", "mnist_fashion"):
        from ladder_tpu_torch.data.mnist import _find_local_mnist
        data_dir = (args.data_dir or cfg.get("data_dir")
                    or os.environ.get("LADDER_DATA_DIR", "./data"))
        choice = "digit" if exp == "mnist_digit" else "fashion"
        found = _find_local_mnist(data_dir, choice)
        if found is None:
            print(f"FAIL: no {choice} MNIST found under {data_dir!r}.\n"
                  f"Provide {'mnist' if choice == 'digit' else 'fashion_mnist'}"
                  f".npz (keras layout) or the idx files "
                  f"(train-images-idx3-ubyte[.gz], ...) there, or pass "
                  f"--data-dir / set $LADDER_DATA_DIR.")
            return 1
        (xtr, ytr), (xte, yte) = found
        print(f"OK: {exp} dataset at {data_dir!r}: train {xtr.shape} "
              f"labels {ytr.shape}, test {xte.shape}")
        if xtr.shape[1:] != (28, 28) or xtr.shape[0] < 10000:
            print("WARN: unexpected shape/size for MNIST")
    elif exp == "celeba":
        data_path = (args.data_dir or cfg.get("data_path")
                     or os.environ.get("LADDER_DATA_DIR", "./data/celeba/"))
        from ladder_tpu_torch.data.tfrecord import ImageRecordReader
        for split in ("train", "val", "test"):
            p = os.path.join(data_path, f"celebA_{split}.tfrecords")
            if not os.path.isfile(p):
                print(f"FAIL: missing {p}\nExpected the reference's three "
                      f"TFRecord files (raw-bytes feature 'X', 128x128x3 "
                      f"uint8) under {data_path!r}.")
                ok = False
                continue
            try:
                r = ImageRecordReader(p, (128, 128, 3))
                img = r.read_batch([0])[0]
                print(f"OK: {p}: {r.n} records, first decodes to "
                      f"{img.shape} {img.dtype}")
            except Exception as e:
                print(f"FAIL: {p}: unreadable ({e})")
                ok = False
    else:
        print(f"FAIL: unknown exp_name {exp!r}")
        return 1
    return 0 if ok else 1


def compare(args):
    cfg = _load_config(args.config)
    exp = cfg["exp_name"]
    result = os.path.join(cfg["result_dir"], f"{exp}-result.npz")
    if not os.path.isfile(result):
        print(f"FAIL: no result file at {result} — run train.py first")
        return 1
    env_path = args.envelope or os.path.join(ENVELOPES, f"{exp}.json")
    with open(env_path) as f:
        env = json.load(f)["checks"]
    r = np.load(result)
    fails = []

    def check_(name, cond, detail):
        print(f"{'OK  ' if cond else 'FAIL'} {name}: {detail}")
        if not cond:
            fails.append(name)

    tl = np.asarray(r["train_loss"], dtype=np.float64)
    sigma = np.asarray(r["sigma"], dtype=np.float64)
    check_("curves_finite",
           np.isfinite(tl).all() and np.isfinite(sigma).all(),
           "train_loss and sigma all finite")
    n_epoch_seen = len(sigma)
    n_iter = int(np.asarray(r["n_train_iter"]))
    check_("curve_lengths", len(tl) == n_epoch_seen * n_iter,
           f"len(train_loss)={len(tl)} == epochs({n_epoch_seen}) x "
           f"n_train_iter({n_iter})")
    first = tl[:n_iter].mean()
    last = tl[-n_iter:].mean()
    drop = (first - last) / abs(first)
    check_("train_loss_drop", drop >= env["min_train_loss_drop"],
           f"epoch-avg loss drop {drop:.2%} >= {env['min_train_loss_drop']:.0%}")
    check_("final_sigma", sigma[-1] <= env["final_sigma_max"],
           f"sigma[-1]={sigma[-1]:.4f} <= {env['final_sigma_max']}")
    tol = env["sigma_monotone_tolerance"]
    check_("sigma_annealing",
           bool(np.all(np.diff(sigma) <= tol)),
           f"sigma non-increasing within +{tol}")
    if len(r["val_loss"]):
        vl = np.asarray(r["val_loss"], dtype=np.float64)
        rel = abs(vl[-1] - last) / abs(last)
        check_("val_tracks_train",
               rel <= env["val_final_within_train_frac"],
               f"|val-train|/|train| = {rel:.2%} <= "
               f"{env['val_final_within_train_frac']:.0%}")
    gm_info = os.path.join(cfg["result_dir"], "GM_prior_info.npz")
    if cfg["prior"] in ("ours", "GMM") and "min_active_mixtures" in env:
        if os.path.isfile(gm_info):
            g = np.load(gm_info)
            n_active = len(g["w_active"])
            check_("active_mixtures",
                   n_active >= env["min_active_mixtures"],
                   f"{n_active} active of {len(g['w_full'])} "
                   f">= {env['min_active_mixtures']}")
        else:
            check_("gm_prior_info", False, f"missing {gm_info}")
    if fails:
        print(f"\nFAILED checks: {fails}")
        return 1
    print("\nAll envelope checks passed — the run reproduces the LaDDer "
          "behaviour profile.")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("check", check), ("compare", compare)):
        p = sub.add_parser(name)
        p.add_argument("--config", required=True)
        p.add_argument("--data-dir", default=None)
        if name == "compare":
            p.add_argument("--envelope", default=None)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    from ladder_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
