"""The training CLI of the port:

    python -m ladder_tpu_torch.train --config codes/mnist_digit_config.json [--device cuda|cpu]
    python -m ladder_tpu_torch.train --config demo/celeba_config.json [--device cuda|cpu]

The counterpart of ``train.py --config``: the same JSON schema, the same
directories and artifacts ({exp}-result.npz, GM_prior_info.npz,
vae-model / prior-model / train-state .msgpack), the same console lines,
checkpoint restore before training (a full train state resumes the epoch
count), then the epoch loop. The data and the trainer follow
config['exp_name'], as ``train.py`` does: the mnist families train on
in-memory arrays (data/mnist.py, MNISTTrainer), CelebA on TFRecords
(data/celeba.py, CelebATrainer). ``--device`` is cuda unless the caller
asks for the CPU; without a CUDA device the default fails. As the
reference does, a missing or unreadable config prints ``missing or invalid
arguments`` and exits 0. The port's trainer does not plot: the config must
set ``"enable_plots": 0``.
"""

from __future__ import annotations

import sys
import time

from ladder_tpu_torch.utils.config import (
    create_dirs,
    get_args,
    process_config,
    save_config,
)
from ladder_tpu_torch.utils.device import resolve_device


def main(argv=None):
    """Run the CLI; returns the trainer (None when nothing trains), so a
    caller in the same process can read its state and timings."""
    try:
        args = get_args(argv)
        config = process_config(args.config)
    except SystemExit:
        raise
    except Exception as e:  # the reference's quirk: report and exit 0
        print("missing or invalid arguments: {}".format(e))
        sys.exit(0)
    device = resolve_device(args.device)

    create_dirs([config["result_dir"], config["checkpoint_dir"]])
    save_config(config)

    from ladder_tpu_torch.models.builder import make_model

    t0 = time.perf_counter()
    if config["exp_name"] == "celeba":
        from ladder_tpu_torch.data.celeba import CelebAData
        from ladder_tpu_torch.training.celeba_trainer import (
            CelebATrainer as Trainer,
        )
        data = CelebAData(config)
    else:
        from ladder_tpu_torch.data.mnist import DataGenerator
        from ladder_tpu_torch.training.trainer import MNISTTrainer as Trainer
        data = DataGenerator(config)
    data_seconds = time.perf_counter() - t0
    model = make_model(config, seed=int(config.get("seed", 0)))
    print("Created a VAE model.")
    print("The current dataset is {}, num hidden units: {}.\n".format(
        config["exp_name"], config["num_hidden_units"]))

    if not (config["TRAIN_VAE"] or config["TRAIN_sigma"]
            or config["TRAIN_prior"]):
        return None
    trainer = Trainer(model, data, config, device=device)
    trainer.data_seconds = data_seconds
    if config.get("load_model", 1):
        trainer.restore()
    if config["num_epochs"] > 0:
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
