"""Config system: JSON -> dict, derived experiment directories.

The port's copy of ``ladder_tpu/utils/config.py``: the same JSON schema,
the same defaults, the same validation messages and the same derived
directory scheme
    ./experiments/{exp_name}/batch-{batch_size}/prior-{...}/{summary,result,checkpoint}/
with the ``load_dir != "default"`` branch that redirects checkpoints to a
pretrained-model directory and results to ./figures/{exp_name}/result/.
A config that one package accepts, the other accepts and resolves to the
same dict. ``save_config``, ``create_dirs`` and ``get_args`` serve the train
CLI as they serve ``ladder_tpu``'s.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime


def get_config_from_json(json_file):
    """Load a config dict from a JSON file."""
    with open(json_file, "r") as f:
        return json.load(f)


# Keys that older reference configs may omit; defaults keep the full flag
# surface well-defined so downstream code never needs .get() chains. The
# extension keys name the JAX package's options; configs carry them to both
# packages unchanged.
_DEFAULTS = {
    "GM_fit_restart": 1,
    "n_MC_samples": 100,
    "use_mask_start": 10**9,
    "sg_pretraining": 0,
    "num_iter_to_plot": 2,
    "accurate_fit": 10,
    "TRAIN_decoded_z_std": 0,
    "TRAIN_inner_sigma": 0,
    "TRAIN_sigma": 1,
    "TRAIN_prior": 0,
    "TRAIN_VAE": 1,
    "max_to_keep": 1,
    "latent_variance_precision": 1e-3,
    "inner_sigma": 0.1,
    "inner_sigma_ub": 0.1,
    "inner_sigma_lb": 0.05,
    "learning_rate_sigma": 0.0005,
    "learning_rate_prior": 0.0003,
    "learning_rate_inner_sigma": 0.0002,
    "n_layers_inner_VAE": 5,
    "num_hidden_units_inner_VAE": 512,
    "inner_activation": "leaky_relu",
    "representation_size": 2,
    "n_mixtures": 50,
    "kernel_size": 3,
    "seed": 0,
    "mesh_shape": None,
    "data_axis": "data",
    "dtype": "float32",          # compute dtype for conv/dense stacks
    "fused_train_step": 1,
    "steps_per_call": 1,
    "scan_unroll": 1,
    "donate_batch_stack": 0,
    "async_checkpoint": 0,
    "gmm_backend": "jax",
    "fuse_upsample_conv": 1,
    "fused_adam": 0,
    "data_dir": None,
    "synthetic_data": 0,
    "num_epochs": 0,
    "learning_rate_ae": 3e-4,
    "sigma": 0.5,
    "load_model": 1,
}

_EXP_DIMS = {"mnist_digit": (28, 28, 1), "mnist_fashion": (28, 28, 1),
             "celeba": (128, 128, 3)}


def apply_defaults(config):
    for k, v in _DEFAULTS.items():
        config.setdefault(k, v)
    dims = _EXP_DIMS.get(config.get("exp_name"))
    if dims is not None:
        config.setdefault("dim_input_x", dims[0])
        config.setdefault("dim_input_y", dims[1])
        config.setdefault("dim_input_channel", dims[2])
    return config


_REQUIRED_KEYS = (
    "exp_name", "prior", "batch_size", "code_size",
    "num_hidden_units", "load_dir",
)
_VALID_PRIORS = ("standard_gaussian", "GMM", "ours", "hierarchical",
                 "vampPrior")
_VALID_EXPS = ("mnist_digit", "mnist_fashion", "celeba")


def validate_config(config):
    """Fail fast with actionable messages instead of KeyErrors deep in the
    model build. Returns the config for chaining."""
    missing = [k for k in _REQUIRED_KEYS if k not in config]
    if missing:
        raise ValueError(f"config is missing required keys: {missing}")
    if config["prior"] not in _VALID_PRIORS:
        raise ValueError(
            f"unknown prior {config['prior']!r}; one of {_VALID_PRIORS}")
    if config["exp_name"] not in _VALID_EXPS:
        raise ValueError(
            f"unknown exp_name {config['exp_name']!r}; one of {_VALID_EXPS}")
    if (config["exp_name"] == "mnist_digit"
            and config["num_hidden_units"] % 64 != 0):
        raise ValueError(
            "mnist_digit requires num_hidden_units divisible by 64 (the "
            "decoder's depth_to_space pyramid ends at num_hidden_units/64 "
            "channels)")
    if (config["exp_name"] == "mnist_fashion"
            and config["num_hidden_units"] % 4 != 0):
        raise ValueError("mnist_fashion requires num_hidden_units "
                         "divisible by 4")
    if (config["exp_name"] == "celeba"
            and config["num_hidden_units"] % 4 != 0):
        raise ValueError("celeba requires num_hidden_units divisible by 4")
    if config.get("dtype") not in (None, "float32", "bfloat16"):
        raise ValueError(f"dtype must be float32 or bfloat16, got "
                         f"{config['dtype']!r}")
    if config.get("fused_train_step") not in (None, 1, 2):
        raise ValueError("fused_train_step must be 1 (sequential) or 2 "
                         "(single-pass)")
    return config


def process_config(json_file):
    """Load the JSON config and derive summary/result/checkpoint directories
    (the reference's exact save-dir naming scheme)."""
    config = get_config_from_json(json_file)
    apply_defaults(config)
    validate_config(config)
    print("The current config is:\n{}\n".format(config))

    save_name = "prior-{}-{}-{}-{}-{}-{}-mixture-{}".format(
        config["prior"],
        config["num_hidden_units"],
        config["code_size"],
        config["representation_size"],
        config["inner_activation"],
        config["n_layers_inner_VAE"],
        config["n_mixtures"],
    )

    if config["load_dir"] == "default":
        save_dir = "./experiments/{}/batch-{}".format(
            config["exp_name"], config["batch_size"]
        )
        config["summary_dir"] = os.path.join(save_dir, save_name, "summary/")
        config["result_dir"] = os.path.join(save_dir, save_name, "result/")
        config["checkpoint_dir"] = os.path.join(save_dir, save_name, "checkpoint/")
    else:
        save_dir = config["load_dir"]
        config["summary_dir"] = "./figures/{}/summary/".format(config["exp_name"])
        config["result_dir"] = "./figures/{}/result/".format(config["exp_name"])
        config["checkpoint_dir"] = os.path.join(save_dir, config["exp_name"])
    print("Models will be saved / loaded at:\n{}".format(config["checkpoint_dir"]))
    print("Results will be saved at:\n{}\n".format(config["result_dir"]))
    return config


def save_config(config):
    """Snapshot the config into checkpoint_dir as a timestamped txt file
    (reference utils.py:24-37)."""
    stamp = datetime.now().strftime("%d-%b-%Y-%H-%M")
    filename = os.path.join(
        config["checkpoint_dir"], "training_config_{}.txt".format(stamp))
    with open(filename, "w") as f:
        f.write(json.dumps(config))
    print("The current config is saved at {}".format(filename))
    return filename


def create_dirs(dirs):
    """Create each directory if missing (reference utils.py:80-93)."""
    try:
        for d in dirs:
            os.makedirs(d, exist_ok=True)
    except OSError as err:
        print("Creating directories error: {0}".format(err))
        raise SystemExit(-1)
    return 0


def get_args(argv=None):
    """The train CLI's arguments: --config, and --device (cuda unless the
    caller asks for the CPU)."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", metavar="C", default="None",
        help="The Configuration file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    return parser.parse_args(argv)
