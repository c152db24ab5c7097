"""Learning-rate schedules (the port of ``ladder_tpu/training/schedules.py``).

``epoch`` is 1-indexed:
  * ae, MNIST: lr_ae * 0.99^(epoch-1)
  * ae, CelebA: staircase /1, /2, /5, /10 at epochs 25/50/75, each leg with a
    0.99 decay restarted at the step
  * sigma: lr_sigma * 0.99^(epoch-1)
  * prior: lr_prior * 1.01^(epoch-1)  (growing)
  * inner sigma: lr_inner_sigma * 1.01^(epoch-1)
"""

from __future__ import annotations


def lr_ae_mnist(config, epoch):
    return config["learning_rate_ae"] * (0.99 ** (epoch - 1))


def lr_ae_celeba(config, epoch):
    base = config["learning_rate_ae"]
    if epoch <= 25:
        return base * (0.99 ** (epoch - 1))
    if epoch <= 50:
        return base / 2 * (0.99 ** (epoch - 25))
    if epoch <= 75:
        return base / 5 * (0.99 ** (epoch - 50))
    return base / 10 * (0.99 ** (epoch - 75))


def lr_ae(config, epoch):
    if config["exp_name"] == "celeba":
        return lr_ae_celeba(config, epoch)
    return lr_ae_mnist(config, epoch)


def lr_sigma(config, epoch):
    return config["learning_rate_sigma"] * (0.99 ** (epoch - 1))


def lr_prior(config, epoch):
    return config["learning_rate_prior"] * (1.01 ** (epoch - 1))


def lr_inner_sigma(config, epoch):
    return config["learning_rate_inner_sigma"] * (1.01 ** (epoch - 1))


def all_lrs(config, epoch):
    return dict(
        ae=lr_ae(config, epoch),
        sigma=lr_sigma(config, epoch),
        prior=lr_prior(config, epoch),
        inner_sigma=lr_inner_sigma(config, epoch),
    )
