"""Population BN statistics for per-row-deterministic CelebA serving.

The CelebA encoder normalises with batch statistics (the reference's
``training=True``, its codes/models.py:471), and its checkpoints carry no
moving averages, so a served encoding depends on everything else in the
batch, pad rows included. The port of ``ladder_tpu/serving/bn_freeze.py``:

  1. ``estimate_bn_stats``: one pass over training batches with the
     batch-statistic forward, reading each BatchNorm layer's input (the
     output of the conv before it, ``Conv_i`` -> ``BatchNormTrain_i``) with
     forward hooks and accumulating per-channel count, sum and sum of
     squares in float64 over N, H and W (NCHW) -- "precise BN"
     recalibration. As the forward is the batch-statistic one, layer k's
     inputs are exactly what it saw in training.
  2. bn_mode='frozen' with ``LadderModel.set_bn_stats`` (the serving
     engine's ``bn_stats_path``): every BatchNormTrain normalises with those
     fixed statistics, so each output row depends only on its own input row.

Exactness: statistics estimated from a single batch make the frozen forward
reproduce the batch-statistic forward on that batch (layer 1's population
statistics are its batch statistics, so its outputs are the same, hence
layer 2's inputs, and so on). ``bn_stats.npz`` is the same flat file in
both packages.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ladder_tpu_torch.utils.device import float32_exact, resolve_device
from ladder_tpu_torch.utils.weights import flax_to_torch


def estimate_bn_stats(config, params, batches, device="cuda"):
    """One recalibration pass: {'BatchNormTrain_i': {'mean', 'var'}} per
    encoder BN layer (float32 CPU tensors; the population, biased,
    variance clamped at 0), from the flax-layout ``params['encoder']`` and
    every batch of ``batches`` (uint8 or [0,1] float NHWC images). Runs on
    the card unless ``device='cpu'`` is asked for; raises without one."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.step import _images

    cfg = dict(config)
    if cfg.get("exp_name") != "celeba":
        raise ValueError("BN freezing applies to the CelebA encoder only "
                         f"(exp_name={cfg.get('exp_name')!r} has no BN)")
    cfg["bn_mode"] = "batch"  # the capture pass must see training behaviour
    device = resolve_device(device)
    model = make_model(cfg)
    encoder = model.encoder
    prefix = "encoder."
    encoder.load_state_dict(
        {k[len(prefix):]: torch.tensor(v) for k, v in
         flax_to_torch({"encoder": params["encoder"]}).items()}, strict=True)
    encoder.to(device).requires_grad_(False)

    acc = {}  # name -> [count, sum, sum of squares], float64 on the device

    def capture(name):
        def hook(module, inputs, out):
            out = out.detach().double()
            entry = acc.setdefault(name, [0, 0.0, 0.0])
            entry[0] += out.numel() // out.shape[1]
            entry[1] = entry[1] + out.sum(dim=(0, 2, 3))
            entry[2] = entry[2] + out.square().sum(dim=(0, 2, 3))
        return hook

    hooks = [getattr(encoder, f"Conv_{i}").register_forward_hook(
        capture(f"BatchNormTrain_{i}")) for i in range(6)]
    n_batches = 0
    exact = float32_exact() if model.dtype is None else contextlib.nullcontext()
    try:
        with torch.no_grad(), exact:
            for batch in batches:
                x = _images(batch, device)     # NCHW, uint8 kept as is
                if x.dtype == torch.uint8:     # as compute_loss normalises
                    x = x.float() * (1.0 / 255.0)
                encoder(x)
                n_batches += 1
    finally:
        for h in hooks:
            h.remove()
    if not n_batches:
        raise ValueError("estimate_bn_stats needs at least one batch")

    stats = {}
    for name, (count, s, ss) in acc.items():
        mean = s / count
        var = torch.clamp(ss / count - mean * mean, min=0.0)  # biased
        stats[name] = {"mean": mean.float().cpu(), "var": var.float().cpu()}
    return stats


def save_bn_stats(path, stats):
    """Flat npz: 'BatchNormTrain_i/mean', 'BatchNormTrain_i/var'."""
    flat = {}
    for name, mv in stats.items():
        for leaf in ("mean", "var"):
            flat[f"{name}/{leaf}"] = np.asarray(
                torch.as_tensor(mv[leaf]).cpu(), np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path


def load_bn_stats(path):
    """Flat npz ('BatchNormTrain_i/mean', 'BatchNormTrain_i/var') ->
    {'BatchNormTrain_i': {'mean': tensor, 'var': tensor}} in float32."""
    stats = {}
    with np.load(path) as z:
        for key in z.files:
            name, leaf = key.rsplit("/", 1)
            stats.setdefault(name, {})[leaf] = torch.tensor(
                np.asarray(z[key], np.float32))
    for name, mv in stats.items():
        if set(mv) != {"mean", "var"}:
            raise ValueError(f"malformed bn_stats file {path}: {name} has "
                             f"{sorted(mv)}")
    return stats
