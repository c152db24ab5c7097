"""Population BN statistics for per-row-deterministic CelebA serving.

The CelebA encoder normalises with batch statistics, so a served encoding
depends on everything else in the batch, pad rows included. With the
population statistics that ``ladder_tpu``'s ``scripts/freeze_bn.py``
estimates (``bn_stats.npz``) and bn_mode='frozen', every BatchNorm layer
normalises with fixed statistics and each output row depends only on its
own input row. The port reads the same file.
"""

from __future__ import annotations

import numpy as np
import torch


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
