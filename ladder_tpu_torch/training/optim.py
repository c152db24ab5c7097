"""Per-group Adam optimisers with TF1 update semantics (the port of
``ladder_tpu/training/optim.py``).

Up to five groups of parameters each have their own moments, step count and
learning rate. Gradients are clipped elementwise to [-1, 1] inside the
update. TF1's Adam folds the bias correction into the step size
(lr_t = lr * sqrt(1-b2^t) / (1-b1^t)) and adds epsilon to the uncorrected
sqrt(v); ``torch.optim.Adam`` does neither, so the update is the package's
own op (ops/adam.py: the hand-written kernel on CUDA tensors, its plain
version on CPU tensors). Updates are in place.
"""

from __future__ import annotations

import torch

from ladder_tpu_torch.ops.adam import adam_update_, any_nonfinite

ADAM_B1 = 0.9
ADAM_B2 = 0.95
ADAM_EPS = 1e-8


def adam_init(params):
    """Zero moments for {name: parameter} and the step count t = 0."""
    return dict(m={k: torch.zeros_like(p) for k, p in params.items()},
                v={k: torch.zeros_like(p) for k, p in params.items()},
                t=0)


def adam_update(grads, state, params, lr, b1=ADAM_B1, b2=ADAM_B2,
                eps=ADAM_EPS, skip_nonfinite=False):
    """One clipped TF1-style Adam step on {name: parameter}, in place:
    params, state['m'], state['v'] and state['t'] change. grads are the
    unclipped gradients, {name: tensor}.

    skip_nonfinite=True drops the whole group update (parameters, moments and
    the step count stay put) when any clipped gradient element is not finite.
    The guard sees the gradients after the clip, as ``ladder_tpu``'s step
    applies it (clip_grads, then adam_update): an infinite element clips to
    +-1 and passes, a NaN drops the update. On a CUDA device a kernel raises a flag and the host reads it, which
    costs one host synchronisation per group update; without the guard the
    update never synchronises."""
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k] for k in names]
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    if skip_nonfinite and any_nonfinite(p, g, m, v):
        return
    state["t"] += 1
    adam_update_(p, g, m, v, lr, state["t"], b1, b2, eps)
