"""The comparison that decides ``correct``: the numbers read from the
program's outputs against the plain reference's, each later held to its
limit in the cell's workload file.

Training (per leaf, a leaf being one parameter tensor):
  first_loss_gap  the relative gap of the first step's loss_ae: the
              forward at the seeded point, before any update;
  loss_gap    the largest relative gap of a step's loss_ae or loss_prior
              over the checked steps;
  grad_gap    the first gradient each optimiser group got, as it enters
              the update (before the update's +-1 clip): the largest gap
              between the program's and the reference's norm of a leaf,
              over the reference's norm of that leaf or of the median
              leaf, whichever is larger;
  grad_gap_median  the median over leaves of that per-leaf gap;
  change_gap  the same for each leaf's change over the checked steps;
  change_gap_median  its median over leaves.
The leaves whose reference gradient is under a thousandth of the median
leaf's are left out of all four: their gradient is zero but for rounding
(a bias before a normalisation), and Adam moves them by round-off alone.
Serving: for each sampled request and output, the largest absolute gap
over the reference's largest magnitude (at least 1e-3), the worst of the
sample by path.
"""

from __future__ import annotations

import statistics

import torch

ZERO_GRADIENT = 1e-3


def norm(t):
    return float(t.double().norm())


def _leaf_gaps(prog, ref):
    """|prog - ref| / max(ref, median(ref)) of each leaf."""
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref]


def train_readings(prog_losses, ref_losses, prog_grad_norms, ref_first,
                   start, prog_params, ref_params):
    """{first_loss_gap, loss_gap, grad_gap, change_gap}; see the module
    docstring."""
    first = float(ref_losses[0]["loss_ae"])
    first_loss_gap = abs(float(prog_losses[0]["loss_ae"]) - first) / max(
        abs(first), 1e-30)
    loss_gap = 0.0
    for p, r in zip(prog_losses, ref_losses):
        for key, rv in r.items():
            rv = float(rv)
            loss_gap = max(loss_gap, abs(float(p[key]) - rv)
                           / max(abs(rv), 1e-30))
    if len(prog_losses) != len(ref_losses):
        loss_gap = float("inf")
    ref_g = {k: norm(g) for k, g in ref_first.items()}
    med = statistics.median(ref_g.values())
    moving = [k for k in ref_g if ref_g[k] >= ZERO_GRADIENT * med]
    grads = _leaf_gaps({k: prog_grad_norms.get(k, 0.0) for k in moving},
                       {k: ref_g[k] for k in moving})
    ref_c = {k: norm(ref_params[k] - start[k]) for k in moving}
    prog_c = {k: norm(prog_params[k].to(start[k].device) - start[k])
              for k in moving}
    changes = _leaf_gaps(prog_c, ref_c)
    return dict(first_loss_gap=first_loss_gap, loss_gap=loss_gap,
                grad_gap=max(grads), grad_gap_median=statistics.median(grads),
                change_gap=max(changes),
                change_gap_median=statistics.median(changes))


def output_gap(prog, ref):
    """Largest |prog - ref| over max(max |ref|, 1e-3) of one output."""
    prog = torch.as_tensor(prog, dtype=torch.float32, device=ref.device)
    if prog.shape != ref.shape:
        return float("inf")
    scale = max(float(ref.abs().max()), 1e-3)
    return float((prog - ref).abs().max()) / scale
