"""Shortest-likelihood-path (SLP) latent interpolation (the port of
``ladder_tpu/interp.py``).

k intermediate latent points are optimised by Adam against

    obj = w_path * sum_i ||p_{i+1} - p_i||
        + w_eq   * std_i(||p_{i+1} - p_i||)
        - sum_i log p_prior(p_i)

with the gradient clipped elementwise to [-1, 1], TF1's Adam (beta1 0.9,
beta2 0.95, the bias correction folded into the step size, epsilon on the
uncorrected root), lr 1e-2, w_path 10, w_eq 100 and 500 iterations, as the
reference notebook's cells 18-21.

``ladder_tpu`` runs the whole optimisation as one jitted ``lax.scan``; here
it is a loop of ``torch.autograd.grad`` over a leaf tensor of points on the
caller's device. The history stays on the device and is copied to the host
once, after the last iteration, so the loop never waits on the device. The
gradient comes only from the prior's log-density: the model is never
differentiated. Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ladder_tpu_torch.ops.distributions import (
    diag_gaussian_logpdf,
    diag_mixture_logpdf,
    gmm_cholesky,
    gmm_logpdf,
)
from ladder_tpu_torch.training.optim import ADAM_B1, ADAM_B2, ADAM_EPS

HISTORY_KEYS = ("obj", "path_length", "step_var", "neg_ll")


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def embedding_dim(config):
    """t's size for the priors with an inner VAE, z's otherwise."""
    return (config["representation_size"]
            if config["prior"] in ("ours", "hierarchical")
            else config["code_size"])


def prior_logpdf_fn(config, gm=None, vamp_params=None):
    """log p(.) of the configured prior.

    gm: (weights, means, covs) for 'ours'/'GMM'; vamp_params: (means, stds)
    of the encoded pseudo-inputs for vampPrior. Arrays or tensors; the
    closure computes on their device (the standard normal's on the points')."""
    prior = config["prior"]
    if prior in ("GMM", "ours"):
        w, m, K = (_f32(a) for a in gm)
        chols = gmm_cholesky(K)
        return lambda x: gmm_logpdf(x, w, m, chols)
    if prior in ("standard_gaussian", "hierarchical"):
        d = (config["code_size"] if prior == "standard_gaussian"
             else config["representation_size"])
        return lambda x: diag_gaussian_logpdf(x, x.new_zeros(d),
                                              x.new_ones(d))
    if prior == "vampPrior":
        means, stds = (_f32(a) for a in vamp_params)
        k = means.shape[0]
        w = torch.full((k,), 1.0 / k, device=means.device)
        return lambda x: diag_mixture_logpdf(x, w, means, stds)
    raise ValueError(prior)


def interpolation_objective(pts, start, end, log_prob, w_path=10.0,
                            w_eq=100.0):
    """(obj, aux) of the SLP objective (notebook cell 18). The step
    variance is the population std (ddof 0), as ``jnp.std``."""
    full_start = torch.cat([start[None], pts], dim=0)
    full_end = torch.cat([pts, end[None]], dim=0)
    seg = torch.sqrt(torch.sum(torch.square(full_end - full_start), dim=1))
    path_length = torch.sum(seg)
    eq = torch.std(seg, correction=0)
    neg_ll = -torch.sum(log_prob(pts))
    obj = w_path * path_length + w_eq * eq + neg_ll
    return obj, dict(path_length=path_length, step_var=eq, neg_ll=neg_ll)


def _lr_t(lr, t):
    """TF1's bias-corrected step size at step t, in float32 as JAX's carry
    computes it (t is a float there, not an integer power)."""
    t = np.float32(t)
    one = np.float32(1.0)
    return float(np.float32(lr) * np.sqrt(one - np.float32(ADAM_B2) ** t)
                 / (one - np.float32(ADAM_B1) ** t))


def optimise_slp(init_pts, start, end, log_prob, n_iter=500, lr=1e-2,
                 w_path=10.0, w_eq=100.0):
    """Adam over the interior points for n_iter iterations, on init_pts'
    device. Returns (final_pts, history): history holds per iteration the
    objective and its parts before that iteration's update (``HISTORY_KEYS``,
    the notebook's loss records), as float32 numpy arrays."""
    pts = _f32(init_pts).detach().clone()
    start, end = (_f32(a).detach().to(pts.device) for a in (start, end))
    m = torch.zeros_like(pts)
    v = torch.zeros_like(pts)
    hist = torch.empty((n_iter, len(HISTORY_KEYS)), device=pts.device)
    for i in range(n_iter):
        pts.requires_grad_(True)
        with torch.enable_grad():
            obj, aux = interpolation_objective(pts, start, end, log_prob,
                                               w_path, w_eq)
            (g,) = torch.autograd.grad(obj, pts)
        with torch.no_grad():
            hist[i] = torch.stack([obj, aux["path_length"], aux["step_var"],
                                   aux["neg_ll"]])
            g = torch.clamp(g, -1.0, 1.0)
            m = ADAM_B1 * m + (1 - ADAM_B1) * g
            v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
            pts = pts - _lr_t(lr, i + 1) * m / (torch.sqrt(v) + ADAM_EPS)
    host = hist.cpu().numpy()
    return pts.detach(), {k: host[:, j] for j, k in enumerate(HISTORY_KEYS)}


def straight_line_init(start, end, n_step):
    """n_step evenly spaced interior points (notebook cell 18's 'linspace'
    branch): start + (end - start) * k / (n_step + 1), k = 1..n_step,
    computed as ``jnp.linspace(..., endpoint=False)[1:]`` computes it."""
    start, end = _f32(start), _f32(end)
    step = torch.arange(1, n_step + 1, dtype=torch.float32,
                        device=start.device)[:, None] / (n_step + 1)
    return start[None] * (1 - step) + end[None] * step


def interpolate(config, start, end, log_prob, n_step=8, n_iter=500, lr=1e-2,
                w_path=10.0, w_eq=100.0, init="linear", generator=None,
                sample_fn=None):
    """End-to-end SLP: init, then optimise. Returns (slp_pts, init_pts,
    history); with the linear init, init_pts are the straight line's (SP)
    points.

    init="random": interior points from sample_fn(generator, n_step) (the
    demo samples the fitted prior), or without a sample_fn standard normals
    in the embedding space drawn from ``generator``."""
    start, end = _f32(start), _f32(end)
    if init == "random":
        if generator is None:
            raise ValueError("init='random' needs a generator")
        if sample_fn is not None:
            init_pts = sample_fn(generator, n_step)
        else:
            init_pts = torch.randn((n_step, embedding_dim(config)),
                                   generator=generator,
                                   device=generator.device)
        init_pts = _f32(init_pts).to(start.device)
    else:
        init_pts = straight_line_init(start, end, n_step)
    slp, hist = optimise_slp(init_pts, start, end, log_prob, n_iter=n_iter,
                             lr=lr, w_path=w_path, w_eq=w_eq)
    return slp, init_pts, hist
