"""Distribution primitives of the serving path and the losses:
diagonal-Gaussian sampling and log-density, mixtures of diagonal Gaussians,
and full-covariance Gaussian mixtures (Cholesky log-prob + logsumexp,
sampling).

The port of ``ladder_tpu/ops/distributions.py``. Sampling draws from an
explicit ``torch.Generator``; the mixture's noise-fed core
(``sample_gmm_from_noise``) takes the component indices and the
standard-normal draws as arguments, so tests can hand JAX and the port the
same numbers.
"""

from __future__ import annotations

import math

import torch

from ladder_tpu_torch.utils.profiling import span

LOG_2PI = math.log(2.0 * math.pi)


def _randn(shape, generator, like):
    """Standard normals drawn on the generator's device, then moved to
    ``like``'s device and dtype."""
    eps = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    return eps.to(device=like.device, dtype=like.dtype)


def sample_diag_gaussian(generator, mean, std):
    """Reparameterised sample from N(mean, diag(std^2))."""
    return mean + std * _randn(mean.shape, generator, mean)


def diag_gaussian_logpdf(x, mean, std):
    """log N(x; mean, diag(std^2)) summed over the last axis."""
    z = (x - mean) / std
    return -0.5 * (z * z + 2.0 * torch.log(std) + LOG_2PI).sum(-1)


def diag_mixture_logpdf(x, weights, means, stds):
    """log p(x) under a mixture of diagonal Gaussians (the vampPrior's
    pseudo-input mixture). means, stds: [K,D]; x: [..., D]."""
    with span("mixture.logpdf"):
        comp = torch.stack([diag_gaussian_logpdf(x, means[k], stds[k])
                            for k in range(means.shape[0])])      # [K, ...]
        logw = torch.log(weights).reshape((-1,) + (1,) * (comp.dim() - 1))
        return torch.logsumexp(comp + logw, dim=0)


def mvn_full_logpdf(x, mean, chol):
    """log N(x; mean, LL^T) with Cholesky factor ``chol`` [D,D].

    x: [..., D]; mean: [D]; returns [...]."""
    d = mean.shape[-1]
    diff = x - mean
    batch_shape = diff.shape[:-1]
    flat = diff.reshape(-1, d).T                       # [D, N]
    y = torch.linalg.solve_triangular(chol, flat, upper=False)
    y = y.T.reshape(batch_shape + (d,))
    logdet = torch.log(torch.diagonal(chol)).sum()
    return -0.5 * (y * y).sum(-1) - logdet - 0.5 * d * LOG_2PI


def gmm_cholesky(covs, jitter=0.0):
    """Batched Cholesky of mixture covariances [K,D,D] (+ optional jitter*I)."""
    if jitter:
        covs = covs + jitter * torch.eye(covs.shape[-1], dtype=covs.dtype,
                                         device=covs.device)
    return torch.linalg.cholesky(covs)


def gmm_logpdf(x, weights, means, chols):
    """log p(x) under a full-covariance Gaussian mixture: logsumexp_k of
    log w_k + log N_k(x). Zero-weight components are masked to -inf.

    x: [..., D]; weights: [K]; means: [K,D]; chols: [K,D,D]."""
    with span("mixture.logpdf"):
        comp = torch.stack([mvn_full_logpdf(x, means[k], chols[k])
                            for k in range(means.shape[0])])      # [K, ...]
        logw = torch.where(weights > 0, torch.log(weights.clamp_min(1e-38)),
                           torch.full_like(weights, -math.inf))
        logw = logw.reshape((-1,) + (1,) * (comp.dim() - 1))
        return torch.logsumexp(comp + logw, dim=0)


def sample_gmm_from_noise(comps, eps, means, chols):
    """Mixture samples from component indices comps [n] and standard
    normals eps [n, D]: means[k] + chols[k] @ eps."""
    return means[comps] + torch.einsum("nij,nj->ni", chols[comps], eps)


def sample_gmm(generator, weights, means, chols, n):
    """Draw n samples [n, D] from a full-covariance mixture."""
    w = weights.detach().to(device=generator.device, dtype=torch.float64)
    comps = torch.multinomial(w.clamp_min(0.0), n, replacement=True,
                              generator=generator).to(means.device)
    eps = _randn((n, means.shape[-1]), generator, means)
    return sample_gmm_from_noise(comps, eps, means, chols)
