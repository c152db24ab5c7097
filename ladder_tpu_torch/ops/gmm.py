"""Gaussian-mixture fitting on the device: EM and variational Bayesian EM
(the port of ``ladder_tpu/ops/gmm.py``).

Three fitters, as in ``ladder_tpu``:
  * fit_em                            -- full-covariance EM (the GMM prior)
  * fit_bgmm 'dirichlet_distribution' -- the per-epoch fast fit
  * fit_bgmm 'dirichlet_process'      -- the accurate stick-breaking fit
with sklearn's prior defaults (mean_precision_prior 1, mean_prior mean(X),
degrees_of_freedom_prior D, covariance_prior cov(X) unscaled, reg_covar
1e-6), sklearn's lower bound as the convergence and restart-selection
objective, and posterior expectations as the reported weights and
covariances (W^-1/nu).

The loop. ``ladder_tpu`` runs ``lax.while_loop``, which tests
``~done & it < max_iter`` before every body, with ``done = |new_lb - lb| <
tol``. Here the body is a Python loop over device tensors and the test
reads ``done`` on the host once per iteration: one host synchronisation an
iteration, and the same iteration count as ``ladder_tpu`` on the same
numbers. Everything stays float32. A failed Cholesky gives NaN factors, as
``jnp.linalg.cholesky`` does, never an exception, so a diverged fit reports
a NaN bound, which restart selection never picks.

Random numbers come from an explicit ``torch.Generator`` (the k-means++
seeding); the draws cannot match JAX's, so tests hand both packages the
same ``init_resp`` or initial parameters. sklearn's own fitter (the
``gmm_backend: sklearn`` option of ``ladder_tpu``) is not ported: the port
does not depend on scikit-learn.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# A component counts as active when its weight reaches this (the trainer's
# report, GM_prior_info.npz).
ACTIVE_WEIGHT_THRESHOLD = 1e-2

_EPS32 = torch.finfo(torch.float32).eps
_LOG_2PI = math.log(2.0 * math.pi)


class GMMFit(NamedTuple):
    """A fitted mixture. lower_bound: the mean log-likelihood for EM,
    sklearn's _compute_lower_bound for the VI fits; n_iter: a Python int;
    the rest are tensors on the samples' device."""
    weights: torch.Tensor      # [K]
    means: torch.Tensor        # [K,D]
    covariances: torch.Tensor  # [K,D,D]
    lower_bound: torch.Tensor  # scalar
    n_iter: int
    converged: bool


# ---------------------------------------------------------------------------
# k-means init (kmeans++ seeding + Lloyd)
# ---------------------------------------------------------------------------

def _gumbel_argmax(logits, generator):
    """A categorical draw without a host synchronisation (Gumbel-max, as
    jax.random.categorical)."""
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    u = u.clamp(_EPS32, 1.0 - _EPS32)
    return torch.argmax(logits - torch.log(-torch.log(u)))


def kmeans_plusplus(generator, x, k):
    """kmeans++ seeding. x: [N,D] -> centers [K,D]."""
    n = x.shape[0]
    first = torch.randint(n, (), generator=generator,
                          device=generator.device).to(x.device)
    centers = x.new_zeros((k, x.shape[1]))
    centers[0] = x[first]
    for i in range(1, k):
        d2 = ((x[:, None, :] - centers[None, :i, :]) ** 2).sum(-1).amin(1)
        probs = d2 / d2.sum().clamp_min(1e-30)
        centers[i] = x[_gumbel_argmax(torch.log(probs.clamp_min(1e-30)),
                                      generator)]
    return centers


def kmeans(generator, x, k, n_iter=25):
    """Lloyd iterations. Returns (centers [K,D], labels [N])."""
    centers = kmeans_plusplus(generator, x, k)
    for _ in range(n_iter):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        onehot = torch.nn.functional.one_hot(d2.argmin(1), k).to(x.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1)[:, None], centers)
    d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return centers, d2.argmin(1)


def _resp_from_kmeans(generator, x, k):
    _, labels = kmeans(generator, x, k)
    return torch.nn.functional.one_hot(labels, k).to(x.dtype)


# ---------------------------------------------------------------------------
# shared statistics
# ---------------------------------------------------------------------------

def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _gaussian_suffstats(x, resp, reg_covar):
    """N_k, xbar_k, S_k (weighted scatter) from responsibilities."""
    nk = resp.sum(0) + 10 * _EPS32                                    # [K]
    means = (resp.T @ x) / nk[:, None]                                # [K,D]
    diff = x[:, None, :] - means[None, :, :]                          # [N,K,D]
    covs = torch.einsum("nk,nki,nkj->kij", resp, diff, diff) / nk[:, None,
                                                                  None]
    return nk, means, covs + reg_covar * _eye(x.shape[1], x)


def _cholesky(a):
    """Lower Cholesky factors; NaN where a matrix is not positive definite
    (``jnp.linalg.cholesky``'s behaviour; no host synchronisation)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, math.nan))


def _precision_chol(covs):
    """Lower L with Sigma^-1 = L L^T, from Sigma = C C^T: L = C^-T."""
    chol = _cholesky(covs)
    eye = _eye(covs.shape[-1], covs).expand_as(covs)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_chol.transpose(1, 2)


def _log_diag(a):
    return torch.log(torch.abs(torch.diagonal(a, dim1=1, dim2=2)))


def _log_gaussian_prob(x, means, precisions_chol):
    """[N,K] log N(x_n; mu_k, Sigma_k) from Cholesky factors of the
    precisions."""
    d = x.shape[1]
    y = torch.einsum("kij,nkj->nki", precisions_chol.transpose(1, 2),
                     x[:, None, :] - means[None, :, :])
    log_det = _log_diag(precisions_chol).sum(1)
    return -0.5 * (d * _LOG_2PI + (y * y).sum(2)) + log_det[None, :]


def responsibilities(x, weights, means, covs, jitter=0.0):
    """softmax_k(log w_k + log N(x; mu_k, Sigma_k + jitter I)): the
    responsibilities of new samples under a fitted mixture (the trainer's
    warm start)."""
    pc = _precision_chol(covs + jitter * _eye(covs.shape[-1], covs))
    logp = (_log_gaussian_prob(x, means, pc)
            + torch.log(weights.clamp_min(1e-38))[None, :])
    return torch.softmax(logp, dim=1)


def _converged(new, old, tol):
    """|new - old| < tol, read on the host (one synchronisation)."""
    return bool(torch.abs(new - old) < tol)


# ---------------------------------------------------------------------------
# Maximum-likelihood EM
# ---------------------------------------------------------------------------

def fit_em(generator, x, k, max_iter=1000, tol=1e-3, reg_covar=1e-6,
           init_weights=None, init_means=None, init_covs=None):
    """Full-covariance EM; warm-started from init_* or initialised by
    k-means."""
    n = x.shape[0]
    if init_means is None:
        resp = _resp_from_kmeans(generator, x, k)
        nk, means, covs = _gaussian_suffstats(x, resp, reg_covar)
        weights = nk / n
    else:
        weights, means, covs = init_weights, init_means, init_covs

    def e_step(weights, means, covs):
        log_prob = _log_gaussian_prob(x, means, _precision_chol(covs))
        weighted = log_prob + torch.log(weights.clamp_min(1e-38))[None, :]
        log_norm = torch.logsumexp(weighted, dim=1)
        return torch.exp(weighted - log_norm[:, None]), log_norm.mean()

    resp, ll = e_step(weights, means, covs)
    it, done = 0, False
    while not done and it < max_iter:
        nk, means, covs = _gaussian_suffstats(x, resp, reg_covar)
        weights = nk / n
        resp, new_ll = e_step(weights, means, covs)
        done = _converged(new_ll, ll, tol)
        it, ll = it + 1, new_ll
    return GMMFit(weights, means, covs, ll, it, done)


# ---------------------------------------------------------------------------
# Variational Bayesian EM
# ---------------------------------------------------------------------------

class _VIPosterior(NamedTuple):
    wc1: torch.Tensor   # dirichlet alpha_k, or stick-breaking gamma_k1
    wc2: torch.Tensor   # gamma_k2 for the DP; zeros otherwise
    beta: torch.Tensor  # mean precisions [K]
    m: torch.Tensor     # posterior means [K,D]
    nu: torch.Tensor    # degrees of freedom [K]
    winv: torch.Tensor  # inverse scale matrices W^-1 [K,D,D]


def _vi_m_step(x, resp, prior, reg_covar):
    """Posterior updates (Bishop 10.58-10.63)."""
    wcp, beta0, m0, nu0, w0inv, dp = prior
    nk, xbar, sk = _gaussian_suffstats(x, resp, reg_covar=0.0)
    if dp:
        # stick-breaking: gamma_k1 = 1 + N_k, gamma_k2 = gamma + sum_{j>k} N_j
        tail = torch.flip(torch.cumsum(torch.flip(nk, (0,)), 0), (0,)) - nk
        wc1, wc2 = 1.0 + nk, wcp + tail
    else:
        wc1, wc2 = wcp + nk, torch.zeros_like(nk)
    beta = beta0 + nk
    m = (beta0 * m0[None, :] + nk[:, None] * xbar) / beta[:, None]
    nu = nu0 + nk
    diff = xbar - m0[None, :]
    winv = (w0inv[None, :, :] + nk[:, None, None] * sk
            + (beta0 * nk / beta)[:, None, None]
            * torch.einsum("ki,kj->kij", diff, diff))
    winv = winv + reg_covar * _eye(x.shape[1], x)
    return _VIPosterior(wc1, wc2, beta, m, nu, winv)


def _vi_expected_log_weights(post, dp):
    if dp:
        g1, g2 = post.wc1, post.wc2
        log_v = torch.digamma(g1) - torch.digamma(g1 + g2)
        log_1mv = torch.digamma(g2) - torch.digamma(g1 + g2)
        cum = torch.cat([log_v.new_zeros(1), torch.cumsum(log_1mv, 0)[:-1]])
        return log_v + cum
    return torch.digamma(post.wc1) - torch.digamma(post.wc1.sum())


def _vi_e_step(x, post, dp):
    """Responsibilities under the variational posterior (Bishop 10.46,
    10.64-10.66) and their entropy -sum resp*log(resp)."""
    d = x.shape[1]
    e_log_pi = _vi_expected_log_weights(post, dp)                     # [K]
    pc = _precision_chol(post.winv / post.nu[:, None, None])
    i = torch.arange(d, dtype=x.dtype, device=x.device)
    e_logdet = (torch.digamma((post.nu[:, None] - i[None, :]) / 2.0).sum(1)
                + d * math.log(2.0)
                - _log_diag(_cholesky(post.winv)).sum(1) * 2)
    quad = -2.0 * (_log_gaussian_prob(x, post.m, pc) + 0.5 * d * _LOG_2PI
                   - _log_diag(pc).sum(1)[None, :])                   # [N,K]
    log_rho = (e_log_pi[None, :] + 0.5 * e_logdet[None, :]
               - 0.5 * d / post.beta[None, :] - 0.5 * quad
               - 0.5 * d * _LOG_2PI)
    log_resp = log_rho - torch.logsumexp(log_rho, dim=1)[:, None]
    resp = torch.exp(log_resp)
    return resp, -torch.xlogy(resp, resp).sum()


def _algdiv(a, b):
    """log(gamma(b)) - log(gamma(a + b)) for b >= 8 and a <= b (scipy's
    cdflib algdiv, as ``jax.scipy.special.betaln`` computes it)."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, \
        0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, \
        -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
         + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a, b):
    """log B(a, b), accurate for large arguments (``jax.scipy.special.
    betaln``'s algorithm, which the lower bound's stick-breaking term uses
    at N_k in the thousands)."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


def _sk_lower_bound(post, ent, d, dp):
    """sklearn's convergence objective (_compute_lower_bound): the
    responsibility entropy minus the Wishart, weight and mean-precision
    normalisers, constants dropped as sklearn drops them."""
    pc = _precision_chol(post.winv / post.nu[:, None, None])
    ldpc = _log_diag(pc).sum(1) - 0.5 * d * torch.log(post.nu)
    i = torch.arange(d, dtype=post.nu.dtype, device=post.nu.device)
    log_wishart = -(post.nu * ldpc + post.nu * d * 0.5 * math.log(2.0)
                    + torch.lgamma(0.5 * (post.nu[:, None] - i[None, :])
                                   ).sum(1))
    if dp:
        log_norm_weight = -betaln(post.wc1, post.wc2).sum()
    else:
        log_norm_weight = (torch.lgamma(post.wc1.sum())
                           - torch.lgamma(post.wc1).sum())
    return (ent - log_wishart.sum() - log_norm_weight
            - 0.5 * d * torch.log(post.beta).sum())


def fit_bgmm(generator, x, k, max_iter=1000, tol=1e-3, reg_covar=1e-6,
             weight_concentration_prior=0.1, dirichlet_process=False,
             init_resp=None):
    """Variational Bayesian GMM. dirichlet_process=False: the Dirichlet
    distribution prior (the fast per-epoch fit); True: the stick-breaking
    Dirichlet process (the accurate fit). init_resp [N,K] warm-starts it;
    otherwise k-means from ``generator``. Returns (GMMFit, resp)."""
    n, d = x.shape
    m0 = x.mean(0)
    xc = x - m0[None, :]
    # sklearn's covariance_prior: cov(X), unscaled
    w0inv = (xc.T @ xc) / (n - 1) + reg_covar * _eye(d, x)
    prior = (weight_concentration_prior, 1.0, m0, float(d), w0inv,
             dirichlet_process)
    resp = (_resp_from_kmeans(generator, x, k) if init_resp is None
            else init_resp)

    post = _vi_m_step(x, resp, prior, reg_covar)
    resp, ent = _vi_e_step(x, post, dirichlet_process)
    lb = _sk_lower_bound(post, ent, d, dirichlet_process)
    it, done = 0, False
    while not done and it < max_iter:
        post = _vi_m_step(x, resp, prior, reg_covar)
        resp, ent = _vi_e_step(x, post, dirichlet_process)
        new_lb = _sk_lower_bound(post, ent, d, dirichlet_process)
        done = _converged(new_lb, lb, tol)
        it, lb = it + 1, new_lb

    if dirichlet_process:
        v = post.wc1 / (post.wc1 + post.wc2)
        rest = torch.cat([v.new_ones(1), torch.cumprod(1.0 - v, 0)[:-1]])
        weights = v * rest
        weights = weights / weights.sum()
    else:
        weights = post.wc1 / post.wc1.sum()
    covariances = post.winv / post.nu[:, None, None]
    return GMMFit(weights, post.m, covariances, lb, it, done), resp


def fit_bgmm_restarts(generator, x, k, n_init=1, **kwargs):
    """n_init fits from independent k-means starts, one after another;
    keeps the one with the best finite lower bound (``ladder_tpu`` runs
    them as one vmapped program with the same per-restart semantics)."""
    if n_init == 1:
        return fit_bgmm(generator, x, k, **kwargs)
    fits = [fit_bgmm(generator, x, k, **kwargs) for _ in range(n_init)]
    return _select_best_restart(fits)


def _select_best_restart(fits):
    """The (GMMFit, resp) with the best FINITE lower bound: a diverged
    restart reports NaN, which a bare argmax would pick where sklearn's
    sequential ``lb > best`` skips it."""
    lbs = torch.stack([f.lower_bound for f, _ in fits])
    lbs = torch.where(torch.isfinite(lbs), lbs,
                      torch.full_like(lbs, -math.inf))
    return fits[int(torch.argmax(lbs))]
