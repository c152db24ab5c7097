"""The port's GM fitters (ladder_tpu_torch/ops/gmm.py) against ladder_tpu's
on the same samples and the same start: the k-means draws cannot match
(JAX's threefry against torch's generator), so both packages get the same
init_resp (the VI fits) or the same initial parameters (EM).

Tolerances. A fixed count of 30 iterations (tol=0): float32 on both sides,
the same formulas in other summation orders, so weights, means and
covariances agree within rtol 1e-4, atol 1e-5. Under the default tol on
well-separated blobs both loops stop on the same iteration and the fits
agree within 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ladder_tpu.ops import gmm as jgmm
from ladder_tpu_torch.ops import gmm as tgmm
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

FIXED_TOL = dict(rtol=1e-4, atol=1e-5)


def blobs(n_per=200, seed=0, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    x = np.concatenate([c + spread * rng.standard_normal((n_per, 2))
                        for c in centers])
    return x.astype(np.float32), centers


def random_resp(n, k, seed=1):
    logits = np.random.default_rng(seed).standard_normal((n, k)) * 2
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def match_means(fitted, true, weights=None, w_floor=0.05):
    fitted = np.asarray(fitted)
    if weights is not None:
        fitted = fitted[np.asarray(weights) >= w_floor]
    return max(np.min(np.linalg.norm(fitted - t, axis=1)) for t in true)


def assert_fits_close(got, want, **tol):
    for name in ("weights", "means", "covariances"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("dp", [False, True])
def test_fit_bgmm_fixed_iterations_match_jax(dp):
    x, _ = blobs(seed=3)
    resp = random_resp(len(x), 6)
    want, want_resp = jgmm.fit_bgmm(
        jax.random.PRNGKey(0), jnp.asarray(x), 6, max_iter=30, tol=0.0,
        dirichlet_process=dp, init_resp=jnp.asarray(resp))
    got, got_resp = tgmm.fit_bgmm(
        None, torch.tensor(x), 6, max_iter=30, tol=0.0,
        dirichlet_process=dp, init_resp=torch.tensor(resp))
    assert got.n_iter == int(want.n_iter) == 30
    assert not got.converged and not bool(want.converged)
    assert_fits_close(got, want, **FIXED_TOL)
    np.testing.assert_allclose(got_resp.numpy(), np.asarray(want_resp),
                               **FIXED_TOL)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=1e-5)


def test_fit_em_fixed_iterations_match_jax():
    x, centers = blobs(seed=4)
    rng = np.random.default_rng(2)
    init = dict(init_weights=np.full(3, 1 / 3, np.float32),
                init_means=(centers + rng.standard_normal((3, 2))).astype(
                    np.float32),
                init_covs=np.stack([np.eye(2, dtype=np.float32) * 2] * 3))
    want = jgmm.fit_em(jax.random.PRNGKey(0), jnp.asarray(x), 3, max_iter=30,
                       tol=0.0, **{k: jnp.asarray(v) for k, v in init.items()})
    got = tgmm.fit_em(None, torch.tensor(x), 3, max_iter=30, tol=0.0,
                      **{k: torch.tensor(v) for k, v in init.items()})
    assert got.n_iter == int(want.n_iter) == 30
    assert_fits_close(got, want, **FIXED_TOL)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=1e-5)


@pytest.mark.parametrize("fit", ["dirichlet_distribution",
                                 "dirichlet_process", "em"])
def test_default_tol_stops_on_the_same_iteration(fit):
    x, centers = blobs(seed=5, spread=0.4)
    if fit == "em":
        init = dict(init_weights=np.full(3, 1 / 3, np.float32),
                    init_means=(centers + 0.5).astype(np.float32),
                    init_covs=np.stack([np.eye(2, dtype=np.float32)] * 3))
        want = jgmm.fit_em(jax.random.PRNGKey(0), jnp.asarray(x), 3,
                           **{k: jnp.asarray(v) for k, v in init.items()})
        got = tgmm.fit_em(None, torch.tensor(x), 3,
                          **{k: torch.tensor(v) for k, v in init.items()})
    else:
        resp = random_resp(len(x), 5, seed=6)
        dp = fit == "dirichlet_process"
        want, _ = jgmm.fit_bgmm(jax.random.PRNGKey(0), jnp.asarray(x), 5,
                                dirichlet_process=dp,
                                init_resp=jnp.asarray(resp))
        got, _ = tgmm.fit_bgmm(None, torch.tensor(x), 5,
                               dirichlet_process=dp,
                               init_resp=torch.tensor(resp))
    assert bool(want.converged) and got.converged
    assert 2 <= got.n_iter == int(want.n_iter) < 1000
    assert_fits_close(got, want, rtol=1e-3, atol=1e-3)
    assert match_means(got.means.numpy(), centers, got.weights.numpy()) < 0.3


def test_restart_selection_skips_nan_bounds():
    def fit(lb, tag):
        return (tgmm.GMMFit(torch.full((2,), tag), torch.zeros(2, 1),
                            torch.zeros(2, 1, 1), torch.tensor(lb), 1, True),
                torch.full((3, 2), tag))

    fits = [fit(float("nan"), 0.0), fit(-3.0, 1.0), fit(-5.0, 2.0)]
    best, resp = tgmm._select_best_restart(fits)
    assert best.weights[0] == 1.0 and resp[0, 0] == 1.0
    # ladder_tpu's selection over the same bounds picks the same restart
    stacked = jgmm.GMMFit(jnp.asarray([[0.0] * 2, [1.0] * 2, [2.0] * 2]),
                          jnp.zeros((3, 2, 1)), jnp.zeros((3, 2, 1, 1)),
                          jnp.asarray([np.nan, -3.0, -5.0]),
                          jnp.ones(3, int), jnp.ones(3, bool))
    jbest, _ = jgmm._select_best_restart(stacked, jnp.zeros((3, 3, 2)))
    assert float(jbest.weights[0]) == 1.0


def test_restarts_keep_the_best_bound():
    x, centers = blobs(seed=7)
    g = torch.Generator().manual_seed(0)
    fit, resp = tgmm.fit_bgmm_restarts(g, torch.tensor(x), 6, n_init=3,
                                       dirichlet_process=True)
    assert resp.shape == (len(x), 6)
    np.testing.assert_allclose(fit.weights.sum().item(), 1.0, rtol=1e-5)
    assert match_means(fit.means.numpy(), centers, fit.weights.numpy()) < 0.5


def test_kmeans_recovers_blobs():
    x, centers = blobs()
    c, labels = tgmm.kmeans(torch.Generator().manual_seed(0),
                            torch.tensor(x), 3)
    assert match_means(c.numpy(), centers) < 0.5
    assert len(np.unique(labels.numpy())) == 3


def test_fits_from_kmeans_recover_blobs():
    x, centers = blobs(seed=8)
    g = torch.Generator().manual_seed(1)
    fit, _ = tgmm.fit_bgmm(g, torch.tensor(x), 10)
    w = fit.weights.numpy()
    assert 3 <= (w >= tgmm.ACTIVE_WEIGHT_THRESHOLD).sum() <= 6
    assert match_means(fit.means.numpy(), centers, w) < 0.5
    em = tgmm.fit_em(g, torch.tensor(x), 3)
    assert em.converged
    assert match_means(em.means.numpy(), centers) < 0.3


def test_helpers_match_jax():
    """betaln at the sizes the stick-breaking bound meets, and the warm
    start's responsibilities (ladder_tpu/training/trainer.py:576-584)."""
    from jax.scipy.special import betaln

    a = np.array([0.5, 3.0, 40.0, 1200.0, 2.0e4], np.float32)
    b = np.array([7.0, 9.0, 2.5e3, 15.0, 3.0e4], np.float32)
    np.testing.assert_allclose(
        tgmm.betaln(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(betaln(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    x, _ = blobs(n_per=20, seed=9)
    rng = np.random.default_rng(3)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    m = rng.standard_normal((3, 2)).astype(np.float32)
    K = np.stack([np.eye(2, dtype=np.float32) * s for s in (0.5, 1.0, 2.0)])
    pc = jgmm._precision_chol(jnp.asarray(K) + 1e-6 * jnp.eye(2))
    want = jax.nn.softmax(jgmm._log_gaussian_prob(jnp.asarray(x),
                                                  jnp.asarray(m), pc)
                          + jnp.log(jnp.asarray(w))[None, :], axis=1)
    got = tgmm.responsibilities(torch.tensor(x), torch.tensor(w),
                                torch.tensor(m), torch.tensor(K), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_failed_cholesky_gives_nan_not_an_exception():
    covs = torch.stack([torch.eye(2), -torch.eye(2)])
    pc = tgmm._precision_chol(covs)
    assert torch.isfinite(pc[0]).all() and torch.isnan(pc[1]).all()
