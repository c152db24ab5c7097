"""The CelebA-128 fast GM fit of the port against ladder_tpu's, epoch by
epoch, on the samples of a float32 run on the card.

The fixture, tests/torch_fixtures/celeba_fast_fits_f32_seed0.npz, was
recorded on an NVIDIA H100 during the float32 seed-0 CelebA-128 quality
record (``python -m ladder_tpu_torch.quality --config
codes/celeba_config.json --fused 2 --seed 0 --n-train 12800 --override
'{"synthetic_n_val": 512}' --fid-samples 512``) by wrapping the trainer's
``fit_GMM_VI``: for each fast fit (epochs 10-50: the fits start at
sg_pretraining's last epoch), ``epoch``, the 2,048 t samples it fitted
(``samples``, float32), the fit it made (``w``, ``m``, ``K``: weights,
means, covariances), its iterations ``n_iter`` and ``converged``. The fit
each epoch warm-starts from is the previous epoch's.

Each package runs on the CPU in float32 from the same samples and the same
previous fit: ladder_tpu's warm start (``ladder_tpu/training/trainer.py:
_resp_from_prev``, written out below) and ``fit_bgmm``; the port's
``responsibilities(..., jitter=1e-6)`` and ``fit_bgmm``. Both run as many
iterations as the card's fit did. They must agree with each other, and
ladder_tpu's with the card's recorded fit, at ``tests/test_torch_gmm.py``'s
FIXED_TOL, and keep the card's active mixtures.

Where a fit stops is not compared across packages: the stop test,
|change of the lower bound| < 1e-3, reads a float32 bound whose terms are
~1e4 (ulp ~1e-3), and on these fits' slow plateaus rounding decides it.
ladder_tpu itself stops on another iteration when only the samples' order
changes (``test_the_stop_moves_with_rounding``), while its fit at a given
iteration count does not move.

The first fit has no previous one: both packages start from the same
k-means responsibilities (their random streams differ), so the card's
start, and with it the card's fit, is not reproduced there; from one-hot
k-means 50 components of ~40 samples trade samples for 277 iterations,
and the two packages' rounding grows with the iterations (3x FIXED_TOL at
the end), so that fit is held at test_torch_gmm's tolerance for fits run
to their stop (rtol, atol 1e-3).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ladder_tpu.ops import gmm as jgmm
from ladder_tpu_torch.ops import gmm as tgmm
from tests.test_torch_gmm import FIXED_TOL
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

FIXTURE = (Path(__file__).parent / "torch_fixtures"
           / "celeba_fast_fits_f32_seed0.npz")
REC = dict(np.load(FIXTURE))
N_FITS, K = REC["w"].shape
# the fast fit's arguments (training/trainer.py:fit_GMM_VI in both packages)
FIT = dict(weight_concentration_prior=0.1, dirichlet_process=False)
RUN_TO_STOP_TOL = dict(rtol=1e-3, atol=1e-3)


def active(weights):
    return int((np.asarray(weights) >= tgmm.ACTIVE_WEIGHT_THRESHOLD).sum())


def jax_warm_start(x, w, m, cov):
    """ladder_tpu's _resp_from_prev: the samples' responsibilities under
    the previous fast fit, its covariances with 1e-6 jitter."""
    pc = jgmm._precision_chol(cov + 1e-6 * jnp.eye(cov.shape[-1]))
    logp = (jgmm._log_gaussian_prob(x, m, pc)
            + jnp.log(jnp.maximum(w, 1e-38))[None, :])
    return jax.nn.softmax(logp, axis=1)


def jax_fit(x, resp):
    """ladder_tpu's fast fit, to its stop (max_iter 1000, the default
    tol)."""
    fit, _ = jgmm.fit_bgmm(jax.random.PRNGKey(0), jnp.asarray(x), K,
                           init_resp=resp, max_iter=1000, **FIT)
    return fit


@jax.jit
def jax_fixed(x, resp, n_iter):
    """ladder_tpu's fit_bgmm (ladder_tpu/ops/gmm.py:301-363, the fast
    fit's prior) for exactly n_iter iterations, from its own steps, with
    the count traced: fit_bgmm compiles once for each max_iter. Returns
    (weights, means, covariances)."""
    n, d = x.shape
    m0 = jnp.mean(x, axis=0)
    xc = x - m0[None, :]
    w0inv = (xc.T @ xc) / (n - 1) + 1e-6 * jnp.eye(d, dtype=x.dtype)
    prior = (FIT["weight_concentration_prior"], 1.0, m0, float(d), w0inv,
             FIT["dirichlet_process"])

    def step(_, carry):
        post, _ = jgmm._vi_m_step(x, carry[1], prior, 1e-6)
        resp, _, _ = jgmm._vi_e_step(x, post, FIT["dirichlet_process"])
        return post, resp

    post, _ = jax.lax.fori_loop(0, n_iter, step, step(0, (None, resp)))
    return (post.wc1 / jnp.sum(post.wc1), post.m,
            post.winv / post.nu[:, None, None])


def card_fit(i):
    return REC["w"][i], REC["m"][i], REC["K"][i]


def assert_fit_close(got, want, tol=FIXED_TOL):
    """(weights, means, covariances) against (weights, means,
    covariances)."""
    for name, a, b in zip(("weights", "means", "covariances"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=name, **tol)


def test_fixture_is_a_whole_run():
    """One fast fit an epoch from sg_pretraining's last (10) to the 50th,
    every sample finite, the card's fits converged."""
    assert list(REC["epoch"]) == list(range(10, 51))
    assert REC["samples"].shape == (N_FITS, 2048, 2)
    assert REC["samples"].dtype == np.float32
    assert np.isfinite(REC["samples"]).all()
    assert REC["converged"].all()


@pytest.mark.parametrize("i", range(N_FITS),
                         ids=lambda i: f"epoch{REC['epoch'][i]}")
def test_fast_fit_matches_ladder_tpu(i):
    x = REC["samples"][i]
    tx = torch.as_tensor(x)
    if i == 0:
        tresp = tgmm._resp_from_kmeans(torch.Generator().manual_seed(0), tx,
                                       K)
        jresp = jnp.asarray(tresp.numpy())
    else:
        prev = card_fit(i - 1)
        jresp = jax_warm_start(jnp.asarray(x), *map(jnp.asarray, prev))
        tresp = tgmm.responsibilities(tx, *map(torch.as_tensor, prev),
                                      jitter=1e-6)
        np.testing.assert_allclose(tresp.numpy(), np.asarray(jresp),
                                   **FIXED_TOL)
    n = int(REC["n_iter"][i])
    want = jax_fixed(jnp.asarray(x), jresp, n)
    got, _ = tgmm.fit_bgmm(torch.Generator().manual_seed(0), tx, K,
                           init_resp=tresp, max_iter=n, tol=0.0, **FIT)
    got = (got.weights, got.means, got.covariances)
    assert active(got[0]) == active(want[0])
    if i == 0:
        assert_fit_close(got, want, RUN_TO_STOP_TOL)
        return
    assert_fit_close(got, want)
    assert_fit_close(want, card_fit(i))
    assert active(want[0]) == active(REC["w"][i])


def test_chain_from_the_first_recorded_fit():
    """ladder_tpu's fast fits chained over the card's samples from the
    card's first fit, each warm-started from its own previous fit and run
    as long as the card's, keep the card's active counts at every epoch (4
    at epoch 11, 2 from epoch 12 on: the chain does not fall to 1) and
    land on the card's fits (40 fits in a row: test_torch_gmm's tolerance
    for fits run to their stop)."""
    prev = tuple(jnp.asarray(a) for a in card_fit(0))
    chain = []
    for i in range(1, N_FITS):
        x = jnp.asarray(REC["samples"][i])
        prev = jax_fixed(x, jax_warm_start(x, *prev), REC["n_iter"][i])
        assert_fit_close(prev, card_fit(i), RUN_TO_STOP_TOL)
        chain.append(active(prev[0]))
    assert chain == [active(w) for w in REC["w"][1:]] == [4] + [2] * 39


def stops(i):
    """ladder_tpu's fast fit at epoch index i, from the card's previous fit,
    run to its stop on the card's samples and on the same samples in
    another order: (fit, fit of the permuted samples, their warm
    starts)."""
    x = jnp.asarray(REC["samples"][i])
    xp = x[np.random.default_rng(i).permutation(x.shape[0])]
    prev = tuple(map(jnp.asarray, card_fit(i - 1)))
    resp, resp_p = jax_warm_start(x, *prev), jax_warm_start(xp, *prev)
    return jax_fit(x, resp), jax_fit(xp, resp_p), (x, xp, resp, resp_p)


def test_the_stop_moves_with_rounding():
    """ladder_tpu's own fast fit stops on other iterations when only the
    samples' order changes (the same data, other rounding) at epochs 13
    and 37 (83 / 13 and 12 / 176 iterations here; at least one must move),
    while the two orders agree when run for the same count, as
    jax_fixed agrees with fit_bgmm. ``PYTHONPATH=. python
    tests/test_torch_fast_fit_chain.py`` prints the stops of every
    epoch."""
    moved = 0
    for epoch in (13, 37):
        a, b, (x, xp, resp, resp_p) = stops(list(REC["epoch"]).index(epoch))
        assert bool(a.converged) and bool(b.converged)
        want = (a.weights, a.means, a.covariances)
        assert_fit_close(jax_fixed(x, resp, a.n_iter), want)
        if int(a.n_iter) != int(b.n_iter):
            moved += 1
            assert_fit_close(jax_fixed(xp, resp_p, a.n_iter), want)
    assert moved > 0


if __name__ == "__main__":
    # each epoch: the card's iterations and active mixtures; ladder_tpu's
    # and the port's fast fit run to their stops from the card's previous
    # fit, and ladder_tpu's on the permuted samples
    moved = 0
    for i in range(1, N_FITS):
        a, b, (x, _, resp, _) = stops(i)
        tx = torch.as_tensor(np.array(x))
        t, _ = tgmm.fit_bgmm(None, tx, K, init_resp=tgmm.responsibilities(
            tx, *map(torch.as_tensor, card_fit(i - 1)), jitter=1e-6),
            max_iter=1000, **FIT)
        moved += int(a.n_iter) != int(b.n_iter)
        print(f"epoch {REC['epoch'][i]}: card {REC['n_iter'][i]} iterations "
              f"{active(REC['w'][i])} active; ladder_tpu {int(a.n_iter)} "
              f"{active(a.weights)}, permuted {int(b.n_iter)} "
              f"{active(b.weights)}; port {t.n_iter} {active(t.weights)}")
    print(f"ladder_tpu's stop moved with the order at {moved} of "
          f"{N_FITS - 1} epochs")
