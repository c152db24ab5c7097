"""The port's SLP interpolation (ladder_tpu_torch/interp.py) against
ladder_tpu/interp.py on the CPU, on the same inputs made with numpy from a
seed. JAX's optimise_slp stays jitted, as ladder_tpu calls it.

Tolerances, measured here: the log-densities, the objective and its
gradient agree to float32 rounding (rtol 1e-5). The optimisation agrees to
~2e-7 over 100 iterations from a random init on the standard normal. From
the straight line it agrees for ~15 iterations and then parts: there the
segments are equal to rounding, the step variance's gradient
(seg - mean) / (n std) points in a direction set by rounding noise, and
Adam turns any gradient's sign into a step of lr. Both packages then find
the same bent path: over 100 iterations the measured gaps are obj 2.3e-3,
path length 3.5e-3 and neg-LL 6.6e-3 relative, step variance 1.9e-3 and
the final points 0.079 absolute, held at about three times that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladder_tpu import interp as jinterp
from ladder_tpu_torch import interp
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

PRIORS = ["standard_gaussian", "GMM", "ours", "hierarchical", "vampPrior"]
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = {"code_size": 5, "representation_size": 2}
# the straight-line run of the two-mode prior, after the paths part
PARTED_RTOL = {"obj": 1e-2, "path_length": 1e-2, "neg_ll": 2e-2}
PARTED_STEP_VAR_ATOL = 1e-2
PARTED_POINTS_ATOL = 0.25
SAME_ITERATIONS = 10   # before the straight-line runs part (measured ~15)


def _prior_args(prior, rng):
    """The prior's parameters (numpy) and the points' dimension."""
    d = CFG["representation_size"] if prior in ("ours", "hierarchical") \
        else CFG["code_size"]
    if prior in ("ours", "GMM"):
        a = rng.standard_normal((3, d, d)) * 0.3
        covs = (a @ a.transpose(0, 2, 1) + np.eye(d)).astype(np.float32)
        gm = (np.array([0.5, 0.3, 0.2], np.float32),
              rng.standard_normal((3, d)).astype(np.float32), covs)
        return dict(gm=gm), d
    if prior == "vampPrior":
        return dict(vamp_params=(
            rng.standard_normal((4, d)).astype(np.float32),
            (0.5 + rng.random((4, d))).astype(np.float32))), d
    return {}, d


def _both(prior, seed=0):
    rng = np.random.default_rng(seed)
    kw, d = _prior_args(prior, rng)
    cfg = dict(CFG, prior=prior)
    return (jinterp.prior_logpdf_fn(cfg, **kw),
            interp.prior_logpdf_fn(cfg, **kw), d, rng)


def two_mode():
    """tests/test_interp.py's prior: modes at (+-3, 0), a bridge at (0, 2)."""
    w = np.array([0.4, 0.4, 0.2], dtype=np.float32)
    m = np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 2.0]], dtype=np.float32)
    K = np.stack([np.eye(2) * 0.3] * 3).astype(np.float32)
    cfg = {"prior": "ours", "representation_size": 2}
    return (jinterp.prior_logpdf_fn(cfg, gm=(w, m, K)),
            interp.prior_logpdf_fn(cfg, gm=(w, m, K)))


def _close_hist(got, want, n=None, **tol):
    for key in interp.HISTORY_KEYS:
        np.testing.assert_allclose(got[key][:n], np.asarray(want[key])[:n],
                                   err_msg=key, **tol)


@pytest.mark.parametrize("prior", PRIORS)
def test_prior_logpdf_matches_jax(prior):
    jlog, tlog, d, rng = _both(prior)
    x = (2 * rng.standard_normal((7, d))).astype(np.float32)
    np.testing.assert_allclose(tlog(torch.tensor(x)).numpy(),
                               np.asarray(jlog(jnp.asarray(x))), **TOL)


def test_unknown_prior_raises():
    with pytest.raises(ValueError):
        interp.prior_logpdf_fn({"prior": "flow"})


@pytest.mark.parametrize("prior", ["ours", "standard_gaussian"])
@pytest.mark.parametrize("zero_segment", [False, True])
def test_objective_value_aux_and_gradient(prior, zero_segment):
    """Value, parts and gradient against jax.value_and_grad; with the
    first point on the start the first segment has length 0, where both
    take sqrt's gradient at 0 (NaN on that point, no epsilon)."""
    jlog, tlog, d, rng = _both(prior, seed=1)
    start, end = (rng.standard_normal(d).astype(np.float32)
                  for _ in range(2))
    pts = rng.standard_normal((6, d)).astype(np.float32)
    if zero_segment:
        pts[0] = start

    def f(p):
        return jinterp.interpolation_objective(
            p, jnp.asarray(start), jnp.asarray(end), jlog)
    (jobj, jaux), jgrad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(pts))
    p = torch.tensor(pts, requires_grad=True)
    obj, aux = interp.interpolation_objective(
        p, torch.tensor(start), torch.tensor(end), tlog)
    (grad,) = torch.autograd.grad(obj, p)
    np.testing.assert_allclose(float(obj.detach()), float(jobj), **TOL)
    for key in ("path_length", "step_var", "neg_ll"):
        np.testing.assert_allclose(float(aux[key].detach()),
                                   float(jaux[key]),
                                   err_msg=key, **TOL)
    jgrad = np.asarray(jgrad)
    assert np.isnan(jgrad[0]).all() == zero_segment
    np.testing.assert_array_equal(np.isnan(grad.numpy()), np.isnan(jgrad))
    np.testing.assert_allclose(grad.numpy(), jgrad, **TOL)


def test_step_variance_is_the_population_std():
    pts = torch.tensor([[1.0, 0.0], [1.5, 0.0]])
    _, aux = interp.interpolation_objective(
        pts, torch.zeros(2), torch.tensor([3.0, 0.0]),
        interp.prior_logpdf_fn({"prior": "standard_gaussian",
                                "code_size": 2}))
    seg = np.array([1.0, 0.5, 1.5])
    np.testing.assert_allclose(float(aux["step_var"]), seg.std(ddof=0),
                               rtol=1e-6)


@pytest.mark.parametrize("n_step, d", [(8, 2), (5, 7), (1, 3)])
def test_straight_line_init_matches_jax(n_step, d):
    rng = np.random.default_rng(n_step)
    start, end = (rng.standard_normal(d).astype(np.float32)
                  for _ in range(2))
    want = np.asarray(jinterp.straight_line_init(
        jnp.asarray(start), jnp.asarray(end), n_step))
    got = interp.straight_line_init(torch.tensor(start), torch.tensor(end),
                                    n_step)
    assert got.shape == (n_step, d)
    # start + (end - start) k / (n + 1), not torch.linspace(start, end, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    k = np.arange(1, n_step + 1)[:, None] / (n_step + 1)
    np.testing.assert_allclose(got.numpy(), start + (end - start) * k,
                               rtol=1e-5, atol=1e-6)


def test_optimise_slp_standard_normal_matches_jax():
    """tests/test_interp.py:59's case (a random init between (-2, 0) and
    (2, 0) on the standard normal), 100 iterations."""
    cfg = {"prior": "standard_gaussian", "code_size": 2}
    jlog = jinterp.prior_logpdf_fn(cfg)
    tlog = interp.prior_logpdf_fn(cfg)
    init = (2 * np.random.default_rng(0).standard_normal((6, 2))).astype(
        np.float32)
    start = np.array([-2.0, 0.0], np.float32)
    end = np.array([2.0, 0.0], np.float32)
    jpts, jhist = jinterp.optimise_slp(jnp.asarray(init), jnp.asarray(start),
                                       jnp.asarray(end), jlog, n_iter=100)
    pts, hist = interp.optimise_slp(torch.tensor(init), torch.tensor(start),
                                    torch.tensor(end), tlog, n_iter=100)
    assert set(hist) == set(jhist)
    assert all(h.shape == (100,) and h.dtype == np.float32
               for h in hist.values())
    _close_hist(hist, jhist, **TOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), **TOL)


def test_optimise_slp_two_mode_from_the_straight_line():
    """tests/test_interp.py:36's case over 100 iterations, both packages
    from the same straight-line points: equal until the segments' rounding
    noise parts them, then within the bounds of the module docstring, and
    both bend off the straight line to a better likelihood."""
    jlog, tlog = two_mode()
    start = np.array([-3.0, 0.0], np.float32)
    end = np.array([3.0, 0.0], np.float32)
    init = np.asarray(jinterp.straight_line_init(jnp.asarray(start),
                                                 jnp.asarray(end), 8))
    jpts, jhist = jinterp.optimise_slp(jnp.asarray(init), jnp.asarray(start),
                                       jnp.asarray(end), jlog, n_iter=100)
    pts, hist = interp.optimise_slp(torch.tensor(init), torch.tensor(start),
                                    torch.tensor(end), tlog, n_iter=100)
    for key in ("obj", "path_length", "neg_ll"):
        np.testing.assert_allclose(hist[key][:SAME_ITERATIONS],
                                   np.asarray(jhist[key])[:SAME_ITERATIONS],
                                   rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(hist[key], np.asarray(jhist[key]),
                                   rtol=PARTED_RTOL[key], err_msg=key)
    np.testing.assert_allclose(hist["step_var"], np.asarray(
        jhist["step_var"]), rtol=0, atol=PARTED_STEP_VAR_ATOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=PARTED_POINTS_ATOL)
    for h in (hist, jhist):
        assert float(h["neg_ll"][-1]) < float(h["neg_ll"][0])
        assert float(h["obj"][-1]) < float(h["obj"][0])
    assert float(pts[:, 1].max()) > 0.3


def test_interpolate_with_a_sample_fn_matches_jax():
    """init='random' with a sample_fn that hands both packages the same
    points: the same init, path and history."""
    cfg = {"prior": "hierarchical", "representation_size": 2}
    init = (2 * np.random.default_rng(3).standard_normal((5, 2))).astype(
        np.float32)
    start = np.array([-1.0, 0.5], np.float32)
    end = np.array([1.5, -0.5], np.float32)
    seen = []

    def jsample(rng, n):
        return jnp.asarray(init[:n])

    def tsample(generator, n):
        seen.append(generator)
        return torch.tensor(init[:n])

    jslp, jinit, jhist = jinterp.interpolate(
        cfg, jnp.asarray(start), jnp.asarray(end),
        jinterp.prior_logpdf_fn(cfg), n_step=5, n_iter=60, init="random",
        rng=jax.random.PRNGKey(0), sample_fn=jsample)
    gen = torch.Generator().manual_seed(0)
    slp, init_pts, hist = interp.interpolate(
        cfg, torch.tensor(start), torch.tensor(end),
        interp.prior_logpdf_fn(cfg), n_step=5, n_iter=60, init="random",
        generator=gen, sample_fn=tsample)
    assert seen == [gen]
    np.testing.assert_array_equal(init_pts.numpy(), np.asarray(jinit))
    _close_hist(hist, jhist, **TOL)
    np.testing.assert_allclose(slp.numpy(), np.asarray(jslp), **TOL)


def test_interpolate_inits():
    """The linear init returns the straight line's points; the random one
    without a sample_fn draws standard normals in the embedding space
    from the generator given, and needs one."""
    cfg = {"prior": "GMM", "code_size": 3}
    log_prob = interp.prior_logpdf_fn(cfg, gm=(
        np.ones(1, np.float32), np.zeros((1, 3), np.float32),
        np.eye(3, dtype=np.float32)[None]))
    start, end = torch.zeros(3), torch.ones(3)
    _, sp, hist = interp.interpolate(cfg, start, end, log_prob, n_step=4,
                                     n_iter=2)
    np.testing.assert_array_equal(
        sp.numpy(), interp.straight_line_init(start, end, 4).numpy())
    assert hist["obj"].shape == (2,)
    with pytest.raises(ValueError, match="generator"):
        interp.interpolate(cfg, start, end, log_prob, init="random")
    draws = [interp.interpolate(cfg, start, end, log_prob, n_step=4,
                                n_iter=1, init="random",
                                generator=torch.Generator().manual_seed(7))[1]
             for _ in range(2)]
    assert draws[0].shape == (4, 3)
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    np.testing.assert_array_equal(
        draws[0].numpy(),
        torch.randn((4, 3), generator=torch.Generator().manual_seed(7))
        .numpy())
