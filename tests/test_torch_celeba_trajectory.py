"""The port's CelebA trainer (ladder_tpu_torch/training/celeba_trainer.py)
against ladder_tpu's over whole epochs, in modes 1 and 2, on the tiny
config of tests/test_torch_celeba_trainer.py (h=16, code 16, batch 8, 32 /
16 / 8 images) for three epochs with sg_pretraining 1 and accurate_fit 2.
So the run crosses the sg switch (epoch 1 trains beside the standard
Gaussian, epochs 2-3 against the fitted mixture), a fast fit that the next
epoch's step takes (epoch 1's fit from the k-means start, then the warm
starts of epochs 2 and 3) and the accurate fits of epochs 2 and 3, with the
sigma and lr schedules and the validation loop of each epoch.

Both trainers start from the same weights (``make_model(cfg,
seed).flax_params()``, as tests/test_torch_celeba_trainer.py's fixture) and read the same TFRecords;
their batch order is the same by construction (a numpy permutation keyed on
the epoch in both packages).

Noise. The two random streams can never match, so both draw from one table
keyed by the draw's shape (``fixed_normal``): ladder_tpu's
``sample_diag_gaussian`` (the losses' and the forward functions') and the
port's ``randn_rows`` (the losses' and the forward functions') return
mean + std * the table's draw. ladder_tpu's step, sampler and evaluation
are jitted, so a draw becomes a constant of the compiled function; keyed
by shape, the port takes the same constant at every call. The first fast
fit and every accurate fit start from k-means, random in both packages:
both start from one fixed assignment (``fixed_resp``) instead.

Compared, with the tolerances below: each step's train loss and sigma;
each epoch's GM samples, fast fit (weights, means, covariances),
validation average, accurate fit; the final celeba-result.npz and
GM_prior_info.npz.

Tolerances. Float32 in both packages, the same ops in other summation
orders, and Adam turns a gradient of rounding size into a step of lr of
either sign (tests/test_torch_train_step.py). So the packages drift apart
step by step, and a value after n updates is held to a tolerance that grows
with n: the step's and the validation's scalars to rtol 1e-3 * n (measured:
at most 2.6e-3 after 7 updates, 1.7e-3 after 11); the t samples, the fits
made of them and the result files to 5e-3 * n, each array also to an atol
of that times its largest element (the inner encoder moves t by up to 2.8%
of its scale after 12 updates, a warm start's responsibilities by 3.8%, and
the ELBO's terms partly cancel, so a term's error is its scale's).

Where a fit stops is float32 rounding in both packages
(tests/test_torch_fast_fit_chain.py). Where the two packages stop on
different iterations, both are run again on ladder_tpu's samples and start
for the smaller count, compared there, and ladder_tpu's fit is carried
into the port for the next epoch, so that one rounding-decided stop does
not end the comparison.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladder_tpu.ops.distributions as jdist
import ladder_tpu.ops.gmm as jgmm
import ladder_tpu.training.losses as jlosses
import ladder_tpu.training.trainer as jtrainer_mod
from ladder_tpu.data.celeba import CelebAData as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.celeba_trainer import CelebATrainer as JTrainer
from ladder_tpu_torch.data.celeba import CelebAData, ensure_synthetic_tfrecords
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.ops import gmm as tgmm
from ladder_tpu_torch.training import losses as tlosses
from ladder_tpu_torch.training import step as tstep
from ladder_tpu_torch.training import trainer as ttrainer_mod
from ladder_tpu_torch.training.celeba_trainer import CelebATrainer
from tests.test_torch_celeba_trainer import _config, _dirs
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

EPOCHS = 3
SEED = 4                      # the weights, as tests/test_torch_celeba_trainer
NOISE_SEED = 11
SCALAR_RTOL = 1e-3            # per update: the step's and validation's scalars
ARRAY_RTOL = 5e-3             # per update: t samples, fits, result files


def fixed_normal(shape):
    """The table's standard-normal draw for a draw of this shape."""
    rng = np.random.default_rng([NOISE_SEED, *shape])
    return rng.standard_normal(shape).astype(np.float32)


def fixed_resp(n, k):
    """One-hot responsibilities of a fixed, balanced assignment: the start
    of every fit that k-means starts in both packages."""
    labels = np.random.default_rng([NOISE_SEED, n, k]).permutation(
        np.arange(n) % k)
    return np.eye(k, dtype=np.float32)[labels]


def _jax_draw(rng, mean, std):
    return mean + std * jnp.asarray(fixed_normal(tuple(mean.shape)))


def _torch_draw(generator, shape, mesh=None, axis=0, device=None):
    assert mesh is None
    return torch.from_numpy(fixed_normal(tuple(shape))).to(device)


class FitLog:
    """Wraps a package's fit_bgmm / fit_bgmm_restarts as its trainer calls
    them and keeps (kind, samples, init_resp, fit) of every call."""

    def __init__(self, mp, module, host):
        self.calls, self.host = [], host
        for name in ("fit_bgmm", "fit_bgmm_restarts"):
            mp.setattr(module, name, self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        def wrapped(rng, x, k, **kw):
            fit, resp = fn(rng, x, k, **kw)
            init = kw.get("init_resp")
            self.calls.append(dict(
                kind="accurate" if name == "fit_bgmm_restarts" else "fast",
                samples=self.host(x),
                init_resp=None if init is None else self.host(init),
                fit=[self.host(a) for a in fit[:3]],
                n_iter=int(fit.n_iter)))
            return fit, resp
        return wrapped


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The TFRecords, the weights, the patched noise and k-means starts, and
    ladder_tpu's mode-independent compiled functions, for both cases."""
    data_root = tmp_path_factory.mktemp("data")
    cfg = _config(data_root, num_epochs=EPOCHS)
    ensure_synthetic_tfrecords(cfg["data_path"], cfg["synthetic_n_train"],
                               cfg["synthetic_n_val"],
                               cfg["synthetic_n_test"], cfg["seed"])
    params = make_model(cfg, seed=SEED).flax_params()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "sample_diag_gaussian", _jax_draw)
        mp.setattr(jdist, "sample_diag_gaussian", _jax_draw)
        mp.setattr(tlosses, "randn_rows", _torch_draw)
        mp.setattr(tstep, "randn_rows", _torch_draw)
        mp.setattr(jgmm, "_resp_from_kmeans", lambda rng, x, k: jnp.asarray(
            fixed_resp(x.shape[0], k)))
        mp.setattr(tgmm, "_resp_from_kmeans", lambda gen, x, k: torch.tensor(
            fixed_resp(x.shape[0], k), device=x.device))
        # fit_bgmm is jitted at module level: no trace made before the patch
        # may serve this module, and none made here may serve another
        jax.clear_caches()
        yield dict(data_root=data_root, params=params, jit={})
    jax.clear_caches()


def _trainers(shared, tmp_path, mode):
    cfg = _config(shared["data_root"], num_epochs=EPOCHS,
                  fused_train_step=mode)
    jcfg = _dirs(dict(cfg), tmp_path / "jax")
    jmodel = jmake(jcfg)
    params = jax.tree.map(jnp.asarray, shared["params"])
    jmodel.init = lambda rng: params
    jt = JTrainer(jmodel, JData(jcfg), jcfg)
    # the evaluation and sampling functions do not depend on the mode:
    # compiled once for both cases
    for name in ("eval_step", "fwd"):
        setattr(jt, name, shared["jit"].setdefault(name, getattr(jt, name)))
    tcfg = _dirs(dict(cfg), tmp_path / "port")
    tt = CelebATrainer(make_model(tcfg, seed=SEED), CelebAData(tcfg), tcfg,
                       device="cpu")
    return jt, tt


def _close(name, got, want, n_updates):
    """A scalar of the step or the validation after n_updates updates."""
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL * max(n_updates, 1),
                               err_msg=name)


def _close_array(name, got, want, n_updates):
    """An array made from t samples after n_updates updates, also to an
    atol of its tolerance times want's largest element."""
    want = np.asarray(want)
    tol = ARRAY_RTOL * max(n_updates, 1)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * float(np.max(np.abs(want),
                                                      initial=0.0)),
        err_msg=name)


def _compare_fit(label, jcall, tcall, n_updates, jt_fit_fn, tt_fit_fn):
    """Two fits of one epoch: the samples, the start, then the fit where
    both stopped on the same iteration; else both rerun for the smaller
    count on ladder_tpu's samples and start. Returns True when the stops
    differed."""
    _close_array(f"{label} samples", tcall["samples"], jcall["samples"],
                 n_updates)
    if jcall["init_resp"] is not None:
        _close_array(f"{label} warm start", tcall["init_resp"],
                     jcall["init_resp"], n_updates)
    got, want = tcall["fit"], jcall["fit"]
    moved = tcall["n_iter"] != jcall["n_iter"]
    if moved:
        n = min(tcall["n_iter"], jcall["n_iter"])
        want = jt_fit_fn(jcall, n)
        got = tt_fit_fn(jcall, n)
    for part, g, w in zip(("weights", "means", "covariances"), got, want):
        _close_array(f"{label} {part}", g, w, n_updates)
    return moved


def _fixed_count_fits(k, kind):
    """Each package's fit of ladder_tpu's samples and start, run for
    exactly n iterations (tol -1 never stops a fit early)."""
    dp = kind == "accurate"

    def jax_fit(call, n):
        x = jnp.asarray(call["samples"])
        init = (jnp.asarray(fixed_resp(x.shape[0], k)) if call["init_resp"]
                is None else jnp.asarray(call["init_resp"]))
        fit, _ = jgmm.fit_bgmm(jax.random.PRNGKey(0), x, k, max_iter=n,
                               tol=-1.0, weight_concentration_prior=0.1,
                               dirichlet_process=dp, init_resp=init)
        return [np.asarray(a) for a in fit[:3]]

    def port_fit(call, n):
        x = torch.tensor(call["samples"])
        init = torch.tensor(fixed_resp(x.shape[0], k) if call["init_resp"]
                            is None else call["init_resp"])
        fit, _ = tgmm.fit_bgmm(None, x, k, max_iter=n, tol=-1.0,
                               weight_concentration_prior=0.1,
                               dirichlet_process=dp, init_resp=init)
        return [_np(a) for a in fit[:3]]

    return jax_fit, port_fit


@pytest.mark.parametrize("mode", [1, 2])
def test_trainers_agree_over_epochs(shared, tmp_path, monkeypatch, mode):
    jlog = FitLog(monkeypatch, jtrainer_mod, np.asarray)
    tlog = FitLog(monkeypatch, ttrainer_mod, _np)
    jt, tt = _trainers(shared, tmp_path, mode)
    k = jt.config["n_mixtures"]
    steps = jt.n_train_iter()
    assert steps == tt.n_train_iter() == 4
    jm, tm = jt.metrics, tt.metrics
    carried = []
    for epoch in range(1, EPOCHS + 1):
        n_before = len(jlog.calls)
        jt.train_epoch()
        tt.train_epoch()
        assert jt.cur_epoch == tt.cur_epoch == epoch
        # each step's loss and sigma, each after as many updates as steps
        lo = (epoch - 1) * steps
        for i in range(lo, epoch * steps):
            _close(f"epoch {epoch} step {i} loss", tm.train_loss[i],
                   jm.train_loss[i], i)
            _close(f"epoch {epoch} step {i} sigma", tm.sigma_train[i],
                   jm.sigma_train[i], i + 1)
        n = epoch * steps
        # the epoch's fits: a fast one, then an accurate one on the cadence
        kinds = [c["kind"] for c in jlog.calls[n_before:]]
        want_kinds = ["fast"] + (["accurate"] if epoch >= 2 else [])
        assert kinds == want_kinds
        assert [c["kind"] for c in tlog.calls[n_before:]] == want_kinds
        for jcall, tcall in zip(jlog.calls[n_before:], tlog.calls[n_before:]):
            fits = _fixed_count_fits(k, jcall["kind"])
            if _compare_fit(f"epoch {epoch} {jcall['kind']} fit", jcall,
                            tcall, n, *fits):
                carried.append((epoch, jcall["kind"]))
                # carry ladder_tpu's fit into the port for the next epoch
                w, m, cov = (torch.tensor(a) for a in jcall["fit"])
                if jcall["kind"] == "fast":
                    tt.gm_fast = (w, m, cov)
                else:
                    tt.gm_final = (w, m, cov)
        # the fast fit the next epoch's step takes
        for part, g, w in zip(("weights", "means", "covariances"),
                              tt.gm_fast, jt.gm_fast):
            _close_array(f"epoch {epoch} gm_fast {part}", _np(g), w, n)
        _close(f"epoch {epoch} validation average", tm.val_loss_ave_epoch,
               jm.val_loss_ave_epoch, n)
    print(f"mode {mode}: fits carried across packages: {carried}")

    # the final result files, key by key
    assert sorted(os.listdir(jt.config["result_dir"])) == sorted(
        os.listdir(tt.config["result_dir"])) == [
        "GM_prior_info.npz", "celeba-result.npz"]
    n = EPOCHS * steps
    # GM_prior_info.npz holds each package's last accurate fit: compared
    # above at one iteration count where the two stopped apart
    names = ["celeba-result.npz"] + (
        [] if (EPOCHS, "accurate") in carried else ["GM_prior_info.npz"])
    for name in names:
        want = np.load(os.path.join(jt.config["result_dir"], name))
        got = np.load(os.path.join(tt.config["result_dir"], name))
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            _close_array(f"{name} {key}", got[key], want[key], n)
