"""The joint trainer: epoch rhythm, GM refitting, evaluation,
metrics and checkpoints (the port of ``ladder_tpu/training/trainer.py``,
``JointTrainer`` and ``MNISTTrainer``).

Per epoch, as ``ladder_tpu``:
  * shuffled batches with the epoch as the shuffle seed, each through the
    train step (training/step.py: every group's update, one Adam kernel
    launch per updated group);
  * the GM hyper-prior refitted on the device: a fast fit warm-started from
    the previous one every epoch, an accurate Dirichlet-process fit on the
    accurate_fit cadence and on the last epoch (ops/gmm.py);
  * the fixed balanced test batch's diagnostics, the validation loop, the
    {exp}-result.npz, the two checkpoint groups and the full train state.
The console lines are ``ladder_tpu``'s word for word.

What differs and why, each named where it lives:
  * random numbers: one ``torch.Generator`` on the device, seeded from
    config['seed'], stands in for the JAX key chain; the streams cannot
    match. The train state stores its state under the port's own key
    ('torch_rng'); ``ladder_tpu``'s 'rng' (a threefry key) does not cross.
  * metrics stay on the device for the whole epoch and are drained with
    one copy at its end (``_to_host``): a per-step read would put a host
    synchronisation into every step.
  * MNIST lives on the device (188 MB at 60,000 images), so a step never
    waits on a host-to-device copy; CelebA's batches are copied there in
    the prefetch thread (data/celeba.py). Host batches (CelebA's test and
    GM-sample batches) are placed by ``_place``.
  * config['dtype'] = 'bfloat16' runs the conv and dense stacks in bf16
    and keeps everything the trainer touches in float32, where
    ``ladder_tpu`` keeps it: the parameters and Adam moments
    (models/builder.py:51-56 casts only activations and kernels inside the
    layers, so the gradients, the clip and skip_nonfinite's guard see
    float32 too), the encoders' heads and so the GM fit's samples
    (models/celeba.py:66-67, models/inner_vae.py:38-41), the decoder's
    output and the output stage's l1/l2 sums (ops/pallas_output.py
    accumulates in float32), and so every metric the recorders read.
  * not ported, and refused at construction rather than skipped: plots
    (config['enable_plots'] must be 0), the sklearn GM backend, a device
    mesh of more than one device. With plots off ``ladder_tpu`` generates
    no prior samples; its test_step still decodes a reconstruction of the
    test batch (output_test, trainer.py:686-690), which only the plots
    read, and the port leaves it out.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time

import numpy as np
import torch

from ladder_tpu_torch.data.mnist import device_epoch_batches
from ladder_tpu_torch.models.builder import (
    PRIORS_WITH_GM,
    PRIORS_WITH_INNER_VAE,
    PRIORS_WITH_PRIOR_MODEL,
)
from ladder_tpu_torch.ops.distributions import gmm_cholesky
from ladder_tpu_torch.ops.gmm import (
    ACTIVE_WEIGHT_THRESHOLD,
    fit_bgmm,
    fit_bgmm_restarts,
    fit_em,
    responsibilities,
)
from ladder_tpu_torch.training import schedules
from ladder_tpu_torch.training.losses import identity_gm
from ladder_tpu_torch.training.step import (
    flax_state,
    init_state,
    load_flax_state,
    make_eval_step,
    make_forward_fns,
    make_train_step,
)
from ladder_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    save_gm_prior_info,
)
from ladder_tpu_torch.utils.device import float32_exact, resolve_device
from ladder_tpu_torch.utils.metrics import BUFFER_NAMES, MetricsRecorder
from ladder_tpu_torch.utils.profiling import StepTimer, trace

RNG_KEY = "torch_rng"


def _flatten(tree, leaves):
    """Nested dicts / lists / tuples of tensors -> a rebuild function, the
    tensors appended to ``leaves``."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda host: {k: f(host) for k, f in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        return lambda host: type(tree)(f(host) for f in parts)
    index = len(leaves)
    leaves.append(tree)
    return lambda host: host[index]


def _to_host(tree):
    """The tensors of ``tree`` as numpy arrays, in the same structure,
    through one device-to-host copy per dtype (the metrics are float32:
    one copy)."""
    leaves = []
    rebuild = _flatten(tree, leaves)
    host = [None] * len(leaves)
    by_dtype = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        flat = flat.cpu().numpy()
        offset = 0
        for i in idx:
            n = leaves[i].numel()
            host[i] = flat[offset:offset + n].reshape(tuple(leaves[i].shape))
            offset += n
    return rebuild(host)


def _refuse_unported(config):
    if config.get("enable_plots", 1):
        raise NotImplementedError(
            "enable_plots: the plotting module is not ported to "
            "ladder_tpu_torch yet (ROADMAP.md); set \"enable_plots\": 0")
    if config.get("gmm_backend", "jax") == "sklearn":
        raise NotImplementedError(
            "gmm_backend='sklearn' is not ported (the port does not depend "
            "on scikit-learn); it fits the GM on the device "
            "(gmm_backend 'jax')")
    shape = config.get("mesh_shape")
    if shape and math.prod(int(n) for n in shape) > 1:
        raise NotImplementedError(
            f"mesh_shape={list(shape)}: the port trains on one device; "
            "data and tensor parallelism are not ported yet (ROADMAP.md)")


class JointTrainer:
    """Dataset-agnostic core; subclasses provide the batch sources
    ([B,H,W,C] tensors on the device, or host arrays that ``_place`` moves
    there)."""

    def __init__(self, model, data, config, device="cuda"):
        _refuse_unported(config)
        self.model = model
        self.data = data
        self.config = config
        self.prior = config["prior"]
        self.device = resolve_device(device)
        # one generator for every draw of the run (see the module docstring)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("seed", 0)))
        self.state = init_state(model, device=self.device)
        self.ckpt = CheckpointManager(config)
        self.metrics = MetricsRecorder()

        self.train_step = make_train_step(model)
        self.eval_step = make_eval_step(model)
        self.fwd = make_forward_fns(model)
        # config['steps_per_call'] is accepted and changes nothing: in
        # ladder_tpu it fuses K steps under lax.scan, and the port has no
        # such fusion (its make_train_multi_step is a loop over the single
        # step), so every batch is one train_step call with the same updates

        self.cur_epoch = 0
        self.gm_fast = None       # (weights, means, covs) of the fast fit
        self.gm_final = None      # accurate fit
        self._timer_summary = None
        # per epoch: the step timer's summary, each GM fit's seconds and
        # iterations, the validation loop's seconds
        self.timings = []

        self.num_para_list = model.count_params()
        print("Total number of trainable parameters in VAE network is:\n"
              "{}k\n".format(np.around(sum(self.num_para_list) / 1000, 2)))

    # ---- subclass hooks ----------------------------------------------
    def train_batches(self):
        raise NotImplementedError

    def val_batches(self):
        raise NotImplementedError

    def sample_batches(self, n_samples):
        raise NotImplementedError

    def test_batch(self):
        raise NotImplementedError

    def n_train_iter(self):
        raise NotImplementedError

    def n_val_iter(self):
        raise NotImplementedError

    def current_lr_ae(self):
        return schedules.lr_ae(self.config, self.cur_epoch)

    def mid_epoch_hook(self, idx_iter, span=1):
        """After each train step (``ladder_tpu``'s trainer.py:461, called at
        :329/:339/:349; the port runs one step per batch, so span is 1).
        ``ladder_tpu``'s CelebA trainer plots reconstructions here at
        idx_check_point; with plots off, the only mode the port trains in,
        it returns at once, as ``ladder_tpu``'s does."""

    def epoch_tail_plots(self):
        """Dataset-specific plots after validation (trainer.py:467); the
        port plots nothing."""

    # ---- epoch-state helpers -----------------------------------------
    def _place(self, batch):
        """A batch on the trainer's device: a tensor already there passes
        through, a host array is copied (``ladder_tpu``'s _place,
        trainer.py:141, without a mesh)."""
        if not torch.is_tensor(batch):
            batch = torch.as_tensor(np.asarray(batch))
        return batch.to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gm_for_step(self):
        """The GM fed to the train step, on the device."""
        cfg = self.config
        if self.prior == "ours":
            if self.cur_epoch <= cfg["sg_pretraining"] or self.gm_fast is None:
                return identity_gm(cfg["n_mixtures"],
                                   cfg["representation_size"],
                                   device=self.device)
            w, m, K = self.gm_fast
            return dict(weights=w, means=m, chols=gmm_cholesky(K))
        if self.prior == "GMM":
            if self.cur_epoch == 1 or self.gm_fast is None:
                return identity_gm(cfg["n_mixtures"], cfg["code_size"],
                                   device=self.device)
            w, m, K = self.gm_fast
            # +0.01*I jitter on the fitted covariances (base.py:925-933)
            return dict(weights=w, means=m, chols=gmm_cholesky(K, jitter=0.01))
        return None

    def _flags(self):
        cfg = self.config
        if self.prior == "ours":
            use_sg = self.cur_epoch <= cfg["sg_pretraining"]
            use_mask = self.cur_epoch >= cfg["use_mask_start"]
        elif self.prior in ("hierarchical", "vampPrior"):
            use_sg = self.cur_epoch <= cfg["sg_pretraining"]
            use_mask = False
        else:
            use_sg = use_mask = False
        return {"use_sg_prior": use_sg, "use_mask": use_mask}

    def _do_prior(self):
        cfg = self.config
        return (self.cur_epoch > cfg["sg_pretraining"] - 1
                and self.prior in PRIORS_WITH_PRIOR_MODEL
                and cfg["TRAIN_prior"] == 1)

    def _lrs(self):
        lrs = schedules.all_lrs(self.config, self.cur_epoch)
        lrs["ae"] = self.current_lr_ae()
        return lrs

    # ---- training ----------------------------------------------------
    def train(self):
        """Run the remaining epochs: after a full-state restore cur_epoch
        is the last completed epoch, so a resume trains num_epochs -
        cur_epoch more. On SIGTERM the current epoch finishes and is saved,
        then train() returns; a second SIGTERM aborts."""
        self.start_time = time.time()
        self._session_start_epoch = self.cur_epoch
        self._stop_requested = False

        def _request_stop(signum, frame):
            if self._stop_requested:
                raise KeyboardInterrupt("second preemption signal")
            self._stop_requested = True
            print("\nPreemption signal: finishing the current epoch, "
                  "saving, then exiting cleanly (signal again to abort).")

        old_handler = None
        try:  # signal.signal only works in the main thread
            old_handler = signal.signal(signal.SIGTERM, _request_stop)
        except ValueError:
            pass
        try:
            for _ in range(max(0,
                               self.config["num_epochs"] - self.cur_epoch)):
                self.train_epoch()
                params = self.model.flax_params()
                if self.prior in PRIORS_WITH_PRIOR_MODEL:
                    self.ckpt.save(params, model="joint")
                else:
                    self.ckpt.save(params, model="VAE")
                self.save_full_state()
                self.compute_execution_time(self.cur_epoch - 1,
                                            self.config["num_epochs"])
                if self._stop_requested:
                    print(f"Preemption save complete at epoch "
                          f"{self.cur_epoch}/{self.config['num_epochs']}; "
                          f"rerun the same command to resume.")
                    break
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            self.ckpt.flush()

    def _run_steps(self, timer, gm, flags, lrs, do_prior, sg_ov, sync_each):
        """The epoch's train steps; returns each step's metrics, still on
        the device."""
        outs = []
        for batch in self.train_batches():
            timer.start()
            self.state, out = self.train_step(
                self.state, self._place(batch), self.generator, gm, flags,
                lrs, do_prior, sg_overlap=sg_ov)
            timer.stop(sync_on=out if sync_each else None)
            outs.append(out)
            self.mid_epoch_hook(len(outs) - 1)
        return outs

    def train_epoch(self):
        cfg = self.config
        self.cur_epoch += 1
        print("{}/{}:".format(self.cur_epoch, cfg["num_epochs"]))
        record = {"epoch": self.cur_epoch, "gm": []}
        self.timings.append(record)

        gm = self._gm_for_step()
        flags = self._flags()
        lrs = self._lrs()
        do_prior = self._do_prior()
        timer = StepTimer(batch_size=cfg["batch_size"])
        profile_dir = cfg.get("profile_dir") if self.cur_epoch == 1 else None
        # sync_each_step=1 times every step on the device's clock
        sync_each = bool(cfg.get("sync_each_step", 0))
        sg_ov = do_prior and self.cur_epoch <= cfg["sg_pretraining"]
        timer.wall_start()
        with trace(profile_dir):
            outs = self._run_steps(timer, gm, flags, lrs, do_prior, sg_ov,
                                   sync_each)
            self._sync()
        timer.wall_stop()
        self._timer_summary = record["train"] = timer.report(
            prefix=f"epoch {self.cur_epoch}: ")

        train_loss_cur_epoch = 0.0
        n_iter = len(outs)
        for step_out in _to_host(outs):
            if cfg["TRAIN_VAE"] == 1 and "ae" in step_out:
                self.metrics.record_ae_step(step_out["ae"])
                train_loss_cur_epoch += float(step_out["ae"]["loss_ae"])
            if cfg["TRAIN_sigma"] == 1 and "sigma" in step_out:
                self.metrics.record_sigma_step(step_out["sigma"])
            if do_prior and "prior" in step_out:
                self.metrics.record_prior_step(step_out["prior"], self.prior)
        if cfg["TRAIN_VAE"] == 1 and n_iter:
            self.metrics.train_loss_ave_epoch.append(
                train_loss_cur_epoch / n_iter)
            self.metrics.iter_epochs_list.append(
                len(self.metrics.train_loss) - 1)

        # fit a GM in representation or code space (trainers.py:47-48)
        if (self.cur_epoch > cfg["sg_pretraining"] - 1
                and self.prior in PRIORS_WITH_GM):
            self.fit_GM()

        self.test_step(self.test_batch(), print_result=True)

        t0 = time.perf_counter()
        val_loss_cur_epoch = 0.0
        n_val = 0
        gm = self._gm_for_step()
        run_vae_val = self.val_vae_enabled()
        run_prior_val = (self.cur_epoch > cfg["sg_pretraining"] - 1
                         and self.prior in PRIORS_WITH_PRIOR_MODEL
                         and self.val_prior_enabled())
        val_outs = [self.eval_step(self._place(batch), self.generator, gm,
                                   flags)
                    for batch in self.val_batches()]
        for m in _to_host(val_outs):
            if run_vae_val:
                val_loss_cur_epoch += self.metrics.record_val_step(
                    m, "VAE", self.prior)
                n_val += 1
            if run_prior_val:
                self.metrics.record_val_step(m, "prior", self.prior)
        record["val_s"] = time.perf_counter() - t0
        self.append_val_average(val_loss_cur_epoch, n_val)
        if cfg["TRAIN_VAE"] == 1 and self.metrics.train_loss_ave_epoch:
            print("Average overall negative ELBO loss:\ntrain: {:.4f}, "
                  "val: {:.4f}".format(
                      self.metrics.train_loss_ave_epoch[-1],
                      self.metrics.val_loss_ave_epoch[-1]
                      if self.metrics.val_loss_ave_epoch else float("nan")))
        self.epoch_tail_plots()

        self.metrics.save(cfg, self.num_para_list, self.n_train_iter(),
                          self.n_val_iter())
        self._write_scalar_summary()

    def val_vae_enabled(self):
        """MNIST runs the VAE val step unconditionally (trainers.py:62);
        CelebA gates it on TRAIN_VAE (trainers.py:180)."""
        return True

    def val_prior_enabled(self):
        """Extra per-dataset gate on the prior val record: none for MNIST
        (trainers.py:63-64); CelebA adds TRAIN_prior==1 (trainers.py:183)."""
        return True

    def append_val_average(self, val_loss_sum, n_val):
        """MNIST appends sum/n_val of the recorded VAE val losses
        (trainers.py:66), guarded for an empty val set."""
        if n_val:
            self.metrics.val_loss_ave_epoch.append(val_loss_sum / n_val)

    # ---- GM fitting (base.py:681-789, 988-1010) ----------------------
    def _collect_samples(self, n_target, space):
        """Encode ~n_target train samples into t or z space on the
        device."""
        fn = self.fwd["representation_sample" if space == "t"
                      else "encode_sample"]
        samples = torch.cat([fn(self._place(batch), self.generator)
                             for batch in self.sample_batches(n_target)])
        # the fit runs in float32 and so do the heads, bf16 mode included
        # (see the module docstring): a sample of another type is a
        # departure from ladder_tpu's policy, not something to cast away
        if samples.dtype != torch.float32:
            raise TypeError(f"GM samples are {samples.dtype}, not float32")
        return samples

    def _report_active(self, w):
        idx = np.where(w >= ACTIVE_WEIGHT_THRESHOLD)[0]
        if len(idx) == 0:
            print("There are 0 active mixtures.")
        else:
            print("There are {} active mixtures.".format(len(idx)))
            print("The current GM prior estimate has following weights:\n{}"
                  .format(w[idx]))

    def fit_GMM_VI(self, mode="fast", space="z"):
        """Fast fit warm-started from the previous one every epoch; fresh
        accurate DP fit on the cadence. Returns the samples used."""
        cfg = self.config
        bs = cfg["batch_size"]
        # whole batches (trainer.py:501-502)
        n_target = ((2000 if mode == "fast" else 20000) // bs + 1) * bs
        samples = self._collect_samples(n_target, space)
        t0 = time.perf_counter()
        with float32_exact():
            if mode == "fast":
                if self.prior == "ours":
                    # warm start: the new samples' responsibilities under
                    # the previous fast fit, with 1e-6 jitter
                    # (trainer.py:576-584)
                    init_resp = (responsibilities(samples, *self.gm_fast,
                                                  jitter=1e-6)
                                 if self.gm_fast is not None else None)
                    fit, _ = fit_bgmm(
                        self.generator, samples, cfg["n_mixtures"],
                        max_iter=1000, weight_concentration_prior=0.1,
                        dirichlet_process=False, init_resp=init_resp)
                else:  # the GMM prior fits max-likelihood EM in z space
                    kw = {}
                    if self.gm_fast is not None:
                        w, m, K = self.gm_fast
                        kw = dict(init_weights=w, init_means=m, init_covs=K)
                    fit = fit_em(self.generator, samples, cfg["n_mixtures"],
                                 max_iter=1000, **kw)
                self.gm_fast = (fit.weights, fit.means, fit.covariances)
            else:
                if self.prior == "ours":
                    fit, _ = fit_bgmm_restarts(
                        self.generator, samples, cfg["n_mixtures"],
                        n_init=cfg["GM_fit_restart"], max_iter=2000,
                        weight_concentration_prior=0.1,
                        dirichlet_process=True)
                else:
                    fit = fit_em(self.generator, samples, cfg["n_mixtures"],
                                 max_iter=2000)
                self.gm_final = (fit.weights, fit.means, fit.covariances)
        self._sync()
        self.timings[-1]["gm"].append(dict(
            mode=mode, samples=int(samples.shape[0]), n_iter=fit.n_iter,
            converged=fit.converged, seconds=time.perf_counter() - t0))
        which = self.gm_fast if mode == "fast" else self.gm_final
        which_host = _to_host(which)
        if mode == "accurate":
            # the reference's order: npz save -> active report -> final print
            save_gm_prior_info(cfg["result_dir"], *which_host)
        self._report_active(which_host[0])
        if mode == "accurate":
            print("Final fitted prior saved.")
        # the fitted GM per fit, for post-hoc analysis (not in the npz)
        self.metrics.gmm_weight.append(which_host[0])
        self.metrics.gmm_mean.append(which_host[1])
        self.metrics.gmm_cov.append(which_host[2])
        return samples

    def fit_GM(self):
        cfg = self.config
        if self.prior == "ours":
            self.fit_GMM_VI(mode="fast", space="t")
            if (self.cur_epoch % cfg["accurate_fit"] == 0
                    or self.cur_epoch == cfg["num_epochs"]):
                self.fit_GMM_VI(mode="accurate", space="t")
        elif self.prior == "GMM":
            if self.cur_epoch < cfg["num_epochs"]:
                self.fit_GMM_VI(mode="fast", space="z")
            else:
                self.fit_GMM_VI(mode="accurate", space="z")

    # ---- test / diagnostics (base.py:944-986) ------------------------
    def test_step(self, batch, print_result=False):
        m = _to_host(self.eval_step(self._place(batch), self.generator,
                                    self._gm_for_step(), self._flags()))
        if print_result:
            print("test loss: elbo: {:.4f}, recons_loss_l1: {:.4f}, "
                  "entropy z: {:.4f}, cross entropy z: {:.4f}, "
                  "sigma_regularisor: {:.4f}".format(
                      float(m["elbo"]), float(m["l1_reconstruction_error"]),
                      float(m["entropy_z"]), float(m["crossEntropy_prior"]),
                      float(m["sigma_regularisor"])))
        sigma_mean = float(np.mean(m["sigma"]))
        self.metrics.test_sigma.append(sigma_mean)
        print("current sigma: mean: {:.7f}; pixel mean error: {:.7f}".format(
            sigma_mean, float(m["mean_pixel_error"])))
        if self.prior in PRIORS_WITH_INNER_VAE and print_result:
            print("current z std: {}".format(m["std_dev_code"]))
            print("current t std: {}".format(m["std_dev_representation"]))
            print("current inner VAE sigma: {}".format(m["inner_sigma"]))
            print("current code prediction error per channel: {}".format(
                m["mean_code_error"]))
        elif print_result:
            print("current z std: {}".format(m["std_dev_code"]))
        return m

    # ---- bookkeeping --------------------------------------------------
    def _write_scalar_summary(self):
        """One JSON line of epoch scalars in summary_dir/scalars.jsonl."""
        sdir = self.config.get("summary_dir")
        if not sdir:
            return
        os.makedirs(sdir, exist_ok=True)
        rec = self.metrics
        row = dict(
            epoch=self.cur_epoch,
            lr_ae=float(self.current_lr_ae()),
            train_loss=(rec.train_loss_ave_epoch[-1]
                        if rec.train_loss_ave_epoch else None),
            val_loss=(rec.val_loss_ave_epoch[-1]
                      if rec.val_loss_ave_epoch else None),
            sigma=rec.test_sigma[-1] if rec.test_sigma else None,
            inner_sigma=(rec.code_inner_sigma_train[-1]
                         if rec.code_inner_sigma_train else None),
        )
        row.update({f"timing_{k}": v
                    for k, v in (self._timer_summary or {}).items()})
        with open(os.path.join(sdir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def compute_execution_time(self, cur_epoch, total_epoch):
        current = time.time()
        elapsed = (current - self.start_time) / 60
        print("Already trained for {} min.".format(elapsed))
        # the rate of this session's epochs only (a resume restarts the
        # clock, not the epoch count)
        done = max(cur_epoch + 1 - getattr(self, "_session_start_epoch", 0),
                   1)
        remaining_epochs = max(total_epoch - (cur_epoch + 1), 0)
        est = (current - self.start_time) / done * remaining_epochs
        print("Remaining {} min.\n".format(est / 60))

    def save_full_state(self):
        """'train-state': params, moments and counters in
        training/step.py:flax_state's layout (each package loads the
        other's), plus the epoch, the fitted GMs, the metric buffers and the
        generator's state under the port's own key."""
        extra = dict(
            cur_epoch=np.asarray(self.cur_epoch),
            metrics={name: np.asarray(getattr(self.metrics, name))
                     for name in BUFFER_NAMES
                     if len(getattr(self.metrics, name))},
        )
        extra[RNG_KEY] = self.generator.get_state().numpy()
        for name, gm in (("gm_fast", self.gm_fast),
                         ("gm_final", self.gm_final)):
            if gm is not None:
                w, m, K = _to_host(gm)
                extra.update({f"{name}_w": w, f"{name}_m": m,
                              f"{name}_K": K})
        self.ckpt.save_full(flax_state(self.state), extra)

    def _restore_generator(self, saved):
        mine = self.generator.get_state()
        saved = torch.from_numpy(np.array(saved, dtype=np.uint8))
        if saved.shape != mine.shape:
            print("The saved random state belongs to a generator of another "
                  "device; keeping the seeded one.")
            return
        self.generator.set_state(saved)

    def restore(self):
        """The reference's startup restore of the two groups, or a
        full-state resume when 'train-state' exists."""
        full = self.ckpt.load_full()
        if full is not None:
            state, extra = full
            load_flax_state(self.state, state)
            self.cur_epoch = int(extra.get("cur_epoch", 0))
            if RNG_KEY in extra:
                self._restore_generator(extra[RNG_KEY])
            for name in ("gm_fast", "gm_final"):
                if f"{name}_w" in extra:
                    setattr(self, name, tuple(
                        torch.tensor(extra[f"{name}_{p}"], device=self.device)
                        for p in "wmK"))
            for name, arr in (extra.get("metrics") or {}).items():
                arr = np.asarray(arr)
                setattr(self.metrics, name,
                        arr.tolist() if arr.ndim <= 1 else list(arr))
            print("Full train state restored (epoch {}).".format(
                self.cur_epoch))
            return
        params = self.ckpt.load(self.model.flax_params(), model="VAE")
        if self.prior in PRIORS_WITH_PRIOR_MODEL:
            params = self.ckpt.load(params, model="prior")
        self.model.load_flax_params(params)


class MNISTTrainer(JointTrainer):
    """trainers.py:12-127 (MNISTTrainer_joint_training). The images are
    copied to the device once; every batch is a gather there."""

    def __init__(self, model, data, config, device="cuda"):
        super().__init__(model, data, config, device)
        self._images = {
            name: torch.as_tensor(getattr(data, name)["image"]).to(self.device)
            for name in ("train_set", "val_set", "test_set")}

    def _batches(self, name, seed, n_batches=None):
        return device_epoch_batches(self._images[name],
                                    self.config["batch_size"], seed,
                                    n_batches)

    def train_batches(self):
        return self._batches("train_set", self.cur_epoch)

    def val_batches(self):
        return self._batches("val_set", self.cur_epoch)

    def sample_batches(self, n_samples):
        return self._batches("train_set", self.cur_epoch * 7919 + 1,
                             n_samples // self.config["batch_size"])

    def test_batch(self):
        return self._images["test_set"]

    def n_train_iter(self):
        return self.data.n_train // self.config["batch_size"]

    def n_val_iter(self):
        return self.data.n_val // self.config["batch_size"]
