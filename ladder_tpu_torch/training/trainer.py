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
  * plots (config['enable_plots'], on by default as in ``ladder_tpu``):
    the ground-truth test grid, the GM scatter and density plots of each
    fit in a 2-D space, the prior samples of every epoch, the
    reconstructions and the loss curves, under ``ladder_tpu``'s PDF
    names (utils/plotting.py). They need matplotlib, which the card's
    machine does not have: with plots on and no matplotlib the trainer
    raises an ImportError at construction, before any step. Prior
    sampling is split as in ``ladder_tpu``: ``prior_samples`` decodes on
    the device and returns host images, ``generate_samples_from_prior``
    plots them. With plots off, test_step decodes no reconstruction of
    the test batch (``ladder_tpu``'s output_test, trainer.py:686-690, which
    only the plots read), so the device runs what it did before plots.
  * data parallelism (``mesh``, a parallel/mesh.py DataMesh, from
    ``LADDER_DISTRIBUTED=1 torchrun ... -m ladder_tpu_torch.train``): each
    rank trains on its rows of every global batch (the sources yield only
    those rows; the test batch is sliced by ``_place_rows``), and the
    step, the evaluation and the GM samples reduce or gather across the
    ranks (training/step.py), so the curves are one process's. The lead
    (rank 0) writes every file; every rank enters every collective. The
    forwards whose output only the lead writes (the plots' decodes, the
    prior samples) run whole on every rank with the sharding off
    (``DataMesh.whole_batch``): the same draws, no collective. The GM is
    fitted on every rank on the gathered samples, then rank 0's fit is
    broadcast; an init or a restore is broadcast from rank 0; a
    preemption signal on any rank stops all of them after the epoch.
  * the (data, model) mesh (``mesh`` a parallel/mesh.py Mesh2D, from
    mesh_shape [n_data, n_model] under LADDER_DISTRIBUTED=1): every rank
    still trains on its own rows, as above, and the parameters and Adam
    moments are held as this rank's shards between steps
    (parallel/tp.py). An init or a restore is broadcast whole from rank 0
    and then sharded; the step gathers what it needs; the forwards after
    the step loop (GM samples, prior samples, test and validation) run
    with the full parameters gathered, freed at the epoch's end; the
    checkpoints gather the whole state on every rank and the lead writes
    ``ladder_tpu``'s bytes. Each epoch's record holds the state's bytes
    at rest and, on a card, the memory allocated between steps.
  * not ported, and refused at construction rather than skipped: the
    sklearn GM backend.
"""

from __future__ import annotations

import contextlib
import json
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
from ladder_tpu_torch.models.layers import set_batchnorm_mesh
from ladder_tpu_torch.ops.distributions import gmm_cholesky, sample_gmm
from ladder_tpu_torch.ops.gmm import (
    ACTIVE_WEIGHT_THRESHOLD,
    fit_bgmm,
    fit_bgmm_restarts,
    fit_em,
    responsibilities,
)
from ladder_tpu_torch.parallel.mesh import (
    check_mesh_shape,
    copy_stats,
    shard_batch,
    shard_state,
    stats_delta,
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
    whole_state,
)
from ladder_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    save_gm_prior_info,
)
from ladder_tpu_torch.utils.device import float32_exact, resolve_device
from ladder_tpu_torch.utils.metrics import BUFFER_NAMES, MetricsRecorder
from ladder_tpu_torch.utils import plotting
from ladder_tpu_torch.utils.profiling import StepTimer, span, trace

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


def _refuse_unported(config, mesh):
    if config.get("gmm_backend", "jax") == "sklearn":
        raise NotImplementedError(
            "gmm_backend='sklearn' is not ported (the port does not depend "
            "on scikit-learn); it fits the GM on the device "
            "(gmm_backend 'jax')")
    # one process trains on its one device whatever the mesh says, as
    # ladder_tpu's train.py does
    check_mesh_shape(config.get("mesh_shape"),
                     mesh.world if mesh is not None else 1)


class JointTrainer:
    """Dataset-agnostic core; subclasses provide the batch sources
    ([B,H,W,C] tensors on the device, or host arrays that ``_place`` moves
    there)."""

    def __init__(self, model, data, config, device="cuda", mesh=None):
        _refuse_unported(config, mesh)
        self.mesh = mesh
        self.is_lead = mesh is None or mesh.is_lead
        self.model = model
        self.data = data
        self.config = config
        self.prior = config["prior"]
        self.plots_enabled = bool(config.get("enable_plots", 1))
        if self.plots_enabled:
            plotting.pyplot()  # no matplotlib: ImportError before any step
        self.device = resolve_device(device)
        # one generator for every draw of the run (see the module docstring)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("seed", 0)))
        self.state = init_state(model, device=self.device)
        set_batchnorm_mesh(model, mesh)
        self.ckpt = CheckpointManager(config, is_lead=self.is_lead)
        self.metrics = MetricsRecorder()

        self.train_step = make_train_step(model, mesh)
        self.eval_step = make_eval_step(model, mesh)
        self.fwd = make_forward_fns(model, mesh)
        # config['steps_per_call'] is accepted and changes nothing: in
        # ladder_tpu it fuses K steps under lax.scan, and the port has no
        # such fusion (its make_train_multi_step is a loop over the single
        # step), so every batch is one train_step call with the same updates

        self.cur_epoch = 0
        self.gm_fast = None       # (weights, means, covs) of the fast fit
        self.gm_final = None      # accurate fit
        self._timer_summary = None
        self.output_test = None   # the test batch's decode, for the plots
        # per epoch: the step timer's summary, each GM fit's seconds and
        # iterations, the validation loop's seconds
        self.timings = []
        self.num_para_list = model.count_params()
        # rank 0's init on every rank; on a (data, model) mesh this rank's
        # shards from here on
        self.tp = shard_state(self.state, mesh) if mesh is not None else None

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
        The CelebA trainer plots reconstructions here; no-op for MNIST."""

    def epoch_tail_plots(self):
        """Dataset-specific plots after validation (trainer.py:467)."""

    # ---- epoch-state helpers -----------------------------------------
    def _place(self, batch):
        """A batch on the trainer's device: a tensor already there passes
        through, a host array is copied."""
        if not torch.is_tensor(batch):
            batch = torch.as_tensor(np.asarray(batch))
        return batch.to(self.device)

    def _place_rows(self, batch):
        """A global batch -> this rank's rows on the device (``ladder_tpu``'s
        _place, trainer.py:141, place_global_batch under a mesh): raises
        on a batch that does not divide across the ranks."""
        return self._place(shard_batch(batch, self.mesh))

    def _whole(self):
        """Sharding off for a block: every rank runs whole batches."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return self.mesh.whole_batch()

    def _replicate(self):
        """Rank 0's parameters, moments and fitted GMs on every rank,
        bitwise (after an init or a restore)."""
        if self.mesh is None:
            return
        tensors = list(self.state["model"].parameters())
        for group in self.state["opt"].values():
            tensors += list(group["m"].values()) + list(group["v"].values())
        for gm in (self.gm_fast, self.gm_final):
            if gm is not None:
                tensors += list(gm)
        self.mesh.replicate_(tensors)

    def _full_params(self):
        """Every full parameter inside the block (gathered, then freed, on
        a (data, model) mesh)."""
        if self.tp is None:
            return contextlib.nullcontext()
        return self.tp.gathered()

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
                # a sharded state is gathered on every rank; the lead writes
                if self.is_lead or self.tp is not None:
                    with whole_state(self.state):
                        params = self.model.flax_params()
                        if self.prior in PRIORS_WITH_PRIOR_MODEL:
                            self.ckpt.save(params, model="joint")
                        else:
                            self.ckpt.save(params, model="VAE")
                        self.save_full_state()
                self._barrier()
                self.compute_execution_time(self.cur_epoch - 1,
                                            self.config["num_epochs"])
                stop = self._stop_requested
                if self.mesh is not None:
                    stop = self.mesh.any(stop)  # no rank stops alone
                if stop:
                    print(f"Preemption save complete at epoch "
                          f"{self.cur_epoch}/{self.config['num_epochs']}; "
                          f"rerun the same command to resume.")
                    break
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            self.ckpt.flush()
        self._barrier()  # the files are on disk before any rank goes on

    def _barrier(self):
        if self.mesh is not None:
            self.mesh.barrier()

    def _run_steps(self, timer, gm, flags, lrs, do_prior, sg_ov, sync_each):
        """The epoch's train steps; returns each step's metrics, still on
        the device. Spans (utils/profiling.py): ``train.batch_wait`` takes
        the next batch to the device, ``train.step`` is a step's call."""
        outs = []
        batches = iter(self.train_batches())
        while True:
            with span("train.batch_wait", step=len(outs)):
                batch = next(batches, None)
                if batch is not None:
                    batch = self._place(batch)
            if batch is None:
                return outs
            timer.start()
            with span("train.step", step=len(outs)):
                self.state, out = self.train_step(
                    self.state, batch, self.generator, gm, flags, lrs,
                    do_prior, sg_overlap=sg_ov)
            timer.stop(sync_on=out if sync_each else None)
            outs.append(out)
            self.mid_epoch_hook(len(outs) - 1)

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
        if profile_dir and self.mesh is not None:
            profile_dir = os.path.join(profile_dir, f"rank{self.mesh.rank}")
        collectives = copy_stats(self.mesh) if self.mesh is not None else None
        # sync_each_step=1 times every step on the device's clock
        sync_each = bool(cfg.get("sync_each_step", 0))
        sg_ov = do_prior and self.cur_epoch <= cfg["sg_pretraining"]
        timer.wall_start()
        with trace(profile_dir) as prof:
            outs = self._run_steps(timer, gm, flags, lrs, do_prior, sg_ov,
                                   sync_each)
            self._sync()
        timer.wall_stop()
        if prof is not None:
            record["profile"] = prof.summary
        if collectives is not None:
            # the step loop's collectives (count, bytes, host seconds)
            record["collectives"] = stats_delta(copy_stats(self.mesh),
                                                collectives)
        if self.tp is not None:
            # at rest: the shards (each step freed its full parameters)
            record["state_bytes"] = dict(
                zip(("predicted", "replicated"), self.tp.predicted_bytes()),
                held=self.tp.held_bytes())
            if self.device.type == "cuda":
                record["memory_allocated"] = torch.cuda.memory_allocated(
                    self.device)
        self._timer_summary = record["train"] = timer.report(
            prefix=f"epoch {self.cur_epoch}: ")
        with self._full_params():
            self._epoch_tail(record, outs, do_prior, flags)

    def _epoch_tail(self, record, outs, do_prior, flags):
        """After the step loop: the curves, the GM fit, the prior samples,
        the test batch, the validation loop and the lead's files."""
        cfg = self.config

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

        # prior samples (base.py:1147-1168)
        if self.plots_enabled:
            self.generate_samples_from_prior()

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
        if not self.is_lead:
            return

        self.metrics.save(cfg, self.num_para_list, self.n_train_iter(),
                          self.n_val_iter())
        self._write_scalar_summary()

        if self.plots_enabled:
            if cfg["TRAIN_VAE"] == 1:
                plotting.plot_train_and_val_loss_vae(
                    self.metrics, cfg["result_dir"], cfg["TRAIN_sigma"],
                    cfg["sigma"])
            if (self.cur_epoch > cfg["sg_pretraining"]
                    and self.prior in PRIORS_WITH_PRIOR_MODEL
                    and cfg["TRAIN_prior"] == 1):
                plotting.plot_train_and_val_loss_prior(
                    self.metrics, cfg["result_dir"], self.prior)

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
        device. Under a mesh each rank encodes its rows and every batch is
        gathered, so all ranks hold one process's samples in its order."""
        fn = self.fwd["representation_sample" if space == "t"
                      else "encode_sample"]
        parts = []
        for batch in self.sample_batches(n_target):
            part = fn(self._place(batch), self.generator)
            if self.mesh is not None:
                part = self.mesh.all_gather_rows(part)
            parts.append(part)
        samples = torch.cat(parts)
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
        if self.mesh is not None:
            # the ranks fitted the same samples with the same draws; rank
            # 0's fit is broadcast all the same, so they cannot drift
            self.mesh.replicate_(self.gm_fast if mode == "fast"
                                 else self.gm_final)
        self._sync()
        self.timings[-1]["gm"].append(dict(
            mode=mode, samples=int(samples.shape[0]), n_iter=fit.n_iter,
            converged=fit.converged, seconds=time.perf_counter() - t0))
        which = self.gm_fast if mode == "fast" else self.gm_final
        which_host = _to_host(which)
        if mode == "accurate" and self.is_lead:
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
            plot = cfg["representation_size"] == 2 and self.plots_enabled
            samples = self.fit_GMM_VI(mode="fast", space="t")
            if plot:
                self._plot_gm(samples, self.gm_fast, "crude-GM")
            if (self.cur_epoch % cfg["accurate_fit"] == 0
                    or self.cur_epoch == cfg["num_epochs"]):
                samples = self.fit_GMM_VI(mode="accurate", space="t")
                if plot:
                    self._plot_gm(samples, self.gm_final, "accurate-GM")
        elif self.prior == "GMM":
            plot = cfg["code_size"] == 2 and self.plots_enabled
            if self.cur_epoch < cfg["num_epochs"]:
                samples = self.fit_GMM_VI(mode="fast", space="z")
                gm, mode = self.gm_fast, "crude-GM"
            else:
                samples = self.fit_GMM_VI(mode="accurate", space="z")
                gm, mode = self.gm_final, "accurate-GM"
            if plot:
                self._plot_gm(samples, gm, mode)

    def _plot_gm(self, samples, gm, mode):
        if not self.is_lead:
            return
        samples, (w, m, K) = _to_host((samples, gm))
        for style in ("circle", "density"):
            plotting.plot_prior_distribution(
                samples, w, m, K, self.config["result_dir"], self.cur_epoch,
                mode=mode, style=style)

    # ---- prior sampling / generation (base.py:1065-1168) -------------
    def prior_draws(self, n, mode="crude-GM", method=None):
        """The random draws behind n codes of the prior ``method`` (the
        trainer's prior by default), from the trainer's generator:
        {'z'} for standard_gaussian and GMM, {'t'} for ours and
        hierarchical, {'k', 'eps'} for vampPrior. GMM and ours sample the
        fast fit (mode 'crude-GM') or the accurate one."""
        cfg = self.config
        method = method or self.prior
        gen, dev = self.generator, self.device
        if method in ("GMM", "ours"):
            w, m, K = self.gm_fast if mode == "crude-GM" else self.gm_final
            x = sample_gmm(gen, w, m, gmm_cholesky(K), n)
            return {"z" if method == "GMM" else "t": x}
        if method == "standard_gaussian":
            return {"z": torch.randn((n, cfg["code_size"]), generator=gen,
                                     device=dev)}
        if method == "hierarchical":
            return {"t": torch.randn((n, cfg["representation_size"]),
                                     generator=gen, device=dev)}
        if method == "vampPrior":
            k = torch.randint(0, cfg["n_mixtures"], (n,), generator=gen,
                              device=dev)
            return {"k": k, "eps": torch.randn((n, cfg["code_size"]),
                                               generator=gen, device=dev)}
        raise ValueError(method)

    def codes_from_draws(self, draws):
        """Codes z from prior_draws' draws: z itself, the inner decoder's
        mean code of t, or the pseudo-input mixture's component k shifted
        by eps (``ladder_tpu``'s sample_codes_from_prior,
        trainer.py:623-647)."""
        if "z" in draws:
            return draws["z"]
        if "t" in draws:
            return self.fwd["inner_decode"](draws["t"])
        with torch.no_grad():
            pseudo = self.model.pseudo_inputs().permute(0, 2, 3, 1)  # NHWC
        mean, std = self.fwd["encode"](pseudo)
        k = draws["k"]
        return mean[k] + std[k] * draws["eps"]

    def sample_codes_from_prior(self, n, mode="crude-GM", method=None):
        """n codes z from the configured prior (or ``method``)."""
        return self.codes_from_draws(self.prior_draws(n, mode, method))

    def prior_samples(self, n_sample=10):
        """The device half of generate_samples_from_prior: n_sample**2
        codes of the epoch's prior and fit (trainer.py:649-663), decoded in
        one call. Returns (images [n_sample**2, H, W, C] on the host, the
        PDF's filename). Under a mesh every rank draws and decodes all
        the codes (no collective; the generators stay in step)."""
        cfg = self.config
        mode, method = "crude-GM", None
        if self.prior == "ours":
            if self.cur_epoch <= cfg["sg_pretraining"]:
                method = "standard_gaussian"
            elif (self.cur_epoch % cfg["accurate_fit"] == 0
                  or self.cur_epoch == cfg["num_epochs"]):
                mode = "accurate-GM"
        elif self.prior == "GMM":
            if self.cur_epoch >= cfg["num_epochs"]:
                mode = "accurate-GM"
        with self._whole(), self._full_params():
            codes = self.sample_codes_from_prior(n_sample ** 2, mode=mode,
                                                 method=method)
            images = self.fwd["decode"](codes).cpu().numpy()
        if (method or self.prior) in ("GMM", "ours"):
            name = f"generated_samples_prior_{self.cur_epoch}_{mode}.pdf"
        else:
            name = f"generated_samples_prior_{self.cur_epoch}.pdf"
        return images, os.path.join(cfg["result_dir"], name)

    def generate_samples_from_prior(self, n_sample=10):
        images, filename = self.prior_samples(n_sample)
        if self.is_lead:
            plotting.plot_generated_samples(images, filename, n_sample,
                                            prior=self.prior)

    # ---- test / diagnostics (base.py:944-986) ------------------------
    def test_step(self, batch, print_result=False):
        """The fixed test batch's diagnostics; under a mesh each rank runs
        its rows and the metrics are averaged across the ranks."""
        with self._full_params():
            m = _to_host(self.eval_step(self._place_rows(batch),
                                        self.generator, self._gm_for_step(),
                                        self._flags()))
            if self.plots_enabled:
                # the reconstruction the plots show: a fresh posterior
                # sample, decoded (trainer.py:684-689); whole on every rank
                with self._whole():
                    z = self.fwd["encode_sample"](self._place(batch),
                                                  self.generator)
                    self.output_test = self.fwd["decode"](z).cpu().numpy()
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
        """One JSON line of epoch scalars in summary_dir/scalars.jsonl (the
        lead's)."""
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
        full-state resume when 'train-state' exists; on every rank (a
        sharded state is gathered, loaded, broadcast from rank 0 and
        sharded again)."""
        with whole_state(self.state):
            self._restore()

    def _restore(self):
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
        else:
            params = self.ckpt.load(self.model.flax_params(), model="VAE")
            if self.prior in PRIORS_WITH_PRIOR_MODEL:
                params = self.ckpt.load(params, model="prior")
            self.model.load_flax_params(params)
        # every rank read the same files; rank 0's values all the same
        self._replicate()


class MNISTTrainer(JointTrainer):
    """trainers.py:12-127 (MNISTTrainer_joint_training). The images are
    copied to the device once; every batch is a gather there."""

    def __init__(self, model, data, config, device="cuda", mesh=None):
        super().__init__(model, data, config, device, mesh)
        if self.plots_enabled and self.is_lead:
            plotting.plot_ground_truth_test_set(
                data.test_set["image"], config["result_dir"],
                config["batch_size"])
        self._images = {
            name: torch.as_tensor(getattr(data, name)["image"]).to(self.device)
            for name in ("train_set", "val_set", "test_set")}

    def _batches(self, name, seed, n_batches=None):
        bs = self.config["batch_size"]
        rows = self.mesh.rows(bs) if self.mesh is not None else None
        return device_epoch_batches(self._images[name], bs, seed, n_batches,
                                    rows=rows)

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

    def epoch_tail_plots(self):
        if (self.plots_enabled and self.is_lead
                and self.output_test is not None):
            plotting.plot_reconstructed_data(
                self.output_test, self.config["result_dir"], self.cur_epoch,
                title_attribs=None, narrow_space=True)
