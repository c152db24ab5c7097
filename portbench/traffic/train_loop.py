"""Traffic kind ``train_loop``: the CelebA trainer's step loop over a pool
of synthetic images, passes back to back.

Set-up writes the pool (made on the device from the seed) as the recipe's
TFRecords under the run's temporary directory, builds the model, the data
and ``CelebATrainer`` of ladder_tpu_torch, loads the seeded weights, puts
the trainer in the recipe's steady phase (past sg_pretraining, the prior
groups on, a hyper-prior mixture made from the seed) and drives its step
loop (``JointTrainer._run_steps``: the native reader, the prefetch thread,
the copy to the card, ``train_step``) through the checked steps. The same
trainer then runs the window: each pass over the pool a new shuffle, every
batch through the same loop, until ``--seconds`` have passed; the window
ends with a device synchronise. With --trace 1 the first half of the
window is untraced (the host clocks) and the second half traced.

After the window and the memory reading the program is freed and the
reference runs the checked steps again from the same inputs.

Mix parameters: pool_images, side_images (the validation and test files
the trainer opens), check_steps.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np
import torch

from portbench import checks, seeded, yardstick
from portbench.reference import ladder_celeba as ref

BATCH_METRIC = "train_img_s"


class LoopClock:
    """Passed where the trainer's loop takes its StepTimer: each step
    call's host time (the dispatch) and the host time from one step's
    return to the next step's call (the wait on the prefetch queue)."""

    def __init__(self):
        self.dispatch, self.wait = [], []
        self._t0 = self._last = None

    def start(self):
        now = time.perf_counter()
        if self._last is not None:
            self.wait.append(now - self._last)
        self._t0 = now

    def stop(self, sync_on=None, n_steps=1):
        now = time.perf_counter()
        self.dispatch.append(now - self._t0)
        self._last = now
        return now - self._t0


def _program_config(cfg, run):
    from ladder_tpu_torch.utils.config import apply_defaults, validate_config

    cfg = validate_config(apply_defaults(dict(cfg)))
    work = run.workdir
    cfg.update(data_path=os.path.join(work, "data"),
               checkpoint_dir=os.path.join(work, "checkpoint"),
               result_dir=os.path.join(work, "result"),
               summary_dir=None, enable_plots=0,
               seed=seeded.sub_seed(run.seed, "trainer"))
    return cfg


def _write_data(cfg, run, mix):
    from ladder_tpu_torch.data.tfrecord import write_image_tfrecords

    os.makedirs(cfg["data_path"], exist_ok=True)
    for split, n in (("train", mix["pool_images"]),
                     ("val", mix["side_images"]),
                     ("test", mix["side_images"])):
        imgs = seeded.images(n, run.seed, split, run.device,
                             size=cfg["dim_input_x"])
        write_image_tfrecords(
            os.path.join(cfg["data_path"], f"celebA_{split}.tfrecords"),
            imgs.cpu().numpy())
        del imgs


def pass_seed(seed, k):
    return seeded.sub_seed(seed, f"pass:{k}") % (2 ** 32)


def _trainer_class():
    from ladder_tpu_torch.training.celeba_trainer import CelebATrainer

    class BenchTrainer(CelebATrainer):
        """The CelebA trainer whose batch source is the benchmark's chain
        of passes, and whose per-step hook keeps the checked state."""

        source = None
        snapshot = None

        def train_batches(self):
            return self.source

        def mid_epoch_hook(self, idx_iter, span=1):
            if self.snapshot is not None:
                self.snapshot(idx_iter)

    return BenchTrainer


def _passes(trainer, seed, first_pass, deadline=None, limit=None):
    """Batches of passes first_pass, first_pass + 1, ... over the pool
    through the trainer's data path, until ``deadline`` (perf_counter) or
    ``limit`` batches."""
    bs = trainer.config["batch_size"]
    k, n = first_pass, 0
    while True:
        it = trainer.data.train.epoch(bs, seed=pass_seed(seed, k),
                                      to_device=trainer.device,
                                      rows=trainer._rows())
        k += 1
        try:
            for batch in it:
                if limit is not None and n >= limit:
                    return
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                n += 1
                yield batch
        finally:
            it.close()


@contextlib.contextmanager
def _first_gradients():
    """{leaf: norm of the first gradient the optimiser got}, recorded at
    the train step's call into the update (training/step.py
    _apply_update) while the block runs."""
    from ladder_tpu_torch.training import step

    apply = step._apply_update
    norms = {}

    def recording(cfg, grads, opt_state, params, lr, mesh=None):
        for k, g in grads.items():
            if k not in norms:
                norms[k] = g.detach().double().norm()
        return apply(cfg, grads, opt_state, params, lr, mesh)

    step._apply_update = recording
    try:
        yield norms
    finally:
        step._apply_update = apply


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def reference_inputs(cfg, run_seed, mix, device):
    """What the reference needs, made again from the seed: the weights,
    the checked steps' batches (NCHW uint8), the mixture with its
    Cholesky factors, the noise generator and the learning rates."""
    n = mix["check_steps"] * cfg["batch_size"]
    pool = seeded.images(mix["pool_images"], run_seed, "train", device,
                         size=cfg["dim_input_x"])
    perm = np.random.default_rng(pass_seed(run_seed, 0)).permutation(
        mix["pool_images"])[:n]
    rows = pool[torch.as_tensor(perm, device=device)]
    del pool
    bs = cfg["batch_size"]
    batches = [rows[i:i + bs].permute(0, 3, 1, 2).contiguous()
               for i in range(0, n, bs)]
    w, m, covs = seeded.mixture(cfg, run_seed, device)
    gm = (w, m, torch.linalg.cholesky(covs))
    gen = seeded.generator(run_seed, "noise", device)
    lrs = ref.lrs_at_epoch(cfg, cfg["sg_pretraining"] + 1)
    return (seeded.weights(cfg, run_seed, device), batches, gm, gen, lrs)


def reference_readings(cfg, run_seed, mix, device, prog, precision):
    """checks.train_readings of ``prog`` (losses, gradient norms,
    parameters after the checked steps) against the reference."""
    weights, batches, gm, gen, lrs = reference_inputs(cfg, run_seed, mix,
                                                      device)
    with ref.tf32_off():
        losses, first, after = ref.train_steps(
            cfg, weights, batches, gm, gen, lrs,
            cfg.get("fused_train_step", 1), ref.Precision(precision))
    return checks.train_readings(prog["losses"], losses, prog["grad_norms"],
                                 first, weights, prog["params"], after)


def run(run):
    cell, mix, device = run.cell, run.cell.mix, run.device
    from ladder_tpu_torch.data.celeba import CelebAData
    from ladder_tpu_torch.models.builder import make_model

    cfg = _program_config(cell.config, run)
    steady = cfg["sg_pretraining"] + 1
    _write_data(cfg, run, mix)
    model = make_model(cfg)
    trainer = _trainer_class()(model, CelebAData(cfg), cfg, device=device)
    weights = seeded.weights(cfg, run.seed, device)
    trainer.model.load_state_dict(weights, strict=True)
    group_sizes = [sum(m.numel() for m in g["m"].values())
                   for g in trainer.state["opt"].values()]
    del weights
    trainer.cur_epoch = steady
    trainer.gm_fast = seeded.mixture(cfg, run.seed, device)
    gm, flags = trainer._gm_for_step(), trainer._flags()
    lrs, do_prior = trainer._lrs(), trainer._do_prior()
    if flags["use_sg_prior"] or flags["use_mask"] or not do_prior:
        raise RuntimeError(f"not the steady phase: {flags}, prior {do_prior}")
    sg_ov = False
    trainer.generator.manual_seed(seeded.sub_seed(run.seed, "noise"))

    # the checked steps: the loop's own call and feed, pass 0's batches;
    # each leaf's first gradient is read where the step hands it to the
    # optimiser (the state keeps only its clipped form, which saturates)
    n_check = mix["check_steps"]
    kept = {}

    def snapshot(i):
        if i == n_check - 1:
            kept["params"] = {k: p.detach().clone() for k, p in
                              trainer.model.named_parameters()}

    trainer.snapshot = snapshot
    trainer.source = _passes(trainer, run.seed, 0, limit=n_check)
    with _first_gradients() as first:
        check_outs = trainer._run_steps(LoopClock(), gm, flags, lrs,
                                        do_prior, sg_ov, False)
    trainer.snapshot = None
    _sync(device)

    # the window
    bs = cfg["batch_size"]
    halves = [(run.seconds / 2, False), (run.seconds / 2, True)] \
        if run.trace else [(run.seconds, False)]
    run.setup_s = time.perf_counter() - run.process_start
    next_pass, steps, outs = 1, 0, []
    for duration, traced in halves:
        clock = LoopClock()
        prof = (yardstick.profiler(device) if traced
                else contextlib.nullcontext())
        with prof as p:
            mark = (torch.profiler.record_function(yardstick.WINDOW_MARK)
                    if traced else contextlib.nullcontext())
            t0 = time.perf_counter()
            with mark:
                trainer.source = _passes(trainer, run.seed, next_pass,
                                         deadline=t0 + duration)
                seg = trainer._run_steps(clock, gm, flags, lrs, do_prior,
                                         sg_ov, False)
                _sync(device)
            t1 = time.perf_counter()
        next_pass += 1 + len(seg) * bs // mix["pool_images"]
        outs += seg
        steps += len(seg)
        if traced:
            run.trace_summary = yardstick.read_profile(p, run.workdir)
        else:
            run.host.update(
                steps=len(seg), wall_s=t1 - t0, batch=bs,
                dispatch_s=clock.dispatch, wait_s=clock.wait[1:],
                step_flops=yardstick.train_step_flops(
                    cfg, bs, cfg["fused_train_step"]),
                dtype=cfg["dtype"])
    run.host.update(step_kernels=yardstick.train_step_kernels(
        cfg, bs, cfg["dtype"], cfg["fused_train_step"], group_sizes))
    if not run.trace:
        run.e2e[BATCH_METRIC] = run.host["steps"] * bs / run.host["wall_s"]
    run.attempted = steps
    losses = torch.stack([o["ae"]["loss_ae"] for o in outs]).cpu()
    run.failed = int((~torch.isfinite(losses)).sum())
    if str(device).startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()

    prog = dict(
        losses=[{"loss_ae": float(o["ae"]["loss_ae"]),
                 "loss_prior": float(o["prior"]["loss_prior"])}
                for o in check_outs],
        grad_norms={k: float(v) for k, v in first.items()},
        params=kept["params"])
    del trainer, model, outs, check_outs, gm
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    run.readings = reference_readings(cfg, run.seed, mix, device, prog,
                                      "float32")
    run.checks = {k: (v, run.cell.limits[k])
                  for k, v in run.readings.items() if k in run.cell.limits}

