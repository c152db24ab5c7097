"""The train step: every per-batch optimiser update in one call (the port of
``ladder_tpu/training/step.py``).

Group ordering and gating:
  1. ae     : d(loss_ae)/d(encoder,decoder)   [TRAIN_VAE]
  2. sigma  : d(loss_ae)/d(sigma)             [TRAIN_sigma]
  3. prior  : d(loss_prior)/d(prior)          [TRAIN_prior, when do_prior]
  4. inner  : d(loss_prior)/d(inner_sigma)    [TRAIN_inner_sigma]
  5. z_std  : d(decoded_z_std_loss)/d(prior)  [TRAIN_decoded_z_std]
with the elementwise +-1 gradient clip, then TF1-style Adam per group
(training/optim.py).

The state is ``dict(model=LadderModel, opt={group: {m, v, t}}, step=int)``.
A step updates it IN PLACE (the parameters inside the model, the moments,
the counters) and returns it with the metrics; nothing is copied. Batches
arrive as ``ladder_tpu``'s do: [B,H,W,C] images, uint8 or float in [0,1],
as a numpy array or a tensor; they are moved to the model's device and to
NCHW here. Metrics come back as detached 0-dim or small tensors on the
model's device, so a step never waits for the device; the caller converts
what it logs.

Noise: a step draws from ONE ``torch.Generator`` per run, passed by the
caller (a CUDA generator on the card keeps the draws on the device), each
compute_loss call taking its draws in turn. ``ladder_tpu`` derives a
per-step stream with ``fold_in(rng, step)``; the two streams cannot be
matched and are not. Tests pass ``noise``: a list with one dict of draws
(losses.draw_noise) per compute_loss call, in order, each over the global
batch.

Data parallelism (``mesh``, parallel/mesh.py): each rank is given its rows
of the global batch and keeps its rows of every draw; each backward's
gradients are averaged across the ranks in one flat buffer before the
clip and the Adam kernel, so every rank applies the same update; the
returned metrics are averaged across the ranks, so they are the global
batch's. In mode 1 every sub-step has its own gradient all-reduce.

On a (data, model) mesh the state is sharded (parallel/tp.py: state['tp'],
from parallel/mesh.py:shard_state): a step gathers the full parameters
before its first forward, applies each group's update through the Adam
kernel to this rank's shards of the averaged gradients, gathers an
updated group again before the next forward reads it (mode 1), and frees
the full parameters at its end. ``flax_state`` and ``load_flax_state``
gather the whole state and are collective on such a mesh.

In float32 mode the step runs with TF32 off for convolutions and matmuls,
as the serving engine does. ``jax.jit``, buffer donation and ``lax.scan``
have no counterpart here: ``scan_unroll``, ``donate_batch_stack`` and the
kernel flags (``fused_adam``, ``fused_output_stage``, ``use_pallas``) are
accepted in configs and choose nothing.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ladder_tpu_torch.models.builder import (
    PRIORS_WITH_INNER_VAE,
    PRIORS_WITH_PRIOR_MODEL,
)
from ladder_tpu_torch.parallel.mesh import randn_rows, sharded
from ladder_tpu_torch.training.losses import (
    compute_loss,
    draw_noise,
    local_noise,
)
from ladder_tpu_torch.training.optim import adam_init, adam_update
from ladder_tpu_torch.utils.device import float32_exact, resolve_device
from ladder_tpu_torch.utils.weights import (
    flax_state_to_torch,
    torch_state_to_flax,
)

# metrics small enough to return from every train step
_SCALAR_KEYS = (
    "loss_ae", "elbo", "l1_reconstruction_error", "l2_reconstruction_error",
    "entropy_z", "crossEntropy_prior", "sigma_regularisor", "sigma",
    "mean_pixel_error", "reconstruction_likelihood", "crossEntropy_prior_sg",
    "elbo_prior", "loss_prior", "code_l1_reconstruction_error",
    "code_reconstruction_likelihood", "entropy_t",
    "crossEntropy_representation", "inner_sigma", "mean_code_error",
    "std_dev_code", "std_dev_representation", "decoded_z_std_loss",
)


def _small(metrics):
    return {k: metrics[k].detach() for k in _SCALAR_KEYS if k in metrics}


def group_keys(config):
    """Optimiser group -> top-level parameter groups of the model."""
    groups = {"ae": ("encoder", "decoder"), "sigma": ("sigma",)}
    if config["prior"] in PRIORS_WITH_PRIOR_MODEL:
        groups["prior"] = ("prior",)
    if (config["prior"] in PRIORS_WITH_INNER_VAE
            and config["TRAIN_inner_sigma"] == 1):
        groups["inner_sigma"] = ("inner_sigma",)
    if (config["prior"] in PRIORS_WITH_INNER_VAE
            and config["TRAIN_decoded_z_std"] == 1):
        groups["z_std"] = ("prior",)
    return groups


def group_params(model, keys):
    """{state-dict name: parameter} of the top-level groups ``keys``."""
    return {name: p for name, p in model.named_parameters()
            if name.split(".", 1)[0] in keys}


def init_state(model, flax_state=None, device="cuda"):
    """Train state around ``model``, moved to ``device``: zero moments per
    group, or everything (parameters, moments, counters) from a flax-layout
    train state ``{params, opt: {group: {m, v, t}}, step}`` of numpy
    arrays, through the weight bridge."""
    device = resolve_device(device)
    model.to(device).train().requires_grad_(True)
    groups = group_keys(model.config)
    state = dict(
        model=model,
        opt={name: adam_init(group_params(model, keys))
             for name, keys in groups.items()},
        step=0)
    if flax_state is not None:
        load_flax_state(state, flax_state)
    return state


def whole_state(state):
    """The full state inside the block: a context that gathers a sharded
    state (collective) and reshards it after, else nothing."""
    tp = state.get("tp")
    return tp.whole() if tp is not None else contextlib.nullcontext()


def load_flax_state(state, flax_state):
    """Overwrite ``state`` with a flax-layout train state (on a (data,
    model) mesh: on every rank, each keeping its shards)."""
    with whole_state(state):
        _load_flax_state(state, flax_state)


def _load_flax_state(state, flax_state):
    loaded = flax_state_to_torch(flax_state)
    model = state["model"]
    device = next(model.parameters()).device
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           loaded["params"].items()}, strict=True)
    if set(loaded["opt"]) != set(state["opt"]):
        raise ValueError(f"optimiser groups {sorted(loaded['opt'])} do not "
                         f"match the model's {sorted(state['opt'])}")
    for name, group in loaded["opt"].items():
        mine = state["opt"][name]
        for moment in ("m", "v"):
            if set(group[moment]) != set(mine[moment]):
                raise ValueError(f"opt[{name!r}][{moment!r}] does not hold "
                                 "the group's parameters")
            for key, value in group[moment].items():
                mine[moment][key].copy_(torch.tensor(value).to(device))
        mine["t"] = int(group["t"])
    state["step"] = int(loaded["step"])


def flax_state(state):
    """The train state as a flax-layout tree of numpy arrays (the inverse
    of load_flax_state; on a (data, model) mesh gathered on every rank)."""
    with whole_state(state):
        return torch_state_to_flax(dict(
            params=state["model"].state_dict(),
            opt=state["opt"], step=state["step"]))


def _images(batch, device):
    """[B,H,W,C] uint8 or float, numpy or tensor -> NCHW on the device
    (uint8 stays uint8; compute_loss normalises it)."""
    x = torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch)
                        else batch).to(device)
    if x.dtype != torch.uint8:
        x = x.float()
    return x.permute(0, 3, 1, 2).contiguous()


def _exact(model):
    return float32_exact() if model.dtype is None \
        else contextlib.nullcontext()


class _NoiseFeed:
    """One dict of draws per compute_loss call: from the caller's list, in
    order, or from the generator."""

    def __init__(self, model, generator, noise, mesh=None):
        self.model, self.generator, self.mesh = model, generator, mesh
        self.queue = None if noise is None else list(noise)

    def next(self, x):
        if self.queue is not None:
            if not self.queue:
                raise ValueError("the noise list is shorter than the "
                                 "step's compute_loss calls")
            return local_noise(self.queue.pop(0), self.mesh)
        return draw_noise(self.model.config, x.shape[0], self.generator,
                          x.device, self.mesh)


def _gradients(loss, params, mesh=None):
    """{name: gradient} of ``loss``; a parameter the loss does not reach
    gets zeros, so its moments decay as they do in ``ladder_tpu``. On a
    sharded mesh the gradients are averaged across the ranks (one flat
    buffer, in the parameters' dtype)."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    if sharded(mesh) is not None:
        mesh.average_(grads.values())
    return grads


def _global_metrics(out, mesh):
    return mesh.average_metrics(out) if sharded(mesh) is not None else out


def _apply_update(cfg, grads, opt_state, params, lr, mesh=None):
    adam_update(grads, opt_state, params, lr,
                skip_nonfinite=bool(cfg.get("skip_nonfinite_updates", 0)),
                mesh=mesh)


def _update_group(cfg, state, name, grads, params, lr, mesh):
    """One group's update: on the parameters, or on a sharded state on
    this rank's shards of the (averaged) gradients, after which the group's
    full parameters are stale."""
    tp = state.get("tp")
    if tp is None:
        _apply_update(cfg, grads, state["opt"][name], params, lr)
        return
    _apply_update(cfg, tp.shard_grads(grads), state["opt"][name],
                  {k: tp.shards[k] for k in params}, lr, mesh)
    tp.updated(params)


@contextlib.contextmanager
def _step_params(state):
    """A sharded state's full parameters are freed when the step ends."""
    tp = state.get("tp")
    try:
        yield
    finally:
        if tp is not None:
            tp.free()


def _gather(state):
    """The full parameters that are not current (a sharded state)."""
    tp = state.get("tp")
    if tp is not None:
        tp.gather()


def make_train_step(model, mesh=None):
    """Build train_step(state, batch, generator, gm, flags, lrs, do_prior,
    sg_overlap=False, noise=None) -> (state, out); with a data mesh, the
    step of one rank of it (see the module docstring).

    config['fused_train_step'] selects the update semantics:
      1 (default): sequential sub-steps. Group k+1 sees the parameters
        group k just wrote and every sub-step draws fresh noise: up to five
        forward passes, each with the backward of its own group only.
      2: single pass. One forward and one backward of loss_ae give every
        group's gradient (loss_ae contains -elbo_prior as its cross-entropy
        term, so grad(loss_ae, group) == grad(loss_prior, group) for the
        prior groups) and the groups update at the same parameter point.
        Not available with TRAIN_decoded_z_std (its loss differs).
    """
    cfg = model.config
    if cfg.get("fused_train_step", 1) == 2:
        if cfg["TRAIN_decoded_z_std"] == 1:
            raise ValueError("fused_train_step=2 is incompatible with "
                             "TRAIN_decoded_z_std=1; use mode 1")
        return _make_single_pass_step(model, mesh)
    groups = group_keys(cfg)

    def train_step(state, batch, generator, gm, flags, lrs, do_prior,
                   sg_overlap=False, noise=None):
        # sg_overlap only matters to the single-pass mode: the sequential
        # sub-steps differentiate loss_prior directly
        del sg_overlap
        model = state["model"]
        x = _images(batch, next(model.parameters()).device)
        feed = _NoiseFeed(model, generator, noise, mesh)
        out = {}

        def grad_step(name, lr, select):
            _gather(state)
            params = group_params(model, groups[name])
            loss_ae, metrics = compute_loss(model, x, gm=gm, flags=flags,
                                            noise=feed.next(x), mesh=mesh)
            grads = _gradients(select(loss_ae, metrics), params, mesh)
            _update_group(cfg, state, name, grads, params, lr, mesh)
            return metrics

        with _exact(model), _step_params(state):
            if cfg["TRAIN_VAE"] == 1:
                m = grad_step("ae", lrs["ae"], lambda L, _: L)
                out["ae"] = _small(m)

            if cfg["TRAIN_sigma"] == 1:
                m = grad_step("sigma", lrs["sigma"], lambda L, _: L)
                out["sigma"] = {"sigma": m["sigma"].detach()}

            if (do_prior and cfg["prior"] in PRIORS_WITH_PRIOR_MODEL
                    and cfg["TRAIN_prior"] == 1):
                m = grad_step("prior", lrs["prior"],
                              lambda L, met: met["loss_prior"])
                out["prior"] = _small(m)

                if "inner_sigma" in groups:
                    grad_step("inner_sigma", lrs["inner_sigma"],
                              lambda L, met: met["loss_prior"])

                if "z_std" in groups:
                    grad_step("z_std", lrs["prior"],
                              lambda L, met: met["decoded_z_std_loss"])

        state["step"] += 1
        return state, _global_metrics(out, mesh)

    return train_step


def _make_single_pass_step(model, mesh=None):
    """One forward and backward for all optimiser groups (see
    make_train_step)."""
    cfg = model.config
    groups = group_keys(cfg)

    def active_groups(do_prior):
        names = []
        if cfg["TRAIN_VAE"] == 1:
            names.append("ae")
        if cfg["TRAIN_sigma"] == 1:
            names.append("sigma")
        if (do_prior and cfg["prior"] in PRIORS_WITH_PRIOR_MODEL
                and cfg["TRAIN_prior"] == 1):
            names.append("prior")
            if "inner_sigma" in groups:
                names.append("inner_sigma")
        return names

    def train_step(state, batch, generator, gm, flags, lrs, do_prior,
                   sg_overlap=False, noise=None):
        """sg_overlap: True only for the epoch where prior training and the
        standard-gaussian pretraining switch coincide. There loss_ae's
        cross-entropy is ce_sg and its backward carries no elbo_prior
        gradient, so the prior groups take a second, explicit backward of
        loss_prior, on the same noise and at the same parameter point."""
        model = state["model"]
        x = _images(batch, next(model.parameters()).device)
        draws = _NoiseFeed(model, generator, noise, mesh).next(x)
        names = active_groups(do_prior)
        prior_names = [n for n in names if n in ("prior", "inner_sigma")]
        main_names = names
        if sg_overlap and prior_names:
            main_names = [n for n in names if n not in prior_names]

        def group_gradients(group_names, select):
            params = {n: group_params(model, groups[n]) for n in group_names}
            merged = {k: p for ps in params.values() for k, p in ps.items()}
            loss_ae, metrics = compute_loss(model, x, gm=gm, flags=flags,
                                            noise=draws, mesh=mesh)
            grads = _gradients(select(loss_ae, metrics), merged, mesh)
            return params, grads, metrics

        with _exact(model), _step_params(state):
            _gather(state)
            # every gradient is taken before any update: all groups update
            # at the same parameter point
            updates = [group_gradients(main_names, lambda L, _: L)]
            metrics = updates[0][2]
            if sg_overlap and prior_names:
                updates.append(group_gradients(
                    prior_names, lambda L, met: met["loss_prior"]))
            for params, grads, _ in updates:
                for name, ps in params.items():
                    _update_group(cfg, state, name, {k: grads[k] for k in ps},
                                  ps, lrs[name], mesh)

        out = {}
        small = _small(metrics)
        if "ae" in names:
            out["ae"] = small
        if "sigma" in names:
            out["sigma"] = {"sigma": metrics["sigma"].detach()}
        if "prior" in names:
            out["prior"] = small
        state["step"] += 1
        return state, _global_metrics(out, mesh)

    return train_step


def make_train_multi_step(model, mesh=None):
    """K train steps in one call over a [K, B, ...] batch stack (with a
    mesh, this rank's rows: parallel/mesh.py:place_global_stack): a plain
    loop with the single step's semantics. The returned metrics carry a
    leading K axis."""
    inner = make_train_step(model, mesh)

    def multi_step(state, batches, generator, gm, flags, lrs, do_prior,
                   sg_overlap=False, noise=None):
        outs = []
        for k in range(len(batches)):
            state, out = inner(state, batches[k], generator, gm, flags, lrs,
                               do_prior, sg_overlap=sg_overlap,
                               noise=None if noise is None else noise[k])
            outs.append(out)
        stacked = {group: {key: torch.stack([o[group][key] for o in outs])
                           for key in outs[0][group]}
                   for group in outs[0]} if outs else {}
        return state, stacked

    return multi_step


def make_eval_step(model, mesh=None):
    """eval_step(batch, generator, gm, flags, noise=None): the small metrics
    without gradients or updates (on a sharded mesh: of the global batch
    whose rows ``batch`` holds, averaged across the ranks)."""

    def eval_step(batch, generator, gm, flags, noise=None):
        x = _images(batch, next(model.parameters()).device)
        if noise is not None:
            noise = local_noise(noise, mesh)
        with torch.no_grad(), _exact(model):
            _, metrics = compute_loss(model, x, generator, gm, flags, noise,
                                      mesh=mesh)
        return _global_metrics(_small(metrics), mesh)

    return eval_step


def make_forward_fns(model, mesh=None):
    """Gradient-free inference helpers for trainers and demos. Image inputs
    are [B,H,W,C], uint8 or float, and are normalised as compute_loss
    normalises them; outputs are tensors on the model's device, decoded
    images [B,H,W,C]. On a sharded mesh the inputs are this rank's rows of
    a global batch, and the samplers keep this rank's rows of the global
    batch's draws."""

    def _norm(x):
        x = _images(x, next(model.parameters()).device)
        return x.float() * (1.0 / 255.0) if x.dtype == torch.uint8 else x

    def _run(fn):
        def wrapped(*args):
            with torch.no_grad(), _exact(model):
                return fn(*args)
        return wrapped

    def sample(generator, mean, std):
        # ops/distributions.py:sample_diag_gaussian's draw without a mesh
        eps = randn_rows(generator, mean.shape, mesh)
        return mean + std * eps.to(device=mean.device, dtype=mean.dtype)

    def encode_sample(x, generator):
        return sample(generator, *model.encode(_norm(x)))

    fns = dict(encode=_run(lambda x: model.encode(_norm(x))),
               decode=_run(lambda z: model.decode(z).permute(0, 2, 3, 1)),
               encode_sample=_run(encode_sample))

    if model.config["prior"] in PRIORS_WITH_INNER_VAE:
        def representation_sample(x, generator):
            z = encode_sample(x, generator)
            return sample(generator, *model.inner_encode(z))

        fns.update(inner_encode=_run(model.inner_encode),
                   inner_decode=_run(lambda t: model.inner_decode(t)[0]),
                   representation_sample=_run(representation_sample))
    return fns
