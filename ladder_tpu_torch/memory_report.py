"""Train-step memory report of the port (the counterpart of
``scripts/memory_report.py``): what one train step and the train state
cost in device memory.

    python -m ladder_tpu_torch.memory_report --config codes/celeba_config.json \\
        [--batch 64] [--fused 1|2] [--dtype bfloat16] [--device cuda|cpu]
    LADDER_DISTRIBUTED=1 torchrun --nproc_per_node 2 \\
        -m ladder_tpu_torch.memory_report --mesh 1,2 ...

Builds the config's model and train state (``training/step.py:
init_state``) and takes one real step of ``make_train_step`` on a zero
batch (uint8 for CelebA, the input the trainer places on the card; float32
for the MNIST families), with the identity GM. Prints ONE JSON line:

- ``state_mb``: the logical bytes of the train state (params, adam_m,
  adam_v), the same numbers as the JAX script's for the same config;
- ``batch_mb``: the batch as the port puts it on the device;
- ``measured_mb`` in place of XLA's ``compiled_per_device_mb`` (a compiled
  program's static accounting has no PyTorch counterpart): on the card
  ``torch.cuda.memory_allocated`` before the step (``allocated_before``),
  ``max_memory_allocated`` during it (``peak_during_step``), the step's own
  share of that peak (``step_increment``, the peak less the bytes before:
  what the step adds to whatever the process already holds) and
  ``memory_reserved`` after it (``reserved``); ``peak_estimate_mb`` is the
  measured peak. On the CPU these are null: not estimated.

``--mesh D,M`` (the (data, model) mesh) or ``--mesh N`` (a data mesh) runs
only under ``LADDER_DISTRIBUTED=1 torchrun`` with as many ranks as the mesh
takes (NCCL on the card, a card a rank; gloo on the CPU); every rank
takes its rows of the global batch, and the lead prints
the line with each rank's bytes at rest (``parallel/tp.py:ShardedState``:
``held``, ``predicted`` by the rule, ``replicated``; a data mesh holds the
replicated bytes) and its measured memory under ``ranks``. Started without
torchrun it raises with the command to use. ``--steps-per-call`` and
``--unroll`` are accepted and reported: the port fuses no steps
(``steps_per_call`` is a departure ROADMAP.md lists). ``--device`` is cuda
unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

MB = 1e6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train-step memory report")
    ap.add_argument("--config", default="codes/celeba_config.json")
    ap.add_argument("--batch", type=int, default=None,
                    help="override config batch_size")
    ap.add_argument("--fused", type=int, default=None, choices=[1, 2])
    ap.add_argument("--dtype", default=None,
                    help="override config compute dtype (e.g. bfloat16)")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="accepted and reported; the port fuses no steps")
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="'N' for an N-rank data mesh, 'D,M' for the (data, "
                         "model) mesh (parallel/tp.py); under "
                         "LADDER_DISTRIBUTED=1 torchrun only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def torchrun_command(args):
    """The command that runs this report on ``args.mesh``."""
    shape = [int(x) for x in args.mesh.split(",")]
    n = int(np.prod(shape))
    return (f"LADDER_DISTRIBUTED=1 torchrun --standalone --nproc_per_node {n}"
            f" -m ladder_tpu_torch.memory_report --mesh {args.mesh} "
            f"--config {args.config} --device {args.device}")


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def state_bytes(state):
    """The train state's logical bytes: every parameter of the model and
    both moments of every optimiser group (a group that shares another's
    parameters counts its own moments, as the JAX state's tree does)."""
    opt = state["opt"].values()
    return {"params": _nbytes(state["model"].parameters()),
            "adam_m": _nbytes(t for g in opt for t in g["m"].values()),
            "adam_v": _nbytes(t for g in opt for t in g["v"].values())}


def zero_batch(cfg):
    b = cfg["batch_size"]
    if cfg["exp_name"] == "celeba":
        return np.zeros((b, cfg["dim_input_x"], cfg["dim_input_y"], 3),
                        np.uint8)  # the trainer's uint8 input
    return np.zeros((b, cfg["dim_input_x"], cfg["dim_input_y"], 1),
                    np.float32)


def step_inputs(cfg, device):
    """The identity GM (or none), the flags, lrs and do_prior of one step
    after pretraining, as the JAX script passes them."""
    import torch

    from ladder_tpu_torch.models.builder import (
        PRIORS_WITH_GM,
        PRIORS_WITH_PRIOR_MODEL,
    )
    from ladder_tpu_torch.training.losses import identity_gm

    prior = cfg["prior"]
    gm = None
    if prior in PRIORS_WITH_GM:
        d = (cfg["representation_size"] if prior == "ours"
             else cfg["code_size"])
        gm = identity_gm(cfg["n_mixtures"], d, device=device)
    flags = {"use_sg_prior": False, "use_mask": False}
    lrs = dict.fromkeys(("ae", "sigma", "prior", "inner_sigma"), 2.5e-4)
    generator = torch.Generator(device=device).manual_seed(1)
    return gm, flags, lrs, prior in PRIORS_WITH_PRIOR_MODEL, generator


def measure_step(step, state, batch, inputs, device):
    """Take one step; on the card the bytes allocated before it, the peak
    during it, the peak less the bytes before and the bytes reserved after
    it (MB), else Nones."""
    import torch

    gm, flags, lrs, do_prior, generator = inputs
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    step(state, batch, generator, gm, flags, lrs, do_prior)
    if not cuda:
        return dict.fromkeys(("allocated_before", "peak_during_step",
                              "step_increment", "reserved"))
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {
        "allocated_before": round(before / MB, 2),
        "peak_during_step": round(peak / MB, 2),
        "step_increment": round((peak - before) / MB, 2),
        "reserved": round(torch.cuda.memory_reserved(device) / MB, 2)}


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ladder_tpu_torch.utils.config import process_config
    from ladder_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = process_config(args.config)
    if args.batch is not None:
        cfg["batch_size"] = args.batch
    if args.fused is not None:
        cfg["fused_train_step"] = args.fused
    if args.dtype is not None:
        cfg["dtype"] = args.dtype
    cfg["steps_per_call"] = args.steps_per_call
    cfg["scan_unroll"] = args.unroll

    mesh = None
    if args.mesh:
        if not (os.environ.get("LADDER_DISTRIBUTED")
                and "RANK" in os.environ):
            raise RuntimeError(
                f"--mesh {args.mesh} runs one process a rank; start it as: "
                + torchrun_command(args))
        from ladder_tpu_torch.parallel.mesh import make_mesh
        cfg["mesh_shape"] = [int(x) for x in args.mesh.split(",")]
        # plain "cuda": each rank on cuda:LOCAL_RANK, as the train CLI
        mesh = make_mesh(cfg, None if args.device == "cuda" else args.device)
        device = mesh.device
    try:
        out = report(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if out is not None:
        print(json.dumps(out))
    return 0


def report(args, cfg, device, mesh=None):
    """The report's dict (None on a rank other than the lead)."""
    import torch

    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.models.layers import set_batchnorm_mesh
    from ladder_tpu_torch.parallel.mesh import shard_batch, shard_state
    from ladder_tpu_torch.training.step import init_state, make_train_step

    model = make_model(cfg, seed=0)
    state = init_state(model, device=device)
    logical = state_bytes(state)
    batch = zero_batch(cfg)
    batch_mb = round(batch.nbytes / MB, 2)
    tp = None
    if mesh is not None:
        set_batchnorm_mesh(model, mesh)
        tp = shard_state(state, mesh)
        batch = shard_batch(batch, mesh)
    step = make_train_step(model, mesh)
    measured = measure_step(
        step, state, torch.as_tensor(batch).to(device), step_inputs(cfg, device),
        device)
    out = {
        "config": args.config,
        "exp_name": cfg["exp_name"],
        "prior": cfg["prior"],
        "batch_size": cfg["batch_size"],
        "dtype": cfg["dtype"],
        "fused_train_step": cfg["fused_train_step"],
        "steps_per_call": args.steps_per_call,
        "mesh": args.mesh,
        "backend": device.type,
        "n_devices": 1 if mesh is None else mesh.world,
        # logical (unsharded) state sizes
        "state_mb": {k: round(v / MB, 2) for k, v in logical.items()},
        "batch_mb": batch_mb,
        # measured around one step (null on the CPU: not estimated)
        "measured_mb": measured,
        "peak_estimate_mb": measured["peak_during_step"],
    }
    if mesh is None:
        return out
    if tp is not None:
        predicted, replicated = tp.predicted_bytes()
        held = tp.held_bytes()
    else:  # a data mesh holds the whole state on every rank
        predicted = replicated = held = sum(logical.values())
    mine = {"rank": mesh.rank, "device": str(device), "held": held,
            "predicted": predicted, "replicated": replicated,
            "measured_mb": measured}
    ranks = [None] * mesh.world
    torch.distributed.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    return out if mesh.is_lead else None


if __name__ == "__main__":
    raise SystemExit(main())
