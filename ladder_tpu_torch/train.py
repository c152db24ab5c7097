"""The training CLI of the port:

    python -m ladder_tpu_torch.train --config codes/mnist_digit_config.json [--device cuda|cpu]
    python -m ladder_tpu_torch.train --config demo/celeba_config.json [--device cuda|cpu]
    LADDER_DISTRIBUTED=1 torchrun --nproc_per_node N -m ladder_tpu_torch.train --config cfg.json

The counterpart of ``train.py --config``: the same JSON schema, the same
directories and artifacts ({exp}-result.npz, GM_prior_info.npz,
vae-model / prior-model / train-state .msgpack), the same console lines,
checkpoint restore before training (a full train state resumes the epoch
count), then the epoch loop. The data and the trainer follow
config['exp_name'], as ``train.py`` does: the mnist families train on
in-memory arrays (data/mnist.py, MNISTTrainer), CelebA on TFRecords
(data/celeba.py, CelebATrainer). ``--device`` is cuda unless the caller
asks for the CPU; without a CUDA device the default fails. As the
reference does, a missing or unreadable config prints ``missing or invalid
arguments`` and exits 0. With ``enable_plots`` on (the default) the
trainer writes ``ladder_tpu``'s PDFs and needs matplotlib: without it, it
raises an ImportError before the first step.

Data parallelism, as ``train.py``'s ``LADDER_DISTRIBUTED=1``: under
torchrun with LADDER_DISTRIBUTED=1 set, every process joins the process
group before any device use (parallel/mesh.py:make_mesh: NCCL on
CUDA, gloo on the CPU, gloo on CUDA only with ``--backend gloo``), takes
cuda:LOCAL_RANK unless ``--device`` names one, and trains its rows of every
global batch (config['batch_size'] is the global batch). ``mesh_shape``
[N] needs N >= the ranks started. ``mesh_shape`` [n_data, n_model] is the
(data, model) mesh (parallel/tp.py): the ranks started must be a multiple
of n_model and at most n_data * n_model; every rank still takes its own
rows, and the parameters and Adam moments are sharded over each group of
n_model ranks between steps:

    LADDER_DISTRIBUTED=1 torchrun --nproc_per_node 4 -m ladder_tpu_torch.train --config cfg.json   # mesh_shape [2, 2]

Without LADDER_DISTRIBUTED the CLI trains on its one device whatever
mesh_shape says, as ``train.py`` does on one device. Rank 0 writes every file and
prints the console lines; the other ranks print nothing to stdout.

``--report FILE`` writes, per process, a JSON record of the run: the rank,
the world size, the device, the kernels' launch counts, a digest of the
parameters, the Adam moments and the fitted GMs (of the whole state,
gathered, on a (data, model) mesh), the train and validation
curves, the per-epoch timings (with the step loop's collectives under a
mesh, and the profile's summary when config['profile_dir'] is set) and the
peak device memory.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time

import torch

from ladder_tpu_torch.utils.config import (
    create_dirs,
    get_args,
    process_config,
    save_config,
)
from ladder_tpu_torch.utils.device import resolve_device


def state_digest(trainer):
    """sha256 over the bytes of every parameter, Adam moment and fitted GM
    tensor of the trainer, in a fixed order: equal on ranks that hold the
    same values bit for bit. A sharded state is gathered first (on every
    rank: collective)."""
    from ladder_tpu_torch.training.step import whole_state
    with whole_state(trainer.state):
        return _digest(trainer)


def _digest(trainer):
    h = hashlib.sha256()
    tensors = [p for _, p in sorted(trainer.model.named_parameters())]
    for name in sorted(trainer.state["opt"]):
        group = trainer.state["opt"][name]
        for moment in ("m", "v"):
            tensors += [group[moment][k] for k in sorted(group[moment])]
    for gm in (trainer.gm_fast, trainer.gm_final):
        if gm is not None:
            tensors += list(gm)
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def launch_counts():
    """The kernel wrappers' launch counters of this process."""
    from ladder_tpu_torch.ops import adam, norm_chain, output_stage
    return {"norm_chain_fwd": norm_chain.fused_instnorm_style_lrelu.launches,
            "norm_chain_bwd": norm_chain.norm_chain_backward.launches,
            "output_stage_fwd": output_stage.fused_output_recon.launches,
            "output_stage_bwd": output_stage.output_recon_backward.launches,
            "adam_update": adam.adam_update_.launches}


def write_report(path, trainer, mesh, device):
    rank = mesh.rank if mesh is not None else 0
    report = dict(
        rank=rank, world=mesh.world if mesh is not None else 1,
        n_model=getattr(mesh, "n_model", None),
        backend=mesh.backend if mesh is not None else None,
        device=str(device), launches=launch_counts(),
        digest=state_digest(trainer), step=trainer.state["step"],
        train_loss=list(map(float, trainer.metrics.train_loss)),
        val_loss=list(map(float, trainer.metrics.val_loss_ave_epoch)),
        timings=trainer.timings, data_seconds=trainer.data_seconds,
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None))
    path = path.replace("{rank}", str(rank))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f)


def main(argv=None):
    """Run the CLI; returns the trainer (None when nothing trains), so a
    caller in the same process can read its state and timings."""
    try:
        args = get_args(argv)
        config = process_config(args.config)
    except SystemExit:
        raise
    except Exception as e:  # the reference's quirk: report and exit 0
        print("missing or invalid arguments: {}".format(e))
        sys.exit(0)
    if not os.environ.get("LADDER_DISTRIBUTED"):
        return _train(config, args, resolve_device(args.device or "cuda"),
                      None)
    from torch import distributed as dist

    from ladder_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(config, args.device, args.backend)
    try:
        with contextlib.ExitStack() as stack:
            if not mesh.is_lead:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            print(f"torch.distributed: rank {mesh.rank}/{mesh.world} on "
                  f"{mesh.device} over {mesh.backend}")
            return _train(config, args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()


def _train(config, args, device, mesh):
    create_dirs([config["result_dir"], config["checkpoint_dir"]])
    if mesh is None or mesh.is_lead:
        save_config(config)

    from ladder_tpu_torch.models.builder import make_model

    t0 = time.perf_counter()
    if config["exp_name"] == "celeba":
        from ladder_tpu_torch.data.celeba import CelebAData
        from ladder_tpu_torch.training.celeba_trainer import (
            CelebATrainer as Trainer,
        )
        if mesh is None:
            data = CelebAData(config)
        else:
            # the lead writes the synthetic TFRecords (and builds the
            # native reader) first, the others wait and then read them
            if mesh.is_lead:
                data = CelebAData(config)
            mesh.barrier()
            if not mesh.is_lead:
                data = CelebAData(config)
    else:
        from ladder_tpu_torch.data.mnist import DataGenerator
        from ladder_tpu_torch.training.trainer import MNISTTrainer as Trainer
        data = DataGenerator(config)
    data_seconds = time.perf_counter() - t0
    model = make_model(config, seed=int(config.get("seed", 0)))
    print("Created a VAE model.")
    print("The current dataset is {}, num hidden units: {}.\n".format(
        config["exp_name"], config["num_hidden_units"]))

    if not (config["TRAIN_VAE"] or config["TRAIN_sigma"]
            or config["TRAIN_prior"]):
        return None
    trainer = Trainer(model, data, config, device=device, mesh=mesh)
    trainer.data_seconds = data_seconds
    if config.get("load_model", 1):
        trainer.restore()
    if config["num_epochs"] > 0:
        trainer.train()
    if args.report:
        write_report(args.report, trainer, mesh, device)
    return trainer


if __name__ == "__main__":
    main()
