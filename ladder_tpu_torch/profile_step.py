"""Per-kernel time of the production train step (the counterpart of
``scripts/profile_step.py``):

    python -m ladder_tpu_torch.profile_step [--batch 64] [--steps 8] [--top 40]
        [--dtype bfloat16|float32] [--fused 2|1] [--device cuda|cpu]

``capture`` builds the JAX script's CelebA-128 config (h=512, 50 mixtures,
100 MC samples, bf16 mode 2 by default) with the port's builder, takes 3
warm-up steps on a fixed uint8 batch, then ``--steps`` steps under
``utils/profiling.py:trace``, which writes a Chrome trace to ``--logdir``
(default ``/tmp/ladder_torch_profile``). ``report`` reads that trace back
and sums the device's kernel events by name: ms a step, launches a step,
the top ``--top`` kernels. PyTorch's trace carries no bytes or flops for a
kernel, so the GB/s and TF/s columns print ``-`` where an event has none.
A trace with no CUDA kernel (a capture on the CPU) stops with a message.

Departures from the JAX script: ``--device`` (cuda unless the caller asks
for the CPU); ``--fused-output`` is accepted and goes into the config, but
chooses no path: the device decides, as in the rest of the port;
``capture`` returns the trace's summary (``Trace.summary``: the window's
wall over the steps after the first, the device's busy time), and
``report`` returns its rows.
"""

from __future__ import annotations

import argparse
import collections
import shutil

WARMUP = 3  # untraced steps before the trace: cuDNN's picks, the builds


def celeba_config(batch, hidden, **step):
    """The JAX profilers' CelebA-128 config (scripts/profile_step.py,
    scripts/stream_trace.py) with ``step``'s dtype and mode keys."""
    from ladder_tpu_torch.utils.config import apply_defaults

    return apply_defaults({
        "exp_name": "celeba", "prior": "ours", "load_dir": "default",
        "num_epochs": 1, "batch_size": batch,
        "dim_input_x": 128, "dim_input_y": 128, "dim_input_channel": 3,
        "code_size": 256, "representation_size": 2,
        "num_hidden_units": hidden,
        "num_hidden_units_inner_VAE": 512, "n_layers_inner_VAE": 5,
        "n_mixtures": 50, "n_MC_samples": 100, "sigma": 0.5,
        "learning_rate_ae": 2.5e-4,
        "TRAIN_VAE": 1, "TRAIN_sigma": 1, "TRAIN_prior": 1,
        "TRAIN_inner_sigma": 1, "sg_pretraining": 0, **step})


def build_config(args):
    """The JAX script's config for these arguments."""
    return celeba_config(args.batch, args.hidden, dtype=args.dtype,
                         fused_train_step=args.fused,
                         fused_output_stage=args.fused_output)


def train_setup(cfg, device):
    """A fresh model's train state and step on ``device``, with the JAX
    scripts' identity GM, flags, learning rates and generator seed:
    (state, step, (generator, gm, flags, lrs, do_prior))."""
    import torch

    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.losses import identity_gm
    from ladder_tpu_torch.training.step import init_state, make_train_step

    model = make_model(cfg)
    state = init_state(model, device=device)
    gm = identity_gm(cfg["n_mixtures"], cfg["representation_size"],
                     device=device)
    flags = {"use_sg_prior": False, "use_mask": False}
    lrs = dict.fromkeys(["ae", "sigma", "prior", "inner_sigma"], 2.5e-4)
    generator = torch.Generator(device=device.type).manual_seed(1)
    return state, make_train_step(model), (generator, gm, flags, lrs, True)


def capture(args):
    """Warm up, then trace ``args.steps`` train steps; returns the trace's
    summary."""
    import numpy as np
    import torch

    from ladder_tpu_torch.utils.device import resolve_device
    from ladder_tpu_torch.utils.profiling import synchronize, trace

    device = resolve_device(args.device)
    state, step, rest = train_setup(build_config(args), device)
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (args.batch, 128, 128, 3)).astype(np.uint8)).to(device)

    for _ in range(WARMUP):
        state, out = step(state, batch, *rest)
    synchronize(out)

    shutil.rmtree(args.logdir, ignore_errors=True)
    with trace(args.logdir) as tr:
        for k in range(args.steps):
            with tr.step_range(k):
                state, out = step(state, batch, *rest)
        synchronize(out)
    print("trace captured to", args.logdir)
    return tr.summary


def report(args):
    """The per-kernel table of the newest trace under ``args.logdir``;
    returns its rows (name, ms a step, launches a step, launches)."""
    from ladder_tpu_torch.utils.profiling import read_chrome_trace

    events = read_chrome_trace(args.logdir)
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernels:
        raise SystemExit("trace has no CUDA kernel events — was the capture "
                         "run on the CPU? (per-kernel reporting needs the "
                         "card's kernel lane)")
    durs = collections.defaultdict(float)
    cnt = collections.Counter()
    extra = {}
    for e in kernels:
        durs[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
        extra.setdefault(e["name"], e.get("args", {}))
    total = sum(durs.values())
    print(f"\ntotal kernel time {total / 1e3 / args.steps:.2f} ms/step "
          f"over {args.steps} steps; top {args.top} kernels:")
    print(f"{'ms/step':>8} {'x':>4} {'GB/s':>6} {'TF/s':>6}  op")
    rows = []
    for name, d in sorted(durs.items(), key=lambda kv: -kv[1]):
        rows.append((name, d / 1e3 / args.steps, cnt[name] / args.steps,
                     cnt[name]))
    for name, ms, _, n in rows[:args.top]:
        per_call_s = durs[name] / n / 1e6
        a = extra[name]
        gbs = (f"{float(a['bytes']) / per_call_s / 1e9:.0f}"
               if a.get("bytes") and per_call_s else "-")
        tfs = (f"{float(a['flops']) / per_call_s / 1e12:.1f}"
               if a.get("flops") and per_call_s else "-")
        print(f"{ms:8.3f} {n // args.steps:>4} {gbs:>6} {tfs:>6}  "
              f"{name[:70]}")
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--fused", type=int, default=2)
    ap.add_argument("--fused-output", type=int, default=0,
                    help="accepted and reported; the device picks the path")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default="/tmp/ladder_torch_profile")
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.report_only:
        capture(args)
    report(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
