"""Smoke test of the PyTorch/CUDA port (ladder_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. Card and build: torch and CUDA versions, the card's name and power
   limit (nvidia-smi), and an nvcc build of every kernel from
   ladder_tpu_torch/csrc/, all sources at once.
2. Kernels against their plain PyTorch versions at the shapes the main
   paths give them (CelebA-128, h=512, batch 64; float32 and bfloat16),
   timed beside their bound on this card: the norm chain forward and
   backward at the four decoder stages, the output stage forward and
   backward at [64,128,128,128], and the Adam update over the model's
   encoder+decoder group, over a scalar group and over the mnist_digit
   model's encoder+decoder and inner-VAE groups. Each kernel's device
   time (``device_ms``, profiler kernel durations; ``ms`` is this one;
   where the inputs would stay in the L2 cache between launches, the
   norm chain's 16x16 stage and the mnist Adam groups, it is taken with
   the cache flushed and the warm time kept as ``device_ms_warm``) is
   reported apart from its call time through the wrapper (``call_ms``, host
   clock) and, for Adam, the wrapper's host time (``host_ms``); see
   kernel_times.py. The norm-chain forward is also timed beside a PyTorch
   elementwise pass over its input (``stream_device_ms``: y = -x, the same
   bytes moved). The norm-chain forward and the Adam update are also
   checked, untimed, on inputs that take their other variants: odd and
   oversized planes, unaligned starts, tails, a group larger than one
   launch's table, a parameter replaced under a cached plan.
3. Serving: the pretrained CelebA-128 'ours' model (demo/celeba_config.json)
   through ladder_tpu_torch's InferenceEngine on the card: every path, the
   kernel launch count per decoding call, agreement with an engine on the
   CPU over the same weights and batch, a bfloat16 engine within a band of
   float32, and one HTTP round trip through the micro-batching server with
   a drain. Then per-path latencies and a profile of one reconstruction.
4. Training: the same model and weights through ladder_tpu_torch's train
   step on the card, batch 64, float32 with TF32 off, a few steps of the
   sequential mode and of the single-pass mode: finite metrics, every
   active group moved and counted, the launch counts of one step, and the
   first step against the same step on the CPU at batch 8. Then the step
   time per mode and a profile of one sequential step.
5. Training the pretrained mnist_digit model (demo/mnist_digit_config.json:
   h=256, code 16, t in 2-D, inner VAE 5x512, 50 mixtures, 100 MC samples,
   batch 256) through ``python -m ladder_tpu_torch.train``'s main, in this
   process, on synthetic MNIST at MNIST's split sizes (60,000 + 10,000):
   2 epochs from the pretrained checkpoint groups, then a rerun with
   num_epochs 3 that resumes from the full train state. Checks: the first
   step against the CPU's at batch 8, finite curves, the result npz over
   the 3 epochs, GM_prior_info.npz, both checkpoint groups rewritten and
   read back, and exactly one Adam launch per updated group per step.
   Logs per epoch the wall time, step time, steps/s and images/s, the GM
   fits' times and iterations and the validation loop's time; then a
   profile of 10 train steps.
6. Training the pretrained CelebA-128 'ours' model (demo/celeba_config.json,
   h=512, code 256, t in 32-D, inner VAE 5x512, 50 mixtures, 100 MC
   samples, batch 64) through ``python -m ladder_tpu_torch.train``'s main
   on synthetic CelebA TFRecords at the demo's split sizes (1,024 + 256 +
   128 images) read by the native reader: float32 mode 1 for 2 epochs from
   the pretrained groups, then resumed to 3; bf16 mode 2 for 1 epoch from
   the same groups; then ``python -m ladder_tpu_torch.freeze_bn``'s main
   over 8 train batches of the float32 checkpoint and an InferenceEngine
   serving it with those BatchNorm statistics. Checks: the native reader,
   the first 2 batches of epoch 1 on the card and equal to the host's read,
   finite curves, the result npz keys, GM_prior_info.npz, both checkpoint
   groups rewritten and read back, the resume, each epoch's launches of the
   five kernels against what its steps and evaluations launch, the bf16
   first-step loss within 5% of a float32 single-pass step on the same
   batch and noise, and a row served alone equal to the same row in a batch
   of 64. Logs the data build, the reader's time per batch, the epochs as
   phase 5 does, freeze_bn's time, and a profile of 10 train steps fed by
   the prefetch thread.
7. SLP interpolation through ``python -m ladder_tpu_torch.interpolate``'s
   run() on the card: the pretrained mnist_digit model (linear, then
   random init from the fitted GM) and the pretrained CelebA-128 model
   (linear init, on phase 6's TFRecords), each with the accurate GM fit,
   the two validation embeddings (images 0 and 32), 500 Adam iterations
   over 8 points and the SLP and SP strips decoded. Checks: finite
   histories, the linear init's path beating the straight line on neg-LL
   and the objective, the same optimisation on the CPU from the card's
   GM, start, end and initial points (its first 20 iterations, its end),
   the strips finite in [0, 1], and the norm-chain launches of the CelebA
   decodes against their count. Then the train CLI's main on the
   pretrained mnist_fashion model for 1 epoch and on a 'GMM'-prior
   mnist_digit model from a fresh init for 2 epochs: the result npz keys,
   GM_prior_info.npz, finite curves, each epoch's Adam launches. Logs the
   fits, the SLP's seconds and its kernels per iteration (a profile of 5
   iterations), and the runs' epochs.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result.
``--only build|kernels|serving|training|mnist|celeba|interp`` runs a part
of it (for debugging; it then prints no result lines either).

    python3 chip_smoke.py --ab DIR [--out ab.json]

compares another checkout's kernels with this one's on one card: the
norm-chain forward at the four decoder stages and the Adam update over the
encoder+decoder group, held against their plain versions and timed by
phase 2's functions (``--only times``), with DIR's ladder_tpu_torch, this
one's twice, and DIR's again, each in a process of its own; one JSON line
per run, then a summary line.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from itertools import islice

import numpy as np

from kernel_times import call_ms, device_ms, host_ms, l2_flusher, smi_line

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "demo/celeba_config.json"
MNIST_CONFIG = "demo/mnist_digit_config.json"
# Phase 5: the pretrained mnist_digit model at its published widths on
# synthetic MNIST at MNIST's split sizes, 2 epochs, then resumed to 3.
MNIST_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 60000,
                   "synthetic_n_test": 10000, "num_epochs": 2,
                   "sg_pretraining": 1, "accurate_fit": 2,
                   "enable_plots": 0}
MNIST_PROFILE_STEPS = 10
# Phase 6: the pretrained CelebA-128 'ours' model at its published widths
# (demo/celeba_config.json) on the demo's synthetic split sizes (1,024 train,
# 256 validation, 128 test images: 16 steps and 4 validation batches an
# epoch), 2 epochs in float32 then resumed to 3, and 1 epoch in bf16.
CELEBA_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 1024,
                    "synthetic_n_val": 256, "synthetic_n_test": 128,
                    "enable_plots": 0, "num_epochs": 2, "sg_pretraining": 1,
                    "accurate_fit": 2}
CELEBA_PROFILE_STEPS = 10
# train batches of the recalibration pass (python -m ladder_tpu_torch.freeze_bn)
FREEZE_BATCHES = 8
# the first batches of epoch 1 held against the host's read of their indices
CHECKED_BATCHES = 2
# bf16 first-step loss vs float32 single-pass loss on the same batch and
# noise (tests/test_perf_modes.py's band for ladder_tpu's bf16 mode)
BF16_LOSS_RTOL = 0.05
# frozen BatchNorm: a row encoded alone vs in a batch of 64, max abs over
# code mean and std (the same arithmetic on other batch shapes)
FROZEN_ROW_MAX_ABS = 1e-4
CELEBA_GM_WEIGHT_SUM_TOL = 1e-5
# Phase 7: SLP interpolation (python -m ladder_tpu_torch.interpolate's run)
# of the pretrained mnist_digit and CelebA-128 models at their published
# widths, the notebook's path (validation images 0 -> 32, 8 steps, 500
# Adam iterations), on the demo configs' synthetic data.
INTERP_ARGS = ("--idx-start", "0", "--idx-end", "32", "--n-step", "8",
               "--n-iter", "500")
INTERP_MNIST_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 8192,
                          "synthetic_n_test": 2048}
INTERP_CELEBA_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 1024,
                           "synthetic_n_val": 256, "synthetic_n_test": 128}
INTERP_PROFILE_ITERS = 5
# The same optimisation on the CPU from the card's GM, start, end and
# initial points. Before the first update (iteration 0) the objective and
# its parts agree to rounding: INTERP_START_RTOL relative (the step
# variance: of the straight line's mean segment). Then, from the straight
# line, whose segments are equal to rounding, the step variance's gradient
# takes a direction set by rounding noise, Adam turns each component's
# sign into a step of lr, and the two runs part at once (from a random
# init they part once the path's segments have equalised): the mnist
# model's linear run measured (H100, PERF.md) over its first 20
# iterations obj 6.0e-3, path length 2.4e-2, neg-LL 1.7e-2 relative and
# the step variance 3.3e-2 of a mean segment of 0.061 (lr 0.01 is a sixth
# of it); at the end obj 1.1e-2 and the points 0.30 segments.
# Held: the first INTERP_CPU_ITERS iterations within INTERP_CPU_RTOL
# (relative; the step variance of a mean segment), the final objective
# within INTERP_FINAL_RTOL, the final points within INTERP_FINAL_SEGMENTS
# mean segments. The iteration where the runs part (a gap over
# INTERP_PART_RTOL) is printed.
INTERP_START_RTOL = 1e-5
INTERP_CPU_ITERS = 20
INTERP_CPU_RTOL = 1e-1
INTERP_FINAL_RTOL = 5e-2
INTERP_FINAL_SEGMENTS = 1.0
INTERP_PART_RTOL = 1e-4
# Phase 7's trainer runs of the other priors and family: the pretrained
# mnist_fashion 'ours' model for 1 epoch on its demo config's synthetic
# split; a 'GMM'-prior mnist_digit model from a fresh init for 2 epochs on
# 8,192 synthetic images, so that epoch 2 trains on the jittered EM fit of
# epoch 1 and writes GM_prior_info.npz.
FASHION_CONFIG = "demo/mnist_fashion_config.json"
FASHION_OVERRIDES = {"synthetic_data": 1, "num_epochs": 1,
                     "enable_plots": 0}
GMM_OVERRIDES = {"prior": "GMM", "synthetic_data": 1,
                 "synthetic_n_train": 8192, "synthetic_n_test": 2048,
                 "num_epochs": 2, "sg_pretraining": 1, "load_model": 0,
                 "enable_plots": 0}
# the {exp}-result.npz keys that ladder_tpu writes (ladder_tpu/utils/
# metrics.py:save, the reference's base.py:791-823); the card's machine has
# no JAX to ask
RESULT_KEYS = (
    "iter_list_val", "n_train_iter", "n_val_iter", "train_loss",
    "elbo_train", "val_loss", "elbo_val", "train_loss_prior",
    "val_loss_prior", "code_elbo_train", "code_elbo_val",
    "recons_loss_train", "recons_loss_val", "recons_loss_prior_train",
    "recons_loss_prior_val", "entropy_z_train", "entropy_z_val",
    "entropy_t_train", "entropy_t_val", "crossentropy_z_train",
    "crossentropy_z_val", "crossentropy_t_train", "crossentropy_t_val",
    "vampPrior_crossEntropy_z_train_prior",
    "vampPrior_crossEntropy_z_val_prior", "sigma_regularisor_train",
    "sigma_regularisor_val", "num_para_VAE", "sigma")
# GM_prior_info.npz's full weights sum to one (float32 sums of 50 terms)
GM_WEIGHT_SUM_TOL = 1e-4
SERVE_BATCH = 64
# The decoder's style stages at batch 64: (NCHW shape, how many of the four
# run at it per decode).
NORM_CHAIN_STAGES = (((64, 512, 2, 2), 2), ((64, 256, 16, 16), 1),
                     ((64, 128, 64, 64), 1))
# the stage whose input (16.8 MB in float32) fits the 50 MB L2 cache: also
# timed with the cache flushed before every launch
L2_RESIDENT_STAGE = (64, 256, 16, 16)
# in the profiler's name of PyTorch's elementwise kernel for torch.neg
# (at::native::neg_kernel_cuda)
STREAM_MARKS = ("neg",)
# kernel vs plain version, same inputs on the card:
#  float32: allclose with rtol = atol = 1e-5 (sums in another order);
#  bfloat16: one bf16 ulp of the plain output, 2**(e-7) for |y| in
#  [2**e, 2**(e+1)), plus 1e-6 absolute near zero, where one ulp is smaller
#  than the float32 difference of the two versions' statistics.
FP32_TOL = 1e-5
# The norm-chain forward's variant at each stage shape (ops/norm_chain.py:
# FORWARD_PATHS), in float32 and bf16.
NORM_CHAIN_STAGE_PATHS = {(64, 512, 2, 2): "thread per plane",
                          (64, 256, 16, 16): "group of 16",
                          (64, 128, 64, 64): "ring"}
# Norm-chain forward inputs off the main path, checked against the plain
# version: (case, NCHW shape, elements by which x starts past an aligned
# allocation: 4 bytes in float32, 2 in bf16; the variant in float32, in
# bf16).
NORM_CHAIN_OTHER_SHAPES = (
    ("odd plane", (3, 5, 7, 9), 0, "generic", "generic"),
    ("plane above the ring", (2, 3, 192, 192), 0, "generic", "generic"),
    ("32x32 planes", (2, 5, 32, 32), 0, "ring", "ring"),
    ("64x128 planes, at the ring's bound in bf16", (1, 3, 64, 128), 0,
     "generic", "ring"),
    ("24x24 planes", (2, 6, 24, 24), 0, "generic", "generic"),
    ("30x34 planes", (1, 3, 30, 34), 0, "generic", "generic"),
    ("2x4 planes", (2, 3, 2, 4), 0, "group of 16", "group of 16"),
    ("4x4 planes, planes not a multiple of a block", (3, 5, 4, 4), 0,
     "group of 16", "group of 16"),
    ("2x2 planes, x unaligned", (4, 8, 2, 2), 1, "generic", "generic"),
    ("16x16 planes, x unaligned", (4, 8, 16, 16), 1, "generic", "generic"),
    ("64x64 planes, x unaligned", (2, 4, 64, 64), 1, "generic", "generic"),
)
BF16_NEAR_ZERO = 1e-6
# GPU engine (TF32 off) vs CPU engine, float32 images in [0, 1]: the two
# run the same ops with other summation orders, which the 2x2 instance
# norms and the batch-statistic BatchNorm amplify; measured 3e-6 on an
# H100 (PERF.md), bound set 30x above that.
GPU_CPU_MAX_ABS = 1e-4
# bfloat16 engine vs float32 engine on the same batch: mean absolute
# difference of the [0, 1] reconstructions (measured 0.0015 on an H100).
BF16_BAND_MEAN_ABS = 0.02
# Output-stage shapes of the main path: u [B,C,H,W], 3 output channels.
OUTPUT_STAGE_SHAPE = (64, 128, 128, 128)
# The derivative of leaky_relu jumps at y = 0, and which side an element
# with |y| below this falls on depends on the order of the fp32 sums behind
# y. The norm-chain backward is compared on the planes that hold no such
# element (over 90% of them must remain).
NORM_BWD_NEAR_ZERO = 1e-5
# Sums over up to a million products (dW8, db8, dscale, dshift), kernel vs
# plain version, both in fp32 in another order: relative to the largest
# entry (measured 1.4e-6 for dW8 on an H100).
SUM_RTOL = 2e-5
# Adam, kernel vs plain version after 3 updates (tests/test_pallas.py's
# tolerance for the TPU kernel against the same formula).
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
# tensors in the Adam check's largest group: more than one launch's table
ADAM_MANY = 300
TRAIN_BATCH = 64
TRAIN_STEPS = 4          # per mode; the first is not timed
TRAIN_CPU_BATCH = 8      # the step that is repeated on the CPU
# First train step, card vs CPU at batch 8, same weights, batch and noise.
# Metrics taken before any update (the 'ae' metrics; in the single-pass mode
# all of them) agree within rtol 2e-4: the same ops in another summation
# order (measured 3e-5 on an H100). At t = 1 Adam moves every parameter by
# lr * sign(g) whatever |g| is, so a gradient of rounding size that changes
# sign moves its parameter by 2 lr: parameters agree within 2.5 lr
# everywhere and within 0.1 lr on average (measured 2 and 0.01), and the
# sequential mode's later metrics, taken on parameters that already differ
# so, within rtol 5e-3 (measured 6e-4).
TRAIN_METRIC_RTOL = 2e-4
TRAIN_LATER_METRIC_RTOL = 5e-3
TRAIN_PARAM_MAX_LR, TRAIN_PARAM_MEAN_LR = 2.5, 0.1
# Peak rates (NVIDIA data sheets, dense): memory bytes/s and float32
# FLOP/s outside the tensor cores, by card name.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, peaks in PEAKS.items():
        if all(part in name for part in key.split()):
            return key, peaks
    log(f"  no peak rates known for {name!r}; bounds use the H100 SXM's")
    return "H100", PEAKS["H100"]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bf16_ulp(y):
    import torch
    a = y.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _times(run, plain, iters, marks, flush=None):
    """Device time and call time of a kernel's wrapper and the call time of
    its plain version. ``ms`` is the device time; with flush (inputs that
    would stay in the L2 cache between launches) it is taken with the cache
    flushed before every launch, its inputs from device memory as the bound
    assumes, and ``device_ms_warm`` keeps the time with them left in it."""
    dev, seen = device_ms(run, iters, marks)
    out = {"ms": dev, "device_ms": dev, "call_ms": call_ms(run, iters),
           "plain_ms": call_ms(plain, iters), "kernels_per_call": seen}
    if flush is not None:
        flushed = device_ms(run, iters, marks, flush)[0]
        out.update(ms=flushed, device_ms=flushed, device_ms_warm=dev,
                   device_ms_l2_flushed=flushed)
    return out


def _fmt_times(t):
    warm = t.get("device_ms_warm")
    return (f"device {t['device_ms'] * 1e3:.2f} us"
            + (f" with L2 flushed ({warm * 1e3:.2f} us warm)" if warm
               else "")
            + f"  call {t['call_ms'] * 1e3:.2f} us  plain "
            f"{t['plain_ms'] * 1e3:.2f} us")


def _on_card(shape, dtype, fill, offset=0):
    """A contiguous CUDA tensor of ``shape`` holding ``fill`` (float32) in
    dtype, starting ``offset`` elements past an aligned allocation."""
    import torch
    n = math.prod(shape)
    t = torch.empty(n + offset, dtype=dtype, device="cuda")[offset:]
    return t.view(shape).copy_(fill)


def _norm_chain_inputs(shape, dtype, gen, offset=0):
    import torch
    b, c = shape[:2]
    x = _on_card(shape, dtype, 2.0 * torch.randn(shape, generator=gen,
                                                 device="cuda") + 0.5, offset)
    scale, shift = (
        (0.1 * torch.randn((b, c), generator=gen, device="cuda")).to(dtype)
        for _ in range(2))
    return x, scale, shift


def _forward_path(nc, x, want):
    """The norm-chain forward's variant for x; raises if it is not want."""
    path = nc.forward_path(x)
    if path != want:
        raise AssertionError(f"norm_chain {list(x.shape)} {x.dtype}: takes "
                             f"the {path!r} variant, expected {want!r}")
    return path


def norm_chain_cases(peaks, flush, paths=NORM_CHAIN_STAGE_PATHS):
    """Kernel vs plain version at every stage shape, float32 and bf16, timed
    beside PyTorch's elementwise y = -x; with paths, each stage's variant
    is asserted."""
    import torch
    from ladder_tpu_torch.ops import norm_chain as nc

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape, per_decode in NORM_CHAIN_STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            b, c = shape[:2]
            x, scale, shift = _norm_chain_inputs(shape, dtype, g)
            path = _forward_path(nc, x, paths[shape]) if paths else None
            got = nc.fused_instnorm_style_lrelu(x, scale, shift)
            torch.cuda.synchronize()
            want = nc.norm_chain_reference(x, scale, shift)
            err = _hold_rounded(f"norm_chain {shape} {dtype}", got, want,
                                dtype)
            iters = 200 if x.numel() < 1 << 20 else 50
            resident = shape == L2_RESIDENT_STAGE
            times = _times(
                lambda: nc.fused_instnorm_style_lrelu(x, scale, shift),
                lambda: nc.norm_chain_reference(x, scale, shift), iters,
                ("norm_chain_fwd",), flush if resident else None)
            # PyTorch's elementwise y = -x into another tensor: the same
            # bytes read and written, at what this card's memory delivers
            # to a plain streaming kernel
            y = torch.empty_like(x)
            times["stream_device_ms"] = device_ms(
                lambda: torch.neg(x, out=y), iters, STREAM_MARKS)[0]
            if resident:
                times["stream_device_ms_l2_flushed"] = device_ms(
                    lambda: torch.neg(x, out=y), iters, STREAM_MARKS,
                    flush)[0]
            itemsize = x.element_size()
            nbytes = 2 * x.numel() * itemsize + 2 * b * c * itemsize
            # flops per element: sum; sub, square, add; sub, mul, fma, select
            bound_ms, bound_by = _bound(nbytes, 8 * x.numel(), peaks)
            cases.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "stages_per_decode": per_decode, "path": path,
                "max_abs_err": err, **times, "bound_ms": bound_ms,
                "bound_by": bound_by})
            log(f"  norm_chain {list(shape)} {cases[-1]['dtype']} ({path}): "
                f"max_abs_err {err:.3g}  {_fmt_times(times)}  y = -x "
                f"{times['stream_device_ms'] * 1e3:.2f} us  bound "
                f"{bound_ms * 1e3:.2f} us")
    return cases


def norm_chain_other_cases():
    """Kernel vs plain version, checked only, on shapes and starts that take
    the forward's other variants (NORM_CHAIN_OTHER_SHAPES)."""
    import torch
    from ladder_tpu_torch.ops import norm_chain as nc

    g = torch.Generator(device="cuda").manual_seed(7)
    others = []
    for label, shape, offset, *paths in NORM_CHAIN_OTHER_SHAPES:
        for dtype, path in zip((torch.float32, torch.bfloat16), paths):
            x, scale, shift = _norm_chain_inputs(shape, dtype, g, offset)
            _forward_path(nc, x, path)
            got = nc.fused_instnorm_style_lrelu(x, scale, shift)
            torch.cuda.synchronize()
            want = nc.norm_chain_reference(x, scale, shift)
            name = f"norm_chain {label} {list(shape)} {dtype}"
            others.append({"case": label, "shape": list(shape),
                           "dtype": str(dtype).split(".")[-1],
                           "offset": offset, "path": path,
                           "max_abs_err": _hold_rounded(name, got, want,
                                                        dtype)})
    log("  norm_chain, other shapes and starts: "
        + "; ".join(f"{o['case']} {o['dtype']} ({o['path']}) "
                    f"{o['max_abs_err']:.3g}" for o in others))
    return others


def norm_chain_entry(cases, launches):
    """One JSON entry: the per-decode (four stages, float32) totals."""
    return per_decode_entry("norm_chain_fwd",
                            "ladder_tpu/ops/pallas_kernels.py:46", cases,
                            launches)


def _bound(nbytes, nflops, peaks):
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, nflops / peaks[1] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _hold(name, got, want, rtol, atol):
    """max abs error of got against want; raises outside the tolerance."""
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{name}: max error {err.max().item()} outside "
                             f"rtol {rtol} atol {atol}")
    return err.max().item()


def _hold_rounded(name, got, want, dtype):
    """Elementwise results in the working dtype: float32 within FP32_TOL,
    bfloat16 within one ulp of the plain result (a rounding that flips)."""
    import torch
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= FP32_TOL + FP32_TOL * want.float().abs()).all())
    else:
        ok = bool((err <= _bf16_ulp(want) + BF16_NEAR_ZERO).all())
    if not ok:
        raise AssertionError(f"{name}: max error {err.max().item()} outside "
                             "tolerance")
    return err.max().item()


def norm_chain_bwd_cases(peaks, flush):
    """Backward kernel vs plain version at every stage shape."""
    import torch
    from ladder_tpu_torch.ops import norm_chain as nc

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for shape, per_decode in NORM_CHAIN_STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            b, c = shape[:2]
            x = (2.0 * torch.randn(shape, generator=gen, device="cuda")
                 + 0.5).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            scale = (0.1 * torch.randn((b, c), generator=gen,
                                       device="cuda")).to(dtype)
            shift = (0.1 * torch.randn((b, c), generator=gen,
                                       device="cuda")).to(dtype)
            got = nc.norm_chain_backward(g, x, scale, shift)
            torch.cuda.synchronize()
            want = nc.norm_chain_bwd_reference(g, x, scale, shift)
            # planes whose every |y| is clear of the leaky kink
            xf = x.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
            y = ((xf - mean) * torch.rsqrt(var + 1e-6)
                 * (scale.float() + 1.0)[:, :, None, None]
                 + shift.float()[:, :, None, None])
            clear = (y.abs() >= NORM_BWD_NEAR_ZERO).all(dim=3).all(dim=2)
            share = clear.float().mean().item()
            if share < 0.9:
                raise AssertionError(f"norm_chain_bwd {shape}: only "
                                     f"{share:.1%} of planes compared")
            name = f"norm_chain_bwd {shape} {dtype}"
            errs = [_hold_rounded(name + " dx", got[0][clear],
                                  want[0][clear], dtype)]
            # dscale, dshift: fp32 sums over the plane in another order
            for part, a, w in (("dscale", got[1], want[1]),
                               ("dshift", got[2], want[2])):
                errs.append(_hold(f"{name} {part}", a[clear], w[clear],
                                  SUM_RTOL, SUM_RTOL * w.abs().max().item()))
            for a in got:
                if not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"{name}: non-finite output")
            iters = 200 if x.numel() < 1 << 20 else 50
            times = _times(
                lambda: nc.norm_chain_backward(g, x, scale, shift),
                lambda: nc.norm_chain_bwd_reference(g, x, scale, shift),
                iters, ("norm_chain_bwd",),
                flush if shape == L2_RESIDENT_STAGE else None)
            itemsize = x.element_size()
            nbytes = 3 * x.numel() * itemsize + 2 * b * c * (itemsize + 4)
            bound_ms, bound_by = _bound(nbytes, 20 * x.numel(), peaks)
            cases.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "stages_per_decode": per_decode, "max_abs_err": max(errs),
                "planes_compared": share, **times, "bound_ms": bound_ms,
                "bound_by": bound_by})
            log(f"  norm_chain_bwd {list(shape)} {cases[-1]['dtype']}: "
                f"max_abs_err {max(errs):.3g} on {share:.1%} of planes  "
                f"{_fmt_times(times)}  bound {bound_ms * 1e3:.2f} us")
    return cases


def per_decode_entry(name, replaces, cases, launches):
    """One JSON entry for a norm-chain kernel: the per-decode (four stages,
    float32) totals. ``ms`` and ``device_ms`` take the 16x16 stage with the
    L2 cache flushed (its input from device memory, as the bound assumes);
    ``device_ms_warm`` takes it with its input left in the L2 cache."""
    f32 = [c for c in cases if c["dtype"] == "float32"]

    def per_decode(key, fallback=None):
        return sum(c.get(key, c.get(fallback)) * c["stages_per_decode"]
                   for c in f32)

    device = per_decode("device_ms_l2_flushed", "device_ms")
    return {"name": name, "route": "cuda",
            "source": "ladder_tpu_torch/csrc/norm_chain.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": device, "device_ms": device,
            "device_ms_warm": per_decode("device_ms_warm", "device_ms"),
            "call_ms": per_decode("call_ms"),
            "plain_ms": per_decode("plain_ms"),
            "bound_ms": per_decode("bound_ms"), "bound_by": "bytes"
            if all(c["bound_by"] == "bytes" for c in f32) else "operations",
            "library_ms": None, "dtype": "float32",
            "shape": "one decode at batch 64: [64,512,2,2] x2, "
                     "[64,256,16,16], [64,128,64,64] (NCHW)",
            "cases": cases}


def output_stage_cases(peaks):
    """Output-stage forward and backward kernels vs their plain versions at
    the main path's shape. Returns (forward cases, backward cases)."""
    import torch
    from ladder_tpu_torch.ops import output_stage as ost

    b, c, h, w = OUTPUT_STAGE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    weight = 0.2 * torch.randn((3, c), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((3,), generator=gen, device="cuda")
    target = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    ddec = 0.01 * torch.randn((b, 3, h, w), generator=gen, device="cuda")
    # gradients of l1_sum and l2_sum of the size a train step sends
    a1 = torch.tensor(0.03, device="cuda")
    a2 = torch.tensor(0.01, device="cuda")
    fwd, bwd = [], []
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).split(".")[-1]
        u = torch.randn((b, c, h, w), generator=gen,
                        device="cuda").to(dtype)
        dec, l1, l2 = ost.fused_output_recon(u, weight, bias, target)
        torch.cuda.synchronize()
        dec_p, l1_p, l2_p = ost.output_recon_reference(u, weight, bias,
                                                       target)
        errs = [_hold_rounded(f"output_stage_fwd {label} dec", dec, dec_p,
                              dtype)]
        for part, a, p_ in (("l1", l1, l1_p), ("l2", l2, l2_p)):
            _hold(f"output_stage_fwd {label} {part}", a, p_, 1e-5, 0.0)
        iters = 20
        times = _times(
            lambda: ost.fused_output_recon(u, weight, bias, target),
            lambda: ost.output_recon_reference(u, weight, bias, target),
            iters, ("output_stage_fwd", "sum_loss_partials"))
        pixels = b * h * w
        nbytes = (u.numel() * u.element_size() + 2 * 3 * pixels * 4
                  + 4 * (weight.numel() + bias.numel() + 2))
        bound_ms, bound_by = _bound(nbytes, pixels * (2 * 3 * c + 2 * c + 12),
                                    peaks)
        fwd.append({"shape": [b, c, h, w], "dtype": label,
                    "max_abs_err": max(errs),
                    "l1_rel_err": abs(l1.item() / l1_p.item() - 1),
                    "l2_rel_err": abs(l2.item() / l2_p.item() - 1),
                    **times, "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  output_stage_fwd {[b, c, h, w]} {label}: dec max_abs_err "
            f"{max(errs):.3g}, l1 rel {fwd[-1]['l1_rel_err']:.2g}, l2 rel "
            f"{fwd[-1]['l2_rel_err']:.2g}  {_fmt_times(times)}  bound "
            f"{bound_ms * 1e3:.2f} us")

        for with_ddec in (False, True):
            dd = ddec if with_ddec else None
            got = ost.output_recon_backward(u, weight, dec, target, a1, a2,
                                            dd)
            torch.cuda.synchronize()
            want = ost.output_recon_bwd_reference(u, weight, dec, target, a1,
                                                  a2, dd)
            name = f"output_stage_bwd {label} ddec={with_ddec}"
            errs = [_hold_rounded(name + " du", got[0], want[0], dtype)]
            largest = []
            for part, a, p_ in (("dW8", got[1], want[1]),
                                ("db8", got[2], want[2])):
                largest.append(p_.abs().max().item())
                errs.append(_hold(f"{name} {part}", a, p_, SUM_RTOL,
                                  SUM_RTOL * largest[-1]))
            times = _times(
                lambda: ost.output_recon_backward(u, weight, dec, target, a1,
                                                  a2, dd),
                lambda: ost.output_recon_bwd_reference(u, weight, dec, target,
                                                       a1, a2, dd),
                iters, ("output_stage_bwd", "sum_partials_kernel"))
            nbytes = (2 * u.numel() * u.element_size()
                      + (3 if with_ddec else 2) * 3 * pixels * 4
                      + 4 * (2 * weight.numel() + bias.numel() + 2))
            bound_ms, bound_by = _bound(nbytes, pixels * (14 * c + 20), peaks)
            bwd.append({"shape": [b, c, h, w], "dtype": label,
                        "ddec": with_ddec, "max_abs_err": max(errs),
                        "du_max_abs_err": errs[0], "dw_max_abs_err": errs[1],
                        "db_max_abs_err": errs[2],
                        "dw_largest": largest[0], "db_largest": largest[1],
                        **times, "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"  output_stage_bwd {[b, c, h, w]} {label} ddec="
                f"{with_ddec}: max_abs_err du {errs[0]:.3g} dW8 "
                f"{errs[1]:.3g} (largest entry {largest[0]:.4g}) db8 "
                f"{errs[2]:.3g} (largest {largest[1]:.4g})  "
                f"{_fmt_times(times)}  bound {bound_ms * 1e3:.2f} us")
        del u, dec, dec_p, got, want
        torch.cuda.empty_cache()
    return fwd, bwd


def output_stage_entry(name, replaces, cases, launches):
    """One JSON entry: the float32 case the train step runs (the backward
    without a gradient for decoded)."""
    main = next(c for c in cases
                if c["dtype"] == "float32" and not c.get("ddec"))
    return {"name": name, "route": "cuda",
            "source": "ladder_tpu_torch/csrc/output_stage.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "device_ms": main["device_ms"], "call_ms": main["call_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "dtype": "float32", "shape": f"u {main['shape']} (NCHW)",
            "cases": cases}


def _adam_groups(cfg, mnist_cfg=None):
    """name -> [(parameter, offset)]: the CelebA h=512 model's
    encoder+decoder group and a one-element group, and the mnist_digit
    model's (h=256) encoder+decoder and inner-VAE groups (the main paths',
    timed), then groups that are only checked: tensors of 1, 3 and 5
    elements, tails and an unaligned start (offset: the elements by which a
    tensor and its gradient and moments start past an aligned allocation),
    and more tensors than one launch's argument table holds."""
    import torch
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.step import group_params

    def group(m, keys):
        return [(p.detach().clone(), 0)
                for p in group_params(m, keys).values()]

    model = make_model(cfg, seed=3).to("cuda")
    groups = {"ae": group(model, ("encoder", "decoder")),
              "scalar": [(torch.tensor(0.5, device="cuda"), 0)]}
    del model
    if mnist_cfg is not None:  # (--ab runs packages without the mnist models)
        mnist = make_model(mnist_cfg, seed=3).to("cuda")
        groups.update(mnist_ae=group(mnist, ("encoder", "decoder")),
                      mnist_prior=group(mnist, ("prior",)))
        del mnist
    gen = torch.Generator(device="cuda").manual_seed(5)
    rand = lambda n: torch.randn(n, generator=gen, device="cuda")
    groups["tails"] = [(rand(1), 0), (rand(3), 0), (rand(5), 0),
                       (rand(1000), 1), (rand(4099), 0),
                       (rand(3 * 2048 + 1), 0)]
    sizes = np.random.default_rng(6).integers(1, 5000, size=ADAM_MANY)
    groups["many"] = [(rand(int(n)), 0) for n in sizes]
    return groups


def _adam_state(params, gen):
    """(kernel state, plain state, gradients) for [(parameter, offset)]:
    the kernel's tensors start ``offset`` elements past an aligned
    allocation; half of a gradient's elements are exactly zero."""
    import torch
    shapes = [p.shape for p, _ in params]
    kernel = ([_on_card(p.shape, torch.float32, p, off) for p, off in params],
              [_on_card(p.shape, torch.float32, 0.0, off)
               for p, off in params],
              [_on_card(p.shape, torch.float32, 0.0, off)
               for p, off in params])
    plain = ([p.clone() for p, _ in params],
             [torch.zeros_like(p) for p, _ in params],
             [torch.zeros_like(p) for p, _ in params])
    grads = [_on_card(s, torch.float32,
                      3.0 * torch.randn(s, generator=gen, device="cuda")
                      * (torch.rand(s, generator=gen, device="cuda")
                         < (0.5 if math.prod(s) > 1 else 1.0)), off)
             for s, (_, off) in zip(shapes, params)]
    return kernel, plain, grads


def _adam_steps(name, state, grads, steps):
    """Updates t in steps of both states; holds the kernel's against the
    plain version's; returns the largest error."""
    import torch
    from ladder_tpu_torch.ops import adam
    from ladder_tpu_torch.training.optim import ADAM_B1, ADAM_B2, ADAM_EPS

    before = adam.adam_update_.launches
    for t in steps:
        adam.adam_update_(*_with_grads(state["kernel"], grads), 2.5e-4, t,
                          ADAM_B1, ADAM_B2, ADAM_EPS)
        adam.adam_update_reference(
            *_with_grads(state["plain"], grads),
            adam.bias_corrected_lr(2.5e-4, t, ADAM_B1, ADAM_B2), ADAM_B1,
            ADAM_B2, ADAM_EPS)
    torch.cuda.synchronize()
    if adam.adam_update_.launches - before != len(steps):
        raise AssertionError("adam: one launch count per group update "
                             "expected")
    err = 0.0
    for part, got, want in zip(("p", "m", "v"), state["kernel"],
                               state["plain"]):
        for a, w in zip(got, want):
            err = max(err, _hold(f"adam {name} {part}", a, w, ADAM_RTOL,
                                 ADAM_ATOL))
    return err


def _check_nonfinite_guard(name, state, grads):
    """The non-finite guard's kernel on the group: no flag on finite
    gradients, none for an infinity (it clips to +-1), a flag for a NaN in
    the last tensor's last element."""
    import torch
    from ladder_tpu_torch.ops import adam

    params, m, v = state
    last = grads[-1].view(-1)
    kept = last[-1].item()
    seen = []
    for value in (kept, float("inf"), float("nan")):
        last[-1] = value
        seen.append(adam.any_nonfinite(params, grads, m, v))
    last[-1] = kept
    if seen != [False, False, True]:
        raise AssertionError(f"adam {name}: the non-finite guard saw {seen} "
                             "for a finite value, an infinity and a NaN")
    torch.cuda.synchronize()


ADAM_TIMED = ("ae", "scalar", "mnist_ae", "mnist_prior")


def adam_cases(cfg, peaks, names=None, mnist_cfg=None, flush=None):
    """The Adam kernel vs its plain version over three updates of each group
    of _adam_groups (or those of names), gradients up to several units in
    size so that the clip acts; then, for the 'tails' group, a parameter
    tensor replaced by another and one more update. The main path's groups
    are timed."""
    import torch
    from ladder_tpu_torch.ops import adam
    from ladder_tpu_torch.training.optim import ADAM_B1, ADAM_B2, ADAM_EPS

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for name, params in _adam_groups(cfg, mnist_cfg).items():
        if names and name not in names:
            continue
        n = sum(p.numel() for p, _ in params)
        kernel, plain, grads = _adam_state(params, gen)
        state = {"kernel": kernel, "plain": plain}
        err = _adam_steps(name, state, grads, (1, 2, 3))
        moved = max((a - p).abs().max().item()
                    for a, (p, _) in zip(state["kernel"][0], params))
        if not moved > 0:
            raise AssertionError(f"adam {name}: parameters did not move")
        case = {"group": name, "tensors": len(params), "elements": n,
                "unaligned_tensors": sum(off > 0 for _, off in params),
                "max_abs_err": err}
        if name in ("tails", "many"):
            _check_nonfinite_guard(name, state["kernel"], grads)
        if name == "tails":
            # a parameter replaced by a tensor elsewhere in memory: the
            # group's cached plan must follow it
            old_plan = adam.group_plan(*_with_grads(state["kernel"], grads))
            for kind in ("kernel", "plain"):
                state[kind][0][4] = state[kind][0][4].clone()
            case["max_abs_err_after_replacing_a_parameter"] = _adam_steps(
                name, state, grads, (4,))
            if adam.group_plan(*_with_grads(state["kernel"],
                                            grads)) is old_plan:
                raise AssertionError("adam: the plan was not rebuilt after "
                                     "a parameter was replaced")
        if name in ADAM_TIMED:
            iters = 50 if n > 1 << 20 else 200

            def update():
                adam.adam_update_(*_with_grads(state["kernel"], grads),
                                  2.5e-4, 4, ADAM_B1, ADAM_B2, ADAM_EPS)

            # the mnist groups (31 and 59 MB of p, g, m, v) fit or half
            # fit the 50 MB L2 cache: their ms is taken with it flushed
            case.update(_times(update, lambda: adam.adam_update_reference(
                *_with_grads(state["plain"], grads), 2.5e-4, ADAM_B1,
                ADAM_B2, ADAM_EPS), iters, ("adam_kernel",),
                flush if name.startswith("mnist") else None))
            # the wrapper's own time on the host (checks, address tables):
            # where it exceeds the device time, calls wait for the host
            case["host_ms"] = host_ms(update, 100)
            # torch's own fused Adam over the same tensors moves the same
            # bytes but computes another function (no clip, eps on the
            # corrected sqrt(v)): a yardstick, not a library_ms
            twins = [p.clone().requires_grad_(True) for p, _ in params]
            for p_, g in zip(twins, grads):
                p_.grad = g
            opt = torch.optim.Adam(twins, lr=2.5e-4,
                                   betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                   fused=True)
            case["torch_fused_adam_call_ms"] = call_ms(opt.step, iters)
            case["bound_ms"], case["bound_by"] = _bound(28 * n, 12 * n, peaks)
            del twins, opt
            log(f"  adam {name}: {len(params)} tensors, {n} elements, "
                f"max_abs_err {err:.3g} after 3 updates  {_fmt_times(case)}"
                f"  host {case['host_ms'] * 1e3:.2f} us  torch fused Adam "
                f"(another function) call "
                f"{case['torch_fused_adam_call_ms'] * 1e3:.2f} us  bound "
                f"{case['bound_ms'] * 1e3:.2f} us")
        else:
            log(f"  adam {name}: {len(params)} tensors, {n} elements, "
                f"{case['unaligned_tensors']} unaligned, max_abs_err "
                f"{err:.3g} after 3 updates"
                + (f", {case['max_abs_err_after_replacing_a_parameter']:.3g}"
                   " after replacing a parameter" if name == "tails" else ""))
        cases.append(case)
        del state, grads
        torch.cuda.empty_cache()
    return cases


def _with_grads(state, grads):
    params, m, v = state
    return params, grads, m, v


def adam_entry(cases, launches):
    main = next(c for c in cases if c["group"] == "ae")
    return {"name": "adam_update", "route": "cuda",
            "source": "ladder_tpu_torch/csrc/adam.cu",
            "replaces": "ladder_tpu/ops/pallas_adam.py:45",
            "launches": launches, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "device_ms": main["device_ms"],
            "call_ms": main["call_ms"], "host_ms": main["host_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "dtype": "float32",
            "shape": f"the encoder+decoder group: {main['tensors']} tensors, "
                     f"{main['elements']} elements", "cases": cases}


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def _post_npy(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def _check_images(name, imgs, n, cfg):
    shape = (n, cfg["dim_input_x"], cfg["dim_input_y"],
             cfg["dim_input_channel"])
    if imgs.shape != shape or imgs.dtype != np.float32:
        raise AssertionError(f"{name}: {imgs.shape} {imgs.dtype}, "
                             f"expected {shape} float32")
    if not np.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 1:
        raise AssertionError(f"{name}: values outside [0, 1]")


def drive_serving(cfg, device):
    """Drive every serving path once on ``device`` and check it; returns
    what the main path did. Kernel launches are counted from 0 for this
    run: 4 per decoding call on a CUDA device, none on the CPU."""
    import torch
    from ladder_tpu_torch import serve as cli
    from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu
    from ladder_tpu_torch.serving import Batcher, InferenceEngine

    per_decode = 4 if torch.device(device).type == "cuda" else 0
    counter = fused_instnorm_style_lrelu
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, device=device, serve_batch=SERVE_BATCH,
                          buckets=(1, 8))
    log(f"  engine on {device}: {time.perf_counter() - t0:.1f} s to load; "
        f"warmup {eng.warmup():.1f} s")
    rng = np.random.default_rng(0)
    hw = (cfg["dim_input_x"], cfg["dim_input_y"], cfg["dim_input_channel"])
    x64 = rng.random((SERVE_BATCH,) + hw, dtype=np.float32)
    code, rep = cfg["code_size"], cfg["representation_size"]
    calls = []

    def call(name, fn, *args, decodes, **kw):
        before = counter.launches
        out = fn(*args, **kw)
        delta = counter.launches - before
        calls.append((name, delta))
        if delta != per_decode * decodes:
            raise AssertionError(f"{name}: {delta} norm-chain launches, "
                                 f"expected {per_decode * decodes}")
        return out

    counter.launches = 0
    recon = call("reconstruct[64]", eng.reconstruct, x64, decodes=1)
    _check_images("reconstruct[64]", recon, SERVE_BATCH, cfg)
    recon3 = call("reconstruct[3]", eng.reconstruct, x64[:3], decodes=1)
    _check_images("reconstruct[3]", recon3, 3, cfg)
    mean, std = call("encode", eng.encode, x64, decodes=0)
    t_mean, t_std = call("represent", eng.represent, x64, decodes=0)
    for name, a, width in (("code_mean", mean, code), ("code_std", std, code),
                           ("t_mean", t_mean, rep), ("t_std", t_std, rep)):
        if a.shape != (SERVE_BATCH, width) or not np.isfinite(a).all():
            raise AssertionError(f"{name}: shape {a.shape} or not finite")
    if not (std > 0).all() or not (t_std > 0).all():
        raise AssertionError("std heads must be positive")
    _check_images("decode", call("decode", eng.decode, mean[:8], decodes=1),
                  8, cfg)
    _check_images("decode_representation",
                  call("decode_representation", eng.decode_representation,
                       t_mean[:16], decodes=1), 16, cfg)
    _check_images("generate", call("generate", eng.generate, 16, seed=0,
                                   decodes=1), 16, cfg)
    logp = call("t_log_density", eng.t_log_density, t_mean, decodes=0)
    if logp.shape != (SERVE_BATCH,) or not np.isfinite(logp).all():
        raise AssertionError(f"t_log_density: {logp.shape} or not finite")

    eng16 = InferenceEngine(cfg, device=device, serve_batch=SERVE_BATCH,
                            buckets=(1, 8), dtype="bfloat16")
    recon16 = call("reconstruct[64] bf16", eng16.reconstruct, x64, decodes=1)
    _check_images("reconstruct bf16", recon16, SERVE_BATCH, cfg)
    bf16_mean_abs = float(np.abs(recon16 - recon).mean())
    log(f"  bf16 vs float32 reconstruct: mean abs {bf16_mean_abs:.4g}, "
        f"max abs {np.abs(recon16 - recon).max():.4g} "
        f"(band: mean abs <= {BF16_BAND_MEAN_ABS})")
    if not bf16_mean_abs <= BF16_BAND_MEAN_ABS:
        raise AssertionError("bf16 reconstruction outside its band")

    front = Batcher(eng, max_wait_ms=2.0)
    server = cli.make_http_server(front, 0)
    thread = threading.Thread(target=cli.serve_http,
                              args=(eng, front, server, True))
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/reconstruct"
        http = call("HTTP POST /reconstruct[3]", _post_npy, url, x64[:3],
                    decodes=1)
    finally:
        server.shutdown()
        thread.join(timeout=120)
    if thread.is_alive():
        raise AssertionError("HTTP server did not drain")
    http_err = float(np.abs(http - recon3).max())
    log(f"  HTTP round trip: {http.shape}, max abs vs engine {http_err:.3g}; "
        f"batching stats {front.stats}")
    if http_err > FP32_TOL:
        raise AssertionError("HTTP reconstruction differs from the engine's")
    launches = counter.launches

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = InferenceEngine(cfg, device="cpu", serve_batch=SERVE_BATCH,
                          buckets=(1, 8))
    recon_cpu = cpu.reconstruct(x64)
    gpu_cpu = float(np.abs(recon - recon_cpu).max())
    log(f"  {device} vs cpu reconstruct[64]: max abs {gpu_cpu:.4g}, "
        f"mean abs {np.abs(recon - recon_cpu).mean():.4g} (bound "
        f"{GPU_CPU_MAX_ABS}); cpu engine {time.perf_counter() - t0:.1f} s")
    if not gpu_cpu <= GPU_CPU_MAX_ABS:
        raise AssertionError("device reconstruction differs from CPU's")
    return {"engine": eng, "engine_bf16": eng16, "x": x64, "calls": calls,
            "launches": launches,
            "gpu_cpu_max_abs": gpu_cpu, "bf16_mean_abs": bf16_mean_abs}


def path_latencies(eng, x, repeats=10):
    """Median host wall time of each path at batch 64 (ms); every call ends
    in a device-to-host copy, so the device work is inside the window."""
    n = x.shape[0]
    mean, _ = eng.encode(x)
    t_mean, _ = eng.represent(x)
    paths = {"encode": (eng.encode, x), "reconstruct": (eng.reconstruct, x),
             "represent": (eng.represent, x), "decode": (eng.decode, mean),
             "decode_representation": (eng.decode_representation, t_mean),
             "generate": (lambda k: eng.generate(k, seed=1), n)}
    out = {}
    for name, (fn, arg) in paths.items():
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(arg)
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e3
    return out


def profile_reconstruct(eng, x):
    """Device time by kernel for one batch-64 reconstruction."""
    eng.reconstruct(x)
    profile_device("one reconstruct[64]", lambda: eng.reconstruct(x),
                   marks=("norm_chain",))


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def kernel_counters():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from ladder_tpu_torch.ops import adam, norm_chain, output_stage
    return {"norm_chain_fwd": norm_chain.fused_instnorm_style_lrelu,
            "norm_chain_bwd": norm_chain.norm_chain_backward,
            "output_stage_fwd": output_stage.fused_output_recon,
            "output_stage_bwd": output_stage.output_recon_backward,
            "adam_update": adam.adam_update_}


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def expected_step_launches(cfg, mode, device):
    """Launches of one train step with do_prior=True, from what the step
    does: the decoder runs four norm-chain stages and compute_loss one
    output stage per forward pass; only the pass that differentiates the
    decoder (the 'ae' group) runs their backward kernels; every group
    update is one Adam launch. Mode 1 takes one forward pass per group,
    mode 2 one for all groups."""
    import torch
    from ladder_tpu_torch.training.step import group_keys
    if torch.device(device).type != "cuda":
        return dict.fromkeys(kernel_counters(), 0)
    groups = len(group_keys(cfg))
    passes = groups if mode == 1 else 1
    return {"norm_chain_fwd": 4 * passes, "norm_chain_bwd": 4,
            "output_stage_fwd": passes, "output_stage_bwd": 1,
            "adam_update": groups}


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _new_state(cfg, mode, flax_params, device):
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.step import init_state, make_train_step
    model = make_model(dict(cfg, fused_train_step=mode))
    model.load_flax_params(flax_params)
    return init_state(model, device=device), make_train_step(model)


def _check_metrics(label, out):
    import torch
    from ladder_tpu_torch.training.step import _SCALAR_KEYS
    for group in ("ae", "prior"):
        missing = [k for k in _SCALAR_KEYS if k not in out[group]
                   and k != "decoded_z_std_loss"]
        if missing:
            raise AssertionError(f"{label}: out[{group!r}] lacks {missing}")
        for key, value in out[group].items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"{label}: {group}/{key} is not finite")
    if not bool(torch.isfinite(out["sigma"]["sigma"])):
        raise AssertionError(f"{label}: sigma is not finite")


def first_step_against_cpu(cfg, mode, flax_params, gm, images, lrs, device):
    """One step from the same weights, batch and noise on ``device`` and on
    the CPU; returns (largest relative difference of the metrics taken
    before any update, of those taken after one, largest and mean parameter
    difference in units of the group's lr)."""
    import torch
    from ladder_tpu_torch.training.losses import draw_noise
    from ladder_tpu_torch.training.step import group_keys, group_params

    gen = torch.Generator().manual_seed(7)
    groups = group_keys(cfg)
    draws = [draw_noise(cfg, images.shape[0], gen, "cpu")
             for _ in range(len(groups) if mode == 1 else 1)]
    runs = {}
    for where in (device, "cpu"):
        state, step = _new_state(cfg, mode, flax_params, where)
        noise = [{k: v.to(where) for k, v in d.items()} for d in draws]
        gm_w = {k: v.to(where) for k, v in gm.items()}
        state, out = step(state, images, None, gm_w, {}, lrs, True,
                          noise=noise)
        _sync(where)
        runs[where] = (state, out)
    (state_d, out_d), (state_c, out_c) = runs[device], runs["cpu"]
    metric_gap = later_gap = 0.0
    for group in out_c:
        before_updates = mode == 2 or group == "ae"
        for key, want in out_c[group].items():
            got = out_d[group][key].cpu()
            gap = ((got - want).abs() / (want.abs() + 1e-3)).max().item()
            if before_updates:
                metric_gap = max(metric_gap, gap)
            else:
                later_gap = max(later_gap, gap)
            if not gap <= (TRAIN_METRIC_RTOL if before_updates
                           else TRAIN_LATER_METRIC_RTOL):
                raise AssertionError(
                    f"mode {mode} {group}/{key}: {got.tolist()} on {device} "
                    f"vs {want.tolist()} on the CPU")
    worst, total, count = 0.0, 0.0, 0
    for name, keys in groups.items():
        lr = lrs["prior" if name == "z_std" else name]
        p_c = group_params(state_c["model"], keys)
        for key, p_d in group_params(state_d["model"], keys).items():
            diff = (p_d.detach().cpu() - p_c[key].detach()).abs() / lr
            worst = max(worst, diff.max().item())
            total += diff.sum().item()
            count += diff.numel()
    mean = total / count
    if not (worst <= TRAIN_PARAM_MAX_LR and mean <= TRAIN_PARAM_MEAN_LR):
        raise AssertionError(f"mode {mode}: parameters differ from the "
                             f"CPU's by {worst:.3g} lr at most, {mean:.3g} "
                             "lr on average")
    return metric_gap, later_gap, worst, mean


def drive_training(cfg, flax_params, gm, images, device, steps=TRAIN_STEPS,
                   cpu_batch=TRAIN_CPU_BATCH):
    """Train steps of both modes on ``device`` from the given weights, with
    every check of the phase; returns per mode the step times, the launch
    counts of the first step and of all steps, and the gaps to the CPU."""
    import torch
    from ladder_tpu_torch.training.schedules import all_lrs
    from ladder_tpu_torch.training.step import group_keys, group_params

    # the first epoch after the standard-gaussian pretraining
    lrs = all_lrs(cfg, cfg["sg_pretraining"] + 1)
    gen_device = "cuda" if torch.device(device).type == "cuda" else "cpu"
    results = {}
    for mode in (1, 2):
        label = f"mode {mode}"
        gaps = first_step_against_cpu(cfg, mode, flax_params, gm,
                                      images[:cpu_batch], lrs, device)
        state, step = _new_state(cfg, mode, flax_params, device)
        gm_d = {k: v.to(device) for k, v in gm.items()}
        generator = torch.Generator(device=gen_device).manual_seed(11)
        groups = group_keys(state["model"].config)
        before = {name: {k: p.detach().clone() for k, p in
                         group_params(state["model"], keys).items()}
                  for name, keys in groups.items()}
        x = torch.as_tensor(images).to(device)
        # A group whose gradient is rightly zero stays where it is: sigma
        # while the pixel-error floor is above it, inner_sigma outside its
        # clamp. The other groups must move.
        must_move = dict.fromkeys(groups, False)
        must_move.update(ae=True, prior=True)
        if "inner_sigma" in groups:
            inner = abs(state["model"].inner_sigma["inner_sigma"].item())
            must_move["inner_sigma"] = (cfg["inner_sigma_lb"] < inner
                                        < cfg["inner_sigma_ub"])
        times, losses = [], []
        first, total = None, dict.fromkeys(kernel_counters(), 0)
        for i in range(steps):
            reset_counters()
            _sync(device)
            t0 = time.perf_counter()
            state, out = step(state, x, generator, gm_d, {}, lrs, True)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            counts = read_counters()
            total = {k: total[k] + v for k, v in counts.items()}
            first = first or counts
            _check_metrics(f"{label} step {i}", out)
            losses.append(float(out["ae"]["loss_ae"]))
            must_move["sigma"] |= bool(out["ae"]["sigma"]
                                       > out["ae"]["mean_pixel_error"])
        want = expected_step_launches(state["model"].config, mode, device)
        if first != want:
            raise AssertionError(f"{label}: launches of one step {first}, "
                                 f"expected {want}")
        for name, keys in groups.items():
            if state["opt"][name]["t"] != steps:
                raise AssertionError(f"{label}: group {name} counted "
                                     f"{state['opt'][name]['t']} updates")
            now = group_params(state["model"], keys)
            moved = any(bool((now[k] != p).any())
                        for k, p in before[name].items())
            if must_move[name] and not moved:
                raise AssertionError(f"{label}: group {name} did not move")
            log(f"    {label}: group {name} took {steps} updates and "
                + ("moved" if moved else "stayed (zero gradient: sigma under "
                   "the pixel-error floor, or inner_sigma on its clamp)"))
        if state["step"] != steps:
            raise AssertionError(f"{label}: step counter {state['step']}")
        results[mode] = {
            "step_ms": times, "launches_per_step": first, "launches": total,
            "metric_gap": gaps[0], "later_metric_gap": gaps[1],
            "param_gap_max_lr": gaps[2], "param_gap_mean_lr": gaps[3],
            "state": state, "step": step,
            "loss_ae": losses,
            "args": (x, generator, gm_d, {}, lrs, True)}
    return results


def profile_device(label, fn, marks=()):
    """Device time by kernel for one call of fn, and the device's idle share
    of the call's wall time. marks: substrings whose kernels are summed.
    Returns the profile, or None when it recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((evt.self_device_time_total, evt.key, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and evt.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        log(f"  profile of {label}: no device time recorded (not measured)")
        return None
    shares = ", ".join(
        f"{mark} {sum(r[0] for r in rows if mark in r[1]) / 1e3:.3f} ms "
        f"({sum(r[0] for r in rows if mark in r[1]) / total:.2%})"
        for mark in marks)
    log(f"  profile of {label}: device activity {total / 1e3:.3f} ms in "
        f"{wall_us / 1e3:.3f} ms wall (idle share "
        f"{max(0.0, 1 - total / wall_us):.1%} with the profiler on), "
        f"{sum(r[2] for r in rows)} device kernels and copies; {shares}")
    for dev, key, count in rows[:18]:
        log(f"    {dev / 1e3:9.3f} ms {100 * dev / total:5.1f}%  x{count:<3d} "
            f"{key[:100]}")
    return prof


def copy_overlap(events, mark="Memcpy HtoD (Pinned"):
    """How much of the pinned host-to-device copies (the prefetch thread's)
    ran while a kernel ran: (copies, their microseconds, the share of
    those microseconds covered by kernels). events: the profile's device
    events (name, start us, end us)."""
    kernels, copies = [], []
    for name, start, end in events:
        (copies if name.startswith(mark) else kernels).append((start, end))
    merged = []
    for start, end in sorted(kernels):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    total = sum(end - start for start, end in copies)
    covered = sum(max(0.0, min(end, b) - max(start, a))
                  for start, end in copies for a, b in merged)
    return len(copies), total, (covered / total if total else None)


def device_events(prof):
    """(name, start us, end us) of every device event of a profile."""
    import torch
    return [(evt.name, evt.time_range.start, evt.time_range.end)
            for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA]


# ---------------------------------------------------------------------------
# phase 5: training the pretrained mnist_digit model through the trainer
# ---------------------------------------------------------------------------

class _Tee(io.TextIOBase):
    """Writes to every stream given (the console and a buffer)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def mnist_config(overrides=MNIST_OVERRIDES, path=MNIST_CONFIG):
    """The demo's mnist config at path (the pretrained model's widths) with
    the phase's overrides, defaults applied and validated."""
    from ladder_tpu_torch.utils.config import apply_defaults, validate_config
    with open(os.path.join(ROOT, path)) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    return validate_config(apply_defaults(cfg))


def _pretrained_mnist(cfg):
    """The pretrained mnist_digit weights (flax layout) and its GM
    (GM_prior_info.npz's full set, Cholesky factors) as CPU tensors."""
    import torch
    from ladder_tpu_torch.ops.distributions import gmm_cholesky
    from ladder_tpu_torch.utils.checkpoint import load_msgpack
    d = os.path.join(ROOT, "pretrained_models", cfg["exp_name"])
    params = {**load_msgpack(os.path.join(d, "vae-model.msgpack")),
              **load_msgpack(os.path.join(d, "prior-model.msgpack"))}
    with np.load(os.path.join(d, "GM_prior_info.npz")) as info:
        gm = {"weights": torch.tensor(info["w_full"]),
              "means": torch.tensor(info["m_full"]),
              "chols": gmm_cholesky(torch.tensor(info["K_full"]))}
    return params, gm


def adam_updates(trainer, t_before):
    """Each optimiser group's updates since ``t_before``, read from its
    Adam step count ``t``, which counts the group's updates."""
    return {g: o["t"] - t_before.get(g, 0)
            for g, o in trainer.state["opt"].items()}


def _run_train_cli(workdir, config_path, device):
    """ladder_tpu_torch.train.main in workdir (its result directory is
    relative to the working directory); (trainer, its console output,
    seconds, kernel launches)."""
    import contextlib
    from ladder_tpu_torch import train

    buf = io.StringIO()
    reset_counters()
    old = os.getcwd()
    os.chdir(workdir)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            trainer = train.main(["--config", config_path, "--device",
                                  device])
        _sync(device)
    finally:
        os.chdir(old)
    return trainer, buf.getvalue(), time.perf_counter() - t0, read_counters()


def _check_mnist_run(label, trainer, launches, want_epochs, t_before):
    """A run's checks: the epochs it trained, finite curves, every updated
    group updated in each step of an epoch, and one Adam launch per group
    update (steps x updated groups). Returns the groups' updates."""
    from ladder_tpu_torch.utils.metrics import BUFFER_NAMES
    cfg = trainer.config
    if [t["epoch"] for t in trainer.timings] != list(want_epochs):
        raise AssertionError(f"{label}: trained epochs "
                             f"{[t['epoch'] for t in trainer.timings]}, "
                             f"expected {list(want_epochs)}")
    for name in BUFFER_NAMES:
        values = getattr(trainer.metrics, name)
        if values and not np.isfinite(np.asarray(values, float)).all():
            raise AssertionError(f"{label}: the {name} curve is not finite")
    steps = trainer.n_train_iter()
    updates = adam_updates(trainer, t_before)
    if (updates["ae"] != steps * len(want_epochs)
            or any(n % steps for n in updates.values())):
        raise AssertionError(f"{label}: group updates {updates}, expected "
                             f"each updated group in every one of the "
                             f"{steps} steps of an epoch")
    want = sum(updates.values()) if trainer.device.type == "cuda" else 0
    if launches["adam_update"] != want:
        raise AssertionError(f"{label}: {launches['adam_update']} Adam "
                             f"launches, expected {want}")
    others = {k: v for k, v in launches.items() if k != "adam_update" and v}
    if others:
        raise AssertionError(f"{label}: the mnist path launched {others}")
    return updates


def _check_artifacts(trainer, copied_ns, work, w_tol=GM_WEIGHT_SUM_TOL):
    """The result npz spans the three epochs, GM_prior_info.npz holds a
    fit whose weights sum to one within w_tol with an active component,
    and both checkpoint groups were rewritten and read back by the port's
    reader as the model holds them."""
    from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, load_msgpack
    cfg = trainer.config
    result_dir = os.path.join(work, cfg["result_dir"])
    steps = trainer.n_train_iter()
    r = np.load(os.path.join(result_dir, f"{cfg['exp_name']}-result.npz"))
    lengths = {"train_loss": 3 * steps, "elbo_train": 3 * steps,
               "code_elbo_train": 3 * steps, "sigma": 3,
               "iter_list_val": 3, "val_loss": 3 * trainer.n_val_iter()}
    for key, n in lengths.items():
        if len(r[key]) != n or not np.isfinite(r[key]).all():
            raise AssertionError(f"result npz {key}: {len(r[key])} finite "
                                 f"values expected {n}")
    with np.load(os.path.join(result_dir, "GM_prior_info.npz")) as gm:
        w_sum = float(gm["w_full"].sum())
        n_active = len(gm["w_active"])
    if abs(w_sum - 1.0) > w_tol or n_active < 1:
        raise AssertionError(f"GM_prior_info.npz: full weights sum to "
                             f"{w_sum}, {n_active} active")
    params = trainer.model.flax_params()
    ckdir = os.path.join(work, cfg["checkpoint_dir"])
    for name, keys in (("vae-model", VAE_KEYS),
                       ("prior-model", ("prior", "inner_sigma"))):
        path = os.path.join(ckdir, f"{name}.msgpack")
        if os.stat(path).st_mtime_ns <= copied_ns:
            raise AssertionError(f"{name}.msgpack was not rewritten")
        saved = load_msgpack(path)
        _same_tree(name, saved, {k: params[k] for k in keys})
    return {"w_full_sum": w_sum, "active_mixtures": n_active,
            "result_keys": sorted(r.files)}


def _same_tree(label, a, b):
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            raise AssertionError(f"{label}: keys differ")
        for k in b:
            _same_tree(f"{label}/{k}", a[k], b[k])
    elif not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError(f"{label}: the checkpoint differs from the "
                             "model")


def _copy_groups(src, load_dir, exp):
    """The two checkpoint groups of src into load_dir/exp; returns the
    newest copy's mtime."""
    import shutil
    ckdir = os.path.join(load_dir, exp)
    os.makedirs(ckdir)
    for name in ("vae-model.msgpack", "prior-model.msgpack"):
        shutil.copy(os.path.join(src, name), ckdir)
    return max(os.stat(os.path.join(ckdir, n)).st_mtime_ns
               for n in os.listdir(ckdir))


def drive_mnist(device, overrides=MNIST_OVERRIDES,
                profile_steps=MNIST_PROFILE_STEPS, cpu_batch=TRAIN_CPU_BATCH):
    """Phase 5. The first train step from the pretrained weights against
    the CPU's; then ``python -m ladder_tpu_torch.train`` in this process
    (its main), 2 epochs from the pretrained checkpoint groups copied into
    a temporary checkpoint directory, and again with num_epochs 3, which
    resumes from the full train state. Every check of the phase; returns
    the runs, their launches and the gaps to the CPU."""
    import shutil
    import tempfile
    from ladder_tpu_torch.data.mnist import synthetic_mnist
    from ladder_tpu_torch.training.schedules import all_lrs

    cfg = mnist_config(overrides)
    params, gm = _pretrained_mnist(cfg)
    (x, _), _ = synthetic_mnist(n_train=cpu_batch, n_test=1, seed=cfg["seed"])
    images = (x.astype(np.float32) / 255.0)[..., None]
    lrs = all_lrs(cfg, cfg["sg_pretraining"] + 1)
    gaps = first_step_against_cpu(cfg, 1, params, gm, images, lrs, device)

    work = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    try:
        raw = dict(cfg, load_dir=work + "/")
        copied_ns = _copy_groups(
            os.path.join(ROOT, "pretrained_models", cfg["exp_name"]), work,
            cfg["exp_name"])
        runs = []
        t_before = {}  # the pretrained groups come without moments
        for epochs in ((1, 2), (3,)):
            path = os.path.join(work, f"epochs_{epochs[-1]}.json")
            with open(path, "w") as f:
                json.dump(dict(raw, num_epochs=epochs[-1]), f)
            trainer, out, seconds, launches = _run_train_cli(work, path,
                                                             device)
            label = f"mnist run to epoch {epochs[-1]}"
            updates = _check_mnist_run(label, trainer, launches, epochs,
                                       t_before)
            # the resumed run starts from the train state saved here
            t_before = {g: o["t"] for g, o in trainer.state["opt"].items()}
            runs.append({"trainer": trainer, "seconds": seconds,
                         "launches": launches, "group_updates": updates,
                         "epochs": epochs,
                         "data_seconds": trainer.data_seconds, "out": out})
        for line in ("Outer VAE model loaded.", "Prior model loaded."):
            if line not in runs[0]["out"]:
                raise AssertionError(f"the first run did not print {line!r}"
                                     ": the pretrained groups were not read")
        if "Full train state restored (epoch 2)." not in runs[1]["out"]:
            raise AssertionError("the second run did not resume from the "
                                 "full train state of epoch 2")
        artifacts = _check_artifacts(runs[-1]["trainer"], copied_ns,
                                           work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    trainer = runs[-1]["trainer"]
    if profile_steps and trainer.device.type == "cuda":
        batches = list(islice(trainer.train_batches(), profile_steps))
        args = (trainer.generator, trainer._gm_for_step(), trainer._flags(),
                trainer._lrs(), trainer._do_prior())

        def steps():
            for batch in batches:
                trainer.train_step(trainer.state, batch, *args)

        profile_device(f"{len(batches)} mnist_digit train steps at batch "
                       f"{cfg['batch_size']}", steps, marks=("adam_kernel",))
    return {"runs": runs, "gaps": gaps, "artifacts": artifacts, "cfg": cfg,
            "cpu_batch": cpu_batch}


def _log_epochs(trainer, bs):
    """Per epoch: wall, step time, steps/s, images/s, the dispatch median,
    the GM fits and the validation loop."""
    for t in trainer.timings:
        tr = t["train"]
        log(f"    epoch {t['epoch']}: {tr['steps']} steps in "
            f"{tr['wall_s']:.3f} s: step {tr['step_ms']:.2f} ms (epoch "
            f"wall / steps), dispatch median {tr['p50_ms']:.2f} ms, "
            f"{1e3 / tr['step_ms']:.2f} steps/s, "
            f"{tr['images_per_sec']:.1f} images/s at batch {bs}; "
            f"validation {t['val_s']:.3f} s"
            + (f"; launches {t['launches']}" if "launches" in t else ""))
        for g in t["gm"]:
            log(f"      GM {g['mode']} fit: {g['samples']} samples, "
                f"{g['n_iter']} iterations "
                f"({'converged' if g['converged'] else 'not converged'}"
                f"), {g['seconds']:.3f} s")


def log_mnist(result, smi):
    """Per run: the data build and the whole run, then its epochs."""
    cfg = result["cfg"]
    bs = cfg["batch_size"]
    for run in result["runs"]:
        log(f"  run to epoch {run['epochs'][-1]} on {smi}: "
            f"{run['seconds']:.2f} s in all, synthetic data "
            f"({cfg['synthetic_n_train']} + {cfg['synthetic_n_test']} "
            f"images) built in {run['data_seconds']:.2f} s; launches "
            f"{run['launches']}; group updates {run['group_updates']}")
        _log_epochs(run["trainer"], bs)
    metric_gap, later_gap, worst, mean = result["gaps"]
    log(f"  first step vs CPU at batch {result['cpu_batch']}: metrics "
        f"within {metric_gap:.2g} relative before any update (bound "
        f"{TRAIN_METRIC_RTOL}), {later_gap:.2g} after one (bound "
        f"{TRAIN_LATER_METRIC_RTOL}); parameters within {worst:.3g} lr, "
        f"{mean:.2g} lr on average (bounds {TRAIN_PARAM_MAX_LR}, "
        f"{TRAIN_PARAM_MEAN_LR})")
    log(f"  artifacts: {result['artifacts']}")


# ---------------------------------------------------------------------------
# phase 6: training CelebA-128 through the trainer, freezing its BatchNorm
# statistics and serving the trained model
# ---------------------------------------------------------------------------

PHASE6 = ("== phase 6: training CelebA-128 through the trainer, then "
          "freezing its BatchNorm statistics and serving it")


def celeba_config(overrides=CELEBA_OVERRIDES):
    """The demo's CelebA config (the pretrained model's widths) with the
    phase's overrides, defaults applied and validated."""
    from ladder_tpu_torch.utils.config import apply_defaults, validate_config
    with open(os.path.join(ROOT, CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    return validate_config(apply_defaults(cfg))


def expected_epoch_launches(cfg, mode, steps, evals, sg_overlap, device):
    """Launches of one CelebA epoch with do_prior=True: its steps (in mode
    2 on the epoch where prior training and the standard-gaussian
    pretraining overlap, the prior groups take a second forward pass, of
    loss_prior, which reaches no decoder backward), and ``evals`` forward
    passes of eval_step (the test batch and the validation batches), each
    one decode and one output stage. The GM fits' encodes launch none."""
    import torch
    step = expected_step_launches(cfg, mode, device)
    if torch.device(device).type != "cuda":
        return step
    if mode == 2 and sg_overlap:
        step = dict(step, norm_chain_fwd=step["norm_chain_fwd"] + 4,
                    output_stage_fwd=step["output_stage_fwd"] + 1)
    out = {k: v * steps for k, v in step.items()}
    out["norm_chain_fwd"] += 4 * evals
    out["output_stage_fwd"] += evals
    return out


class _Recorder:
    """While on: every JointTrainer epoch records the kernel launches it
    made (timings[-1]['launches']), and the train step built by a trainer
    keeps a copy, taken on the step's stream, of the first ``keep``
    batches it is given."""

    def __init__(self, keep):
        self.keep, self.batches = keep, []

    def __enter__(self):
        from ladder_tpu_torch.training import trainer as trainer_mod
        self.mod = trainer_mod
        self.real_step = trainer_mod.make_train_step
        self.real_epoch = trainer_mod.JointTrainer.train_epoch
        recorder = self

        def make_train_step(model):
            step = recorder.real_step(model)

            def recorded(state, batch, *args, **kw):
                if len(recorder.batches) < recorder.keep:
                    recorder.batches.append(batch.clone())
                return step(state, batch, *args, **kw)
            return recorded

        def train_epoch(trainer):
            before = read_counters()
            recorder.real_epoch(trainer)
            trainer.timings[-1]["launches"] = {
                k: v - before[k] for k, v in read_counters().items()}

        trainer_mod.make_train_step = make_train_step
        trainer_mod.JointTrainer.train_epoch = train_epoch
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.real_step
        self.mod.JointTrainer.train_epoch = self.real_epoch

    def kept(self, label):
        """The batches kept; raises unless the steps were seen at all (a
        step built another way would leave nothing to check)."""
        if len(self.batches) != self.keep:
            raise AssertionError(f"{label}: the recorder kept "
                                 f"{len(self.batches)} batches of the "
                                 f"steps, expected {self.keep}")
        return self.batches


def _check_celeba_run(label, trainer, want_epochs, mode, device):
    """The epochs trained, finite curves, and each epoch's launches of
    K1-K5 against what its steps and evaluations launch."""
    from ladder_tpu_torch.utils.metrics import BUFFER_NAMES
    cfg = trainer.config
    if [t["epoch"] for t in trainer.timings] != list(want_epochs):
        raise AssertionError(f"{label}: trained epochs "
                             f"{[t['epoch'] for t in trainer.timings]}, "
                             f"expected {list(want_epochs)}")
    for name in BUFFER_NAMES:
        values = getattr(trainer.metrics, name)
        if values and not np.isfinite(np.asarray(values, float)).all():
            raise AssertionError(f"{label}: the {name} curve is not finite")
    steps, evals = trainer.n_train_iter(), 1 + trainer.n_val_iter()
    for t in trainer.timings:
        overlap = t["epoch"] <= cfg["sg_pretraining"]
        want = expected_epoch_launches(cfg, mode, steps, evals, overlap,
                                       device)
        if t["launches"] != want:
            raise AssertionError(f"{label}: epoch {t['epoch']} launched "
                                 f"{t['launches']}, expected {want}")


def _check_batches(label, seen, records, bs, device):
    """The first batches the steps of epoch 1 saw: on the device, and equal
    to the host's read of the same indices."""
    import torch
    idx = records.epoch_indices(bs, seed=1)
    for i, batch in enumerate(seen):
        if batch.device.type != torch.device(device).type:
            raise AssertionError(f"{label}: batch {i} lies on "
                                 f"{batch.device}, not on {device}")
        want = records.reader.read_batch(idx[i])
        if not np.array_equal(batch.cpu().numpy(), want):
            raise AssertionError(f"{label}: batch {i} of epoch 1 differs "
                                 "from the host's read of its indices")


def _mode2_reference_loss(cfg, params, batch, device):
    """loss_ae of one float32 mode-2 step from params on batch, with the
    trainer's first noise draws (its generator, seeded as the trainer's,
    draws nothing before the first step) and epoch 1's GM and flags."""
    import torch
    from ladder_tpu_torch.training.losses import identity_gm
    cfg = dict(cfg, dtype="float32", fused_train_step=2)
    state, step = _new_state(cfg, 2, params, device)
    gen = torch.Generator(device=device).manual_seed(int(cfg["seed"]))
    gm = identity_gm(cfg["n_mixtures"], cfg["representation_size"],
                     device=device)
    flags = {"use_sg_prior": 1 <= cfg["sg_pretraining"],
             "use_mask": 1 >= cfg["use_mask_start"]}
    lrs = dict.fromkeys(("ae", "sigma", "prior", "inner_sigma"), 0.0)
    _, out = step(state, batch, gen, gm, flags, lrs, True,
                  sg_overlap=1 <= cfg["sg_pretraining"])
    return float(out["ae"]["loss_ae"])


def _freeze_and_serve(cfg_path, trainer, work, device, batches, serve_batch):
    """python -m ladder_tpu_torch.freeze_bn's main over ``batches`` train
    batches of the trained checkpoint, then an InferenceEngine on that
    checkpoint with those statistics: reconstruct and encode at
    serve_batch and at batch 1. Returns the seconds, launches and gaps."""
    import contextlib
    import torch
    from ladder_tpu_torch import freeze_bn
    from ladder_tpu_torch.serving import InferenceEngine

    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(work)
    reset_counters()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            rc = freeze_bn.main(["--config", cfg_path, "--batches",
                                 str(batches), "--device", device])
    finally:
        os.chdir(old)
    seconds = time.perf_counter() - t0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["batches"] != batches or len(line["layers"]) != 6:
        raise AssertionError(f"freeze_bn printed {line}")
    stats_path = os.path.join(work, line["bn_stats"])
    cfg = dict(trainer.config)
    for key in ("checkpoint_dir", "result_dir"):
        cfg[key] = os.path.join(work, cfg[key])
    eng = InferenceEngine(cfg, bn_stats_path=stats_path, device=device,
                          serve_batch=serve_batch)
    x = trainer.data.test.first_batch(serve_batch)
    recon = eng.reconstruct(x)
    recon_one = eng.reconstruct(x[:1])
    mean, std = eng.encode(x)
    row_gap = 0.0
    for i in (0, serve_batch // 2, serve_batch - 1):
        alone, alone_std = eng.encode(x[i:i + 1])
        row_gap = max(row_gap, float(np.abs(alone[0] - mean[i]).max()),
                      float(np.abs(alone_std[0] - std[i]).max()))
    _sync(device)
    launches = read_counters()
    # two decodes (the reconstructions), four norm-chain stages each
    want = dict.fromkeys(launches, 0)
    if torch.device(device).type == "cuda":
        want["norm_chain_fwd"] = 8
    if launches != want:
        raise AssertionError(f"freeze and serve launched {launches}, "
                             f"expected {want}")
    if not row_gap <= FROZEN_ROW_MAX_ABS:
        raise AssertionError(f"frozen BN: a row encoded alone differs from "
                             f"the same row in the batch of {serve_batch} "
                             f"by {row_gap}")
    for name, imgs in (("reconstruct", recon), ("reconstruct[1]",
                                                recon_one)):
        if not (np.isfinite(imgs).all() and imgs.min() >= 0
                and imgs.max() <= 1):
            raise AssertionError(f"frozen BN {name}: not finite in [0, 1]")
    return {"seconds": seconds, "line": line, "row_gap": row_gap,
            "launches": launches}


def drive_celeba(device, overrides=CELEBA_OVERRIDES,
                 groups=os.path.join(ROOT, "pretrained_models", "celeba"),
                 profile_steps=CELEBA_PROFILE_STEPS,
                 freeze_batches=FREEZE_BATCHES, serve_batch=SERVE_BATCH,
                 data_dir=None):
    """Phase 6. ``python -m ladder_tpu_torch.train`` (its main, in this
    process) on synthetic CelebA TFRecords from the checkpoint groups in
    ``groups``: float32 mode 1 for 2 epochs, then resumed to 3; bf16 mode 2
    for 1 epoch from the same groups, held against a float32 mode-2 step on
    its first batch; then freeze_bn over the float32 run's checkpoint and
    frozen-BN serving of it. The TFRecords are written into ``data_dir``
    (kept, for phase 7), else into the phase's own directory. Every check
    of the phase; returns the runs, the times and the launches."""
    import shutil
    import tempfile
    import torch
    from ladder_tpu_torch.utils.checkpoint import load_msgpack

    cfg = celeba_config(overrides)
    bs = cfg["batch_size"]
    overlap = None
    work = tempfile.mkdtemp(prefix="chip_smoke_celeba_")
    try:
        raw = dict(cfg, data_path=os.path.join(data_dir or work, "data")
                   + "/",
                   load_dir=work + "/")
        copied_ns = _copy_groups(groups, work, cfg["exp_name"])
        runs = []
        for epochs in ((1, 2), (3,)):
            path = os.path.join(work, f"epochs_{epochs[-1]}.json")
            with open(path, "w") as f:
                json.dump(dict(raw, num_epochs=epochs[-1]), f)
            with _Recorder(CHECKED_BATCHES) as rec:
                trainer, out, seconds, launches = _run_train_cli(
                    work, path, device)
            label = f"celeba float32 run to epoch {epochs[-1]}"
            if not trainer.data.train.native:
                raise AssertionError(f"{label}: not the native reader")
            if epochs[0] == 1:
                _check_batches(label, rec.kept(label), trainer.data.train,
                               bs, device)
            _check_celeba_run(label, trainer, epochs, 1, device)
            runs.append({"trainer": trainer, "seconds": seconds,
                         "launches": launches, "epochs": epochs,
                         "out": out, "label": label})
        for line in ("Outer VAE model loaded.", "Prior model loaded."):
            if line not in runs[0]["out"]:
                raise AssertionError(f"the first run did not print {line!r}"
                                     ": the checkpoint groups were not read")
        if "Full train state restored (epoch 2)." not in runs[1]["out"]:
            raise AssertionError("the second run did not resume from the "
                                 "full train state of epoch 2")
        artifacts = _check_artifacts(runs[-1]["trainer"], copied_ns, work,
                                     w_tol=CELEBA_GM_WEIGHT_SUM_TOL)
        if artifacts["result_keys"] != sorted(RESULT_KEYS):
            raise AssertionError(f"result npz keys {artifacts['result_keys']}"
                                 f" differ from ladder_tpu's {RESULT_KEYS}")
        trainer = runs[-1]["trainer"]
        reader_s = []
        for idx in trainer.data.train.epoch_indices(bs, seed=0)[:16]:
            t0 = time.perf_counter()
            trainer.data.train.reader.read_batch(idx)
            reader_s.append(time.perf_counter() - t0)

        # bf16 mode 2, one epoch from the same groups, in a directory of its
        # own (its results and checkpoints are relative to it)
        bf_work = os.path.join(work, "bf16")
        _copy_groups(groups, bf_work, cfg["exp_name"])
        path = os.path.join(bf_work, "bf16.json")
        with open(path, "w") as f:
            json.dump(dict(raw, load_dir=bf_work + "/", num_epochs=1,
                           dtype="bfloat16", fused_train_step=2), f)
        with _Recorder(1) as rec:
            bf_trainer, out, seconds, launches = _run_train_cli(
                bf_work, path, device)
        label = "celeba bf16 mode-2 run"
        _check_celeba_run(label, bf_trainer, (1,), 2, device)
        bf16_run = {"trainer": bf_trainer, "seconds": seconds,
                    "launches": launches, "epochs": (1,), "out": out,
                    "label": label}
        params = {**load_msgpack(os.path.join(groups, "vae-model.msgpack")),
                  **load_msgpack(os.path.join(groups, "prior-model.msgpack"))}
        ref = _mode2_reference_loss(raw, params, rec.kept(label)[0],
                                    device)
        got = bf_trainer.metrics.train_loss[0]
        if not abs(got - ref) <= BF16_LOSS_RTOL * abs(ref):
            raise AssertionError(f"bf16 first-step loss {got} vs float32 "
                                 f"mode 2 {ref}: outside rtol "
                                 f"{BF16_LOSS_RTOL}")
        bf16_run["first_loss"], bf16_run["float32_loss"] = got, ref
        del bf_trainer
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        serve = _freeze_and_serve(
            os.path.join(work, "epochs_3.json"), trainer, work, device,
            freeze_batches, serve_batch)

        if profile_steps and torch.device(device).type == "cuda":
            # the next epoch's first steps, batches from the prefetch
            # thread as in training (the trainer's state moves on; every
            # check above is done)
            trainer.cur_epoch += 1
            batches = trainer.train_batches()
            args = (trainer.generator, trainer._gm_for_step(),
                    trainer._flags(), trainer._lrs(), trainer._do_prior())

            def steps():
                for batch in islice(batches, profile_steps):
                    trainer.train_step(trainer.state, trainer._place(batch),
                                       *args)

            prof = profile_device(
                f"{profile_steps} CelebA train steps at batch {bs}, batches "
                "from the prefetch thread", steps,
                marks=("norm_chain_fwd", "norm_chain_bwd",
                       "output_stage_fwd", "output_stage_bwd", "adam_kernel",
                       "Memcpy HtoD"))
            del batches
            if prof is not None:
                n, us, share = copy_overlap(device_events(prof))
                overlap = {"copies": n, "copy_us": us, "under_kernels": share}
                log(f"  the prefetch thread's copies in that window: {n}, "
                    f"{us:.1f} us, "
                    + ("not measured" if share is None else
                       f"{share:.1%} of it while a kernel ran"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"runs": runs, "bf16": bf16_run, "serve": serve,
            "artifacts": artifacts, "cfg": cfg, "copy_overlap": overlap,
            "build_seconds": runs[0]["trainer"].data.build_seconds,
            "reader_s": reader_s}


def log_celeba(result, smi):
    cfg = result["cfg"]
    bs = cfg["batch_size"]
    for name, (synth, write) in sorted(result["build_seconds"].items()):
        log(f"  data: {name} synthesised in {synth:.3f} s, written in "
            f"{write:.3f} s")
    reader = sorted(result["reader_s"])
    log(f"  native reader: {1e3 * statistics.median(reader):.3f} ms per "
        f"batch of {bs} (median of {len(reader)}, {1e3 * reader[0]:.3f}-"
        f"{1e3 * reader[-1]:.3f} ms)")
    for run in result["runs"] + [result["bf16"]]:
        log(f"  {run['label']} on {smi}: {run['seconds']:.2f} s in all; "
            f"launches {run['launches']}")
        _log_epochs(run["trainer"], bs)
    bf = result["bf16"]
    log(f"  bf16 first-step loss {bf['first_loss']:.4f} vs float32 mode 2 "
        f"{bf['float32_loss']:.4f} on the same batch and noise: "
        f"{abs(bf['first_loss'] / bf['float32_loss'] - 1):.3%} (bound "
        f"{BF16_LOSS_RTOL:.0%})")
    serve = result["serve"]
    log(f"  freeze_bn over {serve['line']['batches']} batches: "
        f"{serve['seconds']:.2f} s; frozen-BN serving: a row alone vs in "
        f"the batch, max abs {serve['row_gap']:.3g} (bound "
        f"{FROZEN_ROW_MAX_ABS}); launches {serve['launches']}")
    art = result["artifacts"]
    log(f"  artifacts: GM weights sum {art['w_full_sum']:.7f}, "
        f"{art['active_mixtures']} active; {len(art['result_keys'])} result "
        "keys as ladder_tpu's")


# ---------------------------------------------------------------------------
# phase 7: SLP interpolation of the pretrained models, and trainer runs of
# another family and another prior
# ---------------------------------------------------------------------------

PHASE7 = ("== phase 7: SLP interpolation of the pretrained mnist_digit and "
          "CelebA-128 models, and the fashion and GMM-prior trainer runs")


def _demo_config(path, overrides, load_dir, work):
    """The demo config at path with overrides, through the demo's own
    process_config, its checkpoints read from load_dir and its results
    written under work."""
    from ladder_tpu_torch.utils.config import create_dirs, process_config
    with open(os.path.join(ROOT, path)) as f:
        raw = json.load(f)
    raw.update(overrides, load_dir=load_dir.rstrip("/") + "/")
    os.makedirs(work, exist_ok=True)
    tmp = os.path.join(work, os.path.basename(path))
    with open(tmp, "w") as f:
        json.dump(raw, f)
    cfg = process_config(tmp)
    cfg["result_dir"] = os.path.join(work, "result") + "/"
    cfg["summary_dir"] = os.path.join(work, "summary") + "/"
    create_dirs([cfg["result_dir"]])
    return cfg


def expected_interp_launches(cfg, n_embeddings, n_strips, device):
    """Launches of the demo's decodes: each embedding decodes its sampled
    z and, with an inner VAE, its t-mean; each strip is one decode; a
    CelebA decode runs four norm-chain stages, an mnist one none."""
    import torch
    out = dict.fromkeys(kernel_counters(), 0)
    if cfg["exp_name"] == "celeba" and torch.device(device).type == "cuda":
        per = 2 if cfg["prior"] in ("ours", "hierarchical") else 1
        out["norm_chain_fwd"] = 4 * (per * n_embeddings + n_strips)
    return out


def _check_history(label, hist, improves):
    for key, values in hist.items():
        if not np.isfinite(values).all():
            raise AssertionError(f"{label}: the {key} history is not finite")
    if improves and not (hist["neg_ll"][-1] < hist["neg_ll"][0]
                         and hist["obj"][-1] < hist["obj"][0]):
        raise AssertionError(
            f"{label}: the path does not beat the straight line: neg-LL "
            f"{hist['neg_ll'][0]} -> {hist['neg_ll'][-1]}, obj "
            f"{hist['obj'][0]} -> {hist['obj'][-1]}")


def against_cpu(label, cfg, gm, start, end, init_pts, pts, hist, n_iter):
    """The same optimisation on the CPU from the card's GM, start, end and
    initial points (host copies): the gaps of the first INTERP_CPU_ITERS
    iterations, of the last, and of the final points, each checked; the
    iteration where the two runs part."""
    import torch
    from ladder_tpu_torch.interp import optimise_slp, prior_logpdf_fn
    host = [torch.as_tensor(a).detach().cpu() for a in gm]
    log_prob = prior_logpdf_fn(cfg, gm=host)
    cpu_pts, cpu_hist = optimise_slp(
        torch.as_tensor(np.asarray(init_pts)), torch.as_tensor(start),
        torch.as_tensor(end), log_prob, n_iter=n_iter)
    segment = float(hist["path_length"][0]) / (len(init_pts) + 1)
    rel = {k: np.abs(hist[k] - cpu_hist[k]) / np.abs(cpu_hist[k])
           for k in ("obj", "path_length", "neg_ll")}
    step_var = np.abs(hist["step_var"] - cpu_hist["step_var"]) / segment
    first = slice(0, INTERP_CPU_ITERS)
    start_gaps = {k: float(v[0]) for k, v in rel.items()}
    start_gaps["step_var"] = float(step_var[0])
    gaps = {k: float(v[first].max()) for k, v in rel.items()}
    gaps["step_var"] = float(step_var[first].max())
    parted = np.flatnonzero(np.maximum.reduce(list(rel.values()))
                            > INTERP_PART_RTOL)
    out = {"start": start_gaps, "first": gaps,
           "parts_at": int(parted[0]) if len(parted) else None,
           "final_obj": float(rel["obj"][-1]),
           "final_points": float(np.abs(np.asarray(pts)
                                        - cpu_pts.numpy()).max()),
           "segment": segment}
    log(f"  {label}: card vs CPU before the first update "
        + ", ".join(f"{k} {v:.3g}" for k, v in start_gaps.items())
        + f" (bound {INTERP_START_RTOL}); over the first "
        f"{INTERP_CPU_ITERS} iterations "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (bound {INTERP_CPU_RTOL}); the runs part at iteration "
        f"{out['parts_at']} (a gap over {INTERP_PART_RTOL}); final obj "
        f"{out['final_obj']:.3g} (bound {INTERP_FINAL_RTOL}), final points "
        f"{out['final_points']:.4g} against a mean segment of "
        f"{segment:.4g} (bound {INTERP_FINAL_SEGMENTS} segments)")
    if max(start_gaps.values()) > INTERP_START_RTOL:
        raise AssertionError(f"{label}: the objective at the initial points "
                             f"differs from the CPU's: {start_gaps}")
    if max(gaps.values()) > INTERP_CPU_RTOL:
        raise AssertionError(f"{label}: the card's first {INTERP_CPU_ITERS}"
                             f" iterations differ from the CPU's: {gaps}")
    if (out["final_obj"] > INTERP_FINAL_RTOL
            or out["final_points"] > INTERP_FINAL_SEGMENTS * segment):
        raise AssertionError(f"{label}: the card's path ends away from the "
                             f"CPU's: {out}")
    return out


def _launches_per_iteration(label, init_pts, start, end, log_prob, iters):
    """Kernels and copies per SLP iteration, from a profile of ``iters``
    iterations on the card (None where the profile saw no device time)."""
    import torch
    from ladder_tpu_torch.interp import optimise_slp
    prof = profile_device(f"{iters} SLP iterations ({label})",
                          lambda: optimise_slp(init_pts, start, end,
                                               log_prob, n_iter=iters))
    if prof is None:
        return None
    n = sum(evt.count for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.self_device_time_total > 0)
    return n / iters


def interp_model(label, cfg, argv, device, random_init=False,
                 profile_iters=INTERP_PROFILE_ITERS):
    """python -m ladder_tpu_torch.interpolate's run() for one model on
    ``device`` (the linear init), then, if asked, the random init from the
    fitted GM; every check of the phase for the model. Returns the runs'
    numbers."""
    import torch
    from ladder_tpu_torch.interp import interpolate
    from ladder_tpu_torch.interpolate import get_args, prior_sample_fn, run
    from ladder_tpu_torch.utils.device import float32_exact

    args = get_args(list(argv) + ["--device", device])
    reset_counters()
    t0 = time.perf_counter()
    res = run(cfg, args, device)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()
    want = expected_interp_launches(cfg, 2, 2, device)
    if launches != want:
        raise AssertionError(f"{label}: the demo launched {launches}, "
                             f"expected {want}")
    trainer = res["trainer"]
    gm = trainer.gm_final
    _check_history(f"{label}, linear init", res["hist"], improves=True)
    for name, strip in res["strips"].items():
        if (strip.shape[0] != args.n_step + 2 or not np.isfinite(strip).all()
                or strip.min() < 0 or strip.max() > 1):
            raise AssertionError(f"{label}: the {name} strip is not "
                                 f"{args.n_step + 2} finite images in "
                                 "[0, 1]")
    out = {"label": label, "seconds": seconds, "fit": res["fit"],
           "slp_seconds": res["slp_seconds"], "launches": launches,
           "n_iter": args.n_iter,
           "final": {k: (float(v[0]), float(v[-1]))
                     for k, v in res["hist"].items()},
           "linear": against_cpu(f"{label}, linear init", cfg, gm,
                                 res["start"], res["end"], res["sp"],
                                 res["slp"], res["hist"], args.n_iter)}
    dev = trainer.device
    start = torch.as_tensor(res["start"], device=dev)
    end = torch.as_tensor(res["end"], device=dev)
    if random_init:
        t0 = time.perf_counter()
        with float32_exact():
            slp, init_pts, hist = interpolate(
                cfg, start, end, res["log_prob"], n_step=args.n_step,
                n_iter=args.n_iter, init="random",
                generator=trainer.generator,
                sample_fn=prior_sample_fn(cfg, trainer))
        out["random_slp_seconds"] = time.perf_counter() - t0
        _check_history(f"{label}, random init", hist, improves=False)
        out["random"] = against_cpu(
            f"{label}, random init", cfg, gm, res["start"], res["end"],
            init_pts.cpu().numpy(), slp.cpu().numpy(), hist, args.n_iter)
        out["random_final"] = {k: (float(v[0]), float(v[-1]))
                               for k, v in hist.items()}
    if profile_iters and dev.type == "cuda":
        with float32_exact():
            out["launches_per_iter"] = _launches_per_iteration(
                label, torch.as_tensor(res["sp"], device=dev), start, end,
                res["log_prob"], profile_iters)
    return out


def _check_epoch_adam_launches(label, trainer, updates):
    """Each epoch's Adam launches: one per updated group per step."""
    groups = sum(1 for n in updates.values() if n)
    cuda = trainer.device.type == "cuda"
    for t in trainer.timings:
        want = groups * trainer.n_train_iter() if cuda else 0
        if t["launches"]["adam_update"] != want:
            raise AssertionError(f"{label}: epoch {t['epoch']} made "
                                 f"{t['launches']['adam_update']} Adam "
                                 f"launches, expected {want}")


def _train_run(label, cfg, work, device, epochs, t_before):
    """The train CLI's main on cfg in work, every epoch's launches
    recorded; the run's checks (the epochs, finite curves, every updated
    group in every step, an Adam launch per group update, the result npz
    keys as ladder_tpu's)."""
    path = os.path.join(work, f"{label.replace(' ', '_')}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with _Recorder(0):
        trainer, out, seconds, launches = _run_train_cli(work, path, device)
    updates = _check_mnist_run(label, trainer, launches, epochs, t_before)
    _check_epoch_adam_launches(label, trainer, updates)
    result_dir = os.path.join(work, trainer.config["result_dir"])
    with np.load(os.path.join(result_dir,
                              f"{cfg['exp_name']}-result.npz")) as r:
        keys = sorted(r.files)
    if keys != sorted(RESULT_KEYS):
        raise AssertionError(f"{label}: result npz keys {keys} differ from "
                             f"ladder_tpu's {RESULT_KEYS}")
    return {"label": label, "trainer": trainer, "seconds": seconds,
            "launches": launches, "group_updates": updates, "out": out,
            "result_dir": result_dir, "epochs": epochs}


def drive_other_trainers(device, fashion_overrides=FASHION_OVERRIDES,
                         gmm_overrides=GMM_OVERRIDES,
                         fashion_groups=os.path.join(
                             ROOT, "pretrained_models", "mnist_fashion")):
    """Phase 7's trainer runs: the pretrained mnist_fashion 'ours' groups
    through the train CLI's main for 1 epoch, and a 'GMM'-prior
    mnist_digit model from a fresh init for 2 epochs, whose last epoch
    writes GM_prior_info.npz."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_priors_")
    try:
        fashion_work = os.path.join(work, "fashion")
        _copy_groups(fashion_groups, fashion_work, "mnist_fashion")
        fashion = _train_run(
            "mnist_fashion ours run",
            mnist_config(dict(fashion_overrides, load_dir=fashion_work + "/"),
                         FASHION_CONFIG),
            fashion_work, device, (1,), {})
        for line in ("Outer VAE model loaded.", "Prior model loaded."):
            if line not in fashion["out"]:
                raise AssertionError(f"the fashion run did not print "
                                     f"{line!r}: the groups were not read")
        gmm_work = os.path.join(work, "gmm")
        os.makedirs(gmm_work)
        gmm = _train_run(
            "mnist_digit GMM run",
            mnist_config(dict(gmm_overrides, load_dir=gmm_work + "/")),
            gmm_work, device, (1, 2), {})
        trainer = gmm["trainer"]
        modes = [[g["mode"] for g in t["gm"]] for t in trainer.timings]
        if modes != [["fast"], ["accurate"]]:
            raise AssertionError(f"GMM run: GM fits {modes}, expected a fast"
                                 " EM fit after epoch 1, the accurate one "
                                 "after epoch 2")
        with np.load(os.path.join(gmm["result_dir"],
                                  "GM_prior_info.npz")) as info:
            w_sum = float(info["w_full"].sum())
            gmm["gm_files"] = sorted(info.files)
            gmm["gm_shapes"] = {k: info[k].shape for k in info.files}
        if abs(w_sum - 1.0) > GM_WEIGHT_SUM_TOL:
            raise AssertionError(f"GMM run: GM_prior_info.npz weights sum "
                                 f"to {w_sum}")
        gmm["w_full_sum"] = w_sum
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"fashion": fashion, "gmm": gmm}


def drive_interp(device, mnist_overrides=INTERP_MNIST_OVERRIDES,
                 celeba_overrides=INTERP_CELEBA_OVERRIDES,
                 mnist_groups=os.path.join(ROOT, "pretrained_models"),
                 celeba_groups=os.path.join(ROOT, "pretrained_models"),
                 argv=INTERP_ARGS, data_dir=None,
                 profile_iters=INTERP_PROFILE_ITERS):
    """Phase 7's interpolations: the pretrained mnist_digit model (linear
    then random init) and the pretrained CelebA-128 model (linear init),
    on the demo configs' synthetic data; CelebA's TFRecords are read from
    data_dir where phase 6 wrote them, else written anew."""
    import shutil
    import tempfile
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_interp_")
    try:
        mnist_cfg = _demo_config(MNIST_CONFIG, mnist_overrides, mnist_groups,
                                 os.path.join(work, "mnist"))
        mnist = interp_model("mnist_digit", mnist_cfg, argv, device,
                             random_init=True, profile_iters=profile_iters)
        del mnist_cfg
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        celeba_cfg = _demo_config(
            CONFIG, dict(celeba_overrides, data_path=os.path.join(
                data_dir or work, "data") + "/"),
            celeba_groups, os.path.join(work, "celeba"))
        celeba = interp_model("CelebA-128", celeba_cfg, argv, device,
                              profile_iters=profile_iters)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"mnist": mnist, "celeba": celeba}


def log_interp(result, others, smi):
    for run in (result["mnist"], result["celeba"]):
        fit = run["fit"]
        log(f"  {run['label']} on {smi}: run() {run['seconds']:.2f} s in "
            f"all; accurate GM fit over {fit['samples']} samples: "
            f"{fit['n_iter']} iterations "
            f"({'converged' if fit['converged'] else 'not converged'}), "
            f"{fit['seconds']:.3f} s; {run['n_iter']} SLP iterations "
            f"{run['slp_seconds']:.3f} s on the host clock "
            f"({1e3 * run['slp_seconds'] / run['n_iter']:.2f} ms an "
            "iteration)"
            + (f", random init {run['random_slp_seconds']:.3f} s"
               if "random_slp_seconds" in run else "")
            + (f"; {run['launches_per_iter']:.1f} kernels and copies an "
               "iteration (profile)" if run.get("launches_per_iter")
               else "") + f"; launches {run['launches']}")
        log("    linear init, first -> last iteration: " + ", ".join(
            f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in run["final"].items()))
        if "random_final" in run:
            log("    random init, first -> last iteration: " + ", ".join(
                f"{k} {a:.4f} -> {b:.4f}"
                for k, (a, b) in run["random_final"].items()))
    for key in ("fashion", "gmm"):
        run = others[key]
        log(f"  {run['label']} on {smi}: {run['seconds']:.2f} s in all; "
            f"launches {run['launches']}; group updates "
            f"{run['group_updates']}")
        _log_epochs(run["trainer"], run["trainer"].config["batch_size"])
    gmm = others["gmm"]
    log(f"  GMM run: GM_prior_info.npz {gmm['gm_shapes']}, weights sum "
        f"{gmm['w_full_sum']:.7f}")


def times_only(package, cfg, peaks):
    """``--only times``: phase 2's checks and times of the norm-chain
    forward at the stage shapes and of the Adam update over the
    encoder+decoder group, through the wrappers every version of the port
    has; one dict."""
    import torch
    from ladder_tpu_torch.utils.device import float32_exact

    flush = l2_flusher()
    with float32_exact():
        cases = norm_chain_cases(peaks, flush, paths=None)
        del flush
        torch.cuda.empty_cache()
        [adam_case] = adam_cases(cfg, peaks, ("ae",))
    return {"package": package, "card": smi_line(),
            "norm_chain_fwd": cases, "adam_update": adam_case}


def ab(other, out_path=None):
    """``--ab``: times_only of other's package, this one's twice, other's
    again, each in a process of its own. Returns the four results."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--only", "times",
             "--package", root], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"chip_smoke --only times on {root} failed:\n"
                               f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = []
    for run in runs:
        decode = norm_chain_entry(run["norm_chain_fwd"], None)
        adam_case = run["adam_update"]
        summary.append({
            "package": run["package"], "card": run["card"],
            "norm_chain_fwd_per_decode_device_ms": decode["device_ms"],
            "norm_chain_fwd_per_decode_call_ms": decode["call_ms"],
            "adam_device_ms": adam_case["device_ms"],
            "adam_call_ms": adam_case["call_ms"],
            "adam_host_ms": adam_case["host_ms"]})
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    print(json.dumps({"summary": summary}))
    return runs


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("build", "kernels", "serving",
                                           "training", "mnist", "celeba",
                                           "interp", "times"))
    parser.add_argument("--package", default=ROOT,
                        help="checkout whose ladder_tpu_torch is imported")
    parser.add_argument("--ab", metavar="DIR",
                        help="compare DIR's kernel times with this tree's")
    parser.add_argument("--out", help="write the --ab results here (JSON)")
    args = parser.parse_args(argv)
    if args.ab:
        ab(os.path.abspath(args.ab), args.out)
        return 0
    only = args.only
    package = os.path.abspath(args.package)
    os.chdir(ROOT)
    sys.path.insert(0, package)
    from ladder_tpu_torch.ops import adam, norm_chain, output_stage
    from ladder_tpu_torch.ops._build import build_all
    from ladder_tpu_torch.utils.config import process_config
    from ladder_tpu_torch.utils.device import float32_exact

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("== phase 1: card and build")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(f"  {smi}")
    t0 = time.perf_counter()
    built = build_all([norm_chain.LIBRARY, output_stage.LIBRARY,
                       adam.LIBRARY])
    log(f"  {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        "(one nvcc each, started together)")
    for lib, (so, compiler) in built.items():
        log(f"  {lib}: {so.name} " + ("built" if compiler else
                                      "already built from the same source"))
        for line in compiler.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    peak_name, peaks = card_peaks(name)
    log(f"  bounds from the {peak_name} peaks: {peaks[0] / 1e12} TB/s, "
        f"{peaks[1] / 1e12} TFLOP/s float32")
    cfg = process_config(CONFIG)
    if only == "build":
        return 0
    if only == "times":
        print(json.dumps(times_only(package, cfg, peaks)))
        return 0

    if only in (None, "kernels"):
        log("== phase 2: kernels against their plain versions")
        flush = l2_flusher()
        with float32_exact():  # the plain versions' products in full float32
            cases = norm_chain_cases(peaks, flush)
            other_cases = norm_chain_other_cases()
            bwd_cases = norm_chain_bwd_cases(peaks, flush)
            out_fwd, out_bwd = output_stage_cases(peaks)
            adam_c = adam_cases(cfg, peaks, mnist_cfg=mnist_config(),
                                flush=flush)
        del flush
        torch.cuda.empty_cache()
        if only:
            return 0

    if only == "mnist":
        log("== phase 5: training the pretrained mnist_digit model through "
            "the trainer")
        log_mnist(drive_mnist("cuda"), smi)
        return 0
    if only == "celeba":
        log(PHASE6)
        log_celeba(drive_celeba("cuda"), smi)
        return 0
    if only == "interp":
        log(PHASE7)
        interp = drive_interp("cuda")
        log_interp(interp, drive_other_trainers("cuda"), smi)
        return 0

    log("== phase 3: serving the pretrained CelebA-128 'ours' model")
    reset_counters()
    run = drive_serving(cfg, "cuda")
    serving = read_counters()
    for call_name, delta in run["calls"]:
        log(f"  {call_name}: {delta} norm-chain launches")
    log(f"  main path: {run['launches']} norm-chain launches; all kernels "
        f"{serving}")
    if run["launches"] <= 0 or serving["norm_chain_fwd"] != run["launches"]:
        raise AssertionError("the serving path never launched the kernel")
    eng = run["engine"]
    if only in (None, "serving"):
        log(f"  latency_ema on {smi}: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms"
            for k, v in sorted(eng.latency_ema.items())))
        for label, engine in (("float32", eng),
                              ("bfloat16", run["engine_bf16"])):
            lat = path_latencies(engine, run["x"], repeats=5)
            log(f"  median {label} latency at batch {SERVE_BATCH} on {smi}: "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in lat.items()))
        profile_reconstruct(eng, run["x"])
        if only:
            return 0

    log("== phase 4: training the same model on the card")
    images = eng.generate(TRAIN_BATCH, seed=5)  # NHWC float32 in [0, 1]
    flax_params = eng.model.flax_params()
    gm = {k: v.cpu() for k, v in eng.gm.items()}
    del run["engine_bf16"]
    torch.cuda.empty_cache()
    train = drive_training(cfg, flax_params, gm, images, "cuda")
    training = dict.fromkeys(serving, 0)
    for mode, res in train.items():
        timed = res["step_ms"][1:]
        ms = statistics.median(timed)
        training = {k: training[k] + v for k, v in res["launches"].items()}
        log(f"  mode {mode} on {smi}: step {ms:.2f} ms median of "
            f"{len(timed)} after the first ({res['step_ms'][0]:.1f} ms): "
            f"{1e3 / ms:.3f} steps/s, {TRAIN_BATCH * 1e3 / ms:.1f} images/s "
            f"at batch {TRAIN_BATCH}; all steps "
            + ", ".join(f"{t:.1f}" for t in res["step_ms"]))
        log(f"    launches per step {res['launches_per_step']}")
        log(f"    loss_ae per step " + ", ".join(
            f"{v:.1f}" for v in res["loss_ae"]))
        log(f"    first step vs CPU at batch {TRAIN_CPU_BATCH}: metrics "
            f"within {res['metric_gap']:.2g} relative before any update "
            f"(bound {TRAIN_METRIC_RTOL}), {res['later_metric_gap']:.2g} "
            f"after one (bound {TRAIN_LATER_METRIC_RTOL}); parameters within "
            f"{res['param_gap_max_lr']:.3g} lr, {res['param_gap_mean_lr']:.2g}"
            f" lr on average (bounds {TRAIN_PARAM_MAX_LR}, "
            f"{TRAIN_PARAM_MEAN_LR})")
    for mode, res in train.items():
        profile_device(
            f"one mode-{mode} train step at batch {TRAIN_BATCH}",
            lambda res=res: res["step"](res["state"], *res["args"]),
            marks=("norm_chain_fwd", "norm_chain_bwd", "output_stage_fwd",
                   "output_stage_bwd", "adam_kernel", "partials_kernel"))
    if only:
        return 0
    missing = [k for k, v in training.items() if v <= 0]
    if missing:
        raise AssertionError(f"training never launched {missing}")
    del train, eng, run
    torch.cuda.empty_cache()

    log("== phase 5: training the pretrained mnist_digit model through the "
        "trainer")
    mnist = drive_mnist("cuda")
    log_mnist(mnist, smi)
    mnist_launches = dict.fromkeys(serving, 0)
    for r in mnist["runs"]:
        mnist_launches = {k: mnist_launches[k] + v
                          for k, v in r["launches"].items()}
    if mnist_launches["adam_update"] <= 0:
        raise AssertionError("the mnist trainer never launched the Adam "
                             "kernel")
    del mnist
    torch.cuda.empty_cache()

    import shutil
    import tempfile
    # phase 6's synthetic CelebA TFRecords, read again by phase 7
    celeba_data = tempfile.mkdtemp(prefix="chip_smoke_celeba_data_")
    try:
        log(PHASE6)
        celeba = drive_celeba("cuda", data_dir=celeba_data)
        log_celeba(celeba, smi)
        celeba_launches = dict(celeba["serve"]["launches"])
        for r in celeba["runs"] + [celeba["bf16"]]:
            celeba_launches = {k: celeba_launches[k] + v
                               for k, v in r["launches"].items()}
        missing = [k for k, v in celeba_launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"the CelebA trainer never launched "
                                 f"{missing}")
        del celeba
        torch.cuda.empty_cache()

        log(PHASE7)
        interp = drive_interp("cuda", data_dir=celeba_data)
    finally:
        shutil.rmtree(celeba_data, ignore_errors=True)
    others = drive_other_trainers("cuda")
    log_interp(interp, others, smi)
    interp_launches = {k: interp["mnist"]["launches"][k]
                       + interp["celeba"]["launches"][k] for k in serving}
    prior_launches = {k: others["fashion"]["launches"][k]
                      + others["gmm"]["launches"][k] for k in serving}
    if (interp_launches["norm_chain_fwd"] <= 0
            or prior_launches["adam_update"] <= 0):
        raise AssertionError("phase 7 never launched the norm-chain forward "
                             "(CelebA decodes) or the Adam update (training)")

    total = {k: serving[k] + training[k] + mnist_launches[k]
             + celeba_launches[k] + interp_launches[k] + prior_launches[k]
             for k in serving}
    kernels = [
        dict(norm_chain_entry(cases, total["norm_chain_fwd"]),
             other_cases=other_cases),
        per_decode_entry("norm_chain_bwd",
                         "ladder_tpu/ops/pallas_kernels.py:60", bwd_cases,
                         total["norm_chain_bwd"]),
        output_stage_entry("output_stage_fwd",
                           "ladder_tpu/ops/pallas_output.py:83", out_fwd,
                           total["output_stage_fwd"]),
        output_stage_entry("output_stage_bwd",
                           "ladder_tpu/ops/pallas_output.py:193", out_bwd,
                           total["output_stage_bwd"]),
        adam_entry(adam_c, total["adam_update"])]
    for entry in kernels:
        entry["launches_serving"] = serving[entry["name"]]
        entry["launches_training"] = training[entry["name"]]
        entry["launches_mnist"] = mnist_launches[entry["name"]]
        entry["launches_celeba"] = celeba_launches[entry["name"]]
        entry["launches_interp"] = interp_launches[entry["name"]]
        entry["launches_priors"] = prior_launches[entry["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
