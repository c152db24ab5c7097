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
   Then ``python -m ladder_tpu_torch.bench_serving``'s main twice at the
   published widths (codes/celeba_config.json: h=512, batch 64, random
   init, as the JAX script allows): its defaults (bf16, 50 iterations)
   and float32 at 20. Checks: the line's keys are the JAX script's, every
   rate finite and positive, and the norm-chain forward launched exactly
   4 times per decoding device call (counted by wrapping the engine
   module's ``run_path`` and the engine's ``_render`` here).
4. Training: the same model and weights through ladder_tpu_torch's train
   step on the card, batch 64, float32 with TF32 off, a few steps of the
   sequential mode and of the single-pass mode: finite metrics, every
   active group moved and counted, the launch counts of one step, and the
   first step against the same step on the CPU at batch 8. Then the step
   time per mode and a profile of one sequential step.
5. Training the pretrained mnist_digit model (demo/mnist_digit_config.json:
   h=256, code 16, t in 2-D, inner VAE 5x512, 50 mixtures, 100 MC samples,
   batch 256) through ``python -m ladder_tpu_torch.train``'s main, in this
   process, on 8,192 + 4,096 synthetic MNIST images (cut from MNIST's
   training split to keep the script's time): 2 epochs from the
   pretrained checkpoint groups, then a rerun with
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
   the two validation embeddings (images 0 and 32), 250 Adam iterations
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
8. The utilities: the device half of the trainers' prior sampling (100
   codes, one decode) for the five priors on the mnist_digit demo config
   (the pretrained groups where the prior has them, a seeded init for the
   vampPrior pseudo-inputs, a seeded z-space GM for 'GMM') and for
   CelebA-128 'ours' with its accurate GM, each held against the same
   draws decoded on the CPU; torch.export of every path of the pretrained
   CelebA-128 (float32, TF32 off, batch 64) and mnist_digit engines,
   loaded back and held against the live engines, the norm-chain launches
   of the exported CelebA decodes counted; one mnist_digit epoch through
   the train CLI with async_checkpoint 1, its files against a synchronous
   save of the same state byte for byte; the FID of two synthetic CelebA
   sets of 256 images through the pretrained encoder, card against CPU;
   and the ImportError of a trainer with enable_plots 1 and no
   matplotlib. Logs the export time, the loaded paths' and the engine's
   latencies, the time a save blocks the epoch both ways, and the FID.
9. Data parallelism: ``LADDER_DISTRIBUTED=1 torchrun --standalone
   --nproc_per_node N -m ladder_tpu_torch.train`` in subprocesses, each
   rank writing a ``--report``. The machine has one card and NCCL cannot
   put two ranks on it, so 2 ranks share cuda:0 over gloo (its CUDA
   collectives staged through the host), and 1 rank runs over NCCL. (1)
   The pretrained CelebA-128 'ours' model in float32 mode 1 on 256
   synthetic images, 1 epoch of 4 steps at global batch 64: one process
   (in this process), 2 gloo ranks x 32 and 1 NCCL rank, each held to the
   one process: the first-step loss within TRAIN_METRIC_RTOL, the curves
   within PARALLEL_CURVE_RTOL, the parameters after the epoch within
   TRAIN_PARAM_MAX_LR lr per step; the ranks bitwise equal (a digest of
   parameters, moments and GM fits); every rank's launches of the five
   kernels against its epoch's count; K1, K3 and K4 against their plain
   versions at the local batch of 32; two NCCL ranks on the one card
   refused. (2) codes/celeba_scaled_config.json as it stands but for
   SCALED_OVERRIDES (2 ranks, fresh init, 2,048 images, 1 epoch, global
   batch 512), then the same config in one process: finite curves,
   bitwise ranks, the launches, the first-step loss within
   SCALED_LOSS_RTOL. (3) The pretrained mnist_digit model as 2 ranks x
   128 on 4,096 images for 1 epoch, then resumed to 2: every artifact
   written once (the files of a one-process run, one summary line per
   epoch), the result keys, the ranks' GM fits and validation equal.
   Logs per run and rank the step time, the gradient all-reduce's bytes,
   calls and host time a step, the profile of steps 2-4 (device busy and
   idle share, copies, the collectives' host time) and the peak memory.
10. The (data, model) mesh: the same torchrun path with ``mesh_shape``
   [n_data, n_model], the parameters and Adam moments held between steps
   as each rank's shards (parallel/tp.py). (1) Phase 9's CelebA parity
   run on [1, 2] (2 gloo ranks x 32 on the one card), alone and profiled,
   then resumed to epoch 2, against one process on the same data at phase
   9's bounds; the ranks bitwise equal (the digest of the gathered
   state); each rank's bytes of parameters and moments at rest the
   ``leaf_spec`` rule's exactly and at most TP_MEMORY_SHARE of the
   replicated total; every rank's launches of the five kernels against
   its epoch's count; the lead's checkpoint files byte for byte a
   one-process save of the same state. (2) The pretrained mnist_digit
   model on [2, 2] (4 gloo ranks x 64) on 4,096 images, 1 epoch then
   resumed to 2 (phase 9's checks of the artifacts, the resume and the
   launches). (3) The engine on the pretrained CelebA model with
   mesh_devices=1 against 0: every path bitwise, the same K1 launches;
   more mesh devices than cards refused; ``serve --mesh 1 --generate
   64``. K5 on each rank's shards of the ae group against its plain
   version. Logs per run and rank the step time, the ``param_gather``
   and ``grad`` collectives' bytes, calls and host time a step, the idle
   share of steps 2-4, the bytes at rest, the memory allocated between
   steps and the peak. ``--only tp --tp-backend nccl`` puts every rank on
   a card of its own over NCCL (4 cards), and then also holds the engine
   with a replica on every card against one card.
11. The quality record: ``python -m ladder_tpu_torch.quality``'s run() in
   this process at the published widths, data and epochs cut. (a)
   codes/mnist_digit_config.json on 4,096 + 1,024 synthetic images for 6
   epochs (sg_pretraining's 5 and one of prior training ending in a GM
   fit), the FID over 512 generated images; then ``python -m
   ladder_tpu_torch.eval_fid --network encoder`` on the record's two npz
   files. (b) codes/celeba_config.json (h=512, code 256, batch 64) on 128
   images for 1 epoch with the prior trained from the start and an
   accurate fit after it, the FID over 512 images (more than the code's
   256 dimensions, so that the features' covariance has full rank).
   Checks: the record's scale values finite, an active mixture, the
   FID's self-floor under QUALITY_SELF_FLOOR, each epoch's launches (K5
   on every group update of (a); K1-K5 of (b)'s steps and evaluations)
   and the generation's (four K1 a CelebA decoding call), eval_fid's FID
   within QUALITY_EVAL_FID_RTOL of the record's. Logs each record's
   endpoints, keys, per-epoch times and launches.
12. The scripts, as the port's modules, in this process (their main) at
   the published widths, data and epochs cut, over phase 11's files:
   ``verify_real_data check`` on phase 11 (a)'s synthetic MNIST set
   (written as mnist.npz) and (b)'s CelebA TFRecords, ``compare`` on
   (a)'s result files against docs/envelopes/, held check by check
   against this script's own numpy reading of the same files (a cut run
   may fail the envelope; the same checks must fail); ``sweep_gmm`` on
   codes/mnist_digit_config.json at 10 and 50 mixtures, 2,048 + 512
   images, 5 epochs (the last ends in the first fast fit); ``memory_report``
   on codes/celeba_config.json at batch 64 float32 modes 1 and 2, batch 64
   bf16 mode 2 and batch 256 bf16 mode 2 (state_mb the parameters' and
   moments' float32 bytes, the peak at or above the state, the step's own
   increment growing with the batch);
   ``batch_quality_study`` at batches 64 and 256 for 1 epoch of 1,024
   images; the
   ``mode_parity`` sweep at seeds 0 1 2 x modes 2 1 on 128 images for 1
   epoch with 512 validation and generated images, each record a
   subprocess of this script's ``--quality-child`` (quality's main with
   its launches counted and checked), one after another and each tried
   once, then ``combine``.
   Checks: exit codes and lines, finite values, each trainer's epochs'
   launches (K5 on every group update; K1-K5 of the CelebA steps and
   evaluations), one memory step's launches. Logs each part.
13. The profilers, as the port's modules, in this process at the
   published widths (CelebA-128, h=512, batch 64): ``profile_step`` at its
   defaults (bf16 mode 2, 8 traced steps after 3) and in float32 mode 1
   (4 steps), each top-15 kernel table printed; ``conv_breakdown`` in bf16
   and float32; ``bench_input_pipeline`` with ``--step-ms`` the bf16
   profile's step wall; ``stream_trace`` over 6 + STREAM_STEPS streamed
   steps, its trace read back by ``profile_step``'s report. Checks: K1-K5
   in each trace at ``expected_step_launches`` a step and counted by the
   wrappers at it for every step taken, all 14 conv rows finite and
   positive, the input record's keys and rates, the stream record's keys
   and its wall a step at or above the device's busy time.

Every phase ends in a line with its wall on the host clock, and the full
run prints them all on one line before the result lines. The line before
the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 and prints no result.
``--only build|kernels|serving|training|mnist|celeba|interp|utils|parallel|tp|quality|scripts|profilers``
runs a part of it (``scripts``: phases 11 and 12; for debugging, it then
prints no result lines either).

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
import contextlib
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
# 8,192 + 4,096 synthetic images (cut from MNIST's 60,000 + 10,000: 20,000
# when phase 9 came, 8,192 when the whole script outgrew its time on a
# slower host: 32 steps an epoch), 2 epochs, then resumed to 3.
MNIST_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 8192,
                   "synthetic_n_test": 4096, "num_epochs": 2,
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
# widths, the notebook's path (validation images 0 -> 32, 8 steps; its
# 500 Adam iterations cut to 250 to keep the script's time, on the card
# and in the CPU replay), on the demo configs' synthetic data.
INTERP_ARGS = ("--idx-start", "0", "--idx-end", "32", "--n-step", "8",
               "--n-iter", "250")
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
# Phase 8: the utilities. Prior samples (the device half of
# generate_samples_from_prior: 100 codes, one decode) of the five priors on
# the mnist_digit demo config at epoch 20 (sg_pretraining 10, accurate_fit
# 10, num_epochs 0: 'ours' and 'GMM' sample their accurate fit) and of
# CelebA-128 'ours' at epoch 12 (sg_pretraining 10, accurate_fit 3), held
# against the same draws decoded on the CPU; the exported paths of the
# CelebA-128 and mnist_digit engines against the live engines; one
# mnist_digit epoch with asynchronous checkpoints on 8,192 synthetic images;
# the FID of two synthetic CelebA sets of 256 images through the pretrained
# encoder, card against CPU.
UTILS_MNIST_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 512,
                         "synthetic_n_test": 256, "enable_plots": 0}
UTILS_CELEBA_OVERRIDES = {"enable_plots": 0}
UTILS_MNIST_EPOCH = 20
UTILS_MNIST_NAMES = {
    "ours": "generated_samples_prior_20_accurate-GM.pdf",
    "GMM": "generated_samples_prior_20_accurate-GM.pdf",
    "standard_gaussian": "generated_samples_prior_20.pdf",
    "hierarchical": "generated_samples_prior_20.pdf",
    "vampPrior": "generated_samples_prior_20.pdf"}
UTILS_CELEBA_EPOCH = 12
UTILS_CELEBA_NAME = "generated_samples_prior_12_accurate-GM.pdf"
# card vs CPU decodes of the same codes (GPU_CPU_MAX_ABS's reasoning)
SAMPLE_CPU_MAX_ABS = 1e-4
# an exported path vs the live engine, the same device and input
EXPORT_MAX_ABS = 1e-5
UTILS_LATENCY_REPEATS = 5
ASYNC_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 8192,
                   "synthetic_n_test": 2048, "num_epochs": 1,
                   "enable_plots": 0, "async_checkpoint": 1}
FID_IMAGES = 256
FID_RTOL = 1e-4
# GM_prior_info.npz's full weights sum to one (float32 sums of 50 terms)
GM_WEIGHT_SUM_TOL = 1e-4
SERVE_BATCH = 64
# bench_serving at the published widths: the JAX script's config and batch,
# its defaults (bf16, 50 iterations) and float32 at 20 iterations
BENCH_SERVING_CONFIG = "codes/celeba_config.json"
BENCH_SERVING_RUNS = ((), ("--dtype", "float32", "--iters", "20"))
# scripts/bench_serving.py's line, key for key ('generate_img_s' only
# with a GM fit on disk, after 'encode_device_img_s')
BENCH_SERVING_KEYS = ("metric", "batch", "dtype", "buckets",
                      "reconstruct_img_s", "decode_img_s", "encode_img_s",
                      "reconstruct_device_img_s", "decode_device_img_s",
                      "encode_device_img_s", "bucket_latency_ms",
                      "concurrent_1img_req_s")
# the serving paths that decode (serving/engine.py:run_path)
DECODING_PATHS = ("reconstruct", "decode", "decode_representation")
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

    if device != "cpu":  # the card's host: the CPU engine takes every core
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


def _bench_rates(line):
    """Every rate and latency of a bench_serving line, by name."""
    c = line["concurrent_1img_req_s"]
    return {**{k: v for k, v in line.items() if k.endswith("_img_s")},
            **line["bucket_latency_ms"],
            "direct": c["direct"], "micro_batched": c["micro_batched"]}


def drive_bench_serving(device, runs=BENCH_SERVING_RUNS,
                        config=BENCH_SERVING_CONFIG):
    """bench_serving's main once per run's arguments; every check of the
    part. The decoding device calls are counted by wrapping the engine
    module's run_path (the engine's paths and bench_serving's device rates
    call it) and InferenceEngine._render (generate) here; the norm-chain
    forward must launch 4 times per such call on a CUDA device."""
    import torch
    from ladder_tpu_torch import bench_serving
    from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu
    from ladder_tpu_torch.serving import engine as serving

    per_decode = 4 if torch.device(device).type == "cuda" else 0
    counter = fused_instnorm_style_lrelu
    run_path, render = serving.run_path, serving.InferenceEngine._render
    decodes = [0]

    def counted_path(model, name, x):
        decodes[0] += name in DECODING_PATHS
        return run_path(model, name, x)

    def counted_render(self, z):
        decodes[0] += 1
        return render(self, z)

    serving.run_path = counted_path
    serving.InferenceEngine._render = counted_render
    results = []
    try:
        for extra in runs:
            decodes[0], before = 0, counter.launches
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):  # process_config's dump
                record = bench_serving.main(
                    ["--config", config, *extra, "--device", device])
            seconds = time.perf_counter() - t0
            line = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("{")][-1]
            launches = counter.launches - before
            label = " ".join(extra) or "defaults"
            want = list(BENCH_SERVING_KEYS)
            if "generate_img_s" in record:
                want.insert(want.index("bucket_latency_ms"), "generate_img_s")
            rates = _bench_rates(record)
            bad = {k: v for k, v in rates.items()
                   if not (math.isfinite(v) and v > 0)}
            if json.loads(line) != record or list(record) != want:
                raise AssertionError(f"bench_serving ({label}): keys "
                                     f"{list(record)}, expected {want}")
            if bad or record["concurrent_1img_req_s"]["requests"] != 129:
                raise AssertionError(f"bench_serving ({label}): {bad}, "
                                     f"{record['concurrent_1img_req_s']}")
            if launches != per_decode * decodes[0] or decodes[0] <= 0:
                raise AssertionError(
                    f"bench_serving ({label}): {launches} norm-chain "
                    f"launches over {decodes[0]} decoding device calls, "
                    f"expected {per_decode} each")
            results.append({"label": label, "line": line, "record": record,
                            "seconds": seconds, "decodes": decodes[0],
                            "launches": launches})
    finally:
        serving.run_path = run_path
        serving.InferenceEngine._render = render
    return results


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


def expected_step_launches(cfg, mode, device, do_prior=True):
    """Launches of one train step, from what the step does: the decoder
    runs four norm-chain stages and compute_loss one output stage per
    forward pass; only the pass that differentiates the decoder (the 'ae'
    group) runs their backward kernels; every group update is one Adam
    launch. Mode 1 takes one forward pass per group, mode 2 one for all
    groups. Without do_prior (the epochs before sg_pretraining's last)
    only the ae and sigma groups update."""
    import torch
    from ladder_tpu_torch.training.step import group_keys
    if torch.device(device).type != "cuda":
        return dict.fromkeys(kernel_counters(), 0)
    groups = len([g for g in group_keys(cfg)
                  if do_prior or g in ("ae", "sigma")])
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


def _run_train_cli(workdir, config_path, device, extra=()):
    """ladder_tpu_torch.train.main in workdir (its result directory is
    relative to the working directory), ``extra`` added to its arguments;
    (trainer, its console output, seconds, kernel launches)."""
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
                                  device, *extra])
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


def expected_epoch_launches(cfg, mode, steps, evals, sg_overlap, device,
                            do_prior=True):
    """Launches of one CelebA epoch: its steps (in mode 2 on the epoch
    where prior training and the standard-gaussian pretraining overlap,
    the prior groups take a second forward pass, of loss_prior, which
    reaches no decoder backward), and ``evals`` forward passes of
    eval_step (the test batch and the validation batches), each one decode
    and one output stage. The GM fits' encodes launch none."""
    import torch
    step = expected_step_launches(cfg, mode, device, do_prior)
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
    made (timings[-1]['launches']) and each optimiser group's updates
    (timings[-1]['group_updates']), and the train step built by a trainer
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

        def make_train_step(model, *args, **kw):
            step = recorder.real_step(model, *args, **kw)

            def recorded(state, batch, *args, **kw):
                if len(recorder.batches) < recorder.keep:
                    recorder.batches.append(batch.clone())
                return step(state, batch, *args, **kw)
            return recorded

        def train_epoch(trainer):
            before = read_counters()
            t_before = {g: o["t"] for g, o in trainer.state["opt"].items()}
            recorder.real_epoch(trainer)
            trainer.timings[-1]["launches"] = {
                k: v - before[k] for k, v in read_counters().items()}
            trainer.timings[-1]["group_updates"] = adam_updates(trainer,
                                                                t_before)

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
        # the trainer's _do_prior: from sg_pretraining's last epoch on
        do_prior = t["epoch"] > cfg["sg_pretraining"] - 1
        overlap = do_prior and t["epoch"] <= cfg["sg_pretraining"]
        want = expected_epoch_launches(cfg, mode, steps, evals, overlap,
                                       device, do_prior)
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


def _check_epoch_group_launches(label, trainer):
    """Each epoch's Adam launches: one per group update of that epoch
    (during sg_pretraining the prior's groups take none)."""
    cuda = trainer.device.type == "cuda"
    for t in trainer.timings:
        want = sum(t["group_updates"].values()) if cuda else 0
        if t["launches"]["adam_update"] != want:
            raise AssertionError(f"{label}: epoch {t['epoch']} made "
                                 f"{t['launches']['adam_update']} Adam "
                                 f"launches, expected {want} "
                                 f"({t['group_updates']})")


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
    _check_epoch_group_launches(label, trainer)
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


PHASE8 = ("== phase 8: prior sampling, export, asynchronous checkpoints, FID "
          "and plots without matplotlib")


def _sampling_trainer(cfg, groups, gm, device, seed=0):
    """A JointTrainer (it reads no data) of cfg on device: a seeded init,
    then the checkpoint groups of ``groups`` that the prior has (the
    'vae-model' group always, 'prior-model' for an inner VAE); gm (w, m, K)
    as the fast and the accurate fit."""
    import torch
    from ladder_tpu_torch.models.builder import (PRIORS_WITH_INNER_VAE,
                                                 make_model)
    from ladder_tpu_torch.training.trainer import JointTrainer
    from ladder_tpu_torch.utils.checkpoint import load_msgpack

    model = make_model(cfg, seed=seed)
    params = model.flax_params()
    names = ["vae-model"] + (["prior-model"] if cfg["prior"]
                             in PRIORS_WITH_INNER_VAE else [])
    for name in names:
        params.update(load_msgpack(os.path.join(groups, f"{name}.msgpack")))
    model.load_flax_params(params)
    trainer = JointTrainer(model, None, cfg, device=device)
    trainer.gm_fast = trainer.gm_final = tuple(
        torch.tensor(np.asarray(a, np.float32), device=trainer.device)
        for a in gm)
    return trainer


def _gm_info(path):
    with np.load(path) as info:
        return tuple(info[k] for k in ("w_full", "m_full", "K_full"))


def _seeded_gm(k, d, seed):
    """A mixture of k components in d dimensions, made from seed."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, d, d)) / np.sqrt(d)
    return (rng.dirichlet(np.ones(k)), rng.standard_normal((k, d)),
            a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d))


def sample_prior(label, cfg, groups, gm, epoch, want_name, device):
    """The device half of generate_samples_from_prior at ``epoch`` on
    device, then the same draws through a CPU trainer of the same weights:
    the images' shape and filename, finite, within SAMPLE_CPU_MAX_ABS of
    the CPU's; the norm-chain launches of the call; the time of the call
    and of a second one."""
    from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu

    trainer = _sampling_trainer(cfg, groups, gm, device)
    trainer.cur_epoch = epoch
    seen = {}
    real_draws = trainer.prior_draws

    def prior_draws(*args, **kw):
        seen["draws"] = real_draws(*args, **kw)
        return seen["draws"]

    trainer.prior_draws = prior_draws
    before = fused_instnorm_style_lrelu.launches
    t0 = time.perf_counter()
    images, filename = trainer.prior_samples()
    seconds = time.perf_counter() - t0
    launches = fused_instnorm_style_lrelu.launches - before
    hw = (cfg["dim_input_x"], cfg["dim_input_y"], cfg["dim_input_channel"])
    if images.shape != (100,) + hw or not np.isfinite(images).all():
        raise AssertionError(f"{label}: prior samples {images.shape}, or "
                             "not finite")
    if os.path.basename(filename) != want_name:
        raise AssertionError(f"{label}: filename {filename}, expected "
                             f"{want_name}")
    # again: the first call pays for the decoder's first use at batch 100
    before_again = fused_instnorm_style_lrelu.launches
    t0 = time.perf_counter()
    trainer.prior_draws = real_draws
    trainer.prior_samples()
    seconds_again = time.perf_counter() - t0
    if fused_instnorm_style_lrelu.launches - before_again != launches:
        raise AssertionError(f"{label}: the second call launched the "
                             "norm-chain forward another number of times")
    cpu = _sampling_trainer(cfg, groups, gm, "cpu")
    cpu.model.load_flax_params(trainer.model.flax_params())
    codes = cpu.codes_from_draws({k: v.cpu()
                                  for k, v in seen["draws"].items()})
    gap = float(np.abs(images - cpu.fwd["decode"](codes).numpy()).max())
    if not gap <= SAMPLE_CPU_MAX_ABS:
        raise AssertionError(f"{label}: card vs CPU max abs {gap}")
    return {"label": label, "shape": images.shape,
            "name": os.path.basename(filename), "cpu_max_abs": gap,
            "seconds": seconds, "seconds_again": seconds_again,
            "launches": launches}


def drive_sampling(device, mnist_overrides=UTILS_MNIST_OVERRIDES,
                   celeba_overrides=UTILS_CELEBA_OVERRIDES,
                   mnist_groups=os.path.join(ROOT, "pretrained_models",
                                             "mnist_digit"),
                   celeba_groups=os.path.join(ROOT, "pretrained_models",
                                              "celeba")):
    """Prior samples of the five priors on the mnist_digit demo config
    (the pretrained groups where the prior has them, a seeded init for the
    vampPrior pseudo-inputs; the pretrained t-space GM, a seeded z-space
    GM for 'GMM'), then CelebA-128 'ours' with its accurate GM. A CelebA
    decode launches the norm-chain forward 4 times, an mnist one never."""
    import shutil
    import tempfile
    import torch

    cuda = torch.device(device).type == "cuda"
    runs = []
    work = tempfile.mkdtemp(prefix="chip_smoke_sampling_")
    try:
        t_gm = _gm_info(os.path.join(mnist_groups, "GM_prior_info.npz"))
        for prior in ("ours", "GMM", "standard_gaussian", "hierarchical",
                      "vampPrior"):
            cfg = _demo_config(MNIST_CONFIG, dict(mnist_overrides,
                                                  prior=prior),
                               os.path.dirname(mnist_groups),
                               os.path.join(work, prior))
            gm = (_seeded_gm(cfg["n_mixtures"], cfg["code_size"], 8)
                  if prior == "GMM" else t_gm)
            runs.append(sample_prior(f"mnist_digit {prior}", cfg,
                                     mnist_groups, gm, UTILS_MNIST_EPOCH,
                                     UTILS_MNIST_NAMES[prior], device))
            if runs[-1]["launches"]:
                raise AssertionError(f"{prior}: an mnist decode launched "
                                     "the norm-chain forward")
        cfg = _demo_config(CONFIG, celeba_overrides,
                           os.path.dirname(celeba_groups),
                           os.path.join(work, "celeba"))
        runs.append(sample_prior(
            "CelebA-128 ours", cfg, celeba_groups,
            _gm_info(os.path.join(celeba_groups, "GM_prior_info.npz")),
            UTILS_CELEBA_EPOCH, UTILS_CELEBA_NAME, device))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if runs[-1]["launches"] != (4 if cuda else 0):
        raise AssertionError(f"CelebA prior samples: "
                             f"{runs[-1]['launches']} norm-chain launches, "
                             "expected 4 (one decode)")
    return runs


def _median_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def export_engine(label, cfg, device, out_dir, serve_batch=SERVE_BATCH,
                  repeats=UTILS_LATENCY_REPEATS):
    """Export every path of an engine of cfg on device, load each back and
    hold it against the live engine on the same input (EXPORT_MAX_ABS);
    count the norm-chain launches of each loaded call (4 for a CelebA
    decoding path on a card) and time both, a median of ``repeats``."""
    import torch
    from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu
    from ladder_tpu_torch.serving import InferenceEngine
    from ladder_tpu_torch.serving.export import (export_inference,
                                                 load_exported)

    eng = InferenceEngine(cfg, device=device, serve_batch=serve_batch,
                          buckets=())
    t0 = time.perf_counter()
    paths = export_inference(eng, out_dir)
    export_s = time.perf_counter() - t0
    rng = np.random.default_rng(9)
    x = rng.random((serve_batch, cfg["dim_input_x"], cfg["dim_input_y"],
                    cfg["dim_input_channel"]), dtype=np.float32)
    mean = eng.encode(x)[0]
    inputs = {"encode": x, "reconstruct": x, "represent": x,
              "decode": mean}
    if "represent" in paths:
        inputs["decode_representation"] = eng.represent(x)[0]
    decodes = cfg["exp_name"] == "celeba" and torch.device(device).type \
        == "cuda"
    rows = {}
    for name, path in paths.items():
        call = load_exported(path)
        live = getattr(eng, name)

        def host(out):
            if isinstance(out, (tuple, list)):
                return tuple(o.cpu().numpy() for o in out)
            return out.cpu().numpy()

        before = fused_instnorm_style_lrelu.launches
        got = host(call(inputs[name]))
        launches = fused_instnorm_style_lrelu.launches - before
        want = live(inputs[name])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if len(got) != len(want) or not gap <= EXPORT_MAX_ABS:
            raise AssertionError(f"{label} {name}: exported vs engine max "
                                 f"abs {gap}")
        want_launches = 4 if decodes and name in (
            "decode", "reconstruct", "decode_representation") else 0
        if launches != want_launches:
            raise AssertionError(f"{label} {name}: the exported graph "
                                 f"launched the norm-chain forward "
                                 f"{launches} times, expected "
                                 f"{want_launches}")
        rows[name] = {
            "max_abs": gap, "launches": launches,
            "exported_ms": _median_ms(lambda: host(call(inputs[name])),
                                      repeats),
            "engine_ms": _median_ms(lambda: live(inputs[name]), repeats)}
    return {"label": label, "export_s": export_s, "paths": rows}


def drive_export(device, celeba_cfg, mnist_cfg, serve_batch=SERVE_BATCH,
                 repeats=UTILS_LATENCY_REPEATS):
    """Phase 8's exports: the CelebA-128 'ours' engine (float32, TF32 off)
    and the mnist_digit engine, from the pretrained groups."""
    import shutil
    import tempfile
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        out = [export_engine("CelebA-128 ours", celeba_cfg, device,
                             os.path.join(work, "celeba"), serve_batch,
                             repeats)]
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        out.append(export_engine("mnist_digit ours", mnist_cfg, device,
                                 os.path.join(work, "mnist"), serve_batch,
                                 repeats))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _timed_save(trainer, manager):
    """The trainer's end-of-epoch save (both groups and the train state)
    through manager: (seconds until it returned, seconds until it was on
    disk)."""
    from ladder_tpu_torch.models.builder import PRIORS_WITH_PRIOR_MODEL
    real = trainer.ckpt
    trainer.ckpt = manager
    try:
        t0 = time.perf_counter()
        manager.save(trainer.model.flax_params(),
                     model="joint" if trainer.prior
                     in PRIORS_WITH_PRIOR_MODEL else "VAE")
        trainer.save_full_state()
        blocked = time.perf_counter() - t0
        manager.flush()
        return blocked, time.perf_counter() - t0
    finally:
        trainer.ckpt = real


CHECKPOINT_FILES = ("vae-model.msgpack", "prior-model.msgpack",
                    "train-state.msgpack")


def _same_files(label, a, b):
    for name in CHECKPOINT_FILES:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{label}: {name} differs")


def drive_async(device, overrides=ASYNC_OVERRIDES,
                groups=os.path.join(ROOT, "pretrained_models",
                                    "mnist_digit")):
    """One epoch of the pretrained mnist_digit model through the train CLI
    with async_checkpoint 1; its files against a synchronous save of the
    same state, byte for byte; then the time a save blocks the epoch, both
    ways, on that state."""
    import shutil
    import tempfile
    from ladder_tpu_torch.utils.checkpoint import CheckpointManager

    work = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        _copy_groups(groups, work, "mnist_digit")
        run = _train_run("mnist_digit async-checkpoint run",
                         mnist_config(dict(overrides, load_dir=work + "/")),
                         work, device, (1,), {})
        trainer = run["trainer"]
        written = os.path.join(work, trainer.config["checkpoint_dir"])
        times = {}
        for flag in (0, 1):
            ckdir = os.path.join(work, f"save_{flag}") + "/"
            os.makedirs(ckdir)
            manager = CheckpointManager(dict(trainer.config,
                                             checkpoint_dir=ckdir,
                                             async_checkpoint=flag))
            times[flag] = _timed_save(trainer, manager)
        _same_files("async run vs a synchronous save", written,
                    os.path.join(work, "save_0"))
        _same_files("async save vs synchronous save",
                    os.path.join(work, "save_1"), os.path.join(work, "save_0"))
        sizes = {n: os.path.getsize(os.path.join(written, n))
                 for n in CHECKPOINT_FILES}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"run": run, "sync_s": times[0], "async_s": times[1],
            "bytes": sizes}


def drive_fid(device, cfg, n_images=FID_IMAGES):
    """FID of two seeded synthetic CelebA sets through the pretrained
    encoder (encoder_feature_fn) on device and on the CPU."""
    import shutil
    import tempfile
    from ladder_tpu_torch.data.celeba import synthetic_celeba_images
    from ladder_tpu_torch.utils.fid import (compute_FID_score,
                                            encoder_feature_fn)

    work = tempfile.mkdtemp(prefix="chip_smoke_fid_")
    try:
        files = []
        for seed in (11, 12):
            path = os.path.join(work, f"set{seed}.npz")
            np.savez(path, sampled_images=synthetic_celeba_images(
                n_images, seed=seed))
            files.append(path)
        scores = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            scores[dev] = (compute_FID_score(
                *files, feature_fn=encoder_feature_fn(cfg, device=dev),
                second_set="original"), time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card, cpu = scores[device][0], scores["cpu"][0]
    rel = abs(card - cpu) / abs(cpu)
    if not (np.isfinite(card) and rel <= FID_RTOL):
        raise AssertionError(f"FID on {device} {card} vs CPU {cpu}: "
                             f"relative {rel}")
    return {"card": card, "cpu": cpu, "rel": rel,
            "card_s": scores[device][1], "cpu_s": scores["cpu"][1],
            "images": n_images}


def plots_refused(device, overrides=UTILS_MNIST_OVERRIDES):
    """A trainer with enable_plots 1 and no matplotlib raises an
    ImportError that names it at construction. Where matplotlib is
    installed it is blocked for the check."""
    import importlib.util
    from ladder_tpu_torch.data.mnist import DataGenerator
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.trainer import MNISTTrainer

    installed = importlib.util.find_spec("matplotlib") is not None
    cfg = mnist_config(dict(overrides, enable_plots=1))
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "matplotlib" or k.startswith("matplotlib.")}
    sys.modules["matplotlib"] = None
    try:
        MNISTTrainer(make_model(cfg), DataGenerator(cfg), cfg, device=device)
    except ImportError as e:
        if "matplotlib" not in str(e):
            raise AssertionError(f"the ImportError does not name "
                                 f"matplotlib: {e}")
        return {"message": str(e), "installed": installed}
    finally:
        del sys.modules["matplotlib"]
        sys.modules.update(saved)
    raise AssertionError("a trainer with enable_plots 1 and no matplotlib "
                         "was built")


def drive_utils(device, sampling=None, export_cfgs=None, fid_cfg=None,
                fid_images=FID_IMAGES, serve_batch=SERVE_BATCH,
                repeats=UTILS_LATENCY_REPEATS,
                async_overrides=ASYNC_OVERRIDES):
    """Phase 8: each part's checks, on the pretrained models unless the
    caller gives smaller ones (sampling: drive_sampling's keywords;
    export_cfgs: the CelebA and the mnist engine's configs; fid_cfg: the
    encoder's); the kernel launches of the phase, counted from 0."""
    import torch
    from ladder_tpu_torch.utils.config import process_config

    out = {}
    launches = dict.fromkeys(kernel_counters(), 0)

    def part(key, fn, *args):
        # each part counts from 0 (the train CLI's runs reset the counts)
        reset_counters()
        out[key] = fn(*args)
        for k, v in read_counters().items():
            launches[k] += v
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    part("sampling", lambda: drive_sampling(device, **(sampling or {})))
    part("export", drive_export, device,
         *(export_cfgs or (process_config(CONFIG),
                           process_config(MNIST_CONFIG))),
         serve_batch, repeats)
    part("async", drive_async, device, async_overrides)
    part("fid", drive_fid, device, fid_cfg or process_config(CONFIG),
         fid_images)
    part("plots", plots_refused, device)
    out["launches"] = launches
    return out


def log_utils(result, smi):
    for run in result["sampling"]:
        log(f"  prior samples {run['label']} on {smi}: {run['shape']} "
            f"'{run['name']}', card vs CPU max abs {run['cpu_max_abs']:.3g} "
            f"(bound {SAMPLE_CPU_MAX_ABS}); {1e3 * run['seconds']:.1f} ms, "
            f"again {1e3 * run['seconds_again']:.1f} ms (draws, codes, one "
            f"decode, copy); norm-chain launches {run['launches']} a call")
    for exp in result["export"]:
        log(f"  export {exp['label']} on {smi}: {exp['export_s']:.2f} s for "
            f"{len(exp['paths'])} paths")
        for name, row in exp["paths"].items():
            log(f"    {name}: loaded vs engine max abs {row['max_abs']:.3g} "
                f"(bound {EXPORT_MAX_ABS}); norm-chain launches "
                f"{row['launches']}; median of {UTILS_LATENCY_REPEATS} at "
                f"batch {SERVE_BATCH}: loaded {row['exported_ms']:.2f} ms, "
                f"engine {row['engine_ms']:.2f} ms")
    asy = result["async"]
    log(f"  async checkpoints on {smi}: the run's files and an async save "
        f"equal a synchronous save byte for byte ({asy['bytes']}); a save "
        f"blocks the epoch {1e3 * asy['sync_s'][0]:.1f} ms synchronous, "
        f"{1e3 * asy['async_s'][0]:.1f} ms asynchronous (on disk after "
        f"{1e3 * asy['async_s'][1]:.1f} ms); the run {asy['run']['seconds']:.2f}"
        f" s, launches {asy['run']['launches']}")
    _log_epochs(asy["run"]["trainer"],
                asy["run"]["trainer"].config["batch_size"])
    fid = result["fid"]
    log(f"  FID of two synthetic CelebA sets of {fid['images']} through the "
        f"pretrained encoder: {fid['card']:.6f} on {smi} "
        f"({fid['card_s']:.2f} s), {fid['cpu']:.6f} on the CPU "
        f"({fid['cpu_s']:.2f} s), relative {fid['rel']:.3g} (bound "
        f"{FID_RTOL})")
    plots = result["plots"]
    log(f"  enable_plots 1 without matplotlib (installed here: "
        f"{plots['installed']}): ImportError '{plots['message']}'")
    log(f"  phase 8 launches {result['launches']}")


# ---------------------------------------------------------------------------
# phase 9: data-parallel training across processes through torchrun
# ---------------------------------------------------------------------------

PHASE9 = ("== phase 9: data-parallel training through torchrun -m "
          "ladder_tpu_torch.train (2 gloo ranks on the one card, 1 NCCL "
          "rank)")
# (1) parity: the pretrained CelebA-128 'ours' model (demo/celeba_config.json)
# in float32 mode 1, TF32 off, on 256 train / 128 validation / 128 test
# synthetic images: 1 epoch, 4 steps at global batch 64, as one process and
# as 2 gloo ranks x 32 rows on the one card
PARALLEL_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 256,
                      "synthetic_n_val": 128, "synthetic_n_test": 128,
                      "num_epochs": 1, "sg_pretraining": 1,
                      "accurate_fit": 2, "enable_plots": 0,
                      "mesh_shape": [2]}
PARALLEL_RANKS = 2
# 2 ranks against 1 process: the first-step loss within the card-vs-CPU
# bound of a first step (TRAIN_METRIC_RTOL, the same ops summed in another
# order), the curves within tests/test_multiprocess.py:200-212's band, the
# parameters after the epoch within TRAIN_PARAM_MAX_LR lr per step taken
# (each step may flip the sign of a gradient of rounding size, which Adam
# turns into a step of lr either way)
PARALLEL_CURVE_RTOL = 2e-3
# (2) the repo's scaled recipe as it stands, cut: 2 gloo ranks on the one
# card instead of 8 (mesh_shape [8] over 2 ranks), a fresh init from the
# seed, 2,048 synthetic images (128 validation, 64 test), 1 epoch, global
# batch 512 (256 rows a rank)
SCALED_CONFIG = "codes/celeba_scaled_config.json"
SCALED_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 2048,
                    "synthetic_n_val": 128, "synthetic_n_test": 64,
                    "num_epochs": 1, "enable_plots": 0}
# bf16, one process against 2 ranks, first-step loss: the same bf16
# arithmetic per row, but cuDNN may pick other algorithms at 512 rows than at
# 256, and each bf16 activation then rounds differently (2**-8 relative);
# the loss sums them over 512 x 49,152 pixels, where they average out far
# below 1e-2 (phase 6 holds bf16 against float32 within 5e-2)
SCALED_LOSS_RTOL = 1e-2
# (3) the pretrained mnist_digit model (demo/mnist_digit_config.json), 2
# ranks x 128 rows on 4,096 synthetic images, 1 epoch then resumed to 2; plots
# off (the card's machine has no matplotlib: tests/test_torch_multiprocess.py
# runs the lead-only plots on the CPU)
PARALLEL_MNIST_OVERRIDES = {"synthetic_data": 1, "synthetic_n_train": 4096,
                            "synthetic_n_test": 2048, "num_epochs": 1,
                            "sg_pretraining": 1, "accurate_fit": 2,
                            "enable_plots": 0, "mesh_shape": [2]}


def _torchrun(work, config_path, nproc, device=None, backend=None,
              package=ROOT):
    """Start LADDER_DISTRIBUTED=1 torchrun --standalone --nproc_per_node
    nproc -m ladder_tpu_torch.train --config config_path in work, each rank
    writing work/report{rank}.json; (process, start time)."""
    env = dict(os.environ, LADDER_DISTRIBUTED="1",
               PYTHONPATH=os.pathsep.join(
                   [package] + [p for p in [os.environ.get("PYTHONPATH")]
                                if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "ladder_tpu_torch.train",
           "--config", config_path,
           "--report", os.path.join(work, "report{rank}.json")]
    cmd += ["--device", device] if device else []
    cmd += ["--backend", backend] if backend else []
    proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter()


def _finish(started, timeout=600):
    """Wait for a _torchrun; (exit code, output, seconds)."""
    proc, t0 = started
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, time.perf_counter() - t0


def _ranks_run(label, work, config_path, nproc, device=None, backend=None,
               started=None):
    """A torchrun run (started here, or given as ``started``) that must
    succeed; its ranks' reports, which must hold bitwise-equal parameters,
    moments and GM fits."""
    code, out, seconds = _finish(
        started or _torchrun(work, config_path, nproc, device, backend))
    if code != 0:
        raise AssertionError(f"{label}: torchrun exited {code}:\n"
                             f"{out[-6000:]}")
    reports = []
    for r in range(nproc):
        with open(os.path.join(work, f"report{r}.json")) as f:
            reports.append(json.load(f))
    if len({r["digest"] for r in reports}) != 1:
        raise AssertionError(f"{label}: the ranks' parameters, moments and "
                             "GM fits differ")
    if [(r["rank"], r["world"]) for r in reports] != [
            (r, nproc) for r in range(nproc)]:
        raise AssertionError(f"{label}: ranks {[r['rank'] for r in reports]}")
    return {"label": label, "reports": reports, "seconds": seconds,
            "out": out}


def _one_run(label, work, config_path, device):
    """The same CLI in this process, without LADDER_DISTRIBUTED; its
    report and launches."""
    report = os.path.join(work, "report0.json")
    trainer, out, seconds, launches = _run_train_cli(
        work, config_path, device, ("--report", report))
    with open(report) as f:
        rep = json.load(f)
    return {"label": label, "reports": [rep], "seconds": seconds,
            "out": out, "trainer": trainer, "launches": launches}


def _write_config(work, name, raw):
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _results(work, cfg):
    """The lead's {exp}-result.npz in work, as a dict."""
    from ladder_tpu_torch.utils.config import process_config
    import contextlib
    with contextlib.redirect_stdout(io.StringIO()):
        dirs = process_config(os.path.join(work, "config.json"))
    path = os.path.join(work, dirs["result_dir"],
                        f"{cfg['exp_name']}-result.npz")
    with np.load(path) as r:
        return {k: r[k] for k in r.files}, dirs


# the curves held to PARALLEL_CURVE_RTOL: tests/test_multiprocess.py's
# (train loss, sigma, validation loss) and the ELBO's
PARALLEL_CURVES = ("train_loss", "elbo_train", "sigma", "val_loss",
                   "elbo_val")


def _curve_gaps(got, want):
    """Per curve both results hold, the largest relative gap (each value
    relative to the larger of its |value| and 1e-6 of the curve's
    largest); raises on a curve of another shape or not finite."""
    gaps = {}
    for key, w in want.items():
        a, b = np.asarray(got[key], float), np.asarray(w, float)
        if a.shape != b.shape:
            raise AssertionError(f"curve {key}: {a.shape} vs {b.shape}")
        if not b.size:
            continue
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"curve {key} is not finite")
        scale = np.maximum(np.abs(b), 1e-6 * np.abs(b).max() + 1e-30)
        gaps[key] = float((np.abs(a - b) / scale).max())
    return gaps


def _param_gap(work_a, work_b, dirs_a, dirs_b, lr):
    """max and mean |a - b| over both checkpoint groups, in units of lr."""
    from ladder_tpu_torch.utils.checkpoint import load_msgpack
    worst, total, n = 0.0, 0.0, 0
    for name in ("vae-model.msgpack", "prior-model.msgpack"):
        a = load_msgpack(os.path.join(work_a, dirs_a["checkpoint_dir"], name))
        b = load_msgpack(os.path.join(work_b, dirs_b["checkpoint_dir"], name))
        for x, y in zip(_tree_leaves(a), _tree_leaves(b)):
            d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
            worst = max(worst, float(d.max()) if d.size else 0.0)
            total += float(d.sum())
            n += d.size
    return worst / lr, total / max(n, 1) / lr


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k])
    else:
        yield tree


def _epoch_launches(cfg, mode, steps, evals, device):
    """Launches of one CelebA epoch (expected_epoch_launches), with the
    prior groups only where prior training has started (cur_epoch 1 >
    sg_pretraining - 1)."""
    import torch
    if 1 > cfg["sg_pretraining"] - 1:
        return expected_epoch_launches(cfg, mode, steps, evals,
                                       1 <= cfg["sg_pretraining"], device)
    if torch.device(device).type != "cuda":
        return dict.fromkeys(kernel_counters(), 0)
    passes = 2 if mode == 1 else 1  # ae and sigma
    return {"norm_chain_fwd": 4 * passes * steps + 4 * evals,
            "norm_chain_bwd": 4 * steps,
            "output_stage_fwd": passes * steps + evals,
            "output_stage_bwd": steps, "adam_update": 2 * steps}


def _check_rank_launches(label, run, want):
    for rep in run["reports"]:
        if rep["launches"] != want:
            raise AssertionError(f"{label}: rank {rep['rank']} launched "
                                 f"{rep['launches']}, expected {want}")


def local_batch_kernel_checks(batch):
    """K1, K3 and K4 against their plain versions once at a rank's local
    batch (float32), a grid that phase 2's batch-64 checks do not cover.
    Returns each check's max abs error."""
    import torch
    from ladder_tpu_torch.ops import norm_chain as nc
    from ladder_tpu_torch.ops import output_stage as ost

    gen = torch.Generator(device="cuda").manual_seed(9)
    errs = {}
    for shape, _ in NORM_CHAIN_STAGES:
        shape = (batch,) + tuple(shape[1:])
        x, scale, shift = _norm_chain_inputs(shape, torch.float32, gen)
        got = nc.fused_instnorm_style_lrelu(x, scale, shift)
        torch.cuda.synchronize()
        name = f"norm_chain_fwd {list(shape)}"
        errs[name] = _hold_rounded(name, got, nc.norm_chain_reference(
            x, scale, shift), torch.float32)
    b, c, h, w = (batch,) + tuple(OUTPUT_STAGE_SHAPE[1:])
    weight = 0.2 * torch.randn((3, c), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((3,), generator=gen, device="cuda")
    target = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    u = torch.randn((b, c, h, w), generator=gen, device="cuda")
    dec, l1, l2 = ost.fused_output_recon(u, weight, bias, target)
    torch.cuda.synchronize()
    dec_p, l1_p, l2_p = ost.output_recon_reference(u, weight, bias, target)
    name = f"output_stage_fwd {[b, c, h, w]}"
    errs[name] = _hold_rounded(name, dec, dec_p, torch.float32)
    _hold(name + " l1", l1, l1_p, 1e-5, 0.0)
    _hold(name + " l2", l2, l2_p, 1e-5, 0.0)
    a1 = torch.tensor(0.03, device="cuda")
    a2 = torch.tensor(0.01, device="cuda")
    got = ost.output_recon_backward(u, weight, dec, target, a1, a2, None)
    torch.cuda.synchronize()
    want = ost.output_recon_bwd_reference(u, weight, dec, target, a1, a2,
                                          None)
    name = f"output_stage_bwd {[b, c, h, w]}"
    errs[name] = max(
        _hold_rounded(name + " du", got[0], want[0], torch.float32),
        *(_hold(f"{name} {part}", a, p_, SUM_RTOL,
                SUM_RTOL * p_.abs().max().item())
          for part, a, p_ in (("dW8", got[1], want[1]),
                              ("db8", got[2], want[2]))))
    return errs


def drive_parallel(device, overrides=PARALLEL_OVERRIDES,
                   scaled_overrides=SCALED_OVERRIDES,
                   mnist_overrides=PARALLEL_MNIST_OVERRIDES,
                   groups=os.path.join(ROOT, "pretrained_models", "celeba"),
                   mnist_groups=os.path.join(ROOT, "pretrained_models",
                                             "mnist_digit"),
                   ranks=PARALLEL_RANKS, profile=True):
    """Phase 9 (see the module docstring); every check of the phase.
    ``device`` is the card's 'cuda' or, to rehearse, 'cpu' (the ranks on
    the CPU over gloo, the NCCL runs replaced by one gloo rank).
    ``profile``: trace the first epoch of the runs of (1) and (2). The runs
    whose times are logged run alone; the NCCL runs run beside (3)."""
    import shutil
    import tempfile
    import torch
    from ladder_tpu_torch.data.celeba import ensure_synthetic_tfrecords
    from ladder_tpu_torch.training import schedules
    from ladder_tpu_torch.utils.config import apply_defaults

    on_card = torch.device(device).type == "cuda"
    rank_device = "cuda:0" if on_card else "cpu"
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    res = {"runs": {}}

    def config(name, raw, prof):
        w = os.path.join(work, name)
        if prof and profile:
            raw = dict(raw, profile_dir=os.path.join(w, "profile"))
        return w, _write_config(w, "config.json", raw)

    try:
        cfg = celeba_config(overrides)
        with open(os.path.join(ROOT, SCALED_CONFIG)) as f:
            scfg = apply_defaults(dict(json.load(f), **scaled_overrides))
        sdata = os.path.join(work, "scaled_data") + "/"
        # (2)'s synthetic TFRecords, written while (1) runs
        synth = threading.Thread(target=ensure_synthetic_tfrecords, args=(
            sdata, scfg["synthetic_n_train"], scfg["synthetic_n_val"],
            scfg["synthetic_n_test"], scfg["seed"], scfg["dim_input_x"]))
        synth.start()

        # ---- (1) parity: one process, then the ranks --------------------
        bs = cfg["batch_size"]
        steps = cfg["synthetic_n_train"] // bs
        evals = 1 + cfg["synthetic_n_val"] // bs
        data = os.path.join(work, "celeba_data") + "/"
        runs = {}
        for name in ("one", "ranks", "nccl"):
            w = os.path.join(work, f"parity_{name}")
            _copy_groups(groups, w, cfg["exp_name"])
            w, path = config(f"parity_{name}", dict(
                cfg, data_path=data, load_dir=w + "/"), name != "nccl")
            if name == "one":
                runs[name] = _one_run("parity, one process", w, path, device)
                runs[name].pop("trainer")
            elif name == "ranks":
                runs[name] = _ranks_run(
                    f"parity, {ranks} gloo ranks", w, path, ranks,
                    rank_device, "gloo")
            else:  # run beside (3)
                runs[name] = {"path": path}
            runs[name]["work"] = w
        if on_card:
            res["local_batch"] = local_batch_kernel_checks(bs // ranks)
        synth.join()

        # ---- (2) the scaled recipe --------------------------------------
        sruns = {}
        for name in ("ranks", "one"):
            w, path = config(f"scaled_{name}", dict(scfg, data_path=sdata),
                             True)
            if name == "ranks":
                sruns[name] = _ranks_run(f"scaled recipe, {ranks} gloo ranks",
                                         w, path, ranks, rank_device, "gloo")
            else:
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                sruns[name] = _one_run("scaled recipe, one process", w, path,
                                       device)
                sruns[name].pop("trainer")
                if on_card:
                    torch.cuda.empty_cache()
            sruns[name]["work"] = w

        # ---- (3) the mnist trainer, the NCCL runs beside it -------------
        nccl = runs["nccl"]
        nccl["started"] = _torchrun(nccl["work"], nccl["path"], 1,
                                    None if on_card else "cpu")
        dup = None
        if on_card:  # NCCL refuses two ranks on one card: the CLI says so
            w = os.path.join(work, "nccl_two")
            _copy_groups(groups, w, cfg["exp_name"])
            w, path = config("nccl_two", dict(cfg, data_path=data,
                                              load_dir=w + "/"), False)
            dup = _torchrun(w, path, 2, "cuda:0", "nccl")
        mcfg = mnist_config(mnist_overrides)
        mruns = {}
        for name, epochs in (("ranks", 1), ("resumed", 2), ("one", 1)):
            w = os.path.join(work, "mnist_one" if name == "one"
                             else "mnist_ranks")
            if not os.path.isdir(w):
                _copy_groups(mnist_groups, w, mcfg["exp_name"])
            w, path = config(os.path.basename(w), dict(
                mcfg, load_dir=w + "/", num_epochs=epochs), False)
            if name == "one":
                mruns[name] = _one_run("mnist, one process", w, path, device)
                mruns[name].pop("trainer")
            else:
                mruns[name] = _ranks_run(f"mnist to epoch {epochs}, {ranks} "
                                         "gloo ranks", w, path, ranks,
                                         rank_device, "gloo")
                mruns[name]["files"] = _artifact_files(w)
            mruns[name]["work"] = w
        runs["nccl"] = _ranks_run(
            "parity, 1 NCCL rank" if on_card else "parity, 1 gloo rank",
            nccl["work"], None, 1, started=nccl["started"])
        runs["nccl"]["work"] = nccl["work"]
        if dup is not None:
            code, said, _ = _finish(dup)
            if code == 0 or "same card" not in said:
                raise AssertionError("two NCCL ranks on one card did not "
                                     f"raise:\n{said[-3000:]}")

        # ---- the checks -------------------------------------------------
        want = _epoch_launches(cfg, 1, steps, evals, device)
        one = runs["one"]
        if one["launches"] != want:
            raise AssertionError(f"parity, one process: launched "
                                 f"{one['launches']}, expected {want}")
        want_results, want_dirs = _results(one["work"], cfg)
        lr = max(max(schedules.all_lrs(cfg, 1).values()),
                 schedules.lr_ae_celeba(cfg, 1))
        for name in ("ranks", "nccl"):
            run = runs[name]
            _check_rank_launches(run["label"], run, want)
            first = run["reports"][0]["train_loss"][0]
            ref = one["reports"][0]["train_loss"][0]
            run["first_loss_gap"] = abs(first / ref - 1)
            if run["first_loss_gap"] > TRAIN_METRIC_RTOL:
                raise AssertionError(f"{run['label']}: first-step loss "
                                     f"{first} vs one process {ref}")
            got_results, got_dirs = _results(run["work"], cfg)
            run["curve_gaps"] = _curve_gaps(got_results, want_results)
            run["curve_gap"] = max(run["curve_gaps"][k]
                                   for k in PARALLEL_CURVES)
            if run["curve_gap"] > PARALLEL_CURVE_RTOL:
                raise AssertionError(f"{run['label']}: curves "
                                     f"{run['curve_gaps']} from one "
                                     "process's")
            run["param_gap"] = _param_gap(run["work"], one["work"], got_dirs,
                                          want_dirs, lr)
            if run["param_gap"][0] > TRAIN_PARAM_MAX_LR * steps:
                raise AssertionError(f"{run['label']}: parameters "
                                     f"{run['param_gap'][0]} lr from one "
                                     "process's")
        ssteps = scfg["synthetic_n_train"] // scfg["batch_size"]
        want = _epoch_launches(scfg, scfg["fused_train_step"], ssteps,
                               1 + scfg["synthetic_n_val"] // scfg[
                                   "batch_size"], device)
        _check_rank_launches("scaled recipe", sruns["ranks"], want)
        results, _ = _results(sruns["ranks"]["work"], scfg)
        _curve_gaps(results, results)  # finite
        first = sruns["ranks"]["reports"][0]["train_loss"][0]
        ref = sruns["one"]["reports"][0]["train_loss"][0]
        sruns["ranks"]["first_loss_gap"] = abs(first / ref - 1)
        if sruns["ranks"]["first_loss_gap"] > SCALED_LOSS_RTOL:
            raise AssertionError(f"scaled recipe: first-step loss {first} on "
                                 f"the ranks vs {ref} in one process")
        _check_parallel_mnist(mruns, mcfg, on_card)
        for prefix, group in (("parity", runs), ("scaled", sruns),
                              ("mnist", mruns)):
            res["runs"].update({f"{prefix}_{k}": v for k, v in group.items()})
        res.update(cfg=cfg, steps=steps, scaled_cfg=scfg,
                   scaled_steps=ssteps, mnist_cfg=mcfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


def _artifact_files(work):
    """The files a run wrote under work, less the reports, the configs and
    the copied checkpoint groups' directory listing itself."""
    out = []
    for root, _, files in os.walk(work):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), work)
            if (name.startswith(("report", "training_config_"))
                    or name == "config.json" or rel.startswith("profile")):
                continue
            out.append(rel)
    return sorted(out)


def _check_parallel_mnist(runs, cfg, on_card):
    """Every artifact once, by the lead: the same files as one process's
    and one summary line per epoch; the result keys as one process's; the
    ranks' GM fits (in the digest) and validation curves equal; the resume
    on both ranks; the Adam kernel on both ranks."""
    one = _artifact_files(runs["one"]["work"])
    if runs["ranks"]["files"] != one:
        raise AssertionError(f"mnist: the ranks wrote {runs['ranks']['files']}"
                             f", one process {one}")
    for name, epochs in (("ranks", 1), ("resumed", 2)):
        run = runs[name]
        reps = run["reports"]
        if len({json.dumps(r["val_loss"]) for r in reps}) != 1:
            raise AssertionError(f"{run['label']}: validation differs across "
                                 "ranks")
        if any([t["epoch"] for t in r["timings"]] != [epochs] for r in reps):
            raise AssertionError(f"{run['label']}: the ranks trained "
                                 f"{[[t['epoch'] for t in r['timings']] for r in reps]}")
        if len({json.dumps(r["launches"]) for r in reps}) != 1 or (
                on_card and reps[0]["launches"]["adam_update"] <= 0):
            raise AssertionError(f"{run['label']}: launches "
                                 f"{[r['launches'] for r in reps]}")
    summary = [f for f in runs["resumed"]["files"] if f.endswith(
        "scalars.jsonl")]
    with open(os.path.join(runs["resumed"]["work"], summary[0])) as f:
        if len(f.read().splitlines()) != 2:
            raise AssertionError("mnist: scalars.jsonl does not hold one line "
                                 "per epoch")
    if "Full train state restored (epoch 1)." not in runs["resumed"]["out"]:
        raise AssertionError("mnist: the resumed ranks did not restore the "
                             "full train state of epoch 1")
    keys = [sorted(_results(runs[n]["work"], cfg)[0]) for n in
            ("resumed", "one")]
    if keys[0] != keys[1] or keys[1] != sorted(RESULT_KEYS):
        raise AssertionError(f"mnist: result keys {keys}")


def _per_step(run, steps):
    """Per rank: the step time of steps 2-N under the profiler (its
    window over its steps) and of the whole epoch (wall over steps, the
    first step's warm-up included), the gradient all-reduce's MB, calls
    and host ms a step (and every collective's, by tag), the profile's
    summary, the state's bytes at rest and the memory allocated between
    steps (a sharded state), and the peak memory."""
    out = []
    for rep in run["reports"]:
        t = rep["timings"][0]
        coll = (t.get("collectives") or {}).get("grad")
        prof = t.get("profile")
        out.append({
            "collectives": {
                tag: {"mb": c["bytes"] / steps / 1e6,
                      "calls": c["calls"] / steps,
                      "host_ms": c["seconds"] / steps * 1e3}
                for tag, c in (t.get("collectives") or {}).items()},
            "state_bytes": t.get("state_bytes"),
            "allocated_gb": (t["memory_allocated"] / 1e9
                             if t.get("memory_allocated") else None),
            "step_ms": t["train"]["step_ms"],
            "profiled_step_ms": (prof["wall_ms"] / prof["steps"]
                                 if prof else None),
            "grad_mb": coll["bytes"] / steps / 1e6 if coll else None,
            "grad_calls": coll["calls"] / steps if coll else None,
            "grad_host_ms": coll["seconds"] / steps * 1e3 if coll else None,
            "profile": prof,
            "peak_gb": (rep["peak_memory_bytes"] / 1e9
                        if rep["peak_memory_bytes"] else None)})
    return out


def _fmt_profile(p):
    if not p:
        return "no profile (not measured)"
    coll = ", ".join(f"{k} {v[1]:.2f} ms x{v[0]}" for k, v in
                     sorted(p["collectives_ms"].items()))
    return (f"profile of steps 2-{p['steps'] + 1}: device busy "
            f"{p['device_busy_ms']:.2f} of {p['wall_ms']:.2f} ms (idle "
            f"share {p['idle_share']:.1%}), host<->device copies "
            f"{p['copy_ms']:.2f} ms, collectives on the host: "
            f"{coll or 'none'}")


def log_parallel(res, smi):
    runs = res["runs"]
    for part, steps, bs in (
            ("parity", res["steps"], res["cfg"]["batch_size"]),
            ("scaled", res["scaled_steps"], res["scaled_cfg"]["batch_size"])):
        log(f"  ({'1' if part == 'parity' else '2'}) {part} runs on {smi} "
            "(the ranks share one card in time: no scaling number)")
        for key in sorted(k for k in runs if k.startswith(part)
                          and k != "parity_nccl"):
            run = runs[key]
            log(f"    {run['label']}: {run['seconds']:.1f} s in all")
            for rep, st in zip(run["reports"], _per_step(run, steps)):
                line = (f"      rank {rep['rank']}/{rep['world']} "
                        f"({rep['backend'] or 'no group'}) at global batch "
                        f"{bs}: step " + (
                            f"{st['profiled_step_ms']:.2f} ms (steps 2-"
                            f"{st['profile']['steps'] + 1}, profiler on), "
                            if st["profiled_step_ms"] else "")
                        + f"{st['step_ms']:.2f} ms over the epoch with its "
                        "first step")
                if st["grad_mb"] is not None:
                    line += (f"; gradient all-reduce {st['grad_mb']:.2f} MB "
                             f"in {st['grad_calls']:.0f} calls a step, "
                             f"{st['grad_host_ms']:.2f} ms a step on the "
                             "host")
                if st["peak_gb"] is not None:
                    line += f"; peak memory {st['peak_gb']:.2f} GB"
                log(line)
                log(f"        {_fmt_profile(st['profile'])}")
            if "first_loss_gap" in run:
                log(f"      first-step loss gap {run['first_loss_gap']:.3g}")
            if "curve_gaps" in run:
                worst = sorted(run["curve_gaps"].items(),
                               key=lambda kv: -kv[1])[:3]
                log(f"      curves {run['curve_gap']:.3g} (bound "
                    f"{PARALLEL_CURVE_RTOL}; of every curve, the largest: "
                    + ", ".join(f"{k} {v:.3g}" for k, v in worst) + ")")
                log(f"      parameters {run['param_gap'][0]:.3g} lr max, "
                    f"{run['param_gap'][1]:.3g} lr mean")
    log(f"  K1, K3, K4 at the local batch: "
        + ", ".join(f"{k} {v:.3g}" for k, v in
                    res.get("local_batch", {}).items()))
    for key in ("parity_nccl", "mnist_ranks", "mnist_resumed", "mnist_one"):
        run = runs[key]
        extra = (f"; first-step loss gap {run['first_loss_gap']:.3g}, "
                 f"curves {run['curve_gap']:.3g}, parameters "
                 f"{run['param_gap'][0]:.3g} lr max"
                 if key == "parity_nccl" else "")
        log(f"  {run['label']} on {smi}: {run['seconds']:.1f} s in all "
            f"(beside the others of (3)), launches "
            f"{[r['launches'] for r in run['reports']]}{extra}")


def parallel_launches(res):
    """Every kernel's launches over phase 9's runs, all ranks summed."""
    total = dict.fromkeys(kernel_counters(), 0)
    for run in res["runs"].values():
        for rep in run["reports"]:
            total = {k: total[k] + rep["launches"][k] for k in total}
    return total



# ---------------------------------------------------------------------------
# phase 10: the (data, model) mesh through torchrun, then the engine's
# mesh_devices
# ---------------------------------------------------------------------------

PHASE10 = ("== phase 10: the (data, model) mesh through torchrun -m "
           "ladder_tpu_torch.train (gloo ranks sharing the one card), then "
           "the serving engine's mesh_devices")
# (1) phase 9's parity run on mesh_shape [1, 2]: the pretrained CelebA-128
# 'ours' model in float32 mode 1, 2 gloo ranks x 32 rows, parameters and
# Adam moments sharded over the model axis, 1 epoch of 4 steps at global
# batch 64, then resumed to epoch 2; held against one process on the same
# data at phase 9's bounds
TP_OVERRIDES = dict(PARALLEL_OVERRIDES, mesh_shape=[1, 2])
TP_RANKS = 2
# a rank's bytes of parameters and moments at rest, over the replicated
# total (ladder_tpu's own bound, tests/test_tensor_parallel.py:243)
TP_MEMORY_SHARE = 0.55
# (2) the pretrained mnist_digit model on mesh_shape [2, 2]: 4 gloo ranks x
# 64 rows on 4,096 synthetic images, 1 epoch, then resumed to 2; plots off
TP_MNIST_OVERRIDES = dict(PARALLEL_MNIST_OVERRIDES, mesh_shape=[2, 2])
TP_MNIST_RANKS = 4
SERVE_MESH_GENERATE = 64


def _check_tp_memory(label, run):
    """Every rank's bytes of parameters and moments at rest: the rule's
    prediction exactly, at most TP_MEMORY_SHARE of the replicated total."""
    for rep in run["reports"]:
        for t in rep["timings"]:
            b = t.get("state_bytes")
            if b is None:
                raise AssertionError(f"{label}: rank {rep['rank']} holds no "
                                     "sharded state")
            if b["held"] != b["predicted"] or (
                    b["held"] > TP_MEMORY_SHARE * b["replicated"]):
                raise AssertionError(f"{label}: rank {rep['rank']} holds "
                                     f"{b}")


def _check_tp_files(cfg, work, device):
    """The lead's vae-model, prior-model and train-state files against a
    one-process save of the state its train-state holds: byte for byte."""
    import contextlib
    import shutil
    import tempfile
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.step import flax_state, init_state
    from ladder_tpu_torch.utils.checkpoint import (
        CheckpointManager, load_msgpack, save_msgpack)

    _, dirs = _results(work, cfg)
    ckdir = os.path.join(work, dirs["checkpoint_dir"])
    raw = load_msgpack(os.path.join(ckdir, "train-state.msgpack"))
    state = init_state(make_model(cfg), flax_state=raw["state"],
                       device=device)
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_one_")
    with contextlib.redirect_stdout(io.StringIO()):
        CheckpointManager(dict(cfg, checkpoint_dir=out + "/")).save(
            state["model"].flax_params(), model="joint")
    save_msgpack(os.path.join(out, "train-state.msgpack"),
                 {"state": flax_state(state), "extra": raw["extra"]})
    try:
        _same_files("tp: a one-process save of the same state", ckdir, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return list(CHECKPOINT_FILES)


def adam_shard_case(cfg, peaks, n_model=2, index=0):
    """K5 over one rank's shards of the CelebA ae group (parallel/tp.py's
    layout at n_model) against its plain version, three updates; timed as
    phase 2 times the whole group."""
    import torch
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.ops import adam
    from ladder_tpu_torch.parallel.tp import is_weight, leaf_spec, \
        shard_params_tp
    from ladder_tpu_torch.training.optim import ADAM_B1, ADAM_B2, ADAM_EPS
    from ladder_tpu_torch.training.step import group_params

    model = make_model(cfg, seed=3).to("cuda")
    params = group_params(model, ("encoder", "decoder"))
    specs = {k: leaf_spec(p.shape, n_model, is_weight(k, p))
             for k, p in params.items()}
    shards = shard_params_tp({k: p.detach() for k, p in params.items()},
                             specs, index, n_model)
    del model, params
    group = [(s, 0) for s in shards.values()]
    n = sum(s.numel() for s in shards.values())
    gen = torch.Generator(device="cuda").manual_seed(7)
    kernel, plain, grads = _adam_state(group, gen)
    state = {"kernel": kernel, "plain": plain}
    err = _adam_steps(f"ae shards of rank {index}", state, grads, (1, 2, 3))

    def update():
        adam.adam_update_(*_with_grads(state["kernel"], grads), 2.5e-4, 4,
                          ADAM_B1, ADAM_B2, ADAM_EPS)

    case = {"group": f"ae, rank {index} of {n_model}", "tensors": len(group),
            "elements": n, "sharded_tensors": sum(
                a is not None for a in specs.values()),
            "max_abs_err": err}
    case.update(_times(update, lambda: adam.adam_update_reference(
        *_with_grads(state["plain"], grads), 2.5e-4, ADAM_B1, ADAM_B2,
        ADAM_EPS), 50, ("adam_kernel",)))
    if case["kernels_per_call"] != 1:
        # late in a long process the profiler may record only some of the
        # launches (2 of 50 after phases 1-9); each call is one launch, so
        # the device time of a call is that of the launches it recorded,
        # on average (CUDA events around a call would count the wrapper's
        # host time, which is longer than the kernel)
        case["profiler_ms"] = case["device_ms"]
        case["ms"] = case["device_ms"] = (case["device_ms"]
                                          / case["kernels_per_call"])
        case["device_clock"] = ("profiler, per recorded launch: "
                                f"{case['kernels_per_call']} a call seen")
    case["bound_ms"], case["bound_by"] = _bound(28 * n, 12 * n, peaks)
    log(f"  adam on the ae group's shards of rank {index} of {n_model}: "
        f"{len(group)} tensors ({case['sharded_tensors']} sharded), {n} "
        f"elements, max_abs_err {err:.3g} after 3 updates  "
        f"{_fmt_times(case)}  bound {case['bound_ms'] * 1e3:.2f} us"
        + (f" ({case['device_clock']})" if "device_clock" in case else ""))
    del state, grads
    torch.cuda.empty_cache()
    return case


def drive_tp_engine(cfg, device, serve_batch=SERVE_BATCH):
    """The pretrained CelebA 'ours' model served with mesh_devices=1 against
    mesh_devices=0: every path bitwise, the same norm-chain launches; more
    mesh devices than the machine has refused. Returns the launches,
    counted from 0."""
    import torch
    from ladder_tpu_torch.serving import InferenceEngine

    rng = np.random.default_rng(3)
    hw = (cfg["dim_input_x"], cfg["dim_input_y"], cfg["dim_input_channel"])
    x = rng.random((serve_batch,) + hw, dtype=np.float32)
    engines = [InferenceEngine(cfg, device=device, serve_batch=serve_batch,
                               buckets=(1, 8), mesh_devices=m)
               for m in (0, 1)]
    reset_counters()
    outs, launches = [], []
    for eng in engines:
        before = read_counters()["norm_chain_fwd"]
        mean, std = eng.encode(x)
        t_mean, t_std = eng.represent(x)
        outs.append({
            "encode": (mean, std), "represent": (t_mean, t_std),
            "reconstruct": eng.reconstruct(x),
            "reconstruct[3]": eng.reconstruct(x[:3]),
            "decode": eng.decode(mean[:8]),
            "decode_representation": eng.decode_representation(t_mean[:16]),
            "generate": eng.generate(16, seed=0),
            "t_log_density": eng.t_log_density(t_mean)})
        launches.append(read_counters()["norm_chain_fwd"] - before)
    for name, want in outs[0].items():
        for g, w in zip(*((outs[1][name], want) if isinstance(want, tuple)
                          else ((outs[1][name],), (want,)))):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"mesh_devices=1 {name} differs from "
                                     "mesh_devices=0")
    if launches[0] != launches[1] or (
            torch.device(device).type == "cuda" and launches[0] <= 0):
        raise AssertionError(f"norm-chain launches {launches} with "
                             "mesh_devices 0 and 1")
    count = torch.cuda.device_count() if torch.device(
        device).type == "cuda" else 1
    gap = None
    if count > 1:
        # every card a replica, the BatchNorm sums added across them: one
        # card's results to rounding
        wide = InferenceEngine(cfg, device=device, serve_batch=serve_batch,
                               buckets=(1, 8), mesh_devices=count)
        got = wide.reconstruct(x), wide.encode(x)[0], wide.generate(16, seed=0)
        want = (outs[0]["reconstruct"], outs[0]["encode"][0],
                outs[0]["generate"])
        gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if gap > GPU_CPU_MAX_ABS:
            raise AssertionError(f"mesh_devices={count}: {gap} from one "
                                 "card")
        del wide
    try:
        InferenceEngine(cfg, device=device, serve_batch=serve_batch,
                        mesh_devices=count + 1)
    except ValueError as e:
        if "devices are available" not in str(e):
            raise
    else:
        raise AssertionError(f"mesh_devices={count + 1} on {count} "
                             "device(s) did not raise")
    total = read_counters()
    gen = outs[1]["generate"]
    del engines
    return {"launches": total, "norm_chain_per_engine": launches,
            "paths": sorted(outs[0]), "generate16": gen,
            "cards": count, "all_cards_gap": gap}


def _start_serve_cli(device, config_path, serve_batch, n, out):
    """python -m ladder_tpu_torch.serve --mesh 1 --generate n in a
    subprocess; (process, start)."""
    cmd = [sys.executable, "-m", "ladder_tpu_torch.serve", "--config",
           config_path, "--mesh", "1", "--generate", str(n),
           "--serve-batch", str(serve_batch), "--out", out]
    cmd += ["--device", "cpu"] if _device_type(device) != "cuda" else []
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter()


def _device_type(device):
    import torch
    return torch.device(device).type


def drive_tp(device, overrides=TP_OVERRIDES,
             mnist_overrides=TP_MNIST_OVERRIDES,
             groups=os.path.join(ROOT, "pretrained_models", "celeba"),
             mnist_groups=os.path.join(ROOT, "pretrained_models",
                                       "mnist_digit"),
             ranks=TP_RANKS, mnist_ranks=TP_MNIST_RANKS, profile=True,
             serve_config=CONFIG, serve_batch=SERVE_BATCH,
             serve_generate=SERVE_MESH_GENERATE, peaks=None,
             backend="gloo"):
    """Phase 10 (see the module docstring); every check of the phase.
    ``device`` is the card's 'cuda' or, to rehearse, 'cpu'. The first
    run of (1) runs alone and is profiled; the resume, (2), the one
    process and the serve CLI run beside one another. ``serve_config``:
    the served model's config (a path from the repository's root).
    ``backend`` 'nccl': every rank on a card of its own (cuda:LOCAL_RANK),
    which needs as many cards as ranks."""
    import contextlib
    import shutil
    import tempfile
    from ladder_tpu_torch.training import schedules

    on_card = _device_type(device) == "cuda"
    if backend == "nccl":
        rank_device = None  # cuda:LOCAL_RANK
    else:
        rank_device = "cuda:0" if on_card else "cpu"
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    res = {"runs": {}}
    try:
        cfg = celeba_config(overrides)
        bs = cfg["batch_size"]
        steps = cfg["synthetic_n_train"] // bs
        evals = 1 + cfg["synthetic_n_val"] // bs
        data = os.path.join(work, "celeba_data") + "/"
        runs, mruns = {}, {}

        def celeba_cfg(name, **kw):
            w = os.path.join(work, name)
            if not os.path.isdir(w):
                _copy_groups(groups, w, cfg["exp_name"])
            return w, _write_config(w, "config.json", dict(
                cfg, data_path=data, load_dir=w + "/", **kw))

        # ---- (1) the ranks alone, profiled ------------------------------
        w, path = celeba_cfg("tp", **({"profile_dir": os.path.join(
            work, "tp", "profile")} if profile else {}))
        runs["ranks"] = _ranks_run(f"celeba [1, 2], {ranks} {backend} ranks", w,
                                   path, ranks, rank_device, backend)
        runs["ranks"]["work"] = w
        # epoch 1's curves and parameters, before the resume rewrites them
        epoch1, _ = _results(w, cfg)
        snap = os.path.join(work, "tp_epoch1")
        shutil.copytree(os.path.join(w, _results(w, cfg)[1][
            "checkpoint_dir"]), snap)

        # ---- the others, beside one another -----------------------------
        w, path = celeba_cfg("tp", num_epochs=2)
        resumed = _torchrun(w, path, ranks, rank_device, backend)
        mcfg = mnist_config(mnist_overrides)
        mw = os.path.join(work, "mnist_tp")
        _copy_groups(mnist_groups, mw, mcfg["exp_name"])
        mpath = _write_config(mw, "config.json", dict(
            mcfg, load_dir=mw + "/", num_epochs=1))
        mstart = _torchrun(mw, mpath, mnist_ranks, rank_device, backend)
        gen_out = os.path.join(work, "serve_mesh.npz")
        serve = _start_serve_cli(device, serve_config, serve_batch,
                                 serve_generate, gen_out)
        w, path = celeba_cfg("one")
        runs["one"] = _one_run("celeba, one process", w, path, device)
        runs["one"].pop("trainer")
        runs["one"]["work"] = w
        ow = os.path.join(work, "mnist_one")
        _copy_groups(mnist_groups, ow, mcfg["exp_name"])
        opath = _write_config(ow, "config.json", dict(
            mcfg, load_dir=ow + "/", num_epochs=1))
        mruns["one"] = _one_run("mnist, one process", ow, opath, device)
        mruns["one"].pop("trainer")
        mruns["one"]["work"] = ow
        mesh = mcfg["mesh_shape"]
        mruns["ranks"] = _ranks_run(
            f"mnist {mesh} to epoch 1, {mnist_ranks} {backend} ranks", mw, None,
            mnist_ranks, started=mstart)
        mruns["ranks"]["files"] = _artifact_files(mw)
        mpath = _write_config(mw, "config.json", dict(
            mcfg, load_dir=mw + "/", num_epochs=2))
        mres = _torchrun(mw, mpath, mnist_ranks, rank_device, backend)
        runs["resumed"] = _ranks_run(
            f"celeba [1, 2] resumed to epoch 2, {ranks} {backend} ranks",
            runs["ranks"]["work"], None, ranks, started=resumed)
        runs["resumed"]["work"] = runs["ranks"]["work"]
        mruns["resumed"] = _ranks_run(
            f"mnist {mesh} resumed to epoch 2, {mnist_ranks} {backend} ranks", mw,
            None, mnist_ranks, started=mres)
        mruns["resumed"]["files"] = _artifact_files(mw)
        for run in mruns.values():
            run.setdefault("work", mw)
        code, said, seconds = _finish(serve)
        if code != 0:
            raise AssertionError(f"serve --mesh 1: exit {code}\n{said[-3000:]}")

        # ---- the checks -------------------------------------------------
        want = _epoch_launches(cfg, 1, steps, evals, device)
        if runs["one"]["launches"] != want:
            raise AssertionError(f"celeba, one process: launched "
                                 f"{runs['one']['launches']}, expected {want}")
        _check_rank_launches(runs["ranks"]["label"], runs["ranks"], want)
        _check_rank_launches(runs["resumed"]["label"], runs["resumed"],
                             expected_epoch_launches(cfg, 1, steps, evals,
                                                     False, device))
        for key in ("ranks", "resumed"):
            _check_tp_memory(runs[key]["label"], runs[key])
        if "Full train state restored (epoch 1)." not in runs["resumed"][
                "out"]:
            raise AssertionError("celeba [1, 2]: the resumed ranks did not "
                                 "restore the full train state of epoch 1")
        run, one = runs["ranks"], runs["one"]
        lr = max(max(schedules.all_lrs(cfg, 1).values()),
                 schedules.lr_ae_celeba(cfg, 1))
        run["first_loss_gap"] = abs(run["reports"][0]["train_loss"][0]
                                    / one["reports"][0]["train_loss"][0] - 1)
        if run["first_loss_gap"] > TRAIN_METRIC_RTOL:
            raise AssertionError(f"celeba [1, 2]: first-step loss gap "
                                 f"{run['first_loss_gap']}")
        want_results, want_dirs = _results(one["work"], cfg)
        run["curve_gaps"] = _curve_gaps(epoch1, want_results)
        run["curve_gap"] = max(run["curve_gaps"][k] for k in PARALLEL_CURVES)
        if run["curve_gap"] > PARALLEL_CURVE_RTOL:
            raise AssertionError(f"celeba [1, 2]: curves "
                                 f"{run['curve_gaps']} from one process's")
        run["param_gap"] = _param_gap("", one["work"], {
            "checkpoint_dir": snap}, want_dirs, lr)
        if run["param_gap"][0] > TRAIN_PARAM_MAX_LR * steps:
            raise AssertionError(f"celeba [1, 2]: parameters "
                                 f"{run['param_gap'][0]} lr from one "
                                 "process's")
        res["files_equal"] = _check_tp_files(cfg, run["work"], device)
        _check_parallel_mnist(mruns, mcfg, on_card)
        msteps = mcfg["synthetic_n_train"] // mcfg["batch_size"]
        for key in ("ranks", "resumed"):
            _check_tp_memory(mruns[key]["label"], mruns[key])
            got = mruns[key]["reports"][0]["launches"]["adam_update"]
            if on_card and got != 4 * msteps:
                raise AssertionError(f"{mruns[key]['label']}: {got} Adam "
                                     f"launches, expected {4 * msteps}")
        with np.load(gen_out) as z:
            res["serve_cli"] = {"shape": list(z["x"].shape),
                                "seconds": seconds}
            if z["x"].shape[0] != serve_generate or not np.isfinite(
                    z["x"]).all():
                raise AssertionError(f"serve --mesh 1: {z['x'].shape}")
        from ladder_tpu_torch.utils.config import process_config
        with contextlib.redirect_stdout(io.StringIO()):
            serve_cfg = process_config(os.path.join(ROOT, serve_config))
        res["engine"] = drive_tp_engine(serve_cfg, device, serve_batch)
        with np.load(gen_out) as z:
            # the CLI's first samples are the engine's generate(16)'s
            n = min(16, serve_generate)
            gap = float(np.abs(z["x"][:n] - res["engine"].pop(
                "generate16")[:n]).max())
        res["serve_cli"]["gap_to_engine"] = gap
        if gap > GPU_CPU_MAX_ABS:
            raise AssertionError(f"serve --mesh 1 --generate: {gap} from "
                                 "the engine's generate")
        if on_card:
            res["adam_shards"] = [adam_shard_case(cfg, peaks, 2, i)
                                  for i in range(2)]
        for prefix, group in (("celeba", runs), ("mnist", mruns)):
            res["runs"].update({f"{prefix}_{k}": v for k, v in group.items()})
        res.update(cfg=cfg, steps=steps, mnist_cfg=mcfg, mnist_steps=msteps,
                   backend=backend)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


def log_tp(res, smi):
    runs = res["runs"]
    if res["backend"] == "gloo":
        log(f"  runs on {smi} (gloo ranks share the one card in time and "
            "stage their collectives through the host: no scaling number)")
    else:
        log(f"  runs on {smi}, one card a rank over NCCL")
    for key in ("celeba_ranks", "celeba_one", "celeba_resumed",
                "mnist_ranks", "mnist_resumed", "mnist_one"):
        run = runs[key]
        steps = res["steps"] if key.startswith("celeba") else res[
            "mnist_steps"]
        beside = "" if key == "celeba_ranks" else " (beside the others)"
        log(f"    {run['label']}: {run['seconds']:.1f} s in all{beside}")
        for rep, st in zip(run["reports"], _per_step(run, steps)):
            line = (f"      rank {rep['rank']}/{rep['world']} "
                    f"(n_model {rep.get('n_model')}): step " + (
                        f"{st['profiled_step_ms']:.2f} ms (steps 2-"
                        f"{st['profile']['steps'] + 1}, profiler on), "
                        if st["profiled_step_ms"] else "")
                    + f"{st['step_ms']:.2f} ms over the epoch with its "
                    "first step")
            for tag in ("param_gather", "grad"):
                c = st["collectives"].get(tag)
                if c:
                    line += (f"; {tag} {c['mb']:.2f} MB in {c['calls']:.1f} "
                             f"calls a step, {c['host_ms']:.2f} ms a step on "
                             "the host")
            if st["state_bytes"]:
                b = st["state_bytes"]
                line += (f"; parameters + moments at rest {b['held'] / 1e6:.2f}"
                         f" MB (rule {b['predicted'] / 1e6:.2f} MB, replicated "
                         f"{b['replicated'] / 1e6:.2f} MB, share "
                         f"{b['held'] / b['replicated']:.3f})")
            if st["allocated_gb"] is not None:
                line += (f"; allocated between steps "
                         f"{st['allocated_gb']:.2f} GB")
            if st["peak_gb"] is not None:
                line += f"; peak memory {st['peak_gb']:.2f} GB"
            log(line)
            if st["profile"]:
                log(f"        {_fmt_profile(st['profile'])}")
            log(f"        launches {rep['launches']}")
    run = runs["celeba_ranks"]
    log(f"  celeba [1, 2] against one process: first-step loss gap "
        f"{run['first_loss_gap']:.3g} (bound {TRAIN_METRIC_RTOL}), curves "
        f"{run['curve_gap']:.3g} (bound {PARALLEL_CURVE_RTOL}), parameters "
        f"{run['param_gap'][0]:.3g} lr max, {run['param_gap'][1]:.3g} lr "
        f"mean (bound {TRAIN_PARAM_MAX_LR} lr a step); the files "
        f"{', '.join(res['files_equal'])} byte for byte a one-process save "
        "of the same state")
    for case in res.get("adam_shards", []):
        log(f"  adam {case['group']}: max_abs_err {case['max_abs_err']:.3g} "
            f"{_fmt_times(case)} on {smi}"
            + (f" ({case['device_clock']})" if "device_clock" in case
               else ""))
    eng = res["engine"]
    log(f"  engine mesh_devices=1 vs 0: {', '.join(eng['paths'])} bitwise "
        f"equal; norm-chain launches {eng['norm_chain_per_engine']}; serve "
        f"--mesh 1 --generate: "
        f"{res['serve_cli']['shape']} in {res['serve_cli']['seconds']:.1f} "
        f"s, {res['serve_cli']['gap_to_engine']:.3g} from the engine"
        + (f"; mesh_devices={eng['cards']} on {eng['cards']} cards within "
           f"{eng['all_cards_gap']:.3g} of one card"
           if eng["all_cards_gap"] is not None else ""))


def tp_launches(res):
    """Every kernel's launches over phase 10: all ranks of every run, the
    one-process runs and the engine."""
    total = dict(res["engine"]["launches"])
    for run in res["runs"].values():
        if "reports" in run:
            for rep in run["reports"]:
                total = {k: total[k] + rep["launches"][k] for k in total}
    return total


# ---------------------------------------------------------------------------
# phase 11: the quality record (python -m ladder_tpu_torch.quality) at the
# published widths, data and epochs cut
# ---------------------------------------------------------------------------

PHASE11 = ("== phase 11: the quality record through python -m "
           "ladder_tpu_torch.quality (mnist_digit and CelebA-128, data and "
           "epochs cut), then eval_fid on its files")
# (a) codes/mnist_digit_config.json as published (h=256, inner VAE 5x512,
# 50 mixtures, 100 MC samples, batch 256) on 4,096 + 1,024 synthetic
# images for 6 epochs: sg_pretraining's 5, then one epoch of prior
# training ending in a GM fit; 512 generated images against as many
# validation images
QUALITY_DIGIT_ARGS = ("--config", "codes/mnist_digit_config.json",
                      "--epochs", "6", "--n-train", "4096", "--n-test",
                      "1024", "--fid-samples", "512")
# (b) codes/celeba_config.json (h=512, code 256, batch 64) on 128 training
# images for 1 epoch, the prior trained from the start and fitted
# accurately after it, 512 validation images against 512 generated: with
# fewer images than the code's 256 dimensions the features' covariance is
# singular, and the self-floor is ~4e-8 of its trace in either package's
# FID (-2e-5 with 64 images), above QUALITY_SELF_FLOOR
QUALITY_CELEBA_ARGS = ("--config", "codes/celeba_config.json", "--epochs",
                       "1", "--n-train", "128", "--n-test", "64",
                       "--fid-samples", "512")
QUALITY_CELEBA_OVERRIDES = {"sg_pretraining": 0, "accurate_fit": 1,
                            "synthetic_n_val": 512}
# the self-floor, the FID of the validation set against itself (as
# tests/test_scripts.py holds ladder_tpu's)
QUALITY_SELF_FLOOR = 1e-6
# eval_fid on the record's own files against the record's FID (relative)
QUALITY_EVAL_FID_RTOL = 1e-6


def expected_generation_launches(cfg, n, serve_batch, device):
    """Launches of InferenceEngine.generate(n): every decoding call of a
    CelebA model runs the decoder's four norm-chain stages; the mnist
    decoder and the encoders launch none."""
    import torch
    out = dict.fromkeys(kernel_counters(), 0)
    if cfg["exp_name"] == "celeba" and torch.device(device).type == "cuda":
        out["norm_chain_fwd"] = 4 * -(-n // serve_batch)
    return out


def quality_run(label, argv, work, device):
    """quality.run on argv in work, every epoch's launches recorded; the
    record's checks: its scale keys finite, an active mixture, the FID's
    self-floor, each epoch's launches (K5 for every group update; on
    CelebA K1-K5 for its steps and evaluations) and the generation's."""
    from ladder_tpu_torch import quality
    from ladder_tpu_torch.quality_spread import SCALE_KEYS

    out = os.path.join(work, "record.json")
    argv = list(argv) + ["--workdir", work, "--out", out,
                         "--device", device]
    reset_counters()
    t0 = time.perf_counter()
    with _Recorder(0):
        _, record, trainer = quality.run(argv)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()
    cfg = trainer.config
    bad = {k: record[k] for k in SCALE_KEYS + ("sigma_start",)
           if not np.isfinite(record[k])}
    if bad:
        raise AssertionError(f"{label}: record values not finite: {bad}")
    if not record["active_mixtures"] or record["active_mixtures"] < 1:
        raise AssertionError(f"{label}: active_mixtures "
                             f"{record['active_mixtures']}")
    if not abs(record["encoder_fid_self_floor"]) < QUALITY_SELF_FLOOR:
        raise AssertionError(f"{label}: FID self-floor "
                             f"{record['encoder_fid_self_floor']}")
    epochs = tuple(range(1, cfg["num_epochs"] + 1))
    if cfg["exp_name"] == "celeba":
        _check_celeba_run(label, trainer, epochs, cfg["fused_train_step"],
                          device)
    else:
        _check_mnist_run(label, trainer, launches, epochs, {})
        _check_epoch_group_launches(label, trainer)
    trained = {k: sum(t["launches"][k] for t in trainer.timings)
               for k in launches}
    gen = expected_generation_launches(cfg, record["fid_samples"],
                                       SERVE_BATCH, device)
    want = {k: trained[k] + gen[k] for k in launches}
    if launches != want:
        raise AssertionError(f"{label}: launched {launches}, expected "
                             f"{want} (epochs {trained}, generation {gen})")
    return {"label": label, "record": record, "trainer": trainer,
            "seconds": seconds, "launches": launches, "config": cfg,
            "timings": trainer.timings}


def eval_fid_on(run, device):
    """python -m ladder_tpu_torch.eval_fid's main on the record's two npz
    files with the trained encoder; its FID against the record's."""
    import contextlib
    from ladder_tpu_torch import eval_fid

    cfg, work = run["config"], run["record"]["workdir"]
    cfg_path = os.path.join(work, "trained_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        eval_fid.main([os.path.join(work, "real.npz"),
                       os.path.join(work, "generated.npz"),
                       "--network", "encoder", "--config", cfg_path,
                       "--checkpoint-dir", cfg["checkpoint_dir"],
                       "--resize-to", str(cfg["dim_input_x"]),
                       "--device", device])
    seconds = time.perf_counter() - t0
    line = json.loads(buf.getvalue().splitlines()[-1])
    want = run["record"]["encoder_fid_generated_vs_test"]
    rel = abs(line["fid"] - want) / max(abs(want), 1e-12)
    if not rel <= QUALITY_EVAL_FID_RTOL:
        raise AssertionError(f"{run['label']}: eval_fid {line['fid']} vs "
                             f"the record's {want}: relative {rel}")
    return {"fid": line["fid"], "rel": rel, "seconds": seconds}


def drive_quality(device, digit_args=QUALITY_DIGIT_ARGS,
                  celeba_args=QUALITY_CELEBA_ARGS,
                  celeba_overrides=QUALITY_CELEBA_OVERRIDES, work=None):
    """Phase 11: (a) the mnist_digit record and eval_fid on its files,
    (b) the CelebA-128 record; returns both runs and their launches. The
    records' work directories stay under ``work`` when it is given (phase
    12 reads them), else in a temporary directory removed after."""
    import shutil
    import tempfile
    import torch

    keep = work is not None
    work = work or tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        digit = quality_run("mnist_digit record", digit_args,
                            os.path.join(work, "digit"), device)
        digit["eval_fid"] = eval_fid_on(digit, device)
        digit.pop("trainer")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        celeba = quality_run(
            "celeba record", list(celeba_args)
            + ["--override", json.dumps(celeba_overrides)],
            os.path.join(work, "celeba"), device)
        celeba.pop("trainer")
    finally:
        if not keep:
            shutil.rmtree(work, ignore_errors=True)
    launches = {k: digit["launches"][k] + celeba["launches"][k]
                for k in digit["launches"]}
    return {"digit": digit, "celeba": celeba, "launches": launches}


def log_quality(res, smi):
    for key in ("digit", "celeba"):
        run = res[key]
        rec, cfg = run["record"], run["config"]
        log(f"  {run['label']} on {smi}: {run['seconds']:.1f} s in all, "
            f"train_wall_s {rec['train_wall_s']} ({cfg['num_epochs']} "
            f"epochs at batch {cfg['batch_size']}, h="
            f"{cfg['num_hidden_units']}, {rec['data']['n_train']} images)")
        log("    " + ", ".join(
            f"{k} {rec[k]}" for k in (
                "final_train_neg_elbo", "final_val_neg_elbo",
                "final_train_recons", "final_val_recons", "sigma_start",
                "sigma_final", "n_curve_points", "active_mixtures",
                "encoder_fid_generated_vs_test", "encoder_fid_self_floor",
                "fid_samples")))
        log(f"    record keys {list(rec)}")
        for t in run["timings"]:
            fits = ", ".join(f"{g['mode']} {g['seconds']:.3f} s"
                             for g in t["gm"])
            log(f"    epoch {t['epoch']}: {t['train']['steps']} steps, step "
                f"{t['train']['step_ms']:.2f} ms (epoch wall / steps), "
                f"validation {t['val_s']:.3f} s, GM fits [{fits}], group "
                f"updates {t['group_updates']}")
        log(f"    launches {run['launches']}")
    ev = res["digit"]["eval_fid"]
    log(f"  eval_fid --network encoder on the mnist_digit record's files: "
        f"{ev['fid']} in {ev['seconds']:.1f} s, {ev['rel']:.3g} from the "
        f"record's (bound {QUALITY_EVAL_FID_RTOL})")


# ---------------------------------------------------------------------------
# phase 12: the scripts of the JAX package that the port carries as modules
# (verify_real_data, sweep_gmm, memory_report, batch_quality_study,
# mode_parity), at the published widths, data and epochs cut
# ---------------------------------------------------------------------------

PHASE12 = ("== phase 12: the scripts through python -m ladder_tpu_torch."
           "{verify_real_data,sweep_gmm,memory_report,batch_quality_study,"
           "mode_parity} (published widths, data and epochs cut)")
# sweep_gmm: codes/mnist_digit_config.json as published (h=256, inner VAE
# 5x512, 100 MC samples, batch 256) on 2,048 + 512 synthetic images at 10
# and 50 mixtures, 5 epochs: the fits start after sg_pretraining's first 4,
# so the 5th ends in the first fast fit (and, as the last, an accurate one)
SWEEP_GMM_CONFIG = "codes/mnist_digit_config.json"
SWEEP_GMM_OVERRIDES = {"synthetic_n_train": 2048, "synthetic_n_test": 512}
SWEEP_GMM_ARGS = ("--mixtures", "10", "50", "--epochs", "5", "--synthetic")
# memory_report on codes/celeba_config.json (h=512, code 256): (batch,
# mode, dtype)
MEMORY_CONFIG = "codes/celeba_config.json"
MEMORY_CASES = ((64, 1, "float32"), (64, 2, "float32"),
                (64, 2, "bfloat16"), (256, 2, "bfloat16"))
# batch_quality_study: the CelebA recipe at batches 64 and 256 (lr x4),
# bf16 mode 2, 1 epoch of 1,024 images (sg_pretraining's 2 epochs cut to
# the first: no fit)
BATCH_STUDY_ARGS = ("--epochs", "1", "--n-train", "1024", "--batches", "64",
                    "256")
# mode_parity sweep: both modes at seeds 0 1 2 on 128 images for 1 epoch,
# the prior trained from the start and fitted accurately after it, 512
# validation and generated images for a full-rank FID (phase 11 (b)), a
# 64-image test split; the records one after another, each tried once,
# then combine
MODE_PARITY_ARGS = ("--epochs", "1", "--n-train", "128", "--override",
                    json.dumps(
                        {"sg_pretraining": 0, "accurate_fit": 1,
                         "synthetic_n_val": 512, "synthetic_n_test": 64}))


class _KeepTrainers:
    """While on: every JointTrainer that trains is kept (``trainers``)."""

    def __enter__(self):
        from ladder_tpu_torch.training import trainer as trainer_mod
        self.cls, self.trainers = trainer_mod.JointTrainer, []
        self.real = self.cls.train
        keeper = self

        def train(trainer):
            keeper.trainers.append(trainer)
            return keeper.real(trainer)

        self.cls.train = train
        return self

    def __exit__(self, *exc):
        self.cls.train = self.real


def _main_of(module, argv, cwd=None):
    """module.main(argv) with its output teed and kept; (return value,
    output, seconds, launches)."""
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if cwd is not None:
            stack.enter_context(contextlib.chdir(cwd))
        stack.enter_context(contextlib.redirect_stdout(_Tee(sys.stdout, buf)))
        rc = module.main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0, read_counters()


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def verify_check(label, cfg, work, device, want_lines):
    """verify_real_data check on cfg's data: exit 0 and the OK lines."""
    from ladder_tpu_torch import verify_real_data
    path = _write_json(os.path.join(work, f"{label}.json"), cfg)
    rc, out, seconds, _ = _main_of(verify_real_data,
                                   ["check", "--config", path, "--device",
                                    device])
    got = [ln for ln in out.splitlines() if ln.startswith(("OK", "FAIL"))]
    if rc != 0 or len(got) != len(want_lines) or not all(
            g.startswith("OK") and w in g for g, w in zip(got, want_lines)):
        raise AssertionError(f"verify_real_data check ({label}): exit {rc}, "
                             f"lines {got}, expected OK lines with "
                             f"{want_lines}")
    return {"label": label, "rc": rc, "lines": got, "seconds": seconds}


def envelope_reading(result_dir, exp, prior, env):
    """The envelope's checks, read here from the run's files with numpy:
    {check: passes}."""
    r = np.load(os.path.join(result_dir, f"{exp}-result.npz"))
    tl = np.asarray(r["train_loss"], np.float64)
    sigma = np.asarray(r["sigma"], np.float64)
    n_iter = int(r["n_train_iter"])
    first, last = tl[:n_iter].mean(), tl[-n_iter:].mean()
    out = {
        "curves_finite": bool(np.isfinite(tl).all()
                              and np.isfinite(sigma).all()),
        "curve_lengths": len(tl) == len(sigma) * n_iter,
        "train_loss_drop": bool((first - last) / abs(first)
                                >= env["min_train_loss_drop"]),
        "final_sigma": bool(sigma[-1] <= env["final_sigma_max"]),
        "sigma_annealing": bool(np.all(
            np.diff(sigma) <= env["sigma_monotone_tolerance"]))}
    if len(r["val_loss"]):
        vl = np.asarray(r["val_loss"], np.float64)
        out["val_tracks_train"] = bool(
            abs(vl[-1] - last) / abs(last)
            <= env["val_final_within_train_frac"])
    gm = os.path.join(result_dir, "GM_prior_info.npz")
    if prior in ("ours", "GMM") and "min_active_mixtures" in env:
        if os.path.isfile(gm):
            out["active_mixtures"] = bool(
                len(np.load(gm)["w_active"]) >= env["min_active_mixtures"])
        else:
            out["gm_prior_info"] = False
    return out


def verify_compare(run, work, device):
    """verify_real_data compare on a quality record's files (copied where
    the config's directory scheme puts them), held check by check against
    envelope_reading of the same files; a cut run may fail the envelope,
    and then the same checks must fail."""
    import shutil
    from ladder_tpu_torch import verify_real_data
    from ladder_tpu_torch.utils.config import process_config
    cfg = dict(run["config"])
    cmp_dir = os.path.join(work, "compare_" + cfg["exp_name"])
    os.makedirs(cmp_dir)
    path = _write_json(os.path.join(cmp_dir, "config.json"), cfg)
    with contextlib.chdir(cmp_dir), \
            contextlib.redirect_stdout(io.StringIO()):
        result_dir = process_config(path)["result_dir"]
    os.makedirs(os.path.join(cmp_dir, result_dir))
    for name in (f"{cfg['exp_name']}-result.npz", "GM_prior_info.npz"):
        src = os.path.join(cfg["result_dir"], name)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(cmp_dir, result_dir, name))
    rc, out, seconds, _ = _main_of(verify_real_data,
                                   ["compare", "--config", path, "--device",
                                    device], cwd=cmp_dir)
    printed = {}
    for ln in out.splitlines():
        if ln.startswith(("OK  ", "FAIL ")) and ":" in ln:
            printed[ln[4:].split(":", 1)[0].strip()] = ln.startswith("OK")
    with open(os.path.join(verify_real_data.ENVELOPES,
                           f"{cfg['exp_name']}.json")) as f:
        env = json.load(f)["checks"]
    mine = envelope_reading(os.path.join(cmp_dir, result_dir),
                            cfg["exp_name"], cfg["prior"], env)
    if printed != mine or rc != (0 if all(mine.values()) else 1):
        raise AssertionError(f"verify_real_data compare on {run['label']}: "
                             f"exit {rc}, checks {printed}; read here "
                             f"{mine}")
    return {"label": run["label"], "rc": rc, "checks": printed,
            "failing": sorted(k for k, v in printed.items() if not v),
            "seconds": seconds}


def drive_sweep_gmm(work, device, config=SWEEP_GMM_CONFIG,
                    overrides=SWEEP_GMM_OVERRIDES, args=SWEEP_GMM_ARGS):
    """sweep_gmm's main on the config with the overrides: its rows, each
    arm's trainer checked (finite curves, an Adam launch per group update
    every epoch, the active mixtures its own fast fit's)."""
    from ladder_tpu_torch import sweep_gmm
    with open(os.path.join(ROOT, config)) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    path = _write_json(os.path.join(work, "sweep_gmm.json"), cfg)
    sweep_dir = os.path.join(work, "sweep_gmm")
    os.makedirs(sweep_dir)
    with _Recorder(0), _KeepTrainers() as kept:
        rows, out, seconds, launches = _main_of(
            sweep_gmm, ["-c", path, *args, "--device", device],
            cwd=sweep_dir)
    arms = [int(k) for k in args[args.index("--mixtures") + 1:
                                 args.index("--epochs")]]
    line = json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"sweep"')][-1])["sweep"]
    if line != rows or [r["n_mixtures"] for r in rows] != arms \
            or len(kept.trainers) != len(arms):
        raise AssertionError(f"sweep_gmm: rows {rows}, line {line}, "
                             f"{len(kept.trainers)} trainers for {arms}")
    epochs = tuple(range(1, int(args[args.index("--epochs") + 1]) + 1))
    for row, trainer in zip(rows, kept.trainers):
        label = f"sweep_gmm K={row['n_mixtures']}"
        if not (np.isfinite(row["final_val_loss"])
                and np.isfinite(row["final_val_elbo"])):
            raise AssertionError(f"{label}: {row}")
        w = trainer.gm_fast[0].detach().cpu().numpy()
        if not 1 <= row["active_mixtures"] == int((w >= 1e-2).sum()) \
                <= row["n_mixtures"]:
            raise AssertionError(f"{label}: active_mixtures "
                                 f"{row['active_mixtures']}, fast fit {w}")
        if [t["epoch"] for t in trainer.timings] != list(epochs):
            raise AssertionError(f"{label}: epochs {trainer.timings}")
        _check_epoch_group_launches(label, trainer)
    trained = {k: sum(t["launches"][k] for tr in kept.trainers
                      for t in tr.timings) for k in launches}
    if trained != launches:
        raise AssertionError(f"sweep_gmm launched {launches} in all, its "
                             f"epochs {trained}")
    return {"rows": rows, "seconds": seconds, "launches": launches,
            "timings": [tr.timings for tr in kept.trainers]}


def drive_memory(device, config=MEMORY_CONFIG, cases=MEMORY_CASES):
    """memory_report's main per (batch, mode, dtype): state_mb the model's
    parameters (and each moment the optimiser groups' parameters) in
    float32, the measured peak at or above the state, the step's own
    increment positive and, for cases alike but for the batch, growing at
    least half as fast as the batch (activations scale with it), one
    step's launches as expected_step_launches says."""
    import gc
    import torch
    from ladder_tpu_torch import memory_report
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.step import group_keys, group_params
    from ladder_tpu_torch.utils.config import process_config
    with contextlib.redirect_stdout(io.StringIO()):
        base = process_config(os.path.join(ROOT, config))
    model = make_model(base)
    n_params = sum(p.numel() for p in model.parameters())
    n_moment = sum(p.numel() for keys in group_keys(base).values()
                   for p in group_params(model, keys).values())
    del model
    cuda = torch.device(device).type == "cuda"
    out = []
    for batch, mode, dtype in cases:
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        rc, text, seconds, launches = _main_of(memory_report, [
            "--config", config, "--batch", str(batch), "--fused", str(mode),
            "--dtype", dtype, "--device", device])
        rep = json.loads(text.strip().splitlines()[-1])
        label = f"memory_report batch {batch} mode {mode} {dtype}"
        state = rep["state_mb"]
        want_state = {"params": round(n_params * 4 / 1e6, 2),
                      "adam_m": round(n_moment * 4 / 1e6, 2),
                      "adam_v": round(n_moment * 4 / 1e6, 2)}
        want_batch = round(batch * 128 * 128 * 3 / 1e6, 2)
        if rc != 0 or state != want_state or rep["batch_mb"] != want_batch:
            raise AssertionError(f"{label}: exit {rc}, state_mb {state} "
                                 f"(expected {want_state}), batch_mb "
                                 f"{rep['batch_mb']} ({want_batch})")
        peak, total = rep["peak_estimate_mb"], sum(state.values())
        measured = rep["measured_mb"]
        if cuda and not (peak >= measured["allocated_before"] >= total
                         and measured["step_increment"] > 0):
            raise AssertionError(f"{label}: peak {peak} MB, measured "
                                 f"{measured} MB, state {total} MB")
        cfg = dict(base, batch_size=batch, fused_train_step=mode,
                   dtype=dtype)
        want = expected_step_launches(cfg, mode, device)
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected "
                                 f"{want}")
        out.append({"label": label, "report": rep, "seconds": seconds,
                    "launches": launches})
    if cuda:
        grown = {}
        for (batch, mode, dtype), m in zip(cases, out):
            grown.setdefault((mode, dtype), []).append(
                (batch, m["report"]["measured_mb"]["step_increment"]))
        for (mode, dtype), runs in grown.items():
            for (b0, inc0), (b1, inc1) in zip(runs, runs[1:]):
                if not inc1 >= inc0 * (b1 / b0) / 2:
                    raise AssertionError(
                        f"memory_report mode {mode} {dtype}: the step adds "
                        f"{inc0} MB at batch {b0}, {inc1} MB at {b1}")
    return out


def drive_batch_study(work, device, args=BATCH_STUDY_ARGS):
    """batch_quality_study's main: both batches' records (lr scaled by
    batch / the first, finite curves of one point an epoch) and each
    trainer's epochs' launches (_check_celeba_run)."""
    from ladder_tpu_torch import batch_quality_study
    out_path = os.path.join(work, "batch_quality_study_torch.json")
    with _Recorder(0), _KeepTrainers() as kept:
        payload, _, seconds, launches = _main_of(
            batch_quality_study,
            [*args, "--out", out_path, "--device", device])
    with open(out_path) as f:
        if json.load(f) != payload:
            raise AssertionError("batch_quality_study: the file is not the "
                                 "record main returned")
    batches = [r["batch"] for r in payload["runs"]]
    epochs = payload["meta"]["epochs"]
    for run, trainer in zip(payload["runs"], kept.trainers):
        label = f"batch_quality_study batch {run['batch']}"
        if run["lr_scale"] != run["batch"] / batches[0] or any(
                len(run[k]) != epochs or not np.isfinite(run[k]).all()
                for k in ("train_neg_elbo", "val_neg_elbo", "sigma")):
            raise AssertionError(f"{label}: {run}")
        _check_celeba_run(label, trainer, range(1, epochs + 1),
                          trainer.config["fused_train_step"], device)
    trained = {k: sum(t["launches"][k] for tr in kept.trainers
                      for t in tr.timings) for k in launches}
    if len(kept.trainers) != len(batches) or trained != launches:
        raise AssertionError(f"batch_quality_study launched {launches}, "
                             f"its epochs {trained} "
                             f"({len(kept.trainers)} trainers)")
    return {"payload": payload, "seconds": seconds, "launches": launches,
            "timings": [tr.timings for tr in kept.trainers]}


def quality_child(argv):
    """``--quality-child``: python -m ladder_tpu_torch.quality's main on
    argv, in this process, every epoch's launches recorded and checked
    (quality_run's checks); writes them beside the record
    (_launches_path). mode_parity's sweep runs this in place of the
    quality module, so that its subprocesses' launches are counted."""
    from ladder_tpu_torch import quality
    device = argv[argv.index("--device") + 1]
    out = argv[argv.index("--out") + 1]
    reset_counters()
    with _Recorder(0), _KeepTrainers() as kept:
        rc = quality.main(argv)
    _sync(device)
    launches = read_counters()
    [trainer] = kept.trainers
    cfg = trainer.config
    _check_celeba_run(out, trainer, range(1, cfg["num_epochs"] + 1),
                      cfg["fused_train_step"], device)
    with open(out) as f:
        record = json.load(f)
    trained = {k: sum(t["launches"][k] for t in trainer.timings)
               for k in launches}
    gen = expected_generation_launches(cfg, record["fid_samples"],
                                       SERVE_BATCH, device)
    want = {k: trained[k] + gen[k] for k in launches}
    if launches != want:
        raise AssertionError(f"{out}: launched {launches}, expected {want}")
    _write_json(_launches_path(out), {"launches": launches, "rc": rc})
    return rc


def _launches_path(record):
    """Where quality_child writes a record's launches: beside it, under a
    name that mode_parity's m*_s*.json does not take."""
    head, tail = os.path.split(record)
    return os.path.join(head, "launches_" + tail)


def drive_mode_parity(work, device, args=MODE_PARITY_ARGS):
    """mode_parity's sweep (each record a subprocess of this script's
    --quality-child, tried once: a failed record fails the phase, its log
    kept) and combine: every record written with finite scale
    keys and its launches checked in its process, the combined record with
    every key of KEYS, both modes and the signed gaps."""
    from ladder_tpu_torch import mode_parity
    from ladder_tpu_torch.quality_spread import SCALE_KEYS
    out_dir = os.path.join(work, "mode_parity")
    sweep_args = mode_parity.parse_args(["sweep", out_dir, *args,
                                         "--device", device])
    t0 = time.perf_counter()
    rc = mode_parity.sweep(sweep_args, quality_cmd=[
        sys.executable, os.path.abspath(__file__), "--quality-child"],
        attempts=1)
    seconds = time.perf_counter() - t0
    if rc != 0:
        logs = {p: open(p).read()[-2000:] for p in sorted(
            os.path.join(out_dir, n) for n in os.listdir(out_dir)
            if n.endswith(".log"))}
        raise AssertionError(f"mode_parity sweep exited {rc}: {logs}")
    launches, records = dict.fromkeys(kernel_counters(), 0), {}
    for seed in mode_parity.SEEDS:
        for fused in mode_parity.MODES:
            tag = f"m{fused}_s{seed}"
            with open(os.path.join(out_dir, f"{tag}.json")) as f:
                records[tag] = json.load(f)
            path = _launches_path(os.path.join(out_dir, f"{tag}.json"))
            with open(path) as f:
                mine = json.load(f)["launches"]
            launches = {k: launches[k] + mine[k] for k in launches}
            bad = {k: records[tag][k] for k in SCALE_KEYS
                   if not np.isfinite(records[tag][k])}
            if bad or records[tag]["recipe"]["exp_name"] != "celeba":
                raise AssertionError(f"mode_parity {tag}: {bad}")
    combined = os.path.join(work, "MODE_PARITY_torch.json")
    rc, _, _, _ = _main_of(mode_parity, ["combine", out_dir, "--out",
                                         combined, "--device", device])
    with open(combined) as f:
        rec = json.load(f)
    if rc != 0 or set(rec["metrics"]) != set(mode_parity.KEYS) or any(
            len(m[f"mode{k}"]["values"]) != len(mode_parity.SEEDS)
            for m in rec["metrics"].values() for k in (1, 2)):
        raise AssertionError(f"mode_parity combine: exit {rc}, {rec}")
    return {"records": records, "combined": rec, "seconds": seconds,
            "launches": launches}


def drive_scripts(device, quality_res, work, sweep_gmm_kw=None,
                  memory_kw=None, batch_kw=None, mode_parity_kw=None):
    """Phase 12 over phase 11's records (their work directories under
    ``work``); the ``*_kw`` reach each part's drive_* function (the CPU
    rehearsal shrinks them). Returns every part's results and the
    phase's launches."""
    from ladder_tpu_torch.data.mnist import synthetic_mnist
    digit, celeba = quality_res["digit"], quality_res["celeba"]
    res = {}
    # verify_real_data check: phase 11 (a)'s synthetic MNIST set written
    # as mnist.npz, and phase 11 (b)'s CelebA TFRecords
    dcfg = digit["config"]
    mnist_dir = os.path.join(work, "mnist_data")
    os.makedirs(mnist_dir)
    (xtr, ytr), (xte, yte) = synthetic_mnist(
        n_train=dcfg["synthetic_n_train"], n_test=dcfg["synthetic_n_test"],
        seed=dcfg["seed"])
    np.savez(os.path.join(mnist_dir, "mnist.npz"), x_train=xtr, y_train=ytr,
             x_test=xte, y_test=yte)
    ccfg = celeba["config"]
    res["check"] = [
        verify_check("mnist_digit", dict(dcfg, data_dir=mnist_dir), work,
                     device, [f"train {xtr.shape}"]),
        verify_check("celeba", ccfg, work, device, [
            f"celebA_{s}.tfrecords: {ccfg[f'synthetic_n_{s}']} records, "
            "first decodes to (128, 128, 3) uint8"
            for s in ("train", "val", "test")])]
    res["compare"] = verify_compare(digit, work, device)
    res["sweep_gmm"] = drive_sweep_gmm(work, device,
                                       **(sweep_gmm_kw or {}))
    _free(device)
    res["memory"] = drive_memory(device, **(memory_kw or {}))
    _free(device)
    res["batch_study"] = drive_batch_study(work, device,
                                           **(batch_kw or {}))
    _free(device)
    res["mode_parity"] = drive_mode_parity(work, device,
                                           **(mode_parity_kw or {}))
    parts = (res["sweep_gmm"]["launches"], res["batch_study"]["launches"],
             res["mode_parity"]["launches"],
             *(m["launches"] for m in res["memory"]))
    res["launches"] = {k: sum(p[k] for p in parts) for k in parts[0]}
    return res


def _free(device):
    import gc
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def log_scripts(res, smi):
    for c in res["check"]:
        log(f"  verify_real_data check ({c['label']}): exit {c['rc']} in "
            f"{c['seconds']:.2f} s: " + " | ".join(c["lines"]))
    c = res["compare"]
    log(f"  verify_real_data compare on the {c['label']}'s files: exit "
        f"{c['rc']}, checks {c['checks']} (failing {c['failing']}; the "
        "phase's own reading agrees check by check)")
    s = res["sweep_gmm"]
    log(f"  sweep_gmm on {smi}: {s['seconds']:.1f} s, launches "
        f"{s['launches']}")
    for row, timings in zip(s["rows"], s["timings"]):
        steps = ", ".join(f"{t['train']['step_ms']:.1f}" for t in timings)
        log(f"    {row}; step ms by epoch {steps}")
    for m in res["memory"]:
        rep = m["report"]
        log(f"  {m['label']} on {smi}: state_mb {rep['state_mb']}, batch_mb "
            f"{rep['batch_mb']}, measured_mb {rep['measured_mb']} "
            f"({m['seconds']:.1f} s; launches {m['launches']})")
    b = res["batch_study"]
    log(f"  batch_quality_study on {smi}: {b['seconds']:.1f} s, launches "
        f"{b['launches']}")
    for run in b["payload"]["runs"]:
        log(f"    batch {run['batch']}: lr x{run['lr_scale']}, train "
            f"{run['train_neg_elbo']}, val {run['val_neg_elbo']}, sigma "
            f"{run['sigma']}, wall {run['wall_s']} s")
    p = res["mode_parity"]
    log(f"  mode_parity sweep + combine on {smi}: {p['seconds']:.1f} s for "
        f"{len(p['records'])} records (one after another), launches "
        f"{p['launches']}")
    for tag, rec in sorted(p["records"].items()):
        log(f"    {tag}: train_wall_s {rec['train_wall_s']}, val neg-ELBO "
            f"{rec['final_val_neg_elbo']:.1f}, sigma_final "
            f"{rec['sigma_final']:.4f}, active {rec['active_mixtures']}, "
            f"FID {rec['encoder_fid_generated_vs_test']:.3f}")
    log("    combined gaps (mode2 - mode1): " + ", ".join(
        f"{k} {m['mode2_minus_mode1_mean']:.4g}"
        for k, m in p["combined"]["metrics"].items()))
    log(f"  phase 12 launches {res['launches']}")


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


def run_scripts_phases(device, smi, walls):
    """Phase 11, its records kept, then phase 12 over them; each phase's
    launches (every kernel launched at least once in each)."""
    import shutil
    import tempfile
    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_scripts_")
    try:
        walls.start(11)
        log(PHASE11)
        quality = drive_quality(device, work=os.path.join(work, "quality"))
        log_quality(quality, smi)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        walls.start(12)
        log(PHASE12)
        scripts = drive_scripts(device, quality, work)
        log_scripts(scripts, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cuda = torch.device(device).type == "cuda"
    for n, total in ((11, quality["launches"]), (12, scripts["launches"])):
        missing = [k for k, v in total.items() if v <= 0]
        if cuda and missing:
            raise AssertionError(f"phase {n} never launched {missing}")
    return quality["launches"], scripts["launches"]


PHASE13 = ("== phase 13: the profilers through python -m ladder_tpu_torch."
           "{profile_step,conv_breakdown,bench_input_pipeline,stream_trace} "
           "(CelebA-128 at its published widths)")
# the five kernels' names in a trace (csrc/*.cu): each wrapper launches its
# kernel once a call
KERNEL_TRACE_NAMES = {
    "norm_chain_fwd": r"\bnorm_chain_fwd_(kernel|regs|ring)\b",
    "norm_chain_bwd": r"\bnorm_chain_bwd_kernel\b",
    "output_stage_fwd": r"\boutput_stage_fwd_kernel\b",
    "output_stage_bwd": r"\boutput_stage_bwd_kernel\b",
    "adam_update": r"\badam_kernel\b"}
# profile_step's runs: its defaults, then float32 mode 1 at 4 steps
PROFILE_RUNS = (("bf16 mode 2", ()),
                ("float32 mode 1", ("--dtype", "float32", "--fused", "1",
                                    "--steps", "4")))
# stream_trace's streamed steps (40 at its defaults; 20 keep the script's
# time)
STREAM_STEPS = 20
STREAM_KEYS = ("what", "batch", "steps", "batch_mb", "wall_step_ms",
               "device_busy_ms", "device_idle_ms", "transfer_ms", "link_mbs",
               "serial_bound_ms", "overlap_bound_ms", "overlap_efficiency",
               "img_per_s")


def trace_launches(rows):
    """Launches of each of the five kernels in a profile_step report's
    rows (name, ms a step, launches a step, launches)."""
    import re
    return {k: sum(n for name, _, _, n in rows if re.search(pat, name))
            for k, pat in KERNEL_TRACE_NAMES.items()}


def check_launches(label, rows, counted, want, traced, taken):
    """The trace holds ``traced`` steps of ``want`` launches of every
    kernel, the wrappers counted ``taken`` steps of them; raises
    otherwise."""
    in_trace = trace_launches(rows)
    for k, per_step in want.items():
        if per_step <= 0:
            raise AssertionError(f"{label}: {k} expected no launch a step")
        if in_trace[k] != traced * per_step:
            raise AssertionError(f"{label}: {in_trace[k]} {k} kernels in the "
                                 f"trace, {traced} steps x {per_step} "
                                 "expected")
        if counted[k] != taken * per_step:
            raise AssertionError(f"{label}: {k} counted {counted[k]}, "
                                 f"{taken} steps x {per_step} expected")
    return in_trace


def check_conv_rows(label, rows, n=14):
    """conv_breakdown's rows: n of them, every time finite and positive."""
    import math
    if len(rows) != n:
        raise AssertionError(f"{label}: {len(rows)} conv rows, {n} expected")
    for r in rows:
        if not all(math.isfinite(t) and t > 0 for t in (r[5], r[7], r[9])):
            raise AssertionError(f"{label}: {r[0]} timed {r[5:]}")


def check_stream_record(rec):
    """The stream record's keys, in the JAX script's order, and a wall a
    step no shorter than the device's busy time."""
    if tuple(rec) != STREAM_KEYS:
        raise AssertionError(f"stream record keys {list(rec)}")
    if not rec["wall_step_ms"] >= rec["device_busy_ms"] > 0:
        raise AssertionError(f"stream wall {rec['wall_step_ms']} ms a step "
                             f"under its busy {rec['device_busy_ms']} ms")


def drive_profilers(work):
    """Phase 13 (see the module docstring) on the card; every check of the
    phase. Returns what it measured, with the wrappers' launches of all
    its runs under 'launches'."""
    import torch
    from ladder_tpu_torch import (bench_input_pipeline, conv_breakdown,
                                  profile_step, stream_trace)

    total = dict.fromkeys(kernel_counters(), 0)
    res = {"profile": {}, "conv": {}, "seconds": {}}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        res["seconds"][label] = time.perf_counter() - t0
        return out

    def counted(label, fn):
        reset_counters()
        out = timed(label, fn)
        got = read_counters()
        for k in total:
            total[k] += got[k]
        return out, got

    for i, (label, argv) in enumerate(PROFILE_RUNS):
        log(f"  profile_step {label}:")
        args = profile_step.parse_args(list(argv) + [
            "--top", "15", "--logdir", os.path.join(work, f"profile{i}")])
        summary, got = counted(f"profile_step {label} capture",
                               lambda: profile_step.capture(args))
        rows = timed(f"profile_step {label} report",
                     lambda: profile_step.report(args))
        want = expected_step_launches(profile_step.build_config(args),
                                      args.fused, "cuda")
        check_launches(f"profile_step {label}", rows, got, want, args.steps,
                       args.steps + profile_step.WARMUP)
        res["profile"][label] = dict(
            rows=rows, summary=summary, launches=got, want=want,
            step_ms=summary["wall_ms"] / summary["steps"])
        torch.cuda.empty_cache()

    for dtype in ("bfloat16", "float32"):
        log(f"  conv_breakdown {dtype}:")
        rows = timed(f"conv_breakdown {dtype}",
                     lambda: conv_breakdown.main(["--dtype", dtype]))
        check_conv_rows(f"conv_breakdown {dtype}", rows)
        res["conv"][dtype] = rows
    torch.cuda.empty_cache()

    step_ms = res["profile"][PROFILE_RUNS[0][0]]["step_ms"]
    log(f"  bench_input_pipeline --step-ms {step_ms:.2f} (the bf16 "
        "profile's step wall):")
    rec = timed("bench_input_pipeline", lambda: bench_input_pipeline.main(
        ["--step-ms", f"{step_ms:.2f}"]))
    for key in ("python", "native"):
        if not min(rec[key].values()) > 0:
            raise AssertionError(f"input pipeline {key}: {rec[key]}")
    if rec["device_ceiling_img_s"] is None:
        raise AssertionError("input pipeline: no device-side keys")
    res["input"] = rec

    log("  stream_trace:")
    argv = ["--out", os.path.join(work, "STREAM_torch.json"), "--logdir",
            os.path.join(work, "stream"), "--steps", str(STREAM_STEPS)]
    sargs = stream_trace.parse_args(argv)
    _, got = counted("stream_trace", lambda: stream_trace.main(argv))
    with open(sargs.out) as f:
        stream = json.load(f)
    check_stream_record(stream)
    rows = timed("stream_trace report", lambda: profile_step.report(
        profile_step.parse_args(["--report-only", "--top", "15", "--steps",
                                 str(stream["steps"]), "--logdir",
                                 sargs.logdir])))
    want = expected_step_launches(stream_trace.build_config(sargs), 2, "cuda")
    check_launches("stream_trace", rows, got, want, stream["steps"],
                   sargs.steps + sargs.warmup)
    res["stream"] = dict(record=stream, launches=got, want=want)
    torch.cuda.empty_cache()
    res["launches"] = total
    return res


def log_profilers(res, smi):
    for label, p in res["profile"].items():
        log(f"  profile_step {label} on {smi}: {p['step_ms']:.2f} ms a step "
            f"(traced wall over {p['summary']['steps']} steps), device busy "
            f"{p['summary']['device_busy_ms'] / p['summary']['steps']:.2f} "
            f"ms, idle share {p['summary']['idle_share']:.1%}; launches "
            f"{p['launches']} ({p['want']} a step)")
    for dtype, rows in res["conv"].items():
        log(f"  conv_breakdown {dtype} on {smi}: fwd "
            f"{sum(r[5] for r in rows):.2f} ms, dgrad "
            f"{sum(r[7] for r in rows):.2f} ms, wgrad "
            f"{sum(r[9] for r in rows):.2f} ms over the 14 convs")
    log(f"  input pipeline on the card's host: {json.dumps(res['input'])}")
    log(f"  stream on {smi}: {json.dumps(res['stream']['record'])}; "
        f"launches {res['stream']['launches']}")
    log("  seconds on the host clock: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["seconds"].items()))


def run_profilers_phase(smi, walls):
    """Phase 13; its launches."""
    import shutil
    import tempfile
    walls.start(13)
    log(PHASE13)
    work = tempfile.mkdtemp(prefix="chip_smoke_profilers_")
    try:
        res = drive_profilers(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log_profilers(res, smi)
    return res["launches"]


class _Walls:
    """Each phase's wall on the host clock: start(n) ends the phase before
    it, and each end logs a line of its own."""

    def __init__(self):
        self.walls, self.cur = {}, None

    def start(self, n):
        self.stop()
        self.cur = (n, time.perf_counter())

    def stop(self):
        if self.cur is not None:
            n, t0 = self.cur
            self.walls[n] = time.perf_counter() - t0
            self.cur = None
            log(f"== phase {n} wall: {self.walls[n]:.1f} s (host clock)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--quality-child"]:
        os.chdir(ROOT)
        return quality_child(argv[1:])
    walls = _Walls()
    try:
        return _main(argv, walls)
    finally:
        walls.stop()


def _main(argv, walls):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("build", "kernels", "serving",
                                           "training", "mnist", "celeba",
                                           "interp", "utils", "parallel",
                                           "tp", "quality", "scripts",
                                           "profilers", "times"))
    parser.add_argument("--package", default=ROOT,
                        help="checkout whose ladder_tpu_torch is imported")
    parser.add_argument("--ab", metavar="DIR",
                        help="compare DIR's kernel times with this tree's")
    parser.add_argument("--out", help="write the --ab results here (JSON)")
    parser.add_argument("--tp-backend", default="gloo",
                        choices=("gloo", "nccl"),
                        help="--only tp: the ranks' backend; nccl puts each "
                             "rank on a card of its own (4 cards)")
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
    walls.start(1)
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
        walls.start(2)
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
        walls.start(5)
        log("== phase 5: training the pretrained mnist_digit model through "
            "the trainer")
        log_mnist(drive_mnist("cuda"), smi)
        return 0
    if only == "celeba":
        walls.start(6)
        log(PHASE6)
        log_celeba(drive_celeba("cuda"), smi)
        return 0
    if only == "interp":
        walls.start(7)
        log(PHASE7)
        interp = drive_interp("cuda")
        log_interp(interp, drive_other_trainers("cuda"), smi)
        return 0
    if only == "utils":
        walls.start(8)
        log(PHASE8)
        log_utils(drive_utils("cuda"), smi)
        return 0
    if only == "parallel":
        walls.start(9)
        log(PHASE9)
        log_parallel(drive_parallel("cuda"), smi)
        return 0
    if only == "tp":
        walls.start(10)
        log(PHASE10)
        log_tp(drive_tp("cuda", peaks=peaks, backend=args.tp_backend), smi)
        return 0
    if only == "quality":
        walls.start(11)
        log(PHASE11)
        log_quality(drive_quality("cuda"), smi)
        return 0
    if only == "scripts":
        run_scripts_phases("cuda", smi, walls)
        return 0
    if only == "profilers":
        run_profilers_phase(smi, walls)
        return 0

    walls.start(3)
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
        reset_counters()
        for b in drive_bench_serving("cuda"):
            log(f"  bench_serving ({b['label']}) on {smi}: {b['seconds']:.1f}"
                f" s, {b['decodes']} decoding device calls, "
                f"{b['launches']} norm-chain launches")
            log(f"    {b['line']}")
        serving = {k: serving[k] + v for k, v in read_counters().items()}
        torch.cuda.empty_cache()
        if only:
            return 0

    walls.start(4)
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

    walls.start(5)
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
        walls.start(6)
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

        walls.start(7)
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

    del interp, others
    torch.cuda.empty_cache()

    walls.start(8)
    log(PHASE8)
    utils = drive_utils("cuda")
    log_utils(utils, smi)
    utils_launches = utils["launches"]
    if (utils_launches["norm_chain_fwd"] <= 0
            or utils_launches["adam_update"] <= 0):
        raise AssertionError("phase 8 never launched the norm-chain forward "
                             "(CelebA decodes) or the Adam update (the "
                             "async-checkpoint epoch)")
    del utils
    torch.cuda.empty_cache()

    walls.start(9)
    log(PHASE9)
    parallel = drive_parallel("cuda")
    log_parallel(parallel, smi)
    parallel_total = parallel_launches(parallel)
    missing = [k for k, v in parallel_total.items() if v <= 0]
    if missing:
        raise AssertionError(f"phase 9 never launched {missing}")
    del parallel
    torch.cuda.empty_cache()

    walls.start(10)
    log(PHASE10)
    tp = drive_tp("cuda", peaks=peaks)
    log_tp(tp, smi)
    tp_total = tp_launches(tp)
    missing = [k for k, v in tp_total.items() if v <= 0]
    if missing:
        raise AssertionError(f"phase 10 never launched {missing}")
    tp_adam = tp.get("adam_shards")
    del tp
    torch.cuda.empty_cache()

    quality_total, scripts_total = run_scripts_phases("cuda", smi, walls)
    torch.cuda.empty_cache()
    profilers_total = run_profilers_phase(smi, walls)
    walls.stop()
    log("phase walls on the host clock: " + ", ".join(
        f"{n} {w:.1f} s" for n, w in walls.walls.items())
        + f"; {sum(walls.walls.values()):.1f} s in all")

    total = {k: serving[k] + training[k] + mnist_launches[k]
             + celeba_launches[k] + interp_launches[k] + prior_launches[k]
             + utils_launches[k] + parallel_total[k] + tp_total[k]
             + quality_total[k] + scripts_total[k] + profilers_total[k]
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
        dict(adam_entry(adam_c, total["adam_update"]), tp_shards=tp_adam)]
    for entry in kernels:
        entry["launches_serving"] = serving[entry["name"]]
        entry["launches_training"] = training[entry["name"]]
        entry["launches_mnist"] = mnist_launches[entry["name"]]
        entry["launches_celeba"] = celeba_launches[entry["name"]]
        entry["launches_interp"] = interp_launches[entry["name"]]
        entry["launches_priors"] = prior_launches[entry["name"]]
        entry["launches_utils"] = utils_launches[entry["name"]]
        entry["launches_parallel"] = parallel_total[entry["name"]]
        entry["launches_tp"] = tp_total[entry["name"]]
        entry["launches_quality"] = quality_total[entry["name"]]
        entry["launches_scripts"] = scripts_total[entry["name"]]
        entry["launches_profilers"] = profilers_total[entry["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
