"""Smoke test of the PyTorch/CUDA port (ladder_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. Card and build: torch and CUDA versions, the card's name and power
   limit (nvidia-smi), and an nvcc build of every kernel from
   ladder_tpu_torch/csrc/, all sources at once.
2. Kernels against their plain PyTorch versions at the shapes the main
   paths give them (CelebA-128, h=512, batch 64; float32 and bfloat16),
   timed with CUDA events beside their bound on this card: the norm chain
   forward and backward at the four decoder stages, the output stage
   forward and backward at [64,128,128,128], and the Adam update over the
   model's encoder+decoder group and over a scalar group.
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

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result. ``--only build|kernels|serving|training`` runs a part
of it (for debugging; it then prints no result lines either).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "demo/celeba_config.json"
SERVE_BATCH = 64
# (NCHW shape, how many of the four style stages run at it per decode)
NORM_CHAIN_STAGES = (((64, 512, 2, 2), 2), ((64, 256, 16, 16), 1),
                     ((64, 128, 64, 64), 1))
# kernel vs plain version, same inputs on the card:
#  float32: allclose with rtol = atol = 1e-5 (sums in another order);
#  bfloat16: one bf16 ulp of the plain output, 2**(e-7) for |y| in
#  [2**e, 2**(e+1)), plus 1e-6 absolute near zero, where one ulp is smaller
#  than the float32 difference of the two versions' statistics.
FP32_TOL = 1e-5
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


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cuda_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bf16_ulp(y):
    import torch
    a = y.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def norm_chain_cases(peaks):
    """Kernel vs plain version at every stage shape, float32 and bf16."""
    import torch
    from ladder_tpu_torch.ops import norm_chain as nc

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape, per_decode in NORM_CHAIN_STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            b, c = shape[:2]
            x = (2.0 * torch.randn(shape, generator=g, device="cuda")
                 + 0.5).to(dtype)
            scale = (0.1 * torch.randn((b, c), generator=g,
                                       device="cuda")).to(dtype)
            shift = (0.1 * torch.randn((b, c), generator=g,
                                       device="cuda")).to(dtype)
            got = nc.fused_instnorm_style_lrelu(x, scale, shift)
            torch.cuda.synchronize()
            want = nc.norm_chain_reference(x, scale, shift)
            err = _hold_rounded(f"norm_chain {shape} {dtype}", got, want,
                                dtype)
            iters = 200 if x.numel() < 1 << 20 else 50
            ms = _cuda_ms(lambda: nc.fused_instnorm_style_lrelu(
                x, scale, shift), iters)
            plain_ms = _cuda_ms(lambda: nc.norm_chain_reference(
                x, scale, shift), iters)
            itemsize = x.element_size()
            nbytes = 2 * x.numel() * itemsize + 2 * b * c * itemsize
            # flops per element: sum; sub, square, add; sub, mul, fma, select
            bound_ms, bound_by = _bound(nbytes, 8 * x.numel(), peaks)
            cases.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "stages_per_decode": per_decode,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"  norm_chain {list(shape)} {cases[-1]['dtype']}: "
                f"max_abs_err {cases[-1]['max_abs_err']:.3g}  kernel "
                f"{ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f} us  bound "
                f"{cases[-1]['bound_ms'] * 1e3:.2f} us")
    return cases


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


def norm_chain_bwd_cases(peaks):
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
            ms = _cuda_ms(lambda: nc.norm_chain_backward(g, x, scale, shift),
                          iters)
            plain_ms = _cuda_ms(lambda: nc.norm_chain_bwd_reference(
                g, x, scale, shift), iters)
            itemsize = x.element_size()
            nbytes = 3 * x.numel() * itemsize + 2 * b * c * (itemsize + 4)
            bound_ms, bound_by = _bound(nbytes, 20 * x.numel(), peaks)
            cases.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "stages_per_decode": per_decode, "max_abs_err": max(errs),
                "planes_compared": share, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"  norm_chain_bwd {list(shape)} {cases[-1]['dtype']}: "
                f"max_abs_err {max(errs):.3g} on {share:.1%} of planes  "
                f"kernel {ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f} us  "
                f"bound {bound_ms * 1e3:.2f} us")
    return cases


def per_decode_entry(name, replaces, cases, launches):
    """One JSON entry for a norm-chain kernel: the per-decode (four stages,
    float32) totals."""
    f32 = [c for c in cases if c["dtype"] == "float32"]

    def per_decode(key):
        return sum(c[key] * c["stages_per_decode"] for c in f32)

    return {"name": name, "route": "cuda",
            "source": "ladder_tpu_torch/csrc/norm_chain.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": per_decode("ms"), "plain_ms": per_decode("plain_ms"),
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
        ms = _cuda_ms(lambda: ost.fused_output_recon(u, weight, bias,
                                                     target), iters)
        plain_ms = _cuda_ms(lambda: ost.output_recon_reference(
            u, weight, bias, target), iters)
        pixels = b * h * w
        nbytes = (u.numel() * u.element_size() + 2 * 3 * pixels * 4
                  + 4 * (weight.numel() + bias.numel() + 2))
        bound_ms, bound_by = _bound(nbytes, pixels * (2 * 3 * c + 2 * c + 12),
                                    peaks)
        fwd.append({"shape": [b, c, h, w], "dtype": label,
                    "max_abs_err": max(errs),
                    "l1_rel_err": abs(l1.item() / l1_p.item() - 1),
                    "l2_rel_err": abs(l2.item() / l2_p.item() - 1),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        log(f"  output_stage_fwd {[b, c, h, w]} {label}: dec max_abs_err "
            f"{max(errs):.3g}, l1 rel {fwd[-1]['l1_rel_err']:.2g}, l2 rel "
            f"{fwd[-1]['l2_rel_err']:.2g}  kernel {ms:.3f} ms  plain "
            f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms")

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
            ms = _cuda_ms(lambda: ost.output_recon_backward(
                u, weight, dec, target, a1, a2, dd), iters)
            plain_ms = _cuda_ms(lambda: ost.output_recon_bwd_reference(
                u, weight, dec, target, a1, a2, dd), iters)
            nbytes = (2 * u.numel() * u.element_size()
                      + (3 if with_ddec else 2) * 3 * pixels * 4
                      + 4 * (2 * weight.numel() + bias.numel() + 2))
            bound_ms, bound_by = _bound(nbytes, pixels * (14 * c + 20), peaks)
            bwd.append({"shape": [b, c, h, w], "dtype": label,
                        "ddec": with_ddec, "max_abs_err": max(errs),
                        "du_max_abs_err": errs[0], "dw_max_abs_err": errs[1],
                        "db_max_abs_err": errs[2],
                        "dw_largest": largest[0], "db_largest": largest[1],
                        "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
            log(f"  output_stage_bwd {[b, c, h, w]} {label} ddec="
                f"{with_ddec}: max_abs_err du {errs[0]:.3g} dW8 "
                f"{errs[1]:.3g} (largest entry {largest[0]:.4g}) db8 "
                f"{errs[2]:.3g} (largest {largest[1]:.4g})  kernel {ms:.3f} "
                f"ms  plain "
                f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms")
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
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "dtype": "float32", "shape": f"u {main['shape']} (NCHW)",
            "cases": cases}


def adam_cases(cfg, peaks):
    """The Adam kernel vs its plain version: three updates of the h=512
    model's encoder+decoder group and of a one-element group, gradients up
    to several units in size so that the clip acts."""
    import torch
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.ops import adam
    from ladder_tpu_torch.training.optim import ADAM_B1, ADAM_B2, ADAM_EPS
    from ladder_tpu_torch.training.step import group_params

    model = make_model(cfg, seed=3).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    groups = {
        "ae": [p.detach().clone() for p in
               group_params(model, ("encoder", "decoder")).values()],
        "scalar": [torch.tensor(0.5, device="cuda")]}
    del model
    cases = []
    for name, params in groups.items():
        n = sum(p.numel() for p in params)
        # half of a tensor's gradient elements are exactly zero
        grads = [3.0 * torch.randn(p.shape, generator=gen, device="cuda")
                 * (torch.rand(p.shape, generator=gen, device="cuda")
                    < (0.5 if p.numel() > 1 else 1.0))
                 for p in params]
        state = {kind: ([p.clone() for p in params],
                        [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])
                 for kind in ("kernel", "plain")}
        before = adam.adam_update_.launches
        for t in (1, 2, 3):
            adam.adam_update_(*_with_grads(state["kernel"], grads), 2.5e-4,
                              t, ADAM_B1, ADAM_B2, ADAM_EPS)
            adam.adam_update_reference(
                *_with_grads(state["plain"], grads),
                adam.bias_corrected_lr(2.5e-4, t, ADAM_B1, ADAM_B2), ADAM_B1,
                ADAM_B2, ADAM_EPS)
        torch.cuda.synchronize()
        if adam.adam_update_.launches - before != 3:
            raise AssertionError("adam: one launch per group update expected")
        err = 0.0
        for part, got, want in zip(("p", "m", "v"), state["kernel"],
                                   state["plain"]):
            for a, w in zip(got, want):
                err = max(err, _hold(f"adam {name} {part}", a, w, ADAM_RTOL,
                                     ADAM_ATOL))
        moved = max((a - p).abs().max().item()
                    for a, p in zip(state["kernel"][0], params))
        if not moved > 0:
            raise AssertionError(f"adam {name}: parameters did not move")
        iters = 20 if n > 1 << 20 else 200
        ms = _cuda_ms(lambda: adam.adam_update_(
            *_with_grads(state["kernel"], grads), 2.5e-4, 4, ADAM_B1,
            ADAM_B2, ADAM_EPS), iters)
        plain_ms = _cuda_ms(lambda: adam.adam_update_reference(
            *_with_grads(state["plain"], grads), 2.5e-4, ADAM_B1, ADAM_B2,
            ADAM_EPS), iters)
        # torch's own fused Adam over the same tensors moves the same bytes
        # but computes another function (no clip, eps on the corrected
        # sqrt(v)): a yardstick for the launch, not a library_ms
        twins = [p.clone().requires_grad_(True) for p in params]
        for p_, g in zip(twins, grads):
            p_.grad = g
        opt = torch.optim.Adam(twins, lr=2.5e-4, betas=(ADAM_B1, ADAM_B2),
                               eps=ADAM_EPS, fused=True)
        torch_fused_ms = _cuda_ms(opt.step, iters)
        # the wrapper's own time on the host (checks, address arrays): where
        # it is near ms, back-to-back calls wait for the host, not the card
        t0 = time.perf_counter()
        for _ in range(iters):
            adam.adam_update_(*_with_grads(state["kernel"], grads), 2.5e-4, 4,
                              ADAM_B1, ADAM_B2, ADAM_EPS)
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        bound_ms, bound_by = _bound(28 * n, 12 * n, peaks)
        cases.append({"group": name, "tensors": len(params), "elements": n,
                      "max_abs_err": err, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms,
                      "torch_fused_adam_ms": torch_fused_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"  adam {name}: {len(params)} tensors, {n} elements, "
            f"max_abs_err {err:.3g} after 3 updates  kernel {ms * 1e3:.2f} us"
            f" (wrapper's host time {host_ms * 1e3:.2f} us)  plain {plain_ms * 1e3:.2f} us  torch fused Adam (another "
            f"function) {torch_fused_ms * 1e3:.2f} us  bound "
            f"{bound_ms * 1e3:.2f} us")
        del state, grads, twins, opt
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
            "ms": main["ms"], "plain_ms": main["plain_ms"],
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
    of the call's wall time. marks: substrings whose kernels are summed."""
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
        return
    shares = ", ".join(
        f"{mark} {sum(r[0] for r in rows if mark in r[1]) / 1e3:.3f} ms "
        f"({sum(r[0] for r in rows if mark in r[1]) / total:.2%})"
        for mark in marks)
    log(f"  profile of {label}: device activity {total / 1e3:.3f} ms in "
        f"{wall_us / 1e3:.3f} ms wall (idle share "
        f"{max(0.0, 1 - total / wall_us):.1%} with the profiler on); "
        f"{shares}")
    for dev, key, count in rows[:18]:
        log(f"    {dev / 1e3:9.3f} ms {100 * dev / total:5.1f}%  x{count:<3d} "
            f"{key[:100]}")


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("build", "kernels", "serving",
                                           "training"))
    only = parser.parse_args(argv).only
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
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

    if only in (None, "kernels"):
        log("== phase 2: kernels against their plain versions")
        with float32_exact():  # the plain versions' products in full float32
            cases = norm_chain_cases(peaks)
            bwd_cases = norm_chain_bwd_cases(peaks)
            out_fwd, out_bwd = output_stage_cases(peaks)
            adam_c = adam_cases(cfg, peaks)
        if only:
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

    total = {k: serving[k] + training[k] for k in serving}
    kernels = [
        norm_chain_entry(cases, total["norm_chain_fwd"]),
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
