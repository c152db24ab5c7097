"""Smoke test of the PyTorch/CUDA port (ladder_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. Card and build: torch and CUDA versions, the card's name and power
   limit (nvidia-smi), and an nvcc build of every kernel of the serving
   path from ladder_tpu_torch/csrc/.
2. Kernels against their plain PyTorch versions at the shapes the serving
   path gives them (CelebA-128, h=512, batch 64; float32 and bfloat16),
   timed with CUDA events beside their bound on this card.
3. Serving: the pretrained CelebA-128 'ours' model (demo/celeba_config.json)
   through ladder_tpu_torch's InferenceEngine on the card: every path, the
   kernel launch count per decoding call, agreement with an engine on the
   CPU over the same weights and batch, a bfloat16 engine within a band of
   float32, and one HTTP round trip through the micro-batching server with
   a drain. Then per-path latencies and a profile of one reconstruction.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

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

    mem_rate, flop_rate = peaks
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
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool((err <= FP32_TOL + FP32_TOL
                           * want.abs()).all())
            else:
                ok = bool((err <= _bf16_ulp(want) + BF16_NEAR_ZERO).all())
            if not ok:
                raise AssertionError(
                    f"norm_chain {shape} {dtype}: max error "
                    f"{err.max().item()} outside tolerance")
            iters = 200 if x.numel() < 1 << 20 else 50
            ms = _cuda_ms(lambda: nc.fused_instnorm_style_lrelu(
                x, scale, shift), iters)
            plain_ms = _cuda_ms(lambda: nc.norm_chain_reference(
                x, scale, shift), iters)
            itemsize = x.element_size()
            nbytes = 2 * x.numel() * itemsize + 2 * b * c * itemsize
            # flops per element: sum; sub, square, add; sub, mul, fma, select
            nflops = 8 * x.numel()
            t_bytes, t_ops = nbytes / mem_rate * 1e3, nflops / flop_rate * 1e3
            cases.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "stages_per_decode": per_decode,
                "max_abs_err": err.max().item(), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            log(f"  norm_chain {list(shape)} {cases[-1]['dtype']}: "
                f"max_abs_err {cases[-1]['max_abs_err']:.3g}  kernel "
                f"{ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f} us  bound "
                f"{cases[-1]['bound_ms'] * 1e3:.2f} us")
    return cases


def norm_chain_entry(cases, launches):
    """One JSON entry: the per-decode (four stages, float32) totals."""
    f32 = [c for c in cases if c["dtype"] == "float32"]

    def per_decode(key):
        return sum(c[key] * c["stages_per_decode"] for c in f32)

    return {"name": "norm_chain_fwd", "route": "cuda",
            "source": "ladder_tpu_torch/csrc/norm_chain.cu",
            "replaces": "ladder_tpu/ops/pallas_kernels.py:46",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": per_decode("ms"), "plain_ms": per_decode("plain_ms"),
            "bound_ms": per_decode("bound_ms"), "bound_by": "bytes"
            if all(c["bound_by"] == "bytes" for c in f32) else "operations",
            "library_ms": None, "dtype": "float32",
            "shape": "one decode at batch 64: [64,512,2,2] x2, "
                     "[64,256,16,16], [64,128,64,64] (NCHW)",
            "cases": cases}


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
    """Device time by kernel for one batch-64 reconstruction, and the
    device's idle share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.reconstruct(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.reconstruct(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((evt.self_device_time_total, evt.key, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and evt.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        log("  profile: no device time recorded (not measured)")
        return
    norm = sum(r[0] for r in rows if "norm_chain" in r[1])
    log(f"  profile of one reconstruct[64]: device activity "
        f"{total / 1e3:.3f} ms in {wall_us / 1e3:.3f} ms wall (idle share "
        f"{max(0.0, 1 - total / wall_us):.1%} with the profiler on); "
        f"norm_chain {norm / 1e3:.3f} ms ({norm / total:.2%})")
    for dev, key, count in rows[:15]:
        log(f"    {dev / 1e3:9.3f} ms {100 * dev / total:5.1f}%  x{count:<3d} "
            f"{key[:100]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from ladder_tpu_torch.ops import norm_chain as nc
    from ladder_tpu_torch.utils.config import process_config

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("== phase 1: card and build")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(f"  {smi}")
    t0 = time.perf_counter()
    so, compiler = nc.build()
    log(f"  norm_chain: {so.name} "
        + (f"built in {time.perf_counter() - t0:.1f} s" if compiler
           else "already built from the same source"))
    for line in compiler.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")
    peak_name, peaks = card_peaks(name)
    log(f"  bounds from the {peak_name} peaks: {peaks[0] / 1e12} TB/s, "
        f"{peaks[1] / 1e12} TFLOP/s float32")

    log("== phase 2: kernels against their plain versions")
    cases = norm_chain_cases(peaks)

    log("== phase 3: serving the pretrained CelebA-128 'ours' model")
    cfg = process_config(CONFIG)
    run = drive_serving(cfg, "cuda")
    for call_name, delta in run["calls"]:
        log(f"  {call_name}: {delta} norm-chain launches")
    log(f"  main path: {run['launches']} norm-chain launches")
    if run["launches"] <= 0:
        raise AssertionError("the main path never launched the kernel")
    eng = run["engine"]
    log(f"  latency_ema on {smi}: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in sorted(eng.latency_ema.items())))
    for label, engine in (("float32", eng), ("bfloat16", run["engine_bf16"])):
        lat = path_latencies(engine, run["x"])
        log(f"  median {label} latency at batch {SERVE_BATCH} on {smi}: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in lat.items()))
    profile_reconstruct(eng, run["x"])

    print(smi)
    print(json.dumps({"kernels": [norm_chain_entry(cases, run["launches"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
