"""Serving throughput benchmark at the CelebA-128 shapes (the counterpart of
``scripts/bench_serving.py``):

    python -m ladder_tpu_torch.bench_serving [--config codes/celeba_config.json]
        [--batch 64] [--iters 50] [--dtype bfloat16] [--mesh 0]
        [--bn-stats PATH] [--device cuda|cpu]

Measures the InferenceEngine's steady-state reconstruct / decode / encode
rates, the generate rate when the engine has a GM fit, the latency of a
request at each bucket, and 1-image requests from 16 threads, straight to
the engine and through the micro-batching ``Batcher``. Checkpoints are
optional (``allow_uninitialized``: random weights), so it runs anywhere.
Prints one JSON line with the JAX script's keys in its order; ``main``
returns the same record.

- ``reconstruct_img_s``, ``decode_img_s``, ``encode_img_s``: host rows
  through the engine's public paths (the copies both ways included).
- ``*_device_img_s``: the engine's device path alone, ``run_path`` on the
  engine's model inside ``engine._device_call()`` (its float32 precision
  policy and inference mode) with the input already on the device and the
  outputs left there: ``2 * iters`` pipelined calls, the device
  synchronised once after the warm-up and once after the loop.

Departures: ``--device`` (cuda unless the caller asks for the CPU; without
a card the default raises); no compilation cache (the JAX script's
``enable_compilation_cache``: the port compiles nothing per shape). With
``--mesh N`` the device rates time every replica at once, each on its
share of the batch in its own thread, and each replica's last output is
read back to the host once, after the loop.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

IMAGE_PATHS = ("encode", "reconstruct", "represent")


def rate(fn, x, iters, warmup=3):
    """End-to-end rate: includes the host<->device copies of inputs and
    outputs."""
    for _ in range(warmup):
        out = fn(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    del out
    dt = time.perf_counter() - t0
    return iters * x.shape[0] / dt


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(engine, name, a, device):
    """A path's host input as the device tensor the path takes."""
    import torch
    return (engine._images(a, device) if name in IMAGE_PATHS
            else torch.tensor(a, device=device))


def device_rate(engine, name, x, iters, warmup=3):
    """Compute-path rate: the input stays on the device, the outputs too,
    and the calls pipeline. On a mesh every replica runs the path on its
    share of the batch in its own thread (the engine's ``_on_replicas``,
    BatchNorm statistics summed across the replicas); each replica's last
    output is read back once, which synchronises its device."""
    from ladder_tpu_torch.serving import engine as serving

    if engine._pool is not None:
        shares = {}

        def loop(n):
            def fn(i, part):
                if i not in shares:
                    shares[i] = _on_device(engine, name, part, engine.mesh[i])
                for _ in range(n):
                    out = serving.run_path(engine._replicas[i], name,
                                           shares[i])
                return out
            return fn

        parts = np.split(x, len(engine.mesh))
        with engine._device_call():
            engine._on_replicas(loop(warmup), parts)
            t0 = time.perf_counter()
            engine._on_replicas(loop(iters), parts)
            dt = time.perf_counter() - t0
        return iters * x.shape[0] / dt

    device = engine.device
    xd = _on_device(engine, name, x, device)
    with engine._device_call():
        for _ in range(warmup):
            out = serving.run_path(engine.model, name, xd)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = serving.run_path(engine.model, name, xd)
        _sync(device)
        dt = time.perf_counter() - t0
    del out
    return iters * x.shape[0] / dt


def concurrent_rate(target, x1, n_threads=16, reqs_per_thread=8):
    """Requests a second from n_threads threads, each sending
    reqs_per_thread 1-image reconstructs (the HTTP serving shape)."""
    barrier = threading.Barrier(n_threads + 1)

    def worker():
        barrier.wait()
        for _ in range(reqs_per_thread):
            target.reconstruct(x1)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return n_threads * reqs_per_thread / (time.perf_counter() - t0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="codes/celeba_config.json")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--bn-stats", default=None,
                    help="bn_stats.npz (python -m ladder_tpu_torch.freeze_bn):"
                         " bench the frozen-BN per-row-deterministic mode")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from ladder_tpu_torch.serving import InferenceEngine
    from ladder_tpu_torch.serving.batcher import Batcher
    from ladder_tpu_torch.utils.config import process_config

    args = parse_args(argv)
    cfg = process_config(args.config)
    engine = InferenceEngine(cfg, serve_batch=args.batch, dtype=args.dtype,
                             mesh_devices=args.mesh,
                             allow_uninitialized=True,
                             bn_stats_path=args.bn_stats, device=args.device)
    cfgd = engine.config
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (args.batch, cfgd["dim_input_x"],
                              cfgd["dim_input_y"],
                              cfgd["dim_input_channel"])).astype(np.uint8)
    z = rng.standard_normal((args.batch, cfgd["code_size"])).astype(
        np.float32)

    results = {
        "reconstruct_img_s": round(rate(engine.reconstruct, x, args.iters), 1),
        "decode_img_s": round(rate(engine.decode, z, args.iters), 1),
        "encode_img_s": round(rate(engine.encode, x, args.iters), 1),
        "reconstruct_device_img_s": round(device_rate(
            engine, "reconstruct", x, args.iters * 2), 1),
        "decode_device_img_s": round(device_rate(
            engine, "decode", z, args.iters * 2), 1),
        "encode_device_img_s": round(device_rate(
            engine, "encode", x, args.iters * 2), 1),
    }
    if engine.gm is not None:
        engine.generate(1)  # the first call before timing
        t0 = time.perf_counter()
        engine.generate(args.batch * 10, seed=0)
        results["generate_img_s"] = round(
            args.batch * 10 / (time.perf_counter() - t0), 1)

    # per-bucket request latency: a 1-image request runs at the smallest
    # bucket, so it must cost about a bucket-1 call, not serve_batch's
    engine.warmup()
    bucket_latency_ms = {}
    n = max(5, args.iters // 5)
    for b in engine.buckets:
        xb = x[:b] if b <= x.shape[0] else np.repeat(
            x, -(-b // x.shape[0]), axis=0)[:b]
        for _ in range(3):
            engine.reconstruct(xb)
        t0 = time.perf_counter()
        for _ in range(n):
            engine.reconstruct(xb)
        bucket_latency_ms[f"reconstruct@b{b}"] = round(
            1000 * (time.perf_counter() - t0) / n, 2)
    results["bucket_latency_ms"] = bucket_latency_ms

    # micro-batching under concurrency: 'direct' runs one bucket-1 call a
    # request, the Batcher coalesces them into shared device batches
    engine.reconstruct(x[:1])  # a bucket-1 call before timing
    direct_rps = concurrent_rate(engine, x[:1])
    batcher = Batcher(engine, max_wait_ms=2.0)
    batcher.reconstruct(x[:1])
    batched_rps = concurrent_rate(batcher, x[:1])
    results["concurrent_1img_req_s"] = {
        "direct": round(direct_rps, 1),
        "micro_batched": round(batched_rps, 1),
        "batches": batcher.stats["batches"],
        "requests": batcher.stats["requests"],
    }
    batcher.close()

    record = {"metric": "serving throughput (CelebA-128)",
              "batch": args.batch, "dtype": args.dtype,
              "buckets": engine.buckets, **results}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
