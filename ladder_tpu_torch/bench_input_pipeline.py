"""Host-side input-pipeline throughput of the port, no device in the loop
(the counterpart of ``scripts/bench_input_pipeline.py``):

    python -m ladder_tpu_torch.bench_input_pipeline [--n-images 4096]
        [--batch 64] [--size 128] [--repeats 3] [--threads N]
        [--records FILE] [--step-ms MS] [--device cuda|cpu]

A streamed run trains at min(host pipeline, copy to the card, device step
rate). This measures the host term: a shuffled epoch of indexed TFRecord
reads, Example decodes and batch assembly through the Python reader
(``data/tfrecord.py:ImageRecordReader``) and the native C++ one
(``runtime/``), each also through the prefetch thread
(``data/celeba.py:Prefetcher``, its host path). Prints ONE JSON line with
the JAX script's keys; ``main`` returns the record.

Three departures. ``--device``: the host that matters is the card's, so
the default, cuda, raises on a machine without a card, and ``--device
cpu`` runs it anywhere (no device is used either way). The device-side
keys (``device_ceiling_img_s``, ``required_transfer_mb_s``,
``host_headroom_x``) come from ``--step-ms``, a batch-64 train step's
time that the caller measured on the card (the JAX script's formula, with
it in place of its TPU step time), and are null without it. A native
reader that cannot be built raises: the port's readers never fall back,
so there is no ``native_error`` key. The synthesized records are removed
at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

# the batch that --step-ms is a step of (the headline recipe's)
HEADLINE_BATCH = 64


def _epoch_rate(reader, n, batch, rng):
    """One shuffled epoch of read_batch; returns (img_s, mb_s)."""
    perm = rng.permutation(n)
    n_batches = n // batch
    t0 = time.perf_counter()
    for i in range(n_batches):
        reader.read_batch(perm[i * batch:(i + 1) * batch])
    dt = time.perf_counter() - t0
    imgs = n_batches * batch
    img_bytes = int(np.prod(reader.shape))
    return imgs / dt, imgs * img_bytes / dt / 1e6


def _prefetch_rate(reader, n, batch, rng):
    """Rate as delivered through the double-buffered prefetch thread."""
    from ladder_tpu_torch.data.celeba import Prefetcher

    perm = rng.permutation(n)
    n_batches = n // batch
    idx_batches = [perm[i * batch:(i + 1) * batch] for i in range(n_batches)]
    t0 = time.perf_counter()
    got = 0
    for b in Prefetcher(reader.read_batch, idx_batches):
        got += len(b)
    dt = time.perf_counter() - t0
    assert got == n_batches * batch
    return got / dt


def bench_reader(make_reader, n, batch, repeats, seed=0):
    reader = make_reader()
    rng = np.random.default_rng(seed)
    _epoch_rate(reader, n, batch, rng)          # warm (page cache, pools)
    rates = [_epoch_rate(reader, n, batch, rng) for _ in range(repeats)]
    img_s = sorted(r[0] for r in rates)[repeats // 2]
    mb_s = sorted(r[1] for r in rates)[repeats // 2]
    pf = sorted(_prefetch_rate(reader, n, batch, rng)
                for _ in range(repeats))[repeats // 2]
    reader.close()
    return {"img_s": round(img_s, 1), "mb_s": round(mb_s, 1),
            "prefetch_img_s": round(pf, 1)}


def device_keys(step_ms, batch, shape, best_img_s):
    """What the device side needs at a measured batch-64 step time (the
    JAX script's formula); nulls without one."""
    if step_ms is None:
        return dict.fromkeys(("device_ceiling_img_s",
                              "required_transfer_mb_s", "host_headroom_x"))
    step_s = step_ms / 1e3 * (batch / HEADLINE_BATCH)
    need_img_s = batch / step_s
    return {"device_ceiling_img_s": round(need_img_s, 1),
            "required_transfer_mb_s": round(
                need_img_s * int(np.prod(shape)) / 1e6, 1),
            "host_headroom_x": round(best_img_s / need_img_s, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-images", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=None,
                    help="native reader decode threads (default: the "
                         "reader's, min(cpu count, 8))")
    ap.add_argument("--records", default=None,
                    help="existing TFRecord file (default: synthesize)")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a batch-64 train step's time measured on the card; "
                         "the device-side keys are null without it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's host) or cpu")
    args = ap.parse_args(argv)

    from ladder_tpu_torch.data.celeba import ensure_synthetic_tfrecords
    from ladder_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)

    shape = (args.size, args.size, 3)
    if args.records:
        return _bench(args, args.records, shape)
    with tempfile.TemporaryDirectory(prefix="ladder_input_bench_") as tmp:
        ensure_synthetic_tfrecords(tmp, n_train=args.n_images, n_val=1,
                                   n_test=1, size=args.size)
        return _bench(args, os.path.join(tmp, "celebA_train.tfrecords"),
                      shape)


def _bench(args, path, shape):
    from ladder_tpu_torch.data.tfrecord import ImageRecordReader
    from ladder_tpu_torch.runtime import NativeImageRecordReader

    probe = ImageRecordReader(path, shape)
    n = (len(probe) // args.batch) * args.batch
    probe.close()
    out = {
        "n_images": n, "batch": args.batch, "image_shape": list(shape),
        "host_cpus": os.cpu_count(),
        "python": bench_reader(lambda: ImageRecordReader(path, shape),
                               n, args.batch, args.repeats),
        "native": bench_reader(
            lambda: NativeImageRecordReader(path, shape,
                                            n_threads=args.threads),
            n, args.batch, args.repeats),
    }
    out.update(device_keys(args.step_ms, args.batch, shape,
                           out["native"]["img_s"]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
