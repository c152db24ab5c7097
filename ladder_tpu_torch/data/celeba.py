"""CelebA-128 data: indexed TFRecord reading, shuffled epochs, background
prefetch with the host-to-device copy, and the synthetic dataset.

The port of ``ladder_tpu/data/celeba.py``. For a seed it gives the same
synthetic images, the same files and the same batches in the same order:
a numpy permutation over the records per epoch (a full-dataset shuffle,
where the reference's tf.data pipeline keeps a 1000+3B shuffle buffer),
remainder dropped, uint8 [B,128,128,3] batches.

The records are read by the native C++ reader (ladder_tpu_torch/runtime);
``prefer_native=False`` asks for the Python reader (data/tfrecord.py)
instead. When the native library cannot be built, construction raises: the
Python reader is used only when it is asked for.

``epoch(..., to_device=device)`` moves each batch onto a ``torch.device``
in the prefetch thread, as ``ladder_tpu`` does its ``device_put`` there. On a CUDA device the thread decodes into one of a few
pinned host buffers and copies it on a stream of its own; the consumer's
stream waits for that copy (an event) when it takes the batch, the batch is
``record_stream``'d on the consumer's stream so the caching allocator does
not hand its memory out while a step still reads it, and a pinned buffer is
written again only after its last copy has finished.

Set config['synthetic_data']=1 to generate deterministic CelebA-shaped
TFRecords on first use (config['synthetic_n_train'/'_val'/'_test']).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from ladder_tpu_torch.data.tfrecord import (
    ImageRecordReader,
    write_image_tfrecords,
)

PINNED_BUFFERS = 4  # the queue's depth 2, one being copied, one being read


def synthetic_celeba_images(n, seed=0, size=128, chunk=128):
    """Deterministic face-like images: smooth multi-scale colour blobs,
    uint8 [N,size,size,3]. The rng draw order and the per-blob accumulation
    order are ``ladder_tpu``'s, so a seed gives the same bytes."""
    rng = np.random.default_rng(seed)
    params = np.empty((n, 6, 7), np.float32)
    for i in range(n):
        for b in range(6):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.05, 0.3, 2)
            color = rng.uniform(0, 1, 3)
            params[i, b] = (cx, cy, sx, sy, *color)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    for s in range(0, n, chunk):
        p = params[s:s + chunk]                              # [B,6,7]
        cx = p[..., 0][..., None, None]
        cy = p[..., 1][..., None, None]
        sx = p[..., 2][..., None, None]
        sy = p[..., 3][..., None, None]
        blob = np.exp(-((xx[None, None] - cx) ** 2 / (2 * sx ** 2)
                        + (yy[None, None] - cy) ** 2 / (2 * sy ** 2)))
        img = np.zeros((p.shape[0], size, size, 3), np.float32)
        for b in range(6):                                   # keep add order
            img += blob[:, b, :, :, None] * p[:, b, None, None, 4:7]
        img /= np.maximum(img.max(axis=(1, 2, 3), keepdims=True), 1e-6)
        out[s:s + chunk] = (img * 255).astype(np.uint8)
    return out


def ensure_synthetic_tfrecords(data_path, n_train=512, n_val=128, n_test=64,
                               seed=0, size=128, timings=None):
    """Create celebA_{train,val,test}.tfrecords under data_path if absent.
    ``timings`` (a dict) receives, per file created, the seconds spent
    synthesising its images and writing it."""
    import time

    os.makedirs(data_path, exist_ok=True)
    specs = [("celebA_train.tfrecords", n_train, seed),
             ("celebA_val.tfrecords", n_val, seed + 1),
             ("celebA_test.tfrecords", n_test, seed + 2)]
    for name, n, s in specs:
        path = os.path.join(data_path, name)
        if not os.path.isfile(path):
            t0 = time.perf_counter()
            images = synthetic_celeba_images(n, seed=s, size=size)
            t1 = time.perf_counter()
            write_image_tfrecords(path, images)
            if timings is not None:
                timings[name] = (t1 - t0, time.perf_counter() - t1)
    return data_path


class Prefetcher:
    """Background-thread batch assembly with a bounded queue (depth 2 =
    double buffering): the host reads batch k+1 while the device runs step
    k. The thread starts with the iteration, so an iterator dropped before
    its first ``next`` starts none; ``close()`` (also run when a started
    iterator is abandoned and collected) stops it, as otherwise it would
    wait on the full queue forever."""

    _END = object()

    def __init__(self, fn, idx_batches, depth=2):
        self.q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for idxs in idx_batches:
                    if not put(fn(idxs)):
                        return
            except Exception as e:
                self._err = e
            put(self._END)

        self._worker = worker
        self.t = None

    def __iter__(self):
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()
        try:
            while True:
                item = self.q.get()
                if item is self._END:
                    if self._err:
                        raise self._err
                    return
                yield item
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self.t is not None:
            self.t.join()


class _CudaPlacer:
    """Host batch -> CUDA tensor from the prefetch thread (see the module
    docstring): ``fetch(idxs)`` runs in the thread and returns (tensor,
    copy event); ``arrive(item)`` runs in the consumer's thread."""

    def __init__(self, reader, batch_size, device):
        self.reader = reader
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        shape = (batch_size,) + tuple(reader.shape)
        self.pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                       for _ in range(PINNED_BUFFERS)]
        self.copied = [None] * PINNED_BUFFERS   # the last copy out of each
        self.next = 0

    def fetch(self, idxs):
        k = self.next
        self.next = (k + 1) % PINNED_BUFFERS
        if self.copied[k] is not None:
            self.copied[k].synchronize()        # its last copy has finished
        host = self.pinned[k][:len(idxs)]
        self.reader.read_batch(idxs, out=host.numpy())
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            batch = torch.empty(host.shape, dtype=torch.uint8,
                                device=self.device)
            batch.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[k] = done
        return batch, done

    @staticmethod
    def arrive(item):
        batch, done = item
        stream = torch.cuda.current_stream(batch.device)
        stream.wait_event(done)
        batch.record_stream(stream)
        return batch


class CelebARecords:
    """Epoch iteration over one TFRecord split (see the module
    docstring)."""

    def __init__(self, path, shape=(128, 128, 3), prefer_native=True):
        if prefer_native:
            from ladder_tpu_torch.runtime import NativeImageRecordReader
            self.reader = NativeImageRecordReader(path, shape)
        else:
            self.reader = ImageRecordReader(path, shape)
        self.native = bool(prefer_native)
        self.n = len(self.reader)

    def epoch_indices(self, batch_size, seed, drop_remainder=True):
        """The epoch's index batches: a numpy permutation keyed on seed."""
        perm = np.random.default_rng(seed).permutation(self.n)
        n_batches = (self.n // batch_size if drop_remainder
                     else -(-self.n // batch_size))
        return [perm[i * batch_size:(i + 1) * batch_size]
                for i in range(n_batches)]

    def epoch(self, batch_size, seed, drop_remainder=True, prefetch=True,
              to_device=None, rows=None):
        """uint8 [B,H,W,C] batches of one shuffled epoch: numpy arrays, or
        tensors on the device ``to_device``, placed in the prefetch thread
        (prefetch=True) so that the read and the copy of batch k+1 overlap
        step k. ``rows`` (a slice, a data-parallel rank's rows) reads only
        those rows of each batch's indices."""
        idx_batches = self.epoch_indices(batch_size, seed, drop_remainder)
        if rows is not None:
            idx_batches = [ix[rows] for ix in idx_batches]
            batch_size = len(idx_batches[0]) if idx_batches else 0
        arrive = None
        if to_device is None:
            fetch = self.reader.read_batch
        else:
            device = torch.device(to_device)
            if device.type == "cuda" and prefetch:
                placer = _CudaPlacer(self.reader, batch_size, device)
                fetch, arrive = placer.fetch, placer.arrive
            else:
                def fetch(ix):
                    return torch.from_numpy(
                        self.reader.read_batch(ix)).to(device)
        if not prefetch:
            return (fetch(ix) for ix in idx_batches)
        batches = iter(Prefetcher(fetch, idx_batches))
        if arrive is None:
            return batches
        return (arrive(item) for item in batches)

    def first_batch(self, batch_size):
        """Sequential head batch (the reference's test batch is the first
        batch of celebA_test.tfrecords, its trainers.py:134-136)."""
        return self.reader.read_batch(np.arange(min(batch_size, self.n)))


def data_path(config):
    """config['data_path'], else $LADDER_DATA_DIR, else ./data/celeba/."""
    return config.get("data_path") or os.environ.get(
        "LADDER_DATA_DIR", "./data/celeba/")


class CelebAData:
    """The three splits; generates the synthetic set first when
    config['synthetic_data'] asks for it. ``build_seconds`` holds, per split
    file created here, the seconds synthesising and writing it."""

    def __init__(self, config):
        cfg = config
        shape = (cfg["dim_input_x"], cfg["dim_input_y"],
                 cfg["dim_input_channel"])
        path = data_path(cfg)
        self.build_seconds = {}
        if cfg.get("synthetic_data"):
            ensure_synthetic_tfrecords(
                path,
                n_train=cfg.get("synthetic_n_train", 512),
                n_val=cfg.get("synthetic_n_val", 128),
                n_test=cfg.get("synthetic_n_test", 64),
                seed=cfg.get("seed", 0), size=shape[0],
                timings=self.build_seconds)
        self.train, self.val, self.test = (
            CelebARecords(os.path.join(path, f"celebA_{split}.tfrecords"),
                          shape)
            for split in ("train", "val", "test"))
        self.n_train = self.train.n
        self.n_val = self.val.n
