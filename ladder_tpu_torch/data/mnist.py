"""MNIST / Fashion-MNIST data: the port's own copy of
``ladder_tpu/data/mnist.py`` (pure numpy), so that the two packages give
byte-identical arrays: the /255 normalisation and channel axis, the
class-balanced fixed test batch (per-class counts per batch size, filled by
scanning the validation set in order), the deterministic synthetic dataset
(``config['synthetic_data']=1``), local files found through
``config['data_dir']`` or ``$LADDER_DATA_DIR`` (keras ``mnist.npz`` /
``fashion_mnist.npz``, or the idx files), and the per-epoch shuffle keyed on
the epoch. Arrays are NHWC numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

_BALANCED_COUNTS = {
    64: (7, 7, 7, 7, 6, 6, 6, 6, 6, 6),
    128: (13, 13, 13, 13, 13, 13, 13, 13, 12, 12),
    256: (26, 26, 26, 26, 26, 26, 25, 25, 25, 25),
    512: (51, 51, 51, 51, 51, 51, 51, 51, 52, 52),
}

FASHION_CLASS_NAMES = (
    "top", "trousers", "pullover", "dress", "coat",
    "sandal", "shirt", "sneaker", "bag", "ankle boot",
)


def balanced_counts(batch_size):
    """Per-class counts for the fixed test batch (data_loader.py:37-44).

    For batch sizes outside the reference's table, spread classes as evenly
    as possible (first classes get the remainder), preserving sum==batch.
    """
    if batch_size in _BALANCED_COUNTS:
        return _BALANCED_COUNTS[batch_size]
    base, rem = divmod(batch_size, 10)
    return tuple(base + (1 if i < rem else 0) for i in range(10))


def build_balanced_test_batch(x_test, y_test, batch_size):
    """Scan the validation set in order, filling per-class quotas
    (data_loader.py:45-58). Returns (images[B,28,28], labels[B])."""
    counts = balanced_counts(batch_size)
    H, W = x_test.shape[1], x_test.shape[2]
    x_sel = np.zeros((batch_size, H, W), dtype=x_test.dtype)
    y_sel = np.zeros((batch_size,), dtype="uint8")
    filled = [0] * 10
    idx = 0
    n = len(y_test)
    while sum(filled) < batch_size and idx < n:
        cls = int(y_test[idx])
        if filled[cls] < counts[cls]:
            slot = sum(counts[:cls]) + filled[cls]
            x_sel[slot] = x_test[idx]
            y_sel[slot] = cls
            filled[cls] += 1
        idx += 1
    if sum(filled) < batch_size:
        # small validation sets may not cover every class quota (the
        # reference would index past the array here); top up the remaining
        # slots with arbitrary samples so the batch is always full.
        for cls in range(10):
            while filled[cls] < counts[cls]:
                slot = sum(counts[:cls]) + filled[cls]
                j = (slot * 7919) % n
                x_sel[slot] = x_test[j]
                y_sel[slot] = y_test[j]
                filled[cls] += 1
    return x_sel, y_sel


def _load_idx_images(path):
    with gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _load_idx_labels(path):
    with gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8)


def _find_local_mnist(data_dir, choice):
    """Look for mnist in keras-npz or idx layout under data_dir."""
    name = "mnist" if choice == "digit" else "fashion_mnist"
    npz = os.path.join(data_dir, f"{name}.npz")
    if os.path.isfile(npz):
        with np.load(npz) as d:
            return (d["x_train"], d["y_train"]), (d["x_test"], d["y_test"])
    # raw idx layout (train-images-idx3-ubyte[.gz], ...)
    sub = os.path.join(data_dir, name)
    base = sub if os.path.isdir(sub) else data_dir
    def first(*cands):
        for c in cands:
            p = os.path.join(base, c)
            if os.path.isfile(p):
                return p
        return None
    xs = first("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz")
    if xs:
        return (
            (_load_idx_images(xs),
             _load_idx_labels(first("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"))),
            (_load_idx_images(first("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz")),
             _load_idx_labels(first("t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"))),
        )
    return None


def synthetic_mnist(n_train=6000, n_test=1000, seed=0):
    """Deterministic synthetic MNIST-like data: each class c is a blurred
    oriented bar pattern + noise, so the ELBO has class structure to learn.
    uint8 [N,28,28] like the real dataset."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)

    def render(cls, jitter):
        ang = cls * np.pi / 10.0 + jitter[0] * 0.2
        cx, cy = 14 + jitter[1] * 3, 14 + jitter[2] * 3
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        img = np.exp(-(u / (6 + cls * 0.3)) ** 2 - (v / 1.8) ** 2)
        ring = np.exp(-((np.sqrt(u ** 2 + v ** 2) - 4 - cls * 0.4) / 1.5) ** 2)
        return np.clip(img + 0.5 * ring, 0, 1)

    def make(n):
        ys = rng.integers(0, 10, size=n).astype(np.uint8)
        xs = np.empty((n, 28, 28), dtype=np.uint8)
        for i in range(n):
            jit = rng.standard_normal(3)
            base = render(int(ys[i]), jit)
            noisy = base + 0.05 * rng.standard_normal((28, 28))
            xs[i] = (np.clip(noisy, 0, 1) * 255).astype(np.uint8)
        return xs, ys

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return (x_train, y_train), (x_test, y_test)


def separate_train_and_val_set(n_samples, seed=None):
    """Random 90/10 index split (reference BaseDataGenerator, base.py:24-29;
    defined there but never called — provided for inventory completeness,
    deterministic when a seed is given)."""
    import random as _random
    rng = _random.Random(seed)
    n_train = int(np.floor(n_samples * 0.9))
    idx_train = rng.sample(range(n_samples), n_train)
    idx_val = list(set(idx_train) ^ set(range(n_samples)))
    return idx_train, idx_val


class DataGenerator:
    """Loads train/val sets and the fixed balanced test batch.

    Exposes the same attributes the reference trainer consumes:
    n_train, n_val, train_set/val_set/test_set dicts with 'image'
    ([N,H,W,1] float in [0,1]) and 'attrib' (labels).
    """

    def __init__(self, config):
        self.config = config
        exp = config["exp_name"]
        if exp == "mnist_digit":
            self._load_mnist("digit")
        elif exp == "mnist_fashion":
            self._load_mnist("fashion")
        elif exp == "celeba":
            # CelebA streams from TFRecords; only the split sizes live here
            self.n_train = config.get("n_train_celeba", 180000)
            self.n_val = config.get("n_val_celeba", 20000)
        else:
            raise ValueError(f"unknown exp_name: {exp}")

    def _load_mnist(self, choice):
        cfg = self.config
        raw = None
        if cfg.get("synthetic_data"):
            raw = synthetic_mnist(
                n_train=cfg.get("synthetic_n_train", 6000),
                n_test=cfg.get("synthetic_n_test", 1000),
                seed=cfg.get("seed", 0),
            )
        else:
            data_dir = cfg.get("data_dir") or os.environ.get("LADDER_DATA_DIR")
            for d in filter(None, [data_dir, os.path.expanduser("~/.keras/datasets")]):
                raw = _find_local_mnist(d, choice)
                if raw is not None:
                    break
            if raw is None:
                raise FileNotFoundError(
                    "MNIST data not found locally; set config['data_dir'] or "
                    "$LADDER_DATA_DIR to a directory with mnist.npz / idx files, "
                    "or set config['synthetic_data']=1."
                )
        (x_train, y_train), (x_test, y_test) = raw
        x_train = np.asarray(x_train, dtype=np.float32) / 255.0
        x_test = np.asarray(x_test, dtype=np.float32) / 255.0
        self.n_train = x_train.shape[0]
        self.n_val = x_test.shape[0]
        self.train_set = dict(attrib=np.asarray(y_train),
                              image=np.expand_dims(x_train, -1))
        self.val_set = dict(attrib=np.asarray(y_test),
                            image=np.expand_dims(x_test, -1))
        x_sel, y_sel = build_balanced_test_batch(
            x_test, np.asarray(y_test), self.config["batch_size"])
        self.test_set = dict(attrib=y_sel, image=np.expand_dims(x_sel, -1))
        if choice == "fashion":
            self.class_name = FASHION_CLASS_NAMES


def epoch_permutation(n, epoch_seed):
    """The epoch's shuffle: a numpy permutation keyed on the seed."""
    return np.random.default_rng(epoch_seed).permutation(n)


def epoch_batches(images, batch_size, epoch_seed, drop_remainder=True):
    """Yield shuffled batches for one epoch.

    The reference shuffles the full dataset with a per-epoch seed
    (models.py:33-38 with seed fed at trainers.py:26-28); we mirror with a
    numpy permutation keyed on the epoch.
    """
    n = images.shape[0]
    perm = epoch_permutation(n, epoch_seed)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    for i in range(n_batches):
        idx = perm[i * batch_size:(i + 1) * batch_size]
        yield images[idx]


def device_epoch_batches(images, batch_size, epoch_seed, n_batches=None,
                         rows=None):
    """epoch_batches (remainder dropped) over a tensor that lives on the
    device: the permutation is copied over once, and each batch is a
    gather on the device, so the loop never waits on a host-to-device
    copy. ``n_batches`` stops early. ``rows`` (a slice of the batch, a
    data-parallel rank's) gathers only those rows of each batch."""
    import torch

    n = images.shape[0]
    count = n // batch_size
    if n_batches is not None:
        count = min(count, n_batches)
    perm = torch.as_tensor(epoch_permutation(n, epoch_seed)).to(
        images.device)
    for i in range(count):
        idx = perm[i * batch_size:(i + 1) * batch_size]
        yield images[idx if rows is None else idx[rows]]
