"""The port's MNIST data module (ladder_tpu_torch/data/mnist.py) against
ladder_tpu's: the synthetic dataset, the local files, the balanced fixed
test batch and the epoch shuffle give byte-identical arrays, and the
device-side epoch batches the trainer uses are those batches."""

import gzip
import struct

import numpy as np
import pytest
import torch

from ladder_tpu.data import mnist as jdata
from ladder_tpu_torch.data import mnist as tdata
from tests.conftest import make_config


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_synthetic_mnist_is_byte_identical():
    got = tdata.synthetic_mnist(n_train=300, n_test=50, seed=3)
    want = jdata.synthetic_mnist(n_train=300, n_test=50, seed=3)
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        _same(gy, wy)
    assert got[0][0].dtype == np.uint8 and got[0][0].shape == (300, 28, 28)


@pytest.mark.parametrize("batch_size", [64, 128, 256, 512, 100])
def test_balanced_test_batch_is_byte_identical(batch_size):
    (_, _), (x, y) = jdata.synthetic_mnist(n_train=10, n_test=600, seed=1)
    assert tdata.balanced_counts(batch_size) == jdata.balanced_counts(
        batch_size)
    for g, w in zip(tdata.build_balanced_test_batch(x, y, batch_size),
                    jdata.build_balanced_test_batch(x, y, batch_size)):
        _same(g, w)


@pytest.mark.parametrize("seed", [1, 2, 7920])
def test_epoch_batches_are_byte_identical(seed):
    images = np.random.default_rng(0).random((200, 28, 28, 1)).astype(
        np.float32)
    got = list(tdata.epoch_batches(images, 64, seed))
    want = list(jdata.epoch_batches(images, 64, seed))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    on_device = list(tdata.device_epoch_batches(torch.tensor(images), 64,
                                                seed))
    assert len(on_device) == 3
    for g, w in zip(on_device, want):
        _same(g.numpy(), w)
    assert len(list(tdata.device_epoch_batches(torch.tensor(images), 64,
                                               seed, n_batches=2))) == 2


def _generators(**kw):
    cfg = make_config(batch_size=64, **kw)
    return tdata.DataGenerator(cfg), jdata.DataGenerator(cfg)


def _same_sets(got, want):
    assert (got.n_train, got.n_val) == (want.n_train, want.n_val)
    for name in ("train_set", "val_set", "test_set"):
        for key in ("image", "attrib"):
            _same(getattr(got, name)[key], getattr(want, name)[key])


def test_data_generator_synthetic():
    got, want = _generators(synthetic_data=1, synthetic_n_train=256,
                            synthetic_n_test=128)
    _same_sets(got, want)
    assert got.train_set["image"].shape == (256, 28, 28, 1)


def _write_idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for n in arr.shape:
            f.write(struct.pack(">I", n))
        f.write(arr.tobytes())


@pytest.mark.parametrize("layout", ["npz", "idx"])
@pytest.mark.parametrize("exp", ["mnist_digit", "mnist_fashion"])
def test_data_generator_local_files(tmp_path, layout, exp):
    (xtr, ytr), (xte, yte) = jdata.synthetic_mnist(n_train=128, n_test=100,
                                                   seed=5)
    name = "mnist" if exp == "mnist_digit" else "fashion_mnist"
    if layout == "npz":
        np.savez(tmp_path / f"{name}.npz", x_train=xtr, y_train=ytr,
                 x_test=xte, y_test=yte)
    else:
        d = tmp_path / name
        d.mkdir()
        _write_idx(d / "train-images-idx3-ubyte.gz", xtr, 2051)
        _write_idx(d / "train-labels-idx1-ubyte.gz", ytr, 2049)
        _write_idx(d / "t10k-images-idx3-ubyte.gz", xte, 2051)
        _write_idx(d / "t10k-labels-idx1-ubyte.gz", yte, 2049)
    got, want = _generators(exp_name=exp, synthetic_data=0,
                            data_dir=str(tmp_path))
    _same_sets(got, want)
    if exp == "mnist_fashion":
        assert got.class_name == want.class_name


def test_missing_data_and_bad_idx_files_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("LADDER_DATA_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="synthetic_data"):
        tdata.DataGenerator(make_config(synthetic_data=0,
                                        data_dir=str(tmp_path)))
    bad = tmp_path / "bad.gz"
    _write_idx(bad, np.zeros((1, 2, 2), np.uint8), 1234)
    with pytest.raises(ValueError, match="magic"):
        tdata._load_idx_images(str(bad))
