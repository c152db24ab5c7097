"""The port's CelebA data path (ladder_tpu_torch/data/celeba.py) against
ladder_tpu's: the synthetic images, the epochs' batches and their order,
the head batch, the device placement (on the CPU device here) and the
three splits of CelebAData, all byte for byte."""

import gc
import threading

import numpy as np
import pytest
import torch

from ladder_tpu.data import celeba as jcel
from ladder_tpu_torch.data import celeba as tcel
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

SIZE = 32
SHAPE = (SIZE, SIZE, 3)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One 50-image split written by the port; its readers and
    ladder_tpu's."""
    path = str(tmp_path_factory.mktemp("celeba") / "celebA_train.tfrecords")
    from ladder_tpu_torch.data.tfrecord import write_image_tfrecords
    images = tcel.synthetic_celeba_images(50, seed=4, size=SIZE)
    write_image_tfrecords(path, images)
    return dict(path=path, images=images,
                native=tcel.CelebARecords(path, SHAPE),
                python=tcel.CelebARecords(path, SHAPE, prefer_native=False),
                jax=jcel.CelebARecords(path, SHAPE))


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_images_are_byte_identical(seed):
    got = tcel.synthetic_celeba_images(9, seed=seed, size=SIZE, chunk=4)
    want = jcel.synthetic_celeba_images(9, seed=seed, size=SIZE, chunk=4)
    assert got.dtype == np.uint8 and got.shape == (9,) + SHAPE
    np.testing.assert_array_equal(got, want)


def test_the_readers_are_chosen_as_asked(split):
    from ladder_tpu_torch.data.tfrecord import ImageRecordReader
    from ladder_tpu_torch.runtime import NativeImageRecordReader
    assert split["native"].native and isinstance(split["native"].reader,
                                                 NativeImageRecordReader)
    assert not split["python"].native
    assert isinstance(split["python"].reader, ImageRecordReader)


@pytest.mark.parametrize("seed", [1, 6])
@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_epochs_match_ladder_tpu(split, seed, reader, prefetch):
    """Same batches, same order: the seed's permutation, 6 full batches of
    8 (remainder dropped), and 7 with drop_remainder=False."""
    mine = split[reader]
    got = list(mine.epoch(8, seed=seed, prefetch=prefetch))
    want = list(split["jax"].epoch(8, seed=seed, prefetch=False))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    perm = np.random.default_rng(seed).permutation(50)
    np.testing.assert_array_equal(got[0], split["images"][perm[:8]])
    tail = list(mine.epoch(8, seed=seed, drop_remainder=False,
                           prefetch=prefetch))
    want = list(split["jax"].epoch(8, seed=seed, drop_remainder=False,
                                   prefetch=False))
    assert [len(b) for b in tail] == [8] * 6 + [2]
    for g, w in zip(tail, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("prefetch", [True, False])
def test_to_device_on_the_cpu_gives_the_same_bytes(split, prefetch):
    got = list(split["native"].epoch(8, seed=3, prefetch=prefetch,
                                     to_device="cpu"))
    want = list(split["jax"].epoch(8, seed=3, prefetch=False))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert torch.is_tensor(g) and g.device.type == "cpu"
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_first_batch_matches(split):
    for n in (8, 64):
        got = split["native"].first_batch(n)
        np.testing.assert_array_equal(got, split["jax"].first_batch(n))
        np.testing.assert_array_equal(got, split["images"][:min(n, 50)])


def test_an_abandoned_prefetching_epoch_stops_its_thread(split):
    it = split["native"].epoch(8, seed=0)
    next(it)
    thread = it.gi_frame.f_locals["self"].t
    it.close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_an_epoch_dropped_before_its_first_batch_starts_no_thread(split):
    """The thread starts with the iteration: an epoch iterator that is
    never advanced leaves no thread behind."""
    before = set(threading.enumerate())
    it = split["native"].epoch(8, seed=0)
    assert set(threading.enumerate()) == before
    del it
    gc.collect()
    assert set(threading.enumerate()) == before
    unused = tcel.Prefetcher(lambda ix: ix, [[0], [1]])
    assert unused.t is None
    unused.close()                      # nothing to stop
    prefetcher = tcel.Prefetcher(lambda ix: ix, [[0], [1]])
    assert list(prefetcher) == [[0], [1]]
    assert not prefetcher.t.is_alive()


def test_a_failing_read_reaches_the_consumer(split, monkeypatch):
    monkeypatch.setattr(split["python"].reader, "read_batch",
                        lambda ix, out=None: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        list(split["python"].epoch(8, seed=0))


def test_celeba_data_builds_the_synthetic_splits(tmp_path, monkeypatch):
    """synthetic_data=1: three files of the configured sizes, equal to the
    ones ladder_tpu writes; data_path wins over $LADDER_DATA_DIR."""
    monkeypatch.setenv("LADDER_DATA_DIR", str(tmp_path / "unused"))
    cfg = dict(exp_name="celeba", dim_input_x=SIZE, dim_input_y=SIZE,
               dim_input_channel=3, synthetic_data=1, synthetic_n_train=20,
               synthetic_n_val=12, synthetic_n_test=5, seed=2,
               data_path=str(tmp_path / "port") + "/")
    data = tcel.CelebAData(cfg)
    assert (data.n_train, data.n_val, data.test.n) == (20, 12, 5)
    assert sorted(data.build_seconds) == [
        "celebA_test.tfrecords", "celebA_train.tfrecords",
        "celebA_val.tfrecords"]
    assert not (tmp_path / "unused").exists()
    jcel.CelebAData(dict(cfg, data_path=str(tmp_path / "jax") + "/"))
    for name in data.build_seconds:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    again = tcel.CelebAData(cfg)  # the files exist: nothing is rebuilt
    assert again.build_seconds == {}
    assert tcel.data_path({}) == str(tmp_path / "unused")
