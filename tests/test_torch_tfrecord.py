"""The port's TFRecord I/O (ladder_tpu_torch/data/tfrecord.py) and native
reader (ladder_tpu_torch/runtime) against ladder_tpu's: crc32c values, the
bytes of a written file, the record index, and the batches of a shuffled
read, all exactly equal."""

import numpy as np
import pytest

from ladder_tpu.data import tfrecord as jtf
from ladder_tpu_torch import runtime
from ladder_tpu_torch.data import tfrecord as ttf

SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The same 40 images written by each package."""
    root = tmp_path_factory.mktemp("tfrecord")
    images = np.random.default_rng(3).integers(0, 256, (40,) + SHAPE,
                                                dtype=np.uint8)
    mine, theirs = root / "port.tfrecords", root / "jax.tfrecords"
    ttf.write_image_tfrecords(str(mine), images)
    jtf.write_image_tfrecords(str(theirs), images)
    return dict(images=images, port=str(mine), jax=str(theirs))


@pytest.mark.parametrize("data, want", [
    (b"", 0x0), (b"a", 0xC1D04330), (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA), (bytes([0xFF] * 32), 0x62A8AB43)])
def test_crc32c_known_vectors(data, want):
    """The standard CRC32C vectors (RFC 3720 B.4 for the 32-byte ones), in
    the native path and the table loop alike (exact)."""
    assert ttf.crc32c(data) == ttf.crc32c_reference(data) == want


def test_crc32c_paths_agree_with_ladder_tpu():
    """Random buffers of every length to 70 bytes, and an image record's
    size: native == table loop == ladder_tpu's crc32c (exact)."""
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in list(range(71)) + [49152]]
    for buf in bufs:
        want = jtf.crc32c(buf)
        assert ttf.crc32c(buf) == want
        assert ttf.crc32c_reference(buf) == want
        assert ttf.masked_crc32c(buf) == jtf.masked_crc32c(buf)


def test_written_file_is_byte_identical(records):
    with open(records["port"], "rb") as a, open(records["jax"], "rb") as b:
        assert a.read() == b.read()


def test_example_codec_matches():
    raw = bytes(range(256)) * 2
    buf = ttf.encode_example_bytes("X", raw)
    assert buf == jtf.encode_example_bytes("X", raw)
    assert ttf.parse_example_bytes(buf, "X") == raw
    with pytest.raises(KeyError):
        ttf.parse_example_bytes(buf, "Y")


def test_index_is_equal(records):
    got = ttf.index_tfrecords(records["port"])
    np.testing.assert_array_equal(got, jtf.index_tfrecords(records["jax"]))
    assert got.shape == (40, 2) and got.dtype == np.int64


def test_readers_return_identical_batches(records):
    """A shuffled index list (with a repeat) through the port's native and
    Python readers and ladder_tpu's reader: the same bytes."""
    idxs = np.random.default_rng(7).permutation(40)[:25].tolist() + [3, 3]
    native = runtime.NativeImageRecordReader(records["port"], SHAPE)
    python = ttf.ImageRecordReader(records["port"], SHAPE)
    theirs = jtf.ImageRecordReader(records["jax"], SHAPE)
    want = theirs.read_batch(idxs)
    np.testing.assert_array_equal(want, records["images"][idxs])
    for reader in (native, python):
        assert len(reader) == 40
        got = reader.read_batch(idxs)
        assert got.dtype == np.uint8 and got.shape == (27,) + SHAPE
        np.testing.assert_array_equal(got, want)
        out = np.zeros((27,) + SHAPE, np.uint8)
        assert reader.read_batch(idxs, out=out) is out
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(reader.read(5), records["images"][5])
        reader.close()
    theirs.close()


@pytest.mark.parametrize("kind", ["native", "python"])
def test_a_bad_index_raises(records, kind):
    reader = (runtime.NativeImageRecordReader(records["port"], SHAPE)
              if kind == "native"
              else ttf.ImageRecordReader(records["port"], SHAPE))
    with pytest.raises((IOError, IndexError)):
        reader.read_batch([0, 40])
    reader.close()


def test_native_reader_refuses_a_wrong_out_buffer(records):
    native = runtime.NativeImageRecordReader(records["port"], SHAPE)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.read_batch([0, 1], out=np.zeros((2,) + SHAPE, np.float32))
    native.close()


def test_a_library_that_does_not_build_raises(tmp_path, monkeypatch,
                                              records):
    """No silent fallback: when g++ fails, the native reader and crc32c
    raise with the compiler's message, native_available() says False, and
    the Python reader is there only when asked for."""
    from ladder_tpu_torch.data.celeba import CelebARecords

    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SOURCE", bad)
    monkeypatch.setattr(runtime, "LIBRARY", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    assert runtime.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ttf.crc32c(b"a")
    with pytest.raises(RuntimeError, match="unavailable"):
        CelebARecords(records["port"], SHAPE)
    python = CelebARecords(records["port"], SHAPE, prefer_native=False)
    assert python.n == 40 and not python.native
    assert not list((tmp_path / "_build").glob("*.so"))  # nothing half-built


def test_the_library_is_rebuilt_when_its_source_is_newer(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "reader.cc"
    src.write_text(runtime.SOURCE.read_text())
    lib = tmp_path / "_build" / "libtfrecord.so"
    monkeypatch.setattr(runtime, "SOURCE", src)
    monkeypatch.setattr(runtime, "LIBRARY", lib)
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    runtime.load()
    built = lib.stat().st_mtime_ns
    monkeypatch.setattr(runtime, "_lib", None)
    runtime.load()
    assert lib.stat().st_mtime_ns == built          # up to date: kept
    import os
    os.utime(src, ns=(built + 10**9, built + 10**9))
    monkeypatch.setattr(runtime, "_lib", None)
    runtime.load()
    assert lib.stat().st_mtime_ns > built           # older: rebuilt
