"""Native runtime: a ctypes binding for the C++ TFRecord batch reader.

The port's copy of ``ladder_tpu/runtime``: ``tfrecord_reader.cc`` (the same
source) is compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17 -pthread -msse4.2`` into
``ladder_tpu_torch/_build/libtfrecord.so``, and rebuilt when the source is
newer than the library. Unlike ``ladder_tpu``, nothing falls back in
silence: when the library cannot be built or loaded, ``load()`` raises with
the compiler's message, and so do ``native_crc32c`` and
``NativeImageRecordReader``. A caller that wants the pure-Python reader asks
for it (``data.celeba.CelebARecords(..., prefer_native=False)``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "tfrecord_reader.cc"
LIBRARY = _PKG / "_build" / "libtfrecord.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-msse4.2")  # hardware crc32c (guarded by __SSE4_2__ in the .cc)

_lib = None
_error = None
_lock = threading.Lock()


def _build():
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half


def load():
    """The loaded library, built first if it is missing or older than its
    source. Raises RuntimeError when it cannot be built or loaded (and
    again on every later call, with the same message)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            if (not LIBRARY.is_file() or LIBRARY.stat().st_mtime
                    < SOURCE.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except (OSError, RuntimeError) as e:
            _error = f"native TFRecord reader unavailable: {e}"
            raise RuntimeError(_error) from e
        lib.ldr_open.restype = ctypes.c_void_p
        lib.ldr_open.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.c_char_p, ctypes.c_int]
        lib.ldr_count.restype = ctypes.c_long
        lib.ldr_count.argtypes = [ctypes.c_void_p]
        lib.ldr_read_batch.restype = ctypes.c_long
        lib.ldr_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.ldr_close.argtypes = [ctypes.c_void_p]
        lib.ldr_crc32c.restype = ctypes.c_uint32
        lib.ldr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]
        _lib = lib
    return _lib


def native_available():
    """True when the library is built and loads; False (never an error)
    when it cannot be."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def native_crc32c(data):
    """Hardware CRC32C of a bytes object (raises when the library is
    unavailable)."""
    return int(load().ldr_crc32c(data, len(data)))


class NativeImageRecordReader:
    """The counterpart of data.tfrecord.ImageRecordReader backed by the C++
    library: an mmap, a record index built once, and a thread pool that
    decodes each batch."""

    def __init__(self, path, shape, key="X", n_threads=None):
        self._handle = None
        self._lib = load()
        self.shape = tuple(shape)
        self.image_bytes = int(np.prod(shape))
        n_threads = n_threads or min(os.cpu_count() or 4, 8)
        self._handle = self._lib.ldr_open(str(path).encode(),
                                          self.image_bytes, key.encode(),
                                          n_threads)
        if not self._handle:
            raise IOError(f"cannot open {path}")
        self.n = int(self._lib.ldr_count(self._handle))

    def __len__(self):
        return self.n

    def read_batch(self, idxs, out=None):
        """uint8 [n, *shape] of the records ``idxs``; decoded into ``out``
        (a C-contiguous uint8 array of that shape, e.g. a pinned buffer's
        numpy view) when it is given. Raises IOError on a bad index."""
        idxs = np.ascontiguousarray(idxs, dtype=np.int64)
        n = len(idxs)
        shape = (n,) + self.shape
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        elif (out.shape != shape or out.dtype != np.uint8
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous uint8 {shape}, got "
                             f"{out.dtype} {out.shape}")
        ok = self._lib.ldr_read_batch(
            self._handle,
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if ok != n:
            raise IOError(f"decoded {ok}/{n} records")
        return out

    def read(self, i):
        return self.read_batch([i])[0]

    def close(self):
        if self._handle:
            self._lib.ldr_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
