"""Checkpoint loading: the reference's two-group layout, read without flax.

``ladder_tpu`` writes its checkpoints with ``flax.serialization``: a msgpack
map of nested string-keyed maps whose leaves are ndarrays packed as msgpack
ext type 1. The payload of an ext-1 object is itself a msgpack array
``(shape, dtype_name, C-order bytes)`` (``flax.serialization._ndarray_to_bytes``);
ext type 3 carries a numpy scalar the same way. The port reads these files
with the small pure-Python decoder below, so it needs neither flax nor the
``msgpack`` package.

Trees come back as nested dicts of numpy arrays in the flax layout (HWIO
conv kernels, [in, out] dense kernels); ``utils/weights.py`` turns them into
module state.
"""

from __future__ import annotations

import os
import struct

import numpy as np

VAE_KEYS = ("encoder", "decoder", "sigma")
PRIOR_KEYS = ("prior", "inner_sigma")

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax emits: nil, bool, int, float,
    str, bin, array, map and ext (https://github.com/msgpack/msgpack/blob/master/spec.md)."""

    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # raw=True keeps str payloads as bytes

    def _take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        return _ext_value(code, bytes(self._take(n)))

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._unpack({0xC7: ">B", 0xC8: ">H",
                                           0xC9: ">I"}[b]))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H",
                                           0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _ndarray_from_bytes(data):
    shape, dtype_name, buf = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported: "
                         "ladder_tpu stores parameters in float32")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext_value(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _check_unchunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (>1 GiB) array leaves are not supported")
        for v in tree.values():
            _check_unchunked(v)


def msgpack_restore(data):
    """bytes written by ``flax.serialization.msgpack_serialize`` -> the same
    nested tree ``flax.serialization.msgpack_restore`` returns."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    _check_unchunked(tree)
    return tree


def load_msgpack(path):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


class CheckpointManager:
    """Paths and load side of ``ladder_tpu.utils.checkpoint.CheckpointManager``."""

    def __init__(self, config):
        self.config = config
        ckdir = config["checkpoint_dir"]
        self.path_vae = os.path.join(ckdir, "vae-model.msgpack")
        self.path_prior = os.path.join(ckdir, "prior-model.msgpack")
        self.path_state = os.path.join(ckdir, "train-state.msgpack")

    def load(self, params, model):
        """Merge the saved group ('VAE' or 'prior') into a flax-layout
        parameter tree; soft-fails on a missing file like the reference
        (base.py:68-85). Every saved leaf must match the template's shape."""
        print("\ncheckpoint_dir to be loaded:\n{}\n".format(
            self.config["checkpoint_dir"]))
        path = self.path_vae if model == "VAE" else self.path_prior
        if not os.path.isfile(path):
            print(f"No {'outer VAE' if model == 'VAE' else 'prior'} model "
                  f"found. No {model} model loaded.")
            return params
        saved = load_msgpack(path)
        params = dict(params)
        for k, v in saved.items():
            if k in params:
                _check_same_structure(params[k], v, k)
                params[k] = v
        print(f"{'Outer VAE' if model == 'VAE' else 'Prior'} model loaded.")
        return params


def _check_same_structure(template, saved, path):
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(
                f"checkpoint group {path!r} does not match the model: "
                f"saved keys {sorted(saved) if isinstance(saved, dict) else type(saved)} "
                f"vs model keys {sorted(template)}")
        for k in template:
            _check_same_structure(template[k], saved[k], f"{path}/{k}")
    elif np.shape(template) != np.shape(saved):
        raise ValueError(f"checkpoint leaf {path!r} has shape "
                         f"{np.shape(saved)}, the model expects "
                         f"{np.shape(template)}")
