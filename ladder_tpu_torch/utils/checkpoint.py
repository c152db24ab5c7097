"""Checkpoints: the reference's two-group layout plus the full train
state, read and written without flax.

``ladder_tpu`` writes its checkpoints with ``flax.serialization``: a msgpack
map of nested string-keyed maps whose leaves are ndarrays packed as msgpack
ext type 1. The payload of an ext-1 object is itself a msgpack array
``(shape, dtype_name, C-order bytes)`` (``flax.serialization._ndarray_to_bytes``);
ext type 3 carries a numpy scalar the same way. The port reads these files
with the small pure-Python decoder below, so it needs neither flax nor the
``msgpack`` package.

Trees come back as nested dicts of numpy arrays in the flax layout (HWIO
conv kernels, [in, out] dense kernels); ``utils/weights.py`` turns them into
module state. The writer (``msgpack_serialize``) emits the bytes
``flax.serialization.msgpack_serialize`` emits for the same tree, so either
package reads the other's files. Writes go to a temporary file that
``os.replace`` moves into place.

``CheckpointManager`` works on flax-layout trees of numpy arrays: 'vae-model'
(encoder, decoder, sigma), 'prior-model' (prior, inner_sigma) and
'train-state' ({state, extra}: the train state as
``training/step.py:flax_state`` lays it out, and the trainer's epoch, fitted
GMs, metric buffers and random state). With config['async_checkpoint']
= 1 the serialisation and the disk writes run in one background thread
(``AsyncCheckpointWriter``), in order; every read through the manager, and
``flush()``, waits for them first. The orbax backend is not ported and its
option raises. Under data parallelism only the lead rank's manager
(``is_lead``) writes, and only it starts the writer thread; every rank
reads.
"""

from __future__ import annotations

import os
import queue
import struct
import threading

import numpy as np

from ladder_tpu_torch.ops.gmm import ACTIVE_WEIGHT_THRESHOLD

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


# flax splits arrays above this into chunks, which the reader refuses
_MAX_UNCHUNKED_BYTES = 2 ** 30


def _header(out, n, small, fix, wide):
    """A length header: ``fix | n`` when n < small, else the first of
    ``wide`` ((limit, type byte, struct format), ...) that holds n."""
    if fix is not None and n < small:
        out.append(bytes([fix | n]))
        return
    for limit, code, fmt in wide:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} is too large")


_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARRAY = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))
_EXT = ((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"), (1 << 32, 0xC9, ">I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out, v):
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"),
                                 (1 << 64, 0xCF, ">Q")):
            if v < limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"),
                                 (1 << 63, 0xD3, ">q")):
            if -v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out, code, data):
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _header(out, n, 0, None, _EXT)
    out.append(struct.pack(">b", code) + data)


def _ndarray_to_bytes(arr):
    """The ext payload of an array: msgpack (shape, dtype name, C bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    if arr.nbytes > _MAX_UNCHUNKED_BYTES:
        raise ValueError("arrays above 1 GiB (chunked by flax) are not "
                         "supported")
    out = []
    _pack(out, (arr.shape, arr.dtype.name, arr.tobytes("C")))
    return b"".join(out)


def _pack(out, obj):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 32, 0xA0, _STR)
        out.append(data)
    elif isinstance(obj, bytes):
        _header(out, len(obj), 0, None, _BIN)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 16, 0x90, _ARRAY)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _header(out, len(obj), 16, 0x80, _MAP)
        # flax copies the tree through jax.tree_util first, which sorts
        # every dict's keys
        for k, v in sorted(obj.items(), key=lambda kv: kv[0]):
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def msgpack_serialize(tree):
    """A nested tree of dicts, lists, Python scalars, numpy arrays and numpy
    scalars -> the bytes ``flax.serialization.msgpack_serialize`` writes
    for it."""
    out = []
    _pack(out, tree)
    return b"".join(out)


def save_msgpack(path, tree):
    """Write ``tree`` to ``path`` through a temporary file and os.replace,
    so a crash never leaves a half-written checkpoint."""
    data = msgpack_serialize(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """One background thread that runs the submitted writes in order.

    A bounded queue (``depth`` writes pending at most) applies
    backpressure. A failed write is sticky: every later submit() and
    flush() raises until reset_error(), so a checkpoint stream with a hole
    in it never looks healthy again by itself."""

    def __init__(self, depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # raised again by submit / flush
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            raise RuntimeError(
                "async checkpoint write failed (sticky until reset_error())"
            ) from self._err

    def reset_error(self):
        """Acknowledge a failed write and resume the stream."""
        self._err = None

    def submit(self, fn):
        self._check()
        self._q.put(fn)

    def flush(self):
        """Block until every submitted write is on disk; raise on a failed
        one."""
        self._q.join()
        self._check()


def _snapshot(tree):
    """A host copy of every leaf, taken before the caller goes on.

    The train step updates the parameters and Adam moments in place (the
    Adam kernel writes them on the device, its plain version on the CPU),
    so a leaf the writer thread read later could hold a later step's
    values, or half of one. The copy is made here, synchronously: a tensor
    is copied to the host (a device-to-host copy waits for the kernels
    before it), a numpy array is copied (a CPU tensor's ``.numpy()`` shares
    its memory). The trainer's trees are already host copies
    (utils/weights.py:torch_to_flax), so this costs a host memcpy of the
    checkpoint's bytes, against the serialisation and the disk write the
    thread takes off the training loop."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class CheckpointManager:
    """The two parameter groups and the full train state of
    ``ladder_tpu.utils.checkpoint.CheckpointManager``, on flax-layout trees
    of numpy arrays, written synchronously or by the asynchronous writer."""

    def __init__(self, config, is_lead=True):
        if config.get("checkpoint_backend", "msgpack") != "msgpack":
            raise NotImplementedError(
                f"checkpoint_backend={config['checkpoint_backend']!r}: only "
                "the msgpack backend is ported (ROADMAP.md)")
        self.config = config
        ckdir = config["checkpoint_dir"]
        self.path_vae = os.path.join(ckdir, "vae-model.msgpack")
        self.path_prior = os.path.join(ckdir, "prior-model.msgpack")
        self.path_state = os.path.join(ckdir, "train-state.msgpack")
        self._writer = None
        self.is_lead = is_lead

    def _async_enabled(self):
        """config['async_checkpoint'] = 1 moves serialisation and IO to the
        background writer (of the lead rank, the only one that writes)."""
        return bool(self.config.get("async_checkpoint"))

    def _write_msgpack(self, path, tree, done_msg=None):
        """done_msg, when given, is printed only after the bytes are on
        disk: in async mode inside the writer thread, so the log never
        claims a write that later fails. Nothing on a rank other than the
        lead."""
        if not self.is_lead:
            return
        if not self._async_enabled():
            save_msgpack(path, tree)
            if done_msg:
                print(done_msg)
            return
        if self._writer is None:
            self._writer = AsyncCheckpointWriter()
        snap = _snapshot(tree)

        def _write():
            save_msgpack(path, snap)
            if done_msg:
                print(done_msg)

        self._writer.submit(_write)

    def flush(self):
        """Wait for pending asynchronous writes (nothing to wait for when
        synchronous); raise if one failed."""
        if self._writer is not None:
            self._writer.flush()

    def save(self, params, model="joint"):
        """Write the 'vae-model' and/or 'prior-model' groups of a flax-layout
        parameter tree, gated as the reference gates them (base.py:51-66)."""
        print("Saving model...")
        cfg = self.config
        has_prior = cfg["prior"] in ("ours", "hierarchical", "vampPrior")
        if model in ("VAE", "joint") and (model == "VAE"
                                          or cfg["TRAIN_VAE"] == 1):
            self._write_msgpack(
                self.path_vae, {k: params[k] for k in VAE_KEYS if k in params},
                done_msg="Outer VAE model saved.")
        if has_prior and (model == "prior"
                          or (model == "joint" and cfg["TRAIN_prior"] == 1)):
            self._write_msgpack(
                self.path_prior,
                {k: params[k] for k in PRIOR_KEYS if k in params},
                done_msg="Prior model saved.")

    def load(self, params, model):
        """Merge the saved group ('VAE' or 'prior') into a flax-layout
        parameter tree; soft-fails on a missing file like the reference
        (base.py:68-85). Every saved leaf must match the template's shape."""
        self.flush()  # read after write: pending saves land first
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

    def save_full(self, state, extra=None):
        """Write 'train-state': ``state`` is the flax-layout train state
        {params, opt, step}, ``extra`` a tree of host values."""
        self._write_msgpack(self.path_state,
                            {"state": state, "extra": extra or {}})

    def load_full(self):
        """(flax-layout train state, extra), or None without a file."""
        self.flush()  # read after write: pending saves land first
        if not os.path.isfile(self.path_state):
            return None
        raw = load_msgpack(self.path_state)
        return raw["state"], raw.get("extra", {})


def save_gm_prior_info(result_dir, weights, means, covs,
                       active_threshold=ACTIVE_WEIGHT_THRESHOLD):
    """GM_prior_info.npz: the accurate fit's active components (weights
    renormalised) and the full parameter sets (base.py:768-777)."""
    w, m, K = np.asarray(weights), np.asarray(means), np.asarray(covs)
    idx = np.where(w >= active_threshold)[0]
    w_active = w[idx]
    w_active = w_active / w_active.sum() if w_active.size else w_active
    filename = os.path.join(result_dir, "GM_prior_info.npz")
    np.savez(filename, w_active=w_active, m_active=m[idx], K_active=K[idx],
             w_full=w, m_full=m, K_full=K)
    return filename


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
