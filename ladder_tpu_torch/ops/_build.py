"""Build and load the package's CUDA kernels: nvcc to a shared library with
a plain C interface, loaded with ctypes.

Each kernel module owns one ``KernelLibrary``: a source under
``ladder_tpu_torch/csrc/`` and the ctypes signatures of its C entry points.
The library is compiled at first use into ``ladder_tpu_torch/_build/`` as
``lib<name>_<key>.so``, where the key hashes the source and the compiler
flags, so an edited source or changed flags never load a stale build. Every
C entry point returns ``cudaGetLastError()`` after its launches;
``KernelLibrary.call`` raises on anything but 0, with the message of the
source's ``<name>_error_string``. Nothing here falls back: without nvcc, or
when the compiler fails, the caller gets the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


class KernelLibrary:
    """One CUDA source and its C entry points.

    functions: {C name: [ctypes argument types]}; every entry point returns
    an int (a cudaError_t). ``<name>_error_string(int) -> const char*`` is
    bound as well."""

    def __init__(self, name, functions, flags=NVCC_FLAGS):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.functions = dict(functions)
        self.flags = tuple(flags)
        self.loaded = None
        self._lock = threading.Lock()

    def path(self):
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{key}.so"

    def build(self):
        """Compile the source if its library is not built yet. Returns
        (library path, compiler output; empty when it was already built)."""
        so = self.path()
        if so.is_file():
            return so, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        return so, proc.stdout + proc.stderr

    def load(self):
        with self._lock:
            if self.loaded is None:
                so, _ = self.build()
                lib = ctypes.CDLL(str(so))
                for fn_name, argtypes in self.functions.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self.loaded = lib
            return self.loaded

    def call(self, fn_name, *args):
        """Call an entry point; raise if it reports a CUDA error."""
        lib = self.load()
        rc = getattr(lib, fn_name)(*args)
        if rc != 0:
            message = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{fn_name} launch failed: {message}")


def build_all(libraries):
    """Build several libraries at once, one nvcc process each. Returns
    {name: (path, compiler output)}."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return dict(zip((lib.name for lib in libraries),
                        pool.map(KernelLibrary.build, libraries)))
